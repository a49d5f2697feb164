"""IO layer of the PyTorch port: streams, URI-dispatched filesystems (local,
S3/GCS, HTTP(S), HDFS, Azure), RecordIO, InputSplit and ThreadedIter.

Counterpart of ``dmlc_core_tpu/io/__init__.py``, with the same exports and
the same remote filesystems, registered on import.
"""

from dmlc_core_tpu_torch.io.stream import (  # noqa: F401
    Stream,
    SeekStream,
    Serializable,
    create_stream,
    create_stream_for_read,
)
from dmlc_core_tpu_torch.io.memory_io import MemoryFixedSizeStream, MemoryStringStream  # noqa: F401
from dmlc_core_tpu_torch.io.filesys import URI, FileInfo, FileSystem, FileType  # noqa: F401
from dmlc_core_tpu_torch.io.recordio import (  # noqa: F401
    RECORDIO_MAGIC,
    RecordIOWriter,
    RecordIOReader,
    RecordIOChunkReader,
)
from dmlc_core_tpu_torch.io.threadediter import ThreadedIter  # noqa: F401
from dmlc_core_tpu_torch.io.input_split import InputSplit, create_input_split  # noqa: F401
from dmlc_core_tpu_torch.io.uri_spec import URISpec  # noqa: F401

# remote filesystems register themselves on import (the reference gates these
# with DMLC_USE_S3/HDFS compile flags; here the gate is import/credential time)
from dmlc_core_tpu_torch.io import s3_filesys as _s3  # noqa: F401,E402
from dmlc_core_tpu_torch.io import http_filesys as _http  # noqa: F401,E402
from dmlc_core_tpu_torch.io import hdfs_filesys as _hdfs  # noqa: F401,E402
from dmlc_core_tpu_torch.io import azure_filesys as _azure  # noqa: F401,E402
