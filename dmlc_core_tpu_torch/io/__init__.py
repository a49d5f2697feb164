"""IO layer of the PyTorch port: streams, the local filesystem, RecordIO,
InputSplit and ThreadedIter.

Counterpart of ``dmlc_core_tpu/io/__init__.py``, with the same exports; the
remote filesystems are not ported yet (ROADMAP §1, [1c]).
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
