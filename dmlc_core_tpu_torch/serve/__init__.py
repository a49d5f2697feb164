"""Online scoring on the PyTorch port.

Counterpart of ``dmlc_core_tpu/serve/``, single process: micro-batching
(:mod:`.scheduler`), byte-bounded admission (:mod:`.admission`), the
threaded HTTP transport (:mod:`.server`, ``python -m
dmlc_core_tpu_torch.serve``), named model slots and zero-downtime swaps
(:mod:`.registry`), and the checkpoint watcher that closes the
train→serve loop (:mod:`.lifecycle`).  The GBDT runtime scores on the
card (``cuda`` unless ``device="cpu"``) through the uint8 binned wire.

Not ported yet (ROADMAP.md §1 item 4): the event-loop transport, the
multi-replica router and fleet, the load generator, and the linear and MLP
runtimes (with item 9).
"""

from dmlc_core_tpu_torch.serve.admission import AdmissionController  # noqa: F401
from dmlc_core_tpu_torch.serve.errors import (BadRequest,  # noqa: F401
                                              ClientTimeout, Overloaded,
                                              PredictFailed, RequestTimeout,
                                              ServeError, UnknownModel,
                                              UpstreamFailed)
from dmlc_core_tpu_torch.serve.lifecycle import (CheckpointWatcher,  # noqa: F401
                                                 runtime_builder)
from dmlc_core_tpu_torch.serve.model_runtime import (GBDTRuntime,  # noqa: F401
                                                     ModelRuntime,
                                                     build_runtime)
from dmlc_core_tpu_torch.serve.registry import (ModelRegistry,  # noqa: F401
                                                ModelSlot)
from dmlc_core_tpu_torch.serve.scheduler import (MicroBatcher,  # noqa: F401
                                                 batch_buckets)
from dmlc_core_tpu_torch.serve.server import ScoringServer  # noqa: F401
