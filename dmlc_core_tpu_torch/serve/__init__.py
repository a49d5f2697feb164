"""Online scoring on the PyTorch port.

Counterpart of ``dmlc_core_tpu/serve/``: micro-batching
(:mod:`.scheduler`), byte-bounded admission (:mod:`.admission`), the
threaded and event-loop HTTP transports (:mod:`.server`,
:mod:`.eventloop`, ``python -m dmlc_core_tpu_torch.serve``), named model
slots and zero-downtime swaps (:mod:`.registry`), the checkpoint watcher
that closes the train→serve loop (:mod:`.lifecycle`), the multi-replica
tier (:mod:`.router`, :mod:`.fleet`, ``--replicas N``) and the open-loop
load generator (:mod:`.loadgen`).  The linear, MLP and GBDT runtimes
score on the card (``cuda`` unless ``device="cpu"``); the GBDT one
through the uint8 binned wire.
"""

from dmlc_core_tpu_torch.serve.admission import AdmissionController  # noqa: F401
from dmlc_core_tpu_torch.serve.errors import (BadRequest,  # noqa: F401
                                              ClientTimeout, Overloaded,
                                              PredictFailed, RequestTimeout,
                                              ServeError, UnknownModel,
                                              UpstreamFailed)
from dmlc_core_tpu_torch.serve.fleet import ReplicaFleet  # noqa: F401
from dmlc_core_tpu_torch.serve.lifecycle import (CheckpointWatcher,  # noqa: F401
                                                 runtime_builder)
from dmlc_core_tpu_torch.serve.model_runtime import (GBDTRuntime,  # noqa: F401
                                                     LinearRuntime,
                                                     MLPRuntime,
                                                     ModelRuntime,
                                                     build_runtime)
from dmlc_core_tpu_torch.serve.registry import (ModelRegistry,  # noqa: F401
                                                ModelSlot)
from dmlc_core_tpu_torch.serve.scheduler import (MicroBatcher,  # noqa: F401
                                                 batch_buckets)
from dmlc_core_tpu_torch.serve.router import (Replica,  # noqa: F401
                                              RouterServer)
from dmlc_core_tpu_torch.serve.server import ScoringServer  # noqa: F401
# after .server: the event loop imports the shared request plumbing
# (parse_instances, healthz_payload, route_slot) from there
from dmlc_core_tpu_torch.serve.eventloop import EventLoopServer  # noqa: F401,E402
