"""Rabit-shaped collectives over ``torch.distributed``.

Counterpart of ``dmlc_core_tpu/collective``:

- :mod:`.api` — the process-level API (init/finalize/get_rank/
  get_world_size/allreduce/broadcast/allgather/tracker_print and the
  checkpoint/load_checkpoint recovery pair) over host numpy arrays;
- :mod:`.mesh_collectives` — collectives over one axis of a mesh, on
  tensors, which the model-sharded histogram uses, and the explicit
  ``ring_allreduce``.
"""

from dmlc_core_tpu_torch.collective.api import (  # noqa: F401
    init,
    finalize,
    is_initialized,
    get_rank,
    get_world_size,
    get_processor_name,
    allreduce,
    broadcast,
    allgather,
    tracker_print,
    version_number,
    checkpoint,
    load_checkpoint,
)
from dmlc_core_tpu_torch.collective.mesh_collectives import (  # noqa: F401
    MeshCollective,
    ring_allreduce,
)
