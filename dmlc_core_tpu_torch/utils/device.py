"""Device resolution: the port runs on ``cuda`` unless told otherwise.

Counterpart of the platform selection in ``dmlc_core_tpu/utils/
platform.py``.  There is no quiet fallback: asking for the default device
on a machine without a card raises, so a CPU run is always one the caller
asked for with ``device="cpu"``.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

__all__ = ["resolve_device", "worker_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``; raise when a CUDA device is asked for and
    none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dmlc_core_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def worker_device(device: Optional[Union[str, torch.device]] = None
                  ) -> torch.device:
    """This worker's device in a launch of several workers: a bare
    ``cuda`` becomes card ``rank % device_count`` and is made current, as
    a JAX process takes its own local devices, so ranks spread over a
    host's cards and share one where there is one.  The rank is
    ``LOCAL_RANK`` when set, else the collective's own (``DMLC_TASK_ID``,
    or the rank that mpirun or SLURM gives a process that has no
    ``DMLC_TASK_ID``).  Anything else, and any single-worker run, is
    :func:`resolve_device`'s answer unchanged."""
    # collective.api imports this module
    from dmlc_core_tpu_torch.collective.api import _task_id_from_env

    dev = resolve_device(device)
    if (dev.type != "cuda" or dev.index is not None
            or int(os.environ.get("DMLC_NUM_WORKER", "1")) <= 1):
        return dev
    local = os.environ.get("LOCAL_RANK", "").strip()
    rank = int(local) if local else _task_id_from_env(os.environ)
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev
