"""Device resolution: the port runs on ``cuda`` unless told otherwise.

Counterpart of the platform selection in ``dmlc_core_tpu/utils/
platform.py``.  There is no quiet fallback: asking for the default device
on a machine without a card raises, so a CPU run is always one the caller
asked for with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


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
