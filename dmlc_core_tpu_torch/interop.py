"""Framework interop boundary: zero-copy exchange between torch, numpy and
any dlpack producer.

Counterpart of ``dmlc_core_tpu/interop.py``, with the same four names.
The reference ships a header-only Lua/Torch bridge (include/dmlc/lua.h:62-739)
so DMLC libraries could exchange tensors with Torch7 plugins; the modern
equivalent of that FFI boundary is dlpack.  There the framework's array is
the ``jax.Array``; here it is the ``torch.Tensor``:

- :func:`to_torch` takes any dlpack producer (a ``jax.Array``, a tensor of
  another library) or a numpy array, sharing its memory where dlpack
  allows; the port imports no jax to take a ``jax.Array``;
- :func:`from_torch` gives the tensor back, detached, with no copy;
- :func:`from_numpy` puts an array on the card unless the caller passes
  ``device="cpu"`` (as ``jnp.asarray`` puts it on the default device), and
  raises without a card;
- :func:`to_numpy` copies a CUDA tensor to the host.
"""

from __future__ import annotations

from typing import Any

__all__ = ["to_torch", "from_torch", "to_numpy", "from_numpy"]


def to_torch(x: Any):
    """dlpack producer/numpy -> torch.Tensor (dlpack zero-copy when
    possible)."""
    import torch

    try:
        return torch.from_dlpack(x)
    except Exception:
        import numpy as np

        return torch.from_numpy(np.asarray(x))


def from_torch(t: Any):
    """torch.Tensor -> the same tensor, detached from autograd (no copy)."""
    return t.detach()


def to_numpy(x: Any):
    """Any array -> numpy; a CUDA tensor is copied to the host."""
    import numpy as np

    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def from_numpy(a: Any, device=None):
    """numpy -> torch.Tensor on ``device`` (the card unless ``"cpu"``)."""
    import numpy as np

    import torch

    from dmlc_core_tpu_torch.utils.device import resolve_device

    return torch.from_numpy(np.asarray(a)).to(resolve_device(device))
