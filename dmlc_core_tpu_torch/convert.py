"""Carry a tree ensemble, or MLP weights, between the JAX package and the
port.

The JAX package's ``TreeEnsemble`` is six arrays (``split_feat``,
``split_bin``, ``leaf_value``, ``default_left``, ``split_gain``,
``split_cover``; the last two may be None).  Given as numpy arrays,
:func:`ensemble_from_numpy` makes the port's ensemble of tensors, and
:func:`ensemble_to_numpy` goes the other way.  With the JAX model's
``boundaries`` installed by ``GBDT.set_boundaries``, a JAX-trained ensemble
scores identically in the port.

The JAX package's MLP params are ``{"layers": [{"w": [in, out], "b":
[out]}, ...]}``.  Given as numpy arrays, :func:`mlp_params_from_numpy`
makes the port's tree of tensors (with an ``MLP(model_axis=...)``, the
rank's column blocks of the middle layers), and
:func:`mlp_params_to_numpy` goes the other way (gathering the blocks
first, so it is the full tree on every rank of the model line).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch.models.gbdt import TreeEnsemble
from dmlc_core_tpu_torch.ops.histogram import as_tensor
from dmlc_core_tpu_torch.utils.device import resolve_device
from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["ensemble_from_numpy", "ensemble_to_numpy",
           "mlp_params_from_numpy", "mlp_params_to_numpy"]

_DTYPES = (torch.int32, torch.int32, torch.float32, torch.bool,
           torch.float32, torch.float32)


def ensemble_from_numpy(arrays: Sequence[Optional[np.ndarray]],
                        device=None) -> TreeEnsemble:
    """The port's :class:`TreeEnsemble` on ``device`` (``cuda`` unless
    ``device="cpu"``) from the reference's six fields as numpy arrays."""
    arrays = list(arrays)
    CHECK(4 <= len(arrays) <= 6,
          f"expected 4 to 6 ensemble fields, got {len(arrays)}")
    arrays += [None] * (6 - len(arrays))
    CHECK(all(a is not None for a in arrays[:4]),
          "split_feat, split_bin, leaf_value and default_left are required")
    dev = resolve_device(device)
    return TreeEnsemble(*(None if a is None else as_tensor(a, dev, dt)
                          for a, dt in zip(arrays, _DTYPES)))


def ensemble_to_numpy(ensemble: TreeEnsemble
                      ) -> Tuple[Optional[np.ndarray], ...]:
    """The six fields as host numpy arrays (None stays None), in the
    reference's dtypes."""
    return tuple(None if a is None else a.detach().cpu().numpy()
                 for a in ensemble)


def mlp_params_from_numpy(params: Dict[str, Any], device=None,
                          model=None) -> Dict[str, Any]:
    """The port's MLP tree on ``device`` (``cuda`` unless
    ``device="cpu"``; ``model.device`` when ``model`` is given) from the
    reference's tree of numpy arrays; with an ``MLP(model_axis=...)`` as
    ``model``, the rank's blocks (:meth:`MLP.shard_params`)."""
    dev = model.device if model is not None else resolve_device(device)
    CHECK(isinstance(params, dict) and "layers" in params,
          "expected an MLP tree {'layers': [{'w': ..., 'b': ...}, ...]}")
    tree = {"layers": [{k: as_tensor(np.asarray(layer[k]), dev,
                                     torch.float32) for k in ("w", "b")}
                       for layer in params["layers"]]}
    return tree if model is None else model.shard_params(tree)


def mlp_params_to_numpy(params: Dict[str, Any], model=None
                        ) -> Dict[str, Any]:
    """The reference's tree of float32 numpy arrays from the port's; with
    an ``MLP(model_axis=...)`` as ``model`` the blocks are gathered first
    (a collective over the model line: every rank of it must call)."""
    if model is not None:
        params = model.gather_params(params)
    return {"layers": [{k: layer[k].detach().cpu().numpy()
                        for k in ("w", "b")} for layer in params["layers"]]}
