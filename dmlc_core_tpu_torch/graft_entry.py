"""Entry point: a forward step of the flagship model.

Counterpart of ``entry()`` in the repository's ``__graft_entry__.py``:
hist-GBDT ensemble prediction over binned features, on a tiny seeded
ensemble (3 trees of depth 3 over 8 features and 16 bins) and 64 rows of
bins, drawn with the same ``RandomState`` calls, so both packages score
the same trees on the same rows.
"""

from __future__ import annotations

import numpy as np
import torch

from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam, TreeEnsemble
from dmlc_core_tpu_torch.utils.device import resolve_device

__all__ = ["entry"]


def _tiny_ensemble(num_trees=3, max_depth=3, num_feature=8, num_bins=16,
                   seed=0, device=None) -> TreeEnsemble:
    rng = np.random.RandomState(seed)
    n_internal = 2 ** max_depth - 1
    n_leaf = 2 ** max_depth
    arrays = (
        rng.randint(-1, num_feature, (num_trees, n_internal)).astype(np.int32),
        rng.randint(0, num_bins, (num_trees, n_internal)).astype(np.int32),
        rng.randn(num_trees, n_leaf).astype(np.float32),
        np.zeros((num_trees, n_internal), dtype=bool),
    )
    return TreeEnsemble(*(torch.from_numpy(a).to(device) for a in arrays))


def entry(device=None):
    """``(fn, example_args)``: ``fn(*example_args)`` is the ensemble's
    margin on the example rows, [64] float32, computed on ``device``
    (``cuda`` unless the caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    max_depth, num_bins, num_feature = 3, 16, 8
    param = GBDTParam(num_boost_round=3, max_depth=max_depth,
                      num_bins=num_bins)
    model = GBDT(param, num_feature=num_feature, device=dev)

    def forward(ensemble, bins):
        return model.predict_margin(ensemble, bins)

    ensemble = _tiny_ensemble(3, max_depth, num_feature, num_bins,
                              device=dev)
    bins = torch.from_numpy(np.random.RandomState(1).randint(
        0, num_bins, (64, num_feature)).astype(np.int32)).to(dev)
    return forward, (ensemble, bins)
