"""Tree-ensemble scoring on the H100: the traversal kernel, its plain version.

:func:`predict_margin_cuda` computes ``GBDT.predict_margin``: every row
routed down every tree of a level-order ensemble and the trees' leaf values
added to ``base_score`` in tree order, in f32.  On the card it runs
``csrc/predict.cu`` (built and bound by :mod:`._build`): one launch packs
the trees, one walks every row through every tree, so a call is two
launches whatever the ensemble.  The kernel replaces no Pallas kernel (the
JAX package scores with XLA ops that XLA fuses); it replaces the plain
loop, :func:`predict_margin_ref`, which eager PyTorch runs as ~107 launches
a depth-8 tree.  ``predict.cu``'s note gives its bound and design.

:func:`predict_margin_ref` is that loop, :func:`route_tree` one level at
a time, unchanged.  The wrapper takes it only for tensors that lie on the
CPU; for CUDA tensors it launches the kernel or raises.  The kernel sums
in the plain version's order, so their margins are bitwise equal on any
ensemble a fit grows (split bins below 1024; ``predict.cu`` says what the
kernel's clamp of bins to [-1, 1024] leaves exact).  A node that splits on
a feature outside ``[0, F)``, where the plain version raises, sends every
row left in the kernel; ``GBDT.predict_margin`` holds the bins' width to
the model's ``num_feature`` first, so through the model both raise.

:func:`route_tree`, :func:`predict_tree` and :func:`per_tree` are the
level-order routing that the plain version, and ``GBDT.predict_leaf`` and
``fit_with_eval``'s per-tree margins, share.

``LAUNCHES["predict_margin_cuda"]`` counts the wrapper's kernel calls.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["predict_margin_cuda", "predict_margin_ref", "predict_plan",
           "tier_plan", "route_tree", "predict_tree", "per_tree",
           "reset_launches", "LAUNCHES", "ROWS", "CHAINS", "TIERS"]

# kernel calls of the wrapper since the last reset_launches()
LAUNCHES: Dict[str, int] = {"predict_margin_cuda": 0}

ROWS = 512               # rows (threads) a CTA walks (kRows in predict.cu)
CHAINS = 4               # trees a thread walks at once (kChains)
MAX_DEPTH = 14           # GBDTParam.max_depth's upper bound
MAX_FEATURE = 2 ** 19 - 1  # features a packed node can name
_SMEM_BYTES = 232448     # dynamic shared memory one block may use on sm_90
# dynamic shared memory a block may use with two blocks on one SM (228 KB
# an SM, 1 KB of it reserved by each block)
_TWO_BLOCK_SMEM = 233472 // 2 - 1024
_DTYPES = (torch.int32, torch.int32, torch.float32, torch.bool)
_NAMES = ("split_feat", "split_bin", "leaf_value", "default_left")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- the plain version --------------------------------------------------------
def route_tree(split_feat, split_bin, default_left, bins, max_depth: int,
               miss_id: int = -1):
    """Leaf slot of every row in one tree.  ``miss_id >= 0`` sends rows
    whose split feature carries that bin the node's default way."""
    B = bins.shape[0]
    node = torch.zeros((B,), dtype=torch.int64, device=bins.device)
    for depth in range(max_depth):
        idx = 2 ** depth - 1 + node
        sf = split_feat[idx].to(torch.int64)
        sb = split_bin[idx]
        row_bin = torch.gather(bins, 1, sf.clamp(min=0)[:, None])[:, 0]
        row_bin = row_bin.to(torch.int32)
        go_right = (row_bin > sb) & (sf >= 0)
        if miss_id >= 0:
            go_right = go_right & ~((row_bin == miss_id) & default_left[idx])
        node = node * 2 + go_right.to(torch.int64)
    return node


def predict_tree(split_feat, split_bin, leaf_value, default_left, bins,
                 max_depth: int, miss_id: int = -1):
    """Route every row down one tree and read its leaf value."""
    return leaf_value[route_tree(split_feat, split_bin, default_left, bins,
                                 max_depth, miss_id)]


def per_tree(fn, arrays, multiclass: bool):
    """Apply a per-tree function over one round's arrays, stacking the K
    class trees on axis 1 for softmax ensembles."""
    if multiclass:
        K = arrays[0].shape[0]
        return torch.stack([fn(*(a[k] for a in arrays)) for k in range(K)],
                           dim=1)
    return fn(*arrays)


def predict_margin_ref(split_feat, split_bin, leaf_value, default_left, bins,
                       max_depth: int, miss_id: int = -1,
                       base_score: float = 0.0):
    """The plain loop: ``base_score`` plus each tree's leaf value, tree by
    tree, every tree routed one level at a time ([B], or [B, K] for
    ``[T, K, nodes]`` ensembles).  Any device."""
    trees = [split_feat, split_bin, leaf_value, default_left]
    multiclass = trees[0].dim() == 3
    shape = (bins.shape[0], trees[0].shape[1]) if multiclass \
        else (bins.shape[0],)
    out = torch.full(shape, base_score, dtype=torch.float32,
                     device=bins.device)
    for t in range(trees[0].shape[0]):
        out = out + per_tree(
            lambda sf, sb, lv, dl: predict_tree(sf, sb, lv, dl, bins,
                                                max_depth, miss_id),
            [a[t] for a in trees], multiclass)
    return out


# -- the launch plan ------------------------------------------------------------
class PredictPlan(NamedTuple):
    """The traversal's launch: where bins and trees are read from."""
    bins_smem: bool       # the CTA's bins staged in shared memory
    trees_per_tile: int   # records a staged tile holds; 0: global memory
    smem: int             # dynamic shared memory a CTA


# (shared-memory budget, bins staged) in the order predict_plan tries them
TIERS = ((_TWO_BLOCK_SMEM, True), (_SMEM_BYTES, True),
         (_TWO_BLOCK_SMEM, False))


def tier_plan(budget: int, bins_smem: bool, num_feature: int, max_depth: int,
              num_trees: int) -> Optional[PredictPlan]:
    """The plan that stages tiles of trees within ``budget`` bytes (beside
    the bins where ``bins_smem``), or None where not one record a buffer
    fits."""
    record = 4 * 2 ** (max_depth + 1)
    bins_bytes = 4 * num_feature * ROWS if bins_smem else 0
    tile = min(num_trees, max(0, budget - bins_bytes) // (2 * record))
    if tile >= CHAINS:
        tile -= tile % CHAINS
    if tile < 1:
        return None
    return PredictPlan(bins_smem, tile, bins_bytes + 2 * tile * record)


def predict_plan(num_feature: int, max_depth: int,
                 num_trees: int) -> PredictPlan:
    """The plan for these shapes (``num_trees`` a class): the first of
    TIERS that fits, so bins in shared memory where they fit beside two
    records, two blocks an SM where they fit, and tiles of a multiple of
    CHAINS trees where a tile holds that many; trees too deep to stage are
    read from global memory.  Staged bins come before the second block:
    at depth 8 and 56, 67 and 111 uint8 features one block an SM with
    staged bins walks 4.2 M rows through 500 trees in 6.5, 7.1 and 30.2 ms
    on an H100 (700 W), two with bins from global memory in 29.5, 39.2 and
    75.9 (``tools/predict_times.py``)."""
    for budget, bins_smem in TIERS:
        plan = tier_plan(budget, bins_smem, num_feature, max_depth,
                         num_trees)
        if plan is not None:
            return plan
    bins_bytes = 4 * num_feature * ROWS
    bins_smem = bins_bytes <= _SMEM_BYTES
    return PredictPlan(bins_smem, 0, bins_bytes if bins_smem else 0)


# -- checks and the wrapper -----------------------------------------------------
def _check_args(trees, bins, max_depth: int, miss_id: int) -> None:
    CHECK(bins.dim() == 2, f"bins must be [B, F], got {tuple(bins.shape)}")
    CHECK(bins.dtype in (torch.uint8, torch.int32),
          f"bins must be uint8 or int32, got {bins.dtype}")
    CHECK(bins.is_contiguous(), "bins must be contiguous")
    CHECK(1 <= bins.shape[1] <= MAX_FEATURE,
          f"bins must have 1 to {MAX_FEATURE} features, got "
          f"{bins.shape[1]}")
    CHECK(1 <= max_depth <= MAX_DEPTH,
          f"max_depth must be in [1, {MAX_DEPTH}], got {max_depth}")
    CHECK(-1 <= miss_id < 1024, f"miss_id must be in [-1, 1024), got "
                                f"{miss_id}")
    lead = tuple(trees[0].shape[:-1])
    CHECK(len(lead) in (1, 2), f"split_feat must be [T, nodes] or "
                               f"[T, K, nodes], got {tuple(trees[0].shape)}")
    for name, t, dtype in zip(_NAMES, trees, _DTYPES):
        width = 2 ** max_depth - (0 if name == "leaf_value" else 1)
        CHECK(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        CHECK(tuple(t.shape) == lead + (width,),
              f"{name} must be {list(lead + (width,))} at max_depth "
              f"{max_depth}, got {list(t.shape)}")
        CHECK(t.is_contiguous(), f"{name} must be contiguous")
        CHECK(t.device == bins.device,
              f"{name} is on {t.device}, bins on {bins.device}")


def predict_margin_cuda(split_feat, split_bin, leaf_value, default_left,
                        bins, max_depth: int, miss_id: int = -1,
                        base_score: float = 0.0):
    """``base_score`` plus every tree's leaf value for every row, f32 [B]
    (or [B, K] for ``[T, K, nodes]`` ensembles), summed in tree order.

    Trees are level-order (:class:`..models.gbdt.TreeEnsemble`):
    ``split_feat``/``split_bin`` int32 and ``default_left`` bool
    ``[..., 2**max_depth - 1]``, ``leaf_value`` f32 ``[..., 2**max_depth]``;
    ``bins`` [B, F] uint8 or int32; ``miss_id >= 0`` routes rows whose
    split feature carries that bin the node's default way.  CPU tensors
    take :func:`predict_margin_ref`; CUDA tensors one call of the kernel
    (two launches: the packing and the walk), or ``base_score`` alone for
    an ensemble of no trees."""
    trees = (split_feat, split_bin, leaf_value, default_left)
    _check_args(trees, bins, max_depth, miss_id)
    if bins.device.type == "cpu":
        return predict_margin_ref(*trees, bins, max_depth, miss_id,
                                  base_score)
    CHECK(bins.device.type == "cuda",
          f"the traversal kernel takes CPU or CUDA tensors, got "
          f"{bins.device}")
    B = bins.shape[0]
    T = split_feat.shape[0]
    K = split_feat.shape[1] if split_feat.dim() == 3 else 1
    shape = (B, K) if split_feat.dim() == 3 else (B,)
    out = torch.empty(shape, dtype=torch.float32, device=bins.device)
    if B == 0:
        return out
    if T == 0:
        return out.fill_(base_score)
    plan = predict_plan(bins.shape[1], max_depth, T)
    packed = torch.empty(K * T * 2 ** (max_depth + 1), dtype=torch.int32,
                         device=bins.device)
    lib = _library()
    with torch.cuda.device(bins.device):
        rc = lib.dmlc_predict_margin(
            bins.data_ptr(), int(bins.dtype == torch.uint8), B,
            bins.shape[1], split_feat.data_ptr(), split_bin.data_ptr(),
            default_left.data_ptr(), leaf_value.data_ptr(), T, K, max_depth,
            miss_id, base_score, int(plan.bins_smem), plan.trees_per_tile,
            packed.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc)
    LAUNCHES["predict_margin_cuda"] += 1
    return out


def _library():
    from dmlc_core_tpu_torch.ops._build import load_library

    lib = load_library()
    CHECK(lib.dmlc_predict_rows() == ROWS,
          f"predict.cu walks {lib.dmlc_predict_rows()} rows a CTA, wrapper "
          f"{ROWS}")
    return lib


def _raise_on(lib, rc: int) -> None:
    # one library holds every csrc/*.cu, and one error-string entry serves
    # them all (hist.cu defines it)
    if rc != 0:
        msg = lib.dmlc_hist_error_string(rc).decode()
        raise RuntimeError(f"predict_margin_cuda: CUDA launch failed with "
                           f"error {rc} ({msg})")
