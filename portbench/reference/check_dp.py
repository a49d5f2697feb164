"""The comparison that decides ``correct`` for a job sharded by rows over
ranks, and the reference's own tree grown the same way.

Every rank calls these on its own rows, in the same order, inside one
``torch.distributed`` job (the default group): plain PyTorch and
``torch.distributed``, on the reference's own calls (:mod:`.gbdt`).
Nothing here imports the port.

:func:`judge_train_dp` follows :func:`.check.judge_train` on each rank's
rows: the reference routes the rank's rows through the program's trees
with its own code, keeps the margin they give and from it the next
round's gradients.  For the checked trees each level's float64 histogram
is summed over the ranks before the split scan and the gap; each tree's
leaf values come from float64 leaf sums summed over the ranks.  So the
numbers are those :func:`.check.judge_train` gives on the table the
shards make up, for the same ensemble:

- ``shape_faults``, ``split_gap``, ``leaf_err_med``: as there, the
  widest over the ranks;
- ``margin_err``: the widest over each rank's own rows;
- ``rank_faults``: the number of ranks whose ensemble differs from rank
  0's by a bit (tree count, split features and bins, leaf values, default
  directions).

:func:`build_tree_dp` is :func:`.gbdt.build_tree` over shards: the
histograms and leaf sums summed over the ranks, rows routed locally.  The
control grows its trees with it one precision step below the
configuration.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

from portbench.reference import check, gbdt


def _check_rows_unsampled(params: Dict) -> None:
    """Row draws over shards need each rank's place in the global draw,
    which the reference's Threefry copy does not take."""
    if params.get("subsample", 1.0) < 1.0:
        raise ValueError("the sharded reference implements subsample=1.0 "
                         f"only, the configuration asks for "
                         f"{params['subsample']!r}")


def _summed(*tensors: torch.Tensor):
    """The tensors (float64, one shape) summed over the ranks, as one
    all-reduce."""
    both = torch.stack(tensors)
    dist.all_reduce(both)
    return tuple(both.unbind(0))


def _leaf_values(G: torch.Tensor, H: torch.Tensor, params: Dict
                 ) -> torch.Tensor:
    """:func:`.gbdt.leaf_values` from summed float64 leaf sums."""
    w = -gbdt._threshold(G, params.get("reg_alpha", 0.0)) / (
        H + params.get("reg_lambda", 1.0))
    return w * params["learning_rate"]


def _leaf_sums(leaf: torch.Tensor, gw: torch.Tensor, hw: torch.Tensor,
               num_leaves: int):
    return _summed(torch.bincount(leaf, weights=gw, minlength=num_leaves),
                   torch.bincount(leaf, weights=hw, minlength=num_leaves))


def _tree_counts(trees: int, device) -> list:
    world = dist.get_world_size()
    mine = torch.tensor([trees], dtype=torch.int64, device=device)
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    return [int(p) for p in parts]


def rank_faults(ensemble, counts) -> int:
    """Ranks whose ensemble differs from rank 0's by a bit; ``counts`` is
    every rank's tree count (:func:`_tree_counts`)."""
    if any(c != counts[0] for c in counts):
        return sum(c != counts[0] for c in counts)
    differs = False
    for t in ensemble[:4]:
        t = t.contiguous()
        bits = (t.view(torch.int32) if t.dtype == torch.float32
                else t.to(torch.int32))
        ref = bits.clone()
        dist.broadcast(ref, src=0)
        differs |= not torch.equal(bits, ref)
    flag = torch.tensor([float(differs)], dtype=torch.float64,
                        device=ensemble[0].device)
    dist.all_reduce(flag)
    return int(flag)


def judge_train_dp(bins: torch.Tensor, label: torch.Tensor, ensemble,
                   margin: torch.Tensor, params: Dict, expected_trees: int,
                   checked: Iterable[int], hist_dtype: Optional[str]
                   ) -> Dict[str, float]:
    """The numbers compared for a job sharded by rows, the same on every
    rank: ``bins``, ``label`` and ``margin`` are this rank's rows,
    ``ensemble`` this rank's (split_feat, split_bin, leaf_value,
    default_left) stacked over trees; ``checked`` the trees whose splits
    are recomputed."""
    gbdt.check_supported(params)
    _check_rows_unsampled(params)
    sf_all, sb_all, lv_all, dl_all = (t.to(bins.device) for t in ensemble)
    dev = bins.device
    B, F = bins.shape
    depth = params["max_depth"]
    nb = params["num_bins"]
    gamma = params.get("min_split_loss", 0.0)
    T = sf_all.shape[0]
    counts = _tree_counts(T, dev)
    faults = rank_faults((sf_all, sb_all, lv_all, dl_all), counts)
    shape_faults = (abs(T - expected_trees) + int(dl_all.sum())
                    + int((sf_all >= F).sum()) + int((sf_all < -1).sum())
                    + int(((sf_all >= 0) & ((sb_all < 0)
                                            | (sb_all >= nb - 1))).sum()))
    checked = set(checked)
    split_gap = 0.0
    leaf_errs = []
    ref_margin = torch.zeros(B, dtype=torch.float32, device=dev)
    # every rank follows the same trees, so the collectives pair up
    for t in range(min(counts)):
        sf, sb, lv = sf_all[t], sb_all[t], lv_all[t].to(torch.float32)
        g, h = gbdt.grad_hess(ref_margin, label)
        _, tree_mask = gbdt.tree_draws(params, t, B, F, dev)
        node = torch.zeros(B, dtype=torch.int64, device=dev)
        if t in checked:
            gh, hh = gbdt.rounded(g, hist_dtype), gbdt.rounded(h, hist_dtype)
        for d in range(depth):
            lvl = slice(2 ** d - 1, 2 ** (d + 1) - 1)
            if t in checked:
                G, H = _summed(*gbdt.histogram(bins, node, gh, hh, 2 ** d,
                                               nb))
                allowed = gbdt.level_mask(params, t, d, F, tree_mask, dev)
                gain, parent = gbdt.split_gains(G, H, params, allowed)
                del G, H
                split_gap = max(split_gap, check._gap(gain, parent, sf[lvl],
                                                      sb[lvl], gamma))
                del gain
            node = gbdt.route(bins, node, sf[lvl], sb[lvl])
        ref_lv = _leaf_values(*_leaf_sums(node, g.to(torch.float64),
                                          h.to(torch.float64), 2 ** depth),
                              params)
        scale = torch.maximum(ref_lv.abs(), ref_lv.abs().median()).clamp(
            min=check._TINY)
        leaf_errs.append(check._max((lv.to(torch.float64) - ref_lv).abs()
                                    / scale))
        ref_margin = ref_margin + lv[node]
    widest = torch.tensor(
        [shape_faults, split_gap,
         statistics.median(leaf_errs) if leaf_errs else 0.0,
         check._max((margin.to(torch.float32) - ref_margin).abs())],
        dtype=torch.float64, device=dev)
    dist.all_reduce(widest, op=dist.ReduceOp.MAX)
    shape_faults, split_gap, leaf_err_med, margin_err = widest.tolist()
    return {"shape_faults": shape_faults, "split_gap": split_gap,
            "leaf_err_med": leaf_err_med, "margin_err": margin_err,
            "rank_faults": float(faults)}


def build_tree_dp(bins: torch.Tensor, margin: torch.Tensor,
                  label: torch.Tensor, params: Dict, rnd: int,
                  hist_dtype: Optional[str], leaf_dtype: Optional[str]):
    """:func:`.gbdt.build_tree` over this rank's rows with the histograms
    and leaf sums summed over the ranks; returns (split_feat, split_bin,
    leaf_value, this rank's new margin)."""
    _check_rows_unsampled(params)
    B, F = bins.shape
    dev = bins.device
    depth = params["max_depth"]
    nb = params["num_bins"]
    g, h = gbdt.grad_hess(margin, label)
    _, tree_mask = gbdt.tree_draws(params, rnd, B, F, dev)
    gh, hh = gbdt.rounded(g, hist_dtype), gbdt.rounded(h, hist_dtype)
    sf = torch.full((2 ** depth - 1,), -1, dtype=torch.int32, device=dev)
    sb = torch.zeros((2 ** depth - 1,), dtype=torch.int32, device=dev)
    node = torch.zeros(B, dtype=torch.int64, device=dev)
    for d in range(depth):
        n = 2 ** d
        G, H = _summed(*gbdt.histogram(bins, node, gh, hh, n, nb))
        allowed = gbdt.level_mask(params, rnd, d, F, tree_mask, dev)
        gain, _ = gbdt.split_gains(G, H, params, allowed)
        bf, bb, best = gbdt.best_splits(gain, nb)
        split = best > params.get("min_split_loss", 0.0)
        lvl = slice(n - 1, 2 * n - 1)
        sf[lvl] = torch.where(split, bf, -1).to(torch.int32)
        sb[lvl] = bb.to(torch.int32)
        node = gbdt.route(bins, node, sf[lvl], sb[lvl])
    lv = _leaf_values(*_leaf_sums(node, gbdt.rounded(g, leaf_dtype),
                                  gbdt.rounded(h, leaf_dtype), 2 ** depth),
                      params).to(torch.float32)
    return sf, sb, lv, margin + lv[node]
