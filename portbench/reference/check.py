"""The comparisons that decide a run's ``correct``.

Each judge takes the inputs the benchmark made (bins, labels, the scoring
model) and what the program produced in its window, recomputes what the
program derived with :mod:`.gbdt`, and returns the numbers compared, each
to be held under its limit.  Nothing here imports the port.

Training (:func:`judge_train`).  The program's trees are followed in
order: the reference routes every row through each tree with its own code,
keeps the margin those trees give, and from it the gradients and draws of
the next round.  For every tree it recomputes the leaf values from the
rows each leaf holds; for the trees chosen to be checked it
also recomputes, level by level, every node's histogram and split scan over
the rows the program's tree sends there, and measures how far the gain of
the program's split lies below the best gain.  So the reference follows the
program's own splits: a split is judged by its gain, not by equality.

- ``shape_faults``: trees missing or extra against the rounds run, default
  directions set (the configurations have no missing values), and split
  features or bins out of range.  Exact: 0.
- ``split_gap``: over the checked nodes, the widest (best gain - gain of
  the program's split) / (the best split's children's summed score); a
  node the program leaves unsplit is judged against ``min_split_loss``, and
  a split the reference does not allow reads infinite.
- ``leaf_err_med``: the median over trees of each tree's widest
  |program - reference| / max(|reference leaf|, median |leaf| of its
  tree).  The median, not the widest over all trees: the first few trees'
  leaf sums cancel (p is near 1/2 for every row), so their float32
  rounding reads 10-100x the others' and the widest swings from seed to
  seed, while the median is steady.
- ``margin_err``: the widest |program margin - the margin of the program's
  trees| after the last tree, over all rows.

Scoring (:func:`judge_score`): ``score_err`` is the widest |program score -
reference score| over a batch, the reference summing leaf values in
float64.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional

import torch

from portbench.reference import gbdt

_TINY = 1e-300


def _max(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def _gap(gain, parent, sf, sb, min_split_loss: float) -> float:
    """Widest normalised gap of one level's splits (see the module doc)."""
    n = gain.shape[0]
    flat = gain.reshape(n, -1)
    best = flat.max(dim=1).values
    split = sf >= 0
    pick = (sf.clamp(min=0) * gain.shape[2] + sb.clamp(min=0)).to(torch.int64)
    chosen = flat.gather(1, pick[:, None])[:, 0]
    scale = torch.where(torch.isfinite(best), (best + parent).clamp(
        min=_TINY), torch.full_like(best, _TINY))
    missed = torch.where(torch.isfinite(best),
                         (best - min_split_loss).clamp(min=0.0),
                         torch.zeros_like(best))
    below = torch.where(torch.isfinite(chosen), best - chosen,
                        torch.full_like(best, float("inf")))
    return _max(torch.where(split, below, missed) / scale)


def judge_train(bins: torch.Tensor, label: torch.Tensor, ensemble,
                margin: torch.Tensor, params: Dict, expected_trees: int,
                checked: Iterable[int], hist_dtype: Optional[str]
                ) -> Dict[str, float]:
    """The numbers compared for a training job.  ``ensemble`` is the
    program's (split_feat, split_bin, leaf_value, default_left) stacked
    over trees, ``margin`` its margin after the last; ``checked`` are the
    trees whose splits are recomputed."""
    gbdt.check_supported(params)
    sf_all, sb_all, lv_all, dl_all = (t.to(bins.device) for t in ensemble)
    B, F = bins.shape
    depth = params["max_depth"]
    nb = params["num_bins"]
    gamma = params.get("min_split_loss", 0.0)
    T = sf_all.shape[0]
    shape_faults = (abs(T - expected_trees) + int(dl_all.sum())
                    + int((sf_all >= F).sum()) + int((sf_all < -1).sum())
                    + int(((sf_all >= 0) & ((sb_all < 0)
                                            | (sb_all >= nb - 1))).sum()))
    checked = set(checked)
    split_gap = 0.0
    leaf_errs = []
    ref_margin = torch.zeros(B, dtype=torch.float32, device=bins.device)
    for t in range(T):
        sf, sb, lv = sf_all[t], sb_all[t], lv_all[t].to(torch.float32)
        g, h = gbdt.grad_hess(ref_margin, label)
        row_w, tree_mask = gbdt.tree_draws(params, t, B, F, bins.device)
        if row_w is not None:
            g, h = g * row_w, h * row_w
        node = torch.zeros(B, dtype=torch.int64, device=bins.device)
        if t in checked:
            gh, hh = gbdt.rounded(g, hist_dtype), gbdt.rounded(h, hist_dtype)
        for d in range(depth):
            lvl = slice(2 ** d - 1, 2 ** (d + 1) - 1)
            if t in checked:
                G, H = gbdt.histogram(bins, node, gh, hh, 2 ** d, nb)
                allowed = gbdt.level_mask(params, t, d, F, tree_mask,
                                          bins.device)
                gain, parent = gbdt.split_gains(G, H, params, allowed)
                del G, H
                split_gap = max(split_gap, _gap(gain, parent, sf[lvl],
                                                sb[lvl], gamma))
                del gain
            node = gbdt.route(bins, node, sf[lvl], sb[lvl])
        ref_lv = gbdt.leaf_values(node, g.to(torch.float64),
                                  h.to(torch.float64), 2 ** depth, params)
        scale = torch.maximum(ref_lv.abs(), ref_lv.abs().median()).clamp(
            min=_TINY)
        leaf_errs.append(_max((lv.to(torch.float64) - ref_lv).abs()
                              / scale))
        ref_margin = ref_margin + lv[node]
    margin_err = _max((margin.to(torch.float32) - ref_margin).abs())
    return {"shape_faults": float(shape_faults), "split_gap": split_gap,
            "leaf_err_med": statistics.median(leaf_errs) if leaf_errs
            else 0.0, "margin_err": margin_err}


def reference_scores(bins: torch.Tensor, ensemble, max_depth: int,
                     dtype=torch.float64) -> torch.Tensor:
    """Logistic scores (float64) of ``bins`` under ``ensemble``
    (split_feat, split_bin, leaf_value), the margin summed tree by tree in
    ``dtype``."""
    sf_all, sb_all, lv_all = (t.to(bins.device) for t in ensemble[:3])
    margin = torch.zeros(bins.shape[0], dtype=dtype, device=bins.device)
    for t in range(sf_all.shape[0]):
        leaf = gbdt.leaves(bins, sf_all[t], sb_all[t], max_depth)
        margin = (margin + lv_all[t].to(dtype)[leaf]).to(dtype)
    margin = margin.to(torch.float64)
    return 1.0 / (1.0 + torch.exp(-margin))


def judge_score(bins: torch.Tensor, ensemble, scores: torch.Tensor,
                max_depth: int) -> Dict[str, float]:
    """The number compared for a scored batch."""
    ref = reference_scores(bins, ensemble, max_depth)
    return {"score_err": _max((scores.to(torch.float64) - ref).abs())}


def node_rows(bins: torch.Tensor, split_feat: torch.Tensor,
              split_bin: torch.Tensor, max_depth: int,
              row_w: Optional[torch.Tensor] = None):
    """Rows of every node at every level of one tree (a row of weight 0
    counts for none): a list of ``max_depth`` int64 tensors ``[2**d]``."""
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=bins.device)
    keep = None if row_w is None else (row_w > 0).to(torch.float64)
    out = []
    for d in range(max_depth):
        out.append(torch.bincount(node, weights=keep, minlength=2 ** d)
                   .to(torch.int64))
        lvl = slice(2 ** d - 1, 2 ** (d + 1) - 1)
        node = gbdt.route(bins, node, split_feat[lvl], split_bin[lvl])
    return out
