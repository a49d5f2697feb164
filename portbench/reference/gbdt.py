"""Plain PyTorch reference of histogram gradient-boosted trees.

What the benchmark holds the port's trees and scores against: XGBoost's
``hist`` semantics for binary logistic loss, written from the algorithm and
not from the port.  Rows are routed level by level through level-order
trees (``split_feat`` / ``split_bin`` ``[2**d - 1]``, -1 = no split, a row
goes right when its bin is above the split bin; ``leaf_value`` ``[2**d]``).
Histograms are segment sums of per-row gradients over (node, feature, bin),
summed in float64 by ``torch.bincount``; the split scan is a cumulative sum
over bins, the regularised gain and the first maximum over (feature, bin).
Row and column draws recompute the program's Threefry bits with the frozen
copy beside this file.

Precision is a parameter: ``hist_dtype`` is the type the per-row gradients
are rounded to before they enter a histogram (the configuration states it),
``leaf_dtype`` the type they are rounded to before the leaf sums.  The
control runs these functions one step lower than the configuration.

Runs on any device: the CPU in tests, the card after a run's window.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from portbench.reference import threefry

# one bincount call covers at most this many (row, feature) elements
_BLOCK = 1 << 25

# parameters the reference implements, with the value that means "off" for
# the ones it does not
_UNSUPPORTED = {"objective": "logistic", "handle_missing": False,
                "monotone_constraints": "", "max_delta_step": 0.0,
                "colsample_bynode": 1.0, "scale_pos_weight": 1.0,
                "base_score": 0.0, "num_class": 1}


def check_supported(params: Dict) -> None:
    """Raise where ``params`` asks for something this reference does not
    implement (it would then judge a different model)."""
    for key, off in _UNSUPPORTED.items():
        if params.get(key, off) != off:
            raise ValueError(f"the reference implements {key}={off!r} only, "
                             f"the configuration asks for {params[key]!r}")


def rounded(x: torch.Tensor, dtype: Optional[str]) -> torch.Tensor:
    """``x`` (float32) rounded to ``dtype`` (nearest even) and widened to
    float64; ``None`` or ``"float32"`` keeps it as it is, ``"tfloat32"``
    keeps 10 mantissa bits, as a TF32 matmul reads its inputs."""
    if dtype == "tfloat32":
        i = x.contiguous().view(torch.int32)
        i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
        x = i.view(torch.float32)
    elif dtype not in (None, "float32"):
        x = x.to(getattr(torch, dtype)).to(torch.float32)
    return x.to(torch.float64)


def grad_hess(margin: torch.Tensor, label: torch.Tensor):
    """Logistic loss gradients in float32: ``(p - y, p (1 - p))``."""
    p = 1.0 / (1.0 + torch.exp(-margin))
    return p - label, p * (1.0 - p)


def _rate(x: float) -> float:
    """A sampling rate as the float32 the draws are compared with."""
    return float(np.float32(x))


def tree_draws(params: Dict, rnd: int, rows: int, features: int, device
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Round ``rnd``'s (row weight [rows] f32, tree feature mask [F] bool),
    each None at a rate of 1: ``subsample`` keeps a row where its uniform
    draw lies below the rate, ``colsample_bytree`` a feature likewise, and
    the feature with the smallest draw always stays."""
    row_w = tree_mask = None
    sub = params.get("subsample", 1.0)
    col = params.get("colsample_bytree", 1.0)
    if sub < 1.0 or col < 1.0:
        key = threefry.fold_in(threefry.prng_key(params.get("seed", 0)), rnd)
        if sub < 1.0:
            u = threefry.uniform(threefry.fold_in(key, 0), (rows,), device)
            row_w = (u < _rate(sub)).to(torch.float32)
        if col < 1.0:
            u = threefry.uniform(threefry.fold_in(key, 1), (features,),
                                 device)
            tree_mask = u < _rate(col)
            tree_mask[torch.argmin(u)] = True
    return row_w, tree_mask


def level_mask(params: Dict, rnd: int, depth: int, features: int,
               tree_mask: Optional[torch.Tensor], device
               ) -> Optional[torch.Tensor]:
    """The features a level may split on ([F] bool), or None for all:
    ``colsample_bylevel`` draws from the tree mask's survivors with a key of
    its own per (round, depth); without it the tree mask holds."""
    rate = params.get("colsample_bylevel", 1.0)
    if rate >= 1.0:
        return tree_mask
    key = threefry.fold_in(threefry.prng_key(params.get("seed", 0)), rnd)
    key = threefry.fold_in(threefry.fold_in(key, 7), depth)
    allowed = (tree_mask if tree_mask is not None
               else torch.ones((features,), dtype=torch.bool, device=device))
    u = torch.where(allowed, threefry.uniform(key, (features,), device),
                    float("inf"))
    allowed = (u < _rate(rate)) & allowed
    allowed[torch.argmin(u)] = True
    return allowed


def histogram(bins: torch.Tensor, node: torch.Tensor, gw: torch.Tensor,
              hw: torch.Tensor, num_nodes: int, num_bins: int):
    """(G, H), each ``[num_nodes, F, num_bins]`` float64: the sums of
    ``gw`` and ``hw`` (float64 [B]) over the rows of each node whose
    feature takes each bin.  Rows in blocks, features in groups, one
    ``bincount`` of both sums per block."""
    B, F = bins.shape
    dev = bins.device
    out = torch.zeros(2, num_nodes * F * num_bins, dtype=torch.float64,
                      device=dev)
    rows = min(B, max(1, _BLOCK // F))
    group = max(1, min(F, _BLOCK // max(rows, 1)))
    width = num_nodes * num_bins
    for r0 in range(0, B, rows):
        r1 = min(B, r0 + rows)
        nd = node[r0:r1].to(torch.int64)
        g = gw[r0:r1]
        h = hw[r0:r1]
        for f0 in range(0, F, group):
            f1 = min(F, f0 + group)
            k = f1 - f0
            cols = torch.arange(k, device=dev, dtype=torch.int64)
            # (feature in the group, node, bin) of every (row, feature)
            idx = (cols[None, :] * width + nd[:, None] * num_bins
                   + bins[r0:r1, f0:f1].to(torch.int64)).reshape(-1)
            sums = torch.bincount(
                torch.cat([idx, idx + k * width]),
                weights=torch.cat([g[:, None].expand(-1, k).reshape(-1),
                                   h[:, None].expand(-1, k).reshape(-1)]),
                minlength=2 * k * width)
            sums = sums.reshape(2, k, num_nodes, num_bins)
            out.view(2, F, num_nodes, num_bins)[:, f0:f1] += sums
    out = out.view(2, F, num_nodes, num_bins).permute(0, 2, 1, 3)
    return out[0], out[1]


def _threshold(G: torch.Tensor, alpha: float) -> torch.Tensor:
    if alpha == 0.0:
        return G
    return torch.sign(G) * torch.clamp(torch.abs(G) - alpha, min=0.0)


def split_gains(G: torch.Tensor, H: torch.Tensor, params: Dict,
                allowed: Optional[torch.Tensor]):
    """The gain of every candidate split ``[n, F, nbins]`` (left: bins up
    to and including the candidate), -inf where the split is not allowed
    (a child under ``min_child_weight``, the last bin, a masked feature),
    and the parent's score ``[n]``, so ``gain + parent`` is the children's
    summed score."""
    lam = params.get("reg_lambda", 1.0)
    alpha = params.get("reg_alpha", 0.0)
    mcw = params.get("min_child_weight", 1.0)

    def score(g, h):
        return _threshold(g, alpha) ** 2 / (h + lam)

    GL = torch.cumsum(G, dim=-1)
    HL = torch.cumsum(H, dim=-1)
    GT = GL[..., -1:]
    HT = HL[..., -1:]
    parent = score(GT, HT)
    gain = score(GL, HL) + score(GT - GL, HT - HL) - parent
    valid = (HL >= mcw) & (HT - HL >= mcw)
    valid[..., -1] = False
    if allowed is not None:
        valid &= allowed[None, :, None]
    return torch.where(valid, gain, -float("inf")), parent[:, 0, 0]


def best_splits(gain: torch.Tensor, num_bins: int):
    """(feature, bin, gain) of each node's first best candidate."""
    flat = gain.reshape(gain.shape[0], -1)
    best = torch.argmax(flat, dim=1)
    return best // num_bins, best % num_bins, flat.gather(
        1, best[:, None])[:, 0]


def route(bins: torch.Tensor, node: torch.Tensor, sf: torch.Tensor,
          sb: torch.Tensor) -> torch.Tensor:
    """Every row one level down: ``node`` indexes this level's ``sf`` and
    ``sb``; a row goes right when the node splits and its bin lies above
    the split bin."""
    f = sf.to(torch.int64)[node]
    row_bin = torch.gather(bins, 1, f.clamp(min=0)[:, None])[:, 0]
    right = (row_bin.to(torch.int64) > sb.to(torch.int64)[node]) & (f >= 0)
    return node * 2 + right.to(torch.int64)


def leaves(bins: torch.Tensor, split_feat: torch.Tensor,
           split_bin: torch.Tensor, max_depth: int) -> torch.Tensor:
    """The leaf slot of every row in one tree."""
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=bins.device)
    for d in range(max_depth):
        lvl = slice(2 ** d - 1, 2 ** (d + 1) - 1)
        node = route(bins, node, split_feat[lvl], split_bin[lvl])
    return node


def leaf_values(leaf: torch.Tensor, gw: torch.Tensor, hw: torch.Tensor,
                num_leaves: int, params: Dict) -> torch.Tensor:
    """Shrunk optimal leaf weights [num_leaves] float64 from the float64
    per-row sums of ``gw`` and ``hw``."""
    G = torch.bincount(leaf, weights=gw, minlength=num_leaves)
    H = torch.bincount(leaf, weights=hw, minlength=num_leaves)
    w = -_threshold(G, params.get("reg_alpha", 0.0)) / (
        H + params.get("reg_lambda", 1.0))
    return w * params["learning_rate"]


def build_tree(bins: torch.Tensor, margin: torch.Tensor,
               label: torch.Tensor, params: Dict, rnd: int,
               hist_dtype: Optional[str], leaf_dtype: Optional[str]):
    """Grow round ``rnd``'s tree from ``margin`` (float32 [B]); returns
    (split_feat int32, split_bin int32, leaf_value float32, new margin)."""
    B, F = bins.shape
    dev = bins.device
    depth = params["max_depth"]
    nb = params["num_bins"]
    g, h = grad_hess(margin, label)
    row_w, tree_mask = tree_draws(params, rnd, B, F, dev)
    if row_w is not None:
        g, h = g * row_w, h * row_w
    gh, hh = rounded(g, hist_dtype), rounded(h, hist_dtype)
    sf = torch.full((2 ** depth - 1,), -1, dtype=torch.int32, device=dev)
    sb = torch.zeros((2 ** depth - 1,), dtype=torch.int32, device=dev)
    node = torch.zeros(B, dtype=torch.int64, device=dev)
    for d in range(depth):
        n = 2 ** d
        G, H = histogram(bins, node, gh, hh, n, nb)
        allowed = level_mask(params, rnd, d, F, tree_mask, dev)
        gain, _ = split_gains(G, H, params, allowed)
        bf, bb, best = best_splits(gain, nb)
        split = best > params.get("min_split_loss", 0.0)
        lvl = slice(n - 1, 2 * n - 1)
        sf[lvl] = torch.where(split, bf, -1).to(torch.int32)
        sb[lvl] = bb.to(torch.int32)
        node = route(bins, node, sf[lvl], sb[lvl])
    lv = leaf_values(node, rounded(g, leaf_dtype), rounded(h, leaf_dtype),
                     2 ** depth, params).to(torch.float32)
    return sf, sb, lv, margin + lv[node]
