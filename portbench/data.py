"""Inputs made from the seed: binned rows, labels and a scoring model.

Everything bulky is drawn on the run's device by a ``torch.Generator``
seeded with ``--seed``, in blocks of rows; the few small choices (factor
loadings, which features the label reads) come from a CPU generator with
the same seed.  The same seed gives the same inputs.

Rows.  Each feature is a mix of a few shared normal factors and noise of
its own, so features are correlated as measured features are.  A feature
is binned through its own normal CDF into ``num_bins`` bins of equal mass,
which is what quantile binning gives, so every bin holds about the same
rows and no host binning runs.  The label is 1 where a seeded function of
the features (a linear part over some features and products of pairs of
others, standardised, plus normal noise) lies above its median, so the
classes are balanced and the trees find real gains.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

_BLOCK = 1 << 24          # (row, feature) elements drawn at a time


def _generators(seed: int, device) -> Tuple[torch.Generator,
                                             torch.Generator]:
    s = int(seed) & ((1 << 63) - 1)
    host = torch.Generator().manual_seed(s)
    dev = torch.Generator(device=device).manual_seed(s)
    return host, dev


def make_rows(data: Dict, rows: int, features: int, num_bins: int,
              seed: int, device, with_label: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(bins [rows, features] uint8, label [rows] float32 or None)``."""
    host, gen = _generators(seed, device)
    k = int(data["latent_factors"])
    noise = float(data["feature_noise"])
    loading = torch.randn(k, features, generator=host) / math.sqrt(k)
    sigma = torch.sqrt((loading ** 2).sum(0) + noise ** 2)
    n_lin = min(features, int(data["label_linear"]))
    lin = torch.randperm(features, generator=host)[:n_lin]
    w_lin = torch.randn(n_lin, generator=host)
    pairs = torch.randint(0, features, (int(data["label_pairs"]), 2),
                          generator=host)
    w_pair = torch.randn(pairs.shape[0], generator=host)
    loading, sigma, lin, w_lin, pairs, w_pair = (
        t.to(device) for t in (loading, sigma, lin, w_lin, pairs, w_pair))
    bins = torch.empty(rows, features, dtype=torch.uint8, device=device)
    score = (torch.empty(rows, dtype=torch.float32, device=device)
             if with_label else None)
    block = max(1, _BLOCK // features)
    for r0 in range(0, rows, block):
        r1 = min(rows, r0 + block)
        z = torch.randn(r1 - r0, k, generator=gen, device=device)
        e = torch.randn(r1 - r0, features, generator=gen, device=device)
        x = (z @ loading + noise * e) / sigma
        bins[r0:r1] = torch.clamp(torch.floor(torch.special.ndtr(x)
                                              * num_bins),
                                  0, num_bins - 1).to(torch.uint8)
        if with_label:
            score[r0:r1] = (x[:, lin] @ w_lin
                            + (x[:, pairs[:, 0]] * x[:, pairs[:, 1]])
                            @ w_pair)
    if not with_label:
        return bins, None
    score = (score - score.mean()) / score.std()
    score = score + float(data["label_noise"]) * torch.randn(
        rows, generator=gen, device=device)
    label = (score > score.median()).to(torch.float32)
    return bins, label


def make_ensemble(trees: int, max_depth: int, features: int, num_bins: int,
                  leaf_scale: float, seed: int, device):
    """A full ensemble drawn like random weights: every node splits on a
    uniform feature at a uniform bin below the last, leaf values are normal
    with standard deviation ``leaf_scale``.  Returns (split_feat int32,
    split_bin int32, leaf_value float32, default_left bool), each stacked
    over trees."""
    _, gen = _generators(seed + 1, device)
    internal = 2 ** max_depth - 1
    split_feat = torch.randint(0, features, (trees, internal), generator=gen,
                               device=device, dtype=torch.int32)
    split_bin = torch.randint(0, num_bins - 1, (trees, internal),
                              generator=gen, device=device,
                              dtype=torch.int32)
    leaf_value = leaf_scale * torch.randn(trees, 2 ** max_depth,
                                          generator=gen, device=device)
    default_left = torch.zeros((trees, internal), dtype=torch.bool,
                               device=device)
    return split_feat, split_bin, leaf_value, default_left
