"""One rank's shard of a table that several ranks hold by rows.

:func:`make_shard` makes rank ``rank``'s rows of one global table from the
seed, on the rank's own device, the way :func:`portbench.data.make_rows`
makes a whole table: shared normal factors plus noise, each feature binned
through its own normal CDF into bins of equal mass, a label from a seeded
function of the features cut near its median.  What must be one function
over the whole table comes from the seed alone: the factor loadings, the
features and weights the label reads (drawn as ``make_rows`` draws them),
and the label's standardisation and cut, taken from a pilot of
``PILOT_ROWS`` rows drawn from the seed's own device stream.  The rows
and their label noise come from a stream keyed by (seed, rank).  So the
same seed gives the same global table, shard by shard, and no rank waits
on another to make its rows.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench import data

PILOT_ROWS = 1 << 18
_MASK64 = (1 << 64) - 1


def stream_seed(seed: int, rank: int) -> int:
    """A generator seed for rank ``rank``'s rows (splitmix64 of the pair)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + rank + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def make_shard(spec: Dict, rows: int, features: int, num_bins: int,
               seed: int, rank: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(bins [rows, features] uint8, label [rows] float32)``: rank
    ``rank``'s rows of the table the seed makes (``spec`` is a
    configuration's ``data``)."""
    host, pilot_gen = data._generators(seed, device)
    k = int(spec["latent_factors"])
    noise = float(spec["feature_noise"])
    label_noise = float(spec["label_noise"])
    loading = torch.randn(k, features, generator=host) / math.sqrt(k)
    sigma = torch.sqrt((loading ** 2).sum(0) + noise ** 2)
    n_lin = min(features, int(spec["label_linear"]))
    lin = torch.randperm(features, generator=host)[:n_lin]
    w_lin = torch.randn(n_lin, generator=host)
    pairs = torch.randint(0, features, (int(spec["label_pairs"]), 2),
                          generator=host)
    w_pair = torch.randn(pairs.shape[0], generator=host)
    loading, sigma, lin, w_lin, pairs, w_pair = (
        t.to(device) for t in (loading, sigma, lin, w_lin, pairs, w_pair))

    def draw(gen, n):
        z = torch.randn(n, k, generator=gen, device=device)
        e = torch.randn(n, features, generator=gen, device=device)
        x = (z @ loading + noise * e) / sigma
        score = (x[:, lin] @ w_lin
                 + (x[:, pairs[:, 0]] * x[:, pairs[:, 1]]) @ w_pair)
        return x, score

    # the label function's standardisation and cut, from the seed alone
    _, score = draw(pilot_gen, PILOT_ROWS)
    mean, std = score.mean(), score.std()
    cut = ((score - mean) / std + label_noise * torch.randn(
        PILOT_ROWS, generator=pilot_gen, device=device)).median()

    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, rank))
    bins = torch.empty(rows, features, dtype=torch.uint8, device=device)
    label = torch.empty(rows, dtype=torch.float32, device=device)
    block = max(1, data._BLOCK // features)
    for r0 in range(0, rows, block):
        r1 = min(rows, r0 + block)
        x, score = draw(gen, r1 - r0)
        bins[r0:r1] = torch.clamp(torch.floor(torch.special.ndtr(x)
                                              * num_bins),
                                  0, num_bins - 1).to(torch.uint8)
        noisy = (score - mean) / std + label_noise * torch.randn(
            r1 - r0, generator=gen, device=device)
        label[r0:r1] = (noisy > cut).to(torch.float32)
    return bins, label
