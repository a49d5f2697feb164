"""Threefry-2x32 draws, a frozen copy for the benchmark's reference.

The port draws its row and column samples with the bits of ``jax.random``
under partitionable threefry (``PRNGKey``, ``fold_in``, ``uniform``): the
bits of element ``i`` depend only on the key and ``i``.  This file computes
the same bits with integer tensor ops and never changes with the port, so
the reference can recompute every draw the program made.  Words are int64
tensors (or Python ints) holding values in ``[0, 2**32)``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def prng_key(seed: int) -> Key:
    """``PRNGKey(seed)`` with 64-bit types off: ``(0, seed mod 2**32)``."""
    return 0, int(seed) & _MASK


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(key: Key, x0, x1):
    """The 20-round Threefry-2x32 block function on counter words."""
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def fold_in(key: Key, data: int) -> Key:
    """``fold_in(key, data)``: the block of the counter ``(0, data)``."""
    return threefry2x32(key, 0, int(data) & _MASK)


def uniform(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``uniform(key, shape)`` in [0, 1) as float32 on ``device``."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, i >> 32, i & _MASK)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)
