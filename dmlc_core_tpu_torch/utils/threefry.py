"""Threefry-2x32 counter-based random draws, bit for bit ``jax.random``'s.

The JAX package draws its row and column samples with ``jax.random``
(``PRNGKey``, ``fold_in``, ``uniform``) under partitionable threefry: the
bits of element ``i`` depend only on the key and ``i``.  This module
computes the same bits with integer tensor ops, so a draw on the card is
bitwise the draw on the host, and a rank can draw just its slice of a
global draw (``uniform(..., offset=)``).

torch has few uint32 ops, so every word is an int64 tensor (or, for a
single block such as ``fold_in``'s, a Python int) holding a value in
``[0, 2**32)``; sums and shifts are masked back to 32 bits.  A key is a
pair of Python ints ``(k0, k1)``, so deriving keys costs no tensor op.
"""

from __future__ import annotations

from typing import Sequence, Tuple, TypeVar

import torch

__all__ = ["prng_key", "fold_in", "threefry2x32", "uniform"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]
Word = TypeVar("Word", int, torch.Tensor)


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed is
    taken as an int32, so the high word is 0 and the low word is the seed
    mod 2**32 (``2**33 + 5`` gives ``(0, 5)``, ``-1`` gives
    ``(0, 0xffffffff)``)."""
    return 0, int(seed) & _MASK


def _rotl(v: Word, r: int) -> Word:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(key: Key, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The 20-round Threefry-2x32 block function on counter words
    ``(x0, x1)``: int64 tensors, or Python ints, of values in
    ``[0, 2**32)``."""
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
    """``jax.random.fold_in(key, data)``: the block function of the key on
    the counter ``(0, data mod 2**32)``; its two words are the new key."""
    return threefry2x32(key, 0, int(data) & _MASK)


def uniform(key: Key, shape: Sequence[int], device=None, offset: int = 0
            ) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1) as float32 on
    ``device``.  ``offset`` skips that many leading elements of the flat
    draw: ``uniform(k, (n,), offset=o)`` is ``uniform(k, (o + n,))[o:]``."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    i = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, i >> 32, i & _MASK)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)
