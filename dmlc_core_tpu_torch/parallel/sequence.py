"""Sequence parallelism: ring attention and Ulysses all-to-all attention.

Counterpart of ``dmlc_core_tpu/parallel/sequence.py``.  Layout: every
tensor is ``[B, L, H, D]`` (batch, sequence, heads, head width), the
reference's; scores are ``[B, H, Lq, Lk]``.  The reference takes global
arrays and splits them with ``shard_map`` over one mesh axis; here every
rank is a process, so each rank passes its own sequence block (the rows
``[c * L/n, (c + 1) * L/n)`` of the global arrays on the rank at axis
coordinate ``c``, :func:`shard_sequence`) and gets its block of the output.

- :func:`ring_attention`: the online-softmax scan of the reference's
  ``_ring_attention_local``: the rank's Q stays, the K/V blocks go round
  the ring through :func:`..collective.mesh_collectives.ppermute` (K and V
  stacked into one send a step), and each step folds one block into the
  running max, sum and output.  The causal mask uses the global positions
  ``c * Lq + i`` and ``src * Lk + j`` with ``src = (c - t) % n``; the
  ``finfo.min`` initial max and the ``isfinite`` guards are the
  reference's, so rows that see no key in a step stay exact.
- :func:`ulysses_attention`: an all-to-all from sequence blocks to head
  blocks, :func:`reference_attention` over the whole sequence for the
  rank's heads, and the all-to-all back.

Both compute in float32, as the reference's ``preferred_element_type``
asks, with ``torch.matmul``/``einsum`` (the reference's einsums run
outside any Pallas kernel, so these are its port; no fused attention
kernel is used).  On the card TF32 must stay off and the float32 matmul
precision at ``"highest"``: both functions check it.  Both are
differentiable: the gradient flows back through the inverse shift and the
inverse all-to-all, so every rank of the axis must run the backward, in
the same order, and the gradients of q, k and v are the rank's blocks of
full attention's.
"""

from __future__ import annotations

from typing import Optional

import torch

from dmlc_core_tpu_torch.collective.mesh_collectives import (MeshCollective,
                                                         all_to_all,
                                                         ppermute)
from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["ring_attention", "ulysses_attention", "reference_attention",
           "shard_sequence"]


def reference_attention(q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain full attention (the correctness oracle). Shapes [B, L, H, D]."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        L, Lk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(Lk, device=s.device)[None, :]
                > torch.arange(L, device=s.device)[:, None])
        s = torch.where(mask[None, None], float("-inf"), s)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def shard_sequence(x, mesh, axis: str = "data"):
    """This rank's block of the global ``[B, L, ...]`` array ``x`` along
    the sequence: rows ``[c * L/n, (c + 1) * L/n)`` at axis coordinate
    ``c``.  ``L`` must divide by the axis size."""
    n = mesh.axis_size(axis)
    CHECK(x.shape[1] % n == 0,
          "sequence length must divide the mesh axis size")
    k = x.shape[1] // n
    c = mesh.coord(axis)
    return x[:, c * k:(c + 1) * k]


def _check_precision(q) -> None:
    if q.is_cuda:
        CHECK(not torch.backends.cuda.matmul.allow_tf32
              and torch.get_float32_matmul_precision() == "highest",
              "sequence attention needs full float32 matmuls: TF32 off "
              "and the float32 matmul precision at 'highest'")


def ring_attention(q, k, v, mesh, axis: str = "data", causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over sequence blocks: ``q``, ``k``, ``v`` are this
    rank's ``[B, L/n, H, D]`` blocks along ``axis`` of ``mesh``; returns
    the rank's block of the output, in ``q``'s dtype.  Each rank holds its
    Q block and one K/V block at a time: O(L/n * L/n) scores a step."""
    CHECK(k.shape == v.shape and k.shape[0] == q.shape[0]
          and k.shape[2:] == q.shape[2:],
          f"ring_attention: k {tuple(k.shape)} and v {tuple(v.shape)} "
          f"do not fit q {tuple(q.shape)}")
    _check_precision(q)
    coll = MeshCollective(mesh, axis)
    n, my = coll.axis_size, coll.index
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    scale = sm_scale if sm_scale is not None else D ** -0.5
    dev = q.device
    f32 = torch.float32
    neg_inf = torch.finfo(f32).min
    qf = q.to(f32)
    kv = torch.stack([k, v]).to(f32)
    o = torch.zeros((B, Lq, H, D), dtype=f32, device=dev)
    m = torch.full((B, H, Lq), neg_inf, dtype=f32, device=dev)
    l = torch.zeros((B, H, Lq), dtype=f32, device=dev)   # noqa: E741
    q_pos = my * Lq + torch.arange(Lq, device=dev)
    for t in range(n):
        # the block held at step t came from rank (my - t) mod n
        src = (my - t) % n
        k_cur, v_cur = kv[0], kv[1]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_cur) * scale
        if causal:
            k_pos = src * Lk + torch.arange(Lk, device=dev)
            mask = (k_pos[None, :] > q_pos[:, None])[None, None]
            s = torch.where(mask, neg_inf, s)
        m_new = torch.maximum(m, s.amax(-1))
        # rows with no visible keys yet keep m at -inf; guard the exp
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        if causal:
            p = torch.where(mask, 0.0, p)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(-1)                        # noqa: E741
        o = (o * alpha.transpose(1, 2)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p, v_cur))
        m = m_new
        if t < n - 1:      # the reference's last rotation is never read
            kv = ppermute(kv, coll, 1)
    denom = torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return (o / denom).to(q.dtype)


def ulysses_attention(q, k, v, mesh, axis: str = "data",
                      causal: bool = False,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention by all-to-all head/sequence resharding: ``q``,
    ``k``, ``v`` are this rank's ``[B, L/n, H, D]`` sequence blocks;
    returns its block of the output.  Requires H % axis_size == 0."""
    CHECK(q.shape[2] % mesh.axis_size(axis) == 0,
          "num heads must divide the mesh axis size")
    CHECK(k.shape == v.shape and k.shape[2] == q.shape[2],
          f"ulysses_attention: k {tuple(k.shape)} and v {tuple(v.shape)} "
          f"do not fit q {tuple(q.shape)}")
    _check_precision(q)
    coll = MeshCollective(mesh, axis)
    f32 = torch.float32

    # [B, L/n, H, D] -> [B, L, H/n, D]: split heads, gather sequence
    def to_heads(x):
        return all_to_all(x.to(f32), coll, 2, 1)

    oh = reference_attention(to_heads(q), to_heads(k), to_heads(v),
                             causal=causal, sm_scale=sm_scale)
    return all_to_all(oh, coll, 1, 2).to(q.dtype)
