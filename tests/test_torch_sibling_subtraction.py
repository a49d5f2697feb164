"""Sibling subtraction in the port's tree growth (CPU; small trees).

Below the root ``_build_tree`` histograms, of the two children of every
node split at the level above, only the one with the smaller hessian sum
(an unsplit node's empty right child), and takes the other as the parent's
histogram less the built one.  Through a patched ``models.gbdt.
grad_histogram`` and ``_children`` these tests record every call and every
assembled level, and hold them against the tree's own routing: the kernel
sees ``2**(d-1)`` nodes at depth ``d``, only the built children's rows carry
an in-range id, and each level's assembled (G, H) is a direct histogram of
that level's node ids within float32 rounding.
"""

import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch.models import gbdt

ROWS, F, NB, DEPTH = 800, 5, 16, 4

CASES = {
    "plain": dict(),
    # a heavy hessian floor leaves nodes above the last level unsplit
    "unsplit": dict(min_child_weight=40.0),
    "missing": dict(missing=True),
}


def _inputs(case):
    gen = torch.Generator().manual_seed(11)
    bins = torch.randint(0, NB - 1, (ROWS, F), generator=gen,
                         dtype=torch.int32)
    if case == "missing":
        # the last bin is the missing one; feature 0's missing rows lean
        # left, so default-left splits win
        hole = torch.rand(ROWS, F, generator=gen) < 0.2
        bins = torch.where(hole, NB - 1, bins)
    margin = (bins[:, 0].to(torch.float32) - NB / 2) / 4 \
        + torch.randn(ROWS, generator=gen)
    if case == "missing":
        margin = torch.where(bins[:, 0] == NB - 1, -3.0, margin)
    label = (margin > 0).to(torch.float32)
    p = torch.sigmoid(0.3 * torch.randn(ROWS, generator=gen))
    weight = torch.rand(ROWS, generator=gen) + 0.5
    return bins, (p - label) * weight, p * (1 - p) * weight


def _levels(bins, sf, sb, dl, missing):
    """Each row's node id at every level, routed by the tree itself."""
    node = torch.zeros(ROWS, dtype=torch.int64)
    out = []
    for d in range(DEPTH):
        out.append(node)
        lvl = slice(2 ** d - 1, 2 ** (d + 1) - 1)
        f, b, left = sf[lvl][node], sb[lvl][node], dl[lvl][node]
        row_bin = torch.gather(bins, 1, f.clamp(min=0)[:, None].long())[:, 0]
        right = (row_bin > b) & (f >= 0)
        if missing:
            right = right & ~((row_bin == NB - 1) & left)
        node = node * 2 + right.to(torch.int64)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method", ["scatter", "onehot"])
def test_build_tree_histograms_the_smaller_child(monkeypatch, method, case):
    calls, assembled = [], []
    real_hist, real_children = gbdt.grad_histogram, gbdt._children

    def hist(bins, node_ids, g, h, num_nodes, *a, **k):
        calls.append((node_ids.clone(), num_nodes))
        return real_hist(bins, node_ids, g, h, num_nodes, *a, **k)

    def children(parent, built, build_right):
        out = real_children(parent, built, build_right)
        assembled.append(out.clone())
        return out

    monkeypatch.setattr(gbdt, "grad_histogram", hist)
    monkeypatch.setattr(gbdt, "_children", children)
    bins, g, h = _inputs(case)
    kw = CASES[case]
    sf, sb, _, dl, _, _, _ = gbdt._build_tree(
        bins, g, h, DEPTH, NB, reg_lambda=1.0,
        min_child_weight=kw.get("min_child_weight", 1.0), learning_rate=0.3,
        method=method, missing=kw.get("missing", False))
    levels = _levels(bins, sf, sb, dl, kw.get("missing", False))

    assert [n for _, n in calls] == [1] + [2 ** (d - 1)
                                           for d in range(1, DEPTH)]
    assert torch.equal(calls[0][0], torch.zeros(ROWS, dtype=torch.int64))
    # two assembled tensors (G, H) a level below the root
    assert len(assembled) == 2 * (DEPTH - 1)
    for d in range(1, DEPTH):
        node, (ids, built) = levels[d], calls[d]
        inside = (ids >= 0) & (ids < built)
        parent = node // 2
        assert torch.equal(ids[inside], parent[inside])
        for p in range(built):
            rows = parent == p
            sides = (node[rows & inside] % 2).unique().tolist()
            hl = float(h[rows & (node % 2 == 0)].sum())
            hr = float(h[rows & (node % 2 == 1)].sum())
            if not sides:
                # nothing built: the chosen child is empty (the right one
                # of an unsplit node, or an empty node's)
                assert hr == 0.0 or not bool(rows.any())
                continue
            side, = sides
            # every row of the built child, and no other, is in range
            assert int((rows & inside).sum()) == int(
                (rows & (node % 2 == side)).sum())
            small, large = (hr, hl) if side else (hl, hr)
            assert small <= large + 1e-5 * (hl + hr)
        G, H = assembled[2 * (d - 1)], assembled[2 * d - 1]
        Gd, Hd = real_hist(bins, node, g, h, 2 ** d, NB, method=method,
                           device="cpu")
        scale = float(h.sum())
        np.testing.assert_allclose(G.numpy(), Gd.numpy(), rtol=1e-5,
                                   atol=1e-6 * scale)
        np.testing.assert_allclose(H.numpy(), Hd.numpy(), rtol=1e-5,
                                   atol=1e-6 * scale)

    inner = sf[:2 ** (DEPTH - 1) - 1]
    if case == "unsplit":
        # the case reaches what it is for: unsplit nodes above the last
        # level, whose children are histogrammed
        assert bool((inner < 0).any()) and bool((inner >= 0).any())
    if case == "missing":
        assert bool(dl[:2 ** (DEPTH - 1) - 1].any())


def test_children_puts_each_child_on_its_side():
    parent = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    built = torch.full((2, 3, 4), 0.5)
    build_right = torch.tensor([True, False])
    out = gbdt._children(parent.clone(), built, build_right)
    assert out.shape == (4, 3, 4)
    assert torch.equal(out[0], parent[0] - 0.5)     # node 0: left = other
    assert torch.equal(out[1], built[0])            # right built
    assert torch.equal(out[2], built[1])            # node 1: left built
    assert torch.equal(out[3], parent[1] - 0.5)
