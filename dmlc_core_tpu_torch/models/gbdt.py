"""Histogram gradient-boosted trees on tensors (hist-GBDT on the H100).

Counterpart of ``dmlc_core_tpu/models/gbdt.py``: the same trees, grown
level by level from per-(node, feature, bin) gradient histograms, with the
same split scan (cumsum over bins, gain, first-maximum argmax), missing
values, monotone constraints, L1 and ``max_delta_step``.  Where the
reference compiles a round into one XLA program and scans over rounds, the
port runs eagerly: a Python loop over rounds and levels, each level one
histogram (the CUDA kernel on the card) plus a few tensor ops.  Below the
root a level histograms only the smaller child of each node split above it
and takes the other child as the parent's histogram less the built one
(sibling subtraction): the same trees, at half the kernel's nodes.

Distributed training follows the reference's mesh semantics with one
process per rank (:mod:`..parallel.mesh`): under ``with mesh:`` each rank
fits on its own rows, every level's histogram is summed over the mesh's
row axes (``data``, or the hybrid mesh's ``("dcn_data", "ici_data")``
under ``with data_sharding(mesh, axis=...)``; and, with ``model_axis``,
computed by K4 on the rank's feature window and gathered over the
``model`` group), the split scan runs on every rank on identical sums,
and leaf sums are summed over the same row axes.  Every rank ends with
the same ensemble; margins stay local.

Beside fitting and scoring it carries the reference's estimator extras:
``fit_with_eval`` (eval-set losses, early stopping), ``staged_losses``,
``predict_leaf``, ``feature_importance`` and ``dump_trees``.

Row and column sampling (``subsample``, ``colsample_bytree|bylevel|
bynode``) draw the reference's ``jax.random`` bits through
:mod:`..utils.threefry`, keyed by (seed, round, class, depth) as there, on
the fit's device.  Under a mesh a rank draws its own slice of the one
draw over the global rows, so a sampled distributed fit grows the trees
of the single-process fit.

Each round records telemetry spans (:mod:`..telemetry`, also profiler
annotations while ``torch.profiler`` records): ``gbdt.round`` around
:meth:`GBDT._round`; in every tree ``gbdt.hist``, ``gbdt.split_scan`` and
``gbdt.route`` per level, ``gbdt.leaf`` once, and ``gbdt.draw`` around
each sampling draw (per tree, and per level inside ``gbdt.split_scan``);
``gbdt.predict`` around :meth:`GBDT.predict_margin`.  ``gbdt.hist``
holds the ``grad_histogram`` call alone; its ``nodes`` is the level's node
count and ``built`` the count the kernel histograms (1 at the root, half
the level's below).  Under a mesh whose row axes span more than one rank,
``gbdt.hist`` also holds the level's histogram all-reduce, and
``gbdt.leaf`` the leaf sums' all-reduce, each in its own inner
``collective.sum`` span (:mod:`..collective.mesh_collectives`), so a span's
self time leaves the all-reduce out.  Their attributes are host ints and
strings: no span reads the device.

Trees are stored level-order as in the reference: ``split_feat`` /
``split_bin`` [2**d - 1] with -1 marking "no split", ``leaf_value``
[2**d].

Persistence (``save_model``/``load_model``, ``serving_state``/
``from_serving_state``/``resume``) writes the reference's checkpoint
payload with its dtypes through :mod:`..bridge.checkpoint`, so a model
saved by either package loads in the other.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.bridge.checkpoint import (host_array,
                                                   load_checkpoint,
                                                   save_checkpoint)
from dmlc_core_tpu_torch.collective.mesh_collectives import (MeshCollective,
                                                         data_allreduce,
                                                         data_parallel)
from dmlc_core_tpu_torch.ops import hist_cuda
from dmlc_core_tpu_torch.ops.histogram import (
    apply_bins, as_tensor, bin_onehot, distributed_quantile_boundaries,
    grad_histogram, resolve_hist_method)
from dmlc_core_tpu_torch.param import Parameter, field
from dmlc_core_tpu_torch.parallel.mesh import ambient_mesh
from dmlc_core_tpu_torch.utils import threefry
from dmlc_core_tpu_torch.utils.device import resolve_device
from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["GBDTParam", "TreeEnsemble", "GBDT"]


class GBDTParam(Parameter):
    """The reference's GBDT parameters, field for field."""

    num_boost_round = field(int, default=10, lower=1, help="number of trees")
    max_depth = field(int, default=6, lower=1, upper=14, help="tree depth")
    num_bins = field(int, default=256, lower=2, upper=1024,
                     help="feature histogram bins")
    learning_rate = field(float, default=0.3, lower=0.0, help="shrinkage eta")
    reg_lambda = field(float, default=1.0, lower=0.0, help="L2 on leaf weights")
    reg_alpha = field(float, default=0.0, lower=0.0,
                      help="L1 on leaf weights (soft-thresholded sums)")
    scale_pos_weight = field(float, default=1.0, lower=0.0,
                             help="weight multiplier for positive rows")
    min_child_weight = field(float, default=1.0, lower=0.0,
                             help="minimum hessian sum per child")
    min_split_loss = field(float, default=0.0, lower=0.0,
                           help="gamma: minimum gain to split a node")
    subsample = field(float, default=1.0, lower=1e-6, upper=1.0,
                      help="per-tree row subsampling rate")
    colsample_bytree = field(float, default=1.0, lower=1e-6, upper=1.0,
                             help="per-tree feature subsampling rate")
    colsample_bylevel = field(float, default=1.0, lower=1e-6, upper=1.0,
                              help="per-level feature subsampling rate "
                                   "(a fresh mask every tree depth, nested "
                                   "in colsample_bytree's; a softmax "
                                   "round's K trees share it)")
    colsample_bynode = field(float, default=1.0, lower=1e-6, upper=1.0,
                             help="per-node feature subsampling rate (a "
                                  "fresh mask per (depth, node), nested in "
                                  "the tree and level masks)")
    max_delta_step = field(float, default=0.0, lower=0.0,
                           help="cap on |leaf weight| before shrinkage, "
                                "also applied in gain scoring; 0 disables")
    seed = field(int, default=0, help="subsampling PRNG seed")
    monotone_constraints = field(str, default="",
                                 help="per-feature monotone directions, "
                                      "'(1,0,-1,...)'; empty disables")
    base_score = field(float, default=0.0,
                       help="initial prediction margin")
    handle_missing = field(bool, default=False,
                           help="sparsity-aware splits: NaN features take a "
                                "reserved bin and each split learns its "
                                "default direction")
    objective = field(str, default="logistic",
                      enum=["logistic", "squared", "softmax"], help="loss")
    num_class = field(int, default=1, lower=1,
                      help="classes for objective=softmax (K trees/round)")
    hist_method = field(str, default="auto",
                        enum=["auto", "pallas", "pallas_fused", "onehot",
                              "scatter"],
                        help="histogram algorithm: 'pallas' and "
                             "'pallas_fused' (the reference's K2 and K3) "
                             "both run the CUDA kernel that builds the node "
                             "weights in registers; 'onehot' a matmul, "
                             "'scatter' exact f32 segment sums (the CPU "
                             "default)")


class TreeEnsemble(NamedTuple):
    """Stacked level-order trees, tensors leading with the tree axis [T, ...]
    (multiclass: [T, K, ...])."""

    split_feat: Any    # [T(, K), 2**d - 1] int32, -1 = no split
    split_bin: Any     # [T(, K), 2**d - 1] int32
    leaf_value: Any    # [T(, K), 2**d] float32 (shrinkage applied)
    default_left: Any  # [T(, K), 2**d - 1] bool: missing rows go left
    split_gain: Any = None   # [T(, K), 2**d - 1] f32, 0 where no split
    split_cover: Any = None  # [T(, K), 2**d - 1] f32 hessian mass at node

    @property
    def num_trees(self) -> int:
        return self.split_feat.shape[0]


def _widen_bins(bins):
    """uint8 bins stay narrow (the kernels load them natively); any other
    integer dtype widens to int32 on the device."""
    return bins if bins.dtype in (torch.uint8, torch.int32) \
        else bins.to(torch.int32)


def _grad_hess(margin, label, objective: str):
    if objective == "logistic":
        p = 1.0 / (1.0 + torch.exp(-margin))
        return p - label, p * (1.0 - p)
    return margin - label, torch.ones_like(margin)


def _apply_pos_weight(weight, label, p):
    """scale_pos_weight: positive rows count spw-times in every sum
    (logistic only)."""
    if p.scale_pos_weight == 1.0 or p.objective != "logistic":
        return weight
    return weight * torch.where(label > 0.5, p.scale_pos_weight, 1.0)


def _softmax_grad_hess(margin, label, num_class: int):
    """Softmax cross-entropy gradients: margin [B, K], labels [B] ->
    (g, h) each [B, K], h = max(2p(1-p), 1e-16) as XGBoost."""
    pr = torch.softmax(margin, dim=1)
    onehot = (label.to(torch.int32)[:, None] == torch.arange(
        num_class, dtype=torch.int32, device=margin.device)).to(torch.float32)
    return pr - onehot, torch.clamp(2.0 * pr * (1.0 - pr), min=1e-16)


def _l1_threshold(G, alpha: float):
    """XGBoost's ThresholdL1; alpha=0 is the identity."""
    if alpha == 0.0:
        return G
    return torch.sign(G) * torch.clamp(torch.abs(G) - alpha, min=0.0)


def _check_softmax_labels(label, num_class: int, what: str = "labels"
                          ) -> None:
    host = label.cpu().numpy() if isinstance(label, torch.Tensor) \
        else np.asarray(label)
    if host.size == 0:
        return
    CHECK(host.min() >= 0 and host.max() < num_class,
          f"softmax {what} must lie in [0, {num_class}); "
          f"got range [{host.min()}, {host.max()}]")


def _parse_monotone(spec: str, num_feature: int):
    """'(1,0,-1)' / '1,0,-1' -> int32 [F] array, or None when empty or all
    zero."""
    spec = (spec or "").strip().strip("()")
    if not spec:
        return None
    parts = spec.replace(" ", "").split(",")
    CHECK(all(v != "" for v in parts),
          f"monotone_constraints has an empty entry: {spec!r}")
    vals = [int(v) for v in parts]
    CHECK(len(vals) == num_feature,
          f"monotone_constraints has {len(vals)} entries for "
          f"{num_feature} features")
    CHECK(all(v in (-1, 0, 1) for v in vals),
          f"monotone_constraints entries must be -1/0/+1, got {vals}")
    arr = np.asarray(vals, np.int32)
    return None if not arr.any() else arr


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _children(parent, built, build_right):
    """The [2n, F, nbins] histograms of the children of ``n`` nodes, in
    node order, from the parents' and the built children's ([n, F, nbins]
    each; ``build_right`` [n] bool says which side was built): the other
    child is parent - built.  ``parent`` is overwritten."""
    other = parent.sub_(built)
    br = build_right[:, None, None]
    out = torch.empty((built.shape[0], 2) + tuple(built.shape[1:]),
                      dtype=built.dtype, device=built.device)
    torch.where(br, other, built, out=out[:, 0])
    torch.where(br, built, other, out=out[:, 1])
    return out.reshape((-1,) + tuple(built.shape[1:]))


def _build_tree(bins, g, h, max_depth: int, num_bins: int, reg_lambda: float,
                min_child_weight: float, learning_rate: float,
                model_axis: Optional[str] = None, method: str = "scatter",
                onehot=None,
                min_split_loss: float = 0.0, feat_mask=None,
                missing: bool = False,
                reg_alpha: float = 0.0, monotone=None, level_mask_fn=None,
                max_delta_step: float = 0.0):
    """Grow one tree level by level; returns (split_feat, split_bin,
    leaf_value, default_left, split_gain, split_cover, margin_delta).

    ``feat_mask`` ([F] bool) disables features for the whole tree
    (colsample_bytree); ``level_mask_fn(depth, n_nodes, feat_mask)`` gives
    the [n_nodes, F] mask of one level (colsample_bylevel/bynode), drawn
    from the tree's survivors.

    ``missing=True`` scores every candidate twice from the same cumsums,
    with the missing bin (``num_bins - 1``) right and left, and stores the
    better direction in ``default_left``.  ``monotone`` ([F] in {-1, 0, 1})
    masks violating splits, carries a [lower, upper] weight interval per
    node split at the clamped midpoint, and clamps leaves into it.

    Below the root each level histograms half its nodes (sibling
    subtraction, as XGBoost's hist updater does): of the two children of
    every node split at the level above, ``grad_histogram`` builds the one
    with the smaller hessian sum (``HL`` at the best split against ``HT -
    HL``, the missing bin counted where it goes by default), as the parent's
    id over ``2**(d-1)`` nodes with every other row's id at -1, and the
    other child is the parent's histogram less the built one.  A node left
    unsplit sends every row left, so its empty right child is the one built
    and its left child is the parent's histogram exactly.  The choice is
    made on the device, with no host sync; the larger child carries the f32
    cancellation, small against its own sums.

    Under an ambient mesh the histograms and leaf sums cover every rank's
    rows (``model_axis`` shards the histogram's features), so the split
    scan sees the same sums, picks the same splits and builds the same
    children on every rank; rows are routed locally.
    """
    dev = bins.device
    B, F = bins.shape
    n_internal = 2 ** max_depth - 1
    split_feat = torch.full((n_internal,), -1, dtype=torch.int32, device=dev)
    split_bin = torch.zeros((n_internal,), dtype=torch.int32, device=dev)
    default_left = torch.zeros((n_internal,), dtype=torch.bool, device=dev)
    split_gain = torch.zeros((n_internal,), dtype=torch.float32, device=dev)
    split_cover = torch.zeros((n_internal,), dtype=torch.float32, device=dev)
    node = torch.zeros((B,), dtype=torch.int64, device=dev)
    # parent ids of the built children, int32 as the kernels take ids
    parent_id = torch.arange(max(2 ** (max_depth - 1), 1),
                             dtype=torch.int32, device=dev)
    miss_id = num_bins - 1
    lam = reg_lambda
    mds = max_delta_step
    if monotone is not None:
        mono = torch.as_tensor(monotone, dtype=torch.int32, device=dev)
        node_lo = torch.full((1,), -float("inf"), device=dev)
        node_hi = torch.full((1,), float("inf"), device=dev)

    def _opt_w(Gv, Hv):
        # the (possibly mds-clamped) optimum leaf weight shared by gain
        # scoring, monotone masking and the interval midpoints
        w = -_l1_threshold(Gv, reg_alpha) / (Hv + lam)
        return torch.clamp(w, -mds, mds) if mds > 0.0 else w

    def _score(Gv, Hv):
        # -2x the leaf objective at the (possibly clamped) optimum weight
        if mds == 0.0:
            return _l1_threshold(Gv, reg_alpha) ** 2 / (Hv + lam)
        w = _opt_w(Gv, Hv)
        return (-(2.0 * Gv * w + (Hv + lam) * w * w)
                - 2.0 * reg_alpha * torch.abs(w))

    hist_node = node    # the rows of the nodes built, by parent id
    for depth in range(max_depth):
        n_nodes = 2 ** depth
        level_off = n_nodes - 1
        built = max(n_nodes // 2, 1)
        with telemetry.span("gbdt.hist", depth=depth, nodes=n_nodes,
                            built=built, method=method):
            Gb, Hb = grad_histogram(bins, hist_node, g, h, built, num_bins,
                                    model_axis=model_axis, method=method,
                                    onehot=onehot, device=dev)
        if depth == 0:
            G, H = Gb, Hb                                    # [n, F, nbins]
        else:
            G = _children(G, Gb, build_right)
            H = _children(H, Hb, build_right)
        # freed before the split scan's temporaries and the leaf sums
        del Gb, Hb, hist_node
        with telemetry.span("gbdt.split_scan", depth=depth, nodes=n_nodes):
            GL = torch.cumsum(G, dim=-1)
            HL = torch.cumsum(H, dim=-1)
            GT = GL[..., -1:]
            HT = HL[..., -1:]

            def _gain(GLv, HLv):
                GRv = GT - GLv
                HRv = HT - HLv
                gn = _score(GLv, HLv) + _score(GRv, HRv) - _score(GT, HT)
                ok = (HLv >= min_child_weight) & (HRv >= min_child_weight)
                if monotone is not None:
                    wl, wr = _opt_w(GLv, HLv), _opt_w(GRv, HRv)
                    c = mono[None, :, None]
                    ok = ok & ~(c * (wl - wr) > 0)       # violating splits
                return gn, ok

            gain, valid = _gain(GL, HL)
            if missing:
                # default-right is scored above; default-left moves the
                # missing bin's mass into the left sums
                gain_l, valid_l = _gain(GL + G[..., miss_id:miss_id + 1],
                                        HL + H[..., miss_id:miss_id + 1])
                gain = torch.where(valid, gain, -float("inf"))
                gain_l = torch.where(valid_l, gain_l, -float("inf"))
                go_left_default = gain_l > gain
                gain = torch.maximum(gain, gain_l)
                valid = valid | valid_l
            # splitting on the last bin sends everything left: never valid
            valid = valid & (torch.arange(num_bins, device=dev)
                             < num_bins - 1)[None, None, :]
            if level_mask_fn is not None:
                # the level/node draw consumes the tree mask (nested
                # sampling)
                with telemetry.span("gbdt.draw", scope="level", depth=depth):
                    level_mask = level_mask_fn(depth, n_nodes, feat_mask)
                valid = valid & level_mask[:, :, None]
            elif feat_mask is not None:
                valid = valid & feat_mask[None, :, None]
            gain = torch.where(valid, gain, -float("inf"))
            flat = gain.reshape(n_nodes, F * num_bins)
            best = torch.argmax(flat, dim=-1)                # first maximum
            best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
            fb = best // num_bins
            bf = fb.to(torch.int32)
            bb = (best % num_bins).to(torch.int32)
            do_split = best_gain > min_split_loss
            sf = torch.where(do_split, bf, -1).to(torch.int32)
            if missing:
                dl = torch.gather(
                    go_left_default.reshape(n_nodes, F * num_bins), 1,
                    best[:, None])[:, 0] & do_split
            else:
                dl = torch.zeros((n_nodes,), dtype=torch.bool, device=dev)

            def _at_best(a):
                return torch.gather(a.reshape(n_nodes, F * num_bins), 1,
                                    best[:, None])[:, 0]

            def _left_at_best(A, AL):
                # the left child's sum of the best split; default-left
                # adds the missing bin
                s = _at_best(AL)
                if missing:
                    miss = A[torch.arange(n_nodes, device=dev), fb, miss_id]
                    s = torch.where(dl, s + miss, s)
                return s

            HLb = _left_at_best(H, HL)
            # the next level builds the child of smaller hessian sum
            HTb = torch.gather(HT[:, :, 0], 1, fb[:, None])[:, 0]
            build_right = torch.where(do_split, HTb - HLb <= HLb, True)
            lvl = slice(level_off, level_off + n_nodes)
            split_feat[lvl] = sf
            split_bin[lvl] = bb
            default_left[lvl] = dl
            split_gain[lvl] = torch.where(do_split, best_gain, 0.0)
            split_cover[lvl] = torch.where(do_split, HT[:, 0, 0], 0.0)
            if monotone is not None:
                GLb = _left_at_best(G, GL)
                GTn, HTn = GT[:, 0, 0], HT[:, 0, 0]
                wl = _clip(_opt_w(GLb, HLb), node_lo, node_hi)
                wr = _clip(_opt_w(GTn - GLb, HTn - HLb), node_lo, node_hi)
                mid = 0.5 * (wl + wr)
                c_node = torch.where(do_split, mono[bf.to(torch.int64)], 0)
                # c=+1: left subtree weights <= mid <= right subtree weights
                lo_l = node_lo.expand(n_nodes)
                hi_r = node_hi.expand(n_nodes)
                hi_l = torch.where(c_node > 0, torch.minimum(node_hi, mid),
                                   node_hi)
                lo_r = torch.where(c_node > 0, torch.maximum(node_lo, mid),
                                   node_lo)
                lo_l = torch.where(c_node < 0, torch.maximum(node_lo, mid),
                                   lo_l)
                hi_r = torch.where(c_node < 0, torch.minimum(node_hi, mid),
                                   hi_r)
                node_lo = torch.stack([lo_l, lo_r], dim=1).reshape(-1)
                node_hi = torch.stack([hi_l, hi_r], dim=1).reshape(-1)
        with telemetry.span("gbdt.route", depth=depth):
            # advance every row one level
            nf = sf.to(torch.int64)[node]                    # [B]
            row_bin = torch.gather(bins, 1, nf.clamp(min=0)[:, None])[:, 0]
            row_bin = row_bin.to(torch.int32)
            go_right = (row_bin > bb[node]) & (nf >= 0)
            if missing:
                # missing rows sit above every threshold; default-left
                # overrides
                go_right = go_right & ~((row_bin == miss_id) & dl[node])
            node = node * 2 + go_right.to(torch.int64)
            if depth + 1 < max_depth:
                # each child's parent id where it is built, else -1: the
                # next histogram's ids in one gather
                built_id = torch.where(
                    torch.stack([~build_right, build_right], dim=1),
                    parent_id[:n_nodes, None], -1).reshape(-1)
                hist_node = built_id[node]

    n_leaf = 2 ** max_depth
    with telemetry.span("gbdt.leaf", leaves=n_leaf, method=method):
        if method in ("onehot", "pallas", "pallas_fused"):
            # leaf sums as a small f32 matmul, as the reference does for its
            # matmul-shaped methods (deterministic on the card, unlike float
            # atomics)
            leafhot = (node[:, None] == torch.arange(n_leaf, device=dev)
                       ).to(torch.float32)                   # [B, n_leaf]
            sums = torch.matmul(leafhot.t(), torch.stack([g, h], dim=1))
        else:
            # the reference's segment_sum, atomics-free on the card too
            sums = hist_cuda.segment_sum(torch.stack([g, h], dim=1), node,
                                         n_leaf)
        # every data shard's rows
        Gl, Hl = data_allreduce(sums[:, 0], sums[:, 1])
        leaf_w = -_l1_threshold(Gl, reg_alpha) / (Hl + reg_lambda)
        if max_delta_step > 0.0:
            leaf_w = torch.clamp(leaf_w, -max_delta_step, max_delta_step)
        if monotone is not None:
            leaf_w = _clip(leaf_w, node_lo, node_hi)
        leaf_value = leaf_w * learning_rate
        margin_delta = leaf_value[node]

    return (split_feat, split_bin, leaf_value, default_left, split_gain,
            split_cover, margin_delta)


def _f32(x: float) -> float:
    """``x`` rounded to float32, as JAX's weak typing rounds a Python rate
    compared with a float32 draw."""
    return float(np.float32(x))


def _tree_sampling(p, rnd: int, B: int, F: int, class_index: int = 0,
                   device=None, offset: int = 0):
    """Per-tree (row_weight [B] f32, feature_mask [F] bool), each None at
    a rate of 1.  The draw is keyed by (seed, rnd, class_index) as the
    reference keys it: each of a softmax round's K trees draws its own
    rows and columns.  ``offset`` is the global index of the first row
    (a rank's place under a mesh); the draw of a row depends only on it."""
    if p.subsample >= 1.0 and p.colsample_bytree >= 1.0:
        return None, None
    row_w = fmask = None
    with telemetry.span("gbdt.draw", scope="tree"):
        key = threefry.fold_in(threefry.prng_key(p.seed), rnd)
        if class_index:
            key = threefry.fold_in(key, class_index)
        if p.subsample < 1.0:
            u = threefry.uniform(threefry.fold_in(key, 0), (B,), device,
                                 offset=offset)
            row_w = (u < _f32(p.subsample)).to(torch.float32)
        if p.colsample_bytree < 1.0:
            u = threefry.uniform(threefry.fold_in(key, 1), (F,), device)
            fmask = u < _f32(p.colsample_bytree)
            # never mask every feature: the cheapest column always stays
            fmask[torch.argmin(u)] = True
    return row_w, fmask


def _level_mask_fn(p, rnd: int, F: int, device=None):
    """colsample_bylevel / colsample_bynode: ``mask(depth, n_nodes,
    tree_mask=None) -> [n_nodes, F]`` bool, or None when both rates are 1.
    Keyed by (seed, rnd, depth) without the class, so a softmax round's K
    trees share it.  Nested: bylevel samples from the tree mask's
    survivors and bynode from bylevel's, and each node's cheapest column
    always stays."""
    if p.colsample_bylevel >= 1.0 and p.colsample_bynode >= 1.0:
        return None
    base = threefry.fold_in(threefry.prng_key(p.seed), rnd)
    base = threefry.fold_in(base, 7)     # apart from the row/column draws

    def mask(depth: int, n_nodes: int, tree_mask=None):
        key = threefry.fold_in(base, depth)
        allowed = (tree_mask if tree_mask is not None
                   else torch.ones((F,), dtype=torch.bool, device=device))
        if p.colsample_bylevel < 1.0:
            u = torch.where(allowed, threefry.uniform(key, (F,), device),
                            float("inf"))
            allowed = (u < _f32(p.colsample_bylevel)) & allowed
            allowed[torch.argmin(u)] = True
        m = allowed[None, :].expand(n_nodes, F)
        if p.colsample_bynode < 1.0:
            un = torch.where(allowed[None, :],
                             threefry.uniform(threefry.fold_in(key, 1),
                                              (n_nodes, F), device),
                             float("inf"))
            m = (un < _f32(p.colsample_bynode)) & m
            m[torch.arange(n_nodes, device=device),
              torch.argmin(un, dim=1)] = True
        return m

    return mask


def _row_sampling(p, rnd: int, n_rows: int, B: int, F: int,
                  class_index: int = 0, device=None, offset: int = 0):
    """:func:`_tree_sampling` drawn over ``n_rows`` rows and padded with
    weight 0 to ``B``: the draw never depends on row padding."""
    row_w, fmask = _tree_sampling(p, rnd, n_rows, F, class_index, device,
                                  offset)
    if row_w is not None and B != n_rows:
        row_w = torch.nn.functional.pad(row_w, (0, B - n_rows))
    return row_w, fmask


def _softmax_round(p, bins, margin, label, weight, rnd: int, grow,
                   offset: int = 0):
    """One multiclass round: K trees from one margin snapshot, each tree
    drawing its own rows and columns."""
    K = p.num_class
    B, F = bins.shape
    g_all, h_all = _softmax_grad_hess(margin, label, K)
    trees = []
    for k in range(K):
        row_w, fmask = _tree_sampling(p, rnd, B, F, k, bins.device, offset)
        w = weight if row_w is None else weight * row_w
        trees.append(grow(bins, g_all[:, k] * w, h_all[:, k] * w, fmask))
    delta = torch.stack([t[6] for t in trees], dim=1)    # [B, K]
    return margin + delta, tuple(
        torch.stack([t[i] for t in trees]) for i in range(6))


def _route_tree(split_feat, split_bin, default_left, bins, max_depth: int,
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


def _predict_tree(split_feat, split_bin, leaf_value, default_left, bins,
                  max_depth: int, miss_id: int = -1):
    """Route every row down one tree and read its leaf value."""
    return leaf_value[_route_tree(split_feat, split_bin, default_left, bins,
                                  max_depth, miss_id)]


def _per_tree(fn, arrays, multiclass: bool):
    """Apply a per-tree function over one round's arrays, stacking the K
    class trees on axis 1 for softmax ensembles."""
    if multiclass:
        K = arrays[0].shape[0]
        return torch.stack([fn(*(a[k] for a in arrays)) for k in range(K)],
                           dim=1)
    return fn(*arrays)


class GBDT:
    """Histogram gradient-boosted trees over binned dense features.

    ``device`` is where training and scoring run: ``cuda`` unless the
    caller passes ``device="cpu"``.  ``model_axis`` names the mesh axis
    that shards the histogram's features when training runs under
    ``with mesh:`` (each rank passing its own rows)."""

    def __init__(self, param: GBDTParam, num_feature: int,
                 model_axis: Optional[str] = None, device=None):
        CHECK(param.objective != "softmax" or param.num_class >= 2,
              "objective=softmax needs num_class >= 2")
        CHECK(param.scale_pos_weight == 1.0 or param.objective == "logistic",
              f"scale_pos_weight={param.scale_pos_weight} only applies to "
              f"objective=logistic (got {param.objective!r})")
        self.device = resolve_device(device)
        self._monotone = _parse_monotone(param.monotone_constraints,
                                         num_feature)
        self.param = param
        self.num_feature = num_feature
        self.model_axis = model_axis
        self.boundaries: Optional[np.ndarray] = None  # [F, eff_bins-1]

    # -- binning -------------------------------------------------------------
    def _eff_bins(self) -> int:
        return (self.param.num_bins - 1 if self.param.handle_missing
                else self.param.num_bins)

    def make_bins(self, sample: np.ndarray, comm=None,
                  count: Optional[int] = None) -> np.ndarray:
        """Fit quantile boundaries from a host sample; returns them.

        With ``comm`` (rabit-shaped, e.g. :mod:`dmlc_core_tpu_torch.
        collective`) every rank passes its own shard's sample and all
        ranks get the same boundaries from the merged quantile summary;
        ``count`` is the shard's true row count when ``sample`` is a
        subsample of it."""
        CHECK(sample.shape[1] == self.num_feature,
              "sample feature dim mismatch")
        self.boundaries = distributed_quantile_boundaries(
            sample, self._eff_bins(), comm=comm, count=count)
        return self.boundaries

    def set_boundaries(self, boundaries: np.ndarray) -> None:
        """Install boundaries computed elsewhere (a HostBinner's, or a JAX
        model's ``boundaries`` as they are)."""
        boundaries = np.asarray(boundaries, dtype=np.float32)
        eff = self._eff_bins()
        CHECK(boundaries.shape == (self.num_feature, eff - 1),
              f"boundaries shape {boundaries.shape} != "
              f"{(self.num_feature, eff - 1)} (num_bins="
              f"{self.param.num_bins}, handle_missing="
              f"{self.param.handle_missing})")
        self.boundaries = boundaries

    def bin_features(self, x):
        CHECK(self.boundaries is not None, "call make_bins first")
        miss = (self.param.num_bins - 1 if self.param.handle_missing
                else None)
        return apply_bins(x, self.boundaries, missing_bin=miss,
                          device=self.device)

    # -- internals -----------------------------------------------------------
    def _method(self, bins) -> str:
        """The histogram method of a fit, decided from the shapes and the
        ambient mesh only, so every rank takes the same one.  With
        ``model_axis`` the kernel methods keep the kernel (K4) where the
        reference's sharded plan holds at the deepest level, and fall back
        to ``"onehot"`` where it does not."""
        method = resolve_hist_method(self.param.hist_method, bins)
        if method in ("pallas", "pallas_fused") \
                and self.model_axis is not None:
            deepest = 2 ** (self.param.max_depth - 1)
            mesh = hist_cuda.sharded_hist_plan(
                self.model_axis, self.num_feature, deepest,
                self.param.num_bins)
            if mesh is None:
                method = "onehot"
        return method

    def _row_offset(self, rows: int) -> int:
        """Global index of this rank's first row: rows shard over the
        ambient mesh's row axes in coordinate order, so the offset is
        the row count of the lower coordinates (gathered once, on the
        fit's device).  0 without a mesh or without row sampling."""
        if self.param.subsample >= 1.0 or not data_parallel():
            return 0
        mesh = ambient_mesh()
        counts = MeshCollective(mesh, mesh.row_axes).allgather(
            torch.tensor([rows], dtype=torch.int64, device=self.device))
        return int(counts[:mesh.coord(mesh.row_axes)].sum())

    def _bins(self, bins):
        return _widen_bins(as_tensor(bins, self.device)).contiguous()

    def _rows(self, v, n: int):
        if v is None:
            return torch.ones(n, dtype=torch.float32, device=self.device)
        return as_tensor(v, self.device, torch.float32)

    def _round(self, margin, bins, label, weight, method: str, onehot,
               rnd: int, offset: int = 0):
        """Round ``rnd``: its draws, then its tree (K trees for softmax).
        ``offset`` is this rank's first global row (:meth:`_row_offset`)."""
        p = self.param
        B, F = bins.shape
        with telemetry.span("gbdt.round", round=int(rnd), rows=B, features=F):
            level_mask_fn = _level_mask_fn(p, rnd, F, self.device)

            def grow(bins_, g, h, fmask):
                return _build_tree(
                    bins_, g, h, p.max_depth, p.num_bins, p.reg_lambda,
                    p.min_child_weight, p.learning_rate, self.model_axis,
                    method=method, onehot=onehot,
                    min_split_loss=p.min_split_loss, feat_mask=fmask,
                    missing=p.handle_missing, reg_alpha=p.reg_alpha,
                    monotone=self._monotone, level_mask_fn=level_mask_fn,
                    max_delta_step=p.max_delta_step)

            if p.objective == "softmax":
                return _softmax_round(p, bins, margin, label, weight, rnd,
                                      grow, offset)
            row_w, fmask = _tree_sampling(p, rnd, B, F, device=self.device,
                                          offset=offset)
            if row_w is not None:
                weight = weight * row_w
            g, h = _grad_hess(margin, label, p.objective)
            sf, sb, lv, dl, sg, sc, delta = grow(bins, g * weight,
                                                 h * weight, fmask)
            return margin + delta, (sf, sb, lv, dl, sg, sc)

    def _k(self) -> int:
        return self.param.num_class if self.param.objective == "softmax" \
            else 1

    def _fit_inputs(self, bins, label, weight):
        """The tensors, method and bin one-hot every fit starts from."""
        p = self.param
        if p.objective == "softmax":
            _check_softmax_labels(label, p.num_class)
        bins = self._bins(bins)
        label = as_tensor(label, self.device, torch.float32)
        weight = _apply_pos_weight(self._rows(weight, bins.shape[0]), label,
                                   p)
        method = self._method(bins)
        # the bin one-hot is invariant across rounds and levels
        onehot = bin_onehot(bins, p.num_bins) if method == "onehot" else None
        return (bins, label, weight, method, onehot,
                self._row_offset(bins.shape[0]))

    def _base_margin(self, rows: int):
        K = self._k()
        return torch.full((rows,) if K == 1 else (rows, K),
                          self.param.base_score, dtype=torch.float32,
                          device=self.device)

    # -- public API ----------------------------------------------------------
    def fit_binned(self, bins, label, weight=None
                   ) -> Tuple[TreeEnsemble, Any]:
        """Train on pre-binned features; returns (ensemble, final margin)."""
        bins, label, weight, method, onehot, offset = self._fit_inputs(
            bins, label, weight)
        margin = self._base_margin(bins.shape[0])
        trees = []
        for r in range(self.param.num_boost_round):
            margin, tree = self._round(margin, bins, label, weight, method,
                                       onehot, r, offset)
            trees.append(tree)
        return _stack_trees(trees), margin

    def boost_round(self, margin, bins, label, weight,
                    round_index: Optional[int] = None):
        """One boosting round; returns (margin, tree arrays).

        ``round_index`` keys the round's subsample/colsample draws.  It is
        required when sampling is on: otherwise every streamed round would
        draw the same rows and columns."""
        if round_index is None:
            p = self.param
            CHECK(min(p.subsample, p.colsample_bytree, p.colsample_bylevel,
                      p.colsample_bynode) >= 1.0,
                  "boost_round needs round_index= when subsample/"
                  "colsample_by* are enabled (each tree must draw fresh "
                  "subsets)")
            round_index = 0
        bins = self._bins(bins)
        label = as_tensor(label, self.device, torch.float32)
        weight = _apply_pos_weight(self._rows(weight, bins.shape[0]), label,
                                   self.param)
        margin = as_tensor(margin, self.device, torch.float32)
        method = self._method(bins)
        onehot = (bin_onehot(bins, self.param.num_bins)
                  if method == "onehot" else None)
        return self._round(margin, bins, label, weight, method, onehot,
                           round_index, self._row_offset(bins.shape[0]))

    def append_rounds(self, ensemble: Optional[TreeEnsemble], bins, label,
                      weight=None, *, num_rounds: int = 1, margin=None,
                      start_round: Optional[int] = None
                      ) -> Tuple[TreeEnsemble, Any]:
        """Append ``num_rounds`` rounds trained on fresh binned data (the
        warm start); returns (extended ensemble, final margin).  The margin
        is seeded from the ensemble's own predictions unless given.
        ``start_round`` keys the sampling draws of the first new round and
        defaults to ``ensemble.num_trees`` (0 for ``ensemble=None``), so
        appended trees continue a fresh fit's draw sequence."""
        CHECK(num_rounds >= 1, "append_rounds needs num_rounds >= 1")
        bins = self._bins(bins)
        if margin is None:
            margin = (self._base_margin(bins.shape[0]) if ensemble is None
                      else self.predict_margin(ensemble, bins))
        if start_round is None:
            start_round = 0 if ensemble is None else ensemble.num_trees
        new = []
        for r in range(num_rounds):
            margin, tree = self.boost_round(margin, bins, label, weight,
                                            round_index=start_round + r)
            new.append(tree)

        def cat(old, i):
            fresh = torch.stack([t[i] for t in new])
            if old is None:
                return fresh
            old = as_tensor(old, self.device)
            return torch.cat([old, fresh.to(old.dtype)])

        if ensemble is None:
            ensemble = TreeEnsemble(None, None, None, None, None, None)
        # ensembles without split statistics keep none
        has_stats = (ensemble.split_feat is None
                     or ensemble.split_gain is not None)
        return TreeEnsemble(
            cat(ensemble.split_feat, 0), cat(ensemble.split_bin, 1),
            cat(ensemble.leaf_value, 2), cat(ensemble.default_left, 3),
            cat(ensemble.split_gain, 4) if has_stats else None,
            cat(ensemble.split_cover, 5) if has_stats else None), margin

    def predict_margin(self, ensemble: TreeEnsemble, bins):
        """Sum of the trees' leaf values plus ``base_score`` per row
        ([B], or [B, K] for softmax)."""
        d = self.param.max_depth
        miss_id = self.param.num_bins - 1 if self.param.handle_missing \
            else -1
        bins = self._bins(bins)
        trees = [as_tensor(a, self.device) for a in ensemble[:4]]
        multiclass = trees[0].dim() == 3
        shape = (bins.shape[0], trees[0].shape[1]) if multiclass \
            else (bins.shape[0],)
        with telemetry.span("gbdt.predict", trees=trees[0].shape[0],
                            rows=bins.shape[0]):
            out = torch.full(shape, self.param.base_score,
                             dtype=torch.float32, device=self.device)
            for t in range(trees[0].shape[0]):
                out = out + _per_tree(
                    lambda sf, sb, lv, dl: _predict_tree(sf, sb, lv, dl, bins,
                                                         d, miss_id),
                    [a[t] for a in trees], multiclass)
        return out

    def predict(self, ensemble: TreeEnsemble, bins):
        margin = self.predict_margin(ensemble, bins)
        if self.param.objective == "logistic":
            return 1.0 / (1.0 + torch.exp(-margin))
        if self.param.objective == "softmax":
            return torch.softmax(margin, dim=1)
        return margin

    def predict_class(self, ensemble: TreeEnsemble, bins):
        """Hard labels: argmax over classes (softmax) or margin > 0
        (logistic); int32 [B]."""
        CHECK(self.param.objective != "squared",
              "predict_class needs a classification objective")
        margin = self.predict_margin(ensemble, bins)
        if self.param.objective == "softmax":
            return torch.argmax(margin, dim=1).to(torch.int32)
        return (margin > 0).to(torch.int32)

    # -- training with eval / early stopping ---------------------------------
    def _tree_margin_fn(self):
        """One tree's leaf value for every row: ``fn(sf, sb, lv, dl, bins)``
        (the per-round eval-margin step of :meth:`fit_with_eval`)."""
        d = self.param.max_depth
        miss_id = self.param.num_bins - 1 if self.param.handle_missing \
            else -1

        def one_tree(sf, sb, lv, dl, bins):
            return _predict_tree(sf, sb, lv, dl, self._bins(bins), d,
                                 miss_id)

        return one_tree

    def fit_with_eval(self, bins, label, eval_bins=None, eval_label=None,
                      weight=None, early_stopping_rounds: int = 0,
                      compiled: bool = True, eval_metric: str = "loss"):
        """Boosting with validation loss tracking and early stopping.

        Returns (ensemble, history): history is a list of per-round dicts
        with ``round`` and ``train_loss`` (the objective's loss on the
        training margin) and, with an eval set, ``eval_loss`` (the
        ``eval_metric``: loss | error | rmse | mae).  With
        ``early_stopping_rounds`` > 0 the fit stops once the eval loss has
        not improved by more than 1e-9 for that many rounds, and the
        ensemble is truncated to the best round.

        The trees are grown exactly as :meth:`fit_binned` grows them, so
        without early stopping the ensemble is bitwise the
        :meth:`fit_binned` ensemble.  The reference's ``compiled=True``
        runs every round in one program and applies the stopping rule
        afterwards; here both values of ``compiled`` run the same loop,
        which stops at the stopping round, and return the same ensemble
        and history (the reference proves its two paths equal too).
        """
        p = self.param
        K = self._k()
        if K > 1 and eval_label is not None:
            _check_softmax_labels(eval_label, K, what="eval labels")
        bins, label, weight, method, onehot, offset = self._fit_inputs(
            bins, label, weight)
        metric_fn = _eval_metric_fn(eval_metric, p.objective)
        margin = self._base_margin(bins.shape[0])
        eval_margin = None
        if eval_bins is not None:
            eval_bins = self._bins(eval_bins)
            eval_label = as_tensor(eval_label, self.device, torch.float32)
            eval_margin = self._base_margin(eval_bins.shape[0])
        trees = []
        history = []
        stopper = _EarlyStop(early_stopping_rounds)
        tree_margin = self._tree_margin_fn()
        for r in range(p.num_boost_round):
            margin, tree = self._round(margin, bins, label, weight, method,
                                       onehot, r, offset)
            trees.append(tree)
            entry = {"round": r,
                     "train_loss": float(_logloss(margin, label,
                                                  p.objective))}
            if eval_margin is not None:
                eval_margin = eval_margin + _per_tree(
                    lambda sf, sb, lv, dl: tree_margin(sf, sb, lv, dl,
                                                       eval_bins),
                    tree[:4], K > 1)
                eval_loss = float(metric_fn(eval_margin, eval_label))
                entry["eval_loss"] = eval_loss
                if stopper.update(r, eval_loss):
                    trees = trees[:stopper.best_round + 1]
                    history.append(entry)
                    break
            history.append(entry)
        return _stack_trees(trees), history

    def staged_losses(self, ensemble: TreeEnsemble, bins, label,
                      metric: str = "loss") -> np.ndarray:
        """Per-round cumulative metric of the ensemble on any dataset (the
        learning curve, post hoc).  ``metric``: loss (the objective's own)
        | error | rmse | mae.  float32 [num_trees]."""
        p = self.param
        if p.objective == "softmax":
            _check_softmax_labels(label, p.num_class)
        metric_fn = _eval_metric_fn(metric, p.objective)
        bins = self._bins(bins)
        label = as_tensor(label, self.device, torch.float32)
        trees = [as_tensor(a, self.device) for a in ensemble[:4]]
        tree_margin = self._tree_margin_fn()
        margin = self._base_margin(bins.shape[0])
        losses = []
        for t in range(trees[0].shape[0]):
            margin = margin + _per_tree(
                lambda sf, sb, lv, dl: tree_margin(sf, sb, lv, dl, bins),
                [a[t] for a in trees], trees[0].dim() == 3)
            losses.append(metric_fn(margin, label))
        if not losses:
            return np.zeros((0,), np.float32)
        return torch.stack(losses).to(torch.float32).cpu().numpy()

    def predict_leaf(self, ensemble: TreeEnsemble, bins) -> np.ndarray:
        """Leaf index of every row in every tree (XGBoost pred_leaf):
        int32 [B, T] (or [B, T, K] for softmax), ids in
        [0, 2**max_depth)."""
        d = self.param.max_depth
        miss_id = self.param.num_bins - 1 if self.param.handle_missing \
            else -1
        bins = self._bins(bins)
        trees = [as_tensor(a, self.device) for a in
                 (ensemble.split_feat, ensemble.split_bin,
                  ensemble.default_left)]
        multiclass = trees[0].dim() == 3
        ids = [_per_tree(
            lambda sf, sb, dl: _route_tree(sf, sb, dl, bins, d, miss_id),
            [a[t] for a in trees], multiclass)
            for t in range(trees[0].shape[0])]
        if not ids:
            shape = (bins.shape[0], 0) + ((trees[0].shape[1],)
                                          if multiclass else ())
            return np.zeros(shape, np.int32)
        return torch.stack(ids, dim=1).to(torch.int32).cpu().numpy()

    # -- introspection -------------------------------------------------------
    def feature_importance(self, ensemble: TreeEnsemble,
                           kind: str = "weight") -> np.ndarray:
        """Per-feature importance (the XGBoost importance_type set):
        'weight' = split count, 'gain'/'total_gain' = mean/summed split
        gain, 'cover'/'total_cover' = mean/summed hessian mass at splits.
        Gain and cover need the split statistics recorded at fit time
        (absent on ensembles loaded from pre-stats checkpoints)."""
        kinds = ("weight", "gain", "total_gain", "cover", "total_cover")
        CHECK(kind in kinds, f"importance kind {kind!r} not in {kinds}")
        sf = host_array(ensemble.split_feat).reshape(-1)
        mask = sf >= 0
        counts = np.bincount(sf[mask], minlength=self.num_feature)
        if kind == "weight":
            return counts.astype(np.float64)
        stat = (ensemble.split_gain if "gain" in kind
                else ensemble.split_cover)
        CHECK(stat is not None,
              f"{kind} importance needs split statistics; this ensemble "
              f"was loaded from a checkpoint without them — refit to get "
              f"them")
        stat = host_array(stat).reshape(-1)
        totals = np.bincount(sf[mask], weights=stat[mask],
                             minlength=self.num_feature).astype(np.float64)
        if kind.startswith("total_"):
            return totals
        return np.divide(totals, counts, out=np.zeros_like(totals),
                         where=counts > 0)

    def dump_trees(self, ensemble: TreeEnsemble,
                   feature_names=None) -> str:
        """Text dump of every tree, the reference's format to the byte
        (XGBoost get_dump style): internal nodes show the split feature,
        the real threshold (the bin id mapped back through the
        boundaries; rows with value < threshold go left), the missing-row
        default direction and the recorded gain/cover; leaves show their
        values.  No-split nodes collapse into their left subtree, as
        routing does."""
        CHECK(self.boundaries is not None,
              "dump_trees needs the binning boundaries; call make_bins or "
              "load_model first")
        sf_all = host_array(ensemble.split_feat)
        sb_all = host_array(ensemble.split_bin)
        lv_all = host_array(ensemble.leaf_value)
        dl_all = host_array(ensemble.default_left)
        sg_all = (None if ensemble.split_gain is None
                  else host_array(ensemble.split_gain))
        sc_all = (None if ensemble.split_cover is None
                  else host_array(ensemble.split_cover))
        multiclass = sf_all.ndim == 3
        lines = []

        def one_tree(sf, sb, lv, dl, sg, sc, title):
            lines.append(f"booster[{title}]:")
            d = self.param.max_depth

            def walk(node, depth, indent):
                if depth < d:
                    i = 2 ** depth - 1 + node    # flat level-order id
                    if sf[i] >= 0:
                        f = int(sf[i])
                        b = int(sb[i])
                        bounds = self.boundaries[f]
                        thr = (float(bounds[b]) if b < len(bounds)
                               else float("inf"))
                        name = (feature_names[f]
                                if feature_names is not None else f"f{f}")
                        miss = "yes" if (dl is not None and dl[i]) else "no"
                        extra = ""
                        if sg is not None:
                            extra = (f",gain={sg[i]:.6g}"
                                     f",cover={sc[i]:.6g}")
                        lines.append(f"{indent}{i}:[{name}<{thr:.6g}] "
                                     f"missing_left={miss}{extra}")
                        walk(node * 2, depth + 1, indent + "  ")
                        walk(node * 2 + 1, depth + 1, indent + "  ")
                        return
                # leaf or collapsed no-split subtree: rows fall through
                # left to the leaf slot
                leaf = node
                for _ in range(depth, d):
                    leaf = leaf * 2
                lines.append(f"{indent}leaf={lv[leaf]:.6g}")

            walk(0, 0, "  ")

        for t in range(sf_all.shape[0]):
            if multiclass:
                for k in range(sf_all.shape[1]):
                    one_tree(sf_all[t, k], sb_all[t, k], lv_all[t, k],
                             dl_all[t, k],
                             None if sg_all is None else sg_all[t, k],
                             None if sc_all is None else sc_all[t, k],
                             f"{t}.class{k}")
            else:
                one_tree(sf_all[t], sb_all[t], lv_all[t], dl_all[t],
                         None if sg_all is None else sg_all[t],
                         None if sc_all is None else sc_all[t], str(t))
        return "\n".join(lines) + "\n"

    # -- persistence ---------------------------------------------------------
    def save_model(self, uri: str, ensemble: TreeEnsemble,
                   extra: Optional[dict] = None) -> None:
        """Persist the model + binning boundaries to any URI, in the JAX
        package's checkpoint format (the blob loads in either package).

        ``extra`` adds caller-owned numpy leaves to the payload; keys must
        not clash with the core schema.
        """
        save_checkpoint(uri, self._model_payload(ensemble, extra))

    def _model_payload(self, ensemble: TreeEnsemble,
                       extra: Optional[dict] = None) -> dict:
        """The checkpoint tree ``save_model`` writes (trees + binning
        boundaries + routing contract), as a dict of host arrays with the
        reference's dtypes, so the header's dtype strings match byte for
        byte — the single schema :meth:`serving_state` builds from too."""
        CHECK(self.boundaries is not None, "model has no bin boundaries")
        payload = {
            "split_feat": host_array(ensemble.split_feat),
            "split_bin": host_array(ensemble.split_bin),
            "leaf_value": host_array(ensemble.leaf_value),
            "default_left": host_array(ensemble.default_left),
            "boundaries": np.asarray(self.boundaries),
            # binning contract: loading into a param with a different
            # missing-mode would silently mis-bin NaNs and ignore the
            # learned default directions — record it so load can refuse
            "handle_missing": np.array([int(self.param.handle_missing)]),
            # predict-time contract: predict_margin adds the loader's
            # base_score, so a mismatch silently shifts every margin
            "base_score": np.array([self.param.base_score], np.float32),
        }
        # omit absent stats (ensembles loaded from pre-stats checkpoints):
        # an object-dtype leaf could never be loaded back
        if ensemble.split_gain is not None:
            payload["split_gain"] = host_array(ensemble.split_gain)
        if ensemble.split_cover is not None:
            payload["split_cover"] = host_array(ensemble.split_cover)
        for k, v in (extra or {}).items():
            CHECK(k not in payload, f"extra key {k!r} clashes with the "
                                    f"model schema")
            arr = host_array(v)
            # object arrays serialize as raw pointers and can never load
            # back; reject at save time
            CHECK(arr.dtype != object,
                  f"extra key {k!r} has object dtype; convert to a "
                  f"numeric or fixed-width string array first")
            payload[k] = arr
        return payload

    def load_model(self, uri: str) -> TreeEnsemble:
        return self.load_model_dict(load_checkpoint(uri))

    def load_model_dict(self, flat: dict) -> TreeEnsemble:
        """Restore from an already-loaded checkpoint dict (keys are the
        flattened paths, each exactly ``"['<name>']"``); the ensemble's
        tensors land on this model's device."""
        _REQUIRED = object()

        def get(name, default=_REQUIRED):
            key = f"['{name}']"
            if key not in flat:
                CHECK(default is not _REQUIRED,
                      f"checkpoint is missing required key {name!r}")
                return default
            return flat[key]

        self.boundaries = np.asarray(get("boundaries"), dtype=np.float32)
        sf = get("split_feat")
        # models saved before sparsity-aware splits have no default_left /
        # handle_missing keys: all-False + non-missing reproduces their
        # exact routing
        dl = get("default_left", default=None)
        dl = (np.asarray(dl).astype(bool) if dl is not None
              else np.zeros(np.asarray(sf).shape, dtype=bool))
        hm = get("handle_missing", default=None)
        saved_hm = bool(hm[0]) if hm is not None else False
        CHECK(saved_hm == self.param.handle_missing,
              f"model was saved with handle_missing={saved_hm} but this "
              f"GBDT has handle_missing={self.param.handle_missing}; the "
              f"binning and routing contracts differ — construct the "
              f"loader with the matching GBDTParam")
        bs = get("base_score", default=None)
        saved_bs = float(bs[0]) if bs is not None else 0.0
        CHECK(abs(saved_bs - self.param.base_score) < 1e-9,
              f"model was saved with base_score={saved_bs} but this GBDT "
              f"has base_score={self.param.base_score}; predictions would "
              f"silently shift — construct the loader with the matching "
              f"GBDTParam")
        sg = get("split_gain", default=None)
        sc = get("split_cover", default=None)

        def dev(a):
            return None if a is None else as_tensor(a, self.device)

        return TreeEnsemble(dev(sf), dev(get("split_bin")),
                            dev(get("leaf_value")), dev(dl), dev(sg),
                            dev(sc))

    def serving_state(self, ensemble: TreeEnsemble,
                      extra: Optional[dict] = None) -> dict:
        """Self-describing checkpoint tree for serving: the
        :meth:`save_model` payload plus a ``serve_meta`` leaf recording
        what a loader needs to rebuild this GBDT without knowing its
        params (num_feature, num_bins, max_depth, objective, num_class).
        The binner edges ride the same blob, so a swapped-in model always
        serves through the bins it trained on.  Save it with
        :class:`~dmlc_core_tpu_torch.bridge.checkpoint.CheckpointManager`
        and restore with :meth:`from_serving_state`; ``extra`` adds
        caller-owned leaves, which every loader ignores."""
        merged = {
            _SERVE_META_KEY: np.array(
                [_SERVE_SCHEMA, self.num_feature, self.param.num_bins,
                 self.param.max_depth,
                 _OBJECTIVE_CODES[self.param.objective],
                 self.param.num_class],
                np.int64)}
        for k, v in (extra or {}).items():
            CHECK(k != _SERVE_META_KEY, "extra must not override serve_meta")
            merged[k] = v
        return self._model_payload(ensemble, merged)

    @classmethod
    def from_serving_state(cls, flat: dict, device=None
                           ) -> Tuple["GBDT", TreeEnsemble]:
        """Rebuild (GBDT, ensemble) on ``device`` (``cuda`` unless the
        caller passes ``device="cpu"``) from a flat
        :func:`~dmlc_core_tpu_torch.bridge.checkpoint.load_checkpoint` dict
        written by :meth:`serving_state` of either package: boundaries
        installed, predictions bitwise equal to the saver's."""
        meta = flat.get(f"['{_SERVE_META_KEY}']")
        CHECK(meta is not None,
              "checkpoint has no serve_meta leaf — not a serving_state "
              "blob (train-side save_model checkpoints need their "
              "GBDTParam known to the loader)")
        meta = np.asarray(meta).reshape(-1)
        CHECK(meta.shape[0] == 6 and int(meta[0]) == _SERVE_SCHEMA,
              f"unsupported serve_meta schema {meta!r}")
        _, num_feature, num_bins, max_depth, obj_code, num_class = (
            int(v) for v in meta)
        CHECK(obj_code in _OBJECTIVE_FROM_CODE,
              f"serve_meta names unknown objective code {obj_code}")
        hm = flat.get("['handle_missing']")
        bs = flat.get("['base_score']")
        split_feat = flat.get("['split_feat']")
        CHECK(split_feat is not None, "checkpoint is missing split_feat")
        param = GBDTParam(
            objective=_OBJECTIVE_FROM_CODE[obj_code],
            num_bins=num_bins, max_depth=max_depth, num_class=num_class,
            num_boost_round=max(1, int(np.asarray(split_feat).shape[0])),
            handle_missing=bool(hm[0]) if hm is not None else False,
            base_score=float(bs[0]) if bs is not None else 0.0)
        gbdt = cls(param, num_feature, device=device)
        return gbdt, gbdt.load_model_dict(flat)

    @classmethod
    def resume(cls, flat: dict, param: Optional[GBDTParam] = None,
               device=None) -> Tuple["GBDT", TreeEnsemble]:
        """Warm-start restore for continued training: ``(GBDT, ensemble)``
        from a :meth:`serving_state` checkpoint with the binner edges
        frozen, ready for :meth:`append_rounds` on fresh data.

        ``serve_meta`` records only the structural contract (bins, depth,
        objective, classes); pass ``param`` for the training
        hyperparameters of the appended rounds.  Its structural fields
        must match the checkpoint, since they define the routing and
        binning contract of the uint8 serving wire.
        """
        gbdt, ensemble = cls.from_serving_state(flat, device=device)
        if param is None:
            return gbdt, ensemble
        for f in ("objective", "num_bins", "max_depth", "num_class"):
            CHECK(getattr(param, f) == getattr(gbdt.param, f),
                  f"resume param {f}={getattr(param, f)!r} != checkpoint "
                  f"{f}={getattr(gbdt.param, f)!r}; the structural "
                  f"contract is frozen by the serving checkpoint")
        # handle_missing/base_score mismatches are refused inside
        # load_model_dict (the binning/margin contracts)
        out = cls(param, gbdt.num_feature, device=device)
        return out, out.load_model_dict(flat)


# serving_state schema: bump when the serve_meta layout changes
_SERVE_SCHEMA = 1
_SERVE_META_KEY = "serve_meta"
_OBJECTIVE_CODES = {"logistic": 0, "squared": 1, "softmax": 2}
_OBJECTIVE_FROM_CODE = {v: k for k, v in _OBJECTIVE_CODES.items()}


def _stack_trees(trees) -> TreeEnsemble:
    """Stack per-round tree tuples into an ensemble [T, ...]."""
    return TreeEnsemble(*(torch.stack([t[i] for t in trees])
                          for i in range(6)))


class _EarlyStop:
    """The sequential stopping rule: improvement = eval loss drop > 1e-9;
    stop once ``patience`` rounds pass without one."""

    def __init__(self, patience: int):
        self.patience = patience
        self.best_round = -1
        self.best_loss = float("inf")

    def update(self, r: int, loss: float) -> bool:
        """Record round r's eval loss; True = stop after this round."""
        if loss < self.best_loss - 1e-9:
            self.best_loss, self.best_round = loss, r
            return False
        return bool(self.patience) and r - self.best_round >= self.patience


def _eval_metric_fn(metric: str, objective: str):
    """Eval metric for fit_with_eval: 'loss' = the objective's own loss
    (logloss/mlogloss/MSE), 'error' = classification error rate (0.5
    threshold / argmax), 'rmse' / 'mae' = regression errors.  All are
    minimized by early stopping."""
    if metric == "loss":
        return lambda m, y: _logloss(m, y, objective)
    if metric == "error":
        CHECK(objective in ("logistic", "softmax"),
              f"eval_metric='error' needs a classification objective, "
              f"got {objective!r}")
        if objective == "softmax":
            return lambda m, y: torch.mean(
                (torch.argmax(m, dim=1) != y.to(torch.int32)).to(
                    torch.float32))
        return lambda m, y: torch.mean(((m > 0) != (y > 0.5)).to(
            torch.float32))
    if metric in ("rmse", "mae"):
        CHECK(objective == "squared",
              f"eval_metric={metric!r} compares margins to targets "
              f"directly — only meaningful for objective='squared', got "
              f"{objective!r} (classification margins are log-odds)")
        if metric == "rmse":
            return lambda m, y: torch.sqrt(torch.mean((m - y) ** 2))
        return lambda m, y: torch.mean(torch.abs(m - y))
    CHECK(False, f"unknown eval_metric {metric!r}; "
                 f"use loss|error|rmse|mae")


def _logloss(margin, label, objective: str):
    if objective == "logistic":
        return torch.mean(torch.logaddexp(torch.zeros_like(margin), margin)
                          - label * margin)
    if objective == "softmax":
        # mlogloss: mean cross-entropy of the true class
        logp = torch.log_softmax(margin, dim=1)
        ids = label.to(torch.int64)
        return -torch.mean(torch.gather(logp, 1, ids[:, None])[:, 0])
    return torch.mean((margin - label) ** 2)
