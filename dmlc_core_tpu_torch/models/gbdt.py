"""Histogram gradient-boosted trees on tensors (hist-GBDT on the H100).

Counterpart of ``dmlc_core_tpu/models/gbdt.py``: the same trees, grown
level by level from per-(node, feature, bin) gradient histograms, with the
same split scan (cumsum over bins, gain, first-maximum argmax), missing
values, monotone constraints, L1 and ``max_delta_step``.  Where the
reference compiles a round into one XLA program and scans over rounds, the
port runs eagerly: a Python loop over rounds and levels, each level one
histogram (the CUDA kernel on the card) plus a few tensor ops.

Distributed training follows the reference's mesh semantics with one
process per rank (:mod:`..parallel.mesh`): under ``with mesh:`` each rank
fits on its own rows, every level's histogram is summed over the mesh's
``data`` group (and, with ``model_axis``, computed by K4 on the rank's
feature window and gathered over the ``model`` group), the split scan
runs on every rank on identical sums, and leaf sums are summed over the
``data`` group.  Every rank ends with the same ensemble; margins stay
local.

Trees are stored level-order as in the reference: ``split_feat`` /
``split_bin`` [2**d - 1] with -1 marking "no split", ``leaf_value``
[2**d].  Row/column sampling draws from ``jax.random`` in the reference
and is not ported yet: those parameters raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch.ops import hist_cuda
from dmlc_core_tpu_torch.ops.histogram import (
    apply_bins, as_tensor, bin_onehot, data_allreduce,
    distributed_quantile_boundaries, grad_histogram, resolve_hist_method)
from dmlc_core_tpu_torch.param import Parameter, field
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
                      help="per-tree row subsampling rate (not ported)")
    colsample_bytree = field(float, default=1.0, lower=1e-6, upper=1.0,
                             help="per-tree feature sampling (not ported)")
    colsample_bylevel = field(float, default=1.0, lower=1e-6, upper=1.0,
                              help="per-level feature sampling (not ported)")
    colsample_bynode = field(float, default=1.0, lower=1e-6, upper=1.0,
                             help="per-node feature sampling (not ported)")
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
                        help="histogram algorithm: 'pallas' is the CUDA "
                             "kernel through a bf16 weight matrix, "
                             "'pallas_fused' the kernel that builds it "
                             "in-kernel; 'onehot' a matmul, 'scatter' exact "
                             "f32 index_add_ (the CPU default)")


_SAMPLING = ("subsample", "colsample_bytree", "colsample_bylevel",
             "colsample_bynode")


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


def _check_softmax_labels(label, num_class: int) -> None:
    host = label.cpu().numpy() if isinstance(label, torch.Tensor) \
        else np.asarray(label)
    if host.size == 0:
        return
    CHECK(host.min() >= 0 and host.max() < num_class,
          f"softmax labels must lie in [0, {num_class}); "
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


def _build_tree(bins, g, h, max_depth: int, num_bins: int, reg_lambda: float,
                min_child_weight: float, learning_rate: float,
                model_axis: Optional[str] = None, method: str = "scatter",
                onehot=None,
                min_split_loss: float = 0.0, missing: bool = False,
                reg_alpha: float = 0.0, monotone=None,
                max_delta_step: float = 0.0):
    """Grow one tree level by level; returns (split_feat, split_bin,
    leaf_value, default_left, split_gain, split_cover, margin_delta).

    ``missing=True`` scores every candidate twice from the same cumsums,
    with the missing bin (``num_bins - 1``) right and left, and stores the
    better direction in ``default_left``.  ``monotone`` ([F] in {-1, 0, 1})
    masks violating splits, carries a [lower, upper] weight interval per
    node split at the clamped midpoint, and clamps leaves into it.

    Under an ambient mesh the histograms and leaf sums cover every rank's
    rows (``model_axis`` shards the histogram's features), so the split
    scan sees the same sums, and picks the same splits, on every rank;
    rows are routed locally.
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

    for depth in range(max_depth):
        n_nodes = 2 ** depth
        level_off = n_nodes - 1
        G, H = grad_histogram(bins, node, g, h, n_nodes, num_bins,
                              model_axis=model_axis, method=method,
                              onehot=onehot, device=dev)  # [n, F, nbins]
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
                ok = ok & ~(c * (wl - wr) > 0)           # violating splits
            return gn, ok

        gain, valid = _gain(GL, HL)
        if missing:
            # default-right is scored above; default-left moves the missing
            # bin's mass into the left sums
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
        gain = torch.where(valid, gain, -float("inf"))
        flat = gain.reshape(n_nodes, F * num_bins)
        best = torch.argmax(flat, dim=-1)                # first maximum
        best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
        bf = (best // num_bins).to(torch.int32)
        bb = (best % num_bins).to(torch.int32)
        do_split = best_gain > min_split_loss
        sf = torch.where(do_split, bf, -1).to(torch.int32)
        if missing:
            dl = torch.gather(go_left_default.reshape(n_nodes, F * num_bins),
                              1, best[:, None])[:, 0] & do_split
        else:
            dl = torch.zeros((n_nodes,), dtype=torch.bool, device=dev)
        lvl = slice(level_off, level_off + n_nodes)
        split_feat[lvl] = sf
        split_bin[lvl] = bb
        default_left[lvl] = dl
        split_gain[lvl] = torch.where(do_split, best_gain, 0.0)
        split_cover[lvl] = torch.where(do_split, HT[:, 0, 0], 0.0)
        if monotone is not None:
            def _at_best(a):
                return torch.gather(a.reshape(n_nodes, F * num_bins), 1,
                                    best[:, None])[:, 0]

            GLb, HLb = _at_best(GL), _at_best(HL)
            if missing:
                GLb = torch.where(
                    dl, _at_best(GL + G[..., miss_id:miss_id + 1]), GLb)
                HLb = torch.where(
                    dl, _at_best(HL + H[..., miss_id:miss_id + 1]), HLb)
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
            lo_l = torch.where(c_node < 0, torch.maximum(node_lo, mid), lo_l)
            hi_r = torch.where(c_node < 0, torch.minimum(node_hi, mid), hi_r)
            node_lo = torch.stack([lo_l, lo_r], dim=1).reshape(-1)
            node_hi = torch.stack([hi_l, hi_r], dim=1).reshape(-1)
        # advance every row one level
        nf = sf.to(torch.int64)[node]                    # [B]
        row_bin = torch.gather(bins, 1, nf.clamp(min=0)[:, None])[:, 0]
        row_bin = row_bin.to(torch.int32)
        go_right = (row_bin > bb[node]) & (nf >= 0)
        if missing:
            # missing rows sit above every threshold; default-left overrides
            go_right = go_right & ~((row_bin == miss_id) & dl[node])
        node = node * 2 + go_right.to(torch.int64)

    n_leaf = 2 ** max_depth
    if method in ("onehot", "pallas", "pallas_fused"):
        # leaf sums as a small f32 matmul, as the reference does for its
        # matmul-shaped methods (deterministic on the card, unlike float
        # atomics)
        leafhot = (node[:, None] == torch.arange(n_leaf, device=dev)
                   ).to(torch.float32)                   # [B, n_leaf]
        sums = torch.matmul(leafhot.t(), torch.stack([g, h], dim=1))
        Gl, Hl = sums[:, 0], sums[:, 1]
    else:
        Gl = torch.zeros(n_leaf, device=dev).index_add_(0, node, g)
        Hl = torch.zeros(n_leaf, device=dev).index_add_(0, node, h)
    Gl, Hl = data_allreduce(Gl, Hl)          # every data shard's rows
    leaf_w = -_l1_threshold(Gl, reg_alpha) / (Hl + reg_lambda)
    if max_delta_step > 0.0:
        leaf_w = torch.clamp(leaf_w, -max_delta_step, max_delta_step)
    if monotone is not None:
        leaf_w = _clip(leaf_w, node_lo, node_hi)
    leaf_value = leaf_w * learning_rate
    margin_delta = leaf_value[node]
    return (split_feat, split_bin, leaf_value, default_left, split_gain,
            split_cover, margin_delta)


def _softmax_round(p, bins, margin, label, weight, grow):
    """One multiclass round: K trees from one margin snapshot."""
    K = p.num_class
    g_all, h_all = _softmax_grad_hess(margin, label, K)
    trees = [grow(bins, g_all[:, k] * weight, h_all[:, k] * weight)
             for k in range(K)]
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
            elif method == "pallas_fused":
                mp = mesh.shape[self.model_axis]
                if hist_cuda.hist_node_block(
                        deepest, self.num_feature // mp,
                        self.param.num_bins) < deepest:
                    method = "pallas"   # blocked sweeps have no fused form
        return method

    def _check_sampling(self) -> None:
        for name in _SAMPLING:
            if getattr(self.param, name) < 1.0:
                raise NotImplementedError(
                    f"GBDTParam.{name}={getattr(self.param, name)}: row and "
                    f"column sampling draw from jax.random in the reference "
                    f"and are not ported yet")

    def _bins(self, bins):
        return _widen_bins(as_tensor(bins, self.device)).contiguous()

    def _rows(self, v, n: int):
        if v is None:
            return torch.ones(n, dtype=torch.float32, device=self.device)
        return as_tensor(v, self.device, torch.float32)

    def _round(self, margin, bins, label, weight, method: str, onehot):
        p = self.param

        def grow(bins_, g, h):
            return _build_tree(
                bins_, g, h, p.max_depth, p.num_bins, p.reg_lambda,
                p.min_child_weight, p.learning_rate, self.model_axis,
                method=method, onehot=onehot, min_split_loss=p.min_split_loss,
                missing=p.handle_missing, reg_alpha=p.reg_alpha,
                monotone=self._monotone, max_delta_step=p.max_delta_step)

        if p.objective == "softmax":
            return _softmax_round(p, bins, margin, label, weight, grow)
        g, h = _grad_hess(margin, label, p.objective)
        sf, sb, lv, dl, sg, sc, delta = grow(bins, g * weight, h * weight)
        return margin + delta, (sf, sb, lv, dl, sg, sc)

    def _k(self) -> int:
        return self.param.num_class if self.param.objective == "softmax" \
            else 1

    # -- public API ----------------------------------------------------------
    def fit_binned(self, bins, label, weight=None
                   ) -> Tuple[TreeEnsemble, Any]:
        """Train on pre-binned features; returns (ensemble, final margin)."""
        p = self.param
        self._check_sampling()
        if p.objective == "softmax":
            _check_softmax_labels(label, p.num_class)
        bins = self._bins(bins)
        B = bins.shape[0]
        label = as_tensor(label, self.device, torch.float32)
        weight = _apply_pos_weight(self._rows(weight, B), label, p)
        method = self._method(bins)
        # the bin one-hot is invariant across rounds and levels
        onehot = bin_onehot(bins, p.num_bins) if method == "onehot" else None
        K = self._k()
        margin = torch.full((B,) if K == 1 else (B, K), p.base_score,
                            dtype=torch.float32, device=self.device)
        trees = []
        for _ in range(p.num_boost_round):
            margin, tree = self._round(margin, bins, label, weight, method,
                                       onehot)
            trees.append(tree)
        return TreeEnsemble(*(torch.stack([t[i] for t in trees])
                              for i in range(6))), margin

    def boost_round(self, margin, bins, label, weight,
                    round_index: Optional[int] = None):
        """One boosting round; returns (margin, tree arrays).
        ``round_index`` seeds sampling in the reference, which is not
        ported, so it is accepted and unused."""
        self._check_sampling()
        bins = self._bins(bins)
        label = as_tensor(label, self.device, torch.float32)
        weight = _apply_pos_weight(self._rows(weight, bins.shape[0]), label,
                                   self.param)
        margin = as_tensor(margin, self.device, torch.float32)
        method = self._method(bins)
        onehot = (bin_onehot(bins, self.param.num_bins)
                  if method == "onehot" else None)
        return self._round(margin, bins, label, weight, method, onehot)

    def append_rounds(self, ensemble: Optional[TreeEnsemble], bins, label,
                      weight=None, *, num_rounds: int = 1, margin=None,
                      start_round: Optional[int] = None
                      ) -> Tuple[TreeEnsemble, Any]:
        """Append ``num_rounds`` rounds trained on fresh binned data (the
        warm start); returns (extended ensemble, final margin).  The margin
        is seeded from the ensemble's own predictions unless given."""
        CHECK(num_rounds >= 1, "append_rounds needs num_rounds >= 1")
        bins = self._bins(bins)
        B = bins.shape[0]
        K = self._k()
        if margin is None:
            if ensemble is None:
                margin = torch.full((B,) if K == 1 else (B, K),
                                    self.param.base_score,
                                    dtype=torch.float32, device=self.device)
            else:
                margin = self.predict_margin(ensemble, bins)
        new = []
        for r in range(num_rounds):
            margin, tree = self.boost_round(margin, bins, label, weight)
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
        out = torch.full(shape, self.param.base_score, dtype=torch.float32,
                         device=self.device)
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
