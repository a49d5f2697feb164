"""PyTorch port vs the JAX package: hist-GBDT training and scoring.

The same seeded numpy data trains the JAX ``GBDT`` (on the CPU; the Pallas
kernels in interpret mode) and the port's (``device="cpu"``, the kernels'
plain versions).  Trees must be identical (``split_feat``,
``default_left`` and, where a node splits, ``split_bin`` equal); leaf values and margins agree to rtol 1e-5 for
the exact scatter and 1e-4 for the bf16 kernel path (f32 sums in another
order, and float ops that may differ by an ulp between the frameworks).
"""

import numpy as np
import pytest
import torch

from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu.models.gbdt import GBDTParam as JaxParam
from dmlc_core_tpu.models.gbdt import TreeEnsemble as JaxEnsemble
from dmlc_core_tpu.ops import hist_pallas
from dmlc_core_tpu_torch.bridge.binning import HostBinner
from dmlc_core_tpu_torch.convert import (ensemble_from_numpy,
                                         ensemble_to_numpy)
from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam

N_FEATURE = 4


@pytest.fixture
def interpret_mode():
    def clear():
        for probe in (hist_pallas.pallas_supported,
                      hist_pallas.pallas_fused_supported,
                      hist_pallas.pallas_i8_supported):
            probe.cache_clear()

    hist_pallas._INTERPRET = True
    clear()
    yield
    hist_pallas._INTERPRET = False
    clear()


def _data(n=600, seed=0, objective="logistic", nan=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, N_FEATURE).astype(np.float32)
    w = rng.randn(N_FEATURE).astype(np.float32)
    score = x @ w + 0.3 * rng.randn(n)
    if objective == "softmax":
        y = np.digitize(score, [-0.5, 0.5]).astype(np.float32)   # 3 classes
    elif objective == "squared":
        y = score.astype(np.float32)
    else:
        y = (score > 0).astype(np.float32)
    if nan:
        x[rng.rand(n, N_FEATURE) < 0.15] = np.nan
    return x, y


def _pair(**kw):
    """A JAX model and a port model with the same parameters and edges."""
    jm = JaxGBDT(JaxParam(**kw), num_feature=N_FEATURE)
    pm = GBDT(GBDTParam(**kw), num_feature=N_FEATURE, device="cpu")
    return jm, pm


def _assert_same_trees(port_ens, jax_ens, rtol):
    for name in ("split_feat", "default_left"):
        np.testing.assert_array_equal(
            getattr(port_ens, name).numpy(),
            np.asarray(getattr(jax_ens, name)), err_msg=name)
    # split_bin of a node that does not split is the argmax of gains that
    # all fall below the split threshold, and routing never reads it
    split = np.asarray(jax_ens.split_feat) >= 0
    np.testing.assert_array_equal(port_ens.split_bin.numpy()[split],
                                  np.asarray(jax_ens.split_bin)[split],
                                  err_msg="split_bin")
    for name in ("leaf_value", "split_cover"):
        np.testing.assert_allclose(
            getattr(port_ens, name).numpy(),
            np.asarray(getattr(jax_ens, name)), rtol=rtol, atol=rtol,
            err_msg=name)
    # a gain is a difference of leaf scores, so its error scales with the
    # largest score of the tree, not with the gain itself
    want = np.asarray(jax_ens.split_gain)
    np.testing.assert_allclose(port_ens.split_gain.numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max(),
                               err_msg="split_gain")


CONFIGS = {
    "logistic": dict(),
    "squared": dict(objective="squared", base_score=0.1),
    "softmax": dict(objective="softmax", num_class=3),
    "missing": dict(handle_missing=True),
    "monotone": dict(monotone_constraints="(1,0,-1,0)"),
    "reg_alpha": dict(reg_alpha=0.5, min_split_loss=0.01),
    "max_delta_step": dict(max_delta_step=0.2, scale_pos_weight=2.0),
    # row and column sampling, on 500 rows: the JAX fit pads its rows to
    # the kernel tile, and a draw over the padded count would show
    "subsample": dict(subsample=0.7, seed=3),
    "colsample_bytree": dict(colsample_bytree=0.5, seed=4),
    "colsample_bylevel": dict(colsample_bylevel=0.5, seed=5),
    "colsample_bynode": dict(colsample_bynode=0.5, seed=6),
    "sampled_all": dict(subsample=0.8, colsample_bytree=0.8,
                        colsample_bylevel=0.8, colsample_bynode=0.8),
    "softmax_sampled": dict(objective="softmax", num_class=3, subsample=0.7,
                            colsample_bytree=0.8, colsample_bynode=0.6,
                            seed=2 ** 33 + 5),
}
SAMPLED_ROWS = 500


def _sampled(kw):
    return any(k in kw for k in ("subsample", "colsample_bytree",
                                 "colsample_bylevel", "colsample_bynode"))


@pytest.mark.parametrize("method", ["scatter", "pallas"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_fit_binned_matches_jax(interpret_mode, config, method):
    kw = dict(num_boost_round=2, max_depth=3, num_bins=16,
              hist_method=method, **CONFIGS[config])
    objective = kw.get("objective", "logistic")
    x, y = _data(n=SAMPLED_ROWS if _sampled(kw) else 600,
                 objective=objective, nan=kw.get("handle_missing", False))
    jm, pm = _pair(**kw)
    jm.make_bins(x)
    pm.set_boundaries(jm.boundaries)
    bins = np.asarray(jm.bin_features(x))
    np.testing.assert_array_equal(pm.bin_features(x).numpy(), bins)
    weight = np.random.RandomState(1).rand(len(y)).astype(np.float32) + 0.5
    j_ens, j_margin = jm.fit_binned(bins, y, weight)
    p_ens, p_margin = pm.fit_binned(torch.from_numpy(bins.copy()), y,
                                     weight)
    rtol = 1e-5 if method == "scatter" else 1e-4
    _assert_same_trees(p_ens, j_ens, rtol)
    np.testing.assert_allclose(p_margin.numpy(), np.asarray(j_margin),
                               rtol=rtol, atol=rtol)
    # scoring the trained ensemble reproduces the training margin
    np.testing.assert_allclose(pm.predict_margin(p_ens, bins).numpy(),
                               p_margin.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("config", ["logistic", "softmax", "missing"])
def test_jax_ensemble_scores_identically(config):
    kw = dict(num_boost_round=3, max_depth=4, num_bins=32,
              hist_method="scatter", **CONFIGS[config])
    x, y = _data(n=800, seed=2, objective=kw.get("objective", "logistic"),
                 nan=kw.get("handle_missing", False))
    jm, pm = _pair(**kw)
    jm.make_bins(x)
    j_ens, _ = jm.fit_binned(np.asarray(jm.bin_features(x)), y)
    pm.set_boundaries(jm.boundaries)
    carried = ensemble_from_numpy([None if a is None else np.asarray(a)
                                   for a in j_ens], device="cpu")
    x_new, _ = _data(n=300, seed=3, nan=kw.get("handle_missing", False))
    j_bins = jm.bin_features(x_new)
    p_bins = pm.bin_features(x_new)
    np.testing.assert_allclose(pm.predict_margin(carried, p_bins).numpy(),
                               np.asarray(jm.predict_margin(j_ens, j_bins)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pm.predict(carried, p_bins).numpy(),
                               np.asarray(jm.predict(j_ens, j_bins)),
                               rtol=1e-6, atol=1e-6)
    if kw.get("objective", "logistic") != "squared":
        np.testing.assert_array_equal(
            pm.predict_class(carried, p_bins).numpy(),
            np.asarray(jm.predict_class(j_ens, j_bins)))
    # and back: the port's arrays rebuild a JAX ensemble that scores the same
    back = JaxEnsemble(*ensemble_to_numpy(carried))
    np.testing.assert_array_equal(
        np.asarray(jm.predict_margin(back, j_bins)),
        np.asarray(jm.predict_margin(j_ens, j_bins)))


@pytest.mark.parametrize("method", ["scatter", "pallas"])
def test_uint8_wire_gives_same_trees(method):
    x, y = _data(n=700, seed=4)
    pm = GBDT(GBDTParam(num_boost_round=2, max_depth=3, num_bins=256,
                        hist_method=method), N_FEATURE, device="cpu")
    pm.make_bins(x)
    wire = HostBinner(pm.boundaries, 256).transform(x)
    assert wire.dtype == np.uint8
    e8, m8 = pm.fit_binned(wire, y)
    e32, m32 = pm.fit_binned(pm.bin_features(x), y)
    for a, b in zip(e8, e32):
        assert torch.equal(a, b)
    assert torch.equal(m8, m32)


@pytest.mark.parametrize("name", ["subsample", "colsample_bytree",
                                  "colsample_bylevel", "colsample_bynode"])
def test_sampling_not_ported(name):
    """Named when these rates raised in the port; now each rate's
    ``fit_binned`` and ``boost_round`` grow the JAX package's trees."""
    x, y = _data(n=64)
    kw = dict(num_boost_round=3, max_depth=3, num_bins=16, seed=1,
              hist_method="scatter", **{name: 0.5})
    jm, pm = _pair(**kw)
    jm.make_bins(x)
    pm.set_boundaries(jm.boundaries)
    bins = np.asarray(jm.bin_features(x))
    _assert_same_trees(pm.fit_binned(bins, y)[0], jm.fit_binned(bins, y)[0],
                       1e-5)
    margin = np.full(len(y), 0.25, np.float32)
    weight = np.ones(len(y), np.float32)
    p_margin, p_tree = pm.boost_round(torch.from_numpy(margin), bins, y,
                                      weight, round_index=7)
    j_margin, j_tree = jm.boost_round(margin, bins, y, weight,
                                      round_index=7)
    _assert_same_trees(JaxEnsemble(*(t[None] for t in p_tree)),
                       JaxEnsemble(*(np.asarray(t)[None] for t in j_tree)),
                       1e-5)
    np.testing.assert_allclose(p_margin.numpy(), np.asarray(j_margin),
                               rtol=1e-5, atol=1e-5)


def test_append_rounds_matches_jax():
    kw = dict(num_boost_round=2, max_depth=3, num_bins=16,
              hist_method="scatter")
    x, y = _data(n=500, seed=5)
    jm, pm = _pair(**kw)
    jm.make_bins(x)
    pm.set_boundaries(jm.boundaries)
    bins = np.asarray(jm.bin_features(x))
    j_ens, _ = jm.fit_binned(bins, y)
    p_ens, _ = pm.fit_binned(bins, y)
    j_more, j_margin = jm.append_rounds(j_ens, bins, y, num_rounds=2)
    p_more, p_margin = pm.append_rounds(p_ens, bins, y, num_rounds=2)
    assert p_more.num_trees == 4
    _assert_same_trees(p_more, j_more, 1e-5)
    np.testing.assert_allclose(p_margin.numpy(), np.asarray(j_margin),
                               rtol=1e-5, atol=1e-5)


def test_param_loads_jax_dict_unchanged():
    jp = JaxParam(max_depth=5, hist_method="pallas_fused", reg_alpha=0.25,
                  handle_missing=True, monotone_constraints="(1,0)")
    pp = GBDTParam(**jp.to_dict())
    assert pp.to_dict() == jp.to_dict()
    assert pp.hist_method == "pallas_fused" and pp.handle_missing is True
    assert set(GBDTParam.__fields__) == set(JaxParam.__fields__)
