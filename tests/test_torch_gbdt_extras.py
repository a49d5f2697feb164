"""PyTorch port vs the JAX package: the GBDT estimator extras.

``fit_with_eval`` (eval-set losses, every eval metric, early stopping),
``staged_losses``, ``predict_leaf``, ``feature_importance`` and
``dump_trees``.  Separately fitted models: the same seeded numpy data goes
through the JAX ``GBDT`` (on the CPU; Pallas in interpret mode for
``"pallas"``) and the port's (``device="cpu"``, the kernels' plain
versions); trees must agree as in ``tests/test_torch_gbdt.py`` (rtol 1e-5
for ``"scatter"``, 1e-4 for the bf16 kernel path), history losses to rtol
1e-5, and the early-stopping round exactly.  One JAX-fitted ensemble
loaded into both packages: leaf ids equal, importances exact for
``weight`` and within rtol 1e-6 otherwise, dumps identical text, staged
losses within rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu.models.gbdt import GBDTParam as JaxParam
from dmlc_core_tpu.ops import hist_pallas
from dmlc_core_tpu_torch.convert import ensemble_from_numpy
from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam

N_FEATURE = 8
N_TRAIN = 2000
N_EVAL = 600


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


def _data(objective, seed=3, nan=False):
    rng = np.random.RandomState(seed)
    n = N_TRAIN + N_EVAL
    x = rng.randn(n, N_FEATURE).astype(np.float32)
    w = rng.randn(N_FEATURE).astype(np.float32)
    score = x @ w + rng.randn(n)
    if objective == "softmax":
        y = np.digitize(score, [-0.7, 0.7]).astype(np.float32)  # 3 classes
    elif objective == "squared":
        y = score.astype(np.float32)
    else:
        y = (score > 0).astype(np.float32)
    if nan:
        x[rng.rand(n, N_FEATURE) < 0.15] = np.nan
    return x, y


def _kw(objective, **over):
    kw = dict(num_boost_round=16, max_depth=3, num_bins=16,
              learning_rate=0.8, hist_method="scatter", objective=objective,
              num_class=3 if objective == "softmax" else 1)
    kw.update(over)
    return kw


def _pair(objective, x, **over):
    """A JAX and a port model with the same parameters and JAX-fit edges;
    returns them with the JAX binning of ``x``."""
    kw = _kw(objective, **over)
    jm = JaxGBDT(JaxParam(**kw), num_feature=N_FEATURE)
    jm.make_bins(x[:N_TRAIN])
    pm = GBDT(GBDTParam(**kw), num_feature=N_FEATURE, device="cpu")
    pm.set_boundaries(jm.boundaries)
    return jm, pm, np.asarray(jm.bin_features(x))


def _assert_same_trees(port_ens, jax_ens, rtol):
    for name in ("split_feat", "default_left"):
        np.testing.assert_array_equal(
            getattr(port_ens, name).numpy(),
            np.asarray(getattr(jax_ens, name)), err_msg=name)
    # split_bin of a node that does not split is never read by routing
    split = np.asarray(jax_ens.split_feat) >= 0
    np.testing.assert_array_equal(port_ens.split_bin.numpy()[split],
                                  np.asarray(jax_ens.split_bin)[split],
                                  err_msg="split_bin")
    for name in ("leaf_value", "split_cover"):
        np.testing.assert_allclose(
            getattr(port_ens, name).numpy(),
            np.asarray(getattr(jax_ens, name)), rtol=rtol, atol=rtol,
            err_msg=name)
    # a gain's error scales with the largest score of its tree
    want = np.asarray(jax_ens.split_gain)
    np.testing.assert_allclose(port_ens.split_gain.numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max(),
                               err_msg="split_gain")


def _assert_same_history(port_hist, jax_hist):
    assert len(port_hist) == len(jax_hist)
    for p, j in zip(port_hist, jax_hist):
        assert sorted(p) == sorted(j)
        assert p["round"] == j["round"]
        for key in ("train_loss", "eval_loss"):
            if key in j:
                np.testing.assert_allclose(p[key], j[key], rtol=1e-5,
                                           err_msg=key)


METRICS = {"logistic": ("loss", "error"),
           "squared": ("loss", "rmse", "mae"),
           "softmax": ("loss", "error")}
FIT_CASES = [(obj, metric, esr) for obj in sorted(METRICS)
             for metric in METRICS[obj] for esr in (0, 3)]


@pytest.mark.parametrize("objective,metric,esr", FIT_CASES)
def test_fit_with_eval_matches_jax(objective, metric, esr):
    x, y = _data(objective)
    jm, pm, bins = _pair(objective, x)
    tr, ev = bins[:N_TRAIN], bins[N_TRAIN:]
    ytr, yev = y[:N_TRAIN], y[N_TRAIN:]
    j_ens, j_hist = jm.fit_with_eval(tr, ytr, ev, yev,
                                     early_stopping_rounds=esr,
                                     eval_metric=metric)
    runs = [pm.fit_with_eval(tr, ytr, ev, yev, early_stopping_rounds=esr,
                             eval_metric=metric, compiled=compiled)
            for compiled in (True, False)]
    for p_ens, p_hist in runs:
        _assert_same_history(p_hist, j_hist)
        # the same stopping round, so the same truncation
        assert p_ens.num_trees == np.asarray(j_ens.split_feat).shape[0]
        _assert_same_trees(p_ens, j_ens, rtol=1e-5)
    # both values of compiled run one loop: the same bits
    (a, ha), (b, hb) = runs
    assert ha == hb
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("objective", sorted(METRICS))
def test_fit_with_eval_pallas_matches_jax(interpret_mode, objective):
    x, y = _data(objective, seed=4)
    jm, pm, bins = _pair(objective, x, hist_method="pallas",
                         num_boost_round=6)
    args = (bins[:N_TRAIN], y[:N_TRAIN], bins[N_TRAIN:], y[N_TRAIN:])
    j_ens, j_hist = jm.fit_with_eval(*args, early_stopping_rounds=2)
    p_ens, p_hist = pm.fit_with_eval(*args, early_stopping_rounds=2)
    _assert_same_history(p_hist, j_hist)
    _assert_same_trees(p_ens, j_ens, rtol=1e-4)


@pytest.mark.parametrize("objective", sorted(METRICS))
def test_fit_with_eval_without_eval_set_matches_jax(objective):
    x, y = _data(objective, seed=5)
    jm, pm, bins = _pair(objective, x, num_boost_round=4)
    j_ens, j_hist = jm.fit_with_eval(bins, y)
    p_ens, p_hist = pm.fit_with_eval(bins, y)
    assert all("eval_loss" not in h for h in p_hist)
    _assert_same_history(p_hist, j_hist)
    _assert_same_trees(p_ens, j_ens, rtol=1e-5)
    # the same trees as fit_binned, to the bit
    f_ens, _ = pm.fit_binned(bins, y)
    assert all(torch.equal(u, v) for u, v in zip(p_ens, f_ens))


def test_tree_margin_fn_sums_to_predict_margin():
    x, y = _data("logistic", seed=6)
    _, pm, bins = _pair("logistic", x, num_boost_round=5)
    ens, _ = pm.fit_binned(bins[:N_TRAIN], y[:N_TRAIN])
    tm = pm._tree_margin_fn()
    incr = torch.zeros(N_EVAL)
    for t in range(ens.num_trees):
        incr = incr + tm(ens.split_feat[t], ens.split_bin[t],
                         ens.leaf_value[t], ens.default_left[t],
                         bins[N_TRAIN:])
    full = pm.predict_margin(ens, bins[N_TRAIN:])
    assert torch.equal(full, incr)


@pytest.mark.parametrize("objective", ["logistic", "softmax"])
def test_staged_losses_equal_eval_history(objective):
    x, y = _data(objective, seed=7)
    _, pm, bins = _pair(objective, x, num_boost_round=6)
    ens, hist = pm.fit_with_eval(bins[:N_TRAIN], y[:N_TRAIN],
                                 bins[N_TRAIN:], y[N_TRAIN:])
    curve = pm.staged_losses(ens, bins[N_TRAIN:], y[N_TRAIN:])
    assert curve.shape == (ens.num_trees,) and curve.dtype == np.float32
    # the same margins in the same order: the same losses
    assert [float(c) for c in curve] == [h["eval_loss"] for h in hist]


def test_fit_with_eval_guards():
    pm = GBDT(GBDTParam(**_kw("softmax", num_boost_round=2)), 2,
              device="cpu")
    bins = np.zeros((10, 2), np.int32)
    good = np.zeros(10, np.float32)
    with pytest.raises(Exception, match="softmax labels"):
        pm.fit_with_eval(bins, np.full(10, 5.0, np.float32))
    with pytest.raises(Exception, match="eval labels"):
        pm.fit_with_eval(bins, good, bins, np.full(10, 4.0, np.float32))
    sq = GBDT(GBDTParam(**_kw("squared", num_boost_round=2)), 2,
              device="cpu")
    with pytest.raises(Exception, match="unknown eval_metric"):
        sq.fit_with_eval(bins, good, bins, good, eval_metric="auc")
    with pytest.raises(Exception, match="classification"):
        sq.fit_with_eval(bins, good, bins, good, eval_metric="error")
    lg = GBDT(GBDTParam(**_kw("logistic", num_boost_round=2)), 2,
              device="cpu")
    with pytest.raises(Exception, match="only meaningful"):
        lg.fit_with_eval(bins, good, bins, good, eval_metric="rmse")


# -- one JAX-fitted ensemble, read by both packages --------------------------
LOADED = {
    "logistic": dict(objective="logistic"),
    "squared": dict(objective="squared", base_score=0.25),
    "softmax": dict(objective="softmax"),
    "missing": dict(objective="logistic", handle_missing=True),
}


@pytest.fixture(scope="module")
def jax_fitted():
    """Per config: (jax model, port model holding the JAX ensemble, jax
    ensemble, port ensemble, eval bins, eval labels)."""
    out = {}
    for name, cfg in LOADED.items():
        cfg = dict(cfg)
        objective = cfg.pop("objective")
        x, y = _data(objective, seed=11, nan=cfg.get("handle_missing",
                                                      False))
        kw = _kw(objective, num_boost_round=5, max_depth=4, num_bins=32,
                 learning_rate=0.5, **cfg)
        jm = JaxGBDT(JaxParam(**kw), num_feature=N_FEATURE)
        jm.make_bins(x[:N_TRAIN])
        bins = np.asarray(jm.bin_features(x))
        j_ens, _ = jm.fit_binned(bins[:N_TRAIN], y[:N_TRAIN])
        j_ens = type(j_ens)(*(None if a is None else np.asarray(a)
                              for a in j_ens))
        pm = GBDT(GBDTParam(**kw), num_feature=N_FEATURE, device="cpu")
        pm.set_boundaries(jm.boundaries)
        p_ens = ensemble_from_numpy(j_ens, device="cpu")
        out[name] = (jm, pm, j_ens, p_ens, bins[N_TRAIN:], y[N_TRAIN:])
    return out


@pytest.mark.parametrize("config", sorted(LOADED))
def test_predict_leaf_equal(jax_fitted, config):
    jm, pm, j_ens, p_ens, bins, _ = jax_fitted[config]
    want = np.asarray(jm.predict_leaf(j_ens, bins))
    got = pm.predict_leaf(p_ens, bins)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert got.shape[:2] == (len(bins), j_ens.split_feat.shape[0])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["weight", "gain", "total_gain", "cover",
                                  "total_cover"])
@pytest.mark.parametrize("config", sorted(LOADED))
def test_feature_importance_equal(jax_fitted, config, kind):
    jm, pm, j_ens, p_ens, _, _ = jax_fitted[config]
    want = jm.feature_importance(j_ens, kind)
    got = pm.feature_importance(p_ens, kind)
    assert got.shape == (N_FEATURE,) and got.dtype == np.float64
    if kind == "weight":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("named", [False, True])
@pytest.mark.parametrize("config", sorted(LOADED))
def test_dump_trees_identical_text(jax_fitted, config, named):
    jm, pm, j_ens, p_ens, _, _ = jax_fitted[config]
    names = [f"col{i}" for i in range(N_FEATURE)] if named else None
    got = pm.dump_trees(p_ens, feature_names=names)
    assert got == jm.dump_trees(j_ens, feature_names=names)
    assert got.count("booster[") == int(np.prod(j_ens.split_feat.shape[:-1]))


STAGED = [("logistic", "loss"), ("logistic", "error"), ("squared", "loss"),
          ("squared", "rmse"), ("squared", "mae"), ("softmax", "loss"),
          ("softmax", "error"), ("missing", "loss")]


@pytest.mark.parametrize("config,metric", STAGED)
def test_staged_losses_match_jax(jax_fitted, config, metric):
    jm, pm, j_ens, p_ens, bins, y = jax_fitted[config]
    want = np.asarray(jm.staged_losses(j_ens, bins, y, metric=metric))
    got = pm.staged_losses(p_ens, bins, y, metric=metric)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_importance_needs_split_statistics(jax_fitted):
    _, pm, _, p_ens, _, _ = jax_fitted["logistic"]
    bare = p_ens._replace(split_gain=None, split_cover=None)
    assert pm.feature_importance(bare, "weight").sum() > 0
    with pytest.raises(Exception, match="split statistics"):
        pm.feature_importance(bare, "gain")
    with pytest.raises(Exception, match="importance kind"):
        pm.feature_importance(p_ens, "shap")
