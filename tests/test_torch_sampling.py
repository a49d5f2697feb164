"""PyTorch port vs the JAX package: row and column sampling.

The port's draws (:mod:`dmlc_core_tpu_torch.utils.threefry` under
``_tree_sampling``, ``_level_mask_fn`` and ``_row_sampling``) must be
bitwise ``jax.random``'s for the same (seed, round, class, depth), and the
sampled fits through every entry point (``boost_round``,
``append_rounds``, ``fit_with_eval``, the estimators) must grow the JAX
package's trees: ``split_feat`` and ``default_left`` equal, ``split_bin``
equal where a node splits, leaves to rtol 1e-5 on the exact scatter path
and 1e-4 on the kernel path (Pallas in interpret mode on the JAX side).
"""

import numpy as np
import pytest
import torch

from dmlc_core_tpu.models import gbdt as jax_gbdt
from dmlc_core_tpu.models.sklearn import GBDTClassifier as JaxClassifier
from dmlc_core_tpu.models.sklearn import GBDTRegressor as JaxRegressor
from dmlc_core_tpu.ops import hist_pallas
from dmlc_core_tpu_torch.models import gbdt as port_gbdt
from dmlc_core_tpu_torch.models.sklearn import GBDTClassifier, GBDTRegressor
from dmlc_core_tpu_torch.utils import threefry

SEEDS = [0, 7, 2 ** 33 + 5, -1]
ROUNDS = [0, 1, 1000]
RATES = [0.1, 0.5, 0.8]
ALL_RATES = dict(subsample=0.8, colsample_bytree=0.8, colsample_bylevel=0.8,
                 colsample_bynode=0.8)


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


def _params(**kw):
    return jax_gbdt.GBDTParam(**kw), port_gbdt.GBDTParam(**kw)


def _same_bits(port, want, what):
    want = np.asarray(want)
    got = port.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                  err_msg=what)


@pytest.mark.parametrize("rnd", ROUNDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_matches_jax_random(seed, rnd):
    import jax
    import jax.numpy as jnp

    jkey = jax.random.fold_in(jax.random.PRNGKey(seed),
                              jnp.asarray(rnd, jnp.uint32))
    pkey = threefry.fold_in(threefry.prng_key(seed), rnd)
    assert tuple(int(v) for v in np.asarray(jkey)) == pkey
    for shape in [(7,), (1000,), (28,), (5, 28)]:
        _same_bits(threefry.uniform(pkey, shape),
                   jax.random.uniform(jkey, shape), shape)
    # a slice of a draw is the draw at an offset
    full = threefry.uniform(pkey, (4096,))
    assert torch.equal(threefry.uniform(pkey, (500,), offset=1000),
                       full[1000:1500])


@pytest.mark.parametrize("rnd", ROUNDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_tree_sampling_bitwise_jax(seed, rnd):
    for rate in RATES:
        jp, pp = _params(seed=seed, subsample=rate, colsample_bytree=rate)
        for class_index in (0, 2):
            for B in (7, 500, 4096):
                for F in (4, 28):
                    what = (rate, class_index, B, F)
                    jw, jm = jax_gbdt._tree_sampling(jp, rnd, B, F,
                                                     class_index=class_index)
                    pw, pm = port_gbdt._tree_sampling(
                        pp, rnd, B, F, class_index=class_index)
                    _same_bits(pw, jw, what)
                    _same_bits(pm, jm, what)
                    assert bool(pm.any())


@pytest.mark.parametrize("seed", SEEDS)
def test_level_mask_bitwise_jax(seed):
    import jax.numpy as jnp

    for rate in RATES:
        for kw in (dict(colsample_bylevel=rate),
                   dict(colsample_bynode=rate),
                   dict(colsample_bylevel=rate, colsample_bynode=rate)):
            jp, pp = _params(seed=seed, colsample_bytree=0.5, **kw)
            for rnd in ROUNDS:
                for F in (4, 28):
                    _, jtree = jax_gbdt._tree_sampling(jp, rnd, 8, F)
                    _, ptree = port_gbdt._tree_sampling(pp, rnd, 8, F)
                    jfn = jax_gbdt._level_mask_fn(jp, rnd, F)
                    pfn = port_gbdt._level_mask_fn(pp, rnd, F)
                    for depth in range(4):
                        n = 2 ** depth
                        what = (rate, kw, rnd, F, depth)
                        _same_bits(pfn(depth, n), jfn(depth, n), what)
                        got = pfn(depth, n, ptree)
                        _same_bits(got, jfn(depth, n, jnp.asarray(jtree)),
                                   what)
                        # nested: only the tree's survivors, never empty
                        assert not bool((got & ~ptree).any())
                        assert bool(got.any(dim=1).all())
    assert port_gbdt._level_mask_fn(port_gbdt.GBDTParam(), 0, 4) is None


@pytest.mark.parametrize("B", [7, 500])
def test_row_sampling_draws_over_unpadded_rows(B):
    jp, pp = _params(seed=3, subsample=0.5, colsample_bytree=0.5)
    for rnd in ROUNDS:
        for class_index in (0, 2):
            jw, jm = jax_gbdt._row_sampling(jp, rnd, B, 512, 28,
                                            class_index=class_index)
            pw, pm = port_gbdt._row_sampling(pp, rnd, B, 512, 28,
                                             class_index=class_index)
            _same_bits(pw, jw, (rnd, class_index))
            _same_bits(pm, jm, (rnd, class_index))
            assert not bool(pw[B:].any())
            assert torch.equal(pw[:B], port_gbdt._tree_sampling(
                pp, rnd, B, 28, class_index=class_index)[0])


def test_rate_is_compared_in_float32(monkeypatch):
    import jax.numpy as jnp

    # 0.7 rounds down in float32: a draw equal to the rounded rate is kept
    # by a float64 compare and dropped by the reference's float32 one
    rate32 = np.float32(0.7)
    assert float(rate32) < 0.7
    assert not bool(jnp.asarray([rate32]) < 0.7)
    monkeypatch.setattr(threefry, "uniform", lambda key, shape, *a, **k:
                        torch.full(shape, float(rate32)))
    w, m = port_gbdt._tree_sampling(
        port_gbdt.GBDTParam(subsample=0.7, colsample_bytree=0.7), 0, 5, 4)
    assert not bool(w.any())
    # only the cheapest (first) column survives
    assert m.tolist() == [True, False, False, False]


# -- entry points ---------------------------------------------------------

N_FEATURE = 6


def _data(n=500, seed=0, objective="logistic"):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, N_FEATURE).astype(np.float32)
    w = rng.randn(N_FEATURE).astype(np.float32)
    score = x @ w + 0.3 * rng.randn(n)
    if objective == "softmax":
        y = np.digitize(score, [-0.5, 0.5]).astype(np.float32)
    else:
        y = (score > 0).astype(np.float32)
    return x, y


def _pair(x, **kw):
    jm = jax_gbdt.GBDT(jax_gbdt.GBDTParam(**kw), N_FEATURE)
    jm.make_bins(x)
    pm = port_gbdt.GBDT(port_gbdt.GBDTParam(**kw), N_FEATURE, device="cpu")
    pm.set_boundaries(jm.boundaries)
    return jm, pm, np.asarray(jm.bin_features(x))


def _assert_same_trees(port_ens, jax_ens, rtol):
    for name in ("split_feat", "default_left"):
        np.testing.assert_array_equal(
            np.asarray(getattr(port_ens, name)),
            np.asarray(getattr(jax_ens, name)), err_msg=name)
    split = np.asarray(jax_ens.split_feat) >= 0
    np.testing.assert_array_equal(np.asarray(port_ens.split_bin)[split],
                                  np.asarray(jax_ens.split_bin)[split],
                                  err_msg="split_bin")
    np.testing.assert_allclose(np.asarray(port_ens.leaf_value),
                               np.asarray(jax_ens.leaf_value), rtol=rtol,
                               atol=rtol, err_msg="leaf_value")


def _kw(objective, method="scatter", rounds=4):
    kw = dict(num_boost_round=rounds, max_depth=3, num_bins=16,
              hist_method=method, seed=11, **ALL_RATES)
    if objective == "softmax":
        kw.update(objective="softmax", num_class=3)
    return kw


@pytest.mark.parametrize("objective", ["logistic", "softmax"])
def test_append_rounds_from_none_is_fit_binned(objective):
    x, y = _data(objective=objective)
    _, pm, bins = _pair(x, **_kw(objective))
    ens, margin = pm.fit_binned(bins, y)
    more, more_margin = pm.append_rounds(None, bins, y, num_rounds=4)
    assert all(torch.equal(a, b) for a, b in zip(ens, more))
    assert torch.equal(margin, more_margin)
    # two calls of two rounds continue the draw sequence
    half, m = pm.append_rounds(None, bins, y, num_rounds=2)
    half, m = pm.append_rounds(half, bins, y, num_rounds=2, margin=m)
    assert all(torch.equal(a, b) for a, b in zip(ens, half))


@pytest.mark.parametrize("method", ["scatter", "pallas"])
def test_append_rounds_start_round_matches_jax(interpret_mode, method):
    x, y = _data(seed=1)
    jm, pm, bins = _pair(x, **_kw("logistic", method, rounds=2))
    rtol = 1e-5 if method == "scatter" else 1e-4
    j_ens, _ = jm.fit_binned(bins, y)
    p_ens, _ = pm.fit_binned(bins, y)
    _assert_same_trees(p_ens, j_ens, rtol)
    j_more, j_margin = jm.append_rounds(j_ens, bins, y, num_rounds=2,
                                        start_round=40)
    p_more, p_margin = pm.append_rounds(p_ens, bins, y, num_rounds=2,
                                        start_round=40)
    _assert_same_trees(p_more, j_more, rtol)
    np.testing.assert_allclose(p_margin.numpy(), np.asarray(j_margin),
                               rtol=rtol, atol=rtol)
    # another start round draws other rows and columns
    other, _ = pm.append_rounds(p_ens, bins, y, num_rounds=2,
                                start_round=41)
    assert not torch.equal(other.leaf_value[2], p_more.leaf_value[2])


@pytest.mark.parametrize("name", sorted(ALL_RATES))
def test_boost_round_needs_round_index_when_sampling(name):
    x, y = _data(n=64)
    _, pm, bins = _pair(x, num_boost_round=2, max_depth=2, num_bins=8,
                        **{name: 0.5})
    with pytest.raises(RuntimeError, match="round_index"):
        pm.boost_round(torch.zeros(64), bins, y, torch.ones(64))
    margin, tree = pm.boost_round(torch.zeros(64), bins, y, torch.ones(64),
                                  round_index=0)
    assert tree[0].shape == (3,)


@pytest.mark.parametrize("objective", ["logistic", "softmax"])
def test_fit_with_eval_sampled_matches_jax(objective):
    x, y = _data(n=900, seed=2, objective=objective)
    kw = _kw(objective, rounds=12)
    kw["learning_rate"] = 0.9
    jm, pm, bins = _pair(x[:600], **kw)
    ev = np.asarray(jm.bin_features(x[600:]))
    args = (bins, y[:600], ev, y[600:])
    j_ens, j_hist = jm.fit_with_eval(*args, early_stopping_rounds=2)
    p_ens, p_hist = pm.fit_with_eval(*args, early_stopping_rounds=2)
    assert len(p_hist) == len(j_hist)
    for p, j in zip(p_hist, j_hist):
        assert p["round"] == j["round"]
        np.testing.assert_allclose(p["eval_loss"], j["eval_loss"], rtol=1e-5)
    _assert_same_trees(p_ens, j_ens, 1e-5)
    # without stopping, the eval-tracked fit is fit_binned to the bit
    full, _ = pm.fit_with_eval(*args)
    ens, _ = pm.fit_binned(bins, y[:600])
    assert all(torch.equal(a, b) for a, b in zip(full, ens))
    curve = pm.staged_losses(full, ev, y[600:])
    np.testing.assert_allclose(
        curve, jm.staged_losses(jm.fit_binned(bins, y[:600])[0], ev,
                                y[600:]), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(ALL_RATES))
def test_regressor_sampled_matches_jax(name):
    rng = np.random.RandomState(3)
    x = rng.randn(700, 5).astype(np.float32)
    y = x[:, 0] * 2 - x[:, 1] + 0.1 * rng.randn(700)
    kw = dict(num_boost_round=5, max_depth=3, num_bins=16, seed=4,
              **{name: 0.6})
    reg = GBDTRegressor(device="cpu", **kw).fit(x, y)
    ref = JaxRegressor(**kw).fit(x, y)
    np.testing.assert_allclose(reg.predict(x), ref.predict(x), rtol=1e-5,
                               atol=1e-5)


def test_classifier_multiclass_sampled_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(800, 4).astype(np.float32)
    y = (x[:, 0] > 0).astype(int) + (x[:, 1] > 0).astype(int)
    kw = dict(num_boost_round=4, max_depth=3, num_bins=16, seed=9,
              **ALL_RATES)
    clf = GBDTClassifier(device="cpu", **kw).fit(x, y)
    ref = JaxClassifier(**kw).fit(x, y)
    np.testing.assert_array_equal(clf.predict(x), ref.predict(x))
    np.testing.assert_allclose(clf.predict_proba(x), ref.predict_proba(x),
                               rtol=1e-5, atol=1e-6)
