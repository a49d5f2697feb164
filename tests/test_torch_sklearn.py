"""PyTorch port vs the JAX package: the sklearn-style estimators.

The cases of ``tests/test_sklearn_api.py`` run on the port's estimators
with ``device="cpu"``; where an answer is numeric, the JAX estimator fits
the same seeded data and the two must agree (probabilities and
regressions to rtol 1e-5, the exact f32 scatter path in both).  Estimator
checkpoints cross over: one package saves, the other loads, and the loaded
estimator predicts what the saver predicts.
"""

import numpy as np
import pytest
import torch

from dmlc_core_tpu.models.sklearn import GBDTClassifier as JaxClassifier
from dmlc_core_tpu.models.sklearn import GBDTRegressor as JaxRegressor
from dmlc_core_tpu_torch.models.sklearn import GBDTClassifier, GBDTRegressor


def _binary(n=3000, F=6, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, F).astype(np.float32)
    w = rng.randn(F)
    y = (x @ w > 0).astype(int)
    return x, y


def _three_class(n=2000, seed=1, labels=("cat", "dog", "fish")):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = np.array(labels)[(x[:, 0] > 0).astype(int)
                         + (x[:, 1] > 0).astype(int)]
    return x, y


def _regression(n=3000, seed=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 5).astype(np.float32)
    y = x[:, 0] * 2 - x[:, 1] + 0.1 * rng.randn(n)
    return x, y


def test_classifier_binary_matches_jax():
    x, y = _binary()
    kw = dict(num_boost_round=10, max_depth=4, num_bins=32,
              learning_rate=0.5)
    clf = GBDTClassifier(device="cpu", **kw).fit(x, y)
    ref = JaxClassifier(**kw).fit(x, y)
    assert clf.score(x, y) > 0.95
    proba = clf.predict_proba(x)
    assert proba.shape == (len(x), 2) and proba.dtype == np.float64
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(proba, ref.predict_proba(x), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(clf.predict(x), ref.predict(x))
    assert set(np.unique(clf.predict(x))) <= {0, 1}


def test_classifier_multiclass_string_labels_matches_jax():
    x, y = _three_class()
    kw = dict(num_boost_round=8, max_depth=4, num_bins=32,
              learning_rate=0.5)
    clf = GBDTClassifier(device="cpu", **kw).fit(x, y)
    ref = JaxClassifier(**kw).fit(x, y)
    assert list(clf.classes_) == ["cat", "dog", "fish"]
    pred = clf.predict(x)
    assert set(pred) <= set(clf.classes_)
    assert (pred == y).mean() > 0.9
    np.testing.assert_array_equal(pred, ref.predict(x))
    proba = clf.predict_proba(x)
    assert proba.shape == (len(x), 3)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(proba, ref.predict_proba(x), rtol=1e-5,
                               atol=1e-6)


def test_regressor_r2_matches_jax():
    x, y = _regression()
    kw = dict(num_boost_round=20, max_depth=4, num_bins=64,
              learning_rate=0.3)
    reg = GBDTRegressor(device="cpu", **kw).fit(x, y)
    ref = JaxRegressor(**kw).fit(x, y)
    assert reg.score(x, y) > 0.8
    np.testing.assert_allclose(reg.predict(x), ref.predict(x), rtol=1e-5,
                               atol=1e-5)
    assert reg.score(x, y) == pytest.approx(ref.score(x, y), rel=1e-6)


def test_nan_autoselects_missing_mode():
    x, y = _binary(seed=3)
    x[::5, 0] = np.nan
    clf = GBDTClassifier(num_boost_round=5, max_depth=3, num_bins=16,
                         device="cpu").fit(x, y)
    assert clf.model_.param.handle_missing is True
    proba = clf.predict_proba(x)
    assert np.isfinite(proba).all()
    ref = JaxClassifier(num_boost_round=5, max_depth=3, num_bins=16)
    np.testing.assert_allclose(proba, ref.fit(x, y).predict_proba(x),
                               rtol=1e-5, atol=1e-6)
    # explicit override wins
    clf2 = GBDTClassifier(num_boost_round=2, max_depth=2, num_bins=16,
                          handle_missing=False, device="cpu")
    clf2.fit(np.nan_to_num(x), y)
    assert clf2.model_.param.handle_missing is False


@pytest.mark.parametrize("spelling", ["pair", "list"])
def test_eval_set_early_stopping_matches_jax(spelling):
    x, y = _binary(n=4000, seed=4)
    kw = dict(num_boost_round=40, max_depth=3, num_bins=32,
              learning_rate=0.8)
    held = (x[3000:], y[3000:])
    eval_set = held if spelling == "pair" else [held]
    clf = GBDTClassifier(device="cpu", **kw)
    clf.fit(x[:3000], y[:3000], eval_set=eval_set, early_stopping_rounds=5)
    ref = JaxClassifier(**kw)
    ref.fit(x[:3000], y[:3000], eval_set=eval_set, early_stopping_rounds=5)
    assert clf.eval_history_ and "eval_loss" in clf.eval_history_[0]
    assert clf.ensemble_.num_trees <= 40
    assert clf.ensemble_.num_trees == ref.ensemble_.num_trees
    assert len(clf.eval_history_) == len(ref.eval_history_)
    for a, b in zip(clf.eval_history_, ref.eval_history_):
        assert sorted(a) == sorted(b)
        np.testing.assert_allclose(a["eval_loss"], b["eval_loss"],
                                   rtol=1e-5)


def test_feature_importances_normalized_and_match_jax():
    x, y = _binary()
    kw = dict(num_boost_round=5, max_depth=3, num_bins=32)
    clf = GBDTClassifier(device="cpu", **kw).fit(x, y)
    imp = clf.feature_importances_
    assert imp.shape == (x.shape[1],)
    assert abs(imp.sum() - 1.0) < 1e-6
    assert (imp >= 0).all()
    np.testing.assert_allclose(
        imp, JaxClassifier(**kw).fit(x, y).feature_importances_, rtol=1e-4)


def test_get_set_params_roundtrip():
    clf = GBDTClassifier(num_boost_round=7, max_depth=5)
    p = clf.get_params()
    assert p["num_boost_round"] == 7 and p["max_depth"] == 5
    assert p["device"] is None
    clf.set_params(max_depth=3, handle_missing=True, device="cpu")
    assert clf.get_params()["max_depth"] == 3
    assert clf.get_params()["handle_missing"] is True
    assert clf.get_params()["device"] == "cpu"
    with pytest.raises(Exception):
        clf.set_params(bogus=1)
    with pytest.raises(Exception):
        GBDTClassifier(bogus=1)
    # every key the JAX estimator reports is reported here
    assert set(JaxClassifier(num_boost_round=7).get_params()) \
        <= set(GBDTClassifier(num_boost_round=7).get_params())


def test_unfitted_raises():
    with pytest.raises(Exception, match="not fitted"):
        GBDTClassifier(device="cpu").predict(np.zeros((2, 2), np.float32))


def test_default_device_needs_a_card():
    x, y = _binary(n=200, seed=20)
    clf = GBDTClassifier(num_boost_round=2, max_depth=2, num_bins=8)
    if torch.cuda.is_available():
        assert clf.fit(x, y).model_.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        clf.fit(x, y)


@pytest.mark.parametrize("name", ["subsample", "colsample_bytree",
                                  "colsample_bylevel", "colsample_bynode"])
def test_sampling_raises_naming_the_roadmap_item(name):
    """Named when these rates raised in the port; now the estimator passes
    each rate through and predicts what the JAX estimator predicts."""
    x, y = _binary(n=200, seed=21)
    kw = dict(num_boost_round=2, max_depth=2, num_bins=8, seed=5,
              **{name: 0.5})
    clf = GBDTClassifier(device="cpu", **kw).fit(x, y)
    ref = JaxClassifier(**kw).fit(x, y)
    assert clf.model_.param.to_dict()[name] == "0.5"
    np.testing.assert_allclose(clf.predict_proba(x), ref.predict_proba(x),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(clf.predict(x), ref.predict(x))


def test_save_model_interops_with_low_level(tmp_path):
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam

    x, y = _binary(seed=5)
    clf = GBDTClassifier(num_boost_round=4, max_depth=3, num_bins=16,
                         device="cpu").fit(x, y)
    uri = str(tmp_path / "m.bin")
    clf.save_model(uri)
    low = GBDT(GBDTParam(num_boost_round=4, max_depth=3, num_bins=16),
               num_feature=x.shape[1], device="cpu")
    ens = low.load_model(uri)
    margin = low.predict_margin(ens, low.bin_features(x)).numpy()
    np.testing.assert_array_equal(margin, clf._margin(x))


def test_eval_set_multiclass_early_stopping():
    rng = np.random.RandomState(7)
    x3 = rng.randn(2000, 3).astype(np.float32)
    y3 = (x3[:, 0] > 0).astype(int) + (x3[:, 1] > 0).astype(int)
    kw = dict(num_boost_round=20, max_depth=3, num_bins=16,
              learning_rate=0.5)
    clf3 = GBDTClassifier(device="cpu", **kw)
    clf3.fit(x3[:1500], y3[:1500], eval_set=(x3[1500:], y3[1500:]),
             early_stopping_rounds=5)
    hist = clf3.eval_history_
    assert hist[-1]["eval_loss"] < hist[0]["eval_loss"]
    assert clf3.score(x3[1500:], y3[1500:]) > 0.9
    ref = JaxClassifier(**kw)
    ref.fit(x3[:1500], y3[:1500], eval_set=(x3[1500:], y3[1500:]),
            early_stopping_rounds=5)
    assert len(ref.eval_history_) == len(hist)
    assert ref.ensemble_.num_trees == clf3.ensemble_.num_trees


def test_unseen_eval_labels_rejected():
    x, y = _binary(n=1000, seed=8)
    clf = GBDTClassifier(num_boost_round=2, max_depth=2, num_bins=8,
                         device="cpu")
    with pytest.raises(Exception, match="not in"):
        clf.fit(x[:800], y[:800], eval_set=(x[800:], np.full(200, 7)))


def test_nan_at_predict_without_missing_support_rejected():
    x, y = _binary(n=1000, seed=9)
    clf = GBDTClassifier(num_boost_round=2, max_depth=2, num_bins=8,
                         device="cpu").fit(x, y)
    x_bad = x.copy()
    x_bad[0, 0] = np.nan
    with pytest.raises(Exception, match="handle_missing"):
        clf.predict(x_bad)


def test_estimator_save_load_roundtrip(tmp_path):
    x, y = _three_class(n=1500, seed=10, labels=("a", "b", "c"))
    clf = GBDTClassifier(num_boost_round=5, max_depth=3, num_bins=16,
                         learning_rate=0.5, device="cpu").fit(x, y)
    uri = str(tmp_path / "clf.bin")
    clf.save_model(uri)
    loaded = GBDTClassifier.load_model(uri, device="cpu")
    assert list(loaded.classes_) == ["a", "b", "c"]
    np.testing.assert_array_equal(loaded.predict(x), clf.predict(x))
    np.testing.assert_array_equal(loaded.predict_proba(x),
                                  clf.predict_proba(x))
    assert loaded.get_params()["max_depth"] == 3

    yr = (x[:, 0] * 2).astype(np.float32)
    reg = GBDTRegressor(num_boost_round=5, max_depth=3, num_bins=16,
                        device="cpu").fit(x, yr)
    uri2 = str(tmp_path / "reg.bin")
    reg.save_model(uri2)
    loaded_reg = GBDTRegressor.load_model(uri2, device="cpu")
    np.testing.assert_array_equal(loaded_reg.predict(x), reg.predict(x))

    # cross-type loads refuse clearly
    with pytest.raises(Exception, match="GBDTClassifier"):
        GBDTRegressor.load_model(uri, device="cpu")
    with pytest.raises(Exception, match="regressor"):
        GBDTClassifier.load_model(uri2, device="cpu")
    # low-level checkpoints are not estimator checkpoints
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam

    low = GBDT(GBDTParam(num_boost_round=2, max_depth=2, num_bins=8),
               num_feature=4, device="cpu")
    low.make_bins(x)
    ens, _ = low.fit_binned(low.bin_features(x), (yr > 0).astype(np.float32))
    uri3 = str(tmp_path / "low.bin")
    low.save_model(uri3, ens)
    with pytest.raises(Exception, match="sk_param"):
        GBDTClassifier.load_model(uri3, device="cpu")


def test_nan_missing_mode_survives_save_load(tmp_path):
    x, y = _binary(n=1200, seed=11)
    x[::4, 1] = np.nan
    clf = GBDTClassifier(num_boost_round=4, max_depth=3, num_bins=16,
                         device="cpu").fit(x, y)
    assert clf.model_.param.handle_missing
    uri = str(tmp_path / "m.bin")
    clf.save_model(uri)
    loaded = GBDTClassifier.load_model(uri, device="cpu")
    assert loaded.model_.param.handle_missing
    np.testing.assert_array_equal(loaded.predict(x), clf.predict(x))


def test_object_dtype_classes_rejected_at_save(tmp_path):
    x, y = _binary(n=400, seed=12)
    y_obj = np.array(["n", "p"], dtype=object)[y]     # pandas-style labels
    clf = GBDTClassifier(num_boost_round=2, max_depth=2, num_bins=8,
                         device="cpu").fit(x, y_obj)
    with pytest.raises(Exception, match="object dtype"):
        clf.save_model(str(tmp_path / "bad.bin"))


def test_multiple_eval_sets():
    x, y = _binary(n=3000, seed=14)
    kw = dict(num_boost_round=6, max_depth=3, num_bins=16,
              learning_rate=0.5)
    sets = [(x[2000:2500], y[2000:2500]), (x[2500:], y[2500:])]
    clf = GBDTClassifier(device="cpu", **kw)
    clf.fit(x[:2000], y[:2000], eval_set=sets, early_stopping_rounds=3)
    hist = clf.eval_history_
    assert "eval_loss" in hist[0]        # the LAST set (drives stopping)
    assert "eval0_loss" in hist[0]       # the first set's curve
    kept = clf.ensemble_.num_trees       # entries past truncation carry
    last = hist[kept - 1]                # only the primary eval_loss
    assert last["eval0_loss"] < hist[0]["eval0_loss"]
    ref = JaxClassifier(**kw)
    ref.fit(x[:2000], y[:2000], eval_set=sets, early_stopping_rounds=3)
    assert [sorted(h) for h in hist] == [sorted(h) for h in
                                         ref.eval_history_]
    for a, b in zip(hist, ref.eval_history_):
        for key in a:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5)
    # list-of-rows X in a bare pair must not be misread as a pair list
    clf2 = GBDTClassifier(num_boost_round=3, max_depth=2, num_bins=8,
                          device="cpu")
    clf2.fit(x[:500], y[:500],
             eval_set=(x[500:700].tolist(), y[500:700].tolist()))
    assert "eval_loss" in clf2.eval_history_[0]


def test_multi_eval_sets_share_metric():
    x, y = _binary(n=2400, seed=15)
    clf = GBDTClassifier(num_boost_round=5, max_depth=3, num_bins=16,
                         learning_rate=0.5, device="cpu")
    clf.fit(x[:1600], y[:1600],
            eval_set=[(x[1600:2000], y[1600:2000]), (x[2000:], y[2000:])],
            eval_metric="error")
    h = clf.eval_history_[-1]
    # both curves are ERROR RATES (comparable), not logloss vs error
    assert 0.0 <= h["eval_loss"] <= 1.0
    assert 0.0 <= h["eval0_loss"] <= 1.0


# -- estimator checkpoints cross between the packages ------------------------
def _fit_case(case, jax_side):
    kw = dict(num_boost_round=5, max_depth=3, num_bins=16,
              learning_rate=0.5)
    if case == "binary":
        x, y = _binary(n=1500, seed=16)
        cls = JaxClassifier if jax_side else GBDTClassifier
    elif case == "multiclass":
        x, y = _three_class(n=1500, seed=17)
        cls = JaxClassifier if jax_side else GBDTClassifier
    elif case == "missing":
        x, y = _binary(n=1500, seed=18)
        x[::3, 2] = np.nan
        cls = JaxClassifier if jax_side else GBDTClassifier
    else:
        x, y = _regression(n=1500, seed=19)
        cls = JaxRegressor if jax_side else GBDTRegressor
    if not jax_side:
        kw["device"] = "cpu"
    return cls(**kw).fit(x, y), x


def _outputs(est, x):
    if hasattr(est, "predict_proba"):
        return np.asarray(est.predict(x)), np.asarray(est.predict_proba(x))
    return (np.asarray(est.predict(x)),)


CROSS = ["binary", "multiclass", "missing", "regression"]


@pytest.mark.parametrize("case", CROSS)
def test_port_estimator_loads_in_jax(tmp_path, case):
    est, x = _fit_case(case, jax_side=False)
    uri = str(tmp_path / "port.bin")
    est.save_model(uri)
    cls = JaxRegressor if case == "regression" else JaxClassifier
    loaded = cls.load_model(uri)
    assert loaded.get_params()["max_depth"] == 3
    for got, want in zip(_outputs(loaded, x), _outputs(est, x)):
        if got.dtype.kind in "fc":
            # one ulp of exp/softmax between the frameworks
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-7)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CROSS)
def test_jax_estimator_loads_in_port(tmp_path, case):
    est, x = _fit_case(case, jax_side=True)
    uri = str(tmp_path / "jax.bin")
    est.save_model(uri)
    cls = GBDTRegressor if case == "regression" else GBDTClassifier
    loaded = cls.load_model(uri, device="cpu")
    assert loaded.model_.device.type == "cpu"
    assert loaded.model_.param.to_dict() == {
        k: v for k, v in est.model_.param.to_dict().items()}
    for got, want in zip(_outputs(loaded, x), _outputs(est, x)):
        if got.dtype.kind in "fc":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-7)
        else:
            np.testing.assert_array_equal(got, want)
