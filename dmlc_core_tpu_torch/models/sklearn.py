"""Sklearn-style estimator facade over the port's hist GBDT.

Counterpart of ``dmlc_core_tpu/models/sklearn.py``: ``XGBClassifier``-
shaped ``fit(X, y)`` / ``predict`` / ``predict_proba`` / ``score`` with
``get_params``/``set_params`` (duck-typed, no sklearn dependency), wrapping
:class:`..models.gbdt.GBDT`.  Labels are encoded and decoded
automatically, NaNs in ``X`` switch on sparsity-aware splits unless
overridden, and ``eval_set``/``early_stopping_rounds`` ride
:meth:`GBDT.fit_with_eval`.

``device`` is where the estimator trains and scores: ``cuda`` unless the
caller passes ``device="cpu"``.  ``save_model`` writes the reference's
payload with its ``sk_param`` and ``sk_classes`` leaves, so an estimator
saved by either package loads in the other's.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np

from dmlc_core_tpu_torch.bridge.checkpoint import load_checkpoint
from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["GBDTClassifier", "GBDTRegressor"]

# GBDTParam fields settable through the estimator constructor
_PARAM_KEYS = ("num_boost_round", "max_depth", "num_bins", "learning_rate",
               "reg_lambda", "reg_alpha", "min_child_weight",
               "min_split_loss", "subsample", "colsample_bytree",
               "colsample_bylevel", "colsample_bynode", "max_delta_step",
               "scale_pos_weight", "seed", "base_score",
               "monotone_constraints", "hist_method")
# estimator attributes that are not GBDTParam fields
_OWN_KEYS = ("handle_missing", "bin_sample_rows", "importance_type",
             "device")


def _host(a) -> np.ndarray:
    """A tensor or array as a host numpy array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") \
        else np.asarray(a)


class _GBDTEstimator:
    """Shared fit/predict plumbing; subclasses fix the objective."""

    def __init__(self, handle_missing: Optional[bool] = None,
                 bin_sample_rows: int = 100_000,
                 importance_type: str = "gain", device=None, **params):
        for k in params:
            CHECK(k in _PARAM_KEYS,
                  f"unknown parameter {k!r}; settable: {_PARAM_KEYS}")
        self._params: Dict[str, Any] = dict(params)
        self.handle_missing = handle_missing   # None = auto (NaN in X)
        self.bin_sample_rows = bin_sample_rows
        self.importance_type = importance_type
        self.device = device                   # None = cuda

    # -- sklearn protocol ----------------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        out = dict(self._params)
        for k in _OWN_KEYS:
            out[k] = getattr(self, k)
        return out

    def set_params(self, **params):
        for k, v in params.items():
            if k in _OWN_KEYS:
                setattr(self, k, v)
            else:
                CHECK(k in _PARAM_KEYS, f"unknown parameter {k!r}")
                self._params[k] = v
        return self

    # -- internals -----------------------------------------------------------
    def _objective_params(self, y: np.ndarray) -> Dict[str, Any]:
        raise NotImplementedError

    def _encode(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y, np.float32)

    def _make_model(self, X: np.ndarray, y: np.ndarray) -> GBDT:
        missing = self.handle_missing
        if missing is None:
            missing = bool(np.isnan(X).any())
        param = GBDTParam(handle_missing=missing,
                          **self._params, **self._objective_params(y))
        return GBDT(param, num_feature=X.shape[1], device=self.device)

    def fit(self, X, y, sample_weight=None, eval_set=None,
            early_stopping_rounds: int = 0, eval_metric: str = "loss",
            comm=None):
        """Train; ``eval_set=(X_val, y_val)`` (or XGBoost-style
        ``[(X_val, y_val)]``) enables loss tracking and, with
        ``early_stopping_rounds``, best-round truncation.  ``comm``
        (rabit-shaped) merges bin boundaries across data-parallel workers.
        """
        X = np.asarray(X, np.float32)
        y = np.asarray(y)
        CHECK(X.ndim == 2 and len(X) == len(y),
              f"X [{X.shape}] / y [{y.shape}] shape mismatch")
        self.model_ = self._make_model(X, y)
        self.model_.make_bins(X[: self.bin_sample_rows], comm=comm,
                              count=len(X))
        bins = self.model_.bin_features(X)
        yy = self._encode(y)
        if eval_set is not None:
            # accept bare (X, y) or the XGBoost spelling [(X0, y0), ...];
            # like XGBoost, the LAST set drives early stopping.  A bare
            # pair is recognised by its first element being a 2-D feature
            # matrix (list-of-rows X included); anything else is treated
            # as a list of pairs.
            def _is_pair(es):
                if not isinstance(es, (list, tuple)) or len(es) != 2:
                    return False
                try:
                    return np.asarray(es[0], np.float32).ndim == 2
                except Exception:
                    return False

            sets = [eval_set] if _is_pair(eval_set) else list(eval_set)
            CHECK(sets and all(_is_pair(sv) for sv in sets),
                  "eval_set must be (X_val, y_val) or a list of such pairs")
            binned = [(self.model_.bin_features(np.asarray(Xv, np.float32)),
                       self._encode(np.asarray(yv))) for Xv, yv in sets]
            ev_bins, ev_y = binned[-1]
            self.ensemble_, self.eval_history_ = self.model_.fit_with_eval(
                bins, yy, ev_bins, ev_y, weight=sample_weight,
                early_stopping_rounds=early_stopping_rounds,
                eval_metric=eval_metric)
            # per-round curves for the remaining sets, post hoc, from the
            # FINAL (possibly truncated) ensemble: history entries past
            # the kept rounds carry only the primary set's eval_loss
            for i, (bv, lv) in enumerate(binned[:-1]):
                # same metric as the primary set: the curves must be
                # comparable within one history dict
                curve = self.model_.staged_losses(self.ensemble_, bv, lv,
                                                  metric=eval_metric)
                for r, entry in enumerate(self.eval_history_):
                    if r < len(curve):
                        entry[f"eval{i}_loss"] = float(curve[r])
        else:
            self.ensemble_, _ = self.model_.fit_binned(bins, yy,
                                                       weight=sample_weight)
            self.eval_history_ = []
        return self

    def _check_fitted(self):
        CHECK(getattr(self, "model_", None) is not None,
              "estimator is not fitted; call fit(X, y) first")

    def _bins_for_predict(self, X):
        self._check_fitted()
        X = np.asarray(X, np.float32)
        CHECK(self.model_.param.handle_missing or not np.isnan(X).any(),
              "X contains NaN but the model was trained without missing "
              "support (no NaN seen at fit time); refit with "
              "handle_missing=True")
        return self.model_.bin_features(X)

    def _margin(self, X):
        return _host(self.model_.predict_margin(self.ensemble_,
                                                self._bins_for_predict(X)))

    @property
    def feature_importances_(self) -> np.ndarray:
        """Normalized importances of the estimator's ``importance_type``
        (default ``'gain'``, the XGBoost sklearn wrapper's; any
        :meth:`GBDT.feature_importance` kind is accepted)."""
        self._check_fitted()
        imp = self.model_.feature_importance(self.ensemble_,
                                             self.importance_type)
        total = imp.sum()
        return imp / total if total > 0 else imp

    def _extra_payload(self) -> Dict[str, Any]:
        # enough to reconstruct the estimator: the full GBDTParam as JSON
        # bytes (uint8 leaf) + subclass extras
        blob = json.dumps(self.model_.param.to_dict()).encode()
        return {"sk_param": np.frombuffer(blob, np.uint8)}

    def save_model(self, uri: str) -> None:
        """Persist model + boundaries + estimator metadata; reload with
        ``GBDTClassifier.load_model(uri)`` / ``GBDTRegressor.load_model``."""
        self._check_fitted()
        self.model_.save_model(uri, self.ensemble_,
                               extra=self._extra_payload())

    @classmethod
    def load_model(cls, uri: str, device=None):
        """Reconstruct a fitted estimator on ``device`` (``cuda`` unless
        ``device="cpu"``) from :meth:`save_model` output of either
        package."""
        flat = load_checkpoint(uri)
        key = "['sk_param']"
        CHECK(key in flat,
              f"{uri!r} was not written by an estimator's save_model "
              f"(no sk_param); load it with GBDT.load_model instead")
        pdict = json.loads(bytes(np.asarray(flat[key])).decode())
        param = GBDTParam(**pdict)
        est = cls(handle_missing=param.handle_missing, device=device,
                  **{k: getattr(param, k) for k in _PARAM_KEYS})
        est._restore(param, flat)
        boundaries = np.asarray(flat["['boundaries']"], np.float32)
        model = GBDT(param, num_feature=boundaries.shape[0], device=device)
        est.model_ = model
        # restore from the dict already in hand: a second fetch of the URI
        # could mix metadata and ensemble across a concurrent replace
        est.ensemble_ = model.load_model_dict(flat)
        est.eval_history_ = []
        return est

    def _restore(self, param: GBDTParam, flat: Dict[str, Any]) -> None:
        """Subclass hook for estimator-specific payload (class labels)."""


class GBDTClassifier(_GBDTEstimator):
    """Binary or multiclass classifier (objective auto-selected from y)."""

    def _extra_payload(self) -> Dict[str, Any]:
        out = super()._extra_payload()
        out["sk_classes"] = np.asarray(self.classes_)
        return out

    def _objective_params(self, y: np.ndarray) -> Dict[str, Any]:
        self.classes_ = np.unique(y)
        CHECK(len(self.classes_) >= 2,
              f"need >= 2 classes, got {self.classes_!r}")
        if len(self.classes_) == 2:
            return {"objective": "logistic"}
        return {"objective": "softmax", "num_class": len(self.classes_)}

    def _restore(self, param: GBDTParam, flat: Dict[str, Any]) -> None:
        key = "['sk_classes']"
        CHECK(key in flat,
              "checkpoint has no class labels; it was saved by a regressor "
              "— load it with GBDTRegressor.load_model")
        self.classes_ = np.asarray(flat[key])

    def _encode(self, y: np.ndarray) -> np.ndarray:
        # map original labels to 0..K-1 ids; labels unseen at fit time must
        # error, not silently take an arbitrary insertion index
        unseen = ~np.isin(y, self.classes_)
        CHECK(not unseen.any(),
              f"labels {np.unique(np.asarray(y)[unseen])!r} were not in "
              f"the training classes {self.classes_!r}")
        return np.searchsorted(self.classes_, y).astype(np.float32)

    def predict(self, X) -> np.ndarray:
        bins = self._bins_for_predict(X)       # validates fitted state first
        ids = _host(self.model_.predict_class(self.ensemble_, bins))
        return self.classes_[ids]

    def predict_proba(self, X) -> np.ndarray:
        bins = self._bins_for_predict(X)
        proba = _host(self.model_.predict(self.ensemble_, bins)).astype(
            np.float64)
        if proba.ndim == 2:                    # softmax [B, K]
            return proba
        return np.stack([1.0 - proba, proba], axis=1)   # logistic

    def score(self, X, y) -> float:
        """Mean accuracy."""
        return float((self.predict(X) == np.asarray(y)).mean())


class GBDTRegressor(_GBDTEstimator):
    """Squared-error regressor."""

    def _restore(self, param: GBDTParam, flat: Dict[str, Any]) -> None:
        CHECK(param.objective == "squared",
              f"checkpoint objective is {param.objective!r}; load it with "
              f"GBDTClassifier.load_model")

    def _objective_params(self, y: np.ndarray) -> Dict[str, Any]:
        return {"objective": "squared"}

    def predict(self, X) -> np.ndarray:
        return self._margin(X)

    def score(self, X, y) -> float:
        """R^2 (coefficient of determination), the sklearn convention."""
        y = np.asarray(y, np.float64)
        pred = np.asarray(self.predict(X), np.float64)
        ss_res = float(((y - pred) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum())
        return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
