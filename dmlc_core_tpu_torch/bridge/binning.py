"""Host-side quantile binning to the narrow wire dtype.

Counterpart of ``dmlc_core_tpu/bridge/binning.py`` (``wire_dtype`` and
``HostBinner``).  The edges are applied with numpy ``searchsorted(side=
"right")`` exactly as :func:`..ops.histogram.apply_bins` does on the
device, so the uint8 ids shipped to the card are byte-identical to the
JAX package's and to on-device binning.
"""

from __future__ import annotations

import numpy as np

from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["HostBinner", "wire_dtype"]


def wire_dtype(num_bins: int) -> np.dtype:
    """The narrowest unsigned dtype that holds ``num_bins`` bin ids."""
    CHECK(num_bins >= 2, f"num_bins must be >= 2, got {num_bins}")
    if num_bins <= 256:
        return np.dtype(np.uint8)
    if num_bins <= 65536:
        return np.dtype(np.uint16)
    return np.dtype(np.int32)


class HostBinner:
    """Apply fixed quantile edges on the host; emit wire-dtype bin ids.

    ``boundaries`` is ``[F, eff_bins - 1]`` float32, where ``eff_bins =
    num_bins - 1`` when ``handle_missing`` reserves the last id for NaNs,
    else ``num_bins``.
    """

    def __init__(self, boundaries: np.ndarray, num_bins: int,
                 handle_missing: bool = False):
        boundaries = np.asarray(boundaries, dtype=np.float32)
        CHECK(boundaries.ndim == 2,
              f"boundaries must be [F, bins-1], got {boundaries.shape}")
        eff = num_bins - 1 if handle_missing else num_bins
        CHECK(boundaries.shape[1] == eff - 1,
              f"boundaries have {boundaries.shape[1] + 1} bins; expected "
              f"{eff} (num_bins={num_bins}, handle_missing={handle_missing})")
        self.boundaries = boundaries
        self.num_bins = num_bins
        self.handle_missing = handle_missing
        self.dtype = wire_dtype(num_bins)

    @property
    def num_feature(self) -> int:
        return self.boundaries.shape[0]

    def transform(self, x: np.ndarray) -> np.ndarray:
        """Bin ``x [B, F]`` float -> ``[B, F]`` wire-dtype ids.  NaNs take
        the reserved missing id under ``handle_missing``, else land in the
        last bin (NaN compares false against every edge)."""
        x = np.asarray(x)
        CHECK(x.ndim == 2 and x.shape[1] == self.num_feature,
              f"x must be [B, {self.num_feature}], got {x.shape}")
        x32 = np.ascontiguousarray(x, dtype=np.float32)
        out = np.empty(x32.shape, dtype=self.dtype)
        for f in range(self.num_feature):
            out[:, f] = np.searchsorted(self.boundaries[f], x32[:, f],
                                        side="right")
        if self.handle_missing:
            out[np.isnan(x32)] = self.num_bins - 1
        return out
