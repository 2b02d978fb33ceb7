"""Mesh-based background estimation (SExtractor / sep style).

Replaces the reference's `sep.Background` usage (sfft/AutoCrowdedPrep.py:55-56,
sfft/utils/SExSkySubtract.py) and SExtractor's internal background for the
fallback extractor: the image is tiled into BACK_SIZE cells; each cell gets a
sigma-clipped mode estimate (SExtractor's 2.5*median - 1.5*mean rule) and rms;
the meshes are median-filtered (BACK_FILTERSIZE) and bilinearly interpolated
back to full resolution.

A copy of sfft_tpu/prep/background.py (numpy, on the host).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import ndimage as ndi


def _cell_stats(vals: np.ndarray) -> Tuple[float, float]:
    v = vals[np.isfinite(vals)]
    if v.size < 10:
        return (np.median(v) if v.size else 0.0), (np.std(v) if v.size else 0.0)
    for _ in range(10):
        med = np.median(v)
        sig = np.std(v)
        keep = np.abs(v - med) < 3.0 * sig
        if keep.all() or keep.sum() < 10:
            break
        v = v[keep]
    mean, med, sig = np.mean(v), np.median(v), np.std(v)
    if sig == 0:
        return med, sig
    if abs(mean - med) / sig > 0.3:
        mode = med
    else:
        mode = 2.5 * med - 1.5 * mean
    return mode, sig


class Background:
    """sep.Background-compatible interface: .back(), .rms(), .globalback,
    .globalrms, .subfrom(arr)."""

    def __init__(
        self,
        data: np.ndarray,
        mask: Optional[np.ndarray] = None,
        bw: int = 64,
        bh: int = 64,
        fw: int = 3,
        fh: int = 3,
    ):
        data = np.asarray(data, dtype=np.float64)
        if mask is not None:
            data = np.where(mask, np.nan, data)
        N0, N1 = data.shape
        nbx = max(1, -(-N0 // bw))
        nby = max(1, -(-N1 // bh))
        back_mesh = np.zeros((nbx, nby))
        rms_mesh = np.zeros((nbx, nby))
        for i in range(nbx):
            for j in range(nby):
                cell = data[i * bw : (i + 1) * bw, j * bh : (j + 1) * bh]
                back_mesh[i, j], rms_mesh[i, j] = _cell_stats(cell)
        if fw > 1 or fh > 1:
            back_mesh = ndi.median_filter(back_mesh, size=(fw, fh), mode="nearest")
            rms_mesh = ndi.median_filter(rms_mesh, size=(fw, fh), mode="nearest")
        self._back_mesh = back_mesh
        self._rms_mesh = rms_mesh
        self._shape = (N0, N1)
        self._bw, self._bh = bw, bh
        self.globalback = float(np.median(back_mesh))
        self.globalrms = float(np.median(rms_mesh))

    def _interp(self, mesh: np.ndarray) -> np.ndarray:
        N0, N1 = self._shape
        nbx, nby = mesh.shape
        # cell centers in pixel coords
        cx = (np.arange(nbx) + 0.5) * self._bw
        cy = (np.arange(nby) + 0.5) * self._bh
        x = np.arange(N0) + 0.5
        y = np.arange(N1) + 0.5
        ix = np.clip(np.searchsorted(cx, x) - 1, 0, max(nbx - 2, 0))
        iy = np.clip(np.searchsorted(cy, y) - 1, 0, max(nby - 2, 0))
        if nbx == 1:
            wx = np.zeros(N0)
            ix = np.zeros(N0, int)
            ix1 = ix
        else:
            # unclamped: linear extrapolation into the outer half-cell bands
            wx = (x - cx[ix]) / (cx[ix + 1] - cx[ix])
            ix1 = ix + 1
        if nby == 1:
            wy = np.zeros(N1)
            iy = np.zeros(N1, int)
            iy1 = iy
        else:
            wy = (y - cy[iy]) / (cy[iy + 1] - cy[iy])
            iy1 = iy + 1
        m00 = mesh[np.ix_(ix, iy)]
        m10 = mesh[np.ix_(ix1, iy)]
        m01 = mesh[np.ix_(ix, iy1)]
        m11 = mesh[np.ix_(ix1, iy1)]
        wxg = wx[:, None]
        wyg = wy[None, :]
        return ((1 - wxg) * (1 - wyg) * m00 + wxg * (1 - wyg) * m10
                + (1 - wxg) * wyg * m01 + wxg * wyg * m11)

    def back(self) -> np.ndarray:
        return self._interp(self._back_mesh)

    def rms(self) -> np.ndarray:
        return self._interp(self._rms_mesh)

    def subfrom(self, arr: np.ndarray) -> np.ndarray:
        arr -= self.back()
        return arr
