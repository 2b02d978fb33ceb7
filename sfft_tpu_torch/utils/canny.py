"""Canny edge detector.

Reference vendors a CellProfiler/skimage canny (sfft/utils/cannyEdge/) used as
an optional way to make the mask for Hough detection. Standard algorithm: Gaussian
smoothing (with edge-effect normalization), Sobel gradients, bilinear-
interpolated non-maximum suppression, double-threshold hysteresis.

A copy of sfft_tpu/utils/canny.py (numpy, on the host).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import ndimage as ndi


def canny(
    image: np.ndarray,
    sigma: float = 1.0,
    low_threshold: Optional[float] = None,
    high_threshold: Optional[float] = None,
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    image = np.asarray(image, dtype=np.float64)
    if mask is None:
        mask = np.ones(image.shape, dtype=bool)

    # smooth with edge normalization: smooth(img * mask) / smooth(mask)
    fmask = mask.astype(np.float64)
    smoothed = ndi.gaussian_filter(image * fmask, sigma, mode="constant")
    norm = ndi.gaussian_filter(fmask, sigma, mode="constant")
    with np.errstate(invalid="ignore", divide="ignore"):
        smoothed = np.where(norm > 0, smoothed / norm, 0.0)

    jsobel = ndi.sobel(smoothed, axis=1)
    isobel = ndi.sobel(smoothed, axis=0)
    magnitude = np.hypot(isobel, jsobel)

    # erode the mask so border pixels never become edges
    s = np.ones((3, 3), bool)
    emask = ndi.binary_erosion(mask, structure=s, border_value=0)

    abs_i = np.abs(isobel)
    abs_j = np.abs(jsobel)
    eroded = emask & (magnitude > 0)

    # non-maximum suppression via bilinear interpolation along gradient
    local_maxima = np.zeros(image.shape, bool)

    def shift(arr, di, dj):
        out = np.zeros_like(arr)
        src_i = slice(max(0, -di), arr.shape[0] - max(0, di))
        src_j = slice(max(0, -dj), arr.shape[1] - max(0, dj))
        dst_i = slice(max(0, di), arr.shape[0] - max(0, -di))
        dst_j = slice(max(0, dj), arr.shape[1] - max(0, -dj))
        out[dst_i, dst_j] = arr[src_i, src_j]
        return out

    same_sign = (isobel * jsobel) >= 0
    for horiz_dom, sign_sel, (d1, d2) in [
        (True, True, ((0, 1), (1, 1))),    # |j|>=|i|, same sign: E and SE
        (True, False, ((0, 1), (-1, 1))),  # opposite: E and NE
        (False, True, ((1, 0), (1, 1))),   # |i|>|j|, same sign: S and SE
        (False, False, ((1, 0), (1, -1))),
    ]:
        if horiz_dom:
            sel = eroded & (abs_j >= abs_i) & (same_sign == sign_sel)
            w = np.divide(abs_i, abs_j, out=np.zeros_like(abs_i), where=abs_j > 0)
        else:
            sel = eroded & (abs_i > abs_j) & (same_sign == sign_sel)
            w = np.divide(abs_j, abs_i, out=np.zeros_like(abs_j), where=abs_i > 0)
        for sgn in (+1, -1):
            n1 = shift(magnitude, sgn * d1[0], sgn * d1[1])
            n2 = shift(magnitude, sgn * d2[0], sgn * d2[1])
            neigh = n1 * (1 - w) + n2 * w
            if sgn == +1:
                c_plus = magnitude >= neigh
            else:
                c_minus = magnitude >= neigh
        local_maxima |= sel & c_plus & c_minus

    if low_threshold is None or high_threshold is None:
        # skimage-style default: percentiles of the magnitude
        high_threshold = np.percentile(magnitude[emask], 90) if emask.any() else 0.0
        low_threshold = 0.55 * high_threshold

    high_mask = local_maxima & (magnitude >= high_threshold)
    low_mask = local_maxima & (magnitude >= low_threshold)

    # hysteresis: keep low-mask components touching a high-mask pixel
    labels, n = ndi.label(low_mask, structure=s)
    if n == 0:
        return np.zeros(image.shape, bool)
    keep = np.unique(labels[high_mask])
    keep = keep[keep > 0]
    out = np.isin(labels, keep)
    return out
