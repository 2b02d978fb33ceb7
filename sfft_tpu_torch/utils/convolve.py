"""2D convolution utilities with astronomy-standard boundary semantics
(counterpart of sfft_tpu/utils/convolve.py).

Equivalent of the astropy.convolution.convolve usage throughout the reference
(e.g. test/difference_noise_decorrelation/decorr.py, BSpline_GridConvolve):
direct convolution with 'extend' / 'fill' / 'wrap' boundaries, optional
kernel normalization and NaN interpolation. The convolutions run in the
hand-written K9 kernel (core/fdiff.conv_direct, csrc/conv_direct.cu) on the
card, on a plane padded by torch for 'extend' / 'fill' and with the wrap in
the kernel's own indices for 'wrap'; on CPU tensors its plain twin (one
F.conv2d) runs. use_jax=False keeps sfft_tpu's numpy loop.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sfft_tpu_torch.core import fdiff


def _pad(arr: np.ndarray, w0: int, w1: int, boundary: str, fill_value: float):
    if boundary == "extend":
        return np.pad(arr, ((w0, w0), (w1, w1)), mode="edge")
    if boundary == "fill":
        return np.pad(arr, ((w0, w0), (w1, w1)), mode="constant", constant_values=fill_value)
    if boundary == "wrap":
        return np.pad(arr, ((w0, w0), (w1, w1)), mode="wrap")
    raise ValueError(boundary)


def _conv_numpy(x: np.ndarray, k: np.ndarray, boundary: str, fill_value: float) -> np.ndarray:
    """sfft_tpu's numpy loop (small images)."""
    L0, L1 = k.shape
    xp = _pad(x, L0 // 2, L1 // 2, boundary, fill_value)
    out = np.zeros_like(x)
    for a in range(L0):
        for b in range(L1):
            out += k[a, b] * xp[L0 - 1 - a : L0 - 1 - a + x.shape[0],
                                L1 - 1 - b : L1 - 1 - b + x.shape[1]]
    return out


def _taps(k: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(k, dtype=np.float64), device=device)[None]


def _fill_terms(k: np.ndarray, shape, fill: float, device) -> torch.Tensor:
    """sum k[a, b] * fill over the taps whose window position lies in the
    padding, for a non-finite fill, as a direct convolution of the padded
    plane gives it: NaN where a NaN fill, a zero tap under an infinite one
    or taps of both signs reach the padding, +-inf where the taps there
    have one sign, 0 where the window stays inside. Which taps reach it:
    K9 on the padding's indicator, once per tap sign (integer counts,
    exact)."""
    H, W = shape
    L0, L1 = k.shape
    edge = torch.ones((1, H + L0 - 1, W + L1 - 1), dtype=torch.float64, device=device)
    edge[:, L0 // 2:L0 // 2 + H, L1 // 2:L1 // 2 + W] = 0.0

    def reach(sel):
        return fdiff.conv_direct(edge, _taps(sel, device), wrap=False) > 0

    pos, neg, zero = reach(k > 0), reach(k < 0), reach(~((k > 0) | (k < 0)))
    terms = torch.where(pos, fill, 0.0) + torch.where(neg, -fill, 0.0)
    return terms + torch.where(zero, torch.nan, 0.0)


def _conv_device(x: torch.Tensor, k: np.ndarray, boundary: str, fill_value: float):
    """One plane through K9 (its twin on the CPU). K9 takes finite planes
    only, so a non-finite fill pads with zeros and its terms are added
    after (``_fill_terms``)."""
    L0, L1 = k.shape
    w0, w1 = L0 // 2, L1 // 2
    taps = _taps(k, x.device)
    if boundary == "wrap":
        return fdiff.conv_direct(x[None], taps, wrap=True)
    if boundary == "extend":
        xp = F.pad(x[None, None], (w1, w1, w0, w0), mode="replicate")[0]
    elif boundary == "fill":
        fill = float(fill_value)
        if not np.isfinite(fill):
            xp = F.pad(x[None], (w1, w1, w0, w0), mode="constant", value=0.0)
            return (fdiff.conv_direct(xp, taps, wrap=False)
                    + _fill_terms(k, x.shape, fill, x.device))
        xp = F.pad(x[None], (w1, w1, w0, w0), mode="constant", value=fill)
    else:
        raise ValueError(boundary)
    return fdiff.conv_direct(xp, taps, wrap=False)


def convolve2d(
    image,
    kernel,
    boundary: str = "extend",
    fill_value: float = 0.0,
    normalize_kernel: bool = False,
    nan_treatment: str = "interpolate",
    use_jax: bool = True,
    device=None,
):
    """astropy-convolve-compatible direct convolution.

    out[x, y] = sum_ab k[a, b] * in[x - (a - w0), y - (b - w1)]  — i.e. the
    kernel is centered and *convolved* (flipped), matching astropy. NaNs in the
    input are replaced by the kernel-weighted average of their neighborhood
    ('interpolate', astropy's default) or by zero ('fill').

    Numpy in, numpy out (float64); a tensor image gives a tensor on its
    device. use_jax (sfft_tpu's name) picks the device route: K9 on
    `device` (the card when None; device="cpu" runs K9's twin); False runs
    sfft_tpu's numpy loop on the host.
    """
    as_tensor = isinstance(image, torch.Tensor)
    if isinstance(kernel, torch.Tensor):
        kernel = kernel.detach().cpu().numpy()
    kernel = np.asarray(kernel, dtype=np.float64)
    L0, L1 = kernel.shape
    assert L0 % 2 == 1 and L1 % 2 == 1
    w0, w1 = L0 // 2, L1 // 2

    ksum = kernel.sum()
    kwork = kernel / ksum if normalize_kernel else kernel
    # the validity mask convolves with the normalized kernel, zero-filled
    kmask = kwork / kwork.sum() if abs(kwork.sum()) > 0 else kwork

    if not use_jax:
        img = image.detach().cpu().numpy() if as_tensor else image
        img = np.asarray(img, dtype=np.float64)
        nanmask = ~np.isfinite(img)
        any_nan = bool(nanmask.any())
        x = np.where(nanmask, 0.0, img) if any_nan else img
        if any_nan and nan_treatment == "interpolate":
            num = _conv_numpy(x, kwork, boundary, fill_value)
            den = _conv_numpy((~nanmask).astype(np.float64), kmask, boundary, 0.0)
            with np.errstate(invalid="ignore", divide="ignore"):
                out = num / den
            if not normalize_kernel:
                out = out * ksum if abs(ksum) > 0 else out
            out = np.where(den > 0, out, np.nan)
        else:
            out = _conv_numpy(x, kwork, boundary, fill_value)
        return torch.as_tensor(out, device=image.device) if as_tensor else out

    from sfft_tpu_torch.post.fftkits import as_f64

    img = as_f64(image, device)
    nanmask = ~torch.isfinite(img)
    any_nan = bool(nanmask.any())
    x = torch.where(nanmask, 0.0, img) if any_nan else img
    if any_nan and nan_treatment == "interpolate":
        # astropy-style: convolve data*mask and mask, divide
        num = _conv_device(x, kwork, boundary, fill_value)
        den = _conv_device((~nanmask).to(torch.float64), kmask, boundary, 0.0)
        out = num / den
        if not normalize_kernel:
            out = out * float(ksum) if abs(ksum) > 0 else out
        # astropy keeps result where den > 0
        out = torch.where(den > 0, out, torch.nan)
    else:
        out = _conv_device(x, kwork, boundary, fill_value)
    return out if as_tensor else out.cpu().numpy()
