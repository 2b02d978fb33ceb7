"""Kernel circular-shift/zero-pad (CSZ) conversions and FFT convolution
(counterpart of sfft_tpu/post/fftkits.py), in torch.

Reference: sfft/utils/ConvKernelConvertion.py and sfft/utils/PureCupyFFTKits.py
(KERNEL_CSZ / KERNEL_CSZ_INV / FFT_CONVOLVE). The functions take tensors, or
numpy arrays that go to `device` (the CUDA card unless the caller names
another, as the engine's entry points do); the FFTs are cuFFT on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def as_f64(a, device=None) -> torch.Tensor:
    """A float64 tensor of `a`: tensors keep their device unless `device`
    names another; numpy input goes to `device`, or to the card when it is
    None (sfft_tpu_torch.core.engine.default_device)."""
    from sfft_tpu_torch.core.engine import _as_tensor

    if not isinstance(a, torch.Tensor):
        a = np.asarray(a, dtype=np.float64)
    return _as_tensor(a, device).to(torch.float64)


def _odd(L0: int, L1: int):
    if L0 % 2 != 1 or L1 % 2 != 1:
        raise ValueError(f"kernel sides must be odd, got ({L0}, {L1})")


def kernel_csz(kernel: torch.Tensor, N0: int, N1: int, normalize: bool = False) -> torch.Tensor:
    """Tail-zero-pad a small (odd) kernel to image size and circular-shift its
    center to pixel (0, 0) so fft2(kernel_csz) is the convolution transfer
    function."""
    L0, L1 = kernel.shape
    _odd(L0, L1)
    w0, w1 = (L0 - 1) // 2, (L1 - 1) // 2
    k = kernel / kernel.sum() if normalize else kernel
    padded = F.pad(k, (0, N1 - L1, 0, N0 - L0))
    return torch.roll(padded, shifts=(-w0, -w1), dims=(0, 1))


def kernel_csz_inv(kimg: torch.Tensor, L0: int, L1: int, verbose: bool = False):
    """Inverse: circular-shift back and truncate to (L0, L1). Returns
    (kernel, lost_weight) where lost_weight (a 0-d tensor) is the
    absolute-weight fraction dropped by truncation."""
    _odd(L0, L1)
    w0, w1 = (L0 - 1) // 2, (L1 - 1) // 2
    shifted = torch.roll(kimg, shifts=(w0, w1), dims=(0, 1))
    kernel = shifted[:L0, :L1]
    lost = 1.0 - kernel.abs().sum() / shifted.abs().sum()
    if verbose:
        print(f"MeLOn CheckPoint: Kernel Truncation Loses APE = [{float(lost)*100:.4f} %]")
    return kernel, lost


def fft_convolve(
    image,
    kernel,
    pad_fill_value: float = 0.0,
    nan_fill_value: Optional[float] = 0.0,
    normalize_kernel: bool = False,
    device=None,
) -> torch.Tensor:
    """Zero-padded FFT convolution (reference PureCupy_FFTKits.FFT_CONVOLVE):
    pads by the kernel half-width so the circular wrap never touches data,
    convolves in Fourier space, crops back. Returns a float64 tensor on the
    image's device."""
    image = as_f64(image, device)
    kernel = as_f64(kernel, image.device)
    N0, N1 = image.shape
    L0, L1 = kernel.shape
    _odd(L0, L1)
    w0, w1 = (L0 - 1) // 2, (L1 - 1) // 2

    ximg = F.pad(image, (w1, w1, w0, w0), value=pad_fill_value)
    if nan_fill_value is not None:
        ximg = torch.where(torch.isnan(ximg), torch.full_like(ximg, nan_fill_value), ximg)
    kimg = kernel_csz(kernel, N0 + 2 * w0, N1 + 2 * w1, normalize=normalize_kernel)
    out = torch.fft.irfft2(torch.fft.rfft2(ximg) * torch.fft.rfft2(kimg), s=ximg.shape)
    return out[w0 : w0 + N0, w1 : w1 + N1]
