"""Difference-image noise decorrelation kernels (counterpart of
sfft_tpu/post/decorrelation.py), in torch.

After PSF matching, the difference D = J - I (*) K has spatially correlated
noise (the convolution correlates I's noise). The decorrelation kernel whitens
it: in Fourier space  F_deco = 1 / sqrt( sum_j s_j^2 |F(K_j)|^2 / Nj^2
+ sum_i s_i^2 |F(K_i)|^2 |F(K_fin)|^2 / Ni^2 ), supporting image-stacking
(J group only) and image-subtraction (J group vs I group through a final
matching kernel) modes.

Reference implementations unified here: DeCorrelation_Calculator.DCC
(sfft/utils/DeCorrelationCalculator.py), PureCupy_DeCorrelation_Calculator.PCDC
(sfft/utils/PureCupyDeCorrelationCalculator.py, with REAL_OUTPUT /
NORMALIZE_OUTPUT / clipping options), and BSpline_DeCorrelation.BDC
(sfft/BSplineSFFT.py:4755-4868, with DENO_CLIP_RATIO denominator clipping).

Everything runs in float64 on `device` (the CUDA card unless the caller
names another), with cuFFT for the transforms. The functions return
tensors; the DCC / BDC facades return numpy arrays, as the reference's do.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sfft_tpu_torch.post.fftkits import as_f64, kernel_csz, kernel_csz_inv

_DELTA3 = np.array([[0, 0, 0], [0, 1, 0], [0, 0, 0]], dtype=np.float64)


def _kpow2(kernel, N0: int, N1: int, device) -> torch.Tensor:
    k = _DELTA3 if kernel is None else kernel
    kft = torch.fft.fft2(kernel_csz(as_f64(k, device), N0, N1))
    return (torch.conj(kft) * kft).real


def decorrelation_denominator(
    MK_JLst: Sequence,
    SkySig_JLst: Sequence[float],
    MK_ILst: Sequence = (),
    SkySig_ILst: Sequence[float] = (),
    MK_Fin=None,
    N0: int = 64,
    N1: int = 64,
    device=None,
) -> torch.Tensor:
    from sfft_tpu_torch.core.engine import default_device

    device = default_device() if device is None else torch.device(device)
    NumI, NumJ = len(MK_ILst), len(MK_JLst)
    deno = torch.zeros((N0, N1), dtype=torch.float64, device=device)
    for mk, s in zip(MK_JLst, SkySig_JLst):
        deno = deno + (s**2) * _kpow2(mk, N0, N1, device) / NumJ**2
    if NumI >= 1:
        kfin2 = _kpow2(MK_Fin, N0, N1, device)
        for mk, s in zip(MK_ILst, SkySig_ILst):
            deno = deno + (s**2) * _kpow2(mk, N0, N1, device) * kfin2 / NumI**2
    return deno


def _clip(deno: torch.Tensor, ratio: float):
    """Floor the denominator at max / ratio; returns (deno, clipped mask)."""
    floor = deno.max() / ratio
    mask = deno < floor
    return torch.where(mask, floor, deno), mask


def decorrelation_kernel(
    MK_JLst: Sequence,
    SkySig_JLst: Sequence[float],
    MK_ILst: Sequence = (),
    SkySig_ILst: Sequence[float] = (),
    MK_Fin=None,
    KERatio: float = 2.0,
    VERBOSE_LEVEL: int = 1,
    DENO_CLIP_RATIO: Optional[float] = None,
    device=None,
) -> torch.Tensor:
    """Reference DeCorrelation_Calculator.DCC: real-space decorrelation kernel,
    truncated to KERatio x (max matching-kernel size), unit-sum normalized.

    Image-stacking mode: no I list (needs >= 2 J kernels). Image-subtraction
    mode: both lists (+ optional final matching kernel).

    DENO_CLIP_RATIO: floor tiny denominator values at max/ratio before the
    square root (BSpline_DeCorrelation.BDC behavior, default 1e5 there,
    sfft/BSplineSFFT.py:4853-4857); the plain DCC reference never clips.
    Without clipping, spectral zeros of the denominator propagate inf/NaN
    into the kernel: the failure mode the clipping exists to prevent."""
    NumI, NumJ = len(MK_ILst), len(MK_JLst)
    if NumI == 0:
        if NumJ < 2:
            raise ValueError("Image-Stacking mode requires at least 2 J-images")
        if not any(mk is not None for mk in MK_JLst):
            raise ValueError("Image-Stacking mode requires a non-None J-kernel")
    else:
        if NumJ == 0:
            raise ValueError("Image-Subtraction mode requires >= 1 I & J image")
        if not any(mk is not None for mk in list(MK_JLst) + list(MK_ILst) + [MK_Fin]):
            raise ValueError("need at least one non-None kernel")

    queue = [mk for mk in list(MK_JLst) + ([MK_Fin] + list(MK_ILst) if NumI else [])
             if mk is not None]
    L0 = int(round(KERatio * max(mk.shape[0] for mk in queue)))
    L1 = int(round(KERatio * max(mk.shape[1] for mk in queue)))
    L0 += 1 - L0 % 2
    L1 += 1 - L1 % 2
    if VERBOSE_LEVEL in (1, 2):
        print(f"MeLOn CheckPoint: DeCorrelation Kernel with size [{L0}, {L1}]")

    N0 = 2 ** (math.ceil(np.log2(max(mk.shape[0] for mk in queue))) + 1)
    N1 = 2 ** (math.ceil(np.log2(max(mk.shape[1] for mk in queue))) + 1)

    deno = decorrelation_denominator(
        MK_JLst, SkySig_JLst, MK_ILst, SkySig_ILst, MK_Fin, N0, N1, device
    )
    if DENO_CLIP_RATIO is not None:
        if VERBOSE_LEVEL == 2:
            print(f"MeLOn CheckPoint: Initial Max/Min "
                  f"[{float(deno.max() / deno.min()):.1f}] in Denominator Map")
        deno, clip_mask = _clip(deno, DENO_CLIP_RATIO)
        if VERBOSE_LEVEL == 2:
            print(f"MeLOn CheckPoint: DENOMINATOR CLIPPING TWEAKED "
                  f"[{float(clip_mask.double().mean()):.2%}] PIXELS")
    fdeco = torch.sqrt(1.0 / deno)
    deco = torch.fft.ifft2(fdeco).real
    kdeco, _ = kernel_csz_inv(deco, L0, L1, verbose=VERBOSE_LEVEL == 2)
    return kdeco / kdeco.sum()


def decorrelation_transfer(
    NX_IMG: int,
    NY_IMG: int,
    KERNEL_JQueue: Sequence,
    BKGSIG_JQueue: Sequence[float],
    KERNEL_IQueue: Sequence = (),
    BKGSIG_IQueue: Sequence[float] = (),
    MATCH_KERNEL=None,
    REAL_OUTPUT: bool = False,
    REAL_OUTPUT_SIZE: Optional[Tuple[int, int]] = None,
    NORMALIZE_OUTPUT: bool = True,
    DENO_CLIP_RATIO: Optional[float] = None,
    VERBOSE_LEVEL: int = 1,
    device=None,
) -> torch.Tensor:
    """Full-image-size decorrelation (reference PCDC + BDC clipping):
    returns the Fourier transfer map F_deco (REAL_OUTPUT=False, normalized so
    F_deco[0,0] = 1) or a truncated real-space kernel.

    DENO_CLIP_RATIO: clip tiny denominator values at max/ratio before the
    square root (BSpline_DeCorrelation behavior) to avoid blow-up."""
    deno = decorrelation_denominator(
        KERNEL_JQueue, BKGSIG_JQueue, KERNEL_IQueue, BKGSIG_IQueue,
        MATCH_KERNEL, NX_IMG, NY_IMG, device,
    )
    if DENO_CLIP_RATIO is not None:
        deno, _ = _clip(deno, DENO_CLIP_RATIO)
    fdeco = 1.0 / torch.sqrt(deno)

    if not REAL_OUTPUT:
        if NORMALIZE_OUTPUT:
            fdeco = fdeco / fdeco[0, 0]
        return fdeco

    if REAL_OUTPUT_SIZE is None:
        raise ValueError("REAL_OUTPUT needs REAL_OUTPUT_SIZE")
    kdeco_img = torch.fft.ifft2(fdeco).real
    kdeco, _ = kernel_csz_inv(kdeco_img, *REAL_OUTPUT_SIZE, verbose=VERBOSE_LEVEL == 2)
    if NORMALIZE_OUTPUT:
        kdeco = kdeco / kdeco.sum()
    return kdeco


class DeCorrelationCalculator:
    """Reference-compatible facade (DCC) — no denominator clipping. Returns
    a numpy array."""

    @staticmethod
    def DCC(MK_JLst, SkySig_JLst, MK_ILst=[], SkySig_ILst=[], MK_Fin=None,
            KERatio=2.0, VERBOSE_LEVEL=1, device=None):
        return decorrelation_kernel(
            MK_JLst, SkySig_JLst, MK_ILst, SkySig_ILst, MK_Fin, KERatio, VERBOSE_LEVEL,
            device=device).cpu().numpy()


class BSplineDeCorrelation:
    """Reference-compatible facade (BSpline_DeCorrelation.BDC,
    sfft/BSplineSFFT.py:4755-4868): same math as DCC plus denominator
    clipping at max/DENO_CLIP_RATIO (default 1e5, like the reference) so
    near-zero Fourier denominator pixels cannot blow up the whitening
    kernel (observed on JWST/NIRCam data). Returns a numpy array."""

    @staticmethod
    def BDC(MK_JLst, SkySig_JLst, MK_ILst=[], SkySig_ILst=[], MK_Fin=None,
            KERatio=2.0, DENO_CLIP_RATIO=100000.0, VERBOSE_LEVEL=1, device=None):
        return decorrelation_kernel(
            MK_JLst, SkySig_JLst, MK_ILst, SkySig_ILst, MK_Fin, KERatio,
            VERBOSE_LEVEL, DENO_CLIP_RATIO=DENO_CLIP_RATIO, device=device).cpu().numpy()
