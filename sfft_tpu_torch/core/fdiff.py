"""Difference-image construction from a solved coefficient vector
(counterpart of sfft_tpu/core/fdiff.py).

Reference: Kab phase factors + Construct_FDIFF + ifft2
(sfft/sfftcore/SFFTSubtract.py:771-816, sfft/sfftcore/SFFTConfigure.py:734-809).
The per-pixel phase sum of the reference factorizes: the per-ij kernel
spectrum is K_ij = W0 @ A_ij @ W1, two skinny matmuls, and everything runs on
rfft2 half-spectra. 'fft' computes in the config dtype; 'fft32' runs the same
algebra in float32 / complex64. 'pexact' (the contract mode's exact-grade
difference) lives in core/pexact.py.

The fused model-spectrum pass is plain PyTorch here; its hand kernel (K2)
is the next item of ROADMAP queue 2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sfft_tpu_torch.config import SFFTConfig, torch_dtype
from sfft_tpu_torch.core.statics import Static, table


def _phase_matrices(cfg: SFFTConfig, half: bool = True):
    """W0[u, a] = exp(-2i pi u a / N0) for a in [-w0, w0]; W1[b, v] likewise.

    Static numpy constants (complex128 for float64 configs, complex64 for
    float32)."""
    N0, N1 = cfg.N0, cfg.N1
    a = np.arange(-cfg.w0, cfg.w0 + 1)
    b = np.arange(-cfg.w1, cfg.w1 + 1)
    u = np.arange(N0)
    v = np.arange(N1 // 2 + 1 if half else N1)
    W0 = np.exp((-2j * np.pi / N0) * np.outer(u, a))
    W1 = np.exp((-2j * np.pi / N1) * np.outer(b, v))
    cdt = np.complex128 if cfg.dtype == "float64" else np.complex64
    return W0.astype(cdt), W1.astype(cdt)


def phase_matrix(cfg: SFFTConfig, half: bool, k: int) -> np.ndarray:
    """W0 (k = 0) or W1 (k = 1) of _phase_matrices: the builder of their
    device copies (core/statics.py)."""
    return _phase_matrices(cfg, half)[k]


def split_solution(cfg: SFFTConfig, solution: torch.Tensor):
    a_ijab = solution[: cfg.Fijab].reshape(cfg.Fij, cfg.L0, cfg.L1)
    b_pq = solution[cfg.Fijab :]
    return a_ijab, b_pq


def standard_kernel_coeffs(cfg: SFFTConfig, a_ijab: torch.Tensor) -> torch.Tensor:
    """delta-basis -> standard Cartesian-basis kernel coefficients:
    center pixel becomes 2*a_00 - sum(a) (sfft/utils/SFFTSolutionReader.py:102-114)."""
    s = a_ijab.sum(dim=(1, 2))
    out = a_ijab.clone()
    out[:, cfg.w0, cfg.w1] = 2.0 * a_ijab[:, cfg.w0, cfg.w1] - s
    return out


def fdiff_fft(
    cfg: SFFTConfig,
    solution: torch.Tensor,
    SI: torch.Tensor,
    ST: torch.Tensor,
    J: torch.Tensor,
    SSc: torch.Tensor = None,
) -> torch.Tensor:
    """Fourier-space difference: D = irfft2(FJ - sum_ij K_ij . FI_ij - sum b FT).

    SSc: scaling-weighted planes (SEPARATE-VARYING); the center-offset dofs
    apply to them instead of SI (reference Construct_FDIFF SEPARATE-VARYING
    variant, sfft/BSplineSFFT.py:2430-2528)."""
    N0, N1 = cfg.N0, cfg.N1
    dev = J.device
    a_ijab, b_pq = split_solution(cfg, solution)
    W0 = table(Static(phase_matrix, (cfg, True, 0)), dev)
    W1 = table(Static(phase_matrix, (cfg, True, 1)), dev)
    cdt = W0.dtype

    stack = torch.cat([J[None], SI, ST], dim=0)
    specs = torch.fft.rfft2(stack)
    FJ = specs[0]
    FI = specs[1 : 1 + cfg.Fij]
    FT = specs[1 + cfg.Fij :]

    a00 = a_ijab[:, cfg.w0, cfg.w1]
    Ap = a_ijab.clone()
    Ap[:, cfg.w0, cfg.w1] = 0.0
    Ap = Ap.to(cdt)
    # K'_ij[u, v] = (W0 @ A'_ij @ W1)[u, v]  (center-zeroed kernel spectrum)
    K = torch.einsum("ua,iab,bv->iuv", W0, Ap, W1)
    s_nc = a_ijab.sum(dim=(1, 2)) - a00
    factor = cfg.SCALE * (K - s_nc.to(cdt)[:, None, None])

    model = (factor * FI).sum(dim=0) + torch.tensordot(b_pq.to(cdt), FT, dims=([0], [0]))
    if SSc is None:
        model = model + cfg.SCALE * torch.tensordot(a00.to(cdt), FI, dims=([0], [0]))
    else:
        FS = torch.fft.rfft2(SSc)
        model = model + cfg.SCALE * torch.tensordot(a00.to(cdt), FS, dims=([0], [0]))
    FDIFF = FJ - model
    return torch.fft.irfft2(FDIFF, s=(N0, N1)).to(J.dtype)


def fdiff(cfg: SFFTConfig, solution, SI, ST, J, SSc=None, I=None, shared=None,
          plain: bool = False) -> torch.Tensor:
    """The difference image for cfg.fdiff_backend. 'pexact' builds its own
    pair planes from the image I (SI, ST and SSc unused) and may reuse the
    plane spectra of the solve (`shared`); plain=True runs the plain twins
    of its kernels."""
    if cfg.fdiff_backend == "pexact":
        from sfft_tpu_torch.core.pexact import fdiff_pexact

        return fdiff_pexact(cfg, solution, I, J, shared=shared, plain=plain)
    if cfg.fdiff_backend == "fft":
        return fdiff_fft(cfg, solution, SI, ST, J, SSc)
    if cfg.fdiff_backend == "fft32":
        # float32/complex64 compute of the difference from the float64
        # solution: f32 rounding, far below the pixel noise of survey images
        cfg32 = dataclasses.replace(cfg, dtype="float32", fdiff_backend="fft")
        f32 = torch_dtype("float32")
        out = fdiff_fft(
            cfg32,
            solution.to(f32),
            SI.to(f32),
            ST.to(f32),
            J.to(f32),
            None if SSc is None else SSc.to(f32),
        )
        return out.to(J.dtype)
    raise NotImplementedError(
        f"fdiff backend {cfg.fdiff_backend!r} is not ported to sfft_tpu_torch yet "
        "(ROADMAP queue 1); use 'fft', 'fft32' or 'pexact'")
