"""Greek-tensor computation as windowed circular cross-correlations
(counterpart of sfft_tpu/core/greek.py), with the K1 kernel.

For real planes A, B,

    Re IFFT2( FFT2(A) * conj(FFT2(B)) )[rho, eps]
        = sum_xy A[x, y] * B[(x+rho) % N0, (y+eps) % N1] = CC(A, B)[rho, eps],

and the normal equations only read CC at lags within [-2w, 2w]. The windows
come from rfft2 half-spectra by one of:

  * 'irfft'  — Hadamard product + full irfft2 + corner gather (plain torch);
  * 'matmul' — Hadamard product + a partial inverse DFT, two complex
    contractions with the static E0 / E1 matrices (plain torch);
  * 'kernel' — the same partial inverse DFT in the hand-written K1 kernel
    (csrc/corr_window.cu), which never writes the Hadamard product out.

'auto' picks 'irfft' for CPU tensors (as sfft_tpu does on the CPU) and the
kernel for CUDA tensors; plain=True keeps CUDA tensors on 'irfft', so a
caller can run the whole path on the plain twins.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from sfft_tpu_torch.core.statics import index


def _window_row_indices(N: int, w: int) -> np.ndarray:
    """Row indices of irfft output holding CC at lags rho=-w..w (table index
    rho+w): CC[rho] = irfft2(H)[(-rho) % N]."""
    rho = np.arange(-w, w + 1)
    return ((-rho) % N).astype(np.int32)


def _partial_idft_mats(N0: int, N1: int, wx: int, wy: int, cdtype):
    """Static matrices for the windowed inverse transform:
    CC[rho, eps] = Re( E0 @ H_half @ E1 ) with E0[r, u] = exp(2i pi u x_r / N0)
    / (N0*N1), x_r = (-rho_r) % N0, and E1[v, e] folding the Hermitian half
    spectrum (weight 2 for interior v; 1 at v = 0 and the Nyquist column)."""
    rows = _window_row_indices(N0, wx).astype(np.float64)
    cols = _window_row_indices(N1, wy).astype(np.float64)
    N1h = N1 // 2 + 1
    u = np.arange(N0)
    v = np.arange(N1h)
    E0 = np.exp(2j * np.pi * np.outer(rows, u) / N0) / (N0 * N1)
    w = np.full(N1h, 2.0)
    w[0] = 1.0
    if N1 % 2 == 0:
        w[-1] = 1.0
    E1 = w[:, None] * np.exp(2j * np.pi * np.outer(v, cols) / N1)
    return E0.astype(cdtype), E1.astype(cdtype)


@lru_cache(maxsize=32)
def _idft_mats_on(N0: int, N1: int, wx: int, wy: int, dtype: torch.dtype,
                  device: torch.device):
    """_partial_idft_mats as contiguous tensors on `device` (cached: they are
    static per geometry, like the constants sfft_tpu bakes into its graph)."""
    npdt = np.complex128 if dtype == torch.complex128 else np.complex64
    E0, E1 = _partial_idft_mats(N0, N1, wx, wy, npdt)
    return (torch.as_tensor(E0, device=device).contiguous(),
            torch.as_tensor(E1, device=device).contiguous())


def corr_pairs_plain(specA, specB, ia, ib, E0, E1) -> torch.Tensor:
    """The plain twin of K1 (sfft_tpu's 'matmul' method) for a pair list:
    out[c] = Re(E0 @ (specA[ia[c]] * conj(specB[ib[c]])) @ E1)."""
    H = specA[index(ia, specA.device, torch.long)] * torch.conj(
        specB[index(ib, specA.device, torch.long)])
    T1 = torch.einsum("cuv,ve->cue", H, E1)
    return torch.real(torch.einsum("ru,cue->cre", E0, T1))


def _corr_launch(specA, specB, ia, ib, E0, E1) -> torch.Tensor:
    from sfft_tpu_torch import _kernels

    npairs = len(ia)
    N0, N1h = specA.shape[1], specA.shape[2]
    R0, R1 = E0.shape[0], E1.shape[1]
    real = torch.float32 if specA.dtype == torch.complex64 else torch.float64
    dev = specA.device
    pa = index(ia, dev, torch.int32)
    pb = index(ib, dev, torch.int32)
    T1 = torch.empty((npairs, N0, R1), dtype=specA.dtype, device=dev)
    out = torch.empty((npairs, R0, R1), dtype=real, device=dev)
    entry = ("sfft_corr_window_c64" if specA.dtype == torch.complex64
             else "sfft_corr_window_c128")
    with torch.cuda.device(dev):
        err = getattr(_kernels.lib(), entry)(
            specA.data_ptr(), specB.data_ptr(), pa.data_ptr(), pb.data_ptr(),
            E0.data_ptr(), E1.data_ptr(), T1.data_ptr(), out.data_ptr(),
            npairs, N0, N1h, R0, R1, _kernels.stream_ptr(specA))
    corr_window.launches += 1
    _kernels.check(err, "corr_window kernel launch")
    return out


def corr_window(specA: torch.Tensor, specB: torch.Tensor, ia, ib,
                E0: torch.Tensor, E1: torch.Tensor) -> torch.Tensor:
    """K1: windowed cross-correlations (npairs, R0, R1) for the pair list
    (ia, ib) of the half-spectrum stacks specA (Fa, N0, N1h) and specB
    (Fb, N0, N1h). CUDA tensors launch csrc/corr_window.cu (complex64 or
    complex128); CPU tensors use ``corr_pairs_plain``."""
    tensors = (specA, specB, E0, E1)
    if specA.dtype not in (torch.complex64, torch.complex128) or any(
            t.dtype != specA.dtype for t in tensors):
        raise TypeError("corr_window needs complex64 or complex128 spectra and "
                        "matrices of one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    if specA.dim() != 3 or specB.dim() != 3 or specA.shape[1:] != specB.shape[1:]:
        raise ValueError(f"corr_window needs (F, N0, N1h) stacks, got "
                         f"{tuple(specA.shape)} and {tuple(specB.shape)}")
    N0, N1h = specA.shape[1], specA.shape[2]
    if E0.dim() != 2 or E1.dim() != 2 or E0.shape[1] != N0 or E1.shape[0] != N1h:
        raise ValueError(f"corr_window needs E0 (R0, {N0}) and E1 ({N1h}, R1), "
                         f"got {tuple(E0.shape)} and {tuple(E1.shape)}")
    if any(t.device != specA.device for t in tensors):
        raise ValueError("corr_window operands on different devices")
    if any(t.is_conj() for t in tensors):
        raise ValueError("corr_window needs resolved tensors (call resolve_conj())")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("corr_window needs contiguous operands")
    ia = np.asarray(ia, np.int64)
    ib = np.asarray(ib, np.int64)
    if ia.shape != ib.shape or ia.ndim != 1:
        raise ValueError("corr_window needs two equal-length 1-D pair index lists")
    if len(ia) and (ia.min() < 0 or ia.max() >= specA.shape[0]
                    or ib.min() < 0 or ib.max() >= specB.shape[0]):
        raise IndexError("corr_window pair index out of range")
    if specA.device.type == "cpu":
        return corr_pairs_plain(specA, specB, ia, ib, E0, E1)
    if specA.device.type != "cuda":
        raise ValueError(f"corr_window runs on cpu or cuda tensors, not {specA.device}")
    if E1.shape[1] > 64 or len(ia) == 0 or len(ia) > 65535:
        raise ValueError(f"corr_window kernel takes 1..65535 pairs and at most "
                         f"64 lags along axis 1, got {len(ia)} and {E1.shape[1]}")
    return _corr_launch(specA, specB, ia, ib, E0, E1)


corr_window.launches = 0


def corr_window_fft(
    specA: torch.Tensor,
    specB: torch.Tensor,
    N0: int,
    N1: int,
    wx: int,
    wy: int,
    chunk: int = 0,
    method: str = "auto",
    symmetric: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """CC(A_a, B_b)[rho, eps] for all pairs, lags |rho|<=wx, |eps|<=wy.

    specA: (Fa, N0, N1h) raw rfft2 spectra of A stack; specB likewise (Fb, ...).
    Returns (Fa, Fb, 2*wx+1, 2*wy+1) real. method: 'irfft' | 'matmul' |
    'kernel' | 'auto' (see the module docstring). symmetric (with specA is
    specB, for 'matmul' and 'kernel') computes the upper triangle of pairs
    and mirrors it: CC(A_b, A_a)[rho] = CC(A_a, A_b)[-rho]. chunk bounds the
    pairs per contraction (memory throttling).
    """
    Fa, Fb = specA.shape[0], specB.shape[0]
    if method == "auto":
        method = "irfft" if (plain or specA.device.type == "cpu") else "kernel"

    if method in ("matmul", "kernel"):
        E0, E1 = _idft_mats_on(N0, N1, wx, wy, specA.dtype, specA.device)
        pair_fn = corr_window if method == "kernel" else corr_pairs_plain
        same = symmetric and specA is specB
        if method == "kernel":
            specA = specA.resolve_conj().contiguous()
            specB = specA if same else specB.resolve_conj().contiguous()
        if same:
            iu, ju = np.triu_indices(Fa)
            csize = chunk if chunk else len(iu)
            tri = torch.cat([pair_fn(specA, specB, iu[k:k + csize], ju[k:k + csize], E0, E1)
                             for k in range(0, len(iu), csize)], dim=0)
            full = torch.zeros((Fa, Fa, 2 * wx + 1, 2 * wy + 1), dtype=tri.dtype,
                               device=tri.device)
            iu_t = index(iu, tri.device, torch.long)
            ju_t = index(ju, tri.device, torch.long)
            full[iu_t, ju_t] = tri
            full[ju_t, iu_t] = torch.flip(tri, dims=(1, 2))
            return full
        ia, ib = np.meshgrid(np.arange(Fa), np.arange(Fb), indexing="ij")
        ia = ia.ravel()
        ib = ib.ravel()
        npairs = Fa * Fb
        csize = chunk if chunk else npairs
        out = torch.cat([pair_fn(specA, specB, ia[k:k + csize], ib[k:k + csize], E0, E1)
                         for k in range(0, npairs, csize)], dim=0)
        return out.reshape(Fa, Fb, 2 * wx + 1, 2 * wy + 1)
    if method != "irfft":
        raise ValueError(f"unknown corr_window_fft method {method!r}")

    rows = index(_window_row_indices(N0, wx), specA.device, torch.long)
    cols = index(_window_row_indices(N1, wy), specA.device, torch.long)
    H = specA[:, None, :, :] * torch.conj(specB)[None, :, :, :]
    H = H.reshape(Fa * Fb, N0, specA.shape[-1])

    def one_chunk(h):
        cc = torch.fft.irfft2(h, s=(N0, N1))
        return cc[:, rows][:, :, cols]

    if chunk and Fa * Fb > chunk:
        out = torch.cat([one_chunk(H[k:k + chunk]) for k in range(0, Fa * Fb, chunk)], dim=0)
    else:
        out = one_chunk(H)
    return out.reshape(Fa, Fb, 2 * wx + 1, 2 * wy + 1)


def dot_planes(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Lag-zero correlations only: (Fa, Fb) matrix of plane inner products."""
    Fa = A.shape[0]
    Fb = B.shape[0]
    return A.reshape(Fa, -1) @ B.reshape(Fb, -1).T


def greek_tables(
    SI: torch.Tensor,
    ST: torch.Tensor,
    J: torch.Tensor,
    w0: int,
    w1: int,
    backend: str = "fft",
    chunk: int = 0,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """All correlation tables the assembly needs.

    Returns (Comg, Cgam, Cthe, Cphi, Cdel):
      Comg: (Fij, Fij, 4*w0+1, 4*w1+1)   lags -2w..2w, index lag+2w
      Cgam: (Fij, Fpq, 2*w0+1, 2*w1+1)   lags -w..w, index lag+w
      Cthe: (Fij, 2*w0+1, 2*w1+1)
      Cphi: (Fpq, Fpq) lag 0
      Cdel: (Fpq,)     lag 0

    Unscaled CC values; the engine applies the SCALE powers that map CC to the
    reference's Pre tables. Only backend='fft' is ported; plain=True keeps
    every correlation on the plain twins.
    """
    if backend != "fft":
        raise NotImplementedError(
            f"greek backend {backend!r} is not ported to sfft_tpu_torch yet "
            "(ROADMAP queue 1, TPU-precision engines)")
    N0, N1 = J.shape
    Cphi = dot_planes(ST, ST)
    Cdel = dot_planes(ST, J[None])[:, 0]
    stack = torch.cat([J[None], SI, ST], dim=0)
    specs = torch.fft.rfft2(stack)
    Fij = SI.shape[0]
    specJ = specs[0:1]
    specI = specs[1 : 1 + Fij]
    specT = specs[1 + Fij :]
    Comg = corr_window_fft(specI, specI, N0, N1, 2 * w0, 2 * w1,
                           chunk=chunk, symmetric=True, plain=plain)
    Cgam = corr_window_fft(specI, specT, N0, N1, w0, w1, chunk=chunk, plain=plain)
    Cthe = corr_window_fft(specI, specJ, N0, N1, w0, w1, chunk=chunk, plain=plain)[:, 0]
    return Comg, Cgam, Cthe, Cphi, Cdel
