"""Difference-image construction from a solved coefficient vector
(counterpart of sfft_tpu/core/fdiff.py).

Reference: Kab phase factors + Construct_FDIFF + ifft2
(sfft/sfftcore/SFFTSubtract.py:771-816, sfft/sfftcore/SFFTConfigure.py:734-809).
The per-pixel phase sum of the reference factorizes: the per-ij kernel
spectrum is K_ij = W0 @ A_ij @ W1, two skinny matmuls, and everything runs on
rfft2 half-spectra. 'fft' computes in the config dtype; 'fft32' runs the same
algebra in float32 / complex64. 'exact' (``fdiff_exact``, the v2 engine's
contract-grade difference for any spatial basis) carries that algebra in f32
pair arithmetic with the sliced-integer transforms of core/exact_fft.py;
'pexact' (the polynomial contract mode's) lives in core/pexact.py.

The fused model-spectrum pass between the forward and the inverse rfft2
(``fdiff_model``) is the hand-written K2 kernel (csrc/fdiff_model.cu) on CUDA
tensors and its plain twin ``fdiff_model_plain`` on CPU tensors; the FFTs
stay cuFFT. 'conv' (``fdiff_conv``, the complex-free f64 route) builds the
difference in real space, a circular convolution of the SI planes with the
standard-basis kernel in the hand-written K9 kernel (csrc/conv_direct.cu,
``conv_direct``, twin ``conv_direct_plain``), which utils/convolve.py's
convolve2d shares.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sfft_tpu_torch.config import SFFTConfig, torch_dtype
from sfft_tpu_torch.core import pairs
from sfft_tpu_torch.core.basis import basis_1d_tables
from sfft_tpu_torch.core.indices import ref_basis_exponents
from sfft_tpu_torch.core.statics import Static, index, table


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
    """(a_ijab (Fij, L0, L1), b_pq (Fpq,)) views of a solution (NEQ,), or
    of a batch's (B, NEQ) with the leading pair axis."""
    lead = tuple(solution.shape[:-1])
    a_ijab = solution[..., : cfg.Fijab].reshape(lead + (cfg.Fij, cfg.L0, cfg.L1))
    b_pq = solution[..., cfg.Fijab :]
    return a_ijab, b_pq


def standard_kernel_coeffs(cfg: SFFTConfig, a_ijab: torch.Tensor) -> torch.Tensor:
    """delta-basis -> standard Cartesian-basis kernel coefficients:
    center pixel becomes 2*a_00 - sum(a) (sfft/utils/SFFTSolutionReader.py:102-114)."""
    s = a_ijab.sum(dim=(1, 2))
    out = a_ijab.clone()
    out[:, cfg.w0, cfg.w1] = 2.0 * a_ijab[:, cfg.w0, cfg.w1] - s
    return out


def fdiff_model_plain(specs: torch.Tensor, FS, solution: torch.Tensor, W0: torch.Tensor,
                      W1: torch.Tensor, Fij: int, w0: int, w1: int, SCALE: float) -> torch.Tensor:
    """The model spectrum's plain PyTorch twin: FDIFF = FJ - sum_ij
    SCALE (K'_ij - s_nc_ij) FI_ij - sum_pq b_pq FT_pq - SCALE sum_ij a00_ij
    FX_ij with K'_ij = W0 @ A'_ij @ W1 (center-zeroed), FX = FS when given
    (its nS <= Fij planes pair with the first nS centers), else FI.
    specs: (1 + Fij + Fpq, N0, N1h) rfft2 half spectra of J, SI, ST. A
    batch (specs (B, 1 + Fij + Fpq, N0, N1h), FS (B, nS, N0, N1h),
    solution (B, NEQ)) runs pair by pair: (B, N0, N1h)."""
    if specs.dim() == 4:
        return torch.stack([fdiff_model_plain(specs[b], None if FS is None else FS[b],
                                              solution[b], W0, W1, Fij, w0, w1, SCALE)
                            for b in range(specs.shape[0])])
    cdt = W0.dtype
    L0, L1 = W0.shape[1], W1.shape[0]
    FJ = specs[0]
    FI = specs[1 : 1 + Fij]
    FT = specs[1 + Fij :]
    a_ijab = solution[: Fij * L0 * L1].reshape(Fij, L0, L1)
    b_pq = solution[Fij * L0 * L1 :]
    a00 = a_ijab[:, w0, w1]
    Ap = a_ijab.clone()
    Ap[:, w0, w1] = 0.0
    Ap = Ap.to(cdt)
    # K'_ij[u, v] = (W0 @ A'_ij @ W1)[u, v]  (center-zeroed kernel spectrum)
    K = torch.einsum("ua,iab,bv->iuv", W0, Ap, W1)
    s_nc = a_ijab.sum(dim=(1, 2)) - a00
    factor = SCALE * (K - s_nc.to(cdt)[:, None, None])

    model = (factor * FI).sum(dim=0) + torch.tensordot(b_pq.to(cdt), FT, dims=([0], [0]))
    if FS is None:
        model = model + SCALE * torch.tensordot(a00.to(cdt), FI, dims=([0], [0]))
    else:
        model = model + SCALE * torch.tensordot(a00[: FS.shape[0]].to(cdt), FS,
                                                dims=([0], [0]))
    return FJ - model


_K2_ENTRY = {torch.complex64: "sfft_fdiff_model_c64", torch.complex128: "sfft_fdiff_model_c128"}
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def _fdiff_model_launch(specs, FS, solution, W0, W1, Fij, w0, w1, SCALE):
    """K2's two launches for the batch specs (B, 1 + Fij + Fpq, N0, N1h)
    (FS (B, nS, N0, N1h) or None, solution (B, NEQ)): (B, N0, N1h)."""
    from sfft_tpu_torch import _kernels

    L0, L1 = W0.shape[1], W1.shape[0]
    B, nplanes, N0, N1h = specs.shape
    dev = specs.device
    T = torch.empty((B, Fij, L0, N1h), dtype=specs.dtype, device=dev)
    snc = torch.empty((B, Fij), dtype=solution.dtype, device=dev)
    out = torch.empty((B, N0, N1h), dtype=specs.dtype, device=dev)
    nS = 0 if FS is None else FS.shape[1]
    with torch.cuda.device(dev):
        err = getattr(_kernels.lib(), _K2_ENTRY[specs.dtype])(
            specs.data_ptr(), FS.data_ptr() if nS else None, solution.data_ptr(),
            W0.data_ptr(), W1.data_ptr(), T.data_ptr(), snc.data_ptr(), out.data_ptr(),
            Fij, nplanes - 1 - Fij, nS, L0, L1, w0, w1, N0, N1h, B, float(SCALE),
            _kernels.stream_ptr(specs))
    fdiff_model.launches += 2
    _kernels.check(err, "fdiff_model kernel launch")
    return out


def fdiff_model(specs: torch.Tensor, FS, solution: torch.Tensor, W0: torch.Tensor,
                W1: torch.Tensor, Fij: int, w0: int, w1: int, SCALE: float) -> torch.Tensor:
    """The model spectrum FDIFF (N0, N1h) of ``fdiff_model_plain``'s
    arguments, all contiguous, complex64 (f32 solution) or complex128 (f64);
    a batch of pairs (specs (B, 1 + Fij + Fpq, N0, N1h), FS (B, nS, N0,
    N1h) or None, solution (B, NEQ)) gives (B, N0, N1h), each pair's bits
    those of its single call. CUDA tensors go through the K2 kernel (two
    launches for the batch: the per-ij rows A'_ij @ W1, then one pass over
    the half spectrum that never writes K'); CPU tensors through
    ``fdiff_model_plain``."""
    cdt = specs.dtype
    spectra = [specs, W0, W1] + ([] if FS is None else [FS])
    if cdt not in _REAL or any(t.dtype != cdt for t in spectra) or solution.dtype != _REAL[cdt]:
        raise TypeError("fdiff_model needs complex64 or complex128 spectra and phase matrices "
                        "and a solution of the matching real type")
    tensors = spectra + [solution]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fdiff_model needs contiguous operands")
    if any(t.device != specs.device for t in tensors):
        raise ValueError("fdiff_model operands on more than one device")
    if specs.dim() not in (3, 4):
        raise ValueError("fdiff_model needs ([B,] 1 + Fij + Fpq, N0, N1h) spectra")
    batched = specs.dim() == 4
    nplanes, N0, N1h = specs.shape[-3:]
    B = specs.shape[0] if batched else 1
    L0, L1 = W0.shape[1], W1.shape[0]
    Fpq = nplanes - 1 - Fij
    lead = (B,) if batched else ()
    if (Fpq < 0 or tuple(W0.shape) != (N0, L0) or tuple(W1.shape) != (L1, N1h)
            or tuple(solution.shape) != lead + (Fij * L0 * L1 + Fpq,)
            or (FS is not None and (FS.dim() != specs.dim() or FS.shape[-3] > Fij
                                    or tuple(FS.shape[-2:]) != (N0, N1h)
                                    or tuple(FS.shape[:-3]) != lead))):
        raise ValueError("fdiff_model: inconsistent shapes")
    if specs.device.type == "cpu":
        return fdiff_model_plain(specs, FS, solution, W0, W1, Fij, w0, w1, SCALE)
    if specs.device.type != "cuda":
        raise ValueError(f"fdiff_model runs on cpu or cuda tensors, not {specs.device}")
    if specs.numel() >= 2 ** 31 or Fij * (L0 + 1) > 65535 or B > 65535:
        raise ValueError("fdiff_model kernel takes int32 extents and at most 65535 pairs")
    if batched:
        return _fdiff_model_launch(specs, FS, solution, W0, W1, Fij, w0, w1, SCALE)
    return _fdiff_model_launch(specs[None], None if FS is None else FS[None], solution[None],
                               W0, W1, Fij, w0, w1, SCALE)[0]


fdiff_model.launches = 0


def fdiff_fft(
    cfg: SFFTConfig,
    solution: torch.Tensor,
    SI: torch.Tensor,
    ST: torch.Tensor,
    J: torch.Tensor,
    SSc: torch.Tensor = None,
    plain: bool = False,
) -> torch.Tensor:
    """Fourier-space difference: D = irfft2(FJ - sum_ij K_ij . FI_ij - sum b FT).

    SSc: scaling-weighted planes (SEPARATE-VARYING); the center-offset dofs
    apply to them instead of SI (reference Construct_FDIFF SEPARATE-VARYING
    variant, sfft/BSplineSFFT.py:2430-2528); it may hold fewer than Fij
    planes (the active ones). The model spectrum between the forward and the
    inverse rfft2 is ``fdiff_model`` (K2 on the card); plain=True takes its
    twin. A batch of pairs (J (B, N0, N1), SI and SSc (B, F, N0, N1),
    solution (B, NEQ); ST shared) gives (B, N0, N1): one K2 call for the
    batch, the forward and inverse rfft2 pair by pair (cuFFT's batched
    transforms change a pair's bits), each pair's bits those of its single
    call."""
    from sfft_tpu_torch.core.greek import irfft2_pairs, rfft2_pairs

    N0, N1 = cfg.N0, cfg.N1
    dev = J.device
    W0 = table(Static(phase_matrix, (cfg, True, 0)), dev)
    W1 = table(Static(phase_matrix, (cfg, True, 1)), dev)
    lead = tuple(J.shape[:-2])
    rfft2 = rfft2_pairs if lead else torch.fft.rfft2
    specs = rfft2(torch.cat([J[..., None, :, :], SI, ST.expand(lead + tuple(ST.shape))], dim=-3))
    FS = None if SSc is None else rfft2(SSc)
    model = fdiff_model_plain if plain else fdiff_model
    FDIFF = model(specs, FS, solution.to(_REAL[W0.dtype]).contiguous(), W0, W1, cfg.Fij,
                  cfg.w0, cfg.w1, cfg.SCALE)
    irfft2 = irfft2_pairs if lead else torch.fft.irfft2
    return irfft2(FDIFF, s=(N0, N1)).to(J.dtype)


def conv_direct_plain(planes: torch.Tensor, taps: torch.Tensor, wrap: bool = True, J=None,
                      ST=None, b=None, SSc=None, a00=None, scale: float = 1.0) -> torch.Tensor:
    """K9's plain twin, in sfft_tpu's formulation (fdiff_conv, convolve2d):
    the planes (F, H, W) circularly padded by (L0 // 2, L1 // 2) when
    `wrap` (else already padded by the caller), one grouped VALID conv2d
    with the flipped taps (F, L0, L1), then

        model = scale * sum_i conv_i + sum_q b_q ST_q + scale * sum_s a00_s SSc_s

    and J - model, or model itself without J."""
    F_, L0, L1 = taps.shape
    x = planes[None]
    if wrap:
        x = torch.nn.functional.pad(x, (L1 // 2, L1 // 2, L0 // 2, L0 // 2), mode="circular")
    conv = torch.nn.functional.conv2d(x, torch.flip(taps, dims=(1, 2))[:, None], groups=F_)[0]
    model = scale * conv.sum(dim=0)
    if ST is not None:
        model = model + torch.tensordot(b, ST, dims=([0], [0]))
    if SSc is not None:
        model = model + scale * torch.tensordot(a00, SSc, dims=([0], [0]))
    return model if J is None else J - model


def conv_direct(planes: torch.Tensor, taps: torch.Tensor, wrap: bool = True, J=None, ST=None,
                b=None, SSc=None, a00=None, scale: float = 1.0) -> torch.Tensor:
    """K9: the direct convolution of the planes (F, H, W) with their taps
    (F, L0, L1; odd sides), summed, plus the background planes ST weighted
    by b and the scaling planes SSc weighted by a00, subtracted from J
    (``conv_direct_plain``'s arguments and result). `wrap`: the indices
    read mod the plane's size and the output is (H, W); else the planes are
    padded by (L0 // 2, L1 // 2) on each side and the output is (H - L0 + 1,
    W - L1 + 1). CUDA tensors: one launch of csrc/conv_direct.cu on the
    FP64 tensor cores (float64; mma.sync m16n8k4, M = 16 output columns, N
    = 8 output rows, K = 4 tap columns of one plane; any side: taps past 63
    a side in chunks; bit-reproducible); CPU tensors: ``conv_direct_plain``.
    The planes must be finite on the card: the kernel multiplies the zeros
    of its tap band by every staged value, so a NaN or inf reaches every
    row of its 8-row output tile, past its window (not checked: that costs
    a device sync a call). Its callers keep it so: ``fdiff_conv`` (the
    unmasked image's planes may hold NaN or inf) goes through
    ``conv_direct_nonfinite``, which zeroes them and adds their terms
    after, and convolve2d pads a non-finite fill with zeros and adds its
    terms after. ``conv_direct.launches`` counts the launches."""
    if planes.dim() != 3 or taps.dim() != 3 or taps.shape[0] != planes.shape[0]:
        raise ValueError(f"conv_direct needs planes (F, H, W) and taps (F, L0, L1), got "
                         f"{tuple(planes.shape)} and {tuple(taps.shape)}")
    F_, L0, L1 = taps.shape
    if L0 % 2 != 1 or L1 % 2 != 1:
        raise ValueError(f"conv_direct needs odd kernel sides, got ({L0}, {L1})")
    H, W = planes.shape[1], planes.shape[2]
    N0, N1 = (H, W) if wrap else (H - L0 + 1, W - L1 + 1)
    if N0 < 1 or N1 < 1:
        raise ValueError("conv_direct: the padded planes are smaller than the kernel")
    extras = [t for t in (J, ST, b, SSc, a00) if t is not None]
    if (ST is None) != (b is None) or (SSc is None) != (a00 is None):
        raise ValueError("conv_direct needs ST with b and SSc with a00")
    if ((J is not None and tuple(J.shape) != (N0, N1))
            or (ST is not None and (tuple(ST.shape[1:]) != (N0, N1) or b.shape != ST.shape[:1]))
            or (SSc is not None and (tuple(SSc.shape[1:]) != (N0, N1)
                                     or a00.shape != SSc.shape[:1]))):
        raise ValueError("conv_direct: J, ST (with b) and SSc (with a00) must match the output")
    if any(t.device != planes.device for t in [taps] + extras):
        raise ValueError("conv_direct operands on different devices")
    if planes.device.type == "cpu":
        return conv_direct_plain(planes, taps, wrap, J, ST, b, SSc, a00, scale)
    if planes.device.type != "cuda":
        raise ValueError(f"conv_direct runs on cpu or cuda tensors, not {planes.device}")
    if any(t.dtype != torch.float64 for t in [planes, taps] + extras):
        raise TypeError("the K9 kernel is the float64 route's; got "
                        f"{[t.dtype for t in [planes, taps] + extras]}")
    from sfft_tpu_torch import _kernels

    planes, taps = planes.contiguous(), taps.contiguous()
    J, ST, b, SSc, a00 = (None if t is None else t.contiguous() for t in (J, ST, b, SSc, a00))
    out = torch.empty((N0, N1), dtype=torch.float64, device=planes.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(planes.device):
        err = _kernels.lib().sfft_conv_direct(
            planes.data_ptr(), taps.data_ptr(), ptr(J), ptr(ST), ptr(b), ptr(SSc), ptr(a00),
            out.data_ptr(), F_, H, W, L0, L1, int(wrap), N0, N1,
            0 if ST is None else ST.shape[0], 0 if SSc is None else SSc.shape[0], float(scale),
            _kernels.stream_ptr(planes))
    _K9.launches += 1
    _kernels.check(err, "conv_direct kernel launch")
    return out


conv_direct.launches = 0
# the counter's owner: the module attribute may be replaced by a caller
# that intercepts the calls (chip_smoke.py, the tests)
_K9 = conv_direct


# the codes of conv_direct_nonfinite's second launch: a pixel's class
# (+inf, -inf, NaN) times a tap's sign (+, -, 0) lands a term of the
# difference's sum (+inf, -inf, NaN) in its own slot of the launch's f64
# output: +inf terms at 1 and 2^34, -inf at 2^17, NaN at 2^51 or more
_NF_SLOT = 2.0 ** 17
_NF_NAN = 2.0 ** 51


def conv_direct_nonfinite(planes: torch.Tensor, taps: torch.Tensor, wrap: bool = True,
                          J=None, ST=None, b=None, SSc=None, a00=None,
                          scale: float = 1.0) -> torch.Tensor:
    """``conv_direct`` for planes (and SSc) that may hold NaN or +-inf, with
    the result of sfft_tpu's grouped conv: an output pixel is NaN where a
    NaN, an inf under a zero tap or terms of both infinite signs reach it,
    +-inf where infinite terms of one sign do, and K9's value elsewhere.
    K9 takes finite planes only (``conv_direct``), so the non-finite values
    are zeroed for it, and their terms come from a second launch on the
    planes' codes (0 where finite, 1 at +inf, 2^17 at -inf, 2^51 at NaN)
    with the taps' sign codes (1, 2^17, 0 -> 2^51): every product of a code
    pair is a power of two in the slot of the term's class, and the slots'
    integer counts stay below 2^17 (F L0 L1 < 2^17 is checked), so the sum
    is exact. The scaling planes' non-finite values act pointwise (a00
    times the value). No host sync: the all-finite path runs the same
    launches and its terms are zeros."""
    F_, L0, L1 = taps.shape
    if F_ * L0 * L1 >= _NF_SLOT:
        raise ValueError(f"conv_direct_nonfinite counts {F_} x {L0} x {L1} taps, past 2^17")

    def split(x):
        # (x with its non-finite values zeroed, those values alone)
        z = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
        return z, x - z

    Pz, Pnf = split(planes)
    Sz, Snf = (None, None) if SSc is None else split(SSc)
    out = conv_direct(Pz, taps, wrap, J, ST, b, Sz, a00, scale)
    tcode = torch.where(taps > 0, 1.0, torch.where(taps < 0, _NF_SLOT, _NF_NAN))
    codes = torch.nan_to_num(Pnf, nan=_NF_NAN, posinf=1.0, neginf=_NF_SLOT)
    r = conv_direct(codes, tcode.to(planes.dtype), wrap)
    nan = r >= _NF_NAN
    hi = torch.floor(r / _NF_SLOT ** 2)
    mid = torch.floor((r - hi * _NF_SLOT ** 2) / _NF_SLOT)
    lo = r - hi * _NF_SLOT ** 2 - mid * _NF_SLOT
    pos, neg = (lo > 0) | (hi > 0), mid > 0
    T = torch.where(nan | (pos & neg), torch.nan,
                    torch.where(pos, torch.inf, torch.where(neg, -torch.inf, 0.0))).to(out.dtype)
    if SSc is not None:
        T = T + torch.tensordot(a00, Snf, dims=([0], [0]))
    return torch.where(T == 0, out, out - scale * T)


def fdiff_conv(cfg: SFFTConfig, solution: torch.Tensor, SI: torch.Tensor, ST: torch.Tensor,
               J: torch.Tensor, SSc: torch.Tensor = None, plain: bool = False) -> torch.Tensor:
    """Real-space circular-convolution difference (sfft_tpu's fdiff_conv, the
    complex-free f64 route): in the delta basis multiplying by (W^a W^b - 1)
    is shift-minus-identity, so the model is a circular convolution of the SI
    planes with the standard-basis kernel (center 2 a00 - sum_ab a_ijab):

        D = J - SCALE * sum_ij circconv(SI_ij, Astd_ij) - sum_pq b_pq ST_pq.

    SEPARATE-VARYING (SSc given, possibly only its active planes): the
    center becomes -(sum_ab a_ijab - a00) and the a00 dofs act flat on the
    SSc planes. ``conv_direct_nonfinite`` (K9 on the card; the unmasked
    image's planes may hold NaN or inf); plain=True takes K9's twin."""
    Astd, b_pq, a00 = conv_taps(cfg, solution, None if SSc is None else SSc.shape[0])
    conv = conv_direct_plain if plain else conv_direct_nonfinite
    return conv(SI, Astd, True, J, ST, b_pq, SSc, a00, cfg.SCALE)


def conv_taps(cfg: SFFTConfig, solution: torch.Tensor, nss=None):
    """fdiff_conv's operands from the solution: the standard-basis taps
    Astd (Fij, L0, L1), the background weights b_pq and, with nss scaling
    planes (SEPARATE-VARYING), their a00 weights (else None)."""
    a_ijab, b_pq = split_solution(cfg, solution)
    if nss is None:
        return standard_kernel_coeffs(cfg, a_ijab), b_pq, None
    Astd = a_ijab.clone()
    Astd[:, cfg.w0, cfg.w1] = -(a_ijab.sum(dim=(1, 2)) - a_ijab[:, cfg.w0, cfg.w1])
    return Astd, b_pq, a_ijab[:nss, cfg.w0, cfg.w1]


def _fold_weights(N1: int) -> np.ndarray:
    """Hermitian-fold weights of the half spectrum over the last axis, f32:
    2 for interior columns, 1 for DC and (N1 even) the Nyquist column."""
    fold = np.full(N1 // 2 + 1, 2.0, np.float32)
    fold[0] = 1.0
    if N1 % 2 == 0:
        fold[-1] = 1.0
    return fold


def pair_model_spectrum(cfg: SFFTConfig, sp, K, a00: torch.Tensor, s_nc: torch.Tensor,
                        nss: int, plain: bool = False):
    """The exact differences' model spectrum, shared by fdiff_exact and
    fdiff_pexact: FD = sp[0] - SCALE * sum_i sp[1+i] (K_i + c_i) (+ the
    SEPARATE-VARYING scaling planes sp[1+Fij+s] times a00_s, s < nss),
    compensated, times the Hermitian fold. Per-ij factor (reference
    Construct_FDIFF): for the ENTANGLED center dof the delta-basis term is
    a00 * 1, so c_i = a00_i - s_nc_i; SEPARATE-VARYING applies a00 to the
    scaling planes and c_i = -s_nc_i. K6m (core/pairs.py ``pair_model``, one
    launch on CUDA tensors), or its twin with plain=True. A batch (sp and K
    (B, ...), a00 and s_nc (B, Fij)) gives (B, N0, N1h) in that one
    launch."""
    from sfft_tpu_torch.core.exact_fft import _split_on

    dev = sp.rh.device
    separate_varying = cfg.scaling_mode == "SEPARATE-VARYING"
    c = -s_nc if separate_varying else a00 - s_nc
    model = pairs.pair_model_spectrum_plain if plain else pairs.pair_model
    return model(sp, K, c.to(torch.float64),
                 a00[..., :nss].to(torch.float64) if separate_varying else None,
                 _split_on(Static(np.float64, (float(cfg.SCALE),)), dev),
                 table(Static(_fold_weights, (cfg.N1,)), dev))


def fdiff_exact(cfg: SFFTConfig, solution: torch.Tensor, I: torch.Tensor, J: torch.Tensor,
                shared=None, plain: bool = False) -> torch.Tensor:
    """Exact-grade (f32 pair) difference construction, any spatial basis.

    The spectral algebra of fdiff_fft, carried in pair arithmetic with the
    sliced-integer transforms of core/exact_fft.py:
      * forward half spectra of J, SI (and SSc): exact_plane_spectra, or
        `shared` when the caller has the solve's;
      * per-ij kernel spectra K = W0 @ A_ij @ W1 as two sliced products
        against the static phase matrices;
      * the model spectrum as compensated pair Hadamard sums
        (``pair_model_spectrum``, K6m on the card);
      * the inverse transform of the Hermitian half with the weight-2 fold:
        axis 0 first at half width, then the real-only axis-1 inverse;
      * the background term exactly in image space (separable U B V^T).
    plain=True runs the plain twins of K4, K6 and K7. A batch (solution (B,
    NEQ), I and J (B, N0, N1), or `shared` of such a batch) gives (B, N0,
    N1): one set of K4 / K7 / K6 launches for the batch, the small sums and
    the background's products pair by pair, each pair's bits those of its
    single call."""
    from sfft_tpu_torch.core.exact_fft import _pmap, _swap, exact_dft_axis
    from sfft_tpu_torch.core.greek import exact_plane_spectra
    from sfft_tpu_torch.core.peel import _each

    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    if shared is None:
        shared = exact_plane_spectra(I, J, cfg, plain=plain)
    _Jp, _SIp, SScp, sp = shared
    dev = sp.rh.device
    nss = len(SScp) if SScp is not None else 0
    batch = solution.shape[0] if solution.dim() == 2 else 0
    a_ijab, b_pq = split_solution(cfg, solution.to(torch.float64))

    # --- kernel spectra K_ij = W0 @ A'_ij @ W1 (center-zeroed) -------------
    a00 = a_ijab[..., w0, w1]
    s_nc = _each(lambda a: a.sum(dim=(1, 2)), a_ijab, 3) - a00
    K = kernel_spectra(cfg, a_ijab, plain=plain, batch=batch)            # (i, u, v)

    # --- model spectrum: compensated pair sum over ij, folded --------------
    FDw = pair_model_spectrum(cfg, sp, K, a00, s_nc, nss, plain=plain)

    # --- inverse transform of the Hermitian half ---------------------------
    zt = exact_dft_axis(_pmap(FDw, _swap), N0, inverse=True, plain=plain,
                        batch=batch)                                      # (N1h, N0)
    y = exact_inverse_axis1(_pmap(zt, _swap), N1, plain=plain, batch=batch)
    D = (y.rh.to(torch.float64) + y.rl) / (N0 * N1)

    # --- background term, exactly, in image space --------------------------
    return (D - _each(lambda b: background_model(cfg, b, dev), b_pq, 1)).to(J.dtype)


def kernel_spectra(cfg: SFFTConfig, a_ijab: torch.Tensor, plain: bool = False,
                   batch: int = 0):
    """The center-zeroed kernel spectra K_ij = W0 @ A'_ij @ W1 of the exact
    differences as a pair (Fij, N0, N1h): two sliced products against the
    static phase matrices. batch > 1: a_ijab (B, Fij, L0, L1) holds that
    many pairs' solutions, each sliced under its own scales (its single
    call's), giving (B, Fij, N0, N1h)."""
    return kernel_spectra_blocks(cfg, [a_ijab], [None], plain, batch)[0]


def kernel_spectra_blocks(cfg: SFFTConfig, a_list, rows_list, plain: bool = False,
                          batch: int = 0) -> list:
    """``kernel_spectra`` for frequency-row blocks: a_list, the solution's
    a_ijab on each block's device; rows_list, each block's (r0, r1), or
    None for all rows. The second product slices every block as the whole
    operand would be (core/exact_fft.py ``_cmatmul_blocks``)."""
    from sfft_tpu_torch.core.exact_fft import (NSL_STATIC, _cmatmul_blocks, _cmatmul_sliced,
                                               _pmap, _row_block, _static_big, _swap,
                                               pair_from_f64)

    w0, w1 = cfg.w0, cfg.w1
    W0 = Static(phase_matrix, (cfg, True, 0))
    W1 = Static(phase_matrix, (cfg, True, 1))
    T1s = []
    for a_ijab, rows in zip(a_list, rows_list):
        Ap = a_ijab.clone()
        Ap[..., w0, w1] = 0.0
        # T1[i, b, u] = sum_a Ap[i, a, b] W0[u, a];  K[i, u, v] = sum_b T1[i, b, u] W1[b, v]
        data = pair_from_f64(Ap.transpose(-1, -2))
        if rows is None:
            T1s.append(_cmatmul_sliced(data, Static(np.transpose, (W0,)), plain=plain,
                                       batch=batch))
        else:
            # the block's columns of W0^T, sliced as the whole table is
            T1s.append(_cmatmul_sliced(
                data, Static(np.transpose, (Static(_row_block, (W0,) + tuple(rows)),)),
                plain=plain, static_big=_static_big(Static(np.transpose, (W0,)), NSL_STATIC)))
    return _cmatmul_blocks([_pmap(T1, _swap) for T1 in T1s], W1, plain=plain, batch=batch)


def exact_inverse_axis1(z, N1: int, prof=None, plain: bool = False, batch: int = 0):
    """The real inverse over the last axis of the Hermitian half z (..., N1h),
    fold weights applied: the half-input inverse for even N1, else the full
    real-only inverse of the zero-padded half. Unscaled real pair. batch >
    1: a leading axis of that many pairs, each as its single call."""
    return exact_inverse_axis1_blocks([z], N1, prof, plain, batch)[0]


def exact_inverse_axis1_blocks(zs, N1: int, prof=None, plain: bool = False,
                               batch: int = 0) -> list:
    """``exact_inverse_axis1`` of one operand held as row blocks, each
    sliced as the whole operand would be."""
    from sfft_tpu_torch.core.exact_fft import (_pmap, exact_dft_axis_blocks,
                                               exact_idft_halfin_real_blocks)

    if N1 % 2 == 0:
        return exact_idft_halfin_real_blocks(zs, N1, prof=prof, plain=plain, batch=batch)
    zps = [_pmap(z, lambda v: torch.nn.functional.pad(v, (0, N1 - v.shape[-1]))) for z in zs]
    return exact_dft_axis_blocks(zps, N1, inverse=True, real_out=True, prof=prof, plain=plain,
                                 batch=batch)


def background_model(cfg: SFFTConfig, b_pq: torch.Tensor, device, rows=None) -> torch.Tensor:
    """The background sum_pq b_pq T_pq exactly in image space (separable
    U B V^T), f64; rows = (r0, r1) gives the image rows [r0, r1) only."""
    exps = ref_basis_exponents(cfg.bg_basis)
    U = table(Static(_bg_axis_table, (cfg, 0)), device, torch.float64)
    V = table(Static(_bg_axis_table, (cfg, 1)), device, torch.float64)
    if rows is not None:
        U = U[rows[0]:rows[1]]
    B = torch.zeros((U.shape[1], V.shape[1]), dtype=torch.float64, device=device)
    B.index_put_((index(exps[:, 0], device), index(exps[:, 1], device)), b_pq.to(device),
                 accumulate=True)
    return U @ B @ V.T


def _bg_axis_table(cfg: SFFTConfig, axis: int) -> np.ndarray:
    """1-D value table of the background basis along one axis."""
    return basis_1d_tables(cfg.bg_basis, cfg.N0, cfg.N1)[axis]


def fdiff(cfg: SFFTConfig, solution, SI, ST, J, SSc=None, I=None, shared=None,
          plain: bool = False) -> torch.Tensor:
    """The difference image for cfg.fdiff_backend. 'exact' and 'pexact' build
    their own pair planes from the image I (SI, ST and SSc unused) and may
    reuse the plane spectra of the solve (`shared`); plain=True runs the
    plain twins of their kernels."""
    if cfg.fdiff_backend == "exact":
        if I is None:
            raise ValueError("fdiff_exact needs the unmasked image I")
        return fdiff_exact(cfg, solution, I, J, shared=shared, plain=plain)
    if cfg.fdiff_backend == "pexact":
        from sfft_tpu_torch.core.pexact import fdiff_pexact

        return fdiff_pexact(cfg, solution, I, J, shared=shared, plain=plain)
    if cfg.fdiff_backend == "fft":
        return fdiff_fft(cfg, solution, SI, ST, J, SSc, plain=plain)
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
            plain=plain,
        )
        return out.to(J.dtype)
    if cfg.fdiff_backend == "conv":
        return fdiff_conv(cfg, solution, SI, ST, J, SSc, plain=plain)
    raise ValueError(f"unknown fdiff backend {cfg.fdiff_backend!r}")
