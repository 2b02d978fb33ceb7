"""Peeled + sliced exact engine: contract-grade tables at a reduced slice
depth (counterpart of sfft_tpu/core/pexact.py).

Each image splits exactly, I = P_I + F_I, with P_I a low-degree polynomial
fit (core/peel.py). Every Greek correlation then expands into

  smooth x smooth / smooth x fluct -> exact f64 moment algebra (K3)  [no FFT]
  fluct  x fluct                   -> sliced pair-FFT windows (K4),
                                      at the reduced cfg.pexact_prof

The difference (fdiff_pexact) splits the same way: the spectral model sum
runs on the fluctuation spectra, and the smooth model (the circular
convolution of polynomial planes with the fitted kernel) is closed-form
shift algebra plus wrap corrections on the <= w-wide boundary bands.

Requires polynomial kernel, background and scaling bases. Every function
takes ``plain``: True runs the plain twins of K3, K4, K6 and K7.

A batch of pairs (images (B, N0, N1), the batched step of core/engine.py)
runs through the same functions: every table, spectrum and plane gains the
leading pair axis, and each pair's bits are those of its single call. The
kernels run once for the batch (K3 per moment set, the K4 stage and K7 per
sliced product with each pair's own global scale, K6a, K6m and K6p with the
pair on their grids); the moment algebra goes through ``peel.contract``,
and the small library products whose bits change with the batch's shape
run pair by pair (``peel._each``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sfft_tpu_torch.config import SFFTConfig, torch_dtype
from sfft_tpu_torch.core import pairs
from sfft_tpu_torch.core.exact_fft import (CPair, SliceProfile, _pair_mul_static_rr, _pmap,
                                           _split_on, _swap, exact_corr_window,
                                           exact_dft_axis, exact_sep_weighted_spectra)
from sfft_tpu_torch.core.fdiff import (exact_inverse_axis1, kernel_spectra,
                                        pair_model_spectrum, split_solution,
                                        standard_kernel_coeffs)
from sfft_tpu_torch.core.indices import ref_basis_exponents
from sfft_tpu_torch.core.peel import (MomentSet, PeelGeom, _axis_field, _each,
                                      _embed_index, _exps_key, _monomial_coeffs, _t,
                                      axis_static, coord_powers, coord_powers_of,
                                      fit_poly_coeffs, moment_set, peel_geom, phi_table,
                                      poly_moment_set, polycorr, polynomial_bases,
                                      shift_moment_set)
from sfft_tpu_torch.core.statics import Static, index, table


# ---------------------------------------------------------------------------
# the polynomial plane (K6p)
# ---------------------------------------------------------------------------


def _poly_tables(C: torch.Tensor, N0: int, N1: int, r0: int = 0, r1: Optional[int] = None):
    """K6p's tables for a ScaledFortranCoor polynomial C (SP, SP) f64 over
    c0^s c1^t with c = (idx+1)/N: U = c0^s (SP, N0) and M = C @ c1^t (SP,
    N1, a tiny f64 product), each split into f32 (hi, lo). (r0, r1) keeps
    the image rows [r0, r1) of U (a row block of the sharded step). C (B,
    SP, SP), a batch of polynomials: M is each pair's own (B, SP, N1), its
    product pair by pair; U is shared."""
    SP = C.shape[-1]
    dev = C.device
    V = table(Static(coord_powers, (N1, SP, 0, N1)), dev)       # (SP, N1) f64
    M = _each(lambda c: c.to(torch.float64) @ V, C, 2)          # (SP, N1) f64
    Mh = M.to(torch.float32)
    Ml = (M - Mh.to(torch.float64)).to(torch.float32)
    Uh, Ul = _split_on(Static(coord_powers, (N0, SP, r0, N0 if r1 is None else r1)), dev)
    return Uh, Ul, Mh, Ml


def pair_poly_plane(C: torch.Tensor, N0: int, N1: int, plain: bool = False) -> CPair:
    """Grid evaluation of a ScaledFortranCoor polynomial as a real pair: the
    x-axis accumulation in f32 pair arithmetic (~2^-48 of the plane scale),
    K6p's plane mode (core/pairs.py ``pair_poly``, one launch on CUDA
    tensors), or its twin with plain=True. The paths call the fused modes
    (``pair_poly_sub``, ``pair_poly_add64``) instead."""
    return (pairs.pair_poly_plain if plain else pairs.pair_poly)(*_poly_tables(C, N0, N1))


# ---------------------------------------------------------------------------
# shared front end
# ---------------------------------------------------------------------------


def pexact_supported(cfg: SFFTConfig) -> bool:
    return polynomial_bases(cfg)


def _geom(cfg: SFFTConfig) -> PeelGeom:
    if not pexact_supported(cfg):
        raise ValueError(
            "pexact backends require polynomial kernel/background/scaling "
            "bases; B-spline configs use greek_backend='exact'")
    return peel_geom(cfg)


class PexactShared(NamedTuple):
    """What the Greek tables and the difference both consume, computed once
    per (I, J) pair (for a batch, every field with the leading pair axis)."""

    mI: torch.Tensor         # (dmu+1, dmu+1) f64 peel coeffs of I
    mJ: torch.Tensor
    momI_o: MomentSet        # raw-I exact moments, +-2w window, SG exponents
    momJ_g: MomentSet        # raw-J exact moments, +-w window
    sp: CPair                # stacked half spectra of [F_J] + F_I*beta_union


def pexact_plane_spectra(I: torch.Tensor, J: torch.Tensor, cfg: SFFTConfig,
                         plain: bool = False) -> PexactShared:
    """The moment sets, the peel fits and the fluctuation spectra of (I, J),
    or of a batch of pairs (B, N0, N1): one K3 launch per moment set, one
    K6p launch per image role and one set of K4 / K7 / K6a launches for the
    spectra, whatever B."""
    g = _geom(cfg)
    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    dt = torch_dtype(cfg.dtype)
    I = I.to(dt)
    J = J.to(dt)
    momI_o = moment_set(I, N0, N1, 2 * w0, 2 * w1, g.SG, g.ax0o, g.ax1o, plain)
    momJ_g = moment_set(J, N0, N1, w0, w1, g.SG, g.ax0g, g.ax1g, plain)
    mI = fit_poly_coeffs(momI_o.M, g.dmu, g.ax0o, g.ax1o)
    mJ = fit_poly_coeffs(momJ_g.M, g.dmu, g.ax0g, g.ax1g)
    # exact-pair fluctuations: F = pair(I) - pair-eval(P), with the same
    # coefficients the moment algebra uses; plane and subtraction in one
    # K6p launch each
    sub = pairs.pair_poly_sub_plain if plain else pairs.pair_poly_sub
    FIp = sub(I.to(torch.float64), *_poly_tables(mI, N0, N1))
    FJp = sub(J.to(torch.float64), *_poly_tables(mJ, N0, N1))
    prof = SliceProfile(*cfg.pexact_prof)
    U = Static(coord_powers_of, (N0, tuple(int(i) for i, _ in g.exps_k)))
    V = Static(coord_powers_of, (N1, tuple(int(j) for _, j in g.exps_k)))
    sp = exact_sep_weighted_spectra([FJp], FIp, U, V, prof=prof, plain=plain)
    return PexactShared(mI=mI, mJ=mJ, momI_o=momI_o, momJ_g=momJ_g, sp=sp)


# ---------------------------------------------------------------------------
# Greek tables
# ---------------------------------------------------------------------------


def pexact_greek_tables(I: torch.Tensor, J: torch.Tensor, cfg: SFFTConfig,
                        shared: Optional[PexactShared] = None, plain: bool = False,
                        window=None):
    """(Comg, Cgam, Cthe, Cphi, Cdel[, (Pbs, Pss, Pgs, Pts)]) unscaled CC
    tables: smooth-involving terms exact f64 (moment algebra), fluct x fluct
    via the sliced pair-FFT windows at cfg.pexact_prof. window(ia, jb), when
    given, returns those windows (npairs, 4w0+1, 4w1+1) for the pair list
    of the fluctuation spectra instead of ``exact_corr_window`` on
    shared.sp (the row-sharded step sums them over row blocks). I and J (B,
    N0, N1) (or `shared` of such a batch): every table with a leading pair
    axis, each pair's bits those of its single call."""
    g = _geom(cfg)
    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    dt = torch_dtype(cfg.dtype)
    SP, dmu = g.SP, g.dmu
    separate_varying = cfg.scaling_mode == "SEPARATE-VARYING"
    if shared is None:
        shared = pexact_plane_spectra(I, J, cfg, plain=plain)
    mI, mJ, momI_o, momJ_g, sp = shared
    exps_k, exps_b = g.exps_k, g.exps_b
    Fij, Fpq = len(exps_k), len(exps_b)
    ax0o, ax1o, ax0g, ax1g = g.ax0o, g.ax1o, g.ax0g, g.ax1g
    dev = mI.device
    lead = tuple(mI.shape[:-2])          # () or (B,): the pair axis

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dt, device=dev)

    def batch(x):
        # a table shared by the pairs, as each pair's own (a view)
        return x.expand(lead + tuple(x.shape)) if lead else x

    # +-w moment window is a central slice of the +-2w one
    momI_g = MomentSet(
        M=momI_o.M,
        RS=momI_o.RS[..., w0: 3 * w0 + 1, :, :],
        CS=momI_o.CS[..., w1: 3 * w1 + 1, :, :],
        CNR=momI_o.CNR[..., w0: 3 * w0 + 1, w1: 3 * w1 + 1, :, :],
    )

    # S_a coeffs: mu_I * beta_a — exponent-shifted embeddings, one scatter
    # for the batch
    PA = zeros(Fij, SP, SP)
    pk, pi, pj, ms, mt = (_t(_embed_index, (_exps_key(exps_k), dmu), mI, torch.int64)[r]
                          for r in range(5))
    PA[..., pk, pi, pj] = mI[..., ms, mt]
    mJ_pad = zeros(1, SP, SP)
    mJ_pad[..., 0, : dmu + 1, : dmu + 1] = mJ
    TQ = _t(_monomial_coeffs, (_exps_key(exps_b), SP), mI, dt)

    def fluct_mom(momG: MomentSet, mcoef, ax0, ax1) -> MomentSet:
        Q = zeros(SP, SP)
        Q[..., : dmu + 1, : dmu + 1] = mcoef
        pm = poly_moment_set(Q, (ax0.S.shape[0] - 1) // 2, (ax1.S.shape[0] - 1) // 2,
                             SP, g.SG, ax0, ax1)
        return MomentSet(M=momG.M - pm.M, RS=momG.RS - pm.RS,
                         CS=momG.CS - pm.CS, CNR=momG.CNR - pm.CNR)

    momFI_o = fluct_mom(momI_o, mI, ax0o, ax1o)
    momFI_g = fluct_mom(momI_g, mI, ax0g, ax1g)
    momFb_o = shift_moment_set(momFI_o, exps_k, SP)
    momFa_g = shift_moment_set(momFI_g, exps_k, SP)

    # --- OMG smooth terms -------------------------------------------------
    momSb_o = poly_moment_set(PA, 2 * w0, 2 * w1, SP, g.SG, ax0o, ax1o)
    SS = polycorr(PA, momSb_o, ax0o, ax1o)                 # CC(S_a, S_b)
    SF = polycorr(PA, momFb_o, ax0o, ax1o)                 # CC(S_a, F_b)
    FS = torch.flip(SF.transpose(-4, -3), dims=(-2, -1))

    # --- fluct x fluct via ONE sliced windowed-correlation pass -----------
    # (the THE window +-w is a central slice of the +-2w one)
    prof = SliceProfile(*cfg.pexact_prof)
    iu, ju = np.triu_indices(Fij)
    ia = np.concatenate([iu + 1, np.arange(Fij) + 1])
    jb = np.concatenate([ju + 1, np.zeros(Fij, np.int64)])
    if window is None:
        spec_all = _pmap(sp, lambda v: v[..., : 1 + Fij, :, :])
        cc = exact_corr_window(spec_all, spec_all, N0, N1, 2 * w0, 2 * w1,
                               pairs=(ia, jb), prof=prof, plain=plain)
    else:
        cc = window(ia, jb)
    n_omg = len(iu)
    iu_t = index(iu, dev)
    ju_t = index(ju, dev)
    FF = torch.zeros(lead + (Fij, Fij, 4 * w0 + 1, 4 * w1 + 1), dtype=cc.dtype, device=dev)
    FF[..., iu_t, ju_t, :, :] = cc[..., :n_omg, :, :]
    FF[..., ju_t, iu_t, :, :] = torch.flip(cc[..., :n_omg, :, :], dims=(-2, -1))
    FFJwin = cc[..., n_omg:, w0: 3 * w0 + 1, w1: 3 * w1 + 1]
    Comg = SS + SF + FS + FF.to(dt)

    # --- GAM: fully exact (moment algebra, no FFT at all) ------------------
    momTq = poly_moment_set(TQ, w0, w1, SP, g.SG, ax0g, ax1g)
    SS_gam = polycorr(PA, MomentSet(*(batch(t) for t in momTq)), ax0g, ax1g)  # CC(S_a, T_q)
    FT = polycorr(batch(TQ), momFa_g, ax0g, ax1g)          # CC(T_q, F_a)
    Cgam = SS_gam + torch.flip(FT.transpose(-4, -3), dims=(-2, -1))

    # --- THE ---------------------------------------------------------------
    SJ = polycorr(PA, momJ_g, ax0g, ax1g)                  # CC(S_a, J) exact
    FSJ = torch.flip(polycorr(mJ_pad, momFa_g, ax0g, ax1g)[..., 0, :, :, :], dims=(-2, -1))
    Cthe = SJ + FSJ + FFJwin.to(dt)

    # --- PHI / DEL: closed form --------------------------------------------
    Cphi = batch(table(Static(phi_table, (ax0g.args, ax1g.args, _exps_key(exps_b))), dev, dt))
    bi, bj = (_t(np.array, (tuple(exps_b[:, r]),), mI, torch.int64) for r in range(2))
    Cdel = momJ_g.M[..., bi, bj]

    if not separate_varying:
        return Comg, Cgam, Cthe, Cphi, Cdel

    # --- union tables -> SEPARATE-VARYING blocks (as in core/peel.py) ------
    Fk = g.Fk_only
    win0 = slice(w0, 3 * w0 + 1)
    win1 = slice(w1, 3 * w1 + 1)
    Pbs = Comg[..., :Fk, Fk:, win0, win1]
    Pss = Comg[..., Fk:, Fk:, 2 * w0, 2 * w1]
    Pgs = Cgam[..., Fk:, :, w0, w1]
    Pts = Cthe[..., Fk:, w0, w1]

    def pad_k(x, axes):
        # axes count after the pair axis
        shape = list(x.shape)
        for ax in axes:
            shape[len(lead) + ax] = Fk
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
        out[tuple(slice(0, n) for n in x.shape)] = x
        return out

    extra = (pad_k(Pbs, [1]), pad_k(Pss, [0, 1]), pad_k(Pgs, [0]), pad_k(Pts, [0]))
    return (Comg[..., :Fk, :Fk, :, :], Cgam[..., :Fk, :, :, :], Cthe[..., :Fk, :, :], Cphi, Cdel,
            extra)


# ---------------------------------------------------------------------------
# difference construction
# ---------------------------------------------------------------------------


def fdiff_pexact(cfg: SFFTConfig, solution: torch.Tensor, I: torch.Tensor,
                 J: torch.Tensor, shared: Optional[PexactShared] = None,
                 plain: bool = False) -> torch.Tensor:
    """Exact-grade difference via the peel split.

    D = J - SCALE * sum_ij circconv(I * beta_ij, Astd_ij) - bg. With
    I = P_I + F_I, J = P_J + F_J: the fluct part is the spectral model sum on
    the fluctuation spectra, inverse-transformed at the same profile; the
    smooth part is one polynomial evaluated in pair arithmetic plus f64
    wrap-correction strips. Reference semantics: Construct_FDIFF
    (sfft/sfftcore/SFFTSubtract.py:771-816) and its SEPARATE-VARYING variant
    (sfft/BSplineSFFT.py:2430-2528). A batch (solution (B, NEQ), I and J
    (B, N0, N1)) gives (B, N0, N1), each pair's bits those of its single
    call."""
    g = _geom(cfg)
    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    dt = torch_dtype(cfg.dtype)
    prof = SliceProfile(*cfg.pexact_prof)
    if shared is None:
        shared = pexact_plane_spectra(I, J, cfg, plain=plain)
    mI, mJ, _momI_o, _momJ_g, sp = shared
    solution = solution.to(dt)
    batch = solution.shape[0] if solution.dim() == 2 else 0
    Fs = len(g.exps_k) - g.Fk_only   # union scaling planes (0 if ENTANGLED)

    a_ijab, _ = split_solution(cfg, solution)
    a00 = a_ijab[..., w0, w1]
    s_nc = _each(lambda a: a.sum(dim=(1, 2)), a_ijab, 3) - a00

    # --- spectral fluct model (on the fluct spectra) -----------------------
    K = kernel_spectra(cfg, a_ijab, plain=plain, batch=batch)           # (i, u, v)

    # the model spectrum, FD = sp[0] - SCALE * sum (compensated), folded
    FDw = pair_model_spectrum(cfg, sp, K, a00, s_nc, Fs, plain=plain)

    # inverse of the Hermitian half: axis 0 first at half width, then the
    # real-only axis-1 inverse
    zt = exact_dft_axis(_pmap(FDw, _swap), N0, inverse=True, prof=prof, plain=plain,
                        batch=batch)
    y = exact_inverse_axis1(_pmap(zt, _swap), N1, prof=prof, plain=plain, batch=batch)
    Dfl = _pair_mul_static_rr(y, Static(np.float64, (1.0 / (N0 * N1),)), plain)
    return pexact_smooth_model(cfg, solution, mI, mJ, Dfl, plain=plain).to(J.dtype)


def _smooth_terms(cfg: SFFTConfig, g: PeelGeom, solution: torch.Tensor, mI: torch.Tensor,
                  mJ: torch.Tensor, dev):
    """One pair's smooth model in closed form: the main polynomial's
    coefficients Ctot (SPt, SPt) and the lag tables (Gx, Gy, Gc) of its
    wrap corrections, from the solution and the peel fits (tiny f64
    algebra, run pair by pair: torch.einsum's products change a pair's
    bits with a batch's shape)."""
    w0, w1 = cfg.w0, cfg.w1
    dt = torch_dtype(cfg.dtype)
    separate_varying = cfg.scaling_mode == "SEPARATE-VARYING"
    Fk = g.Fk_only
    a_ijab, b_pq = split_solution(cfg, solution)
    a00 = a_ijab[:, w0, w1]
    s_nc = a_ijab.sum(dim=(1, 2)) - a00

    dmu, dk = g.dmu, cfg.kernel_basis.degree
    ds = cfg.scaling_basis.degree if separate_varying else 0
    db = cfg.bg_basis.degree
    SPc = dmu + dk + 1                      # conv coeff exponents per axis
    SPt = max(SPc, dmu + ds + 1, db + 1)    # total smooth poly exponents
    axs0 = axis_static(cfg.N0, w0, SPc, 2 * SPc + 2)
    axs1 = axis_static(cfg.N1, w1, SPc, 2 * SPc + 2)

    def T(build, *args):
        return table(Static(build, args), dev, torch.float64)

    S0, D0 = T(_axis_field, axs0.args, "S"), T(_axis_field, axs0.args, "D")
    S1, D1 = T(_axis_field, axs1.args, "S"), T(_axis_field, axs1.args, "D")

    exps_kk = ref_basis_exponents(cfg.kernel_basis)
    Cij = torch.zeros((Fk, SPc, SPc), dtype=dt, device=dev)
    for k, (i, j) in enumerate(exps_kk):
        Cij[k, i: i + dmu + 1, j: j + dmu + 1] = mI
    if separate_varying:
        # non-center offsets act on I*beta with effective center -(sum-a00)
        Astd = a_ijab.clone()
        Astd[:, w0, w1] = -s_nc
    else:
        Astd = standard_kernel_coeffs(cfg, a_ijab)
    Cab = torch.einsum("iab,ist->abst", Astd, Cij)             # (L0, L1, SPc, SPc)
    Cm = torch.einsum("asu,abst,btv->uv", S0, Cab, S1)
    Gx = torch.einsum("asu,abst,btv->auv", D0, Cab, S1)        # (L0, SPc, SPc)
    Gy = torch.einsum("asu,abst,btv->buv", S0, Cab, D1)        # (L1, SPc, SPc)
    Gc = torch.einsum("asu,abst,btv->abuv", D0, Cab, D1)

    # total main polynomial: P_J - SCALE*conv_main - bg (- SCALE*a00.P*sigma)
    s = cfg.SCALE
    Ctot = torch.zeros((SPt, SPt), dtype=dt, device=dev)
    Ctot[: dmu + 1, : dmu + 1] += mJ
    Ctot[:SPc, :SPc] += -s * Cm
    Bbg = torch.zeros((SPt, SPt), dtype=dt, device=dev)
    Bbg[index(g.exps_b[:, 0], dev), index(g.exps_b[:, 1], dev)] += b_pq
    Ctot = Ctot - Bbg
    if separate_varying:
        exps_s = ref_basis_exponents(cfg.scaling_basis)
        for k, (i, j) in enumerate(exps_s):
            Ctot[i: i + dmu + 1, j: j + dmu + 1] += -s * a00[k] * mI
    return Ctot, Gx, Gy, Gc


def _wrap_strips(cfg: SFFTConfig, g: PeelGeom, D: torch.Tensor, Gx, Gy, Gc, row0: int, dev):
    """Add one pair's f64 wrap-correction strips to its plane D (its image
    rows [row0, row0 + rows)), in place."""
    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    SPc = g.dmu + cfg.kernel_basis.degree + 1
    s = cfg.SCALE
    r1 = row0 + D.shape[0]

    def T(build, *args):
        return table(Static(build, args), dev, torch.float64)

    def pows(N, lo, hi):
        # (hi - lo, SPc): c^u over rows x in [lo, hi)
        return T(np.transpose, Static(coord_powers, (N, SPc, lo, hi)))

    U_top, U_bot = pows(N0, 0, w0), pows(N0, N0 - w0, N0)
    V_left, V_right = pows(N1, 0, w1), pows(N1, N1 - w1, N1)
    P0, P1 = pows(N0, row0, r1), pows(N1, 0, N1)

    def rcumsum(x, dim):
        return torch.flip(torch.cumsum(torch.flip(x, dims=(dim,)), dim=dim), dims=(dim,))

    def add_rows(lo, corr, cols=slice(None)):
        # D[image rows lo.., cols] += -s * corr, for the rows this block holds
        a, b = max(lo, row0), min(lo + corr.shape[0], r1)
        if a < b:
            D[a - row0:b - row0, cols] += -s * corr[a - lo:b - lo]

    if w0:
        # top rows x in [0, w0): lags a > x  -> suffix-cum over Gx[w0+1:]
        corr_top = torch.einsum("xu,xuv,yv->xy", U_top, rcumsum(Gx[w0 + 1:], 0), P1)
        # bottom rows x = N0-w0+xi: lags a <= -(w0-xi) -> prefix-cum Gx[:w0]
        corr_bot = torch.einsum("xu,xuv,yv->xy", U_bot, torch.cumsum(Gx[:w0], dim=0), P1)
        add_rows(0, corr_top)
        add_rows(N0 - w0, corr_bot)
    if w1:
        corr_l = torch.einsum("xu,yuv,yv->xy", P0, rcumsum(Gy[w1 + 1:], 0), V_left)
        corr_r = torch.einsum("xu,yuv,yv->xy", P0, torch.cumsum(Gy[:w1], dim=0), V_right)
        D[:, :w1] += -s * corr_l
        D[:, N1 - w1:] += -s * corr_r
    if w0 and w1:
        def cum2(block, rev0, rev1):
            b = rcumsum(block, 0) if rev0 else torch.cumsum(block, dim=0)
            return rcumsum(b, 1) if rev1 else torch.cumsum(b, dim=1)

        corners = [
            (slice(None, w0), slice(None, w1), Gc[w0 + 1:, w1 + 1:], True, True,
             U_top, V_left),
            (slice(None, w0), slice(N1 - w1, None), Gc[w0 + 1:, :w1], True, False,
             U_top, V_right),
            (slice(N0 - w0, None), slice(None, w1), Gc[:w0, w1 + 1:], False, True,
             U_bot, V_left),
            (slice(N0 - w0, None), slice(N1 - w1, None), Gc[:w0, :w1], False, False,
             U_bot, V_right),
        ]
        for sx, sy, blk, rev0, rev1, Ux, Vy in corners:
            corr = torch.einsum("xu,xyuv,yv->xy", Ux, cum2(blk, rev0, rev1), Vy)
            add_rows(0 if sx.start is None else sx.start, corr, sy)


def pexact_smooth_model(cfg: SFFTConfig, solution: torch.Tensor, mI: torch.Tensor,
                        mJ: torch.Tensor, Dfl: CPair, row0: int = 0,
                        plain: bool = False) -> torch.Tensor:
    """fdiff_pexact's smooth part: the fluctuation difference Dfl (a real
    pair) plus the main polynomial's plane in one f64 materialisation (K6p
    add64), then the f64 wrap-correction strips. Dfl may be a row block of
    the image, its rows [row0, row0 + rows); returns f64 of Dfl's shape. A
    batch (solution (B, NEQ), mI and mJ (B, ...), Dfl (B, rows, N1)): the
    closed-form algebra and the strips pair by pair, one K6p launch for the
    batch."""
    g = _geom(cfg)
    dev = mI.device
    solution = solution.to(torch_dtype(cfg.dtype))
    n = Dfl.rh.shape[-2]
    if solution.dim() == 1:
        Ctot, *lags = _smooth_terms(cfg, g, solution, mI, mJ, dev)
        lags = [lags]
    else:
        terms = [_smooth_terms(cfg, g, *x, dev) for x in zip(solution, mI, mJ)]
        Ctot = torch.stack([t[0] for t in terms])
        lags = [t[1:] for t in terms]
    # fluct + the main polynomial's plane in pair arithmetic, ONE f64
    # materialisation: one K6p launch (for a batch too)
    add64 = pairs.pair_poly_add64_plain if plain else pairs.pair_poly_add64
    D = add64(Dfl, *_poly_tables(Ctot, cfg.N0, cfg.N1, row0, row0 + n))
    # --- wrap-correction strips (f64, tiny) ---------------------------------
    for Dk, (Gx, Gy, Gc) in zip([D] if solution.dim() == 1 else D, lags):
        _wrap_strips(cfg, g, Dk, Gx, Gy, Gc, row0, dev)
    return D
