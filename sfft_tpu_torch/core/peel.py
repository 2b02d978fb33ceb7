"""Smooth/fluctuation-peeled Greek assembly (counterpart of
sfft_tpu/core/peel.py), polynomial bases; B-spline bases dispatch to the
piecewise peel of core/peel_pw.py.

Each input image splits exactly as I = P_I + F_I, with P_I a low-degree
polynomial fit. Every Greek correlation CC(I*beta_a, I*beta_b)[lag] expands
into

  poly x poly   -> closed form in static grid power sums            [exact f64]
  poly x fluct  -> weighted moments of the fluctuation image        [exact f64]
  fluct x fluct -> windowed FFT correlation of small-magnitude data [fluct dtype]

so only fluct x fluct carries finite FFT precision, and its error stays at
the scale of the cancelled normal-equation entries. Circular wrap-around of
shifted polynomials is exact: lags are bounded by 2*w, so wrap corrections
involve moments over boundary bands and corners only. Everything
data-dependent on the f64 side reduces to one moment set per input image,
whose full-image moments are the skinny f64 contraction of the K3 kernel
(core/moments.py); fluct x fluct goes through core/greek.corr_window_fft,
which runs K1 on CUDA tensors.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sfft_tpu_torch.config import SFFTConfig, torch_dtype
from sfft_tpu_torch.core.greek import corr_window_fft, rfft2_pairs
from sfft_tpu_torch.core.indices import ref_basis_exponents
from sfft_tpu_torch.core.moments import moments
from sfft_tpu_torch.core.statics import Static, table


def _exact_skinny_matmul(P0: torch.Tensor, G: torch.Tensor,
                         plain: bool = False) -> torch.Tensor:
    """P0 @ G to full f64 accuracy: every f64 product goes through the
    moments wrapper (K3 on CUDA tensors, whatever the size; W @ G on CPU
    tensors). plain=True, or a non-f64 G, takes the plain matmul. G may
    carry a leading pair axis (B, N0, N1): one K3 launch for the batch."""
    if G.dtype == torch.float64 and not plain:
        return moments(P0.contiguous(), G.contiguous())
    return _each(lambda g: P0 @ g, G, 2)


def _each(fn, x: torch.Tensor, ndim: int) -> torch.Tensor:
    """fn of one pair's operand x (`ndim` dimensions), or pair by pair over
    a leading pair axis: a library product with a long contraction (cuBLAS
    picks its split of the contraction by the whole shape, so a batched
    product changes a pair's bits on the card) runs as in the single call."""
    if x.dim() == ndim:
        return fn(x)
    return torch.stack([fn(v) for v in x])


# --------------------------------------------------------------------------
# static host-side tensors (exact numpy, cached per geometry)
# --------------------------------------------------------------------------


class AxisStatic(NamedTuple):
    c: np.ndarray        # (N,) scaled coords (x+1)/N
    ps: np.ndarray       # (EMAX+1,) power sums  sum_x c^a
    pref: np.ndarray     # (wmax+1, EMAX+1) prefix sums over x <  r
    suff: np.ndarray     # (wmax+1, EMAX+1) suffix sums over x >= N-r
    S: np.ndarray        # (R, SP, SP) shift matrices for main term
    D: np.ndarray        # (R, SP, SP) wrap-correction delta shift matrices
    lags: np.ndarray     # (R,) lag values -w..w
    args: tuple          # (N, w, SP, EMAX): what built it, the key of its device copies


def _shiftmat(h: float, SP: int) -> np.ndarray:
    """M[s, a] = binom(s, a) * h^(s-a): coeffs of P(c + h) from coeffs of P(c)."""
    from math import comb

    M = np.zeros((SP, SP))
    for s in range(SP):
        for a in range(s + 1):
            M[s, a] = comb(s, a) * h ** (s - a)
    return M


@lru_cache(maxsize=128)
def axis_static(N: int, w: int, SP: int, EMAX: int) -> AxisStatic:
    c = (np.arange(N, dtype=np.float64) + 1.0) / N
    powers = np.stack([c**a for a in range(EMAX + 1)])  # (EMAX+1, N)
    ps = powers.sum(axis=1)
    pref = np.zeros((w + 1, EMAX + 1))
    suff = np.zeros((w + 1, EMAX + 1))
    for r in range(1, w + 1):
        pref[r] = powers[:, :r].sum(axis=1)
        suff[r] = powers[:, N - r :].sum(axis=1)
    lags = np.arange(-w, w + 1)
    S = np.stack([_shiftmat(-l / N, SP) for l in lags])
    D = np.zeros_like(S)
    for k, l in enumerate(lags):
        if l > 0:
            D[k] = _shiftmat(-l / N + 1.0, SP) - S[k]
        elif l < 0:
            D[k] = _shiftmat(-l / N - 1.0, SP) - S[k]
    return AxisStatic(c=c, ps=ps, pref=pref, suff=suff, S=S, D=D, lags=lags,
                      args=(N, w, SP, EMAX))


def _axis_field(args: tuple, name: str) -> np.ndarray:
    return getattr(axis_static(*args), name)


def coord_powers(N: int, npow: int, lo: int, hi: int) -> np.ndarray:
    """(npow, hi - lo): c^a over the scaled coordinates c = (x+1)/N,
    x in [lo, hi)."""
    c = (np.arange(N, dtype=np.float64) + 1.0) / N
    return np.stack([c[lo:hi] ** a for a in range(npow)])


def coord_powers_of(N: int, exps: tuple) -> np.ndarray:
    """(len(exps), N): c^e for each exponent e."""
    c = (np.arange(N, dtype=np.float64) + 1.0) / N
    return np.stack([c ** int(e) for e in exps])


def _ps_table(args: tuple, SG: int, SP: int) -> np.ndarray:
    """(SG, SP) power sums ps[s + u]."""
    idx = np.arange(SG)[:, None] + np.arange(SP)[None, :]
    return axis_static(*args).ps[idx]


def _strip_sums(args: tuple, w: int, SG: int, SP: int) -> np.ndarray:
    """(2w+1, SG, SP) strip power sums per lag: prefix sums over x < l for
    l > 0, suffix sums over x >= N-|l| for l < 0, zero at l = 0."""
    ax = axis_static(*args)
    idx = np.arange(SG)[:, None] + np.arange(SP)[None, :]
    pr = np.zeros((2 * w + 1, SG, SP))
    for k, l in enumerate(range(-w, w + 1)):
        if l > 0:
            pr[k] = ax.pref[l][idx]
        elif l < 0:
            pr[k] = ax.suff[-l][idx]
    return pr


# --------------------------------------------------------------------------
# device-side moment sets
# --------------------------------------------------------------------------


class MomentSet(NamedTuple):
    """Exact f64 moment data of one image G, sufficient to evaluate
    CC(P, G)[rho, eps] for any poly P with per-axis degree < SP and
    |rho| <= w0, |eps| <= w1."""

    M: torch.Tensor    # (SG, SG) full moments sum cx^a cy^b G
    RS: torch.Tensor   # (R0, SG, SG) row-strip moments per rho (0 at rho=0)
    CS: torch.Tensor   # (R1, SG, SG) col-strip moments per eps
    CNR: torch.Tensor  # (R0, R1, SG, SG) corner moments


def _t(build, args: tuple, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """The static table build(*args) as a tensor on `like`'s device (dtype
    defaults to like's), built and uploaded once (core/statics.py)."""
    return table(Static(build, args), like.device, dtype or like.dtype)


def moment_set(
    G: torch.Tensor, N0: int, N1: int, w0: int, w1: int, SG: int,
    ax0: AxisStatic, ax1: AxisStatic, plain: bool = False, row0: int = 0,
) -> MomentSet:
    """Compute the moment set of image G on its device (exact f64).

    G may be a row block of the (N0, N1) image: its rows are the image's
    rows [row0, row0 + G.shape[-2]), and the result is that block's share,
    so that the shares of all blocks sum to the image's moment set (the
    row-sharded step, parallel/sharded_fft.py). G (B, n, N1) is a batch of
    images (the batched step): the set's tensors gain the leading pair
    axis, each pair's bits those of its single call."""
    dt, dev = G.dtype, G.device
    lead = tuple(G.shape[:-2])
    n = G.shape[-2]
    P0 = _t(coord_powers, (N0, SG, row0, row0 + n), G)  # (SG, n)
    P1 = _t(coord_powers, (N1, SG, 0, N1), G)  # (SG, N1)
    R0, R1 = 2 * w0 + 1, 2 * w1 + 1

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dt, device=dev)

    def rows_of(lo, hi):
        # the image rows [lo, hi) as far as G holds them (zero rows elsewhere)
        a, b = max(lo, row0), min(hi, row0 + n)
        if (a, b) == (lo, hi):
            return G[..., lo - row0: hi - row0, :]
        out = zeros(hi - lo, G.shape[-1])
        if a < b:
            out[..., a - lo: b - lo, :] = G[..., a - row0: b - row0, :]
        return out

    # full moments: (SG, N0) @ (N0, N1) @ (N1, SG)
    M = _each(lambda m: m @ P1.T, _exact_skinny_matmul(P0, G, plain), 2)

    # row strips: rows [0, w0) and [N0-w0, N0)
    G_top, G_bot = rows_of(0, w0), rows_of(N0 - w0, N0)
    rowmom_top = _each(lambda g: g @ P1.T, G_top, 2) if w0 else zeros(0, SG)   # (w0, SG)
    rowmom_bot = _each(lambda g: g @ P1.T, G_bot, 2) if w0 else zeros(0, SG)
    cx_top = _t(coord_powers, (N0, SG, 0, w0), G)        # (SG, w0)
    cx_bot = _t(coord_powers, (N0, SG, N0 - w0, N0), G)
    top_terms = cx_top[:, :, None] * rowmom_top[..., None, :, :]   # (SG, w0, SG)
    bot_terms = cx_bot[:, :, None] * rowmom_bot[..., None, :, :]
    top_pref = torch.cumsum(top_terms, dim=-2)                   # sum_{x<rho}
    bot_suff = torch.cumsum(torch.flip(bot_terms, dims=(-2,)), dim=-2)  # sum_{x>=N0-|rho|}
    RS = zeros(R0, SG, SG)
    if w0:
        # rho = 1..w0 -> index w0+rho ; strip x in [0, rho)
        RS[..., w0 + 1:, :, :] = top_pref.movedim(-2, -3)
        # rho = -1..-w0 -> index w0+rho ; strip x in [N0-|rho|, N0)
        RS[..., :w0, :, :] = torch.flip(bot_suff.movedim(-2, -3), dims=(-3,))

    colmom_l = _each(lambda g: P0 @ g[:, :w1], G, 2) if w1 else zeros(SG, 0)   # (SG, w1)
    colmom_r = _each(lambda g: P0 @ g[:, N1 - w1:], G, 2) if w1 else zeros(SG, 0)
    cy_l = _t(coord_powers, (N1, SG, 0, w1), G)
    cy_r = _t(coord_powers, (N1, SG, N1 - w1, N1), G)
    l_terms = colmom_l[..., :, None, :] * cy_l[None, :, :]         # (SG, SG, w1)
    r_terms = colmom_r[..., :, None, :] * cy_r[None, :, :]
    l_pref = torch.cumsum(l_terms, dim=-1)
    r_suff = torch.cumsum(torch.flip(r_terms, dims=(-1,)), dim=-1)
    CS = zeros(R1, SG, SG)
    if w1:
        CS[..., w1 + 1:, :, :] = l_pref.movedim(-1, -3)
        CS[..., :w1, :, :] = torch.flip(r_suff.movedim(-1, -3), dims=(-3,))

    # corners: region x in strip(rho), y in strip(eps) — four corner blocks
    CNR = zeros(R0, R1, SG, SG)
    if w0 and w1:
        blocks = {
            (False, False): G_top[..., :, :w1],
            (False, True): G_top[..., :, N1 - w1:],
            (True, False): G_bot[..., :, :w1],
            (True, True): G_bot[..., :, N1 - w1:],
        }
        for (f0, f1), blk in blocks.items():
            cxp = cx_bot if f0 else cx_top
            cyp = cy_r if f1 else cy_l
            # T[a, x, y, b], then a 2D prefix over the strip rows / cols
            T = cxp[:, :, None, None] * blk[..., None, :, :, None] * cyp.T[None, None, :, :]
            if f0:
                T = torch.flip(T, dims=(-3,))
            if f1:
                T = torch.flip(T, dims=(-2,))
            pre = torch.cumsum(torch.cumsum(T, dim=-3), dim=-2)   # (SG, w0, w1, SG)
            # pre[a, k0, k1, b] = moments over |strip|=k0+1, |strip|=k1+1
            sub = pre.movedim((-3, -2), (-4, -3))  # (w0, w1, SG, SG)
            # lag index of strip depth k: w+1+k for positive lags, w-1-k for
            # negative ones (a reversed range: flip the depth axis)
            if f0:
                sub = torch.flip(sub, dims=(-4,))
            if f1:
                sub = torch.flip(sub, dims=(-3,))
            rows = slice(0, w0) if f0 else slice(w0 + 1, R0)
            cols = slice(0, w1) if f1 else slice(w1 + 1, R1)
            CNR[..., rows, cols, :, :] = sub
    return MomentSet(M=M, RS=RS, CS=CS, CNR=CNR)


def contract(spec: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """einsum(spec, x, y) of two operands ("...ab,bc->...ac": '...' the
    same leading axes on the output and on the operands that have them), as
    one broadcast product and one sum over the contracted letters, which lie
    innermost and contiguous in the product. Every output element sums its
    own products in one order whatever the leading axes hold: a pair's bits
    do not depend on the batch around it, where a library product's do
    (cuBLAS and MKL pick their kernels and splits by the whole shape)."""
    ins, out = spec.split("->")
    specs = ins.split(",")
    body = out.replace("...", "")
    summed = sorted({c for t in specs for c in t.replace("...", "")} - set(body))
    order = body + "".join(summed)
    lead = max(t.dim() - len(sp.replace("...", "")) for t, sp in zip((x, y), specs))

    def view(t, sp):
        letters = sp.replace("...", "")
        extra = t.dim() - len(letters)
        t = t.permute(list(range(extra)) + [extra + letters.index(c) for c in order
                                            if c in letters])
        shape = [1] * (lead - extra) + list(t.shape[:extra])
        it = iter(t.shape[extra:])
        shape += [next(it) if c in letters else 1 for c in order]
        return t.reshape(shape)

    prod = view(x, specs[0]) * view(y, specs[1])
    if not summed:
        return prod
    return prod.sum(dim=tuple(range(-len(summed), 0)))


def poly_moment_set(
    Q: torch.Tensor, w0: int, w1: int, SP: int, SG: int,
    ax0: AxisStatic, ax1: AxisStatic,
) -> MomentSet:
    """MomentSet of a *polynomial* plane with coeff stack Q[..., u2, v2]
    (exponents < SP), from static power/prefix sums — no grid work.

    Supports leading batch axes on Q (``contract``: a batch's bits are
    those of its members' single calls).
    """
    ps0 = _t(_ps_table, (ax0.args, SG, SP), Q)          # (SG, SP)
    ps1 = _t(_ps_table, (ax1.args, SG, SP), Q)
    pr0 = _t(_strip_sums, (ax0.args, w0, SG, SP), Q)    # (R0, SG, SP)
    pr1 = _t(_strip_sums, (ax1.args, w1, SG, SP), Q)

    Qa = contract("...uv,au->...av", Q, ps0)           # sum over u
    Qr = contract("...uv,rau->...rav", Q, pr0)
    M = contract("...av,bv->...ab", Qa, ps1)
    RS = contract("...rav,bv->...rab", Qr, ps1)
    CS = contract("...av,ebv->...eab", Qa, pr1)
    CNR = contract("...rav,ebv->...reab", Qr, pr1)
    return MomentSet(M=M, RS=RS, CS=CS, CNR=CNR)


def polycorr(
    P: torch.Tensor, mom: MomentSet, ax0: AxisStatic, ax1: AxisStatic
) -> torch.Tensor:
    """CC(poly(P), G)[rho, eps] from G's moment set. Batched:
    P: (..., A, SP, SP) poly coeffs ('...': a pair axis, the batched step);
    the mom tensors carry the same leading axes and then their own batch
    axis ('b'), or none. Returns (..., A, [b,] R0, R1); each pair's bits
    are those of its single call (``contract``)."""
    S0 = _t(_axis_field, (ax0.args, "S"), P)
    D0 = _t(_axis_field, (ax0.args, "D"), P)
    S1 = _t(_axis_field, (ax1.args, "S"), P)
    D1 = _t(_axis_field, (ax1.args, "D"), P)
    squeeze = mom.M.dim() == P.dim() - 1
    if squeeze:  # add singleton mom batch
        mom = MomentSet(*(t.unsqueeze(P.dim() - 3) for t in mom))
    # moment sets may carry more exponents (SG) than the poly side needs (SP)
    SP = S0.shape[1]
    Mm, RS, CS, CNR = (t[..., :SP, :SP] for t in mom)
    PS = contract("...ast,rsu->...atru", P, S0)         # sum over s
    PD = contract("...ast,rsu->...atru", P, D0)
    out = (
        contract("...aruev,...buv->...abre", contract("...atru,etv->...aruev", PS, S1), Mm)
        + contract("...aruev,...bruv->...abre", contract("...atru,etv->...aruev", PD, S1), RS)
        + contract("...aruev,...beuv->...abre", contract("...atru,etv->...aruev", PS, D1), CS)
        + contract("...aruev,...breuv->...abre", contract("...atru,etv->...aruev", PD, D1), CNR)
    )
    if squeeze:
        out = out.squeeze(P.dim() - 2)
    return out


def shift_moment_set(mom: MomentSet, exps: np.ndarray, SP: int) -> MomentSet:
    """Moment sets of G*beta_k planes from the moment set of G:
    moments of cx^i cy^j G are exponent-shifted moments of G.
    exps: (F, 2) monomial exponents. Output tensors gain an F axis (after a
    leading pair axis, when mom.M has one), truncated to SP exponent
    entries."""
    at = mom.M.dim() - 2

    def shifted(t):
        return torch.stack([t[..., i: i + SP, j: j + SP] for (i, j) in exps], dim=at)

    return MomentSet(*(shifted(t) for t in mom))


def fit_poly_coeffs(
    M: torch.Tensor, deg: int, ax0: AxisStatic, ax1: AxisStatic, ridge: float = 1e-9
) -> torch.Tensor:
    """Least-squares polynomial fit of an image from its exact moments.

    Solves the tiny normal system Gram @ m = rhs where Gram[st, uv] =
    sum cx^(s+u) cy^(t+v) (static, inverted on the host) and rhs = M[s, t]
    (on the device; no host round trip). Exactness of the peel does NOT
    depend on fit quality, so a small ridge keeps the (Hilbert-like) system
    tame. Returns (deg+1, deg+1) tensor coeffs (total-degree mask); M with
    a leading pair axis (B, SG, SG) gives (B, deg+1, deg+1)."""
    exps = _fit_exponents(deg)
    args = (ax0.args, ax1.args, deg, ridge)
    dd = _t(_fit_gram, args + ("d",), M)
    inv = _t(_fit_gram, args + ("inv",), M)
    st = _t(np.array, (tuple(zip(*exps)),), M, torch.int64)     # (2, n)
    rhs = M[..., st[0], st[1]] / dd
    sol = _each(lambda r: inv @ r, rhs, 1) / dd   # a batched product differs (MKL)
    out = torch.zeros(tuple(M.shape[:-2]) + (deg + 1, deg + 1), dtype=M.dtype, device=M.device)
    out[..., st[0], st[1]] = sol
    return out


def _fit_exponents(deg: int):
    return [(s, t) for s in range(deg + 1) for t in range(deg + 1 - s)]


def _fit_gram(ax0args: tuple, ax1args: tuple, deg: int, ridge: float, part: str):
    """The fit's static tables: "d" the square roots of the Gram diagonal,
    "inv" the inverse of the scaled, ridged Gram matrix."""
    ps0 = axis_static(*ax0args).ps
    ps1 = axis_static(*ax1args).ps
    exps = _fit_exponents(deg)
    n = len(exps)
    G = np.zeros((n, n))
    for a, (s, t) in enumerate(exps):
        for b, (u, v) in enumerate(exps):
            G[a, b] = ps0[s + u] * ps1[t + v]
    d = np.sqrt(np.diag(G))
    if part == "d":
        return d
    return np.linalg.inv(G / np.outer(d, d) + ridge * np.eye(n))


# --------------------------------------------------------------------------
# the peeled Greek backend
# --------------------------------------------------------------------------


def _exps_key(exps: np.ndarray) -> tuple:
    return tuple((int(i), int(j)) for i, j in exps)


def phi_table(ax0args: tuple, ax1args: tuple, exps_b: tuple) -> np.ndarray:
    """PHI = CC(T_p, T_q)[0]: products of the static power sums."""
    ps0 = axis_static(*ax0args).ps
    ps1 = axis_static(*ax1args).ps
    return np.array([[float(ps0[i1 + i2] * ps1[j1 + j2]) for (i2, j2) in exps_b]
                     for (i1, j1) in exps_b])


class PeelShared(NamedTuple):
    """What peeled_greek_tables consumes of the images: the raw-image moment
    sets (I at the +-2w window, J at +-w; ``MomentSet``, or ``PWMoments``
    for B-spline bases) and the peel fits computed from them (the
    row-sharded step sums the blocks' moment sets)."""

    momI_o: MomentSet
    momJ_g: MomentSet
    mI: torch.Tensor
    mJ: torch.Tensor


class PeelGeom(NamedTuple):
    """The peel's geometry of a polynomial-basis config (peeled and pexact)."""

    exps_k: np.ndarray       # the union kernel(+scaling) exponents (Fij_u, 2)
    exps_b: np.ndarray
    Fk_only: int             # kernel-only count (cfg.Fij)
    SP: int                  # poly-side exponents (S_a = mu * beta_a)
    SG: int                  # moment exponents (F_b = Ftil * beta_b)
    ax0o: AxisStatic         # the OMG window +-2w
    ax1o: AxisStatic
    ax0g: AxisStatic         # the GAM / THE window +-w
    ax1g: AxisStatic
    dmu: int


def peel_geom(cfg: SFFTConfig) -> PeelGeom:
    separate_varying = cfg.scaling_mode == "SEPARATE-VARYING"
    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    dmu = cfg.peel_degree
    dk = cfg.kernel_basis.degree
    ds = cfg.scaling_basis.degree if separate_varying else 0
    db = cfg.bg_basis.degree
    SP = dmu + max(dk, ds) + 1
    SG = SP + max(dk, ds, db)
    EMAX = 2 * SG + 2
    exps_k = ref_basis_exponents(cfg.kernel_basis)   # (Fij, 2)
    if separate_varying:
        # the union of kernel and scaling basis functions: its correlation
        # tables hold the beta-beta, beta-sigma and sigma-sigma blocks
        exps_k = np.concatenate([exps_k, ref_basis_exponents(cfg.scaling_basis)], axis=0)
    return PeelGeom(exps_k=exps_k, exps_b=ref_basis_exponents(cfg.bg_basis), Fk_only=cfg.Fij,
                    SP=SP, SG=SG,
                    ax0o=axis_static(N0, 2 * w0, SP, EMAX), ax1o=axis_static(N1, 2 * w1, SP, EMAX),
                    ax0g=axis_static(N0, w0, SP, EMAX), ax1g=axis_static(N1, w1, SP, EMAX),
                    dmu=dmu)


def polynomial_bases(cfg: SFFTConfig) -> bool:
    """Whether every basis the config uses is polynomial (the peel's and
    pexact's closed-form shift algebra)."""
    return (cfg.kernel_basis.kind == "polynomial" and cfg.bg_basis.kind == "polynomial"
            and (cfg.scaling_mode != "SEPARATE-VARYING"
                 or cfg.scaling_basis.kind == "polynomial"))


def peel_moment_sets(I: torch.Tensor, J: torch.Tensor, cfg: SFFTConfig, plain: bool = False,
                     row0: int = 0):
    """(momI_o, momJ_g): the exact moment sets of I (+-2w window) and J (+-w)
    (K3 on CUDA tensors). I and J may be the row block of the images that
    starts at image row row0: the results are that block's shares."""
    g = peel_geom(cfg)
    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    dt = torch_dtype(cfg.dtype)
    momI_o = moment_set(I.to(dt), N0, N1, 2 * w0, 2 * w1, g.SG, g.ax0o, g.ax1o, plain, row0=row0)
    momJ_g = moment_set(J.to(dt), N0, N1, w0, w1, g.SG, g.ax0g, g.ax1g, plain, row0=row0)
    return momI_o, momJ_g


def peel_fits(momI_o: MomentSet, momJ_g: MomentSet, cfg: SFFTConfig) -> PeelShared:
    """The peel fits of I and J from their (summed) moment sets."""
    g = peel_geom(cfg)
    dmu = cfg.peel_degree
    mI = fit_poly_coeffs(momI_o.M, dmu, g.ax0o, g.ax1o)          # (dmu+1, dmu+1)
    mJ = fit_poly_coeffs(momJ_g.M, dmu, g.ax0g, g.ax1g)
    return PeelShared(momI_o=momI_o, momJ_g=momJ_g, mI=mI, mJ=mJ)


def fluct_stack(I: torch.Tensor, J: torch.Tensor, mI: torch.Tensor, mJ: torch.Tensor,
                cfg: SFFTConfig, rows=None) -> torch.Tensor:
    """[F_J] + F_I * beta_union in cfg.fluct_dtype, (1 + Fij, n, N1): the
    fluctuation planes whose windows are the fluct x fluct terms. rows =
    (r0, r1): I and J are the image rows [r0, r1). A batch (I, J (B, n,
    N1), mI, mJ (B, dmu+1, dmu+1)) gives (B, 1 + Fij, n, N1)."""
    g = peel_geom(cfg)
    N0, N1 = cfg.N0, cfg.N1
    r0, r1 = (0, N0) if rows is None else rows
    fd = torch_dtype(cfg.fluct_dtype)
    dmu = cfg.peel_degree
    U = _t(coord_powers, (N0, dmu + 1, 0, N0), I, fd)[:, r0:r1]   # (dmu+1, n)
    V = _t(coord_powers, (N1, dmu + 1, 0, N1), I, fd)
    def smooth(m):
        return _each(lambda c: torch.einsum("st,sx,ty->xy", c, U, V), m.to(fd), 2)

    smoothI, smoothJ = smooth(mI), smooth(mJ)
    FIf = I.to(fd) - smoothI
    FJf = J.to(fd) - smoothJ
    Uk = _t(coord_powers_of, (N0, tuple(int(i) for i in g.exps_k[:, 0])), I, fd)[:, r0:r1]
    Vk = _t(coord_powers_of, (N1, tuple(int(j) for j in g.exps_k[:, 1])), I, fd)
    Fplanes = FIf[..., None, :, :] * (Uk[:, :, None] * Vk[:, None, :])   # (Fij, n, N1)
    return torch.cat([FJf[..., None, :, :], Fplanes], dim=-3)


def fluct_windows(specs: torch.Tensor, cfg: SFFTConfig, plain: bool = False, row0=None):
    """(FF, FFJwin): CC(F_a, F_b) at +-2w and CC(F_a, F_J) at +-w in
    cfg.dtype from the half spectra of ``fluct_stack`` (K1 on CUDA
    tensors); row0: the spectra's frequency rows [row0, row0 + rows) only,
    and the results are their shares. A batch of spectra (B, 1 + Fij, N0,
    N1h) gives the windows of each pair (``corr_window_fft``: one K1
    launch for the batch's FF windows, one for its FFJ)."""
    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    dt = torch_dtype(cfg.dtype)
    specJ, specF = specs[..., 0:1, :, :], specs[..., 1:, :, :]
    FF = corr_window_fft(specF, specF, N0, N1, 2 * w0, 2 * w1, chunk=cfg.greek_chunk,
                         symmetric=True, plain=plain, row0=row0).to(dt)
    FFJwin = corr_window_fft(specF, specJ, N0, N1, w0, w1, chunk=cfg.greek_chunk, plain=plain,
                             row0=row0)[..., 0, :, :].to(dt)
    return FF, FFJwin


def peeled_greek_tables(
    I: torch.Tensor,
    J: torch.Tensor,
    cfg: SFFTConfig,
    plain: bool = False,
    shared: Optional[PeelShared] = None,
    window=None,
) -> Tuple[torch.Tensor, ...]:
    """(Comg, Cgam, Cthe, Cphi, Cdel) unscaled CC tables, mixed-precision:
    exact f64 for every term touching smooth/polynomial content, fluct x fluct
    via FFT in cfg.fluct_dtype. SEPARATE-VARYING adds a sixth entry
    (Pbs, Pss, Pgs, Pts). plain=True keeps K3 and K1 out (plain twins).
    shared (``PeelShared``) and window() -> (FF, FFJwin), when given, stand
    in for the moment stage and the fluctuation windows of (I, J) (the
    row-sharded step sums them over row blocks; I and J are then unused).
    I and J (B, N0, N1), polynomial bases: a batch of pairs (the batched
    step), every table with a leading pair axis; each pair's bits are those
    of its single call (one K3 launch per moment set and one K1 launch per
    window kind for the batch, the table algebra once for the batch)."""
    if not polynomial_bases(cfg):
        # B-spline bases: the truncated-power generalization handles them
        # (it raises where its knot layout is not supported)
        from sfft_tpu_torch.core.peel_pw import peeled_pw_greek_tables

        return peeled_pw_greek_tables(I, J, cfg, plain=plain, shared=shared, window=window)
    separate_varying = cfg.scaling_mode == "SEPARATE-VARYING"
    w0, w1 = cfg.w0, cfg.w1
    dmu = cfg.peel_degree
    g = peel_geom(cfg)
    SP, SG = g.SP, g.SG
    dt = torch_dtype(cfg.dtype)
    exps_k, exps_b = g.exps_k, g.exps_b
    Fk_only = g.Fk_only
    Fij, Fpq = len(exps_k), len(exps_b)
    ax0o, ax1o, ax0g, ax1g = g.ax0o, g.ax1o, g.ax0g, g.ax1g

    # --- exact moment sets of raw images, the polynomial peels -------------
    if shared is None:
        shared = peel_fits(*peel_moment_sets(I, J, cfg, plain), cfg)
    momI_o, momJ_g, mI, mJ = shared
    dev = mI.device
    lead = tuple(mI.shape[:-2])          # () or (B,): the pair axis
    # the +-w window set is a central slice of the +-2w one
    momI_g = MomentSet(
        M=momI_o.M,
        RS=momI_o.RS[..., w0: 3 * w0 + 1, :, :],
        CS=momI_o.CS[..., w1: 3 * w1 + 1, :, :],
        CNR=momI_o.CNR[..., w0: 3 * w0 + 1, w1: 3 * w1 + 1, :, :],
    )

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dt, device=dev)

    def batch(x):
        # a table shared by the pairs, as each pair's own (a view)
        return x.expand(lead + tuple(x.shape)) if lead else x

    # S_a coeffs: mu_I * beta_a — exponent-shifted embeddings, (Fij, SP, SP),
    # one scatter for the batch
    PA = zeros(Fij, SP, SP)
    pk, pi, pj, ms, mt = (_t(_embed_index, (_exps_key(exps_k), dmu), mI, torch.int64)[r]
                          for r in range(5))
    PA[..., pk, pi, pj] = mI[..., ms, mt]
    mJ_pad = zeros(1, SP, SP)
    mJ_pad[..., 0, : dmu + 1, : dmu + 1] = mJ
    # background basis coeffs (static monomials), (Fpq, SP, SP)
    TQ = _t(_monomial_coeffs, (_exps_key(exps_b), SP), mI, dt)

    # --- fluctuation moment sets (pure algebra, no grid) ---------------
    def fluct_mom(momG: MomentSet, mcoef, ax0, ax1) -> MomentSet:
        Q = zeros(SP, SP)
        Q[..., : dmu + 1, : dmu + 1] = mcoef
        pm = poly_moment_set(
            Q, (ax0.S.shape[0] - 1) // 2, (ax1.S.shape[0] - 1) // 2, SP, SG, ax0, ax1)
        return MomentSet(
            M=momG.M - pm.M, RS=momG.RS - pm.RS,
            CS=momG.CS - pm.CS, CNR=momG.CNR - pm.CNR,
        )

    momFI_o = fluct_mom(momI_o, mI, ax0o, ax1o)
    momFI_g = fluct_mom(momI_g, mI, ax0g, ax1g)

    # per-basis fluct moment sets: F_b = Ftil * beta_b
    momFb_o = shift_moment_set(momFI_o, exps_k, SP)
    momFa_g = shift_moment_set(momFI_g, exps_k, SP)

    # --- OMG: (Fij, Fij, R0o, R1o) --------------------------------------
    momSb_o = poly_moment_set(PA, 2 * w0, 2 * w1, SP, SG, ax0o, ax1o)
    SS = polycorr(PA, momSb_o, ax0o, ax1o)            # CC(S_a, S_b)
    SF = polycorr(PA, momFb_o, ax0o, ax1o)            # CC(S_a, F_b)
    FS = torch.flip(SF.transpose(-4, -3), dims=(-2, -1))  # CC(F_a, S_b)

    # --- fluct x fluct: the windows of the fluctuation planes --------------
    if window is None:
        stack = fluct_stack(I.to(dt), J.to(dt), mI, mJ, cfg)
        specs = rfft2_pairs(stack) if lead else torch.fft.rfft2(stack)
        FF, FFJwin = fluct_windows(specs, cfg, plain)
    else:
        FF, FFJwin = window()
    Comg = SS + SF + FS + FF

    # --- GAM: (Fij, Fpq, R0g, R1g) — fully exact ------------------------
    momTq = poly_moment_set(TQ, w0, w1, SP, SG, ax0g, ax1g)
    SS_gam = polycorr(PA, MomentSet(*(batch(t) for t in momTq)), ax0g, ax1g)   # CC(S_a, T_q)
    FT = polycorr(batch(TQ), momFa_g, ax0g, ax1g)       # CC(T_q, F_a)
    FS_gam = torch.flip(FT.transpose(-4, -3), dims=(-2, -1))
    Cgam = SS_gam + FS_gam

    # --- THE: (Fij, R0g, R1g) -------------------------------------------
    SJ = polycorr(PA, momJ_g, ax0g, ax1g)             # CC(S_a, J) exact
    FSJ = torch.flip(polycorr(mJ_pad, momFa_g, ax0g, ax1g)[..., 0, :, :, :],
                     dims=(-2, -1))                   # CC(F_a, S_J)
    Cthe = SJ + FSJ + FFJwin

    # --- PHI / DEL: closed form from static sums / moments --------------
    Cphi = batch(_t(phi_table, (ax0g.args, ax1g.args, _exps_key(exps_b)), mI, dt))
    bi, bj = (_t(np.array, (tuple(exps_b[:, r]),), mI, torch.int64) for r in range(2))
    Cdel = momJ_g.M[..., bi, bj]

    if not separate_varying:
        return Comg, Cgam, Cthe, Cphi, Cdel

    # --- slice the union tables into the SEPARATE-VARYING blocks --------
    Fk = Fk_only
    Fs = Fij - Fk  # actual scaling dof (engine pads placeholders with zeros)
    win0 = slice(w0, 3 * w0 + 1)
    win1 = slice(w1, 3 * w1 + 1)
    Pbs = Comg[..., :Fk, Fk:, win0, win1]          # CC(I*beta_a, I*sigma_b), +-w
    Pss = Comg[..., Fk:, Fk:, 2 * w0, 2 * w1]      # lag 0
    Pgs = Cgam[..., Fk:, :, w0, w1]                # CC(I*sigma, T)[0]
    Pts = Cthe[..., Fk:, w0, w1]                   # CC(I*sigma, J)[0]

    def pad_k(x, axes):
        # axes count after the pair axis
        shape = list(x.shape)
        for ax in axes:
            shape[len(lead) + ax] = Fk
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
        out[tuple(slice(0, n) for n in x.shape)] = x
        return out

    extra = (pad_k(Pbs, [1]), pad_k(Pss, [0, 1]), pad_k(Pgs, [0]),
             pad_k(Pts, [0]))
    return (Comg[..., :Fk, :Fk, :, :], Cgam[..., :Fk, :, :, :], Cthe[..., :Fk, :, :], Cphi, Cdel,
            extra)


def _embed_index(exps_k: tuple, dmu: int) -> np.ndarray:
    """(5, Fij (dmu+1)^2): where each coefficient of the peel's fit lands in
    PA (k, i + s, j + t) and which it is (s, t), for the S_a = mu * beta_a
    embedding of every kernel exponent (i, j)."""
    k, s, t = np.meshgrid(np.arange(len(exps_k)), np.arange(dmu + 1), np.arange(dmu + 1),
                          indexing="ij")
    e = np.asarray(exps_k).reshape(-1, 2)
    return np.stack([k, e[k, 0] + s, e[k, 1] + t, s, t]).reshape(5, -1)


def _monomial_coeffs(exps_b: tuple, SP: int) -> np.ndarray:
    """(Fpq, SP, SP): the background basis as monomial coefficient stacks."""
    TQ = np.zeros((len(exps_b), SP, SP))
    for k, (p, q) in enumerate(exps_b):
        TQ[k, p, q] = 1.0
    return TQ
