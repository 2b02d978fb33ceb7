"""Exact-grade (double-float) DFTs and windowed correlations from
integer-sliced matrix products (counterpart of sfft_tpu/core/exact_fft.py).

Numbers ride as PAIRS of f32 tensors (hi + lo, ~48 bits). Every large
contraction (DFT stages, partial inverse-DFT windows) splits both operands
into 6-bit integer slices (core/slicing.py, the K4 kernel on CUDA tensors);
slice products are int8 x int8 -> int32 matrix products whose sums are exact
(``torch._int_mm``), recombined in compensated f32 pair arithmetic. DFTs
use a two-stage Cooley-Tukey factorisation N = R * S, so each stage is a
small (R x R) or (S x S) product.

The algorithms, slicing depths and chunk sizes are sfft_tpu's. What differs:

  * PyTorch runs eagerly and no compiler rewrites the pair arithmetic, so the
    TwoSum / TwoProd chains need no fences; nothing here may run under
    torch.compile, and the pair code uses no fused operations.
  * The static tables (DFT stage matrices, phase matrices, their int8
    slices) are named by how they are built (``statics.Static``: a builder
    and its geometry arguments), and built once per name and device into
    bounded caches (``statics.table``, ``_split_on``, ``_static_slices_for``):
    a step builds and uploads none.
  * ``torch._int_mm`` on CUDA needs more than 16 rows and depths and widths
    that are multiples of 8: contraction axes are zero-padded (zero slices
    add nothing to the exact sums) and static columns padded to 64.
  * The lax.map bodies are Python loops over the same chunks.

Every public function takes ``plain`` (default False): True slices with the
plain twin of K4 instead of the kernel.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# NB and K4's plain remainder chain (_seq_slices) live beside the kernel
# wrapper in core/slicing.py
from sfft_tpu_torch.core.slicing import (NB, slice_pair, slice_pair_plain, slice_triple,
                                          slice_triple_plain)
from sfft_tpu_torch.core.statics import Static, index, table

NSL_DATA = 9            # data slices (54 bits)
NSL_STATIC = 8          # static-matrix slices (48 bits, the pair lanes' depth)
KMAX = 8                # keep slice combos with i + j <= KMAX


class SliceProfile(NamedTuple):
    """Per-call slicing depth (data slices, static slices, kmax)."""

    nsl_data: int
    nsl_static: int
    kmax: int


# ---------------------------------------------------------------------------
# pair (double-float) helpers — all f32 elementwise
# ---------------------------------------------------------------------------


class CPair(NamedTuple):
    """Complex tensor as four f32 planes (real hi/lo, imag hi/lo); imag
    parts None for a real tensor."""

    rh: torch.Tensor
    rl: torch.Tensor
    ih: Optional[torch.Tensor]
    il: Optional[torch.Tensor]

    @property
    def is_real(self) -> bool:
        return self.ih is None


def _pmap(p: CPair, fn) -> CPair:
    """Apply fn to every present plane of a pair."""
    return CPair(*(None if v is None else fn(v) for v in p))


def pair_from_f64(x: torch.Tensor) -> CPair:
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return CPair(hi, lo, None, None)


def pair_to_c128(p: CPair) -> torch.Tensor:
    re = p.rh.to(torch.float64) + p.rl
    if p.ih is None:
        return re
    return torch.complex(re, p.ih.to(torch.float64) + p.il)


def _two_sum(a, b):
    """Knuth TwoSum in f32: a + b = s + e exactly."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _two_prod(a, b):
    """Dekker TwoProd in f32 (Veltkamp split, no FMA): a * b = p + e exactly."""
    C = 4097.0
    p = a * b
    a1 = a * C
    b1 = b * C
    ah = a1 - (a1 - a)
    al = a - ah
    bh = b1 - (b1 - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _chain(groups, weights):
    """Compensated sum of f32 tensors with power-of-two weights (descending).
    Returns (hi, lo) f32. Terms whose weight is <= 2^-24 of the leading one
    are summed in plain f32 (their rounding lands below 2^-48 of the total)."""
    w0 = weights[0]
    big = [(g, w) for g, w in zip(groups, weights) if w > w0 * 2.0 ** -24]
    small = [(g, w) for g, w in zip(groups, weights) if w <= w0 * 2.0 ** -24]
    h = big[0][0] * float(big[0][1])
    lo = torch.zeros_like(h)
    for g, w in big[1:]:
        h, e = _two_sum(h, g * float(w))
        lo = lo + e
    if small:
        tail = small[0][0] * float(small[0][1])
        for g, w in small[1:]:
            tail = tail + g * float(w)
        lo = lo + tail
    h2 = h + lo
    l2 = lo - (h2 - h)
    return h2, l2


# ---------------------------------------------------------------------------
# static tables on the device (core/statics.py)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=256)
def _split_on(ref: Static, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) f32 pair of a static real f64 table on `device`, built once."""
    a64 = np.asarray(ref.host(), np.float64)
    hi = a64.astype(np.float32)
    lo = (a64 - hi.astype(np.float64)).astype(np.float32)
    return torch.tensor(hi, device=device), torch.tensor(lo, device=device)


def _cols(W: np.ndarray, n: int) -> np.ndarray:
    """The first n columns of a static table."""
    return W[:, :n]


# ---------------------------------------------------------------------------
# integer slicing
# ---------------------------------------------------------------------------


def _pow2ceil_scalar(m: torch.Tensor) -> torch.Tensor:
    """Exact power of two in (m, 2m] (elementwise), from the f32 exponent
    bits: s = 2^(biased_exponent - 126). Stays on the device."""
    m = torch.clamp(m.to(torch.float32), min=1e-30)
    expo = (m.view(torch.int32) >> 23) & 0xFF
    return ((expo + 1) << 23).view(torch.float32)


def _slice_pair_real(hi: torch.Tensor, lo: torch.Tensor, nsl: int,
                     rowwise: bool = False, plain: bool = False):
    """(hi, lo) f32 -> (int8 slices stacked on axis 0, pow-2 scale):
    value == scale * sum_q slices[q] * 2^(-NB (q+1))  (+ O(2^(-NB nsl))).

    rowwise=True scales per row (max over the last axis, shape (..., 1));
    else one global scale (shape ()). The scale is taken from max|hi| before
    the TwoSum canonicalisation, as in sfft_tpu. CUDA tensors launch K4
    (core/slicing.py) unless plain=True; CPU tensors take its plain twin."""
    if rowwise:
        s = _pow2ceil_scalar(hi.abs().amax(dim=-1, keepdim=True))
    else:
        s = _pow2ceil_scalar(hi.abs().amax())
    hi = hi.contiguous()
    lo = lo.contiguous()
    if plain:
        return slice_pair_plain(hi, lo, s, nsl), s
    return slice_pair(hi, lo, s.contiguous(), nsl), s


def _slice_triple_real(hi: torch.Tensor, mid: torch.Tensor, lo: torch.Tensor, nsl: int,
                       rowwise: bool = False, plain: bool = False, out_cols: int = None):
    """Exact f32 triple (hi, mid, lo) -> (int8 slices stacked on axis 0,
    pow-2 scale): value == scale * sum_q slices[q] * 2^(-NB (q+1)) to
    2^(-NB nsl) of the scale (72 bits at nsl = 12; a pair floors at 2^-48).
    The triple is an exact three-way split of an f64 value (hi = f32(v),
    mid = f32(v - hi), lo = f32(v - hi - mid)), already canonical. nsl >= 8.
    out_cols zero-pads the last axis of the slices (the depth an int8
    product wants). CUDA tensors launch K5 (core/slicing.py) unless
    plain=True; CPU tensors take its plain twin."""
    if rowwise:
        s = _pow2ceil_scalar(hi.abs().amax(dim=-1, keepdim=True))
    else:
        s = _pow2ceil_scalar(hi.abs().amax())
    hi, mid, lo = hi.contiguous(), mid.contiguous(), lo.contiguous()
    if plain:
        return slice_triple_plain(hi, mid, lo, s, nsl, out_cols), s
    return slice_triple(hi, mid, lo, s.contiguous(), nsl, out_cols), s


def _slice_static(M: np.ndarray, nsl: int = None):
    """Static real matrix -> (int8 slices (nsl, ...), pow-2 scale), in f64
    numpy (sfft_tpu's host-side slicing of small tables)."""
    if nsl is None:
        nsl = NSL_STATIC
    mx = np.max(np.abs(M))
    s = float(2.0 ** np.ceil(np.log2(mx))) if mx > 0 else 1.0
    r = (M / s).astype(np.float64)
    out = []
    for q in range(nsl):
        sc = 2.0 ** (NB * (q + 1))
        p = np.round(r * sc)
        assert np.max(np.abs(p)) <= 127
        out.append(p.astype(np.int8))
        r = r - p / sc
    return np.stack(out), s


def _group_combos(nsl_d: int, nsl_w: int, kmax: int):
    """combo (i, j) lists per weight group s = i + j."""
    groups = []
    for s_ in range(min(kmax, nsl_d + nsl_w - 2) + 1):
        combos = [(i, s_ - i) for i in range(max(0, s_ - nsl_w + 1),
                                             min(nsl_d - 1, s_) + 1)]
        if combos:
            groups.append((s_, combos))
    return groups


def _pad_cols(M: np.ndarray, mult: int = 64) -> np.ndarray:
    """Zero-pad the LAST axis to a multiple of `mult`."""
    m = (-M.shape[-1]) % mult
    if m == 0:
        return M
    pads = [(0, 0)] * M.ndim
    pads[-1] = (0, m)
    return np.pad(M, pads)


def _padk(x: torch.Tensor, Kp: int) -> torch.Tensor:
    """Zero-pad the last (contraction) axis to Kp."""
    k = x.shape[-1]
    return x if k == Kp else F.pad(x, (0, Kp - k))


def _accum(outs, weights, sc, big: bool):
    """Weighted pair-combine of int32 group sums. `big`: sums may exceed
    f32's exact-integer range — split each into a 2^12-aligned top plus a
    remainder (both exact in f32) before the compensated chain."""
    fo, fw = [], []
    for out, w_ in zip(outs, weights):
        if big:
            top = (out >> 12) << 12
            fo += [top.to(torch.float32), (out - top).to(torch.float32)]
            fw += [w_, w_]
        else:
            fo.append(out.to(torch.float32))
            fw.append(w_)
    h, l = _chain(fo, fw)
    return h * sc, l * sc


class _Static(NamedTuple):
    """Integer slices of a static real matrix (K, M): slT (nsl, Mp, Kp) int8,
    transposed for the products, K zero-padded to a multiple of 8 and M to
    a multiple of 64; scale a float (host-sliced) or a 0-d f32 tensor
    (sliced on the device); key the arguments that built it."""

    key: tuple
    slT: torch.Tensor
    scale: object


@lru_cache(maxsize=256)
def _static_slices_for(ref: Static, nsl: int, device, plain: bool = False) -> Optional[_Static]:
    """Integer slices of the static real matrix `ref`, built once per table,
    depth, device and slicer (plain=True slices big tables with K4's plain
    twin); None for an all-zero table. As in sfft_tpu, big tables (>= 2^17
    slice entries) are sliced from their f32 (hi, lo) pair by the data
    slicer (K4 on CUDA), small ones in f64 numpy."""
    padded = Static(_pad_cols, (ref, 64))
    Mp_ = np.asarray(padded.host(), np.float64)
    if not np.any(Mp_):
        return None
    K = Mp_.shape[0]
    if Mp_.size * nsl >= 2 ** 17:
        hi, lo = _split_on(padded, device)
        sl, s = _slice_pair_real(hi, lo, nsl, rowwise=False, plain=plain)
    else:
        sl_np, s = _slice_static(Mp_, nsl)
        sl = torch.tensor(sl_np, device=device)
    slT = _padk(sl.transpose(1, 2), K + (-K) % 8).contiguous()
    return _Static((ref, nsl, device, plain), slT, s)


@lru_cache(maxsize=256)
def _stacked(keys: tuple, kind) -> torch.Tensor:
    """Transposed concatenations of the static slice sets named by `keys`,
    cached: kind 'deep' stacks every (part, slice) along the output axis; a
    combo list (shallow groups) concatenates the combos' slices along the
    contraction axis and the parts along the output axis."""
    parts = [_static_slices_for(*k) for k in keys]
    if kind == "deep":
        got = torch.cat([p.slT[j] for p in parts for j in range(p.slT.shape[0])], dim=0)
    else:
        got = torch.cat([torch.cat([p.slT[j] for _, j in kind], dim=1) for p in parts], dim=0)
    return got.contiguous()


def _int_mm(A: torch.Tensor, BT: torch.Tensor) -> torch.Tensor:
    """A (m, k) int8 @ BT.T with BT (n, k) int8 contiguous -> (m, n) int32,
    exact. k and n are multiples of 8 (callers pad); m <= 16 is padded,
    since torch._int_mm on CUDA needs more than 16 rows."""
    m = A.shape[0]
    if m <= 16:
        A = F.pad(A, (0, 0, 0, 17 - m))
    return torch._int_mm(A, BT.t())[:m]


def _sliced_dot_multi(dsl, s_d, parts, K: int, M: int, kmax: Optional[int] = None):
    """Exact product of ONE data slice set against SEVERAL static slice sets
    (typically a complex matrix's real and imaginary parts).

    dsl: (nsl_d, ..., Kp) int8 data slices (contraction axis padded to Kp);
    parts: _Static slice sets with K true rows and M true columns. Returns
    one f32 (hi, lo) pair (..., M) per part. Products accumulate in int32
    exactly (|prod| <= 2^12, depth < 2^19).

    Deep K (>= 1024): one product per data slice against every static slice
    of every part. Shallow K: one product per weight group with the group's
    slice pairs concatenated along the contraction axis."""
    nsl_d = dsl.shape[0]
    nsl_w = parts[0].slT.shape[0]
    Mp = parts[0].slT.shape[1]
    Kp = dsl.shape[-1]
    lead = tuple(dsl.shape[1:-1])
    groups = _group_combos(nsl_d, nsl_w, KMAX if kmax is None else kmax)
    keys = tuple(p.key for p in parts)
    assert 64 * 64 * Kp * max(len(c) for _, c in groups) < 2 ** 31, "int32 depth bound"

    def scaled(s_w):
        return s_d * (s_w if isinstance(s_w, torch.Tensor) else float(np.float32(s_w)))

    if K >= 1024:
        ni = min(nsl_d, groups[-1][0] + 1)
        per_i = _int_mm(dsl[:ni].reshape(-1, Kp), _stacked(keys, "deep"))
        per_i = per_i.reshape((ni,) + lead + (-1,))
        results = []
        for p, part in enumerate(parts):
            outs, weights = [], []
            for s_, combos in groups:
                acc = None
                for i, j in combos:
                    off = (p * nsl_w + j) * Mp
                    piece = per_i[i][..., off:off + M]
                    acc = piece if acc is None else acc + piece
                outs.append(acc)
                weights.append(2.0 ** (-NB * (s_ + 2)))
            results.append(_accum(outs, weights, scaled(part.scale), big=True))
        return results

    group_outs = []
    for s_, combos in groups:
        dcat = torch.cat([dsl[i] for i, _ in combos], dim=-1)
        out = _int_mm(dcat.reshape(-1, dcat.shape[-1]), _stacked(keys, tuple(combos)))
        group_outs.append(out.reshape(lead + (-1,)))
    # exact-int32-in-f32 bound (sfft_tpu's): the leading slice reaches 64,
    # later ones stay <= 33, on the TRUE depth K
    big = 64 * 33 * max(len(c) for _, c in groups) * K >= 2 ** 24
    results = []
    for p, part in enumerate(parts):
        outs = [g[..., p * Mp: p * Mp + M] for g in group_outs]
        weights = [2.0 ** (-NB * (s_ + 2)) for s_, _ in groups]
        results.append(_accum(outs, weights, scaled(part.scale), big=big))
    return results


def _cmatmul_sliced(data: CPair, W: Static, rowwise: bool = False, real_out: bool = False,
                    prof: Optional[SliceProfile] = None, plain: bool = False) -> CPair:
    """Exact complex matmul: data (..., K) pair @ the static (complex or
    real) table W (K, M). Returns the pair (..., M). real_out=True (complex
    data and W): only the real part (re = dr.wr - di.wi)."""
    p = prof or SliceProfile(NSL_DATA, NSL_STATIC, KMAX)
    dev = data.rh.device
    K, M = W.host().shape
    Kp = K + (-K) % 8
    wr = _static_slices_for(Static(np.real, (W,)), p.nsl_static, dev, plain)
    dr_sl, sdr = _slice_pair_real(_padk(data.rh, Kp), _padk(data.rl, Kp), p.nsl_data,
                                  rowwise, plain)
    wi = _static_slices_for(Static(np.imag, (W,)), p.nsl_static, dev, plain)
    have_wi = wi is not None
    parts = [wr, wi] if have_wi else [wr]
    if not data.is_real:
        di_sl, sdi = _slice_pair_real(_padk(data.ih, Kp), _padk(data.il, Kp), p.nsl_data,
                                      rowwise, plain)

    if real_out and not data.is_real and have_wi:
        rr_h, rr_l = _sliced_dot_multi(dr_sl, sdr, parts[:1], K, M, p.kmax)[0]
        ii_h, ii_l = _sliced_dot_multi(di_sl, sdi, parts[1:], K, M, p.kmax)[0]
        zr_h, e1 = _two_sum(rr_h, -ii_h)
        return CPair(zr_h, rr_l - ii_l + e1, None, None)

    outs_r = _sliced_dot_multi(dr_sl, sdr, parts, K, M, p.kmax)
    rr_h, rr_l = outs_r[0]
    if have_wi:
        ri_h, ri_l = outs_r[1]
    else:
        ri_h = ri_l = torch.zeros_like(rr_h)
    if not data.is_real:
        outs_i = _sliced_dot_multi(di_sl, sdi, parts, K, M, p.kmax)
        ir_h, ir_l = outs_i[0]
        if have_wi:
            ii_h, ii_l = outs_i[1]
        else:
            ii_h = ii_l = torch.zeros_like(ir_h)
        # (r + i i)(wr + i wi): re = r wr - i wi ; im = r wi + i wr
        zr_h, e1 = _two_sum(rr_h, -ii_h)
        zr_l = rr_l - ii_l + e1
        zi_h, e2 = _two_sum(ri_h, ir_h)
        zi_l = ri_l + ir_l + e2
        return CPair(zr_h, zr_l, zi_h, zi_l)
    return CPair(rr_h, rr_l, ri_h, ri_l)


# ---------------------------------------------------------------------------
# exact DFT via two-stage Cooley-Tukey with sliced matmuls
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _factor(N: int) -> Tuple[int, int]:
    R = int(np.sqrt(N))
    while R > 1 and N % R:
        R -= 1
    return R, N // R


def _dft_stage_mat(N: int, inverse: bool, name: str) -> np.ndarray:
    """Static matrices for the factorised DFT over n = a + R b:
      G[a, d]  = sum_b x[a + R b] e^{-+2 pi i b d / S}               ("DS")
      X[S c+d] = sum_a G[a, d] e^{-+2 pi i a d / N} e^{-+2 pi i a c / R}
    ("tw", the twiddle, an elementwise pair product between the stages;
    "DR")."""
    R, S = _factor(N)
    sgn = 2j * np.pi * (1 if inverse else -1)
    if name == "DS":
        return np.exp(sgn * np.outer(np.arange(S), np.arange(S)) / S)
    if name == "DR":
        return np.exp(sgn * np.outer(np.arange(R), np.arange(R)) / R)
    return np.exp(sgn * np.outer(np.arange(R), np.arange(S)) / N)     # (a, d)


def _pair_mul_static(v: CPair, W: Static) -> CPair:
    """Elementwise complex pair product v * W with a static complex factor
    (broadcast over leading dims), accurate to ~2^-48 relative."""
    dev = v.rh.device
    wr, wr_l = _split_on(Static(np.real, (W,)), dev)
    wi, wi_l = _split_on(Static(np.imag, (W,)), dev)
    prr, err = _two_prod(v.rh, wr)
    pii, eii = _two_prod(v.ih, wi)
    pri, eri = _two_prod(v.rh, wi)
    pir, eir = _two_prod(v.ih, wr)
    cr = err - eii + v.rh * wr_l + v.rl * wr - v.ih * wi_l - v.il * wi
    ci = eri + eir + v.rh * wi_l + v.rl * wi + v.ih * wr_l + v.il * wr
    ur, e1 = _two_sum(prr, -pii)
    ui, e2 = _two_sum(pri, pir)
    return CPair(ur, cr + e1, ui, ci + e2)


def _pair_mul_static_rr(v: CPair, W: Static) -> CPair:
    """REAL pair * static REAL factor (broadcastable), ~2^-48 relative."""
    wh, wl = _split_on(W, v.rh.device)
    p, e = _two_prod(v.rh, wh.expand(torch.broadcast_shapes(v.rh.shape, wh.shape)))
    lo = e + v.rh * wl + v.rl * wh
    return CPair(p, lo, None, None)


def pair_sep_mul(p: CPair, u: Static, v: Static) -> CPair:
    """p * u * v for a real pair p (N0, N1) and static factors u (N0, 1) and
    v (1, N1): exact-grade basis-plane weighting in pair arithmetic."""
    return _pair_mul_static_rr(_pair_mul_static_rr(p, u), v)


def pair_stack(pairs) -> CPair:
    """Stack CPairs along a new leading axis (imag parts must match)."""
    rh = torch.stack([q.rh for q in pairs])
    rl = torch.stack([q.rl for q in pairs])
    if pairs[0].ih is None:
        return CPair(rh, rl, None, None)
    return CPair(rh, rl, torch.stack([q.ih for q in pairs]),
                 torch.stack([q.il for q in pairs]))


def _swap(v: torch.Tensor) -> torch.Tensor:
    return v.transpose(-1, -2)


def exact_dft_axis(x: CPair, N: int, inverse: bool = False, real_out: bool = False,
                   half_out: bool = False, prof: Optional[SliceProfile] = None,
                   plain: bool = False) -> CPair:
    """Exact-grade DFT over the LAST axis (length N) of a pair tensor.

    real_out=True: only the real part of the transform (a real pair).
    half_out=True: only bins k <= N//2 (the Hermitian half for real input);
    the second stage then runs at half width."""
    R, S = _factor(N)
    DS, DR, tw = (Static(_dft_stage_mat, (N, inverse, m)) for m in ("DS", "DR", "tw"))
    sh = tuple(x.rh.shape[:-1])
    # layout (..., b, a): x[a + R b] == x.reshape(S, R)[b, a]
    data = _pmap(x, lambda v: v.reshape(sh + (S, R)))
    if R == 1:
        # prime N: one full DFT product over b (depth N)
        DSc = Static(_cols, (DS, N // 2 + 1)) if half_out else DS
        return _cmatmul_sliced(_pmap(data, lambda v: v[..., 0]), DSc, real_out=real_out,
                               prof=prof, plain=plain)
    # stage 1: G[a, d] = sum_b x[b, a] DS[b, d] — contraction axis last
    G = _cmatmul_sliced(_pmap(data, _swap), DS, prof=prof, plain=plain)
    U = _pair_mul_static(G, tw)
    # stage 2: X[S c + d] = sum_a U[a, d] DR[a, c]
    Rc = R // 2 + 1 if half_out else R
    DRc = Static(_cols, (DR, Rc)) if half_out else DR
    V = _cmatmul_sliced(_pmap(U, _swap), DRc, real_out=real_out, prof=prof,
                        plain=plain)                                 # (..., d, c)
    Nc = N // 2 + 1 if half_out else N

    def fin(v):
        v = _swap(v).reshape(sh + (Rc * S,))                        # k = S c + d
        return v[..., :Nc] if half_out else v

    return _pmap(V, fin)


@lru_cache(maxsize=64)
def _distinct_rows(V: Static):
    """(first row index and all-ones flag of each distinct row of the static
    table V, the distinct row each row maps to)."""
    Vh = V.host()
    keys, firsts, src = {}, [], []
    for k in range(Vh.shape[0]):
        kb = Vh[k].tobytes()
        if kb not in keys:
            keys[kb] = len(firsts)
            firsts.append((k, bool(np.all(Vh[k] == 1.0))))
        src.append(keys[kb])
    return tuple(firsts), tuple(src)


def _row(V: np.ndarray, k: int) -> np.ndarray:
    return V[k][None, :]


def _ones_above(U: np.ndarray, nh: int) -> np.ndarray:
    return np.concatenate([np.ones((nh, U.shape[1])), U], axis=0)


def exact_sep_weighted_spectra(head, base: CPair, U: Static, V: Static,
                               prof: Optional[SliceProfile] = None,
                               plain: bool = False) -> CPair:
    """Stacked half spectra of  list(head) + [base * U[k][:, None] *
    V[k][None, :]  for k]  (sfft_tpu's separable-weight pair FFT).

    head: real pairs transformed as they are; base: one real pair; U (F, N0),
    V (F, N1): static f64 row / column weight tables per output plane. The
    axis-1 legs run once per DISTINCT V row (U commutes with the axis-1
    transform); the legs and the axis-0 bodies run one plane at a time."""
    # sfft_tpu transforms only the real lanes of the inputs and would drop
    # imaginary parts silently: take real pairs only
    if not base.is_real or any(not h.is_real for h in head):
        raise ValueError("exact_sep_weighted_spectra takes real pairs only")
    nh = len(head)
    firsts, vsrc = _distinct_rows(V)
    N0 = base.rh.shape[-2]
    N1 = base.rh.shape[-1]
    dev = base.rh.device

    planes1 = list(head)
    for k, ones in firsts:
        planes1.append(base if ones else _pair_mul_static_rr(base, Static(_row, (V, k))))
    T = [exact_dft_axis(pl_, N1, half_out=True, prof=prof, plain=plain) for pl_ in planes1]
    del planes1

    src = np.concatenate([np.arange(nh), nh + np.asarray(vsrc, dtype=np.int64)])
    Wh, Wl = _split_on(Static(_ones_above, (U, nh)), dev)
    out = []
    for k, t in enumerate(src):
        Tk = T[int(t)]
        wh, wl = Wh[k][:, None], Wl[k][:, None]

        def one(h, l):
            p, e = _two_prod(h, wh.expand(h.shape))
            return p, e + h * wl + l * wh

        zrh, zrl = one(Tk.rh, Tk.rl)
        zih, zil = one(Tk.ih, Tk.il)
        zt = exact_dft_axis(_pmap(CPair(zrh, zrl, zih, zil), _swap), N0, prof=prof,
                            plain=plain)
        out.append(_pmap(zt, _swap))
    return pair_stack(out)


def exact_fft2_pair(F, plane_chunk: int = 0, half: bool = False,
                    prof: Optional[SliceProfile] = None, plain: bool = False) -> CPair:
    """Exact-grade complex 2-D spectrum of a real f64 stack (..., N0, N1), or
    of a real CPair of that shape. Returns the pair (..., N0, N1), or
    (..., N0, N1//2+1) with half=True (the Hermitian half over the last
    axis). A leading stack axis runs in chunks of `plane_chunk` planes
    (sfft_tpu's size by default): the DFT stages slice each chunk under one
    global scale, so the chunking is part of the numbers."""
    is_pair = isinstance(F, CPair)
    ref = F.rh if is_pair else F
    N0, N1 = ref.shape[-2], ref.shape[-1]
    if ref.dim() == 3:
        if plane_chunk <= 0:
            plane_chunk = int(max(1, min(8, 2 ** 24 // (N0 * N1))))
        if ref.shape[0] > plane_chunk:
            outs = []
            for c0 in range(0, ref.shape[0], plane_chunk):
                part = (_pmap(F, lambda v: v[c0:c0 + plane_chunk]) if is_pair
                        else F[c0:c0 + plane_chunk])
                outs.append(exact_fft2_pair(part, plane_chunk, half, prof, plain))
            return CPair(*(torch.cat(vs, dim=0) for vs in zip(*outs)))
    x = F if is_pair else pair_from_f64(F)
    y = exact_dft_axis(x, N1, half_out=half, prof=prof, plain=plain)
    z = exact_dft_axis(_pmap(y, _swap), N0, prof=prof, plain=plain)
    return _pmap(z, _swap)


def _idft_halfin_dims(N: int):
    """Cooley-Tukey split of the half-input real inverse over the last axis,
    y[n] = Re( sum_{k<N/2} x[k] e^{+2 pi i k n / N} ), N even: M = N/2 =
    R*S with k = a + R b (R the larger factor); stage-1 output width 2S."""
    M = N // 2
    r, s_ = _factor(M)
    R = max(r, s_)
    return R, M // R, N // R


def _idft_halfin_mat(N: int, name: str) -> np.ndarray:
    """Its static matrices: "ES" (S, 2S), "tw" (R, 2S), "ER" (R, R)."""
    R, S, m_ = _idft_halfin_dims(N)
    if name == "ES":
        return np.exp(2j * np.pi * np.outer(np.arange(S), np.arange(m_)) / m_)
    if name == "tw":
        return np.exp(2j * np.pi * np.outer(np.arange(R), np.arange(m_)) / N)
    return np.exp(2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)


def _alt_sign(N: int) -> np.ndarray:
    """(-1)^n, n < N, in f32."""
    sign = np.ones(N, np.float32)
    sign[1::2] = -1.0
    return sign


def exact_idft_halfin_real(x: CPair, N: int, prof: Optional[SliceProfile] = None,
                           plain: bool = False) -> CPair:
    """Real inverse DFT over the last axis from the FOLDED Hermitian half.

    x: pair (..., N//2+1), fold weights already applied (2 for interior
    columns, 1 for DC and Nyquist). Returns the real pair
    y[n] = Re(sum_{k<=N/2} x[k] e^{+2 pi i k n/N}) without the 1/N scale.
    N must be even."""
    assert N % 2 == 0, "half-input inverse needs even N"
    R, S, _ = _idft_halfin_dims(N)
    ES, tw, ER = (Static(_idft_halfin_mat, (N, m)) for m in ("ES", "tw", "ER"))
    sh = tuple(x.rh.shape[:-1])
    M = N // 2
    # x[a + R b] == x[..., :M].reshape(S, R)[b, a]; contract b
    d1 = _pmap(x, lambda v: _swap(v[..., :M].reshape(sh + (S, R))))    # (..., a, b)
    H = _cmatmul_sliced(d1, ES, prof=prof, plain=plain)                 # (..., a, m)
    U = _pair_mul_static(H, tw)
    Y = _cmatmul_sliced(_pmap(U, _swap), ER, real_out=True, prof=prof,
                        plain=plain)                                   # (..., m, t)
    yh = _swap(Y.rh).reshape(sh + (N,))                                # n = m_ t + m
    yl = _swap(Y.rl).reshape(sh + (N,))
    # Nyquist column: + Re(x[N/2]) * (-1)^n  (sign and product exact)
    sj = table(Static(_alt_sign, (N,)), x.rh.device)
    nh, ne = _two_sum(yh, x.rh[..., M, None] * sj)
    nl = yl + x.rl[..., M, None] * sj + ne
    return CPair(nh, nl, None, None)


# ---------------------------------------------------------------------------
# exact windowed correlation from pair spectra
# ---------------------------------------------------------------------------


def _pair_hadamard_conj(A: CPair, B: CPair) -> CPair:
    """H = A * conj(B) elementwise, pair-accurate (~2^-48)."""
    prr, err = _two_prod(A.rh, B.rh)
    pii, eii = _two_prod(A.ih, B.ih)
    pri, eri = _two_prod(A.rh, B.ih)
    pir, eir = _two_prod(A.ih, B.rh)
    cr = err + eii + A.rh * B.rl + A.rl * B.rh + A.ih * B.il + A.il * B.ih
    ci = eir - eri + A.ih * B.rl + A.il * B.rh - A.rh * B.il - A.rl * B.ih
    hr, e1 = _two_sum(prr, pii)
    hi, e2 = _two_sum(pir, -pri)
    return CPair(hr, cr + e1, hi, ci + e2)


def _corr_emat(N0: int, N1: int, wx: int, wy: int, half: bool, name: str) -> np.ndarray:
    """"E1" (N1[h], R1) or "E0" (N0, R0): the partial inverse-DFT phase
    matrices (1/(N0*N1) folded into E0; half=True folds the Hermitian half
    with weight-2 interior columns)."""
    if name == "E0":
        lag0 = np.arange(-wx, wx + 1)
        return np.exp(2j * np.pi * np.outer(np.arange(N0), (-lag0) % N0) / N0) / (N0 * N1)
    lag1 = np.arange(-wy, wy + 1)
    n1 = N1 // 2 + 1 if half else N1
    E1 = np.exp(2j * np.pi * np.outer(np.arange(n1), (-lag1) % N1) / N1)
    if half:
        w = np.full(n1, 2.0)
        w[0] = 1.0
        if N1 % 2 == 0:
            w[-1] = 1.0
        E1 = w[:, None] * E1
    return E1


def exact_corr_window(specA: CPair, specB: CPair, N0: int, N1: int, wx: int, wy: int,
                      pairs: Optional[Tuple] = None, symmetric: bool = False,
                      chunk: Optional[int] = None, prof: Optional[SliceProfile] = None,
                      plain: bool = False) -> torch.Tensor:
    """CC(A_a, B_b)[rho, eps] for |rho| <= wx, |eps| <= wy, exact-grade.

    specA / specB: pair spectra stacks (Fa, N0, N1[h]) / (Fb, N0, N1[h]).
    Returns (Fa, Fb, 2wx+1, 2wy+1) f64; with `pairs` = (ia, jb):
    (npairs, R0, R1); symmetric=True computes the upper triangle of A x A
    and mirrors. Pairs run in chunks of `chunk` (sfft_tpu's size by
    default), each row sliced with its own scale, so a chunk's result does
    not depend on its neighbours."""
    Fa = specA.rh.shape[0]
    Fb = specB.rh.shape[0]
    half = specA.rh.shape[-1] != N1
    E0, E1 = (Static(_corr_emat, (N0, N1, wx, wy, half, m)) for m in ("E0", "E1"))
    if chunk is None:
        chunk = int(max(1, min(16, 2 ** 25 // (N0 * specA.rh.shape[-1]))))
    if symmetric:
        ia, jb = np.triu_indices(Fa)
    elif pairs is not None:
        ia, jb = (np.asarray(v) for v in pairs)
    else:
        ia, jb = [x.ravel() for x in
                  np.meshgrid(np.arange(Fa), np.arange(Fb), indexing="ij")]
    npairs = len(ia)
    dev = specA.rh.device

    outs = []
    for c0 in range(0, npairs, chunk):
        iaa = index(ia[c0:c0 + chunk], dev)
        jbb = index(jb[c0:c0 + chunk], dev)
        A = _pmap(specA, lambda v: v.index_select(0, iaa))
        B = _pmap(specB, lambda v: v.index_select(0, jbb))
        H = _pair_hadamard_conj(A, B)                                  # (c, N0, N1h)
        del A, B
        Y = _cmatmul_sliced(H, E1, rowwise=True, prof=prof, plain=plain)  # (c, N0, R1)
        del H
        # CC = Re(sum_k0 Y[k0] E0[k0]): only the real part is formed (the
        # same numbers as sfft_tpu's full product's real lanes)
        Z = _cmatmul_sliced(_pmap(Y, _swap), E0, rowwise=True, real_out=True, prof=prof,
                            plain=plain)                               # (c, R1, R0)
        outs.append(_swap(Z.rh.to(torch.float64) + Z.rl))              # (c, R0, R1)
    out = torch.cat(outs, dim=0)

    if symmetric:
        full = torch.zeros((Fa, Fa, 2 * wx + 1, 2 * wy + 1), dtype=out.dtype, device=dev)
        ia_t = index(ia, dev)
        jb_t = index(jb, dev)
        full[ia_t, jb_t] = out
        full[jb_t, ia_t] = torch.flip(out, dims=(1, 2))
        return full
    if pairs is not None:
        return out
    return out.reshape(Fa, Fb, 2 * wx + 1, 2 * wy + 1)
