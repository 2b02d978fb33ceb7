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
plain twin of K4, combines the products with the plain twin of K7
(``sliced_epilogue_plain``) and runs the pair products on the plain twin of
K6a (``pairs.pair_products_plain``) instead of the kernels. K7
(``sliced_epilogue``, csrc/sliced_epilogue.cu) is a sliced product's whole
epilogue: the group sums of the int32 products, the compensated chain, the
scale and the complex recombination, one launch per ``_cmatmul_sliced``
call. K6a (core/pairs.py ``pair_products``, csrc/pair_products.cu) is every
elementwise pair product here: the twiddles, A * conj(B), the basis and row
weightings, one launch per product.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# NB, the scale (_pow2ceil_scalar), the pad and K4's plain chain live beside
# the kernel wrappers in core/slicing.py
from sfft_tpu_torch.core.slicing import (NB, _padk, _pow2ceil_scalar, slice_pairs,
                                          slice_pairs_plain, slice_triple, slice_triple_plain)
from sfft_tpu_torch.core import pairs
from sfft_tpu_torch.core.pairs import CPair, _two_prod, _two_sum, pair_stack  # noqa: F401
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
# pair (double-float) helpers — all f32 elementwise (the pair type, TwoSum,
# TwoProd and the K6 kernels live in core/pairs.py)
# ---------------------------------------------------------------------------


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


def _row_block(W: np.ndarray, r0: int, r1: int) -> np.ndarray:
    """Rows [r0, r1) of a static table (a row block's share of a
    contraction over image or frequency rows)."""
    return W[r0:r1]


# ---------------------------------------------------------------------------
# integer slicing
# ---------------------------------------------------------------------------


def _slice_pairs(parts, nsl: int, Kp: int, rowwise: bool, plain: bool, scales=None,
                 batch: int = 0):
    """The K4 stage (core/slicing.py slice_pairs) on the operand's parts,
    or its plain twin with plain=True (CPU tensors always take the twin);
    scales: given scales, one per part; batch > 1: the leading axis holds
    that many pairs, each sliced under its own global scale."""
    if scales is None:
        return (slice_pairs_plain if plain else slice_pairs)(parts, nsl, Kp, rowwise, None,
                                                             batch)
    return (slice_pairs_plain if plain else slice_pairs)(parts, nsl, Kp, rowwise, scales)


def _slice_pair_real(hi: torch.Tensor, lo: torch.Tensor, nsl: int,
                     rowwise: bool = False, plain: bool = False):
    """(hi, lo) f32 -> (int8 slices stacked on axis 0, pow-2 scale):
    value == scale * sum_q slices[q] * 2^(-NB (q+1))  (+ O(2^(-NB nsl))).

    rowwise=True scales per row (max over the last axis, shape (..., 1));
    else one global scale (shape ()). The scale is taken from max|hi| before
    the TwoSum canonicalisation, as in sfft_tpu. CUDA tensors launch K4
    (core/slicing.py) unless plain=True; CPU tensors take its plain twin."""
    return _slice_pairs([(hi, lo)], nsl, hi.shape[-1], rowwise, plain)[0]


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


def _static_big(ref: Static, nsl: int) -> bool:
    """Whether the static table `ref` counts as big (>= 2^17 slice entries,
    its columns padded to 64): big tables are sliced on the device."""
    K, M = ref.host().shape
    return K * (M + (-M) % 64) * nsl >= 2 ** 17


@lru_cache(maxsize=256)
def _static_slices_for(ref: Static, nsl: int, device, plain: bool = False,
                       big: Optional[bool] = None) -> Optional[_Static]:
    """Integer slices of the static real matrix `ref`, built once per table,
    depth, device and slicer (plain=True slices big tables with K4's plain
    twin); None for an all-zero table. As in sfft_tpu, big tables (>= 2^17
    slice entries) are sliced from their f32 (hi, lo) pair by the data
    slicer (K4 on CUDA), small ones in f64 numpy; `big` overrides the size
    rule (a row block of a table sliced as the whole table is)."""
    padded = Static(_pad_cols, (ref, 64))
    Mp_ = np.asarray(padded.host(), np.float64)
    if not np.any(Mp_):
        return None
    K = Mp_.shape[0]
    Kp = K + (-K) % 8
    if (Mp_.size * nsl >= 2 ** 17) if big is None else big:
        # the stage slices the transposed view straight into (nsl, Mp, Kp)
        hi, lo = _split_on(padded, device)
        slT, s = _slice_pairs([(hi.t(), lo.t())], nsl, Kp, False, plain)[0]
    else:
        sl_np, s = _slice_static(Mp_, nsl)
        slT = _padk(torch.tensor(sl_np, device=device).transpose(1, 2), Kp).contiguous()
    # the key rebuilds these slices (``_stacked``): it carries an override
    return _Static((ref, nsl, device, plain) + (() if big is None else (big,)), slT, s)


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


def _int_mm(A: torch.Tensor, BT: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A (m, k) int8 @ BT.T with BT (n, k) int8 contiguous -> (m, n) int32,
    exact. k and n are multiples of 8 (callers pad); m <= 16 is padded,
    since torch._int_mm on CUDA needs more than 16 rows. out: a contiguous
    (max(m, 17), n) int32 buffer to write into (the padded rows too)."""
    m = A.shape[0]
    if m <= 16:
        A = F.pad(A, (0, 0, 0, 17 - m))
    if out is None:
        return torch._int_mm(A, BT.t())[:m]
    return torch._int_mm(A, BT.t(), out=out)[:m]


class _Epilogue(NamedTuple):
    """The host plan of one sliced product's epilogue (K7): how to read the
    int32 products (``_sliced_products``) and combine them.

    The products of data part d lie in ``P[d]``, viewed as slabs (nslab,
    rows, ncols) with strides (slab_stride, ncols, 1). Weight group g sums
    the values at (slab, column offset) of ``slabs[g]`` (one per group in
    the shallow route, the group's slice combos in the deep route) and
    carries ``weights[g]``; ``split``: the sums may pass f32's exact-integer
    range. A term (rr, ri, ir, ii) is (data part, first column of its static
    part, static scale: a float or a 0-d tensor), or None when its part is
    absent. mode 0: real data, the pair (rr, ri); 1: complex recombination;
    2: real_out (re only)."""

    lead: tuple
    M: int
    slabs: tuple
    weights: tuple
    split: bool
    slab_stride: int
    ncols: int
    terms: tuple
    mode: int


def _sliced_products(dsets, K: int, M: int, kmax: Optional[int], terms, mode: int):
    """The exact int8 slice products of one _cmatmul_sliced call and the plan
    of their epilogue: each data slice set (nsl_d, ..., Kp) of ``dsets``
    against its static slice sets (_Static parts with K true rows and M true
    columns), written into ONE int32 buffer P (data part first). terms: per
    term (rr, ri, ir, ii), (data part, index of the static part among that
    data part's, static scale) or None. Returns (P, _Epilogue).

    Deep K (>= 1024): one product per data part, its slices folded into
    the rows, against every static slice of every part; P[d] is (ni rows,
    ncols). Shallow K: one product per weight group with the group's slice
    pairs concatenated along the contraction axis and the parts along the
    output axis; P[d, g] is (rows, ncols). Rows are padded to 17 where the
    product needs it (``_int_mm``). Products accumulate in int32 exactly
    (|prod| <= 2^12, depth < 2^19)."""
    dsl0, parts0 = dsets[0]
    nsl_d = dsl0.shape[0]
    nsl_w = parts0[0].slT.shape[0]
    Mp = parts0[0].slT.shape[1]
    Kp = dsl0.shape[-1]
    lead = tuple(dsl0.shape[1:-1])
    rows = int(np.prod(lead, dtype=np.int64))
    groups = _group_combos(nsl_d, nsl_w, KMAX if kmax is None else kmax)
    assert 64 * 64 * Kp * max(len(c) for _, c in groups) < 2 ** 31, "int32 depth bound"
    weights = tuple(2.0 ** (-NB * (s_ + 2)) for s_, _ in groups)
    dev = dsl0.device

    if K >= 1024:
        ni = min(nsl_d, groups[-1][0] + 1)
        ncols = len(parts0) * nsl_w * Mp
        P = torch.empty((len(dsets), max(ni * rows, 17), ncols), dtype=torch.int32, device=dev)
        for d, (dsl, parts) in enumerate(dsets):
            _int_mm(dsl[:ni].reshape(-1, Kp), _stacked(tuple(q.key for q in parts), "deep"),
                    out=P[d])
        slabs = tuple(tuple((i, j * Mp) for i, j in combos) for _, combos in groups)
        split, slab_stride, pstride = True, rows * ncols, nsl_w * Mp
    else:
        ncols = len(parts0) * Mp
        P = torch.empty((len(dsets), len(groups), max(rows, 17), ncols), dtype=torch.int32,
                        device=dev)
        for d, (dsl, parts) in enumerate(dsets):
            keys = tuple(q.key for q in parts)
            for g, (s_, combos) in enumerate(groups):
                dcat = torch.cat([dsl[i] for i, _ in combos], dim=-1)
                _int_mm(dcat.reshape(-1, dcat.shape[-1]), _stacked(keys, tuple(combos)),
                        out=P[d, g])
        slabs = tuple(((g, 0),) for g in range(len(groups)))
        # exact-int32-in-f32 bound (sfft_tpu's): the leading slice reaches 64,
        # later ones stay <= 33, on the TRUE depth K
        split = 64 * 33 * max(len(c) for _, c in groups) * K >= 2 ** 24
        slab_stride, pstride = max(rows, 17) * ncols, Mp
    terms = tuple(None if t is None else (t[0], t[1] * pstride, t[2]) for t in terms)
    return P, _Epilogue(lead, M, slabs, weights, split, slab_stride, ncols, terms, mode)


def _scaled(s_d: torch.Tensor, s_w) -> torch.Tensor:
    """A term's scale: the data scale times the static one (powers of two)."""
    return s_d * (s_w if isinstance(s_w, torch.Tensor) else float(np.float32(s_w)))


def sliced_epilogue_plain(P: torch.Tensor, plan: _Epilogue, sd) -> CPair:
    """The plain PyTorch twin of K7 (the chain sfft_tpu's ``_sliced_dot_multi``
    and ``_cmatmul_sliced`` run after the products): for each term, the
    group sums of the int32 products (combos added in int32 in the deep
    route), ``_accum`` under the term's scale, then the recombination. sd:
    the data parts' scales (shape () or lead + (1,))."""
    lead, M = plan.lead, plan.M
    rows = int(np.prod(lead, dtype=np.int64))

    def term(t):
        if plan.terms[t] is None:
            return None
        d, base, s_w = plan.terms[t]
        S = P[d].as_strided((P[d].numel() // plan.slab_stride, rows, plan.ncols),
                            (plan.slab_stride, plan.ncols, 1))
        outs = []
        for combos in plan.slabs:
            acc = None
            for slab, off in combos:
                piece = S[slab][:, base + off: base + off + M]
                acc = piece if acc is None else acc + piece
            outs.append(acc.reshape(lead + (M,)))
        return _accum(outs, plan.weights, _scaled(sd[d], s_w), big=plan.split)

    rr_h, rr_l = term(0)
    if plan.mode == 2:
        ii_h, ii_l = term(3)
        zr_h, e1 = _two_sum(rr_h, -ii_h)
        return CPair(zr_h, rr_l - ii_l + e1, None, None)
    ri = term(1)
    ri_h, ri_l = ri if ri is not None else (torch.zeros_like(rr_h),) * 2
    if plan.mode == 0:
        return CPair(rr_h, rr_l, ri_h, ri_l)
    ir_h, ir_l = term(2)
    ii = term(3)
    ii_h, ii_l = ii if ii is not None else (torch.zeros_like(ir_h),) * 2
    # (r + i i)(wr + i wi): re = r wr - i wi ; im = r wi + i wr
    zr_h, e1 = _two_sum(rr_h, -ii_h)
    zr_l = rr_l - ii_l + e1
    zi_h, e2 = _two_sum(ri_h, ir_h)
    zi_l = ri_l + ir_l + e2
    return CPair(zr_h, zr_l, zi_h, zi_l)


_EPI_GROUPS = 9             # sliced_epilogue.cu kMaxGroups
_EPI_COMBOS = 9             # sliced_epilogue.cu kMaxCombos


class _EpiArgs(ctypes.Structure):
    """sliced_epilogue.cu ``Epi``."""
    _fields_ = [("prod", ctypes.c_void_p * 2), ("sd", ctypes.c_void_p * 2),
                ("swp", ctypes.c_void_p * 4), ("out", ctypes.c_void_p * 4),
                ("off", (ctypes.c_longlong * _EPI_COMBOS) * _EPI_GROUPS),
                ("row_stride", ctypes.c_longlong), ("rows", ctypes.c_longlong),
                ("w", ctypes.c_float * _EPI_GROUPS), ("swv", ctypes.c_float * 4),
                ("ncombo", ctypes.c_int * _EPI_GROUPS), ("term_d", ctypes.c_int * 4),
                ("term_base", ctypes.c_int * 4), ("M", ctypes.c_int), ("ngroups", ctypes.c_int),
                ("nbig", ctypes.c_int), ("split", ctypes.c_int), ("sd_rowwise", ctypes.c_int),
                ("mode", ctypes.c_int)]


def _epi_args(P: torch.Tensor, plan: _Epilogue, sd, outs) -> _EpiArgs:
    """K7's launch arguments (the plan as the kernel reads it): product and
    scale pointers, each combo's element offset from a row's start, the
    terms, and the number of leading groups that _chain sums by TwoSum."""
    a = _EpiArgs()
    for d in range(P.shape[0]):
        a.prod[d] = P[d].data_ptr()
    for d, s in enumerate(sd):
        a.sd[d] = s.data_ptr()
    a.sd_rowwise = int(sd[0].dim() > 0)
    for t, term in enumerate(plan.terms):
        if term is None:
            a.term_d[t] = -1
            continue
        d, base, s_w = term
        a.term_d[t], a.term_base[t] = d, base
        if isinstance(s_w, torch.Tensor):
            a.swp[t] = s_w.data_ptr()
        else:
            a.swv[t] = float(np.float32(s_w))
    for g, combos in enumerate(plan.slabs):
        a.ncombo[g] = len(combos)
        a.w[g] = plan.weights[g]
        for k, (slab, off) in enumerate(combos):
            a.off[g][k] = slab * plan.slab_stride + off
    a.row_stride, a.rows, a.M = plan.ncols, int(np.prod(plan.lead, dtype=np.int64)), plan.M
    a.ngroups = len(plan.slabs)
    w0 = plan.weights[0]
    a.nbig = sum(w > w0 * 2.0 ** -24 for w in plan.weights)   # _chain's big terms
    a.split, a.mode = int(plan.split), plan.mode
    for k, o in enumerate(outs):
        a.out[k] = o.data_ptr()
    return a


def sliced_epilogue(P: torch.Tensor, plan: _Epilogue, sd) -> CPair:
    """K7: the epilogue of one sliced product (``sliced_epilogue_plain``'s
    arguments) -> the CPair (lead + (M,)) the caller receives. CUDA tensors:
    one launch of csrc/sliced_epilogue.cu, bit-identical to the twin; CPU
    tensors: ``sliced_epilogue_plain``. ``sliced_epilogue.launches`` counts
    the launches."""
    if P.dtype != torch.int32 or not P.is_contiguous() or P.dim() < 3:
        raise ValueError("sliced_epilogue needs the contiguous int32 products")
    sd = list(sd)
    ndp = len(sd)
    if (sorted({t[0] for t in plan.terms if t is not None}) != list(range(ndp))
            or P.shape[0] != ndp or plan.terms[0] is None or plan.mode not in (0, 1, 2)):
        raise ValueError("sliced_epilogue: terms, data parts and scales disagree")
    shape = plan.lead + (1,)
    if any(s.dtype != torch.float32 or not s.is_contiguous() or s.device != P.device
           or tuple(s.shape) != tuple(sd[0].shape) or tuple(s.shape) not in ((), shape)
           for s in sd):
        raise ValueError("sliced_epilogue needs float32 data scales, all of shape () or all "
                         "of shape lead + (1,)")
    if any(isinstance(t[2], torch.Tensor) and (t[2].dtype != torch.float32 or t[2].dim() != 0
                                               or t[2].device != P.device)
           for t in plan.terms if t is not None):
        raise ValueError("sliced_epilogue needs 0-d float32 static scales on P's device")
    if P.device.type == "cpu":
        return sliced_epilogue_plain(P, plan, sd)
    if P.device.type != "cuda":
        raise ValueError(f"sliced_epilogue runs on cpu or cuda tensors, not {P.device}")
    n = int(np.prod(plan.lead, dtype=np.int64)) * plan.M
    if (len(plan.slabs) > _EPI_GROUPS or any(len(c) > _EPI_COMBOS for c in plan.slabs)
            or not 1 <= n < 2 ** 31):
        raise ValueError("sliced_epilogue: at most 9 weight groups of 9 combos, and a "
                         "non-empty output of fewer than 2^31 elements")
    from sfft_tpu_torch import _kernels

    outs = [torch.empty(plan.lead + (plan.M,), dtype=torch.float32, device=P.device)
            for _ in range(2 if plan.mode == 2 else 4)]
    a = _epi_args(P, plan, sd, outs)
    with torch.cuda.device(P.device):
        err = _kernels.lib().sfft_sliced_epilogue(ctypes.addressof(a), _kernels.stream_ptr(P))
    _K7.launches += 1
    _kernels.check(err, "sliced_epilogue kernel launch")
    return CPair(*outs) if len(outs) == 4 else CPair(outs[0], outs[1], None, None)


sliced_epilogue.launches = 0
# the counter's owner: the module attribute may be replaced by a caller
# that intercepts the calls (chip_smoke.py, the tests)
_K7 = sliced_epilogue


def _cmatmul_sliced(data: CPair, W: Static, rowwise: bool = False, real_out: bool = False,
                    prof: Optional[SliceProfile] = None, plain: bool = False, scales=None,
                    k_total: Optional[int] = None, static_big: Optional[bool] = None,
                    epilogue: bool = True, batch: int = 0):
    """Exact complex matmul: data (..., K) pair @ the static (complex or
    real) table W (K, M). Returns the pair (..., M). real_out=True (complex
    data and W): only the real part (re = dr.wr - di.wi). The int8 products
    go into one int32 buffer; their epilogue is K7 (``sliced_epilogue``,
    one launch on CUDA tensors) or, with plain=True, its twin.

    For a row block of a contraction split over devices (core of the
    row-sharded step): scales, the data parts' scales to slice with (the
    whole operand's); k_total, the whole contraction's depth (it picks the
    products' route and plan); static_big, the whole static table's slicing
    rule; epilogue=False returns (int32 products, epilogue plan, data
    scales) instead of the pair, so that the blocks' products sum exactly
    before one epilogue.

    batch > 1: the data's leading axis holds that many independent pairs
    (the batched step), and a global scale is taken per pair (the K4
    stage's per-pair mode), so that each pair's result is that of its
    single call: the int8 products are exact and the epilogue works row by
    row."""
    p = prof or SliceProfile(NSL_DATA, NSL_STATIC, KMAX)
    dev = data.rh.device
    K, M = W.host().shape
    Kp = K + (-K) % 8
    if static_big is None:
        wr = _static_slices_for(Static(np.real, (W,)), p.nsl_static, dev, plain)
        wi = _static_slices_for(Static(np.imag, (W,)), p.nsl_static, dev, plain)
    else:
        wr = _static_slices_for(Static(np.real, (W,)), p.nsl_static, dev, plain, static_big)
        wi = _static_slices_for(Static(np.imag, (W,)), p.nsl_static, dev, plain, static_big)
    have_wi = wi is not None
    parts = [wr, wi] if have_wi else [wr]
    # the producers' views as they are (transposed ones too): one K4 stage
    # for the real and the imaginary part, padded to Kp by the slicer
    pairs = [(data.rh, data.rl)] + ([] if data.is_real else [(data.ih, data.il)])
    sliced = _slice_pairs(pairs, p.nsl_data, Kp, rowwise, plain, scales, batch)
    sd = [s for _, s in sliced]
    if real_out and not data.is_real and have_wi:
        # re = dr.wr - di.wi: the two products alone
        dsets = [(sliced[0][0], [wr]), (sliced[1][0], [wi])]
        terms, mode = ((0, 0, wr.scale), None, None, (1, 0, wi.scale)), 2
    else:
        dsets = [(sl, parts) for sl, _ in sliced]
        ri = (0, 1, wi.scale) if have_wi else None
        ii = (1, 1, wi.scale) if have_wi else None
        terms, mode = (((0, 0, wr.scale), ri, None, None), 0) if data.is_real else \
            (((0, 0, wr.scale), ri, (1, 0, wr.scale), ii), 1)
    P, plan = _sliced_products(dsets, K if k_total is None else k_total, M, p.kmax, terms, mode)
    if not epilogue:
        return P, plan, sd
    return (sliced_epilogue_plain if plain else sliced_epilogue)(P, plan, sd)


def _common_scales(datas, rowwise: bool = False):
    """The data scales of one operand held as blocks on several devices:
    per part (real, imaginary) the power of two of the max of |hi| over all
    blocks (per row with rowwise: the rows are split over the blocks), which
    the K4 stage would have taken from the whole operand; one copy per
    block's device."""
    dev0 = datas[0].rh.device
    scales = []
    for lane in ((0, 2) if not datas[0].is_real else (0,)):
        m = None
        for d in datas:
            hi = d[lane]
            mk = (hi.abs().amax(dim=-1, keepdim=True) if rowwise else hi.abs().amax()).to(dev0)
            m = mk if m is None else torch.maximum(m, mk)
        s = _pow2ceil_scalar(m)
        scales.append([s.to(d.rh.device).contiguous() for d in datas])
    return [list(ss) for ss in zip(*scales)]


def _cmatmul_blocks(datas, W, rowwise: bool = False, real_out: bool = False,
                    prof: Optional[SliceProfile] = None, plain: bool = False,
                    batch: int = 0) -> list:
    """``_cmatmul_sliced`` of each block of an operand held as blocks (W one
    static table, or one per block), each block sliced as the whole operand
    would be (``_common_scales``; a rowwise product over full rows needs no
    common scale). One block is ``_cmatmul_sliced`` itself (with its
    ``batch``: a leading pair axis; blocks take none)."""
    Ws = [W] * len(datas) if isinstance(W, Static) else list(W)
    if len(datas) == 1:
        return [_cmatmul_sliced(datas[0], Ws[0], rowwise, real_out, prof, plain, batch=batch)]
    if batch > 1:
        raise ValueError("_cmatmul_blocks: row blocks of one pair, or one block of a batch")
    if rowwise:
        return [_cmatmul_sliced(d, w, rowwise, real_out, prof, plain) for d, w in zip(datas, Ws)]
    return [_cmatmul_sliced(d, w, rowwise, real_out, prof, plain, scales=s)
            for d, w, s in zip(datas, Ws, _common_scales(datas))]


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


def _k6a(plain: bool):
    """K6a (core/pairs.py pair_products), or its twin with plain=True; looked
    up at each call, so that a caller may intercept the module's wrapper."""
    return pairs.pair_products_plain if plain else pairs.pair_products


def _pair_mul_static(v: CPair, W: Static, plain: bool = False) -> CPair:
    """Elementwise complex pair product v * W with a static complex factor
    (broadcast over leading dims), accurate to ~2^-48 relative: one K6a
    launch on CUDA tensors."""
    dev = v.rh.device
    wr, wr_l = _split_on(Static(np.real, (W,)), dev)
    wi, wi_l = _split_on(Static(np.imag, (W,)), dev)
    return _k6a(plain)("mul_static", v, CPair(wr, wr_l, wi, wi_l))


def _pair_mul_static_rr(v: CPair, W: Static, plain: bool = False) -> CPair:
    """REAL pair * static REAL factor (broadcastable), ~2^-48 relative."""
    if not v.is_real:
        raise ValueError("_pair_mul_static_rr takes a real pair")
    wh, wl = _split_on(W, v.rh.device)
    return _k6a(plain)("mul_static_rr", v, CPair(wh, wl, None, None))


def pair_sep_mul(p: CPair, u: Static, v: Static, plain: bool = False) -> CPair:
    """p * u * v for a real pair p (N0, N1) and static factors u (N0, 1) and
    v (1, N1): exact-grade basis-plane weighting in pair arithmetic, the two
    products in one K6a launch."""
    dev = p.rh.device
    return _k6a(plain)("sep_mul", p, CPair(*_split_on(u, dev), None, None),
                       CPair(*_split_on(v, dev), None, None))


def _swap(v: torch.Tensor) -> torch.Tensor:
    return v.transpose(-1, -2)


def exact_dft_axis(x: CPair, N: int, inverse: bool = False, real_out: bool = False,
                   half_out: bool = False, prof: Optional[SliceProfile] = None,
                   plain: bool = False, batch: int = 0) -> CPair:
    """Exact-grade DFT over the LAST axis (length N) of a pair tensor.

    real_out=True: only the real part of the transform (a real pair).
    half_out=True: only bins k <= N//2 (the Hermitian half for real input);
    the second stage then runs at half width. batch > 1: the leading axis
    holds that many independent pairs, each transformed as its single call
    (``_cmatmul_sliced``)."""
    return exact_dft_axis_blocks([x], N, inverse, real_out, half_out, prof, plain, batch)[0]


def exact_dft_axis_blocks(xs, N: int, inverse: bool = False, real_out: bool = False,
                          half_out: bool = False, prof: Optional[SliceProfile] = None,
                          plain: bool = False, batch: int = 0) -> list:
    """``exact_dft_axis`` of one operand held as blocks (split along a
    leading axis, each on its own device): each stage's products slice
    every block as the whole operand would be (``_cmatmul_blocks``), so
    block k's result is the rows of the whole operand's result."""
    R, S = _factor(N)
    DS, DR, tw = (Static(_dft_stage_mat, (N, inverse, m)) for m in ("DS", "DR", "tw"))
    shs = [tuple(x.rh.shape[:-1]) for x in xs]
    # layout (..., b, a): x[a + R b] == x.reshape(S, R)[b, a]
    datas = [_pmap(x, lambda v, sh=sh: v.reshape(sh + (S, R))) for x, sh in zip(xs, shs)]
    if R == 1:
        # prime N: one full DFT product over b (depth N)
        DSc = Static(_cols, (DS, N // 2 + 1)) if half_out else DS
        return _cmatmul_blocks([_pmap(d, lambda v: v[..., 0]) for d in datas], DSc,
                               real_out=real_out, prof=prof, plain=plain, batch=batch)
    # stage 1: G[a, d] = sum_b x[b, a] DS[b, d] — contraction axis last
    Gs = _cmatmul_blocks([_pmap(d, _swap) for d in datas], DS, prof=prof, plain=plain,
                         batch=batch)
    Us = [_pair_mul_static(G, tw, plain) for G in Gs]
    # stage 2: X[S c + d] = sum_a U[a, d] DR[a, c]
    Rc = R // 2 + 1 if half_out else R
    DRc = Static(_cols, (DR, Rc)) if half_out else DR
    Vs = _cmatmul_blocks([_pmap(U, _swap) for U in Us], DRc, real_out=real_out, prof=prof,
                         plain=plain, batch=batch)                   # (..., d, c)
    Nc = N // 2 + 1 if half_out else N

    def fin(v, sh):
        v = _swap(v).reshape(sh + (Rc * S,))                        # k = S c + d
        return v[..., :Nc] if half_out else v

    return [_pmap(V, lambda v, sh=sh: fin(v, sh)) for V, sh in zip(Vs, shs)]


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
    transform); the legs and the axis-0 bodies run one plane at a time.
    Planes (B, N0, N1) are a batch of pairs: the result is (B, planes, N0,
    N1h), each pair's spectra those of its single call (one set of launches
    for the batch)."""
    # sfft_tpu transforms only the real lanes of the inputs and would drop
    # imaginary parts silently: take real pairs only
    if not base.is_real or any(not h.is_real for h in head):
        raise ValueError("exact_sep_weighted_spectra takes real pairs only")
    nh = len(head)
    firsts, vsrc = _distinct_rows(V)
    N0 = base.rh.shape[-2]
    N1 = base.rh.shape[-1]
    dev = base.rh.device
    batch = base.rh.shape[0] if base.rh.dim() == 3 else 0

    planes1 = list(head)
    for k, ones in firsts:
        planes1.append(base if ones else _pair_mul_static_rr(base, Static(_row, (V, k)), plain))
    T = [exact_dft_axis(pl_, N1, half_out=True, prof=prof, plain=plain, batch=batch)
         for pl_ in planes1]
    del planes1

    src = np.concatenate([np.arange(nh), nh + np.asarray(vsrc, dtype=np.int64)])
    Wh, Wl = _split_on(Static(_ones_above, (U, nh)), dev)
    out = []
    for k, t in enumerate(src):
        # the row weighting: both lanes of the spectrum times U[k] (one K6a
        # launch)
        z = _k6a(plain)("mul_static_rr", T[int(t)], CPair(Wh[k][:, None], Wl[k][:, None],
                                                          None, None))
        zt = exact_dft_axis(_pmap(z, _swap), N0, prof=prof, plain=plain, batch=batch)
        out.append(_pmap(zt, _swap))
    return pair_stack(out, dim=-3)


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
                           plain: bool = False, batch: int = 0) -> CPair:
    """Real inverse DFT over the last axis from the FOLDED Hermitian half.

    x: pair (..., N//2+1), fold weights already applied (2 for interior
    columns, 1 for DC and Nyquist). Returns the real pair
    y[n] = Re(sum_{k<=N/2} x[k] e^{+2 pi i k n/N}) without the 1/N scale.
    N must be even. batch > 1: a leading axis of that many pairs, each
    transformed as its single call."""
    return exact_idft_halfin_real_blocks([x], N, prof, plain, batch)[0]


def exact_idft_halfin_real_blocks(xs, N: int, prof: Optional[SliceProfile] = None,
                                  plain: bool = False, batch: int = 0) -> list:
    """``exact_idft_halfin_real`` of one operand held as blocks (split along
    a leading axis), each block sliced as the whole operand would be."""
    assert N % 2 == 0, "half-input inverse needs even N"
    R, S, _ = _idft_halfin_dims(N)
    ES, tw, ER = (Static(_idft_halfin_mat, (N, m)) for m in ("ES", "tw", "ER"))
    shs = [tuple(x.rh.shape[:-1]) for x in xs]
    M = N // 2
    # x[a + R b] == x[..., :M].reshape(S, R)[b, a]; contract b
    d1s = [_pmap(x, lambda v, sh=sh: _swap(v[..., :M].reshape(sh + (S, R))))
           for x, sh in zip(xs, shs)]                                  # (..., a, b)
    Hs = _cmatmul_blocks(d1s, ES, prof=prof, plain=plain, batch=batch)  # (..., a, m)
    Us = [_pair_mul_static(H, tw, plain) for H in Hs]
    Ys = _cmatmul_blocks([_pmap(U, _swap) for U in Us], ER, real_out=True, prof=prof,
                         plain=plain, batch=batch)                     # (..., m, t)
    out = []
    for x, Y, sh in zip(xs, Ys, shs):
        yh = _swap(Y.rh).reshape(sh + (N,))                            # n = m_ t + m
        yl = _swap(Y.rl).reshape(sh + (N,))
        # Nyquist column: + Re(x[N/2]) * (-1)^n  (sign and product exact)
        sj = table(Static(_alt_sign, (N,)), x.rh.device)
        nh, ne = _two_sum(yh, x.rh[..., M, None] * sj)
        nl = yl + x.rl[..., M, None] * sj + ne
        out.append(CPair(nh, nl, None, None))
    return out


# ---------------------------------------------------------------------------
# exact windowed correlation from pair spectra
# ---------------------------------------------------------------------------


def _pair_hadamard_conj(A: CPair, B: CPair, plain: bool = False) -> CPair:
    """H = A * conj(B) elementwise, pair-accurate (~2^-48): one K6a launch
    on CUDA tensors."""
    return _k6a(plain)("hadamard_conj", A, B)


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
    not depend on its neighbours. Stacks with a leading axis of B image
    pairs, (B, Fa, N0, N1[h]), give each image pair's windows, (B, ...):
    a chunk takes its plane pairs of every image pair in one set of
    launches."""
    Fa = specA.rh.shape[-3]
    Fb = specB.rh.shape[-3]
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
        A = _pmap(specA, lambda v: v.index_select(-3, iaa))
        B = _pmap(specB, lambda v: v.index_select(-3, jbb))
        H = _pair_hadamard_conj(A, B, plain)                           # (c, N0, N1h)
        del A, B
        Y = _cmatmul_sliced(H, E1, rowwise=True, prof=prof, plain=plain)  # (c, N0, R1)
        del H
        # CC = Re(sum_k0 Y[k0] E0[k0]): only the real part is formed (the
        # same numbers as sfft_tpu's full product's real lanes)
        Z = _cmatmul_sliced(_pmap(Y, _swap), E0, rowwise=True, real_out=True, prof=prof,
                            plain=plain)                               # (c, R1, R0)
        outs.append(_swap(Z.rh.to(torch.float64) + Z.rl))              # (c, R0, R1)
    out = torch.cat(outs, dim=-3)
    lead = tuple(out.shape[:-3])

    if symmetric:
        full = torch.zeros(lead + (Fa, Fa, 2 * wx + 1, 2 * wy + 1), dtype=out.dtype, device=dev)
        ia_t = index(ia, dev)
        jb_t = index(jb, dev)
        full[..., ia_t, jb_t, :, :] = out
        full[..., jb_t, ia_t, :, :] = torch.flip(out, dims=(-2, -1))
        return full
    if pairs is not None:
        return out
    return out.reshape(lead + (Fa, Fb, 2 * wx + 1, 2 * wy + 1))
