"""The exact paths' f32 pair arithmetic and its kernels, K6 (counterpart
of the pair helpers of sfft_tpu/core/exact_fft.py and sfft_tpu/core/pexact.py).

Numbers ride as PAIRS of f32 planes (hi + lo, ~48 bits): products by
Dekker's TwoProd, sums by Knuth's TwoSum, every operation one f32 operation
rounded to nearest, with no fused multiply-add. On the TPU XLA fused these
chains into the passes around them; run op by op they are ~15 eager
launches per TwoProd. Three kernels compute them, each bit for bit with its
plain twin here:

  * K6a ``pair_products`` (csrc/pair_products.cu): elementwise products by
    mode. 'hadamard_conj': A * conj(B) of two complex pairs (the windowed
    correlations' spectra products); 'mul_static': a complex pair times a
    static complex table (the DFT twiddles); 'mul_static_rr': a real pair,
    or both lanes of a complex one, times a static real table (basis rows,
    the row weighting of the separable spectra, a scalar); 'sep_mul': two
    such real tables chained (the separable basis weights). Operands
    broadcast against each other, with any strides;
  * K6m ``pair_model`` (csrc/pair_model.cu): the exact difference's model
    spectrum, sp[0] - SCALE * (sum_i sp[1+i] (K_i + c_i) + sum_s a00_s
    sp[1+Fk+s]), compensated, times the Hermitian fold, in one pass;
  * K6p (csrc/pair_poly.cu): a polynomial's grid evaluation, sum_s U[s, x]
    M[s, y], with what consumes it, in three modes of one kernel:
    ``pair_poly`` the pair plane; ``pair_poly_sub`` an f64 image minus the
    plane, as a pair (pexact's fluctuations); ``pair_poly_add64`` a pair
    plus the plane, materialised in f64 (pexact's difference).

CUDA tensors launch the kernel or raise; CPU tensors take the twin. The
callers take the twins on the card with ``plain=True``. Each wrapper counts
its launches (``pair_products.launches``, ...; K6p's three modes on
``pair_poly.launches``) on a fixed alias, so that a caller that replaces the
module attribute to intercept the calls loses no counts.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch


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


def _planes(p: CPair):
    return [v for v in p if v is not None]


def _layout(v: torch.Tensor):
    """v's strides along its axes of extent > 1 (the others address nothing)."""
    return tuple(st for st, n in zip(v.stride(), v.shape) if n != 1)


# ---------------------------------------------------------------------------
# K6a: elementwise pair products
# ---------------------------------------------------------------------------

MODES = ("hadamard_conj", "mul_static", "mul_static_rr", "sep_mul")


def _rr(h, l, wh, wl):
    """(h, l) * (wh, wl), a real pair times a real factor: (p, e + h wl + l wh)."""
    p, e = _two_prod(h, wh.expand(torch.broadcast_shapes(h.shape, wh.shape)))
    return p, e + h * wl + l * wh


def pair_products_plain(mode: str, A: CPair, B: CPair, C: Optional[CPair] = None) -> CPair:
    """The plain twin of K6a (sfft_tpu's pair helpers, term for term).

    hadamard_conj: A * conj(B); mul_static: A * B with B the static
    complex factor as (re hi, re lo, im hi, im lo); mul_static_rr: A * B
    with B a real factor, on each lane of A; sep_mul: (A * B) * C for a
    real A and real factors B and C."""
    if mode == "hadamard_conj":
        prr, err = _two_prod(A.rh, B.rh)
        pii, eii = _two_prod(A.ih, B.ih)
        pri, eri = _two_prod(A.rh, B.ih)
        pir, eir = _two_prod(A.ih, B.rh)
        cr = err + eii + A.rh * B.rl + A.rl * B.rh + A.ih * B.il + A.il * B.ih
        ci = eir - eri + A.ih * B.rl + A.il * B.rh - A.rh * B.il - A.rl * B.ih
        hr, e1 = _two_sum(prr, pii)
        hi, e2 = _two_sum(pir, -pri)
        return CPair(hr, cr + e1, hi, ci + e2)
    if mode == "mul_static":
        wr, wr_l, wi, wi_l = B
        prr, err = _two_prod(A.rh, wr)
        pii, eii = _two_prod(A.ih, wi)
        pri, eri = _two_prod(A.rh, wi)
        pir, eir = _two_prod(A.ih, wr)
        cr = err - eii + A.rh * wr_l + A.rl * wr - A.ih * wi_l - A.il * wi
        ci = eri + eir + A.rh * wi_l + A.rl * wi + A.ih * wr_l + A.il * wr
        ur, e1 = _two_sum(prr, -pii)
        ui, e2 = _two_sum(pri, pir)
        return CPair(ur, cr + e1, ui, ci + e2)
    if mode == "mul_static_rr":
        rh, rl = _rr(A.rh, A.rl, B.rh, B.rl)
        if A.is_real:
            return CPair(rh, rl, None, None)
        return CPair(rh, rl, *_rr(A.ih, A.il, B.rh, B.rl))
    if mode == "sep_mul":
        return pair_products_plain("mul_static_rr",
                                   pair_products_plain("mul_static_rr", A, B), C)
    raise ValueError(f"pair_products: unknown mode {mode!r}")


class _PPArgs(ctypes.Structure):
    """csrc/pair_products.cu ``PP``."""
    _fields_ = [("a", ctypes.c_void_p * 4), ("b", ctypes.c_void_p * 4),
                ("c", ctypes.c_void_p * 2), ("out", ctypes.c_void_p * 4),
                ("sa", ctypes.c_longlong * 4), ("sb", ctypes.c_longlong * 4),
                ("sc", ctypes.c_longlong * 4), ("size", ctypes.c_uint * 4),
                ("n", ctypes.c_uint), ("nd", ctypes.c_int), ("mode", ctypes.c_int)]


# the kernel's modes: sfft_pair_products' switch
_KMODE = {("hadamard_conj", False): 0, ("mul_static", False): 1, ("mul_static_rr", True): 2,
          ("mul_static_rr", False): 3, ("sep_mul", True): 4}


def _pp_check(mode, A, B, C):
    """The operands' rules; returns the broadcast output shape."""
    if mode not in MODES:
        raise ValueError(f"pair_products: unknown mode {mode!r}")
    complex_a = mode in ("hadamard_conj", "mul_static")
    if A.is_real == complex_a and mode != "mul_static_rr":
        raise ValueError(f"pair_products {mode}: A must be a "
                         f"{'complex' if complex_a else 'real'} pair")
    if B.is_real == complex_a:
        raise ValueError(f"pair_products {mode}: B must be a "
                         f"{'complex' if complex_a else 'real'} pair")
    if (C is not None) != (mode == "sep_mul") or (C is not None and not C.is_real):
        raise ValueError("pair_products: sep_mul and only sep_mul takes a real C")
    ops = [A, B] + ([C] if C is not None else [])
    planes = [v for p in ops for v in _planes(p)]
    if any(v.dtype != torch.float32 for v in planes):
        raise ValueError("pair_products takes float32 planes")
    if any(v.device != A.rh.device for v in planes):
        raise ValueError("pair_products operands on more than one device")
    if any(len({tuple(v.shape) for v in _planes(p)}) != 1 for p in ops):
        raise ValueError("pair_products: the planes of an operand differ in shape")
    try:
        return tuple(torch.broadcast_shapes(*(p.rh.shape for p in ops)))
    except RuntimeError as err:
        raise ValueError(f"pair_products: shapes do not broadcast ({err})") from None


def _pp_plan(shape, strides):
    """Collapse the output shape for the kernel: drop extent-1 axes and merge
    neighbours along which every operand's (broadcast) strides run on, as
    one contiguous output does. strides: per operand, its element strides
    broadcast into shape. Returns (sizes, per operand strides), innermost
    axis first."""
    dims = [(n, [s[k] for s in strides]) for k, n in enumerate(shape) if n != 1]
    out = []
    for n, st in reversed(dims):
        if out and all(s == o * out[-1][0] for s, o in zip(st, out[-1][1])):
            out[-1] = (out[-1][0] * n, out[-1][1])
        else:
            out.append((n, st))
    if not out:
        out = [(1, [0] * len(strides))]
    return [n for n, _ in out], [[st[i] for _, st in out] for i in range(len(strides))]


def _pp_outs(A: CPair, shape, nout: int):
    """K6a's fresh output planes: in A's layout where A spans the output and
    is dense (a transposed image plane gives transposed outputs, as the
    twin's elementwise operations do, so that the kernel reads A in memory
    order), else contiguous."""
    if tuple(A.rh.shape) == tuple(shape):
        return [torch.empty_like(A.rh) for _ in range(nout)]
    return [torch.empty(shape, dtype=torch.float32, device=A.rh.device) for _ in range(nout)]


def _pp_args(mode, A, B, C, shape, outs):
    """K6a's launch arguments: plane pointers, the collapsed sizes and each
    operand's strides, with the axes ordered as the (dense) outputs lie in
    memory (an operand whose planes differ in strides is made contiguous
    first; the copies count on ``pair_products.copies``)."""
    ops = [A, B] + ([C] if C is not None else [])
    views = []
    for p in ops:
        vs = _planes(p)
        if len({_layout(v) for v in vs}) != 1:
            vs = [v.contiguous() for v in vs]
            _K6A.copies += len(vs)
        views.append([v.expand(shape) for v in vs])
    order = sorted(range(len(shape)), key=lambda k: -outs[0].stride(k))
    sizes, strides = _pp_plan([shape[k] for k in order],
                              [[vs[0].stride(k) for k in order] for vs in views])
    if len(sizes) > 4:
        raise ValueError("pair_products: more than 4 axes after collapsing")
    a = _PPArgs()
    for field, vs in zip(("a", "b", "c"), views):
        for k, v in enumerate(vs):
            getattr(a, field)[k] = v.data_ptr()
    for field, st in zip(("sa", "sb", "sc"), strides):
        for k, s in enumerate(st):
            getattr(a, field)[k] = s
    for k, n in enumerate(sizes):
        a.size[k] = n
    for k, o in enumerate(outs):
        a.out[k] = o.data_ptr()
    a.n, a.nd = int(np.prod(shape, dtype=np.int64)), len(sizes)
    a.mode = _KMODE[(mode, A.is_real)]
    return a, views


def pair_products(mode: str, A: CPair, B: CPair, C: Optional[CPair] = None) -> CPair:
    """K6a: ``pair_products_plain(mode, A, B, C)`` as one kernel launch on
    CUDA tensors (bit for bit), the twin on CPU tensors. The output is a
    fresh CPair of the operands' broadcast shape (``_pp_outs``); nothing is
    written in place. ``pair_products.launches`` counts the launches."""
    shape = _pp_check(mode, A, B, C)
    dev = A.rh.device
    if dev.type == "cpu":
        return pair_products_plain(mode, A, B, C)
    if dev.type != "cuda":
        raise ValueError(f"pair_products runs on cpu or cuda tensors, not {dev}")
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2 ** 31:
        raise ValueError("pair_products: an output of fewer than 2^31 elements")
    from sfft_tpu_torch import _kernels

    nout = 2 if A.is_real else 4
    outs = _pp_outs(A, shape, nout)
    if n == 0:
        return CPair(*outs) if nout == 4 else CPair(outs[0], outs[1], None, None)
    a, _views = _pp_args(mode, A, B, C, shape, outs)
    with torch.cuda.device(dev):
        err = _kernels.lib().sfft_pair_products(ctypes.addressof(a), _kernels.stream_ptr(A.rh))
    _K6A.launches += 1
    _kernels.check(err, "pair_products kernel launch")
    return CPair(*outs) if nout == 4 else CPair(outs[0], outs[1], None, None)


pair_products.launches = 0
pair_products.copies = 0
# the counters' owner: the module attribute may be replaced by a caller that
# intercepts the calls (chip_smoke.py, the tests)
_K6A = pair_products


# ---------------------------------------------------------------------------
# K6m: the exact model spectrum
# ---------------------------------------------------------------------------


def _split64(c):
    """An f64 scalar as an f32 pair (hi, lo)."""
    c32 = c.to(torch.float32)
    return c32, (c - c32.to(torch.float64)).to(torch.float32)


def _scale_pair(P: CPair, c32, cres) -> CPair:
    """pair * (c32 + cres), compensated (TwoProd on the hi lane)."""
    pr, er = _two_prod(P.rh, c32.expand(P.rh.shape))
    pi, ei = _two_prod(P.ih, c32.expand(P.ih.shape))
    return CPair(pr, er + P.rl * c32 + P.rh * cres, pi, ei + P.il * c32 + P.ih * cres)


def _plane(P: CPair, k: int) -> CPair:
    return CPair(*(None if v is None else v[k] for v in P))


def pair_stack(parts, dim: int = 0) -> CPair:
    """CPairs stacked along a new axis `dim` (imag parts must match)."""
    return CPair(*(None if vs[0] is None else torch.stack(vs, dim=dim) for vs in zip(*parts)))


def pair_model_spectrum_plain(sp: CPair, K: CPair, c: torch.Tensor,
                              a00: Optional[torch.Tensor], scale,
                              fold: Optional[torch.Tensor]) -> CPair:
    """The plain twin of K6m: the exact difference's model spectrum
    (sfft_tpu's fdiff_exact / fdiff_pexact loop, term for term).

    sp: the plane spectra (P, N0, N1h) pair, [J] + the Fk basis-weighted
    planes (+ the scaling planes); K: the kernel spectra (Fk, N0, N1h); c:
    (Fk,) f64 shifts of K_i; a00: (nss,) f64 weights of the scaling planes
    sp[1+Fk+s] (SEPARATE-VARYING), or None; scale: SCALE as two 0-d f32
    tensors (hi, lo); fold: (N1h,) f32 Hermitian-fold weights, or None.
    Returns FD = sp[0] - SCALE * acc (times fold), acc the compensated sum
    over i of sp[1+i] * (K_i + c_i) (A * conj(conj B)), then over s of
    a00_s sp[1+Fk+s].

    A batch of B image pairs (sp (B, P, N0, N1h), K (B, Fk, N0, N1h), c
    (B, Fk), a00 (B, nss)) gives (B, N0, N1h): each pair's spectrum as its
    single call computes it."""
    if sp.rh.dim() == 4:
        return pair_stack([pair_model_spectrum_plain(_plane(sp, b), _plane(K, b), c[b],
                                                 None if a00 is None else a00[b], scale, fold)
                       for b in range(sp.rh.shape[0])])
    Fk = K.rh.shape[0]
    acc = None

    def addp(acc, term):
        if acc is None:
            return term
        hr, er = _two_sum(acc.rh, term.rh)
        hi, ei = _two_sum(acc.ih, term.ih)
        return CPair(hr, acc.rl + term.rl + er, hi, acc.il + term.il + ei)

    for i in range(Fk):
        c32, cres = _split64(c[i])
        Kr = _plane(K, i)
        h, e = _two_sum(Kr.rh, c32.expand(Kr.rh.shape))
        acc = addp(acc, pair_products_plain("hadamard_conj", _plane(sp, 1 + i),
                                            CPair(h, Kr.rl + e + cres, -Kr.ih, -Kr.il)))
    for s in range(0 if a00 is None else a00.shape[0]):
        acc = addp(acc, _scale_pair(_plane(sp, 1 + Fk + s), *_split64(a00[s])))
    m = _scale_pair(acc, *scale)
    dr, er = _two_sum(sp.rh[0], -m.rh)
    di, ei = _two_sum(sp.ih[0], -m.ih)
    FD = CPair(dr, sp.rl[0] - m.rl + er, di, sp.il[0] - m.il + ei)
    if fold is not None:
        FD = CPair(*(v * fold for v in FD))
    return FD


class _PMArgs(ctypes.Structure):
    """csrc/pair_model.cu ``PM``."""
    _fields_ = [("sp", ctypes.c_void_p * 4), ("k", ctypes.c_void_p * 4),
                ("c", ctypes.c_void_p), ("a00", ctypes.c_void_p),
                ("scale", ctypes.c_void_p * 2), ("fold", ctypes.c_void_p),
                ("out", ctypes.c_void_p * 4), ("sps", ctypes.c_longlong * 4),
                ("ks", ctypes.c_longlong * 4), ("N0", ctypes.c_int), ("N1h", ctypes.c_int),
                ("Fk", ctypes.c_int), ("nss", ctypes.c_int)]


def _pm_check(sp, K, c, a00, scale, fold):
    if sp.is_real or K.is_real:
        raise ValueError("pair_model: sp and K must be complex pairs")
    tensors = _planes(sp) + _planes(K) + list(scale) + ([] if fold is None else [fold])
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("pair_model: float32 planes, scale and fold")
    if c.dtype != torch.float64 or (a00 is not None and a00.dtype != torch.float64):
        raise ValueError("pair_model: c and a00 are float64")
    dev = sp.rh.device
    if any(t.device != dev for t in tensors + [c] + ([] if a00 is None else [a00])):
        raise ValueError("pair_model operands on more than one device")
    if sp.rh.dim() not in (3, 4) or any(v.shape != sp.rh.shape for v in _planes(sp)):
        raise ValueError("pair_model: sp is a (P, N0, N1h) pair, or (B, P, N0, N1h)")
    lead = tuple(sp.rh.shape[:-3])
    Fk, N0, N1h = K.rh.shape[-3:] if K.rh.dim() == 3 + len(lead) else (0, 0, 0)
    nss = 0 if a00 is None else a00.shape[-1]
    if (Fk < 1 or any(tuple(v.shape) != lead + (Fk, N0, N1h) for v in _planes(K))
            or tuple(sp.rh.shape[-2:]) != (N0, N1h) or sp.rh.shape[-3] < 1 + Fk + nss
            or tuple(c.shape) != lead + (Fk,)
            or (a00 is not None and tuple(a00.shape) != lead + (nss,))
            or len(scale) != 2 or any(s.dim() != 0 for s in scale)
            or (fold is not None and tuple(fold.shape) != (N1h,))):
        raise ValueError("pair_model: inconsistent shapes")
    return Fk, N0, N1h, nss, (lead[0] if lead else 1)


def _same_strides(vs):
    """The planes as they are when they share strides, else contiguous
    (the copies count on ``pair_model.copies``)."""
    if len({_layout(v) for v in vs}) == 1:
        return vs
    _K6M.copies += len(vs)
    return [v.contiguous() for v in vs]


def pair_model(sp: CPair, K: CPair, c: torch.Tensor, a00: Optional[torch.Tensor], scale,
               fold: Optional[torch.Tensor]) -> CPair:
    """K6m: ``pair_model_spectrum_plain``'s model spectrum as one kernel
    launch on CUDA tensors (bit for bit; the scalars c, a00 and SCALE are
    read on the device, nothing is copied to the host), the twin on CPU
    tensors; a batch of image pairs (a leading axis on sp, K, c and a00)
    in one launch, the pair on the grid's y axis, each pair's spectrum
    that of its single call. ``pair_model.launches`` counts the
    launches."""
    Fk, N0, N1h, nss, B = _pm_check(sp, K, c, a00, scale, fold)
    dev = sp.rh.device
    if dev.type == "cpu":
        return pair_model_spectrum_plain(sp, K, c, a00, scale, fold)
    if dev.type != "cuda":
        raise ValueError(f"pair_model runs on cpu or cuda tensors, not {dev}")
    if N0 * N1h >= 2 ** 31 or B > 65535:
        raise ValueError("pair_model: planes of fewer than 2^31 elements, at most 65535 pairs")
    from sfft_tpu_torch import _kernels

    lead = tuple(sp.rh.shape[:-3])
    outs = [torch.empty(lead + (N0, N1h), dtype=torch.float32, device=dev) for _ in range(4)]
    sps, ks = _same_strides(_planes(sp)), _same_strides(_planes(K))
    c = c.contiguous()
    a00 = None if a00 is None else a00.contiguous()
    fold = None if fold is None else fold.contiguous()
    a = _PMArgs()
    for k in range(4):
        a.sp[k], a.k[k], a.out[k] = sps[k].data_ptr(), ks[k].data_ptr(), outs[k].data_ptr()
    # (pair, plane, row, column) strides; the pair's is unused without one
    a.sps[:] = (sps[0].stride(0) if lead else 0,) + sps[0].stride()[-3:]
    a.ks[:] = (ks[0].stride(0) if lead else 0,) + ks[0].stride()[-3:]
    a.c = c.data_ptr()
    a.a00 = None if a00 is None else a00.data_ptr()
    a.scale[0], a.scale[1] = scale[0].data_ptr(), scale[1].data_ptr()
    a.fold = None if fold is None else fold.data_ptr()
    a.N0, a.N1h, a.Fk, a.nss = N0, N1h, Fk, nss
    with torch.cuda.device(dev):
        err = _kernels.lib().sfft_pair_model(ctypes.addressof(a), B, _kernels.stream_ptr(sp.rh))
    _K6M.launches += 1
    _kernels.check(err, "pair_model kernel launch")
    return CPair(*outs)


pair_model.launches = 0
pair_model.copies = 0
_K6M = pair_model


# ---------------------------------------------------------------------------
# K6p: the pair polynomial plane
# ---------------------------------------------------------------------------


def pair_poly_plain(Uh, Ul, Mh, Ml) -> CPair:
    """The plain twin of K6p's plane mode (sfft_tpu's pair_poly_plane loop):
    the real pair (N0, N1) of sum_s (Uh + Ul)[s, x] (Mh + Ml)[s, y], TwoProd
    of the hi parts, TwoSum into hi, the cross and error terms into lo, in
    s's order."""
    hi = lo = None
    for s in range(Uh.shape[0]):
        uh, ul = Uh[s][:, None], Ul[s][:, None]
        p, e = _two_prod(uh, Mh[s][None, :])
        plo = e + uh * Ml[s][None, :] + ul * Mh[s][None, :]
        if hi is None:
            hi, lo = p, plo
        else:
            hi, e2 = _two_sum(hi, p)
            lo = lo + plo + e2
    return CPair(hi, lo, None, None)


def _table_of(t: torch.Tensor, b: int) -> torch.Tensor:
    """Pair b's table: its own (a (B, SP, n) stack) or the shared (SP, n)."""
    return t[b] if t.dim() == 3 else t


def pair_poly_sub_plain(I, Uh, Ul, Mh, Ml) -> CPair:
    """The plain twin of K6p's sub mode: pair(I) - the plane, for an f64
    image I (sfft_tpu's pexact fluctuation, pair_sub(pair_from_f64(I),
    pair_poly_plane(...))): hi by TwoSum(f32(I), -plane.hi), lo = (f32(I -
    f32(I)) - plane.lo) + e. A batch (I (B, N0, N1), tables (B, SP, n) or
    shared) runs pair by pair."""
    if I.dim() == 3:
        return pair_stack([pair_poly_sub_plain(I[b], *(_table_of(t, b) for t in (Uh, Ul, Mh, Ml)))
                       for b in range(I.shape[0])])
    P = pair_poly_plain(Uh, Ul, Mh, Ml)
    ih = I.to(torch.float32)
    il = (I - ih.to(torch.float64)).to(torch.float32)
    h, e = _two_sum(ih, -P.rh)
    return CPair(h, il - P.rl + e, None, None)


def pair_poly_add64_plain(Dfl: CPair, Uh, Ul, Mh, Ml) -> torch.Tensor:
    """The plain twin of K6p's add64 mode: the pair Dfl plus the plane,
    materialised in f64 (sfft_tpu's fdiff_pexact combination): h, e =
    TwoSum(Dfl.hi, plane.hi); f64(h) + f64((Dfl.lo + plane.lo) + e). A
    batch (Dfl (B, N0, N1), tables (B, SP, n) or shared) runs pair by
    pair."""
    if Dfl.rh.dim() == 3:
        return torch.stack([pair_poly_add64_plain(_plane(Dfl, b),
                                                  *(_table_of(t, b) for t in (Uh, Ul, Mh, Ml)))
                            for b in range(Dfl.rh.shape[0])])
    P = pair_poly_plain(Uh, Ul, Mh, Ml)
    h, e = _two_sum(Dfl.rh, P.rh)
    return h.to(torch.float64) + (Dfl.rl + P.rl + e)


# the kernel's modes: sfft_pair_poly's first argument
_POLY_MODES = {"plane": 0, "sub": 1, "add64": 2}
_POLY_MAX_SP = 32       # csrc/pair_poly.cu kMaxSP


def _poly_tables(name, tabs, batched: bool = False):
    """The tables' rules; returns (SP, N0, N1, B). batched: a U or M pair
    may be a (B, SP, n) stack, each pair's own (B = 0 when none is)."""
    if any(t.dtype != torch.float32 or t.dim() not in ((2, 3) if batched else (2,))
           for t in tabs):
        raise ValueError(f"{name} takes 2-D float32 tables" + (", or (B, SP, n) stacks"
                                                               if batched else ""))
    if any(t.device != tabs[0].device for t in tabs):
        raise ValueError(f"{name} operands on more than one device")
    Uh, Ul, Mh, Ml = tabs
    SP, N0 = Uh.shape[-2:]
    N1 = Mh.shape[-1]
    B = {t.shape[0] for t in tabs if t.dim() == 3}
    if (SP < 1 or Ul.shape != Uh.shape or tuple(Mh.shape[-2:]) != (SP, N1)
            or Ml.shape != Mh.shape or len(B) > 1):
        raise ValueError(f"{name}: U (SP, N0) and M (SP, N1) pairs")
    if SP > _POLY_MAX_SP:
        raise ValueError(f"{name}: at most {_POLY_MAX_SP} terms")
    return SP, N0, N1, (B.pop() if B else 0)


def _transposed(name, planes, shape):
    """Whether the planes (all of one layout) lie with strides (1, N0)
    rather than row-major (in each pair's plane, for a (B, N0, N1) batch);
    any other layout raises (the kernel copies nothing)."""
    if any(tuple(v.shape) != tuple(shape) for v in planes):
        raise ValueError(f"{name}: planes of shape {tuple(shape)}")
    N0, N1 = shape[-2:]
    st = {tuple(v.stride()) for v in planes}
    if len(st) == 1:
        st = st.pop()
        if N0 == 1 or N1 == 1 or st[-2:] == (N1, 1):
            return False
        if st[-2:] == (1, N0):
            return True
    raise ValueError(f"{name}: planes row-major or transposed (strides (N1, 1) or (1, N0)), "
                     "all of one layout")


def _poly_launch(name, mode, tabs, ins, shape, out_dtype, nout):
    """One K6p launch on CUDA tensors: `nout` fresh output planes in the
    layout of the inputs `ins` (row-major for the plane mode); shape (SP,
    N0, N1, B), B > 0 a batch of pairs (ins (B, N0, N1), each pair's own
    tables where a table is a (B, SP, n) stack)."""
    SP, N0, N1, B = shape
    dev = tabs[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {dev}")
    if N0 * N1 >= 2 ** 31 or B > 65535:
        raise ValueError(f"{name}: planes of fewer than 2^31 elements, at most 65535 pairs")
    from sfft_tpu_torch import _kernels

    lead = (B,) if B else ()
    transposed = bool(ins) and _transposed(name, ins, lead + (N0, N1))
    tabs = [t.contiguous() for t in tabs]
    if transposed:
        outs = [torch.empty(lead + (N1, N0), dtype=out_dtype, device=dev).transpose(-1, -2)
                for _ in range(nout)]
    else:
        outs = [torch.empty(lead + (N0, N1), dtype=out_dtype, device=dev) for _ in range(nout)]
    ptrs = [v.data_ptr() for v in ins] + [None] * (2 - len(ins))
    optrs = [v.data_ptr() for v in outs] + [None] * (2 - nout)
    in_ps = ins[0].stride(0) * ins[0].element_size() if B and ins else 0
    out_ps = N0 * N1 * outs[0].element_size() if B else 0
    u_ps, m_ps = (t.stride(0) if t.dim() == 3 else 0 for t in (tabs[0], tabs[2]))
    with torch.cuda.device(dev):
        err = _kernels.lib().sfft_pair_poly(_POLY_MODES[mode], int(transposed),
                                            *(t.data_ptr() for t in tabs), *ptrs, *optrs,
                                            SP, N0, N1, max(B, 1), in_ps, out_ps, u_ps, m_ps,
                                            _kernels.stream_ptr(tabs[0]))
    _K6P.launches += 1
    _K6P.mode_launches[mode] += 1
    _kernels.check(err, f"{name} kernel launch")
    return outs


def pair_poly(Uh: torch.Tensor, Ul: torch.Tensor, Mh: torch.Tensor,
              Ml: torch.Tensor) -> CPair:
    """K6p, plane mode: ``pair_poly_plain`` on the f32 tables U (SP, N0) and
    M (SP, N1), as (hi, lo) pairs, in one kernel launch on CUDA tensors (bit
    for bit), the twin on CPU tensors. ``pair_poly.launches`` counts the
    launches of every mode, ``pair_poly.mode_launches`` each mode's."""
    tabs = [Uh, Ul, Mh, Ml]
    shape = _poly_tables("pair_poly", tabs)
    if Uh.device.type == "cpu":
        return pair_poly_plain(*tabs)
    hi, lo = _poly_launch("pair_poly", "plane", tabs, [], shape, torch.float32, 2)
    return CPair(hi, lo, None, None)


def _batch_of(name, planes, shape):
    """The tables' and the planes' batch: B of a (B, N0, N1) batch of
    planes (the tables' too, where they have one), else 0."""
    B = planes[0].shape[0] if planes[0].dim() == 3 else 0
    if shape[3] and shape[3] != B:
        raise ValueError(f"{name}: tables of {shape[3]} pairs for planes of shape "
                         f"{tuple(planes[0].shape)}")
    want = ((B,) if B else ()) + shape[1:3]
    if any(tuple(v.shape) != want for v in planes):
        raise ValueError(f"{name}: planes of shape {want}")
    return shape[:3] + (B,)


def pair_poly_sub(I: torch.Tensor, Uh: torch.Tensor, Ul: torch.Tensor, Mh: torch.Tensor,
                  Ml: torch.Tensor) -> CPair:
    """K6p, sub mode: ``pair_poly_sub_plain``, the pair I - plane for an f64
    image I (N0, N1), row-major or transposed, in one kernel launch on CUDA
    tensors (bit for bit; the output in I's layout), the twin on CPU
    tensors. A batch: I (B, N0, N1) and each pair's own tables (B, SP, n)
    where they differ, in one launch."""
    tabs = [Uh, Ul, Mh, Ml]
    shape = _poly_tables("pair_poly_sub", tabs, batched=True)
    if I.dtype != torch.float64:
        raise ValueError("pair_poly_sub takes a float64 image")
    if I.device != Uh.device:
        raise ValueError("pair_poly_sub operands on more than one device")
    shape = _batch_of("pair_poly_sub", [I], shape)
    if I.device.type == "cpu":
        return pair_poly_sub_plain(I, *tabs)
    hi, lo = _poly_launch("pair_poly_sub", "sub", tabs, [I], shape, torch.float32, 2)
    return CPair(hi, lo, None, None)


def pair_poly_add64(Dfl: CPair, Uh: torch.Tensor, Ul: torch.Tensor, Mh: torch.Tensor,
                    Ml: torch.Tensor) -> torch.Tensor:
    """K6p, add64 mode: ``pair_poly_add64_plain``, the real pair Dfl (N0, N1)
    plus the plane as one f64 plane, in one kernel launch on CUDA tensors
    (bit for bit; the output in Dfl's layout), the twin on CPU tensors. A
    batch: Dfl (B, N0, N1) and each pair's own tables (B, SP, n) where
    they differ, in one launch."""
    tabs = [Uh, Ul, Mh, Ml]
    shape = _poly_tables("pair_poly_add64", tabs, batched=True)
    if not Dfl.is_real:
        raise ValueError("pair_poly_add64 takes a real pair")
    planes = [Dfl.rh, Dfl.rl]
    if any(v.dtype != torch.float32 for v in planes):
        raise ValueError("pair_poly_add64 takes float32 planes")
    if any(v.device != Uh.device for v in planes):
        raise ValueError("pair_poly_add64 operands on more than one device")
    shape = _batch_of("pair_poly_add64", planes, shape)
    if Uh.device.type == "cpu":
        return pair_poly_add64_plain(Dfl, *tabs)
    return _poly_launch("pair_poly_add64", "add64", tabs, planes, shape, torch.float64, 1)[0]


pair_poly.launches = 0
pair_poly.mode_launches = dict.fromkeys(_POLY_MODES, 0)
_K6P = pair_poly
