"""Integer slicing of f32 (hi, lo) pairs and of f64 values split into exact
f32 (hi, mid, lo) triples: the K4 and K5 kernels and their plain twins.

Counterpart of sfft_tpu/core/pallas_slice.py (slice_pair_real), which is a
bit-twin of sfft_tpu/core/exact_fft.py ``_slice_pair_real(int8=True)``. The
sliced exact engine (core/exact_fft.py) writes every f32 (hi, lo) operand of
its integer matrix products as ``nsl`` 6-bit slices under a power-of-two
scale s:

    hi + lo == s * sum_q slices[q] * 2^(-NB (q+1))   (+ O(2^(-NB nsl)) s)

K4 is a whole slicing stage. ``slice_pairs`` takes an operand as its
producer left it (one or two pairs: a complex operand's real and imaginary
parts; any strides, a transposed view included), computes each pair's scale
(per row or global: max|hi| rounded up to a power of two), and writes the
(nsl, ..., Kp) int8 planes with the contraction axis zero-padded to Kp: one
launch of csrc/slice_pair.cu per operand, after one small launch that
reduces the global max (or, for a transposed operand whose rows span
several tiles, the row maxima). ``slice_pairs_plain`` is the chain the callers ran
before (pad, amax, ``_pow2ceil_scalar``, ``.contiguous()``,
``slice_pair_plain``): the CPU route and the reference the kernel is held to
on the card. ``slice_pair(hi, lo, s, nsl)`` slices a contiguous pair under a
given scale through the same kernel.

K5 (csrc/slice_triple.cu; counterpart of pallas_slice.py slice_triple_real,
the bit-twin of exact_fft.py ``_slice_triple_real``) slices an exact
three-way f32 split of f64 values (~72 bits): mid joins the remainder after
slice 4 through a TwoSum whose rounding is kept as a carry, and the carry
joins with lo after slice 8, so nsl = 12 slices hold the value to 2^-72 of
the scale. ``slice_rows_f64`` is the refinement setup of the large f64
solve (core/solve.py) in one launch: from A and the equilibration vector d
to the f32 hi part of d A d, its row scales and its slices.
``slice_vec_f64`` does the same for a residual's vector (one global scale)
straight into the int8 operand of the product. ``slice_triple`` slices a
given triple under a given scale. Each has its plain twin here.

Every wrapper runs its twin for CPU tensors and launches its kernel for CUDA
tensors (or raises); scales stay on the device, nothing synchronises with
the host. ``slice_pair.launches`` counts K4's slicing launches (and
``slice_pair.scale_launches`` its launches that reduce a global or row max
first), ``slice_triple.launches`` every K5 launch.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

NB = 6                      # bits per integer slice
# the f32 hi part (24-bit significand) is used up after ceil(24 / NB) slices;
# lo joins the remainder there (csrc/slice_pair.cu derives the same index)
INJECT = -(-24 // NB)
# 2^(NB * nsl) and its reciprocal must stay normal f32 numbers (nsl <= 21);
# 16 covers the triple slicer's 72 bits (2^72) with room to spare
_NSL_MAX = 16
_THREADS = 256              # slice_pair.cu / slice_triple.cu kThreads
_COLS = 16                  # slice_pair.cu kCols: tile mode's columns per thread
_ROW_COLS = 8               # slice_pair.cu kRowCols: row mode's columns per thread
_ROW_THREADS = 512          # slice_pair.cu kRowThreads
_MAX_BLOCKS = 132 * 16      # grid-stride loops beyond ~16 blocks per H100 SM


def _pow2ceil_scalar(m: torch.Tensor) -> torch.Tensor:
    """Exact power of two in (m, 2m] (elementwise), from the f32 exponent
    bits: s = 2^(biased_exponent - 126). Stays on the device."""
    m = torch.clamp(m.to(torch.float32), min=1e-30)
    expo = (m.view(torch.int32) >> 23) & 0xFF
    return ((expo + 1) << 23).view(torch.float32)


def _padk(x: torch.Tensor, Kp: int) -> torch.Tensor:
    """Zero-pad the last (contraction) axis to Kp."""
    k = x.shape[-1]
    return x if k == Kp else F.pad(x, (0, Kp - k))


def _seq_slices(r0: torch.Tensor, lo_over_s: torch.Tensor, nsl: int, inject: int):
    """Sequential remainder-chain slicing of r0 = hi/s (|r0| <= 1), injecting
    lo/s after slice `inject`: the algorithm of sfft_tpu's ``_seq_slices``.
    Every step is exact (power-of-two products; Sterbenz subtraction), and
    torch.round rounds half to even as jnp.round does."""
    r = r0
    out = []
    for q in range(nsl):
        sc = float(2.0 ** (NB * (q + 1)))
        p = torch.round(r * sc)
        out.append(p.to(torch.int8))
        r = r - p / sc
        if q == inject - 1:
            r = r + lo_over_s
    return out


def slice_pair_plain(hi: torch.Tensor, lo: torch.Tensor, s: torch.Tensor,
                     nsl: int) -> torch.Tensor:
    """The plain PyTorch twin of K4's slicing under a given scale:
    canonicalise (hi, lo) by TwoSum so that |lo| <= ulp(hi)/2, then the
    remainder chain. Returns (nsl, *hi.shape) int8."""
    hi2 = hi + lo
    lo2 = lo - (hi2 - hi)
    return torch.stack(_seq_slices(hi2 / s, lo2 / s, nsl, INJECT))


def slice_pairs_plain(parts, nsl: int, Kp: int = None, rowwise: bool = False):
    """The plain twin of the K4 stage: for each (hi, lo) pair, the chain
    that sfft_tpu's ``_slice_pair_real`` is (after the caller's zero pad of
    the last axis to Kp): the scale from max|hi| (per row with rowwise, else
    over the operand) rounded up to a power of two, then ``slice_pair_plain``
    on contiguous copies. Returns [(slices (nsl, ..., Kp) int8, scale)]."""
    out = []
    for hi, lo in parts:
        Kq = hi.shape[-1] if Kp is None else Kp
        hi, lo = _padk(hi, Kq), _padk(lo, Kq)
        if rowwise:
            s = _pow2ceil_scalar(hi.abs().amax(dim=-1, keepdim=True))
        else:
            s = _pow2ceil_scalar(hi.abs().amax())
        out.append((slice_pair_plain(hi.contiguous(), lo.contiguous(), s, nsl), s))
    return out


# --------------------------------------------------------------------------
# K4 launch plans (pure functions of shapes and strides)
# --------------------------------------------------------------------------


class _PartArgs(ctypes.Structure):
    """slice_pair.cu ``Part``."""
    _fields_ = [("hi", ctypes.c_void_p), ("lo", ctypes.c_void_p),
                ("hs", ctypes.c_longlong * 3), ("ls", ctypes.c_longlong * 3),
                ("scale_in", ctypes.c_void_p), ("scale_out", ctypes.c_void_p),
                ("out", ctypes.c_void_p),
                ("mn", ctypes.c_longlong * 3), ("ms", ctypes.c_longlong * 3)]


class _StageArgs(ctypes.Structure):
    """slice_pair.cu ``Stage``."""
    _fields_ = [("part", _PartArgs * 2),
                ("n_outer", ctypes.c_longlong), ("n_inner", ctypes.c_longlong),
                ("o_outer", ctypes.c_longlong), ("o_inner", ctypes.c_longlong),
                ("K", ctypes.c_longlong), ("Kp", ctypes.c_longlong),
                ("nsl", ctypes.c_int), ("scale_mode", ctypes.c_int)]


def _row_dims(shape, strides_list):
    """The leading (row) axes of a view as at most two (size, [stride of each
    tensor]) axes, outer first: size-1 axes dropped and neighbours merged
    where every tensor's strides allow. Raises for a layout that needs three."""
    merged = []
    for d, n in enumerate(shape[:-1]):
        if n == 1:
            continue
        ss = [st[d] for st in strides_list]
        if merged and all(ps == s * n for ps, s in zip(merged[-1][1], ss)):
            merged[-1] = (merged[-1][0] * n, ss)
        else:
            merged.append((n, ss))
    if len(merged) > 2:
        raise ValueError(f"slice_pairs takes views whose leading axes merge into two, got "
                         f"shape {tuple(shape)} with strides {strides_list}")
    while len(merged) < 2:
        merged.insert(0, (1, [0] * len(strides_list)))
    return merged


def _pairs_plan(shape, strides_list, Kp: int, rowwise: bool) -> dict:
    """The K4 launch of a stage on views of `shape` (all parts) with the
    element strides of each tensor (hi, lo of each part, in order): the mode
    (0 row mode: K stride 1; 1 tile mode), the row decomposition (outer,
    inner; the output row of (o, i) is o * o_outer + i * o_inner), each
    tensor's (outer, inner, K) strides, the store width and the grid; with
    a rowwise scale in tile mode over more than one tile, the row-max launch
    before it (``rowmax`` K chunks, else 0)."""
    K = shape[-1]
    (B, sB), (M, sM) = _row_dims(shape, strides_list)
    sK = [st[-1] for st in strides_list]
    rows = B * M
    store = 16 if Kp % 16 == 0 else 8 if Kp % 8 == 0 else 1
    if K == 1 or all(s == 1 for s in sK):
        chunks = -(-Kp // _ROW_COLS)
        if chunks <= 32:
            G = 1
            while G < chunks:
                G *= 2
            threads = _THREADS
        else:
            G = threads = min(_ROW_THREADS, 32 * -(-chunks // 32))
        return dict(mode=0, n_outer=B, n_inner=M, o_outer=M, o_inner=1,
                    strides=[(a, b, c) for a, b, c in zip(sB, sM, sK)], store=store, G=G,
                    threads=threads, WC=0, tiles_inner=0, kblocks=0, rowmax=0,
                    blocks=-(-rows // (threads // G)))
    # tile mode: the stored (stride-1) row axis of hi is the inner one
    if sM[0] != 1 and B > 1 and sB[0] == 1:
        n_outer, n_inner, o_outer, o_inner = M, B, 1, M
        strides = [(b, a, c) for a, b, c in zip(sB, sM, sK)]
    else:
        n_outer, n_inner, o_outer, o_inner = B, M, M, 1
        strides = [(a, b, c) for a, b, c in zip(sB, sM, sK)]
    WC = 1
    while WC < _THREADS // 32 and WC * _COLS < Kp:
        WC *= 2
    RG = min(_THREADS // 32 // WC, -(-n_inner // 32))    # fewer rows for a short axis
    TR, TC = 32 * RG, _COLS * WC
    tiles_inner = -(-n_inner // TR)
    ntiles = -(-Kp // TC)
    rowmax = 0
    if rowwise and ntiles > 1:
        # enough blocks of 32 rows x one K chunk to fill the card twice
        tiles32 = n_outer * -(-n_inner // 32)
        rowmax = max(1, min(-(-K // 64), -(-2 * 132 // tiles32)))
    kblocks = 1 if (rowwise and not rowmax) else ntiles
    return dict(mode=1, n_outer=n_outer, n_inner=n_inner, o_outer=o_outer, o_inner=o_inner,
                strides=strides, store=store, G=32 * WC * RG, threads=32 * WC * RG, WC=WC,
                tiles_inner=tiles_inner, kblocks=kblocks, rowmax=rowmax,
                blocks=n_outer * tiles_inner * kblocks)


def _absmax_plan(shape, strides):
    """hi's view for the global max: (sizes, strides) of at most three axes
    in ascending stride order, and whether it is one contiguous run
    (then ((numel, 1, 1), (1, 0, 0)))."""
    dims = sorted(((s, n) for n, s in zip(shape, strides) if n != 1))
    numel = 1
    for n in shape:
        numel *= n
    run = 1
    for s, n in dims:
        if s != run:
            break
        run *= n
    else:
        return (numel, 1, 1), (1, 0, 0), True
    (B, (sB,)), (M, (sM,)) = _row_dims(shape, [strides])
    axes = sorted([(strides[-1], shape[-1]), (sM, M), (sB, B)])
    return tuple(n for _, n in axes), tuple(s for s, _ in axes), False


_scratch = {}    # (device index, stream) -> (zeroed uint32 tickets, partial maxima)


def _max_scratch(device: torch.device, stream: int, tickets: int, partials: int):
    """Tickets (zeroed; the max kernels leave them zeroed, and launches on
    one stream run in order) and room for partial maxima, kept per stream
    and grown when a launch needs more."""
    key = (device.index, stream)
    got = _scratch.get(key)
    if got is None or got[0].numel() < tickets or got[1].numel() < partials:
        got = _scratch[key] = (
            torch.zeros(max(tickets, 4096), dtype=torch.int32, device=device),
            torch.empty(max(partials, 1 << 18), dtype=torch.float32, device=device))
    return got


def _launch_pairs(parts, nsl: int, Kp: int, rowwise: bool, scales=None):
    """K4 on CUDA tensors: [(slices, scale)] of each part. scales: given
    scales (one tensor per part; shape () or rows + (1,)); None computes
    them (rowwise in the slicing launch, global in a max launch before it)."""
    from sfft_tpu_torch import _kernels

    hi0 = parts[0][0]
    dev = hi0.device
    shape = tuple(hi0.shape)
    lead = shape[:-1]
    K = shape[-1]
    tensors = [t for pr in parts for t in pr]
    strides = [tuple(t.stride()) for t in tensors]
    compute = scales is None
    plan = _pairs_plan(shape, strides, Kp, compute and rowwise)
    st = _StageArgs()
    st.n_outer, st.n_inner = plan["n_outer"], plan["n_inner"]
    st.o_outer, st.o_inner = plan["o_outer"], plan["o_inner"]
    st.K, st.Kp, st.nsl = K, Kp, nsl
    if compute:
        # rowwise: in the slicing launch, or given by the row-max launch
        st.scale_mode = (1 if plan["rowmax"] else 2) if rowwise else 0
    else:
        st.scale_mode = 1 if scales[0].dim() > 0 else 0
    outs = []
    dense4 = True
    for p, (hi, lo) in enumerate(parts):
        out = torch.empty((nsl,) + lead + (Kp,), dtype=torch.int8, device=dev)
        if compute:
            s = torch.empty(lead + (1,) if rowwise else (), dtype=torch.float32, device=dev)
        else:
            s = scales[p]
        a = st.part[p]
        a.hi, a.lo, a.out = hi.data_ptr(), lo.data_ptr(), out.data_ptr()
        a.hs[:] = plan["strides"][2 * p]
        a.ls[:] = plan["strides"][2 * p + 1]
        a.scale_in = a.scale_out = s.data_ptr()
        mn, ms, dense = _absmax_plan(shape, strides[2 * p])
        a.mn[:], a.ms[:] = mn, ms
        dense4 = dense4 and dense and hi.data_ptr() % 16 == 0
        outs.append((out, s))
    vec_in = int(plan["mode"] == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
                 and all(x % 4 == 0 for t in plan["strides"] for x in t[:2]))
    lib = _kernels.lib()
    with torch.cuda.device(dev):
        stream = _kernels.stream_ptr(hi0)
        if compute and not rowwise:
            blocks = max(1, min(1024, -(-hi0.numel() // (_THREADS * 8))))
            ticket, partial = _max_scratch(dev, stream, 2, 2 * blocks)
            err = lib.sfft_slice_pairs_absmax(ctypes.addressof(st), int(dense4), blocks,
                                              len(parts), partial.data_ptr(),
                                              ticket.data_ptr(), stream)
            slice_pair.scale_launches += 1
            _kernels.check(err, "slice_pairs global-scale launch")
        elif compute and plan["rowmax"]:
            tiles32 = -(-plan["n_inner"] // 32)
            ntile = len(parts) * plan["n_outer"] * tiles32
            ticket, partial = _max_scratch(dev, stream, ntile, ntile * plan["rowmax"] * 32)
            err = lib.sfft_slice_pairs_rowmax(ctypes.addressof(st), tiles32, plan["rowmax"],
                                              len(parts), partial.data_ptr(),
                                              ticket.data_ptr(), stream)
            slice_pair.scale_launches += 1
            _kernels.check(err, "slice_pairs row-scale launch")
        err = lib.sfft_slice_pairs(ctypes.addressof(st), plan["mode"], vec_in, plan["store"],
                                   plan["G"], plan["WC"], plan["tiles_inner"], plan["kblocks"],
                                   plan["blocks"], len(parts), stream)
    slice_pair.launches += 1
    _kernels.check(err, "slice_pairs kernel launch")
    return outs


def _check_parts(parts, nsl: int, Kp: int, what: str):
    if not 1 <= len(parts) <= 2:
        raise ValueError(f"{what} takes one or two (hi, lo) pairs, got {len(parts)}")
    hi0 = parts[0][0]
    for hi, lo in parts:
        if hi.dtype != torch.float32 or lo.dtype != torch.float32:
            raise TypeError(f"{what} needs float32 operands, got {hi.dtype} and {lo.dtype}")
        if hi.shape != hi0.shape or lo.shape != hi0.shape or hi0.dim() == 0:
            raise ValueError(f"{what} needs pairs of one shape (at least 1-D), got "
                             f"{[(tuple(h.shape), tuple(l.shape)) for h, l in parts]}")
        if hi.device != hi0.device or lo.device != hi0.device:
            raise ValueError(f"{what} operands on more than one device")
    if hi0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {hi0.device}")
    if not 1 <= nsl <= _NSL_MAX:
        raise ValueError(f"{what} takes 1 <= nsl <= {_NSL_MAX}, got {nsl}")
    if Kp < hi0.shape[-1]:
        raise ValueError(f"{what} needs Kp >= {hi0.shape[-1]}, got {Kp}")


def slice_pairs(parts, nsl: int, Kp: int = None, rowwise: bool = False):
    """K4 stage: each (hi, lo) f32 pair of `parts` (one, or a complex
    operand's real and imaginary parts; all of one shape, any strides) ->
    (slices (nsl, *hi.shape[:-1], Kp) int8, power-of-two scale of shape
    hi.shape[:-1] + (1,) with rowwise, else ()). The last axis is
    zero-padded to Kp (default: its length). CUDA tensors: one launch of
    csrc/slice_pair.cu for all parts (after one max launch for a global
    scale); CPU tensors: ``slice_pairs_plain``."""
    parts = list(parts)
    Kp = parts[0][0].shape[-1] if Kp is None else Kp
    _check_parts(parts, nsl, Kp, "slice_pairs")
    hi0 = parts[0][0]
    if hi0.device.type == "cpu":
        return slice_pairs_plain(parts, nsl, Kp, rowwise)
    if hi0.numel() == 0:
        raise ValueError("slice_pairs needs a non-empty operand (its scale is a max)")
    if NB != 6:
        raise ValueError("csrc/slice_pair.cu is built for 6-bit slices (NB == 6)")
    return _launch_pairs(parts, nsl, Kp, rowwise)


def slice_pair(hi: torch.Tensor, lo: torch.Tensor, s: torch.Tensor, nsl: int) -> torch.Tensor:
    """K4 under a given scale: (nsl, *hi.shape) int8 slices of the f32 pair
    (hi, lo) under the power-of-two scale s, which is either one value
    (shape ()) or one per last-axis row (shape hi.shape[:-1] + (1,)). hi, lo
    and s are contiguous float32 on one device. CUDA tensors go through
    csrc/slice_pair.cu; CPU tensors through ``slice_pair_plain``."""
    if any(t.dtype != torch.float32 for t in (hi, lo, s)):
        raise TypeError(f"slice_pair needs float32 operands, got "
                        f"{hi.dtype}, {lo.dtype} and {s.dtype}")
    if hi.shape != lo.shape or hi.dim() == 0:
        raise ValueError(f"slice_pair needs hi and lo of one shape (at least 1-D), got "
                         f"{tuple(hi.shape)} and {tuple(lo.shape)}")
    if s.shape != () and s.shape != hi.shape[:-1] + (1,):
        raise ValueError(f"slice_pair needs a scale of shape () or "
                         f"{tuple(hi.shape[:-1]) + (1,)}, got {tuple(s.shape)}")
    if not (hi.is_contiguous() and lo.is_contiguous() and s.is_contiguous()):
        raise ValueError("slice_pair needs contiguous operands")
    if hi.device != lo.device or hi.device != s.device:
        raise ValueError(f"slice_pair operands on {hi.device}, {lo.device} and {s.device}")
    if hi.device.type not in ("cpu", "cuda"):
        raise ValueError(f"slice_pair runs on cpu or cuda tensors, not {hi.device}")
    if not 1 <= nsl <= _NSL_MAX:
        raise ValueError(f"slice_pair takes 1 <= nsl <= {_NSL_MAX}, got {nsl}")
    if hi.device.type == "cpu":
        return slice_pair_plain(hi, lo, s, nsl)
    if hi.numel() == 0:
        return torch.empty((nsl,) + tuple(hi.shape), dtype=torch.int8, device=hi.device)
    if NB != 6:
        raise ValueError("csrc/slice_pair.cu is built for 6-bit slices (NB == 6)")
    return _launch_pairs([(hi, lo)], nsl, hi.shape[-1], s.dim() > 0, scales=[s])[0][0]


slice_pair.launches = 0
slice_pair.scale_launches = 0


# --------------------------------------------------------------------------
# K5: f64 values as exact (hi, mid, lo) triples
# --------------------------------------------------------------------------

TRIPLE_NSL_MIN = 2 * INJECT     # the lo injection lands after slice 2 * INJECT
_SMEM_MAX = 232448              # bytes of shared memory a block may use on the H100


def split3(x: torch.Tensor, consume: bool = False):
    """Exact three-way f32 split of an f64 tensor: hi = f32(x),
    mid = f32(x - hi), lo = f32(x - hi - mid). consume=True overwrites x
    with the remainders (no second f64 copy of a large matrix)."""
    rem = x if consume else x.clone()
    hi = rem.to(torch.float32)
    rem -= hi
    mid = rem.to(torch.float32)
    rem -= mid
    return hi, mid, rem.to(torch.float32)


def slice_triple_plain(hi: torch.Tensor, mid: torch.Tensor, lo: torch.Tensor,
                       s: torch.Tensor, nsl: int, out_cols: int = None) -> torch.Tensor:
    """The plain PyTorch twin of K5's slicing: the remainder chain of
    sfft_tpu's ``_slice_triple_real`` in eager PyTorch (no compiler may
    contract or reassociate the TwoSum, so this must not run under
    torch.compile). Inputs are an exact three-way split (already canonical).
    Returns (nsl, *hi.shape[:-1], out_cols) int8, the last axis zero-padded
    from hi.shape[-1] to out_cols."""
    r = hi / s
    out = []
    carry = None
    for q in range(nsl):
        sc = float(2.0 ** (NB * (q + 1)))
        p = torch.round(r * sc)
        out.append(p.to(torch.int8))
        r = r - p / sc
        if q == INJECT - 1:
            # TwoSum: r + mid/s = t + carry exactly; the carry (~2^-48 s)
            # waits for the lo injection, where the sum rounds at 2^-72 s
            b = mid / s
            t = r + b
            v = t - r
            carry = (r - (t - v)) + (b - v)
            r = t
        if q == 2 * INJECT - 1:
            r = r + (lo / s + carry)
    sl = torch.stack(out)
    K = hi.shape[-1]
    if out_cols is not None and out_cols != K:
        sl = torch.nn.functional.pad(sl, (0, out_cols - K))
    return sl


def slice_rows_f64_plain(A: torch.Tensor, d: torch.Tensor, nsl: int, out_cols: int = None):
    """The plain twin of the K5 matrix stage: the chain sfft_tpu's
    ``_sliced_residual_setup`` runs (``slice_rows``): As = A * d[:, None] *
    d[None, :] (two f64 roundings, in that order; rows take d[:n], columns
    d[:K]), the exact split, the row scales from max|hi|, the slices.
    Returns (Ah, slices (nsl, n, out_cols), scales (n, 1)); Ah is the f32 hi
    part of As."""
    n, K = A.shape
    As = A * d[:n, None] * d[None, :K]
    Ah, Am, Al = split3(As, consume=True)
    del As
    s = _pow2ceil_scalar(Ah.abs().amax(dim=-1, keepdim=True))
    return Ah, slice_triple_plain(Ah, Am, Al, s, nsl, out_cols), s


def slice_vec_f64_plain(x: torch.Tensor, nsl: int, out: torch.Tensor) -> torch.Tensor:
    """The plain twin of the K5 vector stage: split x (n,) f64, one global
    scale, the slices written into rows 0..nsl-1 of the int8 operand `out`
    (rows >= nsl, Kp >= n; its pad columns get zeros, its other rows are
    left alone). Returns the scale (shape ())."""
    hi, mid, lo = split3(x)
    s = _pow2ceil_scalar(hi.abs().amax())
    out[:nsl] = slice_triple_plain(hi, mid, lo, s, nsl, out.shape[1])
    return s


def _check_triple_nsl(nsl: int, what: str):
    if not TRIPLE_NSL_MIN <= nsl <= _NSL_MAX:
        # below 8 slices the mid / lo injections would be dropped silently
        raise ValueError(f"{what} takes {TRIPLE_NSL_MIN} <= nsl <= {_NSL_MAX}, got {nsl}")


def slice_rows_f64(A: torch.Tensor, d: torch.Tensor, nsl: int, out_cols: int = None):
    """K5 matrix stage: (Ah, slices, scales) of d A d for A (n, K) f64 with
    unit column stride and d (max(n, K),) f64 contiguous: Ah (n, K) f32 is
    the f32 rounding of As = (A[i, j] * d[i]) * d[j], slices (nsl, n,
    out_cols) int8 hold As to 2^(-6 nsl) of each row's power-of-two scale
    (scales (n, 1) f32), the columns zero-padded from K to out_cols. CUDA
    tensors: one launch of csrc/slice_triple.cu; CPU tensors:
    ``slice_rows_f64_plain``."""
    if A.dtype != torch.float64 or d.dtype != torch.float64:
        raise TypeError(f"slice_rows_f64 needs float64 A and d, got {A.dtype} and {d.dtype}")
    if A.dim() != 2 or d.dim() != 1 or d.shape[0] < max(A.shape):
        raise ValueError(f"slice_rows_f64 needs A (n, K) and d of length >= max(n, K), got "
                         f"{tuple(A.shape)} and {tuple(d.shape)}")
    if A.device != d.device or A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"slice_rows_f64 operands on {A.device} and {d.device}")
    _check_triple_nsl(nsl, "slice_rows_f64")
    n, K = A.shape
    out_cols = K if out_cols is None else out_cols
    if out_cols < K:
        raise ValueError(f"slice_rows_f64 needs out_cols >= {K}, got {out_cols}")
    if A.device.type == "cpu":
        return slice_rows_f64_plain(A, d, nsl, out_cols)
    if A.numel() == 0:
        raise ValueError("slice_rows_f64 needs a non-empty matrix")
    if A.stride(1) != 1 or not d.is_contiguous():
        raise ValueError("slice_rows_f64 needs A with unit column stride and a contiguous d")
    from sfft_tpu_torch import _kernels

    Ah = torch.empty((n, K), dtype=torch.float32, device=A.device)
    sl = torch.empty((nsl, n, out_cols), dtype=torch.int8, device=A.device)
    s = torch.empty((n, 1), dtype=torch.float32, device=A.device)
    # the row stays in shared memory (from the 16-byte boundary before it)
    # when it fits; else the kernel reads it twice
    smem = 8 * (K + 2)
    staged = int(smem <= _SMEM_MAX)
    with torch.cuda.device(A.device):
        err = _kernels.lib().sfft_slice_rows_f64(
            A.data_ptr(), A.stride(0), d.data_ptr(), Ah.data_ptr(), s.data_ptr(),
            sl.data_ptr(), n, K, out_cols, nsl, staged, smem if staged else 0,
            _kernels.stream_ptr(A))
    slice_triple.launches += 1
    _kernels.check(err, "slice_rows_f64 kernel launch")
    return Ah, sl, s


def slice_vec_f64(x: torch.Tensor, nsl: int, out: torch.Tensor) -> torch.Tensor:
    """K5 vector stage: split x (n,) f64, take one global scale and write
    the nsl slices into rows 0..nsl-1 of the contiguous int8 operand `out`
    (R >= nsl rows, Kp >= n columns; pad columns written as zeros, rows >=
    nsl untouched, so a caller zeroes them once). Returns the scale (shape
    ()). CUDA tensors: one single-block launch of csrc/slice_triple.cu; CPU
    tensors: ``slice_vec_f64_plain``."""
    if x.dtype != torch.float64 or out.dtype != torch.int8:
        raise TypeError(f"slice_vec_f64 needs float64 x and an int8 out, got {x.dtype} and "
                        f"{out.dtype}")
    if x.dim() != 1 or out.dim() != 2 or out.shape[0] < nsl or out.shape[1] < x.shape[0]:
        raise ValueError(f"slice_vec_f64 needs x (n,) and out (>= {nsl}, >= n), got "
                         f"{tuple(x.shape)} and {tuple(out.shape)}")
    if x.device != out.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"slice_vec_f64 operands on {x.device} and {out.device}")
    _check_triple_nsl(nsl, "slice_vec_f64")
    if x.device.type == "cpu":
        return slice_vec_f64_plain(x, nsl, out)
    if x.numel() == 0 or not (x.is_contiguous() and out.is_contiguous()):
        raise ValueError("slice_vec_f64 needs a non-empty contiguous x and a contiguous out")
    from sfft_tpu_torch import _kernels

    s = torch.empty((), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernels.lib().sfft_slice_vec_f64(
            x.data_ptr(), s.data_ptr(), out.data_ptr(), x.shape[0], out.shape[1], nsl,
            _kernels.stream_ptr(x))
    slice_triple.launches += 1
    _kernels.check(err, "slice_vec_f64 kernel launch")
    return s


def _triple_vec_in(hi, mid, lo) -> int:
    """4 (float4 loads) when every row starts on a 16-byte boundary, else 1."""
    K = hi.shape[-1]
    return 4 if (K % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (hi, mid, lo))) else 1


def _launch_triple(hi, mid, lo, s, nsl: int, out_cols: int) -> torch.Tensor:
    from sfft_tpu_torch import _kernels

    K = hi.shape[-1]
    rows = hi.numel() // K
    rowwise = s.dim() > 0
    out = torch.empty((nsl,) + tuple(hi.shape[:-1]) + (out_cols,), dtype=torch.int8,
                      device=hi.device)
    vec_in = _triple_vec_in(hi, mid, lo)
    # a thread takes 4 neighbouring columns of one row; with out_cols a
    # multiple of 4 it stores them as one char4 per plane (and zeroes the
    # pad columns of its group), whatever the alignment of the input rows
    vec_out = 4 if out_cols % 4 == 0 else 1
    groups = -(-K // 4)
    written = 4 * groups if vec_out == 4 else K
    if out_cols > written:
        out[..., written:] = 0
    blocks = max(1, min(_MAX_BLOCKS, -(-(rows * groups) // _THREADS)))
    with torch.cuda.device(hi.device):
        err = _kernels.lib().sfft_slice_triple_f32(
            hi.data_ptr(), mid.data_ptr(), lo.data_ptr(), s.data_ptr(), out.data_ptr(),
            rows, K, out_cols, int(rowwise), nsl, vec_in, vec_out, blocks,
            _kernels.stream_ptr(hi))
    slice_triple.launches += 1
    _kernels.check(err, "slice_triple kernel launch")
    return out


def slice_triple(hi: torch.Tensor, mid: torch.Tensor, lo: torch.Tensor, s: torch.Tensor,
                 nsl: int, out_cols: int = None) -> torch.Tensor:
    """K5 under a given scale: int8 slices of the exact f32 triple (hi,
    mid, lo) under the power-of-two scale s (shape () or hi.shape[:-1] +
    (1,)), nsl >= 8. Returns (nsl, *hi.shape[:-1], out_cols): the last axis
    is zero-padded to out_cols (default: no padding), so the slices land
    directly in the buffer an int8 product wants. Operands are contiguous
    float32 on one device. CUDA tensors go through csrc/slice_triple.cu;
    CPU tensors through ``slice_triple_plain``."""
    ops = (hi, mid, lo, s)
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError(f"slice_triple needs float32 operands, got {[t.dtype for t in ops]}")
    if hi.shape != mid.shape or hi.shape != lo.shape or hi.dim() == 0:
        raise ValueError(f"slice_triple needs hi, mid and lo of one shape (at least 1-D), "
                         f"got {tuple(hi.shape)}, {tuple(mid.shape)} and {tuple(lo.shape)}")
    if s.shape != () and s.shape != hi.shape[:-1] + (1,):
        raise ValueError(f"slice_triple needs a scale of shape () or "
                         f"{tuple(hi.shape[:-1]) + (1,)}, got {tuple(s.shape)}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("slice_triple needs contiguous operands")
    if any(t.device != hi.device for t in ops):
        raise ValueError(f"slice_triple operands on {[str(t.device) for t in ops]}")
    if hi.device.type not in ("cpu", "cuda"):
        raise ValueError(f"slice_triple runs on cpu or cuda tensors, not {hi.device}")
    _check_triple_nsl(nsl, "slice_triple")
    K = hi.shape[-1]
    if out_cols is None:
        out_cols = K
    if out_cols < K:
        raise ValueError(f"slice_triple needs out_cols >= {K}, got {out_cols}")
    if hi.device.type == "cpu":
        return slice_triple_plain(hi, mid, lo, s, nsl, out_cols)
    if hi.numel() == 0:
        return torch.zeros((nsl,) + tuple(hi.shape[:-1]) + (out_cols,), dtype=torch.int8,
                           device=hi.device)
    if NB != 6:
        raise ValueError("csrc/slice_triple.cu is built for 6-bit slices (NB == 6)")
    return _launch_triple(hi, mid, lo, s, nsl, out_cols)


slice_triple.launches = 0
