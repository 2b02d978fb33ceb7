"""Integer slicing of f32 (hi, lo) pairs and (hi, mid, lo) triples: the K4 and
K5 kernels and their plain twins.

Counterpart of sfft_tpu/core/pallas_slice.py (slice_pair_real), which is a
bit-twin of sfft_tpu/core/exact_fft.py ``_slice_pair_real(int8=True)``. The
sliced exact engine (core/exact_fft.py) writes every f32 (hi, lo) operand of
its integer matrix products as ``nsl`` 6-bit slices under a power-of-two
scale s:

    hi + lo == s * sum_q slices[q] * 2^(-NB (q+1))   (+ O(2^(-NB nsl)) s)

On CUDA tensors ``slice_pair`` launches the hand-written kernel of
csrc/slice_pair.cu, which reads (hi, lo) once and writes the nsl int8 planes;
on CPU tensors it uses ``slice_pair_plain``, the same remainder chain in
eager PyTorch, which is also the reference the kernel is held to on the card.
Both take the scale as an input tensor (per row or global), so the caller
computes it on the device and nothing here synchronises with the host.

``slice_triple`` (K5, csrc/slice_triple.cu; counterpart of pallas_slice.py
slice_triple_real, the bit-twin of exact_fft.py ``_slice_triple_real``) does
the same for an exact three-way f32 split of an f64 value (~72 bits): mid
joins the remainder after slice 4 through a TwoSum whose rounding is kept as
a carry, and the carry joins with lo after slice 8, so nsl = 12 slices hold
the value to 2^-72 of the scale. The refinement residual of the large f64
solve (core/solve.py) is its one caller.
"""

from __future__ import annotations

import torch

NB = 6                      # bits per integer slice
# the f32 hi part (24-bit significand) is used up after ceil(24 / NB) slices;
# lo joins the remainder there (csrc/slice_pair.cu derives the same index)
INJECT = -(-24 // NB)
# 2^(NB * nsl) and its reciprocal must stay normal f32 numbers (nsl <= 21);
# 16 covers the triple slicer's 72 bits (2^72) with room to spare
_NSL_MAX = 16
_THREADS = 256              # slice_pair.cu kThreads
_MAX_BLOCKS = 132 * 16      # grid-stride loop beyond ~16 blocks per H100 SM


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
    """The plain PyTorch twin of K4: canonicalise (hi, lo) by TwoSum so that
    |lo| <= ulp(hi)/2, then the remainder chain. Returns (nsl, *hi.shape)
    int8."""
    hi2 = hi + lo
    lo2 = lo - (hi2 - hi)
    return torch.stack(_seq_slices(hi2 / s, lo2 / s, nsl, INJECT))


def _vec_width(hi: torch.Tensor, lo: torch.Tensor, s: torch.Tensor) -> int:
    """4 (float4 loads) when every vector of 4 lies in one row and both
    operands are 16-byte aligned, else 1."""
    n, K = hi.numel(), hi.shape[-1]
    return 4 if (n % 4 == 0 and (s.dim() == 0 or K % 4 == 0)
                 and hi.data_ptr() % 16 == 0 and lo.data_ptr() % 16 == 0) else 1


def _launch(hi: torch.Tensor, lo: torch.Tensor, s: torch.Tensor, nsl: int) -> torch.Tensor:
    from sfft_tpu_torch import _kernels

    n = hi.numel()
    K = hi.shape[-1]
    rowwise = s.dim() > 0
    out = torch.empty((nsl,) + tuple(hi.shape), dtype=torch.int8, device=hi.device)
    vec = _vec_width(hi, lo, s)
    blocks = max(1, min(_MAX_BLOCKS, -(-(n // vec) // _THREADS)))
    with torch.cuda.device(hi.device):
        err = _kernels.lib().sfft_slice_pair_f32(
            hi.data_ptr(), lo.data_ptr(), s.data_ptr(), out.data_ptr(),
            n, K, int(rowwise), nsl, vec, blocks, _kernels.stream_ptr(hi))
    slice_pair.launches += 1
    _kernels.check(err, "slice_pair kernel launch")
    return out


def slice_pair(hi: torch.Tensor, lo: torch.Tensor, s: torch.Tensor, nsl: int) -> torch.Tensor:
    """K4: (nsl, *hi.shape) int8 slices of the f32 pair (hi, lo) under the
    power-of-two scale s, which is either one value (shape ()) or one per
    last-axis row (shape hi.shape[:-1] + (1,)). hi, lo and s are contiguous
    float32 on one device. CUDA tensors go through csrc/slice_pair.cu; CPU
    tensors through ``slice_pair_plain``."""
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
    return _launch(hi, lo, s, nsl)


slice_pair.launches = 0


# --------------------------------------------------------------------------
# K5: (hi, mid, lo) triples
# --------------------------------------------------------------------------

TRIPLE_NSL_MIN = 2 * INJECT     # the lo injection lands after slice 2 * INJECT


def slice_triple_plain(hi: torch.Tensor, mid: torch.Tensor, lo: torch.Tensor,
                       s: torch.Tensor, nsl: int, out_cols: int = None) -> torch.Tensor:
    """The plain PyTorch twin of K5: the remainder chain of sfft_tpu's
    ``_slice_triple_real`` in eager PyTorch (no compiler may contract or
    reassociate the TwoSum, so this must not run under torch.compile).
    Inputs are an exact three-way split (already canonical). Returns
    (nsl, *hi.shape[:-1], out_cols) int8, the last axis zero-padded from
    hi.shape[-1] to out_cols."""
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
    """K5: int8 slices of the exact f32 triple (hi, mid, lo) under the
    power-of-two scale s (shape () or hi.shape[:-1] + (1,)), nsl >= 8.
    Returns (nsl, *hi.shape[:-1], out_cols): the last axis is zero-padded to
    out_cols (default: no padding), so the slices land directly in the
    buffer an int8 product wants. Operands are contiguous float32 on one
    device. CUDA tensors go through csrc/slice_triple.cu; CPU tensors
    through ``slice_triple_plain``."""
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
    if not TRIPLE_NSL_MIN <= nsl <= _NSL_MAX:
        # below 8 slices the mid / lo injections would be dropped silently
        raise ValueError(f"slice_triple takes {TRIPLE_NSL_MIN} <= nsl <= {_NSL_MAX}, got {nsl}")
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
