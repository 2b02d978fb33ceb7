"""Row-sharded 2-D transforms and the row-sharded single-pair step over a
list of devices (counterpart of sfft_tpu/parallel/sharded_fft.py).

sfft_tpu runs this layer single-controller: one process, a Mesh over its
devices, shard_map with all_to_all collectives inside. The port keeps that
model. A "mesh" is a sequence of torch devices, repeats allowed, as
``parallel.batch.data_devices`` returns it: one card named four times runs
every stage on its own row block and every exchange as a device-to-device
copy on that card; a list of cards sends the same copies between cards.

A row-sharded array is a ``RowBlocks``: block k holds the image rows
[k n, (k + 1) n), n = N0 / d, on devices[k] (N0 % d == 0 is required).
The 2-D transforms are the pencil decomposition: the axis-1 transform runs
on each row block, ``exchange`` turns the row blocks into column blocks
(N0, C / d), the axis-0 transform runs on each column block, and a second
exchange brings the spectrum back to row blocks (frequency rows). Half
spectra pad their N1 // 2 + 1 columns to a multiple of d for the exchange
and trim them after (zero columns transform to zero columns).

``sharded_subtract_step`` is the solve-and-subtract step of one pair with
every image-size array in row blocks (or in column blocks inside a
transform). Only four things cross devices inside it: (i) the pencil
transposes; (ii) partial reductions of a block, summed in a fixed order on
devices[0]: correlation tables of the normal system's size and moment sets
(vectors no longer than one image side per plane), and what is computed
from the sums alone (the peel coefficients of pexact and peeled), copied
back to each device; (iii) the solution, solved once on devices[0] and
copied to each device; (iv) halo rows (``halo_rows``): the rows of the
neighbouring blocks that a windowed operation in real space needs (the
FFT-free route: K8's lags, K9's taps), of the image planes only; each
block builds its basis-weighted plane stacks at its wrapped row indices.
The difference is gathered only as the caller's output.

The exact products keep the local step's numbers: every block of an
operand is sliced with the whole operand's scales (one max over the blocks,
a partial reduction of one value per part or per row), and a contraction
over the row blocks sums the blocks' int32 products (exact) before one
epilogue on devices[0]; so the exact engine's sharded step is the local
step bit for bit. What the split changes: the f64 sums of pexact's moment
sets (K3 per block), of the fft family's and the peeled backend's windows
(K1 per frequency-row block), of the corr route's tables (K8 per block on
its halo-extended planes), the blocks' own cuFFT transforms, and the f64
background and wrap-strip products taken at a block's rows. The conv
difference (K9 per block on its halo-extended planes) computes each pixel
as the local step does.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sfft_tpu_torch.config import SFFTConfig, torch_dtype
from sfft_tpu_torch.core import pairs as _pairs
from sfft_tpu_torch.core import exact_fft as _xf
from sfft_tpu_torch.core.exact_fft import (KMAX, NSL_DATA, NSL_STATIC, CPair, SliceProfile,
                                           _cmatmul_blocks, _cmatmul_sliced, _common_scales,
                                           _distinct_rows, _ones_above, _pair_hadamard_conj,
                                           _pair_mul_static_rr, _pmap, _row, _row_block,
                                           _split_on, _static_big, _static_slices_for, _swap,
                                           exact_dft_axis_blocks, pair_from_f64, pair_stack)
from sfft_tpu_torch.core.statics import Static, index
from sfft_tpu_torch.parallel.batch import data_devices

GREEK_BACKENDS = ("fft", "fft32", "exact", "pexact", "peeled", "corr")
FDIFF_BACKENDS = ("fft", "fft32", "exact", "pexact", "conv")


class RowBlocks(NamedTuple):
    """A row-sharded array: blocks[k] (tensor or CPair, (..., n, C)) holds
    the rows [k n, (k + 1) n) on devices[k]."""

    blocks: tuple
    devices: tuple

    @property
    def rows(self) -> int:
        return _lane(self.blocks[0]).shape[-2]

    def spans(self):
        """(k, device, r0, r1) of each block."""
        n = self.rows
        return [(k, dev, k * n, (k + 1) * n) for k, dev in enumerate(self.devices)]


def _lane(b) -> torch.Tensor:
    return b.rh if isinstance(b, CPair) else b


def _check_devices(devices) -> tuple:
    devices = tuple(data_devices(devices=devices))
    if not devices:
        raise ValueError("no devices to shard over")
    return devices


def shard_rows(x, devices=None) -> RowBlocks:
    """x (..., N0, N1) (numpy, a tensor or a pair on any device, or RowBlocks
    over the same devices) as row blocks over `devices` (every visible card when
    None; without a card this raises). N0 must be a multiple of the number
    of devices."""
    if isinstance(x, RowBlocks):
        if devices is not None and _check_devices(devices) != tuple(x.devices):
            raise ValueError("row blocks over other devices")
        return x
    devices = _check_devices(devices)
    if not isinstance(x, (torch.Tensor, CPair)):
        x = torch.as_tensor(np.array(x))
    d = len(devices)
    N0 = _lane(x).shape[-2]
    if N0 % d:
        raise ValueError(f"N0={N0} is not divisible by the {d} devices")
    n = N0 // d

    def block(k, dev):
        part = lambda v: v[..., k * n:(k + 1) * n, :].to(dev)  # noqa: E731
        return _pmap(x, part) if isinstance(x, CPair) else part(x)

    return RowBlocks(tuple(block(k, dev) for k, dev in enumerate(devices)), devices)


def gather_rows(x: RowBlocks, device=None):
    """The whole array on `device` (devices[0] when None): for callers and
    tests, never inside the step."""
    dev = torch.device(device) if device is not None else x.devices[0]
    if isinstance(x.blocks[0], CPair):
        return CPair(*(None if lanes[0] is None else torch.cat([v.to(dev) for v in lanes], dim=-2)
                       for lanes in zip(*x.blocks)))
    return torch.cat([b.to(dev) for b in x.blocks], dim=-2)


# ---------------------------------------------------------------------------
# the exchange (sfft_tpu's _all_to_all_transpose)
# ---------------------------------------------------------------------------


def exchange(blocks: Sequence[torch.Tensor], devices, to_cols: bool) -> list:
    """The pencil transpose. to_cols: row blocks (..., n, C) -> column
    blocks (..., d n, C / d), block j holding the columns [j C/d, (j+1) C/d)
    of every row; else the inverse. Chunk j of block k goes to devices[j] by
    ``.to(..., non_blocking=True)`` and is concatenated there in block
    order. PyTorch orders a copy between two devices against both devices'
    current streams (the destination waits for the source's pending work and
    the copy lands before the destination's next work), and on one device
    the copy is stream-ordered, so no consumer reads a chunk before it
    lands. ``exchange.bytes`` counts the bytes of the chunks that change list
    position (k != j: those that cross cards when the devices differ),
    ``exchange.calls`` the calls."""
    d = len(devices)
    out = []
    for j, dev in enumerate(devices):
        parts = []
        for k, b in enumerate(blocks):
            if to_cols:
                c = b.shape[-1] // d
                piece = b[..., j * c:(j + 1) * c]
            else:
                r = b.shape[-2] // d
                piece = b[..., j * r:(j + 1) * r, :]
            if k != j:
                exchange.bytes += piece.numel() * piece.element_size()
            parts.append(piece.to(dev, non_blocking=True))
        out.append(torch.cat(parts, dim=-2 if to_cols else -1))
    exchange.calls += 1
    return out


exchange.bytes = 0
exchange.calls = 0


def halo_rows(x: RowBlocks, above: int, below: int) -> list:
    """Each block of x (tensors (..., n, C)) extended by its neighbours'
    rows: block k becomes the image rows [k n - above, (k + 1) n + below)
    mod N0 on devices[k], (..., n + above + below, C). A halo deeper than
    one block takes rows from as many blocks as it spans; each piece of
    another block is a copy to devices[k] (``exchange``'s ordering).
    ``halo_rows.bytes`` counts the bytes of those pieces,
    ``halo_rows.calls`` the calls."""
    n, d = x.rows, len(x.devices)
    out = []
    for k, dev in enumerate(x.devices):
        parts, r, hi = [], k * n - above, (k + 1) * n + below
        while r < hi:
            j, off = (r // n) % d, r % n
            piece = x.blocks[j][..., off:min(n, off + hi - r), :]
            if j != k:
                halo_rows.bytes += piece.numel() * piece.element_size()
                piece = piece.to(dev, non_blocking=True)
            parts.append(piece)
            r += piece.shape[-2]
        out.append(torch.cat(parts, dim=-2))
    halo_rows.calls += 1
    return out


halo_rows.bytes = 0
halo_rows.calls = 0


def _wrapped_rows(r0: int, r1: int, above: int, below: int, N0: int) -> np.ndarray:
    """The image rows [r0 - above, r1 + below) mod N0: a halo-extended
    block's row indices."""
    return np.arange(r0 - above, r1 + below) % N0


def _pexchange(blocks: Sequence[CPair], devices, to_cols: bool) -> list:
    """``exchange`` of pair blocks, lane by lane (the four-lane (rh, rl, ih,
    il) exchange of sfft_tpu's exact transform)."""
    lanes = [None if blocks[0][i] is None else exchange([b[i] for b in blocks], devices, to_cols)
             for i in range(4)]
    return [CPair(*(None if lane is None else lane[j] for lane in lanes))
            for j in range(len(devices))]


def _pad_cols(v: torch.Tensor, d: int) -> torch.Tensor:
    pad = (-v.shape[-1]) % d
    return F.pad(v, (0, pad)) if pad else v


# ---------------------------------------------------------------------------
# f64 / f32 transforms (cuFFT on each block)
# ---------------------------------------------------------------------------


def sharded_fft2(x, devices=None) -> RowBlocks:
    """The c128 or c64 2-D FFT of x (..., N0, N1) with row sharding (sfft_tpu
    :42): the axis-1 FFT per row block, the exchange, the axis-0 FFT per
    column block, the exchange back. N0 and N1 divisible by the number of
    devices."""
    x = shard_rows(x, devices)
    d = len(x.devices)
    if _lane(x.blocks[0]).shape[-1] % d:
        raise ValueError(f"N1 is not divisible by the {d} devices")
    f1 = [torch.fft.fft(b, dim=-1) for b in x.blocks]
    cols = [torch.fft.fft(c, dim=-2) for c in exchange(f1, x.devices, True)]
    return RowBlocks(tuple(exchange(cols, x.devices, False)), x.devices)


def sharded_rfft2(x, devices=None) -> RowBlocks:
    """The half spectrum (..., N0, N1 // 2 + 1) of a real x with row
    sharding: rfft over axis 1 per row block, its columns padded to a
    multiple of d for the exchange, the axis-0 FFT per column block, the
    exchange back, the padding trimmed."""
    x = shard_rows(x, devices)
    d = len(x.devices)
    f1 = [torch.fft.rfft(b, dim=-1) for b in x.blocks]
    C = f1[0].shape[-1]
    cols = [torch.fft.fft(c, dim=-2)
            for c in exchange([_pad_cols(v, d) for v in f1], x.devices, True)]
    return RowBlocks(tuple(v[..., :C] for v in exchange(cols, x.devices, False)), x.devices)


def sharded_irfft2(X, N1: int, devices=None) -> RowBlocks:
    """The real inverse (..., N0, N1) of a row-sharded half spectrum: the
    axis-0 inverse per column block between two exchanges, then irfft over
    axis 1 per row block."""
    X = shard_rows(X, devices)
    d = len(X.devices)
    C = X.blocks[0].shape[-1]
    cols = [torch.fft.ifft(c, dim=-2)
            for c in exchange([_pad_cols(v, d) for v in X.blocks], X.devices, True)]
    rows = exchange(cols, X.devices, False)
    return RowBlocks(tuple(torch.fft.irfft(v[..., :C], n=N1, dim=-1) for v in rows), X.devices)


# ---------------------------------------------------------------------------
# exact (sliced-integer pair) transforms
# ---------------------------------------------------------------------------


def _exact_axis0(blocks: Sequence[CPair], devices, N0: int, inverse: bool = False,
                 prof: Optional[SliceProfile] = None, plain: bool = False,
                 per_plane: bool = True) -> list:
    """The exact DFT over axis 0 of row-block pairs (..., n, C): columns
    padded to a multiple of d, the four-lane exchange, ``exact_dft_axis``
    over the N0 rows of the column blocks in lockstep (each sliced as the
    whole operand: one plane of a stack at a time with per_plane, as the
    local stages run them, else the whole stack), the exchange back, the
    padding trimmed."""
    d = len(devices)
    C = blocks[0].rh.shape[-1]
    cols = _pexchange([_pmap(b, lambda v: _pad_cols(v, d)) for b in blocks], devices, True)

    def axis0(cs):
        ys = exact_dft_axis_blocks([_pmap(c, _swap) for c in cs], N0, inverse=inverse,
                                   prof=prof, plain=plain)
        return [_pmap(y, _swap) for y in ys]

    if per_plane and cols[0].rh.dim() == 3:
        planes = [axis0([_pmap(c, lambda v, f=f: v[f]) for c in cols])
                  for f in range(cols[0].rh.shape[0])]
        out = [pair_stack([p[k] for p in planes]) for k in range(d)]
    else:
        out = axis0(cols)
    rows = _pexchange(out, devices, False)
    return [_pmap(r, lambda v: v[..., :C]) for r in rows]


def sharded_exact_fft2_pair(F_, devices=None, half: bool = False,
                            prof: Optional[SliceProfile] = None,
                            plain: bool = False) -> RowBlocks:
    """The exact-grade spectrum of a real f64 array (or real pair) F (..., N0,
    N1) with row sharding (sfft_tpu :66): ``exact_dft_axis`` over axis 1 on
    each row block on its device (K4, K7 and K6a there), the four-lane
    exchange, the axis-0 transform per column block, the exchange back.
    half=True keeps the Hermitian half (N1 // 2 + 1 columns). Returns
    RowBlocks of pairs. Every product slices each block with the whole
    operand's scale (one max over the blocks, a partial reduction), so the
    result is ``exact_fft2_pair``'s, bit for bit; a stack runs in
    ``exact_fft2_pair``'s plane chunks."""
    x = shard_rows(F_, devices)
    N0 = x.rows * len(x.devices)
    N1 = _lane(x.blocks[0]).shape[-1]
    pairs_ = [b if isinstance(b, CPair) else pair_from_f64(b) for b in x.blocks]
    if pairs_[0].rh.dim() == 3:
        chunk = int(max(1, min(8, 2 ** 24 // (N0 * N1))))
        F = pairs_[0].rh.shape[0]
        parts = [_exact_fft2_blocks([_pmap(p, lambda v: v[c0:c0 + chunk]) for p in pairs_],
                                    x.devices, N0, N1, half, prof, plain)
                 for c0 in range(0, F, chunk)]
        out = [CPair(*(None if parts[0][k][i] is None
                       else torch.cat([pt[k][i] for pt in parts], dim=0) for i in range(4)))
               for k in range(len(x.devices))]
    else:
        out = _exact_fft2_blocks(pairs_, x.devices, N0, N1, half, prof, plain)
    return RowBlocks(tuple(out), x.devices)


def _exact_fft2_blocks(pairs_, devices, N0, N1, half, prof, plain) -> list:
    ys = exact_dft_axis_blocks(pairs_, N1, half_out=half, prof=prof, plain=plain)
    return _exact_axis0(ys, devices, N0, prof=prof, plain=plain, per_plane=False)


def sharded_exact_irfft2_pair(FD, N1: int, devices=None, prof: Optional[SliceProfile] = None,
                              plain: bool = False) -> RowBlocks:
    """The real inverse of a row-sharded, folded Hermitian half spectrum
    pair (..., N0, N1 // 2 + 1) (fold weights applied), unscaled, as the
    exact differences take it: the axis-0 inverse per column block between
    two exchanges, then the half-input real inverse over axis 1
    (``exact_idft_halfin_real``) on each row block. Returns RowBlocks of
    real pairs (..., N0, N1)."""
    from sfft_tpu_torch.core.fdiff import exact_inverse_axis1_blocks

    FD = shard_rows(FD, devices)
    N0 = FD.rows * len(FD.devices)
    z = _exact_axis0(list(FD.blocks), FD.devices, N0, inverse=True, prof=prof, plain=plain,
                     per_plane=False)
    return RowBlocks(tuple(exact_inverse_axis1_blocks(z, N1, prof=prof, plain=plain)),
                     FD.devices)


def sharded_sep_weighted_spectra(heads: Sequence[list], base: RowBlocks, U: Static, V: Static,
                                 prof: Optional[SliceProfile] = None,
                                 plain: bool = False) -> RowBlocks:
    """``exact_sep_weighted_spectra`` with row sharding: heads (per block, a
    list of real pairs) and base (one real pair per block); the column
    weights V and the axis-1 legs on each block, the row weights U at the
    block's rows, then one exchange pair for the stack's axis-0 legs.
    Returns RowBlocks of the stacked half-spectrum pairs."""
    firsts, vsrc = _distinct_rows(V)
    devices = base.devices
    N0 = base.rows * len(devices)
    N1 = base.blocks[0].rh.shape[-1]
    k6a = _pairs.pair_products_plain if plain else _pairs.pair_products
    nh = len(heads[0])
    planes1 = [list(hs) + [b if ones else _pair_mul_static_rr(b, Static(_row, (V, kk)), plain)
                           for kk, ones in firsts]
               for hs, b in zip(heads, base.blocks)]
    # the axis-1 legs, one plane at a time over all blocks in lockstep
    T = [exact_dft_axis_blocks([p1[q] for p1 in planes1], N1, half_out=True, prof=prof,
                               plain=plain) for q in range(len(planes1[0]))]
    src = np.concatenate([np.arange(nh), nh + np.asarray(vsrc, dtype=np.int64)])
    z = []
    for (k, dev, r0, r1) in base.spans():
        Wh, Wl = _split_on(Static(_ones_above, (U, nh)), dev)
        z.append(pair_stack([k6a("mul_static_rr", T[int(t)][k],
                                 CPair(Wh[f][r0:r1, None], Wl[f][r0:r1, None], None, None))
                             for f, t in enumerate(src)]))
    return RowBlocks(tuple(_exact_axis0(z, devices, N0, prof=prof, plain=plain)), devices)


# ---------------------------------------------------------------------------
# products whose contraction runs over the row blocks
# ---------------------------------------------------------------------------


@lru_cache(maxsize=256)
def _static_scales_agree(Ws: tuple, nsl: int, devices: tuple, plain: bool, big: bool) -> bool:
    """Whether the blocks' static tables Ws slice under one scale per part
    (real, imaginary) and are zero in the same parts: then their int32
    products sum to the whole table's."""
    seen = []
    for W, dev in zip(Ws, devices):
        parts = [_static_slices_for(Static(f, (W,)), nsl, dev, plain, big)
                 for f in (np.real, np.imag)]
        seen.append(tuple(None if p is None else float(p.scale) for p in parts))
    return len(set(seen)) == 1


def _split_products(datas, Ws, W_full: Static, rowwise: bool, real_out: bool, prof, plain: bool,
                    k_total: int) -> torch.Tensor:
    """sum_k datas[k] @ Ws[k] for a contraction split over the blocks
    (datas[k] (..., n_k) the rows of block k, Ws[k] those rows of W_full),
    as f64 (hi + lo) on devices[0]: each block sliced with the whole
    operand's scales (rows' maxima over the blocks with rowwise), the
    blocks' int32 products summed (exactly, a table of the output's size)
    and one epilogue, which gives the whole product's bits. Where the
    blocks' static slices take different scales, each block's epilogue runs
    and the f64 results are summed."""
    p = prof or SliceProfile(NSL_DATA, NSL_STATIC, KMAX)
    big = _static_big(W_full, p.nsl_static)
    dev0 = datas[0].rh.device
    scales = _common_scales(datas, rowwise)
    devs = tuple(d.rh.device for d in datas)
    if _static_scales_agree(tuple(Ws), p.nsl_static, devs, plain, big):
        P = plan = sd = None
        for d, w, s in zip(datas, Ws, scales):
            Pk, plan, sdk = _cmatmul_sliced(d, w, rowwise, real_out, prof, plain, scales=s,
                                            k_total=k_total, static_big=big, epilogue=False)
            P = Pk.to(dev0) if P is None else P + Pk.to(dev0)
            sd = sd or sdk
        plan = plan._replace(terms=tuple(
            None if t is None else (t[0], t[1], t[2].to(dev0) if isinstance(t[2], torch.Tensor)
                                    else t[2]) for t in plan.terms))
        out = (_xf.sliced_epilogue_plain if plain else _xf.sliced_epilogue)(P, plan, sd)
        return out.rh.to(torch.float64) + out.rl
    total = None
    for d, w, s in zip(datas, Ws, scales):
        o = _cmatmul_sliced(d, w, rowwise, real_out, prof, plain, scales=s, k_total=k_total,
                            static_big=big)
        v = (o.rh.to(torch.float64) + o.rl).to(dev0)
        total = v if total is None else total + v
    return total


def _corr_window_blocks(sp: RowBlocks, N0: int, N1: int, wx: int, wy: int, ia, jb,
                        prof: Optional[SliceProfile] = None, plain: bool = False) -> torch.Tensor:
    """``exact_corr_window(..., pairs=(ia, jb))`` of row-sharded pair spectra
    (frequency rows in blocks): per block the Hadamard products and the
    axis-1 window product (full rows), then the axis-0 product split over
    the blocks (``_split_products``). Returns (npairs, 2wx+1, 2wy+1) f64 on
    devices[0]."""
    from sfft_tpu_torch.core.exact_fft import _corr_emat

    half = sp.blocks[0].rh.shape[-1] != N1
    E0, E1 = (Static(_corr_emat, (N0, N1, wx, wy, half, m)) for m in ("E0", "E1"))
    E0s = [Static(_row_block, (E0, r0, r1)) for (_, _, r0, r1) in sp.spans()]
    chunk = int(max(1, min(16, 2 ** 25 // (N0 * sp.blocks[0].rh.shape[-1]))))
    ia, jb = np.asarray(ia), np.asarray(jb)
    outs = []
    for c0 in range(0, len(ia), chunk):
        Yts = []
        for b in sp.blocks:
            dev = b.rh.device
            iaa, jbb = index(ia[c0:c0 + chunk], dev), index(jb[c0:c0 + chunk], dev)
            H = _pair_hadamard_conj(_pmap(b, lambda v: v.index_select(0, iaa)),
                                    _pmap(b, lambda v: v.index_select(0, jbb)), plain)
            Y = _cmatmul_sliced(H, E1, rowwise=True, prof=prof, plain=plain)  # (c, n, R1)
            Yts.append(_pmap(Y, _swap))
        Z = _split_products(Yts, E0s, E0, True, True, prof, plain, N0)        # (c, R1, R0)
        outs.append(_swap(Z))
    return torch.cat(outs, dim=0)


def _bg_corr_blocks(planes, spans, bg_spec, N0: int, N1: int, wx: int, wy: int,
                    plain: bool = False) -> torch.Tensor:
    """``greek.exact_bg_corr_pair`` of a real pair stack held as row blocks
    (planes[k] (F, n, N1)): the axis-1 product per block, the axis-0
    product split over the blocks. (F, Fpq, 2wx+1, 2wy+1) f64 on
    devices[0]."""
    from sfft_tpu_torch.core.basis import basis_1d_tables
    from sfft_tpu_torch.core.greek import _bg_roll_mat
    from sfft_tpu_torch.core.indices import ref_basis_exponents

    exps = ref_basis_exponents(bg_spec)
    U, V = basis_1d_tables(bg_spec, N0, N1)
    F0, F1 = U.shape[1], V.shape[1]
    R0, R1 = 2 * wx + 1, 2 * wy + 1
    Ur = Static(_bg_roll_mat, (bg_spec, N0, N1, wx, wy, 0))          # (N0, R0*F0)
    Vr = Static(_bg_roll_mat, (bg_spec, N0, N1, wx, wy, 1))          # (N1, R1*F1)
    M1s = _cmatmul_blocks(list(planes), Vr, plain=plain)              # (F, n, R1*F1)
    M1ts = [CPair(M.rh.transpose(-1, -2), M.rl.transpose(-1, -2), None, None) for M in M1s]
    Urs = [Static(_row_block, (Ur, r0, r1)) for (_, _, r0, r1) in spans]
    M = _split_products(M1ts, Urs, Ur, False, False, None, plain, N0)
    M = M.reshape(-1, R1, F1, R0, F0)
    out = torch.stack([M[:, :, int(j), :, int(i)] for (i, j) in exps], dim=1)
    return out.permute(0, 1, 3, 2)                                   # (F, Fpq, R0, R1)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def _sum_on(parts, device):
    """Sum of the blocks' partial results in block order on `device` (a
    tensor, or a NamedTuple of tensors)."""
    if isinstance(parts[0], tuple):
        return type(parts[0])(*(_sum_on([p[i] for p in parts], device)
                                for i in range(len(parts[0]))))
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def _on_each(t: torch.Tensor, devices) -> list:
    """A small tensor computed on devices[0] (the solution, peel
    coefficients) copied to each device."""
    return [t.to(dev) for dev in devices]


# ---------------------------------------------------------------------------
# the tables of each greek backend
# ---------------------------------------------------------------------------


def _fft_tables(cfg: SFFTConfig, I: RowBlocks, J: RowBlocks, plain: bool):
    """greek 'fft' / 'fft32' (greek_tables and greek_tables_separate): the
    lag-zero inner products per block, the windows of the row-sharded half
    spectra per frequency-row block (K1 with the block's rows of E0)."""
    from sfft_tpu_torch.core.engine import _plane_stacks
    from sfft_tpu_torch.core.greek import corr_window_fft, dot_planes

    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    dt = torch_dtype(cfg.dtype)
    sep = cfg.scaling_mode == "SEPARATE-VARYING"
    f32 = cfg.greek_backend == "fft32"
    dots, stacks = [], []
    for (k, dev, r0, r1), Ib, Jb in zip(I.spans(), I.blocks, J.blocks):
        SI, ST, SSc = _plane_stacks(cfg, Ib.to(dt), rows=(r0, r1))
        Jb = Jb.to(dt)
        dk = [dot_planes(ST, ST), dot_planes(ST, Jb[None])[:, 0]]
        if sep:
            dk += [dot_planes(SSc, SSc), dot_planes(SSc, ST), dot_planes(SSc, Jb[None])[:, 0]]
        dots.append(dk)
        planes = [Jb[None], SI, ST] + ([SSc] if sep else [])
        stack = torch.cat(planes, dim=0)
        stacks.append(stack.to(torch.float32) if f32 else stack)
    specs = sharded_rfft2(RowBlocks(tuple(stacks), I.devices))
    Fij, Fpq = cfg.Fij, cfg.Fpq
    wins = []
    for (k, dev, r0, r1), sp in zip(I.spans(), specs.blocks):
        specI, specJ = sp[1:1 + Fij], sp[0:1]
        specT = sp[1 + Fij:1 + Fij + Fpq]
        kw = dict(chunk=cfg.greek_chunk, plain=plain, row0=r0)
        wk = [corr_window_fft(specI, specI, N0, N1, 2 * w0, 2 * w1, symmetric=True, **kw),
              corr_window_fft(specI, specT, N0, N1, w0, w1, **kw),
              corr_window_fft(specI, specJ, N0, N1, w0, w1, **kw)[:, 0]]
        if sep:
            wk.append(corr_window_fft(specI, sp[1 + Fij + Fpq:], N0, N1, w0, w1, **kw))
        wins.append(wk)
    dev0 = I.devices[0]
    Comg, Cgam, Cthe = (_sum_on([w[i] for w in wins], dev0) for i in range(3))
    Cphi, Cdel = (_sum_on([dk[i] for dk in dots], dev0) for i in range(2))
    if f32:
        Cphi, Cdel = Cphi.to(torch.float32), Cdel.to(torch.float32)
    extra = None
    if sep:
        Pbs = _sum_on([w[3] for w in wins], dev0)
        Pss, Pgs, Pts = (_sum_on([dk[i] for dk in dots], dev0) for i in range(2, 5))
        if f32:
            Pss, Pgs, Pts = (t.to(torch.float32) for t in (Pss, Pgs, Pts))
        extra = (Pbs, Pss, Pgs, Pts)
    return (Comg, Cgam, Cthe, Cphi, Cdel), extra


class ExactShared(NamedTuple):
    """exact_plane_spectra with row sharding: per block the image pairs Jp,
    SIp, SScp (as the local front end has them) and sp, the stacked half
    spectra [J] + SI (+ SSc) in row blocks."""

    Jp: tuple
    SIp: tuple
    SScp: tuple
    sp: RowBlocks


def exact_shared(cfg: SFFTConfig, I: RowBlocks, J: RowBlocks, plain: bool = False) -> ExactShared:
    """The exact engine's front end (greek.exact_plane_spectra) on row
    blocks: the basis weightings at the block's rows, the separable-weight
    pair FFT with row sharding."""
    from sfft_tpu_torch.core.exact_fft import pair_sep_mul
    from sfft_tpu_torch.core.greek import _basis_factor, _plane_weights
    from sfft_tpu_torch.core.indices import ref_basis_exponents

    N0, N1 = cfg.N0, cfg.N1
    sep = cfg.scaling_mode == "SEPARATE-VARYING"
    Jps, Ips, SIps, SScps = [], [], [], []
    for (k, dev, r0, r1), Ib, Jb in zip(I.spans(), I.blocks, J.blocks):
        Ip = pair_from_f64(Ib.to(torch.float64))
        Jp = pair_from_f64(Jb.to(torch.float64))

        def weighted(spec):
            return [pair_sep_mul(Ip, Static(_row_block, (Static(_basis_factor,
                                                               (spec, N0, N1, 0, int(i))), r0, r1)),
                                 Static(_basis_factor, (spec, N0, N1, 1, int(j))), plain)
                    for (i, j) in ref_basis_exponents(spec)]

        Jps.append(Jp)
        Ips.append(Ip)
        SIps.append(weighted(cfg.kernel_basis))
        SScps.append(weighted(cfg.scaling_basis) if sep else None)
    sp = sharded_sep_weighted_spectra([[p] for p in Jps], RowBlocks(tuple(Ips), I.devices),
                                      Static(_plane_weights, (cfg, 0)),
                                      Static(_plane_weights, (cfg, 1)), plain=plain)
    return ExactShared(tuple(Jps), tuple(SIps), tuple(SScps), sp)


def _exact_tables(cfg: SFFTConfig, sh: ExactShared, plain: bool):
    """greek 'exact' (greek_tables_exact): the windows of the row-sharded
    pair spectra and the background correlations per row block, summed."""
    from sfft_tpu_torch.core.greek import exact_tables

    N0, N1 = cfg.N0, cfg.N1
    spans = sh.sp.spans()
    dev0 = sh.sp.devices[0]

    def window(ia, jb, wx, wy):
        return _corr_window_blocks(sh.sp, N0, N1, wx, wy, ia, jb, plain=plain)

    def planes(name, k):
        if name == "SI":
            return pair_stack(sh.SIp[k])
        if name == "SS":
            return pair_stack(sh.SScp[k])
        return CPair(sh.Jp[k].rh[None], sh.Jp[k].rl[None], None, None)

    def bg_corr(name, wx, wy):
        return _bg_corr_blocks([planes(name, k) for k in range(len(spans))], spans,
                               cfg.bg_basis, N0, N1, wx, wy, plain)

    Fs = len(sh.SScp[0]) if sh.SScp[0] is not None else 0
    out = exact_tables(cfg, len(sh.SIp[0]), Fs, dev0, window, bg_corr)
    return out[:5], (out[5] if cfg.scaling_mode == "SEPARATE-VARYING" else None)


def pexact_shared(cfg: SFFTConfig, I: RowBlocks, J: RowBlocks, plain: bool = False):
    """pexact_plane_spectra on row blocks: the moment sets per block (K3),
    summed on devices[0]; the peel fits there, copied to each device; the
    fluctuations per block (K6p sub at the block's rows); the
    separable-weight pair FFT with row sharding. Returns (PexactShared with
    the summed moments and the fits on devices[0] and sp in row blocks,
    the fits on each device)."""
    from sfft_tpu_torch.core.peel import coord_powers_of, fit_poly_coeffs, moment_set
    from sfft_tpu_torch.core.pexact import PexactShared, _geom, _poly_tables

    g = _geom(cfg)
    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    dt = torch_dtype(cfg.dtype)
    dev0 = I.devices[0]
    Ib = [b.to(dt) for b in I.blocks]
    Jb = [b.to(dt) for b in J.blocks]
    spans = I.spans()
    momI_o = _sum_on([moment_set(b, N0, N1, 2 * w0, 2 * w1, g.SG, g.ax0o, g.ax1o, plain,
                                 row0=r0) for (_, _, r0, _), b in zip(spans, Ib)], dev0)
    momJ_g = _sum_on([moment_set(b, N0, N1, w0, w1, g.SG, g.ax0g, g.ax1g, plain, row0=r0)
                      for (_, _, r0, _), b in zip(spans, Jb)], dev0)
    mI = fit_poly_coeffs(momI_o.M, g.dmu, g.ax0o, g.ax1o)
    mJ = fit_poly_coeffs(momJ_g.M, g.dmu, g.ax0g, g.ax1g)
    mIs, mJs = _on_each(mI, I.devices), _on_each(mJ, I.devices)
    sub = _pairs.pair_poly_sub_plain if plain else _pairs.pair_poly_sub
    FI, FJ = [], []
    for (k, dev, r0, r1), a, b in zip(spans, Ib, Jb):
        FI.append(sub(a.to(torch.float64), *_poly_tables(mIs[k], N0, N1, r0, r1)))
        FJ.append([sub(b.to(torch.float64), *_poly_tables(mJs[k], N0, N1, r0, r1))])
    prof = SliceProfile(*cfg.pexact_prof)
    U = Static(coord_powers_of, (N0, tuple(int(i) for i, _ in g.exps_k)))
    V = Static(coord_powers_of, (N1, tuple(int(j) for _, j in g.exps_k)))
    sp = sharded_sep_weighted_spectra(FJ, RowBlocks(tuple(FI), I.devices), U, V, prof=prof,
                                      plain=plain)
    return PexactShared(mI=mI, mJ=mJ, momI_o=momI_o, momJ_g=momJ_g, sp=sp), (mIs, mJs)


def _pexact_tables(cfg: SFFTConfig, sh, plain: bool):
    """greek 'pexact': the moment algebra on devices[0] from the summed
    moment sets, the fluctuation windows summed over row blocks."""
    from sfft_tpu_torch.core.pexact import pexact_greek_tables

    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    prof = SliceProfile(*cfg.pexact_prof)
    Fu = sh.sp.blocks[0].rh.shape[0] - 1

    def window(ia, jb):
        spa = RowBlocks(tuple(_pmap(b, lambda v: v[:1 + Fu]) for b in sh.sp.blocks),
                        sh.sp.devices)
        return _corr_window_blocks(spa, N0, N1, 2 * w0, 2 * w1, ia, jb, prof=prof, plain=plain)

    out = pexact_greek_tables(None, None, cfg, shared=sh, plain=plain, window=window)
    return out[:5], (out[5] if cfg.scaling_mode == "SEPARATE-VARYING" else None)


def _peeled_tables(cfg: SFFTConfig, I: RowBlocks, J: RowBlocks, plain: bool):
    """greek 'peeled' (peeled_greek_tables; peeled_pw_greek_tables for
    B-spline bases): the moment sets per block (K3), summed on devices[0];
    the fits there, copied to each device; the fluctuation planes per block
    in cfg.fluct_dtype, their half spectra with row sharding, the windows
    per frequency-row block (K1 with the block's rows of E0), summed in
    cfg.dtype; the moment algebra once on devices[0]."""
    from sfft_tpu_torch.core import peel, peel_pw

    if peel.polynomial_bases(cfg):
        moments, fits, fluct = peel.peel_moment_sets, peel.peel_fits, peel.fluct_stack
    else:
        moments, fits, fluct = (peel_pw.pw_peel_moment_sets, peel_pw.pw_peel_fits,
                                peel_pw.pw_fluct_stack)
    dt = torch_dtype(cfg.dtype)
    dev0 = I.devices[0]
    spans = I.spans()
    Ib = [b.to(dt) for b in I.blocks]
    Jb = [b.to(dt) for b in J.blocks]
    moms = [moments(a, b, cfg, plain, row0=r0) for (_, _, r0, _), a, b in zip(spans, Ib, Jb)]
    shared = fits(_sum_on([m[0] for m in moms], dev0), _sum_on([m[1] for m in moms], dev0), cfg)
    mIs, mJs = _on_each(shared.mI, I.devices), _on_each(shared.mJ, I.devices)
    stacks = [fluct(a, b, mIs[k], mJs[k], cfg, rows=(r0, r1))
              for (k, _, r0, r1), a, b in zip(spans, Ib, Jb)]
    specs = sharded_rfft2(RowBlocks(tuple(stacks), I.devices))
    wins = [peel.fluct_windows(sp, cfg, plain, row0=r0)
            for (_, _, r0, _), sp in zip(spans, specs.blocks)]
    FF, FFJ = (_sum_on([w[i] for w in wins], dev0) for i in range(2))
    out = peel.peeled_greek_tables(None, None, cfg, plain=plain, shared=shared,
                                   window=lambda: (FF, FFJ))
    return out[:5], (out[5] if cfg.scaling_mode == "SEPARATE-VARYING" else None)


def _corr_tables(cfg: SFFTConfig, I: RowBlocks, J: RowBlocks, plain: bool):
    """greek 'corr' (greek_tables and greek_tables_separate on K8): block
    k's share of CC(A_a, B_b)[rho, eps] sums x over the block's own rows,
    so its K8 launch (``greek.corr_table``) takes A zero outside them and B
    over the rows [r0 + rho_min, r1 + rho_max]: the image planes' halo rows
    (w0 above, 2 w0 below), the plane stacks built at the wrapped row
    indices. K8's circular wrap over the extended rows lands on A's zeros,
    and so does its operand swap. Comg takes the lag rows rho = 0 .. 2 w0
    of every pair (only the successor halo) and mirrors the rows rho < 0
    from the blocks' sum (a block's share is not symmetric); Cgam, Cthe and
    Pbs (on the active scaling planes) take -w0 .. w0; the lag-zero blocks
    are inner products per block. The sums run in block order on
    devices[0]."""
    from sfft_tpu_torch.core.engine import _plane_stacks
    from sfft_tpu_torch.core.greek import _pad_scaling, corr_table, dot_planes

    N0, w0, w1 = cfg.N0, cfg.w0, cfg.w1
    dt = torch_dtype(cfg.dtype)
    sep = cfg.scaling_mode == "SEPARATE-VARYING"
    nS = cfg.scaling_basis.num_funcs() if sep else 0
    n, R0 = I.rows, 2 * w0 + 1
    Ih = halo_rows(RowBlocks(tuple(b.to(dt) for b in I.blocks), I.devices), w0, 2 * w0)
    Jh = halo_rows(RowBlocks(tuple(b.to(dt) for b in J.blocks), J.devices), w0, w0)
    parts = []
    for (k, dev, r0, r1), Ik, Jk in zip(I.spans(), Ih, Jh):
        # SI over the rows [r0 - w0, r1 + 2 w0): Comg's frame starts at r0,
        # the others' frame [r0 - w0, r1 + w0) at row 0 of the stacks
        SI, ST, SSc = _plane_stacks(cfg, Ik, rows=_wrapped_rows(r0, r1, w0, 2 * w0, N0))
        own, frame = slice(w0, w0 + n), slice(0, n + 2 * w0)
        A2 = F.pad(SI[:, own], (0, 0, 0, 2 * w0))
        A1 = F.pad(SI[:, own], (0, 0, w0, w0))
        STb, Jb = ST[:, own], Jk[own]
        pk = [corr_table(A2, SI[:, w0:], 0, 2 * w0 + 1, 2 * w1, plain),
              corr_table(A1, ST[:, frame], -w0, R0, w1, plain),
              corr_table(A1, Jk[None], -w0, R0, w1, plain)[:, 0],
              dot_planes(STb, STb), dot_planes(STb, Jb[None])[:, 0]]
        if sep:
            SA = SSc[:nS]
            SAb = SA[:, own]
            pk += [corr_table(A1, SA[:, frame], -w0, R0, w1, plain), dot_planes(SAb, SAb),
                   dot_planes(SAb, STb), dot_planes(SAb, Jb[None])[:, 0]]
        parts.append(pk)
    dev0 = I.devices[0]
    sums = [_sum_on([p[i] for p in parts], dev0) for i in range(len(parts[0]))]
    half = sums[0]                                               # rho = 0 .. 2 w0
    Comg = half.new_empty(half.shape[:2] + (4 * w0 + 1, half.shape[3]))
    Comg[:, :, 2 * w0:] = half
    Comg[:, :, :2 * w0] = torch.flip(half[:, :, 1:], dims=(2, 3)).transpose(0, 1)
    extra = _pad_scaling(*sums[5:], max(cfg.Fij, nS) - nS) if sep else None
    return (Comg, *sums[1:5]), extra


# ---------------------------------------------------------------------------
# the differences of each fdiff backend
# ---------------------------------------------------------------------------


def _fdiff_fft(cfg: SFFTConfig, sols, I: RowBlocks, J: RowBlocks, plain: bool) -> RowBlocks:
    """fdiff 'fft' / 'fft32' (fdiff_fft): the half spectra with row
    sharding, the model spectrum per frequency-row block (K2 with the
    block's rows of W0), the sharded inverse."""
    from sfft_tpu_torch.core.engine import _plane_stacks
    from sfft_tpu_torch.core.fdiff import fdiff_model, fdiff_model_plain, phase_matrix
    from sfft_tpu_torch.core.statics import table

    if cfg.fdiff_backend == "fft32":
        cfg = dataclasses.replace(cfg, dtype="float32", fdiff_backend="fft")
    dt = torch_dtype(cfg.dtype)
    nS = cfg.scaling_basis.num_funcs() if cfg.scaling_mode == "SEPARATE-VARYING" else 0
    stacks, scal = [], []
    for (k, dev, r0, r1), Ib, Jb in zip(I.spans(), I.blocks, J.blocks):
        SI, ST, SSc = _plane_stacks(cfg, Ib.to(dt), dtype=dt, rows=(r0, r1))
        stacks.append(torch.cat([Jb.to(dt)[None], SI, ST], dim=0))
        scal.append(None if SSc is None else SSc[:nS])
    specs = sharded_rfft2(RowBlocks(tuple(stacks), I.devices))
    FS = sharded_rfft2(RowBlocks(tuple(scal), I.devices)).blocks if nS else [None] * len(stacks)
    model = fdiff_model_plain if plain else fdiff_model
    FD = []
    for (k, dev, r0, r1), sp, fs in zip(I.spans(), specs.blocks, FS):
        W0 = table(Static(phase_matrix, (cfg, True, 0)), dev)[r0:r1]
        W1 = table(Static(phase_matrix, (cfg, True, 1)), dev)
        sol = sols[k].to(W1.real.dtype).contiguous()
        FD.append(model(sp.contiguous(), None if fs is None else fs.contiguous(), sol, W0, W1,
                        cfg.Fij, cfg.w0, cfg.w1, cfg.SCALE))
    D = sharded_irfft2(RowBlocks(tuple(FD), I.devices), cfg.N1)
    return RowBlocks(tuple(v.to(dt) for v in D.blocks), D.devices)


def _fdiff_conv(cfg: SFFTConfig, sols, I: RowBlocks, J: RowBlocks, plain: bool) -> RowBlocks:
    """fdiff 'conv' (fdiff_conv): per block, the image's halo rows (L0 // 2
    each side), the SI planes (and the active scaling planes) at the
    wrapped row indices, padded circularly by L1 // 2 columns, and one K9
    launch in its padded-plane mode, whose output is the block's rows of
    the difference (``conv_direct_nonfinite``: a second launch gives the
    terms of non-finite pixels); the taps from each device's copy of the
    solution."""
    from sfft_tpu_torch.core import fdiff
    from sfft_tpu_torch.core.engine import _plane_stacks

    N0, w0, w1 = cfg.N0, cfg.w0, cfg.w1
    dt = torch_dtype(cfg.dtype)
    nS = cfg.scaling_basis.num_funcs() if cfg.scaling_mode == "SEPARATE-VARYING" else None
    n = I.rows
    Ih = halo_rows(RowBlocks(tuple(b.to(dt) for b in I.blocks), I.devices), w0, w0)
    conv = fdiff.conv_direct_plain if plain else fdiff.conv_direct_nonfinite
    out = []
    for (k, dev, r0, r1), Ik, Jb, sol in zip(I.spans(), Ih, J.blocks, sols):
        SI, ST, SSc = _plane_stacks(cfg, Ik, rows=_wrapped_rows(r0, r1, w0, w0, N0))
        Astd, b_pq, a00 = fdiff.conv_taps(cfg, sol.to(dt), nS)
        planes = F.pad(SI[None], (w1, w1, 0, 0), mode="circular")[0]
        own = slice(w0, w0 + n)
        out.append(conv(planes, Astd, False, Jb.to(dt), ST[:, own], b_pq,
                        None if nS is None else SSc[:nS, own], a00, cfg.SCALE))
    return RowBlocks(tuple(out), I.devices)


def _fdiff_exact(cfg: SFFTConfig, sols, sh: ExactShared, plain: bool) -> RowBlocks:
    """fdiff 'exact' (fdiff_exact): the kernel spectra at the block's
    frequency rows, the model spectrum per block (K6m), the sharded exact
    inverse, the background per block."""
    from sfft_tpu_torch.core.fdiff import (background_model, kernel_spectra_blocks,
                                           pair_model_spectrum, split_solution)

    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    nss = len(sh.SScp[0]) if sh.SScp[0] is not None else 0
    spans = sh.sp.spans()
    splits = [split_solution(cfg, sol.to(torch.float64)) for sol in sols]
    Ks = kernel_spectra_blocks(cfg, [a for a, _ in splits], [(r0, r1) for *_, r0, r1 in spans],
                               plain=plain)
    FD, bgs = [], []
    for (k, dev, r0, r1), sp, K, (a_ijab, b_pq) in zip(spans, sh.sp.blocks, Ks, splits):
        a00 = a_ijab[:, w0, w1]
        s_nc = a_ijab.sum(dim=(1, 2)) - a00
        FD.append(pair_model_spectrum(cfg, sp, K, a00, s_nc, nss, plain=plain))
        bgs.append(background_model(cfg, b_pq, dev, rows=(r0, r1)))
    y = sharded_exact_irfft2_pair(RowBlocks(tuple(FD), sh.sp.devices), N1, plain=plain)
    return RowBlocks(tuple((v.rh.to(torch.float64) + v.rl) / (N0 * N1) - bg
                           for v, bg in zip(y.blocks, bgs)), y.devices)


def _fdiff_pexact(cfg: SFFTConfig, sols, sh, fits, plain: bool) -> RowBlocks:
    """fdiff 'pexact' (fdiff_pexact): the fluctuation model per block, the
    sharded exact inverse at the config's profile, the smooth model (K6p
    add64 and the wrap strips) at the block's rows."""
    from sfft_tpu_torch.core.fdiff import (kernel_spectra_blocks, pair_model_spectrum,
                                           split_solution)
    from sfft_tpu_torch.core.pexact import _geom, pexact_smooth_model

    g = _geom(cfg)
    N0, N1, w0, w1 = cfg.N0, cfg.N1, cfg.w0, cfg.w1
    dt = torch_dtype(cfg.dtype)
    Fs = len(g.exps_k) - g.Fk_only
    prof = SliceProfile(*cfg.pexact_prof)
    spans = sh.sp.spans()
    a_list = [split_solution(cfg, sol.to(dt))[0] for sol in sols]
    Ks = kernel_spectra_blocks(cfg, a_list, [(r0, r1) for *_, r0, r1 in spans], plain=plain)
    FD = []
    for sp, K, a_ijab in zip(sh.sp.blocks, Ks, a_list):
        a00 = a_ijab[:, w0, w1]
        s_nc = a_ijab.sum(dim=(1, 2)) - a00
        FD.append(pair_model_spectrum(cfg, sp, K, a00, s_nc, Fs, plain=plain))
    y = sharded_exact_irfft2_pair(RowBlocks(tuple(FD), sh.sp.devices), N1, prof=prof,
                                  plain=plain)
    mIs, mJs = fits
    out = []
    for (k, dev, r0, r1), v in zip(y.spans(), y.blocks):
        Dfl = _pair_mul_static_rr(v, Static(np.float64, (1.0 / (N0 * N1),)), plain)
        out.append(pexact_smooth_model(cfg, sols[k], mIs[k], mJs[k], Dfl, row0=r0,
                                       plain=plain))
    return RowBlocks(tuple(out), y.devices)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def sharded_subtract_step(cfg: SFFTConfig, devices=None):
    """The solve-and-subtract step of one pair with row-sharded inputs
    (sfft_tpu :128): returns run(I, J, mI, mJ, plain=False,
    with_system=False) -> (solution, difference[, (lhs, rhs)]). The inputs
    are (N0, N1) arrays or tensors (split into row blocks over `devices`,
    every visible card when None; without a card this raises) or RowBlocks;
    the solution lies on devices[0], and the difference is gathered there
    as the caller's output. Every greek backend (GREEK_BACKENDS) and fdiff
    backend (FDIFF_BACKENDS) of SFFTConfig, any solver; the module
    docstring says what crosses devices."""
    devices = _check_devices(devices)
    d = len(devices)
    if cfg.N0 % d:
        raise ValueError(f"N0={cfg.N0} is not divisible by the {d} devices")
    from sfft_tpu_torch.core.solve import solve_system
    from sfft_tpu_torch.core.engine import system_from_tables

    dt = torch_dtype(cfg.dtype)

    def run(I, J, mI, mJ, plain: bool = False, with_system: bool = False):
        same = (I is mI) and (J is mJ)
        mIb, mJb = shard_rows(mI, devices), shard_rows(mJ, devices)
        Ib, Jb = (mIb, mJb) if same else (shard_rows(I, devices), shard_rows(J, devices))
        ex = pex = None
        if cfg.greek_backend in ("fft", "fft32"):
            out, extra = _fft_tables(cfg, mIb, mJb, plain)
        elif cfg.greek_backend == "exact":
            ex = exact_shared(cfg, mIb, mJb, plain)
            out, extra = _exact_tables(cfg, ex, plain)
        elif cfg.greek_backend == "pexact":
            pex = pexact_shared(cfg, mIb, mJb, plain)
            out, extra = _pexact_tables(cfg, pex[0], plain)
        elif cfg.greek_backend == "peeled":
            out, extra = _peeled_tables(cfg, mIb, mJb, plain)
        else:
            out, extra = _corr_tables(cfg, mIb, mJb, plain)
        lhs, rhs = system_from_tables(cfg, out, extra, devices[0])
        sol = solve_system(cfg, lhs, rhs, plain=plain).to(dt)
        sols = _on_each(sol, devices)
        if cfg.fdiff_backend in ("fft", "fft32"):
            D = _fdiff_fft(cfg, sols, Ib, Jb, plain)
        elif cfg.fdiff_backend == "conv":
            D = _fdiff_conv(cfg, sols, Ib, Jb, plain)
        elif cfg.fdiff_backend == "exact":
            if ex is None or not same:
                ex = exact_shared(cfg, Ib, Jb, plain)
            D = _fdiff_exact(cfg, sols, ex, plain)
        else:
            if pex is None or not same:
                pex = pexact_shared(cfg, Ib, Jb, plain)
            D = _fdiff_pexact(cfg, sols, pex[0], pex[1], plain)
        if cfg.fdiff_backend in ("exact", "pexact"):
            # in J's dtype, as fdiff_exact and fdiff_pexact return it
            D = RowBlocks(tuple(v.to(j.dtype) for v, j in zip(D.blocks, Jb.blocks)), devices)
        diff = gather_rows(D)
        return (sol, diff, (lhs, rhs)) if with_system else (sol, diff)

    return run
