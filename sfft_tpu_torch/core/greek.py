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
    (csrc/corr_window.cuh), which never writes the Hadamard product out.

'auto' picks 'irfft' for CPU tensors (as sfft_tpu does on the CPU) and the
kernel for CUDA tensors; plain=True keeps CUDA tensors on 'irfft', so a
caller can run the whole path on the plain twins.

The 'exact' backend (``greek_tables_exact``; the contract tables of the v2
engine, any spatial basis) computes the same windows without f64 FFTs: the
images ride as f32 pairs, one sliced-integer pair-FFT covers every data
plane (core/exact_fft.py, the K4 slicer), every spectrum-pair window comes
from one ``exact_corr_window`` pass, and the blocks against the analytic
background planes are rolled-basis moments.

The 'corr' backend (``corr_window_conv``) is the FFT-free f64 route: the
windows straight from the planes in real space, in the hand-written K8
kernel (csrc/corr_direct.cu) on CUDA tensors and its plain twin (a loop
over the lags, one product each) on CPU tensors.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from sfft_tpu_torch.core.basis import basis_1d_tables
from sfft_tpu_torch.core.indices import ref_basis_exponents
from sfft_tpu_torch.core.statics import Static, index, table


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
    # the lags +d and -d carry conjugate weights: what the kernel's
    # conjugate-pair route (``_corr_window`` with sym) relies on
    assert np.allclose(E1[:, wy + 1:], np.conj(E1[:, :wy][:, ::-1]), rtol=0.0, atol=1e-9)
    return E0.astype(cdtype), E1.astype(cdtype)


@lru_cache(maxsize=32)
def _idft_mats_on(N0: int, N1: int, wx: int, wy: int, dtype: torch.dtype,
                  device: torch.device, e0_rows=None):
    """_partial_idft_mats as contiguous tensors on `device` (cached: they are
    static per geometry, like the constants sfft_tpu bakes into its graph).
    e0_rows = (r0, r1) keeps E0's columns for the frequency rows [r0, r1)."""
    npdt = np.complex128 if dtype == torch.complex128 else np.complex64
    E0, E1 = _partial_idft_mats(N0, N1, wx, wy, npdt)
    if e0_rows is not None:
        E0 = E0[:, e0_rows[0]:e0_rows[1]]
    return (torch.as_tensor(E0, device=device).contiguous(),
            torch.as_tensor(E1, device=device).contiguous())


def corr_pairs_plain(specA, specB, ia, ib, E0, E1) -> torch.Tensor:
    """The plain twin of K1 (sfft_tpu's 'matmul' method) for a pair list:
    out[c] = Re(E0 @ (specA[ia[c]] * conj(specB[ib[c]])) @ E1)."""
    H = specA[index(ia, specA.device, torch.long)] * torch.conj(
        specB[index(ib, specA.device, torch.long)])
    T1 = torch.einsum("cuv,ve->cue", H, E1)
    return torch.real(torch.einsum("ru,cue->cre", E0, T1))


# csrc/corr_window.cuh: the stage-1 block and its fragments
_K1_NT_MAX = 6         # n-tiles (4 lag slots each) of a warp (kMaxNT)
_K1_ROWS = 16          # spectrum rows of a block: two m-tiles of 8 (kUT)
_BLOCK_WARPS = 4       # warps of a stage-1 block (kWarps)
_GROUP_SLOTS = 4       # planes a block holds in shared memory (kSlots)
_GROUP_INTS = 18       # ints per row of the group table (kGroupInts)
_U_RANGES = 32         # ranges of u that stage 2 sums apart (kUSplit)
_E1_ROW_PAD = 64       # the packed E1 has a multiple of this many rows (kMaxVT)


def _k1_plan(R1: int, sym: bool = False):
    """(S, NT, nng) of a K1 launch: the S lag slots (the R1 columns of E1,
    or with `sym` the w + 1 slots d = 0..w, w = R1 // 2, each standing for
    the columns w + d and w - d) in n-tiles of 4 slots, cut into nng
    n-groups of NT n-tiles, a warp each (padded slots are computed and not
    written): the fewest n-groups, then the fewest n-tiles."""
    S = R1 // 2 + 1 if sym else R1
    tiles = -(-S // 4)
    nng = -(-tiles // _K1_NT_MAX)
    return S, -(-tiles // nng), nng


def _k1_pairs_per_block(nng: int) -> int:
    """Pairs a stage-1 block works on: its warps over the warps (n-groups)
    of a pair."""
    return _BLOCK_WARPS // nng


def _k1_e1_index(N1h: int, R1: int, sym: bool, ntiles: int) -> np.ndarray:
    """Where each f64 of the packed E1 comes from: (rows / 4, ntiles, 32)
    indices into E1 (N1h, R1) viewed as reals, rows = N1h rounded up to a
    multiple of 64. Element (k, n, lane) is B[t][g] of the DMMA fragment of
    k-step k and n-tile n, lane = 4 g + t: column v = 4 k + t of E1 and lag
    slot s = 4 n + g // 2 (column s, or w + s with `sym`), its real part for
    even g and its imaginary part for odd g. Rows past N1h and slots past
    the lags index one past the end: the appended zero."""
    rows = -(-N1h // _E1_ROW_PAD) * _E1_ROW_PAD
    k = np.arange(rows // 4)[:, None, None]
    n = np.arange(ntiles)[None, :, None]
    lane = np.arange(32)[None, None, :]
    g, t = lane >> 2, lane & 3
    v, s = 4 * k + t, 4 * n + g // 2
    S = R1 // 2 + 1 if sym else R1
    col = s + (R1 // 2 if sym else 0)
    ok = (v < N1h) & (s < S)
    return np.where(ok, (v * R1 + col) * 2 + (g & 1), 2 * N1h * R1).astype(np.int64)


@lru_cache(maxsize=64)
def _k1_e1_index_on(N1h: int, R1: int, sym: bool, ntiles: int, device: torch.device):
    return torch.as_tensor(_k1_e1_index(N1h, R1, sym, ntiles), device=device)


def _k1_pack_e1(E1: torch.Tensor, sym: bool, ntiles: int) -> torch.Tensor:
    """E1 (N1h, R1) complex as the f64 B fragments of K1's DMMAs, in the
    order the kernel reads them (``_k1_e1_index``): one gather of its real
    and imaginary parts, widened exactly, with zeros past the lags and past
    N1h."""
    N1h, R1 = E1.shape
    flat = torch.view_as_real(E1).reshape(-1).to(torch.float64)
    flat = torch.nn.functional.pad(flat, (0, 1))
    return flat[_k1_e1_index_on(N1h, R1, bool(sym), ntiles, E1.device)]


def _pair_groups(ia, ib, same: bool, ppb: int):
    """The schedule of a K1 launch: the pair list (ia[c], ib[c]) cut into
    groups of at most `ppb` pairs that touch at most 4 planes between them,
    so that a block copies each plane's tile once for all its pairs. Pairs
    are binned by rectangles of planes (2 x 2 for 4 pairs per block, or 3 x 1
    where one side has a single plane; 2 x 1 for 2), and a bin holding more
    than `ppb` pairs (a repeated pair) is cut in list order. `same`: the
    two stacks are one tensor, so plane p of A and plane p of B share a slot.

    Returns a list of (slots, pairs): slots a list of (stack, plane) with
    stack 0 for A and 1 for B; pairs a list of (slot_a, slot_b, c)."""
    ia = [int(v) for v in ia]
    ib = [int(v) for v in ib]
    ua, ub = sorted(set(ia)), sorted(set(ib))
    if ppb >= 4:
        ra, rb = (3, 1) if len(ub) == 1 else (1, 3) if len(ua) == 1 else (2, 2)
    elif ppb >= 2:
        ra, rb = (2, 1) if len(ua) > 1 else (1, 2)
    else:
        ra, rb = 1, 1
    bin_a = {p: k // ra for k, p in enumerate(ua)}
    bin_b = {p: k // rb for k, p in enumerate(ub)}
    bins = {}
    for c, (a, b) in enumerate(zip(ia, ib)):
        bins.setdefault((bin_a[a], bin_b[b]), []).append(c)
    groups = []
    for cs in bins.values():
        for k in range(0, len(cs), ppb):
            slots, pairs = [], []
            for c in cs[k:k + ppb]:
                keys = ((0, ia[c]), (0 if same else 1, ib[c]))
                for key in keys:
                    if key not in slots:
                        slots.append(key)
                pairs.append((slots.index(keys[0]), slots.index(keys[1]), c))
            groups.append((slots, pairs))
    return groups


def _group_table(groups) -> np.ndarray:
    """The groups as the (ngroups, 18) int32 table the kernel reads: npairs,
    nslots, the slots' planes [4] and stacks [4], the pairs' slots as
    slot_a + 4 * slot_b [4] and their output indices c [4]."""
    tab = np.zeros((len(groups), _GROUP_INTS), np.int32)
    for row, (slots, pairs) in zip(tab, groups):
        assert 1 <= len(pairs) <= _BLOCK_WARPS and 1 <= len(slots) <= _GROUP_SLOTS
        row[0], row[1] = len(pairs), len(slots)
        for k, (stack, plane) in enumerate(slots):
            row[2 + k], row[6 + k] = plane, stack
        for k, (sa, sb, c) in enumerate(pairs):
            row[10 + k], row[14 + k] = sa + 4 * sb, c
    return tab


def _batch_groups(ia, ib, same: bool, ppb: int, blocks: int = 1):
    """``_pair_groups`` of a list that is `blocks` equal consecutive
    segments (the pairs of a batch: each segment is one image pair's list
    of plane pairs), scheduled segment by segment, so that a group never
    mixes two segments and each segment's groups are those of its own list."""
    n = len(ia) // blocks
    groups = []
    for k in range(blocks):
        for slots, pairs in _pair_groups(ia[k * n:(k + 1) * n], ib[k * n:(k + 1) * n], same, ppb):
            groups.append((slots, [(sa, sb, c + k * n) for sa, sb, c in pairs]))
    return groups


@lru_cache(maxsize=256)
def _schedule(ia: tuple, ib: tuple, same: bool, ppb: int, device: torch.device,
              blocks: int = 1):
    """(group table on `device`, ngroups) of a pair list of `blocks`
    segments (``_batch_groups``): built and uploaded once per list."""
    groups = _group_table(_batch_groups(ia, ib, same, ppb, blocks))
    return torch.tensor(groups.ravel(), device=device), len(groups)


def _corr_launch(specA, specB, ia, ib, E0, E1, sym=False, blocks=1):
    """One K1 launch; with `sym` (and an odd R1) on the conjugate-pair
    route: the plan, the pair schedule (of `blocks` segments) and the
    packed E1, then ``_k1_call``."""
    R1 = E1.shape[1]
    sym = bool(sym) and R1 % 2 == 1
    _, NT, nng = _k1_plan(R1, sym)
    same = specA.data_ptr() == specB.data_ptr() and specA.shape == specB.shape
    table_dev, ngroups = _schedule(tuple(int(v) for v in ia), tuple(int(v) for v in ib), same,
                                   _k1_pairs_per_block(nng), specA.device, blocks)
    E1p = _k1_pack_e1(E1, sym, NT * nng)
    return _k1_call(specA, specB, table_dev, ngroups, len(ia), E0, E1p, R1, NT, nng, sym)


def _k1_call(specA, specB, groups, ngroups, npairs, E0, E1p, R1, NT, nng, sym):
    """The C entry of csrc/corr_window.cuh on the launch's operands (the
    scratch allocated here: the stage-1 result and stage 2's partial sums
    over ranges of u, f64 for both types). ``corr_window.launches`` counts
    its launches."""
    from sfft_tpu_torch import _kernels

    N0, N1h = specA.shape[1], specA.shape[2]
    R0 = E0.shape[0]
    double = specA.dtype == torch.complex128
    dev = specA.device
    T1 = torch.empty((npairs, N0, R1), dtype=specA.dtype, device=dev)
    part = torch.empty((npairs, _U_RANGES, R0, R1), dtype=torch.float64, device=dev)
    out = torch.empty((npairs, R0, R1), dtype=torch.float64 if double else torch.float32,
                      device=dev)
    entry = "sfft_corr_window_c128" if double else "sfft_corr_window_c64"
    with torch.cuda.device(dev):
        err = getattr(_kernels.lib(), entry)(
            specA.data_ptr(), specB.data_ptr(), groups.data_ptr(), E0.data_ptr(),
            E1p.data_ptr(), T1.data_ptr(), part.data_ptr(), out.data_ptr(),
            npairs, ngroups, specA.shape[0], specB.shape[0], N0, N1h, R0, R1, NT, nng, int(sym),
            _kernels.stream_ptr(specA))
    corr_window.launches += 1
    _kernels.check(err, "corr_window kernel launch")
    return out


def corr_window(specA: torch.Tensor, specB: torch.Tensor, ia, ib,
                E0: torch.Tensor, E1: torch.Tensor) -> torch.Tensor:
    """K1: windowed cross-correlations (npairs, R0, R1) for the pair list
    (ia, ib) of the half-spectrum stacks specA (Fa, N0, N1h) and specB
    (Fb, N0, N1h), with any weight matrices E0 (R0, N0) and E1 (N1h, R1).
    CUDA tensors launch csrc/corr_window.cuh (complex64 or complex128); CPU
    tensors use ``corr_pairs_plain``."""
    return _corr_window(specA, specB, ia, ib, E0, E1, sym=False)


def _corr_window(specA, specB, ia, ib, E0, E1, sym: bool, blocks: int = 1) -> torch.Tensor:
    """``corr_window``; with `sym` the kernel takes E1's columns as
    conjugate-symmetric about the middle one, E1[:, w + d] == conj(E1[:,
    w - d]) with w = R1 // 2: it forms both lags from one set of products
    (half the multiply-adds) and reads only the columns from w on. Only for
    the matrices of ``_partial_idft_mats``, which are built so and checked
    there. `blocks`: the list is that many equal segments (a batch's
    pairs), which the kernel's schedule keeps apart (``_batch_groups``)."""
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
    if len(ia) % blocks:
        raise ValueError("corr_window: the pair list is not whole segments")
    return _corr_launch(specA, specB, ia, ib, E0, E1, sym=sym, blocks=blocks)


corr_window.launches = 0


def _plane_view(X: torch.Tensor):
    """K1's operand for the plane stacks of a batch of pairs, X (B, F, N0,
    N1h): a (planes, N0, N1h) view of X's storage in which pair z's plane f
    is plane off[z] + f, and off. A slice of a larger stack along its plane
    axis (the views of one transform that the tables take) passes without
    a copy; another layout is made contiguous first."""
    X = X.resolve_conj()
    B, F, n0, n1 = X.shape
    P = n0 * n1
    if tuple(X.stride()[1:]) != (P, n1, 1) or (B > 1 and X.stride(0) % P):
        X = X.contiguous()
    step = X.stride(0) // P if B > 1 else F
    return X.as_strided(((B - 1) * step + F, n0, n1), (P, n1, 1)), np.arange(B) * step


def _corr_irfft(specA, specB, N0: int, N1: int, wx: int, wy: int, chunk: int) -> torch.Tensor:
    """The 'irfft' method of ``corr_window_fft`` for one pair's stacks."""
    Fa, Fb = specA.shape[0], specB.shape[0]
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
    row0=None,
) -> torch.Tensor:
    """CC(A_a, B_b)[rho, eps] for all pairs, lags |rho|<=wx, |eps|<=wy.

    specA: (Fa, N0, N1h) raw rfft2 spectra of A stack; specB likewise (Fb, ...).
    Returns (Fa, Fb, 2*wx+1, 2*wy+1) real. method: 'irfft' | 'matmul' |
    'kernel' | 'auto' (see the module docstring). symmetric (with specA is
    specB, for 'matmul' and 'kernel') computes the upper triangle of pairs
    and mirrors it: CC(A_b, A_a)[rho] = CC(A_a, A_b)[-rho]. chunk bounds the
    pairs per contraction (memory throttling). row0: the stacks hold the
    frequency rows [row0, row0 + rows) of the spectra only, and the result
    is their share of the windows (the partial inverse DFT over those rows;
    'auto' then takes 'matmul' where it would take 'irfft').

    A leading pair axis, specA (B, Fa, N0, N1h) and specB (B, Fb, N0, N1h),
    gives (B, Fa, Fb, 2*wx+1, 2*wy+1), pair z's windows bit for bit those of
    the call on specA[z], specB[z]; a single call is the batch of one. The
    kernel takes the batch folded into its plane axis (``_plane_view``):
    one pair list, each pair's the list of its own call offset to its
    planes and scheduled apart (``_corr_window``'s `blocks`), at most 65535
    pairs a launch. 'irfft' and 'matmul' run pair by pair (a batched
    irfft2 changes a pair's bits).
    """
    same = symmetric and specA is specB
    one = specA.dim() == 3
    if one:
        specA = specA[None]
        specB = specA if same else specB[None]
    B, Fa, Fb = specA.shape[0], specA.shape[1], specB.shape[1]
    R0, R1 = 2 * wx + 1, 2 * wy + 1
    if method == "auto":
        method = "irfft" if (plain or specA.device.type == "cpu") else "kernel"
        if method == "irfft" and row0 is not None:
            method = "matmul"
    if row0 is not None and method == "irfft":
        raise ValueError("a row block of the spectra takes the 'matmul' or 'kernel' method")
    if method == "irfft":
        out = torch.stack([_corr_irfft(specA[z], specB[z], N0, N1, wx, wy, chunk)
                           for z in range(B)])
        return out[0] if one else out
    if method not in ("matmul", "kernel"):
        raise ValueError(f"unknown corr_window_fft method {method!r}")

    e0_rows = None if row0 is None else (row0, row0 + specA.shape[2])
    E0, E1 = _idft_mats_on(N0, N1, wx, wy, specA.dtype, specA.device, e0_rows)
    if same:
        iu, ju = np.triu_indices(Fa)
    else:
        iu, ju = (g.ravel() for g in np.meshgrid(np.arange(Fa), np.arange(Fb), indexing="ij"))
    n = len(iu)
    csize = chunk if chunk else n
    if method == "kernel":
        # the window's weights come in conjugate pairs of lags (+d, -d)
        A, offA = _plane_view(specA)
        Bv, offB = (A, offA) if same else _plane_view(specB)
        ia, ib = (offA[:, None] + iu).ravel(), (offB[:, None] + ju).ravel()
        if csize < n:   # a pair's own list in chunks, as its single call cuts it
            parts = [_corr_window(A, Bv, ia[z * n + k:z * n + min(n, k + csize)],
                                  ib[z * n + k:z * n + min(n, k + csize)], E0, E1, sym=True)
                     for z in range(B) for k in range(0, n, csize)]
        else:
            per = max(1, min(65535, chunk or 65535) // n)   # pairs of the batch a launch
            parts = [_corr_window(A, Bv, ia[z * n:min(B, z + per) * n],
                                  ib[z * n:min(B, z + per) * n], E0, E1, sym=True,
                                  blocks=min(B, z + per) - z)
                     for z in range(0, B, per)]
    else:
        parts = [corr_pairs_plain(specA[z], specB[z], iu[k:k + csize], ju[k:k + csize], E0, E1)
                 for z in range(B) for k in range(0, n, csize)]
    tri = torch.cat(parts, dim=0).reshape(B, n, R0, R1)
    if same:
        full = torch.zeros((B, Fa, Fa, R0, R1), dtype=tri.dtype, device=tri.device)
        iu_t = index(iu, tri.device, torch.long)
        ju_t = index(ju, tri.device, torch.long)
        full[:, iu_t, ju_t] = tri
        full[:, ju_t, iu_t] = torch.flip(tri, dims=(2, 3))
    else:
        full = tri.reshape(B, Fa, Fb, R0, R1)
    return full[0] if one else full


def rfft2_pairs(x: torch.Tensor) -> torch.Tensor:
    """rfft2 of each pair's plane stack x[b] (B, F, N0, N1) into one (B, F,
    N0, N1h) tensor: one transform call a pair, on the shape of the single
    call's, because cuFFT picks its plan by the whole batch (a batched call
    changed a pair's bits at 128^2 on the card, the `gpu` case of
    tests/test_torch_pair_axis.py, though not at 4096^2). A batch of one is
    the pair's own transform (``out=`` costs a copy of the spectra on the
    card)."""
    if x.shape[0] == 1:
        return torch.fft.rfft2(x[0])[None]
    out = torch.empty(tuple(x.shape[:-1]) + (x.shape[-1] // 2 + 1,),
                      dtype=torch.complex128 if x.dtype == torch.float64 else torch.complex64,
                      device=x.device)
    for b in range(x.shape[0]):
        torch.fft.rfft2(x[b], out=out[b])
    return out


def irfft2_pairs(X: torch.Tensor, s) -> torch.Tensor:
    """irfft2 of each pair's spectra X[b] (B, ..., N0, N1h) to the real
    shape `s` into one tensor, one call a pair (cuFFT's batched inverse
    transform changes a pair's bits with B); a batch of one is the pair's
    own transform."""
    if X.shape[0] == 1:
        return torch.fft.irfft2(X[0], s=s)[None]
    out = torch.empty(tuple(X.shape[:-2]) + tuple(s),
                      dtype=torch.float64 if X.dtype == torch.complex128 else torch.float32,
                      device=X.device)
    for b in range(X.shape[0]):
        torch.fft.irfft2(X[b], s=s, out=out[b])
    return out


def corr_direct_plain(A: torch.Tensor, B: torch.Tensor, ia, ib, wx: int, wy: int) -> torch.Tensor:
    """K8's plain twin: C[p, rho + wx, eps + wy] = sum_xy A[ia[p], x, y] *
    B[ib[p], (x + rho) % N0, (y + eps) % N1] as (npairs, 2wx+1, 2wy+1), in
    the input dtype: the pairs of ``corr_table_plain``'s table (one loop
    over the lags, one (Fa, N) x (N, Fb) product each; never F.conv2d with
    the image as its weight: its im2col matrix holds one row per lag and
    one column per pixel)."""
    ia = torch.as_tensor(np.asarray(ia, np.int64), device=A.device)
    ib = torch.as_tensor(np.asarray(ib, np.int64), device=A.device)
    return corr_table_plain(A, B, -wx, 2 * wx + 1, wy)[ia, ib]


def corr_window_conv_plain(A: torch.Tensor, B: torch.Tensor, wx: int, wy: int) -> torch.Tensor:
    """The plain twin of ``corr_window_conv``: every pair (Fa, Fb, 2wx+1,
    2wy+1) through ``corr_direct_plain``."""
    Fa, Fb = A.shape[0], B.shape[0]
    ia, ib = np.meshgrid(np.arange(Fa), np.arange(Fb), indexing="ij")
    return corr_direct_plain(A, B, ia.ravel(), ib.ravel(), wx, wy).reshape(
        Fa, Fb, 2 * wx + 1, 2 * wy + 1)


# csrc/corr_direct.cu: kP lag rows a warp, kTY staged columns, kMT A planes
# an m-tile
_K8_P, _K8_TY, _K8_MT = 6, 16, 8
# shared memory of a block: two blocks an SM fit under the first, one under
# the second (the card's 227 KB)
_K8_SMEM_TWO, _K8_SMEM_MAX = 114688, 232448
# staged B rows in order of preference
_K8_ROWS = (16, 32, 8)
# blocks the grid should hold: eight waves of two an SM on the card's 132
# SMs (small tables split their columns over more blocks)
_K8_BLOCKS = 2112


def _k8_group_tile(ng: int, ntiles: int, nng: int) -> int:
    """csrc/corr_direct.cu ``group_tile``: the first n-tile of n-group ng
    (the groups split the tiles evenly)."""
    return ng * ntiles // nng


def _k8_unit(u: int, nrg: int):
    """csrc/corr_direct.cu ``unit_of``: unit u's (lag group, n-group)."""
    return u % nrg, u // nrg


def _k8_block_span(plan: dict, blk: int):
    """csrc/corr_direct.cu ``block_span`` and ``block_columns``: the lag
    groups (first, last), n-groups (first, last) and (plane, lag) columns
    (first, last) of block blk's units."""
    W, nrg, nng, ntiles = plan["W"], plan["nrg"], plan["nng"], plan["ntiles"]
    units = [_k8_unit(u, nrg) for u in range(blk * W, min(blk * W + W, plan["nunits"]))]
    rgs, ngs = [u[0] for u in units], [u[1] for u in units]
    n_lo = _k8_group_tile(min(ngs), ntiles, nng) * 8
    n_hi = min(_k8_group_tile(max(ngs) + 1, ntiles, nng) * 8, plan["NN"]) - 1
    return (min(rgs), max(rgs)), (min(ngs), max(ngs)), (n_lo, n_hi)


def _k8_layout(Fa: int, Fb: int, N0: int, N1: int, nrho: int, wy: int, NT: int, RT: int,
               W: int, CS: int = 1) -> dict:
    """K8's launch plan, owned here: the units of work (lag group x n
    group, lag group fastest), the blocks (W units each, grid (nmt * bpb,
    nbands, CS)), the staged rows (the most lag rows a block spans) and
    planes of one of the two buffers and the shared memory in bytes. The
    launch passes span, nbp and nbands; csrc/corr_direct.cu ``make_plan``
    derives the same buffer layout from them, and a block the plan does
    not cover writes NaN."""
    P, TY, MT = _K8_P, _K8_TY, _K8_MT
    R1 = 2 * wy + 1
    nmt, nA, nrg, NN = -(-Fa // MT), min(Fa, MT), -(-nrho // P), Fb * R1
    ntiles = -(-NN // 8)
    nng = -(-ntiles // NT)
    nunits = nrg * nng
    plan = dict(Fa=Fa, Fb=Fb, nrho=nrho, wy=wy, R1=R1, NT=NT, RT=RT, W=W, CS=CS, nmt=nmt,
                nA=nA, nrg=nrg, NN=NN, ntiles=ntiles, nng=nng, nunits=nunits,
                bpb=-(-nunits // W), nchunks=-(-N1 // TY), BW=TY + R1 - 1,
                nbands=-(-(N0 + nrho - 1) // RT))
    span = nbp = 0
    for blk in range(plan["bpb"]):
        (rg_lo, rg_hi), _, (n_lo, n_hi) = _k8_block_span(plan, blk)
        span = max(span, (rg_hi - rg_lo + 1) * P)
        nbp = max(nbp, n_hi // R1 - n_lo // R1 + 1)
    RA = RT + span - 1
    SA = RA * TY + 4
    buf = nA * SA + nbp * RT * plan["BW"]
    plan.update(span=span, RA=RA, SA=SA, SB=RT * plan["BW"], nbp=nbp, buf=buf, smem=16 * buf)
    return plan


def _k8_plan(Fa: int, Fb: int, N0: int, N1: int, nrho: int, wy: int) -> dict:
    """K8's launch plan for a (Fa, Fb, nrho, 2wy+1) table (csrc/corr_direct.cu:
    mma.sync m16n8k4 in f64, M = two lag rows x 8 A planes, N = 8 flattened
    (B plane, lag) columns, K = 4 image columns; a warp keeps 6 lag rows x
    NT n-tiles of accumulators, and a producer warp stages the tiles). NT
    is 5, or 4 where that splits the tiles into as many n-groups (fewer
    registers). W, the compute warps of a block, is the lag groups (2 to
    4), so that a block's warps share one n-group's staged planes and every
    lag row it stages (3 lag groups and the producer: a warp on each SM
    sub-partition); 1 where no block of W fits. RT, the staged B rows, is
    the first of _K8_ROWS whose two buffers fit two blocks an SM (else
    one). CS splits the columns until the grid holds _K8_BLOCKS blocks."""
    ntiles, nrg = -(-Fb * (2 * wy + 1) // 8), -(-nrho // _K8_P)
    NT = 4 if -(-ntiles // 4) == -(-ntiles // 5) else 5
    for budget in (_K8_SMEM_TWO, _K8_SMEM_MAX):
        for W in (min(max(nrg, 2), 4), 1):
            for RT in _K8_ROWS:
                plan = _k8_layout(Fa, Fb, N0, N1, nrho, wy, NT, RT, W)
                if plan["smem"] <= budget:
                    blocks = plan["nmt"] * plan["bpb"] * plan["nbands"]
                    CS = min(plan["nchunks"], max(1, -(-_K8_BLOCKS // blocks)))
                    return _k8_layout(Fa, Fb, N0, N1, nrho, wy, NT, RT, W, CS)
    raise ValueError(f"corr_direct: no K8 block fits shared memory for {Fb} planes of "
                     f"{2 * wy + 1} lags")


def _k8_padded(Fx: int, Fy: int, R1: int) -> int:
    """Products a K8 launch computes per pixel and lag row with Fx planes
    as its plane operand and Fy as its shifted one: planes to 8, (plane,
    lag) columns to 8."""
    return -(-Fx // _K8_MT) * _K8_MT * (-(-Fy * R1 // 8) * 8)


def _k8_launch(A: torch.Tensor, B: torch.Tensor, rho_lo: int, nrho: int, wy: int) -> torch.Tensor:
    """One launch of K8 (csrc/corr_direct.cu): C[a, b, i, e] =
    sum_xy A[a, x, y] * B[b, (x + rho_lo + i) % N0, (y + e - wy) % N1] as
    (Fa, Fb, nrho, 2wy+1) f64, A the plane operand, B the shifted one; the
    partials of the bands and column splits, then their fixed-order sum.
    ``_K8.launches`` (on this function) counts the launches."""
    from sfft_tpu_torch import _kernels

    Fa, Fb, N0, N1 = A.shape[0], B.shape[0], A.shape[1], A.shape[2]
    plan = _k8_plan(Fa, Fb, N0, N1, nrho, wy)
    dev = A.device
    part = torch.empty((plan["nbands"] * plan["CS"], Fa, Fb, nrho, 2 * wy + 1),
                       dtype=torch.float64, device=dev)
    out = torch.empty((Fa, Fb, nrho, 2 * wy + 1), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = _kernels.lib().sfft_corr_direct(
            A.data_ptr(), B.data_ptr(), part.data_ptr(), out.data_ptr(), Fa, Fb, N0, N1,
            rho_lo, nrho, wy, plan["NT"], plan["RT"], plan["W"], plan["CS"], plan["span"],
            plan["nbp"], plan["nbands"], _kernels.stream_ptr(A))
    _K8.launches += 1
    _kernels.check(err, "corr_direct kernel launch")
    return out


_k8_launch.launches = 0
# the counter's owner: the module attribute may be replaced by a caller
# that intercepts the launches (the tests' emulation)
_K8 = _k8_launch


def _k8_table(A: torch.Tensor, B: torch.Tensor, rho_lo: int, nrho: int, wy: int) -> torch.Tensor:
    """C[a, b, i, e] = CC(A_a, B_b)[rho_lo + i, e - wy], (Fa, Fb, nrho,
    2wy+1), in one K8 launch. The operand whose padding wastes less is the
    kernel's plane operand: when that is B, the launch computes CC(B_b,
    A_a) at the negated lags (CC(A_a, B_b)[d] = CC(B_b, A_a)[-d]) and the
    table is flipped back."""
    R1 = 2 * wy + 1
    if _k8_padded(B.shape[0], A.shape[0], R1) < _k8_padded(A.shape[0], B.shape[0], R1):
        T = _k8_launch(B, A, -(rho_lo + nrho - 1), nrho, wy)
        return torch.flip(T, dims=(2, 3)).transpose(0, 1).contiguous()
    return _k8_launch(A, B, rho_lo, nrho, wy)


def corr_direct(A: torch.Tensor, B: torch.Tensor, ia, ib, wx: int, wy: int) -> torch.Tensor:
    """K8: the windowed circular cross-correlations (npairs, 2wx+1, 2wy+1)
    of the plane pairs (A[ia[p]], B[ib[p]]) (``corr_direct_plain``'s
    arguments). CUDA tensors: csrc/corr_direct.cu on the FP64 tensor cores
    (float64, two launches: the bands, then their fixed-order sum;
    bit-reproducible), which computes every pair of A and B planes in one
    launch (``_k8_table``) and returns the listed ones; CPU tensors:
    ``corr_direct_plain``. ``_K8.launches`` counts the launches."""
    if A.dim() != 3 or B.dim() != 3 or A.shape[1:] != B.shape[1:]:
        raise ValueError(f"corr_direct needs (F, N0, N1) stacks, got {tuple(A.shape)} and "
                         f"{tuple(B.shape)}")
    if A.dtype != B.dtype or A.device != B.device:
        raise ValueError("corr_direct needs A and B of one dtype on one device")
    ia, ib = np.asarray(ia, np.int64).ravel(), np.asarray(ib, np.int64).ravel()
    if ia.shape != ib.shape or wx < 0 or wy < 0:
        raise ValueError("corr_direct needs equal-length pair lists and lags >= 0")
    if len(ia) and (ia.min() < 0 or ia.max() >= A.shape[0] or ib.min() < 0
                    or ib.max() >= B.shape[0]):
        raise IndexError("corr_direct pair index out of range")
    if A.device.type == "cpu":
        return corr_direct_plain(A, B, ia, ib, wx, wy)
    _k8_check(A, B, wy)
    if not len(ia):
        return A.new_empty((0, 2 * wx + 1, 2 * wy + 1))
    T = _k8_table(A, B, -wx, 2 * wx + 1, wy)
    return T[index(ia, A.device, torch.long), index(ib, A.device, torch.long)]


def _k8_check(A: torch.Tensor, B: torch.Tensor, wy: int):
    if A.device.type != "cuda":
        raise ValueError(f"corr_direct runs on cpu or cuda tensors, not {A.device}")
    if A.dtype != torch.float64 or B.dtype != torch.float64:
        raise TypeError(f"the K8 kernel is the float64 route's; got {A.dtype}")
    if not (A.is_contiguous() and B.is_contiguous()):
        raise ValueError("corr_direct needs contiguous stacks")
    if 2 * wy + 1 > 255:
        raise ValueError("corr_direct kernel takes at most 255 lags along axis 1")



def _corr_window_k8(A: torch.Tensor, B: torch.Tensor, wx: int, wy: int) -> torch.Tensor:
    """corr_window_conv's K8 route (one launch): when B is A, the lag rows
    rho >= 0 of every pair, the rows rho < 0 mirrored from them
    (CC(A_a, A_b)[-d] = CC(A_b, A_a)[d]); else all lag rows."""
    if A is B:
        half = _k8_table(A, A, 0, wx + 1, wy)                   # rho = 0 .. wx
        full = half.new_empty((A.shape[0], A.shape[0], 2 * wx + 1, 2 * wy + 1))
        full[:, :, wx:] = half
        full[:, :, :wx] = torch.flip(half[:, :, 1:], dims=(2, 3)).transpose(0, 1)
        return full
    return _k8_table(A, B, -wx, 2 * wx + 1, wy)


def corr_table_plain(A: torch.Tensor, B: torch.Tensor, rho_lo: int, nrho: int,
                     wy: int) -> torch.Tensor:
    """``_k8_table``'s plain twin: C[a, b, i, e] = sum_xy A[a, x, y] *
    B[b, (x + rho_lo + i) % N0, (y + e - wy) % N1], (Fa, Fb, nrho, 2wy+1)
    in the input dtype; one (Fa, N) x (N, Fb) product a lag."""
    Fa, Fb = A.shape[0], B.shape[0]
    Af = A.reshape(Fa, -1)
    out = A.new_empty((Fa, Fb, nrho, 2 * wy + 1))
    for i in range(nrho):
        Br = torch.roll(B, shifts=-(rho_lo + i), dims=1)
        for e in range(-wy, wy + 1):
            out[:, :, i, e + wy] = Af @ torch.roll(Br, shifts=-e, dims=2).reshape(Fb, -1).T
    return out


def corr_table(A: torch.Tensor, B: torch.Tensor, rho_lo: int, nrho: int, wy: int,
               plain: bool = False) -> torch.Tensor:
    """CC(A_a, B_b)[rho_lo + i, e - wy] for lag rows rho_lo .. rho_lo +
    nrho - 1, (Fa, Fb, nrho, 2wy+1): one K8 launch on CUDA tensors
    (``_k8_table``), ``corr_table_plain`` on CPU tensors or with
    plain=True. The row-sharded step runs it on a row block's
    halo-extended planes (parallel/sharded_fft.py)."""
    if plain or A.device.type == "cpu":
        return corr_table_plain(A, B, rho_lo, nrho, wy)
    A, B = A.contiguous(), B.contiguous()
    _k8_check(A, B, wy)
    return _k8_table(A, B, rho_lo, nrho, wy)


def corr_window_conv(A: torch.Tensor, B: torch.Tensor, wx: int, wy: int,
                     plain: bool = False) -> torch.Tensor:
    """FFT-free CC(A_a, B_b)[rho, eps] windows, (Fa, Fb, 2wx+1, 2wy+1) in
    the input dtype (sfft_tpu's corr_window_conv, the greek 'corr'
    backend): C[a, b, rho + wx, eps + wy] = sum_xy A[a, x, y] *
    B[b, (x + rho) % N0, (y + eps) % N1]. CUDA tensors run K8 once
    (``_corr_window_k8``; when B is A, only the lag rows rho >= 0, the
    others mirrored). CPU tensors and plain=True run
    ``corr_window_conv_plain``."""
    if plain or A.device.type == "cpu":
        return corr_window_conv_plain(A, B, wx, wy)
    same = A is B
    A = A.contiguous()
    B = A if same else B.contiguous()
    _k8_check(A, B, wy)
    return _corr_window_k8(A, B, wx, wy)


def dot_planes(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Lag-zero correlations only: (Fa, Fb) matrix of plane inner products."""
    Fa = A.shape[0]
    Fb = B.shape[0]
    return A.reshape(Fa, -1) @ B.reshape(Fb, -1).T


def _bg_roll_mat(bg_spec, N0: int, N1: int, wx: int, wy: int, axis: int) -> np.ndarray:
    """Rolled 1-D background-basis table of one axis, (N, R * F): column
    (r, f) holds basis function f circularly shifted by lag r - w, so a
    correlation against a separable analytic plane at every lag of the
    window is one contraction with it."""
    T = basis_1d_tables(bg_spec, N0, N1)[axis]
    w = wx if axis == 0 else wy
    rolled = np.stack([np.roll(T, -lag, axis=0) for lag in range(-w, w + 1)], 1)
    return rolled.reshape(T.shape[0], -1)


def exact_bg_corr(A: torch.Tensor, bg_spec, N0: int, N1: int, wx: int, wy: int,
                  plain: bool = False) -> torch.Tensor:
    """CC(A_a, T_q)[rho, eps] exactly for separable analytic background
    planes T_q(x, y) = u_p(x) v_q(y): the lag set is static, so circularly
    shifted basis factors are rolled value tables and the correlation is
    two skinny f64 contractions (the K3 kernel on CUDA tensors):

        CC[a, (p,q), rho, eps] = sum_xy A_a[x,y] u_p(x+rho) v_q(y+eps)

    Any separable basis (polynomial or B-spline). Returns
    (Fa, Fpq, 2wx+1, 2wy+1) f64."""
    from sfft_tpu_torch.core.peel import _exact_skinny_matmul

    dev = A.device
    exps = ref_basis_exponents(bg_spec)
    U, V = basis_1d_tables(bg_spec, N0, N1)
    F0, F1 = U.shape[1], V.shape[1]
    R0, R1 = 2 * wx + 1, 2 * wy + 1
    Ur = table(Static(np.transpose, (Static(_bg_roll_mat, (bg_spec, N0, N1, wx, wy, 0)),)),
               dev, torch.float64)                                   # (R0*F0, N0)
    Vr = table(Static(np.transpose, (Static(_bg_roll_mat, (bg_spec, N0, N1, wx, wy, 1)),)),
               dev, torch.float64)                                   # (R1*F1, N1)
    Fa = A.shape[0]
    A64 = A.to(torch.float64)
    # step 1 (y): M1[(e,t), (a,x)] = sum_y Vr[(e,t), y] A[a, x, y]
    M1 = _exact_skinny_matmul(Vr, A64.permute(2, 0, 1).reshape(N1, -1), plain=plain)
    # step 2 (x): M2[(r,s), (e,t), a] = sum_x Ur[(r,s), x] M1[(e,t), (a,x)]
    M1 = M1.reshape(R1 * F1 * Fa, N0).T
    M2 = _exact_skinny_matmul(Ur, M1, plain=plain).reshape(R0, F0, R1, F1, Fa)
    out = torch.stack([M2[:, int(i), :, int(j), :] for (i, j) in exps], dim=0)
    return out.permute(3, 0, 1, 2)                                   # (Fa, Fpq, R0, R1)


def exact_bg_corr_pair(Ap, bg_spec, N0: int, N1: int, wx: int, wy: int,
                       plain: bool = False) -> torch.Tensor:
    """exact_bg_corr for a pair-represented real plane stack Ap (F, N0, N1):
    both contractions run through the sliced-integer exact products. Returns
    (F, Fpq, R0, R1) f64. Ap (B, F, N0, N1), a batch of pairs: (B, F, Fpq,
    R0, R1), both products sliced under each pair's own global scale (K4's
    per-pair mode), so each pair's bits are those of its single call."""
    from sfft_tpu_torch.core.exact_fft import CPair, _cmatmul_sliced

    exps = ref_basis_exponents(bg_spec)
    U, V = basis_1d_tables(bg_spec, N0, N1)
    F0, F1 = U.shape[1], V.shape[1]
    R0, R1 = 2 * wx + 1, 2 * wy + 1
    lead = tuple(Ap.rh.shape[:-3])                                   # () or (B,)
    batch = lead[0] if lead else 0
    Ur = Static(_bg_roll_mat, (bg_spec, N0, N1, wx, wy, 0))          # (N0, R0*F0)
    Vr = Static(_bg_roll_mat, (bg_spec, N0, N1, wx, wy, 1))          # (N1, R1*F1)
    M1 = _cmatmul_sliced(Ap, Vr, plain=plain, batch=batch)           # pair (F, N0, R1*F1)
    M1t = CPair(M1.rh.transpose(-1, -2), M1.rl.transpose(-1, -2), None, None)
    M2 = _cmatmul_sliced(M1t, Ur, plain=plain, batch=batch)          # pair (F, R1*F1, R0*F0)
    M = (M2.rh.to(torch.float64) + M2.rl).reshape(lead + (-1, R1, F1, R0, F0))
    out = torch.stack([M[..., int(j), :, int(i)] for (i, j) in exps], dim=-3)
    return out.transpose(-1, -2)                                     # (F, Fpq, R0, R1)


def _basis_factor(spec, N0: int, N1: int, axis: int, k: int) -> np.ndarray:
    """1-D basis function k of one axis, shaped to broadcast over a plane:
    (N0, 1) for axis 0, (1, N1) for axis 1."""
    col = basis_1d_tables(spec, N0, N1)[axis][:, k]
    return col[:, None] if axis == 0 else col[None, :]


def _plane_weights(cfg, axis: int) -> np.ndarray:
    """(F, N) row (axis 0) or column (axis 1) weights of the basis-weighted
    planes in spectrum order: the kernel basis, then the scaling basis for
    SEPARATE-VARYING."""
    specs = [cfg.kernel_basis]
    if cfg.scaling_mode == "SEPARATE-VARYING":
        specs.append(cfg.scaling_basis)
    rows = []
    for spec in specs:
        T = basis_1d_tables(spec, cfg.N0, cfg.N1)[axis]
        rows += [T[:, ij[axis]] for ij in ref_basis_exponents(spec)]
    return np.stack(rows)


def exact_plane_spectra(I: torch.Tensor, J: torch.Tensor, cfg, plain: bool = False):
    """Shared front end of the exact engine: pair-split the images, build
    the basis-weighted pair planes [J, I*beta_ij (, I*sigma_ij)] in f32 pair
    arithmetic, and take one half-spectrum pair-FFT of the whole stack.

    Both the Greek tables (greek_tables_exact) and the exact difference
    (fdiff_exact) consume this; the solve+subtract step computes it once
    when the masked and unmasked pairs are the same tensors.

    Returns (Jp, SIp, SScp, sp): image-domain pairs (Jp one plane, SIp list
    of Fij, SScp list or None) and the stacked half spectra CPair in plane
    order [J] + SI (+ SSc). I and J (B, N0, N1), a batch of pairs: every
    plane keeps the pair axis (Jp and the list entries (B, N0, N1), sp (B,
    planes, N0, N1h)), one set of K4 / K7 / K6a launches for the batch, each
    pair's bits those of its single call."""
    from sfft_tpu_torch.core.exact_fft import (exact_sep_weighted_spectra, pair_from_f64,
                                               pair_sep_mul)

    N0, N1 = cfg.N0, cfg.N1
    Ip = pair_from_f64(I.to(torch.float64))
    Jp = pair_from_f64(J.to(torch.float64))

    def weighted(spec):
        return [pair_sep_mul(Ip, Static(_basis_factor, (spec, N0, N1, 0, int(i))),
                             Static(_basis_factor, (spec, N0, N1, 1, int(j))), plain)
                for (i, j) in ref_basis_exponents(spec)]

    # image-domain weighted planes (the background moments consume them)
    SIp = weighted(cfg.kernel_basis)
    SScp = weighted(cfg.scaling_basis) if cfg.scaling_mode == "SEPARATE-VARYING" else None
    # separable-weight pair-FFT: Fi*Fj basis planes share Fj distinct
    # column factors, so the axis-1 legs run once per distinct factor
    sp = exact_sep_weighted_spectra([Jp], Ip, Static(_plane_weights, (cfg, 0)),
                                    Static(_plane_weights, (cfg, 1)), plain=plain)
    return Jp, SIp, SScp, sp


def greek_tables_exact(I: torch.Tensor, J: torch.Tensor, cfg, shared=None,
                       plain: bool = False):
    """All exact-grade tables for one config, without f64 FFTs: the images
    are pair-split once, the basis weightings run in f32 pair arithmetic,
    one pair-FFT covers every data plane (SEPARATE-VARYING scaling planes
    included), and the background blocks are rolled-basis sliced moments.

    shared: the precomputed exact_plane_spectra(I, J, cfg), when the caller
    has it. Returns (Comg, Cgam, Cthe, Cphi, Cdel[, (Pbs, Pss, Pgs, Pts)]).
    I and J (B, N0, N1) (or `shared` of such a batch): every table with a
    leading pair axis (Cphi, the same for every pair, as a view), each
    pair's bits those of its single call."""
    from sfft_tpu_torch.core.exact_fft import _pmap, exact_corr_window, pair_stack

    N0, N1 = cfg.N0, cfg.N1
    if shared is None:
        shared = exact_plane_spectra(I, J, cfg, plain=plain)
    Jp, SIp, SScp, sp = shared
    # the image-domain stacks (F, N0, N1), or (B, F, N0, N1) for a batch
    planes = {"SI": lambda: pair_stack(SIp, dim=-3), "SS": lambda: pair_stack(SScp, dim=-3),
              "J": lambda: _pmap(Jp, lambda v: v[..., None, :, :])}

    def window(ia, jb, wx, wy):
        return exact_corr_window(sp, sp, N0, N1, wx, wy, pairs=(ia, jb), plain=plain)

    def bg_corr(name, wx, wy):
        return exact_bg_corr_pair(planes[name](), cfg.bg_basis, N0, N1, wx, wy, plain=plain)

    return exact_tables(cfg, len(SIp), len(SScp) if SScp is not None else 0,
                        sp.rh.device, window, bg_corr)


def exact_tables(cfg, Fij: int, Fs: int, dev, window, bg_corr):
    """greek_tables_exact's tables from its two correlations:
    window(ia, jb, wx, wy), the windows (npairs, 2wx+1, 2wy+1) f64 of the
    spectrum pairs (ia[c], jb[c]) in plane order [J] + SI (+ SSc), and
    bg_corr(name, wx, wy), the correlations (F, Fpq, 2wx+1, 2wy+1) f64 of
    the planes `name` ("SI", "SS" or "J") with the background planes. The
    row-sharded step passes sums over row blocks. Correlations with a
    leading pair axis (a batch) give every table that axis."""
    N0, N1 = cfg.N0, cfg.N1
    w0, w1 = cfg.w0, cfg.w1
    separate_varying = cfg.scaling_mode == "SEPARATE-VARYING"

    # ALL spectrum-pair windows share ONE pass at the widest (+-2w) window
    # (the partial inverse DFT pads every lag grid to the same 64 product
    # columns, so a narrower window costs the same): OMG (SI x SI, +-2w),
    # THE (SI x J, +-w) and for SEPARATE-VARYING also PBS / PSS / PTS
    iu, ju = np.triu_indices(Fij)
    ia_l = [iu + 1, np.arange(Fij) + 1]
    jb_l = [ju + 1, np.zeros(Fij, np.int64)]
    if separate_varying:
        gI, gS = np.meshgrid(np.arange(Fij) + 1, np.arange(Fs) + 1 + Fij, indexing="ij")
        su, sv = np.triu_indices(Fs)
        ia_l += [gI.ravel(), su + 1 + Fij, np.arange(Fs) + 1 + Fij]
        jb_l += [gS.ravel(), sv + 1 + Fij, np.zeros(Fs, np.int64)]
    cc = window(np.concatenate(ia_l), np.concatenate(jb_l), 2 * w0, 2 * w1)
    lead = tuple(cc.shape[:-3])          # () or (B,): the pair axis
    n_omg = len(iu)
    iu_t, ju_t = index(iu, dev), index(ju, dev)
    Comg = torch.zeros(lead + (Fij, Fij, 4 * w0 + 1, 4 * w1 + 1), dtype=cc.dtype, device=dev)
    Comg[..., iu_t, ju_t, :, :] = cc[..., :n_omg, :, :]
    Comg[..., ju_t, iu_t, :, :] = torch.flip(cc[..., :n_omg, :, :], dims=(-2, -1))
    win0, win1 = slice(w0, 3 * w0 + 1), slice(w1, 3 * w1 + 1)
    Cthe = cc[..., n_omg: n_omg + Fij, win0, win1]
    Cgam = bg_corr("SI", w0, w1)
    Cphi = table(Static(bg_static_gram, (cfg.bg_basis, N0, N1)), dev, cc.dtype)
    Cphi = Cphi.expand(lead + tuple(Cphi.shape))
    Cdel = bg_corr("J", 0, 0)[..., 0, :, 0, 0]
    if not separate_varying:
        return Comg, Cgam, Cthe, Cphi, Cdel

    o = n_omg + Fij
    Pbs = cc[..., o: o + Fij * Fs, win0, win1].reshape(lead + (Fij, Fs, 2 * w0 + 1, 2 * w1 + 1))
    o += Fij * Fs
    su_t, sv_t = index(su, dev), index(sv, dev)
    pss_u = cc[..., o: o + len(su), 2 * w0, 2 * w1]
    Pss = torch.zeros(lead + (Fs, Fs), dtype=cc.dtype, device=dev)
    Pss[..., su_t, sv_t] = pss_u
    Pss[..., sv_t, su_t] = pss_u
    o += len(su)
    Pts = cc[..., o: o + Fs, 2 * w0, 2 * w1]
    Pgs = bg_corr("SS", 0, 0)[..., 0, 0]
    return Comg, Cgam, Cthe, Cphi, Cdel, _pad_scaling(Pbs, Pss, Pgs, Pts, cfg.Fij - Fs)


def _pad_scaling(Pbs, Pss, Pgs, Pts, npad: int):
    """Zero-pad the scaling-plane axes of the SEPARATE-VARYING tables from
    the active scaling functions to Fij (the placeholder dofs)."""
    if npad:
        pad = torch.nn.functional.pad
        Pbs = pad(Pbs, (0, 0, 0, 0, 0, npad))
        Pss = pad(Pss, (0, npad, 0, npad))
        Pgs = pad(Pgs, (0, 0, 0, npad))
        Pts = pad(Pts, (0, npad))
    return Pbs, Pss, Pgs, Pts


def bg_static_gram(bg_spec, N0: int, N1: int) -> np.ndarray:
    """PHI block in closed form: <T_q, T_q'> = (sum_x u u') (sum_y v v'),
    separable exact host-side sums."""
    U, V = basis_1d_tables(bg_spec, N0, N1)
    exps = ref_basis_exponents(bg_spec)
    GU = U.T @ U
    GV = V.T @ V
    return np.array([[GU[i1, i2] * GV[j1, j2] for (i2, j2) in exps]
                     for (i1, j1) in exps])


def _half_spectra(stack: torch.Tensor, plain: bool):
    from sfft_tpu_torch.core.exact_fft import exact_fft2_pair

    return exact_fft2_pair(stack.to(torch.float64), half=True, plain=plain)


def greek_tables_separate(
    SI: torch.Tensor,
    SSc: torch.Tensor,
    ST: torch.Tensor,
    J: torch.Tensor,
    w0: int,
    w1: int,
    backend: str = "fft",
    chunk: int = 0,
    bg_spec=None,
    n_active: int = 0,
    plain: bool = False,
):
    """Extra correlation tables for SEPARATE-VARYING scaling: the center-offset
    dofs attach to the sigma-weighted stack SSc = I * sigma_ij (zero-padded to
    Fij planes; reference ScaSPixA_Iij, sfft/BSplineSFFT.py:2862-2886).

    Returns (Pbs_raw, Pss_raw, Pgs_raw, Pts_raw) unscaled CC tables:
      Pbs: CC(SI_a, SSc_b) window +-w; Pss: CC(SSc_a, SSc_b)[0];
      Pgs: CC(SSc_a, T_q)[0]; Pts: CC(SSc_a, J)[0].
    Backends 'fft', 'fft32' (f32 tables), 'exact' and 'corr' (K8). The fft
    backends take a batch of pairs too (SI, SSc (B, F, N0, N1), J (B, N0,
    N1), ST shared), as ``greek_tables`` does.
    """
    N0, N1 = J.shape[-2:]
    if backend == "exact":
        from sfft_tpu_torch.core.exact_fft import _pmap, exact_corr_window

        Fij = SI.shape[0]
        Fs = n_active if n_active else SSc.shape[0]
        SScA = SSc[:Fs]   # trailing planes are static zero padding: skip
        sp = _half_spectra(torch.cat([SI, SScA, J[None]], dim=0), plain)
        specI = _pmap(sp, lambda v: v[:Fij])
        specS = _pmap(sp, lambda v: v[Fij:-1])
        specJ = _pmap(sp, lambda v: v[-1:])
        Pbs = exact_corr_window(specI, specS, N0, N1, w0, w1, plain=plain)
        Pss = exact_corr_window(specS, specS, N0, N1, 0, 0, symmetric=True,
                                plain=plain)[:, :, 0, 0]
        Pts = exact_corr_window(specS, specJ, N0, N1, 0, 0, plain=plain)[:, 0, 0, 0]
        if bg_spec is not None:
            Pgs = exact_bg_corr(SScA, bg_spec, N0, N1, 0, 0, plain=plain)[:, :, 0, 0]
        else:
            specT = _half_spectra(ST, plain)
            Pgs = exact_corr_window(specS, specT, N0, N1, 0, 0, plain=plain)[:, :, 0, 0]
        return _pad_scaling(Pbs, Pss, Pgs, Pts, SSc.shape[0] - Fs)
    if backend == "corr":
        # K8 on the active scaling planes only (the trailing planes are
        # static zero padding), the lag-zero blocks as inner products
        SScA = SSc[:n_active] if n_active else SSc
        Pbs = corr_window_conv(SI, SScA, w0, w1, plain=plain)
        return _pad_scaling(Pbs, dot_planes(SScA, SScA), dot_planes(SScA, ST),
                            dot_planes(SScA, J[None])[:, 0], SSc.shape[0] - SScA.shape[0])
    if backend not in ("fft", "fft32"):
        raise ValueError(f"unknown greek backend {backend!r}")
    if J.dim() == 2:   # one pair: the batch of one
        return tuple(t[0] for t in greek_tables_separate(
            SI[None], SSc[None], ST, J[None], w0, w1, backend=backend, chunk=chunk,
            plain=plain))
    Pss = torch.stack([dot_planes(x, x) for x in SSc])
    Pgs = torch.stack([dot_planes(x, ST) for x in SSc])
    Pts = torch.stack([dot_planes(x, j[None])[:, 0] for x, j in zip(SSc, J)])
    if backend == "fft32":
        # c64 spectra into the windowed correlation (K1 in c64 on the card);
        # the lag-zero blocks stay f64 inner products, cast to f32
        SI, SSc = SI.to(torch.float32), SSc.to(torch.float32)
        Pss, Pgs, Pts = (t.to(torch.float32) for t in (Pss, Pgs, Pts))
    Pbs = corr_window_fft(rfft2_pairs(SI), rfft2_pairs(SSc), N0, N1, w0, w1, chunk=chunk,
                          plain=plain)
    return Pbs, Pss, Pgs, Pts


def greek_tables(
    SI: torch.Tensor,
    ST: torch.Tensor,
    J: torch.Tensor,
    w0: int,
    w1: int,
    backend: str = "fft",
    chunk: int = 0,
    plain: bool = False,
    bg_spec=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """All correlation tables the assembly needs.

    Returns (Comg, Cgam, Cthe, Cphi, Cdel):
      Comg: (Fij, Fij, 4*w0+1, 4*w1+1)   lags -2w..2w, index lag+2w
      Cgam: (Fij, Fpq, 2*w0+1, 2*w1+1)   lags -w..w, index lag+w
      Cthe: (Fij, 2*w0+1, 2*w1+1)
      Cphi: (Fpq, Fpq) lag 0
      Cdel: (Fpq,)     lag 0

    Unscaled CC values; the engine applies the SCALE powers that map CC to the
    reference's Pre tables. Backends 'fft', 'fft32' (f32 compute and f32
    tables), 'corr' (the FFT-free f64 route: ``corr_window_conv``, K8, for
    Comg, Cgam and Cthe) and 'exact' ('exact':
    the sliced-integer pair-FFT and windowed correlation for the data x data
    blocks; with `bg_spec`, the background basis, rolled-basis exact moments
    for everything against the background planes, else the generic spectral
    route on the ST planes). plain=True keeps every correlation and slicer
    on the plain twins.

    The 'fft' and 'fft32' backends take a batch of pairs, SI (B, Fij, N0,
    N1) and J (B, N0, N1) with ST shared, and give every table a leading
    pair axis, each pair's bits those of its single call (which is the
    batch of one): the forward transforms and the lag-zero inner products
    pair by pair, each window one K1 launch for the batch
    (``corr_window_fft``).
    """
    N0, N1 = J.shape[-2:]
    if backend == "exact":
        from sfft_tpu_torch.core.exact_fft import _pmap, exact_corr_window

        Fij = SI.shape[0]
        sp = _half_spectra(torch.cat([J[None], SI], dim=0), plain)
        specJ = _pmap(sp, lambda v: v[0:1])
        specI = _pmap(sp, lambda v: v[1: 1 + Fij])
        Comg = exact_corr_window(specI, specI, N0, N1, 2 * w0, 2 * w1, symmetric=True,
                                 plain=plain)
        Cthe = exact_corr_window(specI, specJ, N0, N1, w0, w1, plain=plain)[:, 0]
        if bg_spec is not None:
            Cgam = exact_bg_corr(SI, bg_spec, N0, N1, w0, w1, plain=plain)
            Cphi = table(Static(bg_static_gram, (bg_spec, N0, N1)), J.device, torch.float64)
            Cdel = exact_bg_corr(J[None], bg_spec, N0, N1, 0, 0, plain=plain)[0, :, 0, 0]
        else:
            specT = _half_spectra(ST, plain)
            Cgam = exact_corr_window(specI, specT, N0, N1, w0, w1, plain=plain)
            Cphi = exact_corr_window(specT, specT, N0, N1, 0, 0, symmetric=True,
                                     plain=plain)[:, :, 0, 0]
            Cdel = exact_corr_window(specT, specJ, N0, N1, 0, 0, plain=plain)[:, 0, 0, 0]
        return Comg, Cgam, Cthe, Cphi, Cdel
    if backend not in ("fft", "fft32", "corr"):
        raise ValueError(f"unknown greek backend {backend!r}")
    if backend == "corr":
        # lag-zero blocks are plain inner products, in the input dtype
        Comg = corr_window_conv(SI, SI, 2 * w0, 2 * w1, plain=plain)
        Cgam = corr_window_conv(SI, ST, w0, w1, plain=plain)
        Cthe = corr_window_conv(SI, J[None], w0, w1, plain=plain)[:, 0]
        return Comg, Cgam, Cthe, dot_planes(ST, ST), dot_planes(ST, J[None])[:, 0]
    if J.dim() == 2:   # one pair: the batch of one
        return tuple(t[0] for t in greek_tables(SI[None], ST, J[None], w0, w1, backend=backend,
                                                chunk=chunk, plain=plain))
    B, Fij = SI.shape[:2]
    # lag-zero blocks are plain inner products, in the input dtype, pair by
    # pair (long contractions: a batched one changes a pair's bits)
    Cphi = dot_planes(ST, ST).expand((B,) + (ST.shape[0],) * 2)
    Cdel = torch.stack([dot_planes(ST, j[None])[:, 0] for j in J])
    if backend == "fft32":
        # f32 compute: the inputs cast to f32 go through the fft route (K1 in
        # c64 on the card), so the correlation tables come out f32 and the
        # assembly runs in f32; Cphi and Cdel are the f64 products cast
        SI, ST, J = (t.to(torch.float32) for t in (SI, ST, J))
        Cphi, Cdel = Cphi.to(torch.float32), Cdel.to(torch.float32)
    specs = rfft2_pairs(torch.cat([J[:, None], SI, ST.expand((B,) + tuple(ST.shape))], dim=1))
    specJ = specs[:, 0:1]
    specI = specs[:, 1:1 + Fij]
    specT = specs[:, 1 + Fij:]
    Comg = corr_window_fft(specI, specI, N0, N1, 2 * w0, 2 * w1,
                           chunk=chunk, symmetric=True, plain=plain)
    Cgam = corr_window_fft(specI, specT, N0, N1, w0, w1, chunk=chunk, plain=plain)
    Cthe = corr_window_fft(specI, specJ, N0, N1, w0, w1, chunk=chunk, plain=plain)[:, :, 0]
    return Comg, Cgam, Cthe, Cphi, Cdel
