"""Skinny f64 moment contraction M = W @ G: the K3 kernel and its plain twin.

Counterpart of sfft_tpu/core/pallas_moments.py (moments_pallas). The peeled
assembly (core/peel.py) needs image moments M[s, y] = sum_x W[s, x] G[x, y]
to full f64 accuracy. On CUDA tensors ``moments`` launches the hand-written
kernel of csrc/moments.cu, which computes them in native FP64; on CPU
tensors it uses ``moments_plain`` (W @ G in f64), which is also the
reference the kernel is held to on the card.
"""

from __future__ import annotations

from functools import lru_cache

import torch

_S_MAX = 16          # moment rows per kernel launch (larger S is chunked)
# The kernel's block (moments.cu): 2 warps along the columns by 4 along the
# rows, 4 rows of G in flight per thread. Of the block shapes and grids tried
# at (8, 4096, 4096) it was the fastest: 0.050 ms against 0.051-0.055 ms for
# 4 x 2, 1 x 8 and 2 x 8 warps, 8 rows in flight, or 1 or 4 blocks per SM
# (NVIDIA H100 80GB HBM3, 700 W).
_ROW_TILE = 4 * 4    # a split is a whole number of row groups of every warp row
_COLS = 32 * 2 * 2   # output columns per block with 16-byte loads (two per thread)
# blocks to aim for: one wave of two 256-thread blocks on each of the H100's
# 132 SMs, 64 KB of G in flight per SM
_TARGET_BLOCKS = 132 * 2

_tickets = {}        # (device index, stream) -> zeroed uint32 tickets, one per column block


def moments_plain(W: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch twin: W @ G in f64; a batch G (B, N0, N1) pair by
    pair, so that each pair's bits are those of its single call."""
    if G.dim() == 3:
        return torch.stack([W @ g for g in G])
    return W @ G


def _split_plan(N0: int, N1: int, cols: int = _COLS):
    """(nsplit, rows_per_split) of the contraction axis: about
    ``_TARGET_BLOCKS`` blocks of `cols` columns in all, each split a whole
    number of row groups, none empty. Split k covers rows
    [k * rows, min(N0, (k + 1) * rows))."""
    col_blocks = -(-N1 // cols)
    tiles = -(-N0 // _ROW_TILE)
    want = max(1, min(tiles, 65535, _TARGET_BLOCKS // col_blocks))
    rows = -(-tiles // want) * _ROW_TILE
    return -(-N0 // rows), rows


@lru_cache(maxsize=256)
def _launch_plan(N0: int, N1: int, aligned: bool = True):
    """The launch of one (S <= 16, N0) x (N0, N1) product: vec (columns per
    thread: 2 with 16-byte loads when N1 is even and the pointers are
    16-byte aligned, else 1), cols (columns per block), col_blocks, nsplit
    and rows (``_split_plan``). Block (i, k) computes columns
    [i * cols, min(N1, (i + 1) * cols)) over rows
    [k * rows, min(N0, (k + 1) * rows))."""
    vec = 2 if (aligned and N1 % 2 == 0) else 1
    cols = _COLS // 2 * vec
    nsplit, rows = _split_plan(N0, N1, cols)
    return dict(vec=vec, cols=cols, col_blocks=-(-N1 // cols), nsplit=nsplit, rows=rows)


def _ticket(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """n zeroed tickets for launches on `stream`: the kernel leaves them
    zeroed, and launches on one stream run in order, so one buffer per
    stream serves every launch."""
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return t


def _launch(W: torch.Tensor, G: torch.Tensor, out: torch.Tensor) -> None:
    """One kernel launch for the batch G (B, N0, N1), its results into out
    (B, S, N1), a view whose pairs may lie further apart than S * N1 (a
    chunk of a larger S). The host side is kept short (the plan cached): at
    the peeled path's shape the kernel takes 0.050 ms a pair (NVIDIA H100
    80GB HBM3, 700 W)."""
    from sfft_tpu_torch import _kernels

    S, N0 = W.shape
    B, N1 = G.shape[0], G.shape[2]
    plan = _launch_plan(N0, N1, aligned=G.data_ptr() % 16 == 0 and G.stride(0) % 2 == 0
                        and out.stride(0) % 2 == 0)
    nsplit = plan["nsplit"]
    # the splits' partial sums, pair by pair
    part = torch.empty((B * nsplit * S * N1 if nsplit > 1 else 1,), dtype=torch.float64,
                       device=G.device)
    with torch.cuda.device(G.device):
        stream = _kernels.stream_ptr(G)
        err = _kernels.lib().sfft_moments_f64(
            W.data_ptr(), G.data_ptr(), part.data_ptr(), out.data_ptr(),
            _ticket(G.device, stream, B * plan["col_blocks"]).data_ptr(),
            S, N0, N1, nsplit, plan["rows"], plan["vec"], B, G.stride(0), out.stride(0), stream)
    moments.launches += 1
    _kernels.check(err, "moments kernel launch")


def moments(W: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """M = W @ G, W (S, N0) f64, G (N0, N1) f64, both contiguous, on one
    device. Returns (S, N1) f64. A batch G (B, N0, N1) gives (B, S, N1):
    M_b = W @ G_b, each pair's bits those of its single call. CUDA tensors
    go through the K3 kernel (one launch for the batch per 16 rows of W);
    CPU tensors through ``moments_plain``."""
    if W.dtype != torch.float64 or G.dtype != torch.float64:
        raise TypeError(f"moments needs float64 operands, got {W.dtype} and {G.dtype}")
    if W.dim() != 2 or G.dim() not in (2, 3) or W.shape[1] != G.shape[-2]:
        raise ValueError(f"moments needs W (S, N0) and G ([B,] N0, N1), got "
                         f"{tuple(W.shape)} and {tuple(G.shape)}")
    if not (W.is_contiguous() and G.is_contiguous()):
        raise ValueError("moments needs contiguous operands")
    if W.device != G.device:
        raise ValueError(f"moments operands on {W.device} and {G.device}")
    if W.device.type not in ("cpu", "cuda"):
        raise ValueError(f"moments runs on cpu or cuda tensors, not {W.device}")
    S, N0 = W.shape
    N1 = G.shape[-1]
    B = G.shape[0] if G.dim() == 3 else 1
    if W.device.type == "cuda" and (max(S * N1, N0, N1) >= 2 ** 31 or B > 65535):
        raise ValueError("moments kernel takes int32 extents and at most 65535 pairs")
    if S == 0 or N0 == 0 or N1 == 0 or B == 0:
        return torch.zeros(tuple(G.shape[:-2]) + (S, N1), dtype=torch.float64, device=W.device)
    if W.device.type == "cpu":
        if S <= _S_MAX:
            return moments_plain(W, G)
        return torch.cat([moments_plain(W[i:i + _S_MAX], G) for i in range(0, S, _S_MAX)],
                         dim=-2)
    G3 = G if G.dim() == 3 else G[None]
    out = torch.empty((B, S, N1), dtype=torch.float64, device=G.device)
    for i in range(0, S, _S_MAX):
        _launch(W[i:i + _S_MAX], G3, out[:, i:i + _S_MAX])
    return out if G.dim() == 3 else out[0]


moments.launches = 0
