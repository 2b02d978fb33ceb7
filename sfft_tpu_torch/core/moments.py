"""Skinny f64 moment contraction M = W @ G: the K3 kernel and its plain twin.

Counterpart of sfft_tpu/core/pallas_moments.py (moments_pallas). The peeled
assembly (core/peel.py) needs image moments M[s, y] = sum_x W[s, x] G[x, y]
to full f64 accuracy. On CUDA tensors ``moments`` launches the hand-written
kernel of csrc/moments.cu, which computes them in native FP64; on CPU
tensors it uses ``moments_plain`` (W @ G in f64), which is also the
reference the kernel is held to on the card.
"""

from __future__ import annotations

import torch

_S_MAX = 16          # moment rows per kernel launch (larger S is chunked)
_ROW_TILE = 64       # contraction rows per shared-memory tile (moments.cu kRows)
_COLS = 128          # output columns per block (moments.cu kCols)
# blocks to aim for: ~4 on each of the H100's 132 SMs (a sweep of 2..64 per
# SM at (8, 4096, 4096) measured this best on an H100 SXM at 700 W)
_TARGET_BLOCKS = 132 * 4


def moments_plain(W: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch twin: W @ G in f64."""
    return W @ G


def _split_plan(N0: int, N1: int):
    """(nsplit, rows_per_split) of the contraction axis: enough blocks in
    flight for the memory system, each split a whole number of row tiles."""
    col_blocks = -(-N1 // _COLS)
    tiles = -(-N0 // _ROW_TILE)
    want = max(1, min(tiles, -(-_TARGET_BLOCKS // col_blocks)))
    rows = -(-tiles // want) * _ROW_TILE
    return -(-N0 // rows), rows


def _launch(W: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    from sfft_tpu_torch import _kernels

    S, N0 = W.shape
    N1 = G.shape[1]
    nsplit, rows = _split_plan(N0, N1)
    part = torch.empty((nsplit, S, N1), dtype=torch.float64, device=G.device)
    out = torch.empty((S, N1), dtype=torch.float64, device=G.device)
    with torch.cuda.device(G.device):
        err = _kernels.lib().sfft_moments_f64(
            W.data_ptr(), G.data_ptr(), part.data_ptr(), out.data_ptr(),
            S, N0, N1, nsplit, rows, _kernels.stream_ptr(G))
    moments.launches += 1
    _kernels.check(err, "moments kernel launch")
    return out


def moments(W: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """M = W @ G, W (S, N0) f64, G (N0, N1) f64, both contiguous, on one
    device. Returns (S, N1) f64. CUDA tensors go through the K3 kernel (one
    launch per 16 rows of W); CPU tensors through ``moments_plain``."""
    if W.dtype != torch.float64 or G.dtype != torch.float64:
        raise TypeError(f"moments needs float64 operands, got {W.dtype} and {G.dtype}")
    if W.dim() != 2 or G.dim() != 2 or W.shape[1] != G.shape[0]:
        raise ValueError(f"moments needs W (S, N0) and G (N0, N1), got "
                         f"{tuple(W.shape)} and {tuple(G.shape)}")
    if not (W.is_contiguous() and G.is_contiguous()):
        raise ValueError("moments needs contiguous operands")
    if W.device != G.device:
        raise ValueError(f"moments operands on {W.device} and {G.device}")
    if W.device.type not in ("cpu", "cuda"):
        raise ValueError(f"moments runs on cpu or cuda tensors, not {W.device}")
    S, N0 = W.shape
    N1 = G.shape[1]
    if W.device.type == "cuda" and max(S * N1, N0, N1) >= 2 ** 31:
        raise ValueError("moments kernel takes int32 extents")
    if S == 0 or N0 == 0 or N1 == 0:
        return torch.zeros((S, N1), dtype=torch.float64, device=W.device)
    fn = _launch if W.device.type == "cuda" else moments_plain
    if S <= _S_MAX:
        return fn(W, G)
    return torch.cat([fn(W[i:i + _S_MAX], G) for i in range(0, S, _S_MAX)], dim=0)


moments.launches = 0
