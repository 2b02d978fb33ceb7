"""Lossy-but-bounded int16 upload of the fast survey path's input planes
(counterpart of sfft_tpu/utils/pack.py).

sfft_tpu quantizes the four input planes of a FAST-mode pair to int16 with
one float32 scale per 64-row block before they go to the device, halving
the bytes of the upload (its prefetch and mesh-batched survey paths). The
port does the same for the same configs, so that a fast-mode survey gives
the same difference through either package. Quantization error is <= 0.5 *
blockmax / 32767 per pixel, two orders below fast mode's own accuracy
floor; it must never be used on the contract path, whose 1e-6-grade parity
it would destroy.

NaN handling: NaNs (and any other non-finite pixel: an inf would otherwise
make its block's scale inf and silently zero the whole 64-row block) are
packed as -32768 (a value quantization never produces: quantized magnitudes
are <= 32767) and restored as NaN on unpack, so masked-image NaN semantics
survive the round trip exactly.

pack_i16 and pack_stack_i16 are numpy copies of sfft_tpu's (on the host);
unpack_i16 is torch on the tensors' device, with the same operations as
sfft_tpu's (an f32 multiply, the sentinel to NaN, then the cast), so it is
bit for bit the same; a stack of planes dequantizes in one pass (the
batched step's sub-batch). Two elementwise passes once per upload: no hand
kernel (sfft_tpu runs them as XLA ops, not as a Pallas kernel).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

_NAN_SENTINEL = -32768


class PackedI16(NamedTuple):
    """Host-side pack product. q is (nblocks*block, N1) int16 (row-padded),
    scales is (nblocks, 1) float32; n0 is the true row count."""

    q: np.ndarray
    scales: np.ndarray
    n0: int
    block: int


def pack_i16(a: np.ndarray, block: int = 64) -> PackedI16:
    """Quantize a 2-D float array to int16 with one f32 scale per `block`
    rows (host side, one vectorized pass). |err| <= 0.5 * scale, where
    scale = max|block| / 32767. Zero blocks get scale 1.0 (exact zeros)."""
    a = np.asarray(a)
    n0, n1 = a.shape
    nb = -(-n0 // block)
    npad = nb * block
    ap = np.zeros((npad, n1), np.float32)
    ap[:n0] = a
    blocks = ap.reshape(nb, block, n1)
    # non-finite (NaN OR +-inf) pixels all ride the sentinel: one inf pixel
    # would otherwise set its block scale to inf and quantize the whole
    # block to 0 (unpack then yields 0*inf = NaN everywhere in the block)
    nanmask = ~np.isfinite(blocks)
    absb = np.abs(np.where(nanmask, 0.0, blocks))
    bmax = absb.max(axis=(1, 2))
    scales = np.where(bmax > 0, bmax / np.float32(32767.0), 1.0).astype(
        np.float32)[:, None]
    q = np.rint(np.where(nanmask, 0.0, blocks)
                / scales[:, :, None]).astype(np.int16)
    if nanmask.any():
        q[nanmask] = _NAN_SENTINEL
    return PackedI16(q.reshape(npad, n1), scales, n0, block)


def unpack_i16(q, scales, n0: int, block: int, dtype=None):
    """Dequantize on the tensors' device: (nblocks*block, N1) int16 + per-
    block scales (nblocks, 1) f32 -> (n0, N1) float. dtype defaults to
    float64 (the engine's input dtype). NaN sentinels are restored. A stack
    (q (B, nblocks*block, N1), scales (B, nblocks, 1)) dequantizes in one
    pass to (B, n0, N1), each plane's bits those of its own call."""
    if dtype is None:
        dtype = torch.float64
    lead = tuple(q.shape[:-2])
    npad, n1 = q.shape[-2:]
    nb = npad // block
    qb = q.reshape(lead + (nb, block, n1))
    out = qb.to(torch.float32) * scales[..., :, :, None]
    out = torch.where(qb == _NAN_SENTINEL, torch.nan, out)
    return out.reshape(lead + (npad, n1))[..., :n0, :].to(dtype)


def pack_stack_i16(stack: np.ndarray, block: int = 64
                   ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Pack a (B, N0, N1) host stack: returns (q (B, npad, N1) int16,
    scales (B, nblocks, 1) f32, n0, block)."""
    packs = [pack_i16(stack[b], block) for b in range(stack.shape[0])]
    q = np.stack([p.q for p in packs])
    s = np.stack([p.scales for p in packs])
    return q, s, packs[0].n0, block
