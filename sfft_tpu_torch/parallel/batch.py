"""Survey-mode batching: many image pairs over the data devices
(counterpart of sfft_tpu/parallel/batch.py).

sfft_tpu stacks same-config pairs on a leading axis and runs jax.vmap of the
fused solve+subtract, sharded over a 1-D device mesh. The port's kernels
take one pair per launch and PyTorch runs eagerly, so here a batch is its
pairs run one after another through the step of a single call
(core/engine.solve_and_subtract_fn), pair k on devices[k % len(devices)].
The upload of pair k+1 is issued on a side stream before pair k's step, so
it overlaps that step; the step waits for its own upload through an event.
A leading pair axis through every kernel is open work (ROADMAP).

Every plane keeps its strides on the way to the device: the unmasked pair
of the automatic packets arrives transposed and the masked pair row-major,
and the K4 slicer and K6p take different routes on the two layouts, so a
copy that made a plane contiguous could change the bits of the result.

batched_subtract_packed is sfft_tpu's int16 upload of the fast survey
path (utils/pack.py): the planes are quantized on the host, go up as int16
with f32 block scales (half the bytes of f32) and are dequantized on the
card, so that a fast-mode survey gives the same difference as sfft_tpu's;
the planes then arrive row-major.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sfft_tpu_torch.config import SFFTConfig
from sfft_tpu_torch.core.engine import solve_and_subtract_fn


def data_devices(n_devices: Optional[int] = None, devices=None) -> List[torch.device]:
    """The devices a batch spreads over (sfft_tpu's make_data_mesh): every
    visible CUDA card, or the first `n_devices` of them. Without a card this
    raises: there is no CPU fallback. `devices` names them instead; CPU
    entries are allowed only there (the CPU tests name them)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "sfft_tpu_torch batches run on the CUDA cards, and no CUDA device is "
            "available; name the devices (devices=['cpu']) to run on the CPU")
    found = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return found if n_devices is None else found[:n_devices]


def upload_planes(planes: Sequence, device) -> Tuple[list, Optional[torch.cuda.Event]]:
    """The planes as tensors on `device`, with their strides; returns
    (tensors, event). Tensors already there pass through. Host planes
    (numpy arrays or CPU tensors) going to a card are pinned and copied with
    non_blocking on a side stream, after which `event` is recorded: a
    consumer waits for it through ``await_upload``. The same object twice
    gives the same tensor twice (the engine shares work between a masked
    and an unmasked plane that are one object)."""
    device = torch.device(device)
    out, seen, side = [], {}, None
    for p in planes:
        if id(p) in seen:
            out.append(seen[id(p)])
            continue
        t = p
        if not isinstance(t, torch.Tensor):
            a = np.asarray(t)
            if not a.flags.writeable:  # as core/engine._as_tensor does
                a = a.copy()
            t = torch.as_tensor(a)
        if t.device != device:
            if device.type == "cuda" and t.device.type == "cpu":
                if side is None:
                    side = torch.cuda.Stream(device)
                with torch.cuda.stream(side):
                    t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
        seen[id(p)] = t
        out.append(t)
    if side is None:
        return out, None
    event = torch.cuda.Event()
    event.record(side)
    return out, event


def await_upload(tensors: Sequence[torch.Tensor], event: Optional[torch.cuda.Event]) -> None:
    """Make the calling thread's current stream on each tensor's device wait
    for `event` (an ``upload_planes`` copy), and record the tensor on that
    stream, so that the caching allocator does not hand its memory out again
    before the consumer's work on it has run."""
    if event is None:
        return
    for t in tensors:
        if t.device.type == "cuda":
            stream = torch.cuda.current_stream(t.device)
            stream.wait_event(event)
            t.record_stream(stream)


def upload_packed(planes: Sequence, device, block: int = 64
                  ) -> Tuple[list, Optional[torch.cuda.Event]]:
    """The planes quantized on the host (utils/pack.pack_i16 of their f32
    values, as sfft_tpu's survey paths quantize), uploaded as int16 with
    their f32 block scales and dequantized to f64 on `device`: returns
    (tensors, event) as ``upload_planes`` does. On a card the copies (from
    pinned memory) and the dequantization run on one side stream, after
    which `event` is recorded; on the CPU the planes dequantize in place
    and the event is None. The same object twice gives the same tensor
    twice."""
    from sfft_tpu_torch.utils.pack import pack_i16, unpack_i16

    device = torch.device(device)
    packs, seen, order = [], {}, []
    for p in planes:
        if id(p) not in seen:
            a = p.detach().cpu().numpy() if isinstance(p, torch.Tensor) else p
            seen[id(p)] = len(packs)
            packs.append(pack_i16(np.ascontiguousarray(a, np.float32), block))
        order.append(seen[id(p)])
    host = [t for pk in packs for t in (pk.q, pk.scales)]
    up, event = upload_planes(host, device)
    side = None if event is None else torch.cuda.Stream(device)
    with contextlib.ExitStack() as stack:
        if side is not None:
            side.wait_event(event)
            stack.enter_context(torch.cuda.stream(side))
        out = [unpack_i16(up[2 * k], up[2 * k + 1], pk.n0, pk.block)
               for k, pk in enumerate(packs)]
    if side is None:
        return [out[k] for k in order], None
    for t in up:
        t.record_stream(side)
    done = torch.cuda.Event()
    done.record(side)
    return [out[k] for k in order], done


def batched_subtract_packed(I_stack, J_stack, mI_stack, mJ_stack, cfg: SFFTConfig,
                            devices=None, block: int = 64, plain: bool = False):
    """FAST-mode variant of ``batched_subtract`` (sfft_tpu's
    batched_subtract_packed): each pair's four planes are quantized to int16
    with one f32 scale per `block` rows on the host, uploaded
    (``upload_packed``: pinned, on a side stream), dequantized on the card
    and then solved and subtracted as ``batched_subtract`` does, pair k on
    devices[k % len(devices)]. The quantization error (<= 0.5 blockmax /
    32767 a pixel) sits far below fast mode's accuracy floor; never use it
    with contract configs. Returns what ``batched_subtract`` returns."""
    devices = data_devices(devices=devices)
    stacks = (I_stack, J_stack, mI_stack, mJ_stack)
    staged = [[] for _ in stacks]
    for k in range(len(I_stack)):
        planes, event = upload_packed([s[k] for s in stacks], devices[k % len(devices)], block)
        await_upload(planes, event)
        for out, t in zip(staged, planes):
            out.append(t)
    return batched_subtract(*staged, cfg, devices, plain=plain)


def batched_subtract(I_stack, J_stack, mI_stack, mJ_stack, cfg: SFFTConfig,
                     devices=None, plain: bool = False):
    """Solve+subtract a batch of pairs: pair k solves on (mI_stack[k],
    mJ_stack[k]) and subtracts (I_stack[k], J_stack[k]) on devices[k %
    len(devices)] (every visible card when None; without a card this
    raises). A stack is a (B, N0, N1) array or tensor, or a sequence of B
    planes (each kept in its own layout). Returns stacked (solutions,
    differences, per-pair RMS of the difference in f32) on devices[0].
    plain=True runs the kernels' plain twins."""
    devices = data_devices(devices=devices)
    step = solve_and_subtract_fn(cfg)
    stacks = (I_stack, J_stack, mI_stack, mJ_stack)
    B = len(I_stack)

    def upload(k):
        return upload_planes([s[k] for s in stacks], devices[k % len(devices)])

    sols, diffs, rms = [], [], []
    nxt = upload(0)
    for k in range(B):
        planes, event = nxt
        if k + 1 < B:
            nxt = upload(k + 1)  # issued before pair k's step: overlaps it
        await_upload(planes, event)
        I, J, mI, mJ = planes
        sol, diff = step(I, J, mI, mJ, plain=plain)
        sols.append(sol.to(devices[0]))
        diffs.append(diff.to(devices[0]))
        rms.append(torch.sqrt(torch.mean(diff.to(torch.float32) ** 2)).to(devices[0]))
    return torch.stack(sols), torch.stack(diffs), torch.stack(rms)
