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

sfft_tpu's int16 upload (batched_subtract_packed) is not ported: on the
H100 the four f64 planes of a DECam pair (268 MB) go up from pinned memory
in a small fraction of the subtraction's device time (PERF.md §5), so the
upload does not bound the step and the quantization would buy nothing.
"""

from __future__ import annotations

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
