"""Survey-mode batching: many image pairs over the data devices
(counterpart of sfft_tpu/parallel/batch.py).

sfft_tpu stacks same-config pairs on a leading axis and runs jax.vmap of the
fused solve+subtract, sharded over a 1-D device mesh. Here pair k goes to
devices[k % len(devices)], and each device runs its pairs as batched
steps (core/engine.solve_and_subtract_batched_fn: one set of the config's
kernel launches and one pass of the table algebra for the step's pairs,
each pair's bits those of its single call) where the config has one
(core/engine.batched_step_supported: the fast mode's backends peeled /
fft32 and the contract's pexact / pexact with polynomial bases; the
default fft / fft, the v2 fast fft32 / fft32 and the exact exact / exact
backends with any bases, the v2 NIRCam configuration's among them; any
solver): one step for the device's pairs where its memory holds them,
else steps of ``max_batch`` pairs. The survey paths
(parallel/scheduler.run_mesh_batched, parallel/multihost.process_local_batch)
pass one pair a device, as sfft_tpu's do, and the batched step of one pair
is the single step. Every other config (corr / conv, the piecewise peel,
pexact with B-spline bases) runs its
pairs one after another through the step of a single call
(core/engine.solve_and_subtract_fn). Either way the
upload of the next step's pairs (or the next pair) is issued on a
side stream before the current step, so it overlaps that step; the step
waits for its own upload through an event.

Every plane keeps its strides on the way to the device: the unmasked pair
of the automatic packets arrives transposed and the masked pair row-major,
and the K4 slicer and K6p take different routes on the two layouts, so a
copy that made a plane contiguous could change the bits of the result. The
batched step stacks a role's planes on the device in their layout where
they share one (row- or column-major), row-major otherwise: the default
trio gives the same bits on any layout, the peel's moment products read
the masked planes in their layout, so a fast config whose masked planes
mix layouts takes the per-pair loop; the contract trio's moment sets and
the exact trio's spectra read the masked planes, and their difference the
unmasked ones where they are other planes, so they take the loop where any
role mixes layouts.

batched_subtract_packed is sfft_tpu's int16 upload of the fast survey
path (utils/pack.py): the planes are quantized on the host, go up as int16
with f32 block scales (half the bytes of f32) and are dequantized on the
card, a device's sub-batch in one pass, so that a fast-mode survey gives
the same difference as sfft_tpu's; the planes then arrive row-major.
"""

from __future__ import annotations

import contextlib
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sfft_tpu_torch.config import SFFTConfig
from sfft_tpu_torch.core.engine import (batched_step_supported, solve_and_subtract_batched_fn,
                                        solve_and_subtract_fn)


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
    lists = {}
    out, event = upload_packed_stacks([lists.setdefault(id(p), [p]) for p in planes], device,
                                      block)
    views = {}
    return [views.setdefault(id(t), t[0]) for t in out], event


def upload_packed_stacks(stacks: Sequence[Sequence], device, block: int = 64
                         ) -> Tuple[list, Optional[torch.cuda.Event]]:
    """``upload_packed`` for stacks of same-shape planes: each stack's planes
    are quantized on the host (utils/pack.pack_i16, plane by plane), go up
    as one int16 array and one array of scales, and are dequantized to f64
    on `device` in one pass (utils/pack.unpack_i16 over the stack's leading
    axis, bit for bit the planes one by one). Returns ((B, N0, N1) tensors,
    event). The same stack object twice gives the same tensor twice."""
    from sfft_tpu_torch.utils.pack import pack_i16, unpack_i16

    device = torch.device(device)
    packs, seen, order = [], {}, []
    for st in stacks:
        if id(st) not in seen:
            seen[id(st)] = len(packs)
            pk = [pack_i16(np.ascontiguousarray(
                p.detach().cpu().numpy() if isinstance(p, torch.Tensor) else p, np.float32), block)
                for p in st]
            packs.append((np.stack([x.q for x in pk]), np.stack([x.scales for x in pk]),
                          pk[0].n0))
        order.append(seen[id(st)])
    host = [a for q, sc, _ in packs for a in (q, sc)]
    up, event = upload_planes(host, device)
    side = None if event is None else torch.cuda.Stream(device)
    with contextlib.ExitStack() as stack:
        if side is not None:
            side.wait_event(event)
            stack.enter_context(torch.cuda.stream(side))
        out = [unpack_i16(up[2 * k], up[2 * k + 1], n0, block)
               for k, (_, _, n0) in enumerate(packs)]
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
    with one f32 scale per `block` rows on the host, uploaded (pinned, on a
    side stream: ``upload_packed_stacks``, a device's sub-batch of each
    plane kind as one array), dequantized on the card in one pass and then
    solved and subtracted as ``batched_subtract`` does, pair k on
    devices[k % len(devices)]. The quantization error (<= 0.5 blockmax /
    32767 a pixel) sits far below fast mode's accuracy floor; never use it
    with contract configs. Returns what ``batched_subtract`` returns."""
    devices = data_devices(devices=devices)
    nd = len(devices)
    B = len(I_stack)
    stacks = (I_stack, J_stack, mI_stack, mJ_stack)
    staged = [[None] * B for _ in stacks]
    for d in range(min(nd, B)):
        ks = range(d, B, nd)
        subs, ids = [], {}
        for s in stacks:   # a stack passed twice is one sub-batch
            subs.append(ids.setdefault(id(s), [s[k] for k in ks]))
        planes, event = upload_packed_stacks(subs, devices[d], block)
        await_upload(planes, event)
        for out, t in zip(staged, planes):
            for i, k in enumerate(ks):
                out[k] = t[i]
    return batched_subtract(*staged, cfg, devices, plain=plain)


# the device memory of a batched step, in bytes per image pixel: (the
# step's own share, each pair's share), keyed by the greek backend. From
# the peaks of chip_smoke.py's phase 14 on the card at 4096^2 (one pair's
# step 5.44 GiB fast, 8.57 GiB default and 10.83 GiB contract, with 2 GiB
# of the phase's own planes; each further pair 2.15, 4.02 and 8.63 GiB:
# 137, 257 and 552 bytes a pixel; the exact trio 9.48 GiB, 607 bytes a
# pixel) and on the NIRCam configuration at 900^2 (the v2 fast trio 2.93
# GiB a further pair), less the systems' share below, rounded up, with a
# pair's four f64 planes (32 bytes a pixel) added for the next step's
# upload
_STEP_BYTES = {"peeled": (320, 192), "fft": (448, 320), "fft32": (448, 464),
               "pexact": (64, 592), "exact": (64, 640)}
# and in bytes per entry of the (NEQ, NEQ) system: each pair's, in f64
# tables (half that in the fft32 mode's f32 tables: the system holds about
# four copies while the assembly builds, stacks and concatenates it; with
# the 4096^2 peaks, fitted to the NIRCam configuration's 5.55 GiB (default
# trio) and 5.64 GiB (exact trio) a further pair at NEQ 13226), and the
# solve's own transient, once a step as the pairs solve one by one (the f64
# copy of the tweaked system, K5's twelve int8 slices of it, its f32 hi
# part and the f32 factor)
_SYSTEM_BYTES = 34
_SOLVE_BYTES = 32


def max_batch(cfg: SFFTConfig, device) -> int:
    """The most pairs of `cfg` one batched step on `device` takes: as many
    as its free memory holds by ``_STEP_BYTES`` and the systems' NEQ^2
    terms (``_SYSTEM_BYTES``, ``_SOLVE_BYTES``; on a card the driver's free
    memory and what PyTorch's allocator holds unused; on the CPU the
    available physical memory), at least one."""
    device = torch.device(device)
    if device.type == "cuda":
        free = torch.cuda.mem_get_info(device)[0] + (torch.cuda.memory_reserved(device)
                                                     - torch.cuda.memory_allocated(device))
    else:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    fixed, pair = (b * cfg.N0 * cfg.N1 for b in _STEP_BYTES[cfg.greek_backend])
    system = cfg.NEQ ** 2
    fixed += _SOLVE_BYTES * system
    pair += _SYSTEM_BYTES * system // (2 if cfg.greek_backend == "fft32" else 1)
    return max(1, int((0.9 * free - fixed) // pair))


def _layout(p) -> str:
    """'C' (row-major), 'F' (column-major) or '' (neither) of a plane."""
    if isinstance(p, torch.Tensor):
        return "C" if p.is_contiguous() else "F" if p.T.is_contiguous() else ""
    a = np.asarray(p)
    return "C" if a.flags.c_contiguous else "F" if a.flags.f_contiguous else ""


def _batchable(cfg: SFFTConfig, stacks) -> bool:
    """Whether a batch (the stacks I, J, mI, mJ) runs as batched steps: a
    ``batched_step_supported`` config, and for the backends whose kernels
    read planes in their layout, planes of one layout a role: the masked
    ones for the peel, all four for the contract and exact backends (their
    spectra read the masked planes, their difference the unmasked ones
    where they are other planes)."""
    if not batched_step_supported(cfg):
        return False
    roles = {"peeled": stacks[2:], "pexact": stacks, "exact": stacks}.get(cfg.greek_backend, ())
    return all(len({_layout(p) for p in s}) == 1 and _layout(s[0]) for s in roles)


def _device_stack(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """One (B, N0, N1) tensor of a sub-batch's planes on their device, in
    the planes' layout where they share one (a transposed stack of
    column-major planes): a stack's own planes (views of one contiguous
    tensor) pass as that tensor, other planes are copied into one."""
    if all(_layout(p) == "F" for p in planes):
        return torch.stack([p.T for p in planes]).transpose(1, 2)
    first = planes[0]
    n, size = first.numel(), first.element_size()
    store = first.untyped_storage()
    if (first.dim() == 2 and (first.storage_offset() + len(planes) * n) * size <= store.nbytes()
            and all(p.is_contiguous() and p.shape == first.shape
                    and p.untyped_storage().data_ptr() == store.data_ptr()
                    and p.data_ptr() == first.data_ptr() + k * n * size
                    for k, p in enumerate(planes))):
        return first.as_strided((len(planes),) + tuple(first.shape), (n,) + tuple(first.stride()))
    return torch.stack(list(planes))


def batched_subtract(I_stack, J_stack, mI_stack, mJ_stack, cfg: SFFTConfig,
                     devices=None, plain: bool = False):
    """Solve+subtract a batch of pairs: pair k solves on (mI_stack[k],
    mJ_stack[k]) and subtracts (I_stack[k], J_stack[k]) on devices[k %
    len(devices)] (every visible card when None; without a card this
    raises). A stack is a (B, N0, N1) array or tensor, or a sequence of B
    planes (each kept in its own layout). A ``batched_step_supported``
    config runs each device's pairs as batched steps (``_batchable``) of
    at most ``max_batch`` pairs (one step where they fit); the others run
    their pairs one by one. Returns stacked (solutions, differences,
    per-pair RMS of the difference in f32) on devices[0], each pair's bits
    those of its single call. plain=True runs the kernels' plain twins."""
    devices = data_devices(devices=devices)
    stacks = (I_stack, J_stack, mI_stack, mJ_stack)
    B = len(I_stack)
    sols, diffs, rms = [None] * B, [None] * B, [None] * B

    def keep(k, sol, diff):
        sols[k] = sol.to(devices[0])
        diffs[k] = diff.to(devices[0])
        rms[k] = torch.sqrt(torch.mean(diff.to(torch.float32) ** 2)).to(devices[0])

    if not _batchable(cfg, stacks):
        step = solve_and_subtract_fn(cfg)

        def upload(k):
            return upload_planes([s[k] for s in stacks], devices[k % len(devices)])

        nxt = upload(0)
        for k in range(B):
            planes, event = nxt
            if k + 1 < B:
                nxt = upload(k + 1)  # issued before pair k's step: overlaps it
            await_upload(planes, event)
            keep(k, *step(*planes, plain=plain))
        return torch.stack(sols), torch.stack(diffs), torch.stack(rms)

    step = solve_and_subtract_batched_fn(cfg)
    nd = len(devices)
    own = [list(range(d, B, nd)) for d in range(min(nd, B))]
    cap = [max_batch(cfg, devices[d]) for d in range(len(own))]
    # each device's pairs in batched steps of at most cap[d] pairs, the
    # devices taking turns
    units = [(d, ks[c * cap[d]:(c + 1) * cap[d]])
             for c in range(max(-(-len(ks) // cap[d]) for d, ks in enumerate(own)))
             for d, ks in enumerate(own) if ks[c * cap[d]:]]

    def upload_unit(u):
        # the unit's planes; a stack passed in two roles (mI is I) once
        d, ks = units[u]
        seen = {}
        return upload_planes([seen.setdefault((id(s), k), s[k]) for s in stacks for k in ks],
                             devices[d])

    nxt = upload_unit(0)
    for u, (d, ks) in enumerate(units):
        planes, event = nxt
        if u + 1 < len(units):
            nxt = upload_unit(u + 1)  # issued before this step: overlaps it
        await_upload(planes, event)
        n = len(ks)
        made = {}   # a role whose planes are another's (mI is I): one stack

        def stacked(ps):
            key = tuple(id(p) for p in ps)
            if key not in made:
                made[key] = _device_stack(ps)
            return made[key]

        sol, diff = step(*(stacked(planes[r * n:(r + 1) * n]) for r in range(4)), plain=plain)
        for i, k in enumerate(ks):
            keep(k, sol[i], diff[i])
    return torch.stack(sols), torch.stack(diffs), torch.stack(rms)
