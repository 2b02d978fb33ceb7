"""Survey-mode multi-task scheduler (counterpart of
sfft_tpu/parallel/scheduler.py, the MultiEasy* replacement).

Reference: MultiEasy_SparsePacket.MESP_Cupy / MultiEasy_CrowdedPacket
(sfft/MultiEasySparsePacket.py:391-948, sfft/MultiEasyCrowdedPacket.py):
a status dict {0 init, 32 prep-running, 1 prep-ok, -1 prep-fail,
64 sub-running, 2 ok, -2 fail}, N CPU preprocessing threads feeding one
subtraction thread per CUDA device, work-stealing under an RLock, per-task
timeouts, and per-device memory cleanup on failure.

The port keeps sfft_tpu's semantics and names:
  * preprocessing stays in a thread pool (numpy and the native extension on
    the host);
  * MultiTaskScheduler runs one subtract worker per device of
    parallel/batch.data_devices(), each under its device on a CUDA stream of
    its own; before a task's blocking subtraction the worker issues the
    upload of the next ready task's planes on a side stream;
  * run_mesh_batched streams same-config groups through
    parallel/batch.batched_subtract over the devices, with sfft_tpu's
    two-deep pipeline, padding, drain and per-task fall-back; a group is
    one task a device, as sfft_tpu's is, so each device runs the batched
    step of the fast or the default config on one pair, which is that
    config's single step (core/engine.solve_and_subtract_fn).

One compute thread per card: the kernel wrappers' launch counters and the
static-table caches are shared by every thread of the process.
"""

from __future__ import annotations

import contextlib
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sfft_tpu_torch.api.easy_crowded import EasyCrowdedPacket
from sfft_tpu_torch.api.easy_sparse import EasySparsePacket
from sfft_tpu_torch.parallel import batch
from sfft_tpu_torch.utils.multiproc import TimeoutAfter, TimeoutError_

# status codes (reference MultiEasySparsePacket.py:396-416)
STATUS_INIT = 0
STATUS_PREP_RUNNING = 32
STATUS_PREP_OK = 1
STATUS_PREP_FAIL = -1
STATUS_SUB_RUNNING = 64
STATUS_OK = 2
STATUS_FAIL = -2

_PLANES = ("PixA_I", "PixA_J", "PixA_mI", "PixA_mJ")
_worker = threading.local()


def worker_device() -> Optional[torch.device]:
    """The device of the subtract worker running the calling thread (None
    outside one): MultiEasy*'s subtract functions run there."""
    return getattr(_worker, "device", None)


@contextlib.contextmanager
def _on_device(device: torch.device):
    """Run the block as a worker of `device`: on a card, under that device
    and on a stream of its own."""
    _worker.device = device
    try:
        if device.type == "cuda":
            with torch.cuda.device(device), torch.cuda.stream(torch.cuda.Stream(device)):
                yield
        else:
            yield
    finally:
        _worker.device = None


def _clean_up(device: torch.device) -> None:
    """After a failed subtraction: let the work already queued on the device
    finish (a timeout does not stop it), then give the cached blocks back
    (the reference's per-device memory clean-up)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _start_warmup(devices: Sequence[torch.device]) -> Optional[threading.Thread]:
    """A daemon thread that creates the CUDA context of each card and loads
    the kernel library (building it on its first use), so that both overlap
    the prep pool (sfft_tpu's start_device_warmup). Nothing for CPU devices."""
    cards = [d for d in devices if d.type == "cuda"]
    if not cards:
        return None

    def warm():
        from sfft_tpu_torch import _kernels

        try:
            for d in cards:
                torch.zeros(1, device=d)
            _kernels.lib()
        except Exception:  # noqa: BLE001 - the first real call raises it again
            traceback.print_exc()

    t = threading.Thread(target=warm, name="sfft-device-warmup", daemon=True)
    t.start()
    return t


class MultiTaskScheduler:
    """Generic two-stage (preprocess -> subtract) task scheduler."""

    def __init__(
        self,
        num_tasks: int,
        prep_fn: Callable[[int], object],
        subtract_fn: Callable[[int, object], object],
        NUM_THREADS_4PREPROC: int = 4,
        NUM_THREADS_4SUBTRACT: int = 1,
        TIMEOUT_4PREPROC_EACHTASK: float = 300.0,
        TIMEOUT_4SUBTRACT_EACHTASK: float = 300.0,
        VERBOSE_LEVEL: int = 1,
        prefetch_fn: Optional[Callable[[object], object]] = None,
        devices=None,
    ):
        """The subtract workers are one per device: `devices`, or the first
        NUM_THREADS_4SUBTRACT CUDA cards (data_devices; raises at run()
        without a card). prefetch_fn(prep) -> prep issues the next ready
        task's uploads right before the current task's blocking subtraction,
        so that they ride under it."""
        self.num_tasks = num_tasks
        self.prep_fn = prep_fn
        self.subtract_fn = subtract_fn
        self.nprep = NUM_THREADS_4PREPROC
        self.nsub = NUM_THREADS_4SUBTRACT
        self.devices = devices
        self.t_prep = TIMEOUT_4PREPROC_EACHTASK
        self.t_sub = TIMEOUT_4SUBTRACT_EACHTASK
        self.verbose = VERBOSE_LEVEL
        self.prefetch_fn = prefetch_fn
        self.lock = threading.RLock()
        self.status: Dict[int, int] = {i: STATUS_INIT for i in range(num_tasks)}
        self.products: Dict[int, dict] = {i: {} for i in range(num_tasks)}

    # ------------------------------------------------------------------
    def _prep_worker(self):
        while True:
            with self.lock:
                todo = [i for i, s in self.status.items() if s == STATUS_INIT]
                if not todo:
                    return
                tid = todo[0]
                self.status[tid] = STATUS_PREP_RUNNING
            try:
                with TimeoutAfter(self.t_prep):
                    prep = self.prep_fn(tid)
                with self.lock:
                    self.products[tid]["prep"] = prep
                    self.status[tid] = STATUS_PREP_OK
            except (Exception, TimeoutError_):
                if self.verbose >= 1:
                    traceback.print_exc()
                with self.lock:
                    self.status[tid] = STATUS_PREP_FAIL

    def _sub_worker(self, device: torch.device):
        with _on_device(device):
            self._sub_loop(device)

    def _sub_loop(self, device: torch.device):
        while True:
            with self.lock:
                pending_prep = any(
                    s in (STATUS_INIT, STATUS_PREP_RUNNING)
                    for s in self.status.values()
                )
                ready = [i for i, s in self.status.items() if s == STATUS_PREP_OK]
                if not ready:
                    if not pending_prep:
                        return
                    tid = None
                else:
                    tid = ready[0]
                    self.status[tid] = STATUS_SUB_RUNNING
            if tid is None:
                time.sleep(0.01)  # reference: 10 ms nap while prep pending
                continue
            if self.prefetch_fn is not None:
                with self.lock:
                    nxt = next(
                        (i for i, s in self.status.items()
                         if s == STATUS_PREP_OK
                         and not self.products[i].get("prefetched")), None)
                    if nxt is not None:
                        self.products[nxt]["prefetched"] = True
                try:
                    if nxt is not None:
                        # upload issued on a side stream; overlaps the solve below
                        prefetched = self.prefetch_fn(self.products[nxt]["prep"])
                        with self.lock:
                            self.products[nxt]["prep"] = prefetched
                except Exception:
                    if self.verbose >= 1:
                        traceback.print_exc()
            try:
                with TimeoutAfter(self.t_sub):
                    result = self.subtract_fn(tid, self.products[tid]["prep"])
                with self.lock:
                    self.products[tid]["result"] = result
                    self.status[tid] = STATUS_OK
            except (Exception, TimeoutError_):
                if self.verbose >= 1:
                    traceback.print_exc()
                with self.lock:
                    self.status[tid] = STATUS_FAIL
                _clean_up(device)

    # ------------------------------------------------------------------
    def run(self) -> Tuple[Dict[int, int], Dict[int, dict]]:
        devices = batch.data_devices(self.nsub, self.devices)
        # the CUDA context and the kernel library's load overlap the prep pool
        _start_warmup(devices)
        threads = [threading.Thread(target=self._prep_worker)
                   for _ in range(self.nprep)]
        threads += [threading.Thread(target=self._sub_worker, args=(d,))
                    for d in devices]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        ok = sum(1 for s in self.status.values() if s == STATUS_OK)
        if self.verbose >= 1:
            print(f"MeLOn CheckPoint: MULTI-TASK SUCCESS [{ok} / "
                  f"{self.num_tasks}] in [{time.time()-t0:.1f} s]!")
        return self.status, self.products

    def run_prep_only(self) -> None:
        """Run only the preprocessing pool (statuses end at PREP_OK/PREP_FAIL)
        — for callers that dispatch the device stage themselves."""
        threads = [threading.Thread(target=self._prep_worker)
                   for _ in range(self.nprep)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()


def _check_pack_h2d(PACK_H2D: str) -> None:
    if PACK_H2D not in ("auto", "off"):
        raise ValueError(f"PACK_H2D must be 'auto' or 'off', got {PACK_H2D!r}")


def run_mesh_batched(
    num_tasks: int,
    prep_fn: Callable[[int], dict],
    subtract_fn: Callable,
    group_inputs: Callable[[dict], tuple],
    NUM_THREADS_4PREPROC: int = 4,
    TIMEOUT_4PREPROC_EACHTASK: float = 300.0,
    TIMEOUT_4SUBTRACT_EACHTASK: float = 300.0,
    VERBOSE_LEVEL: int = 1,
    devices=None,
    PACK_H2D: str = "auto",
    plain: bool = False,
) -> Tuple[Dict[int, int], Dict[int, dict]]:
    """Survey dispatch with STREAMING homogeneous-group batching over the
    devices (every visible card when None; without a card this raises).

    PACK_H2D: 'auto' ships the groups of FAST-mode configs (``_pack_eligible``)
    as int16 planes with f32 block scales, dequantized on the card
    (parallel/batch.upload_packed), as sfft_tpu does; 'off', and every
    contract or exact-solver config, ship the f64 planes.

    The prep thread pool and the dispatcher run CONCURRENTLY: as prep
    products arrive they are grouped by their static SFFTConfig (which pins
    shape + kernel HW + bases), and the moment a group reaches the number of
    devices it is dispatched through parallel/batch.batched_subtract — so
    preprocessing of later tasks overlaps device subtraction of earlier
    ones, preserving the reference scheduler's overlap property
    (sfft/MultiEasySparsePacket.py:930-940). When the prep pool drains,
    remaining partial groups are padded and flushed. Singleton groups and
    tasks needing contamination propagation take the per-task path.
    `group_inputs` maps a prep product to (cfg, I, J, mI, mJ, batchable:
    bool); per-task post-processing still runs through `subtract_fn(tid,
    prep, precomputed)`. plain=True runs the kernels' plain twins.
    """
    _check_pack_h2d(PACK_H2D)
    devices = batch.data_devices(devices=devices)
    _start_warmup(devices)  # overlap the context and library load with the prep pool
    sched = MultiTaskScheduler(
        num_tasks, prep_fn, lambda tid, prep: None,
        NUM_THREADS_4PREPROC=NUM_THREADS_4PREPROC,
        NUM_THREADS_4SUBTRACT=0,
        TIMEOUT_4PREPROC_EACHTASK=TIMEOUT_4PREPROC_EACHTASK,
        VERBOSE_LEVEL=VERBOSE_LEVEL,
    )
    t0 = time.time()
    status, products = sched.status, sched.products
    prep_threads = [threading.Thread(target=sched._prep_worker)
                    for _ in range(max(1, NUM_THREADS_4PREPROC))]
    for t in prep_threads:
        t.start()

    nd = len(devices)
    pending: Dict[object, List[int]] = {}   # cfg -> ready, undispatched tids
    solo: List[int] = []
    claimed: set = set()

    def _poll_ready() -> None:
        with sched.lock:
            ready = [i for i, s in status.items()
                     if s == STATUS_PREP_OK and i not in claimed]
        for tid in ready:
            claimed.add(tid)
            try:
                cfg, _I, _J, _mI, _mJ, batchable = \
                    group_inputs(products[tid]["prep"])
            except Exception:
                if VERBOSE_LEVEL >= 1:
                    traceback.print_exc()
                status[tid] = STATUS_FAIL
                continue
            if batchable:
                pending.setdefault(cfg, []).append(tid)
            else:
                solo.append(tid)

    def _finish(tid: int, precomputed, device: torch.device) -> None:
        status[tid] = STATUS_SUB_RUNNING
        try:
            with _on_device(device), TimeoutAfter(TIMEOUT_4SUBTRACT_EACHTASK):
                result = subtract_fn(tid, products[tid]["prep"],
                                     precomputed=precomputed)
            products[tid]["result"] = result
            status[tid] = STATUS_OK
        except (Exception, TimeoutError_):
            if VERBOSE_LEVEL >= 1:
                traceback.print_exc()
            status[tid] = STATUS_FAIL
            _clean_up(device)

    def _fall_back(tids: List[int]) -> None:
        # the per-task path, each task on the device its pair was given
        for k, tid in enumerate(tids):
            if status[tid] == STATUS_PREP_OK:
                _finish(tid, None, devices[k % nd])

    # two-deep group pipeline: group k+1's upload (stage) and dispatch
    # (launch) are issued BEFORE group k's results are fetched (collect), so
    # the next group's upload rides under the current group's device work.
    # Residency is bounded to two groups' inputs + outputs.
    inflight: List[tuple] = []   # [(cfg, tids, pad, launched_outputs)]

    def _dispatch(cfg, tids: List[int]) -> None:
        try:
            inputs = [group_inputs(products[t]["prep"]) for t in tids]
            stacks = [[x[1 + key] for x in inputs] for key in range(4)]
            # pad to a multiple of the device count by repeating the last pair
            pad = (-len(tids)) % nd
            if pad:
                stacks = [s + [s[-1]] * pad for s in stacks]
            if PACK_H2D == "auto" and _pack_eligible(cfg):
                staged = _stage_group_arrays(stacks, devices, packed=True)   # async H2D
            else:
                staged = _stage_group_arrays(stacks, devices)   # async H2D
            with TimeoutAfter(TIMEOUT_4SUBTRACT_EACHTASK * len(tids)):
                out = batch.batched_subtract(*staged, cfg, devices, plain=plain)
            inflight.append((cfg, tids, pad, out))
        except (Exception, TimeoutError_):
            if VERBOSE_LEVEL >= 1:
                traceback.print_exc()
                print("MeLOn WARNING: mesh-batched dispatch failed; "
                      "falling back to per-task path!")
            _fall_back(tids)

    def _collect_oldest() -> None:
        cfg, tids, pad, out = inflight.pop(0)
        try:
            with TimeoutAfter(TIMEOUT_4SUBTRACT_EACHTASK * len(tids)):
                sols = out[0].cpu()
                diffs = out[1].cpu()
            if VERBOSE_LEVEL >= 1:
                print(f"MeLOn CheckPoint: MESH-BATCHED [{len(tids)}] tasks "
                      f"(+{pad} pad) over [{nd}] devices for config "
                      f"{cfg.N0}x{cfg.N1} KerHW={cfg.w0}!")
            for k, tid in enumerate(tids):
                _finish(tid, (sols[k], diffs[k]), devices[k % nd])
        except (Exception, TimeoutError_):
            if VERBOSE_LEVEL >= 1:
                traceback.print_exc()
                print("MeLOn WARNING: mesh-batched collect failed; "
                      "falling back to per-task path!")
            _fall_back(tids)

    # streaming loop: dispatch full groups while preps are still running
    while True:
        _poll_ready()
        dispatched = False
        for cfg in list(pending):
            while len(pending[cfg]) >= nd:
                tids = pending[cfg][:nd]
                del pending[cfg][:nd]
                _dispatch(cfg, tids)
                dispatched = True
                while len(inflight) > 1:   # keep the pipeline two deep
                    _collect_oldest()
        if not any(t.is_alive() for t in prep_threads):
            break
        if not dispatched:
            time.sleep(0.01)  # reference: 10 ms nap while prep pending
    for t in prep_threads:
        t.join()

    # drain: flush remaining partial groups (padded) and singletons
    _poll_ready()
    for cfg, tids in pending.items():
        if len(tids) >= 2:
            _dispatch(cfg, tids)
        else:
            solo.extend(tids)
    while inflight:
        _collect_oldest()
    for tid in solo:
        _finish(tid, None, devices[0])

    ok = sum(1 for s in status.values() if s == STATUS_OK)
    if VERBOSE_LEVEL >= 1:
        print(f"MeLOn CheckPoint: MULTI-TASK SUCCESS [{ok} / "
              f"{num_tasks}] in [{time.time()-t0:.1f} s]!")
    return status, products


def _pack_eligible(cfg) -> bool:
    """int16 H2D packing is invisible only inside FAST-mode accuracy floors
    (quantization ~1.5e-5 of block max vs fast's ~7e-3; utils/pack.py).
    Contract/pexact/exact-solver configs must never be packed."""
    return (getattr(cfg, "fdiff_backend", None) == "fft32"
            and getattr(cfg, "greek_backend", None) in ("peeled", "fft32")
            and getattr(cfg, "solver", None) != "exact")


def _stage_group_arrays(stacks, devices, packed: bool = False):
    """Upload one group's four input stacks, pair k to devices[k %
    len(devices)]: non_blocking copies from pinned host memory on a side
    stream (parallel/batch.upload_planes, each plane in its own layout; with
    `packed`, batch.upload_packed: int16 planes dequantized on the card),
    which the caller's current stream waits for. Returns the four stacks as
    lists of device tensors. The copies overlap whatever the host does next
    (collecting the previous group's results)."""
    upload = batch.upload_packed if packed else batch.upload_planes
    staged = [[] for _ in stacks]
    for k in range(len(stacks[0])):
        planes, event = upload([s[k] for s in stacks], devices[k % len(devices)])
        batch.await_upload(planes, event)
        for out, t in zip(staged, planes):
            out.append(t)
    return staged


def _prefetch_pair_planes(prep: dict) -> dict:
    """Upload the four solve-input planes of an ESP/ECP prep product to the
    calling worker's device: non_blocking copies from pinned memory on a
    side stream, each plane with its strides (the same layout a single call
    gives it). FAST-mode configs (``_pack_eligible``) ship int16 planes with
    f32 block scales and dequantize on the device (batch.upload_packed), as
    sfft_tpu does, on the CPU too (the planes then arrive row-major);
    otherwise nothing is done on the CPU. Returns a copy of the product
    whose planes are device tensors (the engine takes them unchanged) and
    whose "h2d_event" the consumer waits for (``await_prefetch``). Used only
    on the per-task path."""
    if not isinstance(prep, dict):
        return prep
    device = worker_device()
    pack = _pack_eligible(prep.get("cfg"))
    if not pack and (device is None or device.type != "cuda"):
        return prep
    if device is None:
        device = torch.device("cpu")
    keys = [k for k in _PLANES if prep.get(k) is not None]
    if pack:   # sfft_tpu quantizes the host arrays only
        keys = [k for k in keys if isinstance(prep[k], np.ndarray)]
    upload = batch.upload_packed if pack else batch.upload_planes
    planes, event = upload([prep[k] for k in keys], device)
    out = dict(prep, h2d_event=event)
    out.update(zip(keys, planes))
    return out


def await_prefetch(prep) -> None:
    """Before a subtraction: the calling thread's streams wait for the
    prefetched planes of `prep`, if it has any."""
    if isinstance(prep, dict) and prep.get("h2d_event") is not None:
        batch.await_upload([prep[k] for k in _PLANES if isinstance(prep.get(k), torch.Tensor)],
                           prep["h2d_event"])


def _prep_group_inputs(prep: dict) -> tuple:
    """(cfg, I, J, mI, mJ, batchable) from an ESP_Prep/ECP_Prep product.
    Contamination-mask propagation needs an extra kernel pass per task
    (GeneralSFFT.GSS), so such tasks are not mesh-batchable."""
    return (
        prep["cfg"], prep["PixA_I"], prep["PixA_J"],
        prep["PixA_mI"], prep["PixA_mJ"], prep["ContamMask_I"] is None,
    )


class _MultiEasy:
    """The queues and the two dispatch modes shared by MultiEasySparsePacket
    and MultiEasyCrowdedPacket; `_stages()` gives the packet's prep and
    subtract stages. The keyword arguments are the packet's; `device` (the
    card when None; 'cpu' on the CPU) and `plain` reach the subtraction
    only."""

    def __init__(self, FITS_REF_Queue: Sequence[str],
                 FITS_SCI_Queue: Sequence[str],
                 FITS_DIFF_Queue: Optional[Sequence[Optional[str]]] = None,
                 FITS_Solution_Queue: Optional[Sequence[Optional[str]]] = None,
                 ForceConv_Queue: Optional[Sequence[str]] = None,
                 GKerHW_Queue: Optional[Sequence[Optional[int]]] = None,
                 **kwargs):
        n = len(FITS_REF_Queue)
        self.FITS_REF_Queue = list(FITS_REF_Queue)
        self.FITS_SCI_Queue = list(FITS_SCI_Queue)
        self.FITS_DIFF_Queue = list(FITS_DIFF_Queue or [None] * n)
        self.FITS_Solution_Queue = list(FITS_Solution_Queue or [None] * n)
        self.ForceConv_Queue = list(ForceConv_Queue or ["AUTO"] * n)
        self.GKerHW_Queue = list(GKerHW_Queue or [None] * n)
        self.kwargs = kwargs
        self.n = n

    def _run(self, NUM_THREADS_4PREPROC, NUM_THREADS_4SUBTRACT, TIMEOUT_4PREPROC_EACHTASK,
             TIMEOUT_4SUBTRACT_EACHTASK, MESH_BATCH, devices, PACK_H2D, VERBOSE_LEVEL):
        _check_pack_h2d(PACK_H2D)
        prep_stage, subtract_stage = self._stages()
        prep_kwargs = {k: v for k, v in self.kwargs.items() if k not in ("device", "plain")}
        device = self.kwargs.get("device")
        if devices is None and device is not None:
            devices = [device]

        def prep_fn(tid):
            return prep_stage(
                FITS_REF=self.FITS_REF_Queue[tid],
                FITS_SCI=self.FITS_SCI_Queue[tid],
                ForceConv=self.ForceConv_Queue[tid],
                GKerHW=self.GKerHW_Queue[tid],
                VERBOSE_LEVEL=0, **prep_kwargs,
            )

        def subtract_fn(tid, prep, precomputed=None):
            await_prefetch(prep)
            kwargs = dict(self.kwargs, device=worker_device() or device)
            return subtract_stage(
                prep,
                FITS_REF=self.FITS_REF_Queue[tid],
                FITS_SCI=self.FITS_SCI_Queue[tid],
                FITS_DIFF=self.FITS_DIFF_Queue[tid],
                FITS_Solution=self.FITS_Solution_Queue[tid],
                VERBOSE_LEVEL=0, precomputed=precomputed, **kwargs,
            )

        if MESH_BATCH:
            return run_mesh_batched(
                self.n, prep_fn, subtract_fn, _prep_group_inputs,
                NUM_THREADS_4PREPROC=NUM_THREADS_4PREPROC,
                TIMEOUT_4PREPROC_EACHTASK=TIMEOUT_4PREPROC_EACHTASK,
                TIMEOUT_4SUBTRACT_EACHTASK=TIMEOUT_4SUBTRACT_EACHTASK,
                VERBOSE_LEVEL=VERBOSE_LEVEL, devices=devices, PACK_H2D=PACK_H2D,
                plain=self.kwargs.get("plain", False),
            )
        sched = MultiTaskScheduler(
            self.n, prep_fn, subtract_fn,
            NUM_THREADS_4PREPROC=NUM_THREADS_4PREPROC,
            NUM_THREADS_4SUBTRACT=NUM_THREADS_4SUBTRACT,
            TIMEOUT_4PREPROC_EACHTASK=TIMEOUT_4PREPROC_EACHTASK,
            TIMEOUT_4SUBTRACT_EACHTASK=TIMEOUT_4SUBTRACT_EACHTASK,
            VERBOSE_LEVEL=VERBOSE_LEVEL,
            prefetch_fn=_prefetch_pair_planes,
            devices=devices,
        )
        return sched.run()


class MultiEasySparsePacket(_MultiEasy):
    """Reference MultiEasy_SparsePacket.MESP equivalent, over
    EasySparsePacket's ESP_Prep and ESP_Subtract."""

    def _stages(self):
        return EasySparsePacket.ESP_Prep, EasySparsePacket.ESP_Subtract

    def MESP(self, NUM_THREADS_4PREPROC: int = 4,
             NUM_THREADS_4SUBTRACT: int = 1,
             TIMEOUT_4PREPROC_EACHTASK: float = 300.0,
             TIMEOUT_4SUBTRACT_EACHTASK: float = 300.0,
             MESH_BATCH: bool = False, devices=None,
             PACK_H2D: str = "auto",
             VERBOSE_LEVEL: int = 1):
        """MESH_BATCH=False: pipelined two-stage dispatch — CPU preprocessing
        threads overlap the subtraction workers, one per device (`devices`,
        or the constructor's `device`, or the first NUM_THREADS_4SUBTRACT
        cards), reference semantics (sfft/MultiEasySparsePacket.py:930-940).
        MESH_BATCH=True: STREAMING batching — same-config groups go through
        batched_subtract over the devices (every card when None) the moment
        they fill, while later preps are still running (run_mesh_batched).
        PACK_H2D ('auto' or 'off'): under 'auto' the MESH_BATCH groups of
        FAST-mode configs go up as int16 planes (parallel/batch.
        upload_packed); the per-task path's prefetch packs FAST-mode planes
        whatever PACK_H2D says, as sfft_tpu's does. Returns (status,
        products)."""
        return self._run(NUM_THREADS_4PREPROC, NUM_THREADS_4SUBTRACT, TIMEOUT_4PREPROC_EACHTASK,
                         TIMEOUT_4SUBTRACT_EACHTASK, MESH_BATCH, devices, PACK_H2D,
                         VERBOSE_LEVEL)


class MultiEasyCrowdedPacket(_MultiEasy):
    """Reference MultiEasy_CrowdedPacket.MECP equivalent, over
    EasyCrowdedPacket's ECP_Prep and ECP_Subtract."""

    def _stages(self):
        return EasyCrowdedPacket.ECP_Prep, EasyCrowdedPacket.ECP_Subtract

    def MECP(self, NUM_THREADS_4PREPROC: int = 4,
             NUM_THREADS_4SUBTRACT: int = 1,
             TIMEOUT_4PREPROC_EACHTASK: float = 300.0,
             TIMEOUT_4SUBTRACT_EACHTASK: float = 300.0,
             MESH_BATCH: bool = False, devices=None,
             PACK_H2D: str = "auto",
             VERBOSE_LEVEL: int = 1):
        """See MultiEasySparsePacket.MESP."""
        return self._run(NUM_THREADS_4PREPROC, NUM_THREADS_4SUBTRACT, TIMEOUT_4PREPROC_EACHTASK,
                         TIMEOUT_4SUBTRACT_EACHTASK, MESH_BATCH, devices, PACK_H2D,
                         VERBOSE_LEVEL)
