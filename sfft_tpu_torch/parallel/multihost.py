"""Multi-host survey mode: one process per host, each on its own cards
(counterpart of sfft_tpu/parallel/multihost.py).

sfft_tpu wires its processes into one JAX runtime and shards a global
batch over every device. The port's processes join through
``torch.distributed`` over gloo instead, and gloo carries only host-side
summaries: every pair lives wholly on one card of the process that loaded
it, so no image crosses hosts. Each batch ends in one collective, an
all_gather of the batch's per-pair difference RMS (the QA summaries): it
keeps the processes in step, and a dead peer fails the others at the
process group's timeout instead of hanging them.

Single-process use needs no initialization: ``init_multihost`` does nothing
when the environment describes no multi-process launch, and
``process_local_batch`` is then ``batch.batched_subtract`` over this
process's devices.
"""

from __future__ import annotations

import atexit
import datetime
import os
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from sfft_tpu_torch.config import SFFTConfig
from sfft_tpu_torch.parallel.batch import batched_subtract, data_devices

DEFAULT_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class MultiHostSpec:
    """Launch description for one process of a multi-host survey run. With
    ``num_processes == 1`` (default) everything is local and no process group
    is made."""

    coordinator_address: Optional[str] = None   # "host0:port" of process 0
    num_processes: int = 1
    process_id: int = 0

    @classmethod
    def from_env(cls) -> "MultiHostSpec":
        """From SFFT_COORDINATOR_ADDRESS, SFFT_NUM_PROCESSES and
        SFFT_PROCESS_ID; without them from torchrun's WORLD_SIZE and RANK
        (the address then comes from MASTER_ADDR / MASTER_PORT, env://); a
        single-process spec when neither is set."""
        addr = os.environ.get("SFFT_COORDINATOR_ADDRESS")
        if addr is not None:
            return cls(coordinator_address=addr,
                       num_processes=int(os.environ.get("SFFT_NUM_PROCESSES", "1")),
                       process_id=int(os.environ.get("SFFT_PROCESS_ID", "0")))
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            return cls(num_processes=int(os.environ["WORLD_SIZE"]),
                       process_id=int(os.environ.get("RANK", "0")))
        return cls()


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def init_multihost(spec: Optional[MultiHostSpec] = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join the process group if (and only if) the spec describes a
    multi-process launch: gloo over tcp://<coordinator_address>, or env://
    (as torchrun sets it) without an address. Returns the number of
    processes (1, and nothing done, for a single process). Collectives
    fail after `timeout_s` seconds."""
    spec = spec or MultiHostSpec.from_env()
    if spec.num_processes <= 1:
        return 1
    import torch.distributed as dist

    if not dist.is_initialized():
        init = ("env://" if spec.coordinator_address is None
                else f"tcp://{spec.coordinator_address}")
        dist.init_process_group("gloo", init_method=init, world_size=spec.num_processes,
                                rank=spec.process_id,
                                timeout=datetime.timedelta(seconds=timeout_s))
        # a group still alive when the interpreter exits aborts the process
        # as its threads are torn down
        atexit.register(shutdown_multihost)
    return dist.get_world_size()


def shutdown_multihost() -> None:
    """Leave the process group, if this process is in one (sfft_tpu's
    runtime shuts down at exit; ``init_multihost`` registers this at exit)."""
    dist = _dist()
    if dist is not None:
        dist.destroy_process_group()


def _rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist else 0


def _world() -> int:
    dist = _dist()
    return dist.get_world_size() if dist else 1


def _all_gather(obj) -> list:
    """obj of every process, in rank order (one gloo collective)."""
    dist = _dist()
    if dist is None:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


class GlobalDevices(NamedTuple):
    """This process's devices and the count of every process's."""

    devices: List
    per_process: Tuple[int, ...]

    @property
    def count(self) -> int:
        return sum(self.per_process)


def global_data_devices(devices=None) -> GlobalDevices:
    """sfft_tpu's global_data_mesh: this process's cards
    (``batch.data_devices``; without a card this raises, so CPU callers
    name their devices), with every process's count from one collective.
    Every process must call it."""
    local = data_devices(devices=devices)
    return GlobalDevices(local, tuple(_all_gather(len(local))))


def assign_tasks(n_tasks: int, process_id: Optional[int] = None,
                 process_count: Optional[int] = None) -> np.ndarray:
    """Indices of the tasks this process loads: contiguous slabs, one per
    process (sfft_tpu's block arithmetic)."""
    pid = _rank() if process_id is None else process_id
    pc = _world() if process_count is None else process_count
    bounds = np.linspace(0, n_tasks, pc + 1).astype(int)
    return np.arange(bounds[pid], bounds[pid + 1])


def process_local_batch(local_I, local_J, local_mI, local_mJ, cfg: SFFTConfig,
                        devices=None):
    """One batch of this process's pairs (B_local, N0, N1): pair k solves on
    (mI[k], mJ[k]) and subtracts (I[k], J[k]) on devices[k % n]
    (``batch.batched_subtract``: batched steps for the fast and the
    default configs; ``run_survey_multihost`` passes one pair a device,
    whose batched step is the single step). Every process calls it
    collectively with the same B_local, a multiple of its device count;
    otherwise it raises.
    Returns (solutions, differences, rms) of the local pairs as numpy."""
    devices = data_devices(devices=devices)
    B = len(local_I)
    if B % len(devices):
        raise ValueError(f"B_local={B} is not a multiple of the {len(devices)} local devices")
    sizes = _all_gather(B)
    if len(set(sizes)) != 1:
        raise ValueError(f"every process must pass the same B_local, got {sizes}")
    sols, diffs, rms = batched_subtract(local_I, local_J, local_mI, local_mJ, cfg,
                                        devices=devices)
    return sols.cpu().numpy(), diffs.cpu().numpy(), rms.cpu().numpy()


def run_survey_multihost(pairs: Sequence, load_fn, cfg: SFFTConfig,
                         spec: Optional[MultiHostSpec] = None, devices=None,
                         with_difference: bool = False,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """The multi-host survey entry point. pairs: the GLOBAL task list, the same
    on every process; load_fn(task) -> (I, J, mI, mJ) numpy arrays. Each
    process loads only its ``assign_tasks`` slab, pads its last batch by
    repeating its last task, and runs as many batches as the process with
    the most, each through ``process_local_batch`` and one all_gather of the
    batch's per-pair RMS. Returns {global index: (solution, diff RMS)} for
    the local tasks, or (solution, diff RMS, difference) with
    with_difference=True. devices: this process's (its cards when None)."""
    init_multihost(spec, timeout_s)
    glob = global_data_devices(devices)
    pc = len(glob.per_process)
    n_local = len(glob.devices)
    mine = assign_tasks(len(pairs), _rank(), pc)
    # every process runs the same number of collective batches
    n_batches = max(-(-len(assign_tasks(len(pairs), p, pc)) // glob.per_process[p])
                    for p in range(pc))
    results = {}
    for b in range(n_batches):
        sel = mine[b * n_local:(b + 1) * n_local]
        idxs = list(sel) + [mine[-1] if len(mine) else 0] * (n_local - len(sel))
        loaded = [load_fn(pairs[i]) for i in idxs]
        stacks = [np.stack([t[k] for t in loaded]) for k in range(4)]
        sols, diffs, _ = process_local_batch(*stacks, cfg, devices=glob.devices)
        rms = [float(np.sqrt(np.mean(diffs[j] ** 2))) for j in range(len(sel))]
        _all_gather(rms)
        for j, i in enumerate(sel):
            results[int(i)] = ((sols[j], rms[j], diffs[j]) if with_difference
                               else (sols[j], rms[j]))
    return results
