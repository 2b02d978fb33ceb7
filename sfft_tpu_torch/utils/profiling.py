"""Phase timing + profiler integration (counterpart of
sfft_tpu/utils/profiling.py).

Reference: wall-clock segment timers printed at VERBOSE_LEVEL 2 with labeled
phases a-k (sfft/sfftcore/SFFTSubtract.py:172-178, 416-425, 465-470). Here a
small context-manager based phase timer with the same reporting style, plus a
torch.profiler trace context for device-level profiling.

PyTorch returns before the card finishes, so a wall-clock phase ends with
``sync``: torch.cuda.synchronize on the device of the phase's result (CUDA
tensors only; CPU work is already done when the call returns).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(x) -> float:
    """Wait for the card to finish the work behind x (a tensor, or a
    list / tuple / dict holding one): torch.cuda.synchronize on the device
    of its first tensor. Returns 0.0, as sfft_tpu's returns a cheap scalar."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return 0.0


class PhaseTimer:
    """Collects labeled phase durations; prints the reference's report style."""

    def __init__(self, verbose_level: int = 2):
        self.verbose_level = verbose_level
        self.phases: Dict[str, float] = {}
        self._order = []

    @contextlib.contextmanager
    def phase(self, label: str, sync_result=None):
        t0 = time.time()
        box = {}
        try:
            yield box
        finally:
            if "result" in box:
                sync(box["result"])
            elif sync_result is not None:
                sync(sync_result)
            dt = time.time() - t0
            if label not in self.phases:
                self._order.append(label)
                self.phases[label] = 0.0
            self.phases[label] += dt

    def report(self):
        if self.verbose_level >= 2:
            total = sum(self.phases.values())
            for i, label in enumerate(self._order):
                tag = chr(ord("a") + i)
                print(f"/////   {tag}   ///// {label:40s} ({self.phases[label]:.4f}s)")
            print(f"MeLOn CheckPoint: TOTAL [{total:.4f}s]")
        return dict(self.phases)


@contextlib.contextmanager
def torch_trace(logdir: str = "sfft_torch_trace"):
    """torch.profiler trace of the block (the host's operators and, where a
    card is present, its kernels and copies), written as a Chrome trace to
    `logdir`/trace.json (open in chrome://tracing or Perfetto). Yields the
    profiler; ``key_averages()`` on it gives the table."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
