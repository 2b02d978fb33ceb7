#!/usr/bin/env python3
"""Smoke run of the sfft_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from sfft_tpu_torch/csrc, holds each
against its plain PyTorch twin on the card, then drives the port's main path
once at full size: a 4096^2 pair (the benchmark pair's generator) through
PureTorchCustomizedPacket.PCP -> GeneralSFFT.GSS with the 'fast' backends
(peeled tables, fft32 difference, refined solve), KerHW=8, poly2/poly2
(NEQ = 1740). It checks that the path went through both kernels, that the
difference is finite with the pair's noise level, and that it agrees with the
port's f64 fft/fft/lu path run on the plain twins only.

Every phase prints one line; any failure raises, so the process exits
non-zero and prints no result. The last three lines are the kernel report
(one JSON object), the card's name and power limit, and
{"ok": true, "device": {...}}. Needs a CUDA device and nvcc; imports
nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N = 4096
KERHW = 8


def log(msg):
    print(msg, flush=True)


def make_pair(n, seed=0):
    """The benchmark pair (bench.py make_pair): smooth sky, 2000 point
    sources, J = 1.1 I + 5 + unit noise, I + unit noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    I = 200.0 * (1.0 + 0.2 * xx / n + 0.3 * (yy / n) ** 2)
    k = 2000
    xs = rng.integers(4, n - 4, k)
    ys = rng.integers(4, n - 4, k)
    amps = rng.uniform(100, 2000, k)
    psf = np.array(
        [[0.01, 0.05, 0.1, 0.05, 0.01],
         [0.05, 0.3, 0.6, 0.3, 0.05],
         [0.1, 0.6, 1.0, 0.6, 0.1],
         [0.05, 0.3, 0.6, 0.3, 0.05],
         [0.01, 0.05, 0.1, 0.05, 0.01]]
    )
    for x, y, a in zip(xs, ys, amps):
        I[x - 2 : x + 3, y - 2 : y + 3] += a * psf
    J = 1.1 * I + 5.0 + rng.normal(0, 1.0, (n, n))
    I = I + rng.normal(0, 1.0, (n, n))
    return I, J


def cuda_ms(fn, reps=5, inner=10):
    """Time of one call of fn in ms: the median over `reps` CUDA-event
    windows (after one warm-up) of `inner` back-to-back calls, divided by
    `inner`, so the host's launch overhead overlaps the device work as it
    does on the main path."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def rel_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    assert torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul is on"
    assert torch.get_float32_matmul_precision() == "highest", "f32 matmul below highest"
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"allow_tf32=False float32_matmul_precision=highest")
    return smi


def phase_build():
    from sfft_tpu_torch import _kernels

    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.lib()
    srcs = [os.path.relpath(s, HERE) for s in _kernels.sources()]
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s, {srcs} -> "
        f"{os.path.relpath(path, HERE)}")


def phase_kernels():
    import torch
    from sfft_tpu_torch.core import greek, moments

    dev = torch.device("cuda")
    report = {}

    # K3: M = W @ G, the test_pallas_moments.py inputs (W * logspace, G + 1e4)
    k3 = {}
    for S, N0, N1 in [(8, N, N), (3, 300, 257), (16, 512, 130), (20, 256, 129)]:
        rng = np.random.default_rng(5)
        W = torch.as_tensor(rng.normal(0, 1, (S, N0)) * np.logspace(0, 6, N0)[None, :],
                            device=dev)
        G = torch.as_tensor(rng.normal(0, 1, (N0, N1)) + 1e4, device=dev)
        out = moments.moments(W, G)
        torch.cuda.synchronize()
        ref = moments.moments_plain(W, G)
        err = rel_err(out, ref)
        assert err <= 1e-13, f"K3 {(S, N0, N1)}: rel err {err:.3e} > 1e-13"
        log(f"phase 3 K3 moments {(S, N0, N1)}: max|d|/max|ref| = {err:.3e} (bound 1e-13)")
        if (S, N0, N1) == (8, N, N):
            k3 = dict(max_abs_err=float((out - ref).abs().max()),
                      ms=cuda_ms(lambda: moments.moments(W, G)),
                      plain_ms=cuda_ms(lambda: moments.moments_plain(W, G)))
    log(f"phase 3 K3 moments (8, {N}, {N}) f64: kernel {k3['ms']:.4f} ms, "
        f"plain W @ G {k3['plain_ms']:.4f} ms")
    report["moments"] = k3

    # K1 at the slice's two shapes in c64: 6 fluctuation spectra (N, N/2+1);
    # OMG window +-2w symmetric (21 pairs, 33 x 33), THE window +-w vs J
    # (6 pairs, 17 x 17)
    rng = np.random.default_rng(6)
    planes = torch.as_tensor(rng.normal(0, 30, (7, N, N)), dtype=torch.float32, device=dev)
    specs = torch.fft.rfft2(planes)
    del planes
    specJ, specF = specs[0:1], specs[1:]
    calls = {
        "omg": lambda m: greek.corr_window_fft(specF, specF, N, N, 2 * KERHW, 2 * KERHW,
                                               method=m, symmetric=True),
        "the": lambda m: greek.corr_window_fft(specF, specJ, N, N, KERHW, KERHW, method=m),
    }
    k1 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
    for name, call in calls.items():
        out = call("kernel")
        torch.cuda.synchronize()
        ref = call("matmul")
        err = rel_err(out, ref)
        assert err <= 1e-5, f"K1 c64 {name}: rel err {err:.3e} > 1e-5"
        ms = cuda_ms(lambda: call("kernel"))
        pms = cuda_ms(lambda: call("matmul"))
        k1["max_abs_err"] = max(k1["max_abs_err"], float((out - ref).abs().max()))
        k1["ms"] += ms
        k1["plain_ms"] += pms
        log(f"phase 3 K1 corr_window c64 {name} {tuple(out.shape)}: max|d|/max|ref| = "
            f"{err:.3e} (bound 1e-5); kernel {ms:.4f} ms, plain matmul twin {pms:.4f} ms")
    report["corr_window"] = k1
    del specs, specJ, specF

    # K1 in c128 at 512^2: both symmetric settings and chunking
    A = torch.as_tensor(rng.normal(0, 1, (6, 512, 512)), device=dev)
    spec = torch.fft.rfft2(A)
    for symmetric in (True, False):
        for chunk in (0, 5):
            kw = dict(symmetric=symmetric, chunk=chunk)
            out = greek.corr_window_fft(spec, spec, 512, 512, 16, 16, method="kernel", **kw)
            torch.cuda.synchronize()
            ref = greek.corr_window_fft(spec, spec, 512, 512, 16, 16, method="matmul", **kw)
            err = rel_err(out, ref)
            assert err <= 1e-11, f"K1 c128 {kw}: rel err {err:.3e} > 1e-11"
            log(f"phase 3 K1 corr_window c128 512^2 {kw}: max|d|/max|ref| = {err:.3e} "
                f"(bound 1e-11)")
    return report


def run_pcp(I, J, cfg, plain, reps):
    """One warm-up and `reps` timed solve+subtract runs through PCP;
    returns (solution, difference, median seconds)."""
    import torch
    from sfft_tpu_torch import PureTorchCustomizedPacket

    times = []
    for k in range(reps + 1):
        t0 = time.perf_counter()
        sol, diff = PureTorchCustomizedPacket.PCP(I, J, I, J, "REF", KERHW, cfg=cfg,
                                                  plain=plain)
        torch.cuda.synchronize()
        if k:
            times.append(time.perf_counter() - t0)
    return sol, diff, statistics.median(times)


def phase_slice(I, J):
    import torch
    from sfft_tpu_torch import make_config
    from sfft_tpu_torch.core import greek, moments

    cfg = make_config(N, N, KERHW, greek_backend="peeled", fdiff_backend="fft32",
                      solver="refined")
    assert cfg.NEQ == 1740 and cfg.fluct_dtype == "float32"
    moments.moments.launches = 0
    greek.corr_window.launches = 0
    sol, diff, step_s = run_pcp(I, J, cfg, plain=False, reps=3)
    launches = {"moments": moments.moments.launches,
                "corr_window": greek.corr_window.launches}
    assert all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}"
    assert sol.shape == (cfg.NEQ,) and diff.shape == (N, N)
    assert bool(torch.isfinite(sol).all()) and bool(torch.isfinite(diff).all())
    c = slice(N // 4, 3 * N // 4)
    rms = float(torch.sqrt(torch.mean(diff[c, c] ** 2)))
    assert 1.3 <= rms <= 1.7, f"central difference RMS {rms:.4f} outside [1.3, 1.7]"
    log(f"phase 4 slice {N}^2 KerHW={KERHW} peeled/fft32/refined NEQ={cfg.NEQ}: "
        f"median step {step_s * 1e3:.1f} ms over 3 runs; launches {launches} in 4 runs; "
        f"central diff RMS {rms:.4f} (expect ~1.49)")
    _, _, plain_s = run_pcp(I, J, cfg, plain=True, reps=3)
    log(f"phase 4 same slice on the plain twins (no hand kernel): median step "
        f"{plain_s * 1e3:.1f} ms")
    return diff, launches, step_s, plain_s


def phase_f64(I, J, diff_fast):
    import torch
    from sfft_tpu_torch import make_config

    cfg = make_config(N, N, KERHW)
    assert (cfg.greek_backend, cfg.fdiff_backend, cfg.solver) == ("fft", "fft", "lu")
    _, diff64, step_s = run_pcp(I, J, cfg, plain=True, reps=1)
    assert bool(torch.isfinite(diff64).all())
    rms = float(torch.sqrt(torch.mean((diff_fast - diff64) ** 2)))
    assert rms < 0.05, f"fast vs f64 difference RMS {rms:.4e} >= 0.05"
    log(f"phase 5 f64 fft/fft/lu on the plain twins: step {step_s * 1e3:.1f} ms; "
        f"RMS(diff_fast - diff_f64) = {rms:.4e} (bound 0.05)")
    return rms


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import sfft_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = phase_device()
    phase_build()
    report = phase_kernels()
    t0 = time.perf_counter()
    I, J = make_pair(N)
    dev = torch.device("cuda")
    I = torch.as_tensor(I, device=dev)
    J = torch.as_tensor(J, device=dev)
    log(f"phase 4 pair {N}^2 made and uploaded in {time.perf_counter() - t0:.1f} s")
    diff_fast, launches, step_s, plain_s = phase_slice(I, J)
    rms64 = phase_f64(I, J, diff_fast)
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules), "jax imported"

    kernels = []
    for name, source, replaces in [
        ("moments", "sfft_tpu_torch/csrc/moments.cu", "sfft_tpu/core/pallas_moments.py:143"),
        ("corr_window", "sfft_tpu_torch/csrc/corr_window.cu", "sfft_tpu/core/greek.py:94"),
    ]:
        r = report[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"]))
    log(json.dumps({"slice_step_ms": step_s * 1e3, "slice_step_plain_ms": plain_s * 1e3,
                    "fast_vs_f64_rms": rms64, "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
