#!/usr/bin/env python3
"""Smoke run of the sfft_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from sfft_tpu_torch/csrc, holds each
against its plain PyTorch twin on the card (K3 moments, K1 windowed
correlation, K4 and K5 integer slicers: bit for bit), then drives the port's
paths at full size. On a 4096^2 pair (the benchmark pair's generator),
KerHW=8, poly2/poly2 (NEQ = 1740), through PureTorchCustomizedPacket.PCP ->
GeneralSFFT.GSS:

  * the 'fast' slice (peeled tables, fft32 difference, refined solve), which
    runs K3 and K1;
  * the 'contract' path (pexact tables and difference at pexact_prof
    (8, 7, 6), transformed solve; what sfft_tpu runs on the TPU), which runs
    K3 and K4; and once with the 'exact' solver.

And on a 900^2 pair of the same generator, written to FITS, through
BSplinePacket.BSP -> GeneralSFFT.GSS:

  * the v2 (B-spline) engine's contract path on the JWST/NIRCam
    configuration of sfft_tpu's bench.py (GKerHW=11, degree-2 B-spline
    kernel with 2 x 2 internal knots, SEPARATE-VARYING degree-2 polynomial
    scaling, degree-0 background, Tikhonov lambda = 3e-5 on 512 seeded
    points: NEQ = 13226) with the exact / exact / exact backends, which runs
    K4 (every sliced product of the exact engine) and K5 (the sliced
    residuals of the large f64 solve). The NIRCam image pair itself is not
    in the repository; the generated pair stands in for it.

Each path is driven with the launch counts set to 0 just before it and read
just after, and must have launched its kernels. Two more steps of the
contract path and of the v2 path, the first with the static-table caches
emptied, hold every launch of the K4 and K5 slicing stages of the step (the
static tables' and the data's, on the views, depths and padded widths the
path gives them) bit for bit against the stage twins on the same inputs
(slices, scales, and the f32 matrix of the K5 setup), and time each stage
and its twin on each distinct launch's inputs. The v2 path is held to the f64 fft/fft/lu
path of the same configuration (difference within 1e-6 RMS, solution within
1e-6 of its maximum), and its large solve (f32 Cholesky refined with sliced
residuals) to the same solve with f64-matvec residuals (1e-9). The 4096^2
paths are held to the port's f64 path on the plain twins: the fast
difference to the fft/fft/lu difference within 0.05 RMS; the contract
difference to the fft/fft/exact difference (the f64 tables solved by the
refined 'exact' solver) within 1e-6 RMS, and its solution to 1e-6 of that
solution's maximum. Each difference must have the pair's noise level.

Every phase prints one line; any failure raises, so the process exits
non-zero and prints no result. The last three lines are the kernel report
(one JSON object), the card's name and power limit, and
{"ok": true, "device": {...}}. Needs a CUDA device and nvcc; imports
nothing of JAX. Takes a few minutes on an H100.

    python3 chip_smoke.py --profile OUT_DIR

builds the kernels and profiles one step of each path (contract, fast, v2)
instead (device busy time, idle share, top operations; the full tables go to
OUT_DIR).

    python3 chip_smoke.py --steady PAIRS

builds the kernels and times the fast slice at steady state instead: two
warm-ups each way, then PAIRS pairs of one step with the kernels and one on
the plain twins, in alternating order (KP, PK, ...); prints the medians and
the number of pairs in which the kernels were faster, then the host time the
K3 and K1 wrappers take to enqueue one call and the time of each call on the
device (graph replay and back-to-back calls), which compares two commits'
kernels on one clock when the script is run in a checkout of each.

    python3 chip_smoke.py --kernels OUT_DIR
    python3 chip_smoke.py --slicers OUT_DIR

build the kernels with the compiler's resource report (registers, shared
memory, spills; written to OUT_DIR/build_report.txt) and run phase 3's
checks and timings of K3 and K1 (with a profile of one call of each at the
fast slice's shapes: device time of each stage by kernel name), or of the
K4 and K5 slicing stages, alone.

    python3 chip_smoke.py --stages OUT_DIR

times the slicing stages of one steady contract step and one steady v2 step
on the path's own inputs (device, back to back, plain twins, kernels and
copies per call, bound; OUT_DIR/stages_<label>.json). It runs in a checkout
without the stage entries of core/slicing.py too, where each stage is the
wrapper chain the callers ran before them, so that two commits compare on
one card.
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
# the v2 path: image width, kernel half-width and Tikhonov weight of the
# NIRCam configuration; solve_n is the size of its tweaked system (13226
# dofs less the 19 placeholder scaling dofs)
V2_N = 900
V2_KERHW = 11
V2_LAMBDA = 3e-5
V2_NEQ = 13226
V2_SOLVE_N = 13207
# H100 SXM datasheet peaks (NVIDIA's data sheet, dense rates at the 700 W
# limit): HBM3, and FP32 / FP64 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12


def bound(nbytes, flops, peak):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


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


def graph_ms(fn, calls=20, reps=7):
    """Time of one call of fn in ms with the host out of the way: `calls`
    calls are captured in one CUDA graph (after three warm-ups on the capture
    stream) and the graph is replayed; the median over `reps` replays, over
    `calls`. At tens of microseconds per call cuda_ms measures the host's
    launch rate as much as the kernel; this measures the device alone, for a
    hand kernel and a library call alike."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
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
    if sys.argv[1:2] in (["--kernels"], ["--slicers"]) and len(sys.argv) == 3:
        # the compiler's report (registers, shared memory, spills) goes to a file
        import contextlib

        os.makedirs(sys.argv[2], exist_ok=True)
        with open(os.path.join(sys.argv[2], "build_report.txt"), "w") as f:
            with contextlib.redirect_stdout(f):
                path = _kernels.build(verbose=True)
    else:
        path = _kernels.build()
    _kernels.lib()
    srcs = [os.path.relpath(s, HERE) for s in _kernels.sources()]
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s, {srcs} -> "
        f"{os.path.relpath(path, HERE)}")


def phase_k3():
    """K3 against its twin at the fast slice's shape and at ragged ones, each
    launched twice (bit-equal); times at the fast slice's shape."""
    import torch
    from sfft_tpu_torch.core import moments

    dev = torch.device("cuda")
    k3 = {}
    # M = W @ G, the test_pallas_moments.py inputs (W * logspace, G + 1e4).
    # Odd N1 (257, 129, 20001) and the view 8 bytes off the 16-byte boundary
    # take the 8-byte-load variant; (5, 3001, 20001) stages W in several
    # chunks per block; (3, 7, 300) is one split (no reduction)
    cases = [(8, N, N, 0), (3, 300, 257, 0), (16, 512, 130, 0), (20, 256, 129, 0),
             (8, 500, 384, 1), (5, 3001, 20001, 0), (5, 3001, 20002, 0), (3, 7, 300, 0)]
    for S, N0, N1, shift in cases:
        rng = np.random.default_rng(5)
        W = torch.as_tensor(rng.normal(0, 1, (S, N0)) * np.logspace(0, 6, N0)[None, :],
                            device=dev)
        if N0 * N1 > 2 ** 24 and N0 != N:
            g = torch.Generator(device=dev)
            g.manual_seed(5)
            G = torch.randn((N0 * N1 + shift,), dtype=torch.float64, device=dev, generator=g)
            G += 1e4
        else:
            G = torch.as_tensor(rng.normal(0, 1, (N0 * N1 + shift,)) + 1e4, device=dev)
        G = G[shift:].reshape(N0, N1)
        plan = moments._launch_plan(N0, N1, aligned=G.data_ptr() % 16 == 0)
        assert plan["vec"] == (1 if (N1 % 2 or shift) else 2), plan
        out = moments.moments(W, G)
        again = moments.moments(W, G)
        torch.cuda.synchronize()
        assert torch.equal(out, again), f"K3 {(S, N0, N1)}: two launches differ"
        ref = moments.moments_plain(W, G)
        err = rel_err(out, ref)
        assert err <= 1e-13, f"K3 {(S, N0, N1)}: rel err {err:.3e} > 1e-13"
        log(f"phase 3 K3 moments {(S, N0, N1)}{' off 16-byte alignment' if shift else ''}: "
            f"{plan['vec'] * 8}-byte loads, {plan['col_blocks']} x {plan['nsplit']} blocks of "
            f"{plan['rows']} rows; max|d|/max|ref| = {err:.3e} (bound 1e-13); two launches "
            f"bit-equal")
        if (S, N0, N1) == (8, N, N):
            # ms, plain_ms and library_ms are device times (graph replay); the
            # *_eager_ms are back-to-back calls from Python, launch gaps included
            k3 = dict(max_abs_err=float((out - ref).abs().max()),
                      ms=graph_ms(lambda: moments.moments(W, G)),
                      plain_ms=graph_ms(lambda: moments.moments_plain(W, G)),
                      library_ms=graph_ms(lambda: torch.matmul(W, G)),
                      eager_ms=cuda_ms(lambda: moments.moments(W, G)),
                      library_eager_ms=cuda_ms(lambda: torch.matmul(W, G)))
            k3["bound_ms"], k3["bound_by"] = bound(8 * (S * N0 + N0 * N1 + S * N1),
                                                   2 * S * N0 * N1, FP64_FLOP_PER_S)
    log(f"phase 3 K3 moments (8, {N}, {N}) f64, device time (20 calls in a CUDA graph, "
        f"replayed): kernel {k3['ms']:.4f} ms, plain W @ G {k3['plain_ms']:.4f} ms, library "
        f"torch.matmul {k3['library_ms']:.4f} ms, bound {k3['bound_ms']:.4f} ms "
        f"({k3['bound_by']}); back-to-back calls from Python: kernel {k3['eager_ms']:.4f} ms, "
        f"torch.matmul {k3['library_eager_ms']:.4f} ms")
    return k3


def k1_bound(npairs, nspec, n0, n1h, r0, r1, itemsize, peak, sym):
    """K1's bound: stage 1 forms the Hadamard product (6 flops per element)
    and contracts it with E1: a complex multiply-add (8 flops) per window
    column, or with `sym` (the conjugate-pair route, which corr_window_fft
    takes) four multiply-adds (8 flops) per pair of columns +d and -d:
    r1 // 2 + 1 of them. Stage 2 contracts the (pairs, N0, R1) result with
    E0; each spectrum is read once, the real windows written once."""
    cols = r1 // 2 + 1 if sym else r1
    return bound(itemsize * nspec * n0 * n1h + itemsize // 2 * npairs * r0 * r1,
                 npairs * n0 * n1h * (6 + 8 * cols) + 8 * npairs * r0 * n0 * r1, peak)


def phase_k1():
    """K1 against its matmul twin: c64 at the fast slice's two shapes (timed,
    launched twice: bit-equal) and at ragged shapes, c128 at 512^2 and, timed,
    at the f64 'fft' greek backend's OMG call at 4096^2."""
    import torch
    from sfft_tpu_torch.core import greek

    dev = torch.device("cuda")
    # the slice's two shapes in c64: 6 fluctuation spectra (N, N/2+1);
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
    N1h = N // 2 + 1
    shapes = {"omg": (21, 4 * KERHW + 1, 6), "the": (6, 2 * KERHW + 1, 7)}
    k1 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
              bound_by="operations")
    for name, call in calls.items():
        out = call("kernel")
        again = call("kernel")
        torch.cuda.synchronize()
        assert torch.equal(out, again), f"K1 c64 {name}: two launches differ"
        del again
        ref = call("matmul")
        err = rel_err(out, ref)
        assert err <= 1e-5, f"K1 c64 {name}: rel err {err:.3e} > 1e-5"
        ms = graph_ms(lambda: call("kernel"), calls=5)
        ems = cuda_ms(lambda: call("kernel"))
        pms = cuda_ms(lambda: call("matmul"))
        npairs, R, nspec = shapes[name]
        bms, by = k1_bound(npairs, nspec, N, N1h, R, R, 8, FP32_FLOP_PER_S, sym=True)
        k1["max_abs_err"] = max(k1["max_abs_err"], float((out - ref).abs().max()))
        k1["ms"] += ms
        k1["plain_ms"] += pms
        k1["bound_ms"] += bms
        k1[name] = dict(ms=ms, eager_ms=ems, plain_ms=pms, bound_ms=bms, bound_by=by,
                        plan=greek._corr_plan(R, True))
        log(f"phase 3 K1 corr_window c64 {name} {tuple(out.shape)} plan (TY, NE) = "
            f"{k1[name]['plan']}: max|d|/max|ref| = {err:.3e} (bound 1e-5), two launches "
            f"bit-equal; kernel {ms:.4f} ms (5 calls in a CUDA graph, replayed; {ems:.4f} ms "
            f"back to back from Python), plain matmul twin {pms:.4f} ms, "
            f"bound {bms:.4f} ms ({by}, the conjugate-pair route's count); no single PyTorch "
            f"call computes it")
    # the general route (any weights; no caller on the port's paths) on the
    # OMG pair list, against its own bound
    iu, ju = np.triu_indices(6)
    R = 4 * KERHW + 1
    E0, E1 = greek._idft_mats_on(N, N, 2 * KERHW, 2 * KERHW, specF.dtype, dev)
    out = greek.corr_window(specF, specF, iu, ju, E0, E1)
    err = rel_err(out, greek.corr_pairs_plain(specF, specF, iu, ju, E0, E1))
    assert err <= 1e-5, f"K1 c64 omg pair list, general weights: rel err {err:.3e} > 1e-5"
    gen = dict(ms=graph_ms(lambda: greek.corr_window(specF, specF, iu, ju, E0, E1), calls=5),
               plan=greek._corr_plan(R, False))
    gen["bound_ms"], gen["bound_by"] = k1_bound(21, 6, N, N1h, R, R, 8, FP32_FLOP_PER_S,
                                                sym=False)
    k1["omg_general"] = gen
    log(f"phase 3 K1 corr_window c64 omg pair list on the general route (any weights), plan "
        f"(TY, NE) = {gen['plan']}: max|d|/max|ref| = {err:.3e} (bound 1e-5); kernel "
        f"{gen['ms']:.4f} ms, bound {gen['bound_ms']:.4f} ms ({gen['bound_by']})")
    del specs, specJ, specF, out, ref, E0, E1

    # c64 at ragged shapes: N0 off the 64-row tile, odd and even N1h, 1 to 64
    # lags along axis 1, an unordered pair list with repeated planes
    ia = np.array([3, 0, 3, 1, 1, 0, 2, 3])
    ib = np.array([1, 1, 3, 0, 1, 2, 2, 0])
    nragged = 0
    for N0, N1h_r in [(100, 51), (131, 52), (64, 17)]:
        sa = torch.as_tensor(rng.normal(0, 1, (4, N0, N1h_r, 2)), dtype=torch.float32,
                             device=dev)
        sb = torch.as_tensor(rng.normal(0, 1, (4, N0, N1h_r, 2)), dtype=torch.float32,
                             device=dev)
        sa, sb = torch.view_as_complex(sa), torch.view_as_complex(sb)
        for R0, R1 in [(1, 1), (17, 17), (33, 33), (5, 64), (7, 10)]:
            E0 = torch.view_as_complex(torch.as_tensor(
                rng.normal(0, 1, (R0, N0, 2)), dtype=torch.float32, device=dev))
            E1 = torch.view_as_complex(torch.as_tensor(
                rng.normal(0, 1, (N1h_r, R1, 2)), dtype=torch.float32, device=dev))
            variants = [(E1, False)]
            if R1 % 2:
                # conjugate-symmetric weights about the middle column: the
                # kernel's half-work variant, and the general one on them
                w = R1 // 2
                Es = torch.cat([torch.flip(E1[:, w + 1:], dims=(1,)).conj(), E1[:, w:]],
                               dim=1).resolve_conj().contiguous()
                variants += [(Es, True), (Es, False)]
            for (E, sym) in variants:
                for pa, pb in [(ia, ib), (ia[:1], ib[:1])]:
                    out = greek._corr_window(sa, sb, pa, pb, E0, E, sym=sym)
                    again = greek._corr_window(sa, sb, pa, pb, E0, E, sym=sym)
                    torch.cuda.synchronize()
                    assert torch.equal(out, again), \
                        f"K1 c64 ragged {(N0, N1h_r, R0, R1, sym)}: two launches differ"
                    err = rel_err(out, greek.corr_pairs_plain(sa, sb, pa, pb, E0, E))
                    assert err <= 1e-5, \
                        f"K1 c64 ragged {(N0, N1h_r, R0, R1, sym)}: {err:.3e} > 1e-5"
                    nragged += 1
    # a chunk that splits a plane's group of pairs, symmetric and cross
    A = torch.as_tensor(rng.normal(0, 1, (5, 200, 150)), dtype=torch.float32, device=dev)
    spec = torch.fft.rfft2(A)
    for symmetric in (True, False):
        for chunk in (0, 4, 1):
            kw = dict(symmetric=symmetric, chunk=chunk)
            out = greek.corr_window_fft(spec, spec, 200, 150, 8, 16, method="kernel", **kw)
            torch.cuda.synchronize()
            ref = greek.corr_window_fft(spec, spec, 200, 150, 8, 16, method="matmul", **kw)
            err = rel_err(out, ref)
            assert err <= 1e-5, f"K1 c64 (5, 200, 76) {kw}: rel err {err:.3e} > 1e-5"
            nragged += 1
    log(f"phase 3 K1 corr_window c64 ragged: {nragged} checks within 1e-5 of the twin "
        f"(N0 100 / 131 / 64 / 200, N1h 51 / 52 / 17 / 76, R1 1 / 10 / 17 / 33 / 64, an "
        f"unordered pair list with repeated planes, one pair, general and conjugate-symmetric "
        f"weights, chunks 4 and 1 splitting a plane's pairs), direct launches twice and "
        f"bit-equal")

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
    del A, spec, out, ref

    # c128 at the f64 'fft' greek backend's largest call: OMG of six planes
    # at 4096^2 (21 pairs, 33 x 33)
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    spec = torch.fft.rfft2(30.0 * torch.randn((6, N, N), dtype=torch.float64, device=dev,
                                              generator=g))
    call = lambda m: greek.corr_window_fft(spec, spec, N, N, 2 * KERHW, 2 * KERHW, method=m,
                                           symmetric=True)
    out = call("kernel")
    again = call("kernel")
    torch.cuda.synchronize()
    assert torch.equal(out, again), "K1 c128 omg: two launches differ"
    del again
    err = rel_err(out, call("matmul"))
    assert err <= 1e-11, f"K1 c128 omg: rel err {err:.3e} > 1e-11"
    R = 4 * KERHW + 1
    c128 = dict(ms=graph_ms(lambda: call("kernel"), calls=3, reps=3),
                plain_ms=cuda_ms(lambda: call("matmul"), reps=3, inner=1),
                plan=greek._corr_plan(R, True))
    c128["bound_ms"], c128["bound_by"] = k1_bound(21, 6, N, N1h, R, R, 16, FP64_FLOP_PER_S, sym=True)
    k1["c128_omg"] = c128
    log(f"phase 3 K1 corr_window c128 omg {tuple(out.shape)} at {N}^2 plan (TY, NE) = "
        f"{c128['plan']}: max|d|/max|ref| = {err:.3e} (bound 1e-11), two launches bit-equal; "
        f"kernel {c128['ms']:.4f} ms, plain matmul twin {c128['plain_ms']:.4f} ms, bound "
        f"{c128['bound_ms']:.4f} ms ({c128['bound_by']})")
    return k1


def phase_kernels():
    import torch
    from sfft_tpu_torch.core import exact_fft

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    N1h = N // 2 + 1
    report = {"moments": phase_k3(), "corr_window": phase_k1()}
    torch.cuda.empty_cache()

    # K4: bit for bit against the twin (slices and scales), rowwise and
    # global, on wide-range values: odd widths (the scalar path: a row
    # width or size not a multiple of 4) and widths that are (the float4
    # path, as the contract path's padded operands). phase 6 repeats the
    # check on every launch of a contract step, on the path's own inputs
    ndiff = 0
    for shape in [(64, 384), (3, 40, 256), (130, 120), (7, 33), (1001,), (N, N1h),
                  (3, N, N1h + 7), (N, 64, 64)]:
        v = rng.normal(0, 7.3, shape) * np.exp(rng.normal(0, 4, shape))
        h = torch.as_tensor(v.astype(np.float32), device=dev)
        lo = torch.as_tensor((v - v.astype(np.float32)).astype(np.float32), device=dev)
        for rowwise in (True, False):
            for nsl in (6, 7, 8, 9):
                sl, s = exact_fft._slice_pair_real(h, lo, nsl, rowwise)
                torch.cuda.synchronize()
                ref, sref = exact_fft._slice_pair_real(h, lo, nsl, rowwise, plain=True)
                ndiff += int((sl != ref).sum()) + int((s != sref).sum())
        assert ndiff == 0, f"K4 {shape}: {ndiff} slices or scales differ from the twin"
    log(f"phase 3 K4 slice_pair: 0 slices or scales differ from the twin over 8 shapes x "
        f"(rowwise, global) x nsl (6, 7, 8, 9)")
    phase_stage_checks(rng)
    report["slice_triple_alone"] = phase_k5(rng)
    return report


def k4_views(rng, dev):
    """Views of wide-range f32 pairs as producers leave them: (name, make)
    where make(seed) gives a (hi, lo) pair of that layout. Transposed and
    strided views, a leading axis of stride 1, ragged K, rows off the
    16-byte boundary, zero rows and lo parts that are f32 subnormals."""
    import torch

    def pair(shape, scale=1.0, zero=None):
        v = rng.normal(0, 7.3, shape) * np.exp(rng.normal(0, 4, shape)) * scale
        if zero is not None:
            v[zero] = 0.0
        h = torch.as_tensor(v.astype(np.float32), device=dev)
        return h, torch.as_tensor((v - v.astype(np.float32)).astype(np.float32), device=dev)

    def each(fn, *ps):
        return tuple(fn(t) for t in ps)

    return [
        ("(64, 384) contiguous", lambda: pair((64, 384))),
        ("(7, 33) contiguous", lambda: pair((7, 33))),
        ("(1001,)", lambda: pair((1001,))),
        ("(64, 385) rows of 400", lambda: each(lambda t: t[:, :385], *pair((64, 400)))),
        ("(64, 384) transposed", lambda: each(lambda t: t.t(), *pair((384, 64)))),
        ("(3, 40, 13) transposed", lambda: each(lambda t: t.transpose(1, 2), *pair((3, 13, 40)))),
        ("(3, 40, 256) leading axis of stride 1",
         lambda: each(lambda t: t.permute(2, 0, 1), *pair((40, 256, 3)))),
        ("(5, 33, 130) transposed, a zero row",
         lambda: each(lambda t: t.transpose(1, 2), *pair((5, 130, 33), zero=(1, slice(None), 4)))),
        ("(130, 120) with zero rows", lambda: pair((130, 120), zero=[3, 77])),
        ("(48, 100) off the 16-byte boundary",
         lambda: each(lambda t: t.reshape(-1)[1:1 + 4800].reshape(48, 100), *pair((48 * 100 + 4,)))),
        ("(33, 120) subnormal lo parts", lambda: pair((33, 120), scale=1e-33)),
        ("(2, 900, 451) rows of 451", lambda: pair((2, 900, 451))),
        ("(451, 30, 30) leading axis of stride 1",
         lambda: each(lambda t: t.permute(2, 0, 1), *pair((30, 30, 451)))),
    ]


def phase_stage_checks(rng):
    """The stage entries (core/slicing.py) against their twins, bit for bit:
    K4's slice_pairs on the views of k4_views, real-only (one pair) and
    complex (two pairs), rowwise and global, K padded to Kp = K, the next
    multiple of 8 and 19 more, nsl 1 to 16, and slice_pair under given
    scales; K5's slice_rows_f64 on f64 matrices whose rows alternate between
    16- and 8-byte phases, a zero row, subnormal lo parts, a row too wide for
    shared memory, nsl 8 to 16 and padded widths, and slice_vec_f64 on the
    13207 vector (rows of the operand past nsl left as they were)."""
    import torch
    from sfft_tpu_torch.core import slicing

    dev = torch.device("cuda")
    nchecks = 0
    for name, make in k4_views(rng, dev):
        a, b = make(), make()
        K = a[0].shape[-1]
        for parts in ([a], [a, b]):
            for rowwise in (True, False):
                for Kp, nsl in [(K, 1), (K + (-K) % 8, 9), (K + 19, 16), (K + (-K) % 8, 6)]:
                    before = slicing.slice_pair.launches
                    got = slicing.slice_pairs(parts, nsl, Kp, rowwise)
                    torch.cuda.synchronize()
                    assert slicing.slice_pair.launches == before + 1, name
                    ref = slicing.slice_pairs_plain(parts, nsl, Kp, rowwise)
                    for (sl, s), (rsl, rs) in zip(got, ref):
                        assert sl.shape == rsl.shape and torch.equal(sl, rsl) and \
                            torch.equal(s, rs), f"K4 stage {name} parts={len(parts)} " \
                            f"rowwise={rowwise} Kp={Kp} nsl={nsl}: differs from the twin"
                    nchecks += 1
        h, lo = (t.contiguous() for t in a)
        for s in (ref[0][1], slicing._pow2ceil_scalar(h.abs().amax(dim=-1, keepdim=True))):
            assert torch.equal(slicing.slice_pair(h, lo, s.contiguous(), 8),
                               slicing.slice_pair_plain(h, lo, s, 8)), f"K4 given scale {name}"
            nchecks += 1
    log(f"phase 3 K4 slice_pairs stage: {nchecks} checks bit-identical to the twin (slices and "
        f"scales) over {len(k4_views(rng, dev))} views x (one pair, two) x (rowwise, global) x "
        f"(Kp, nsl) in ((K, 1), (K8, 9), (K + 19, 16), (K8, 6)), and slice_pair under given "
        f"scales")

    def f64(shape, scale=1.0):
        v = rng.normal(0, 7.3, shape) * np.exp(rng.normal(0, 4, shape)) * scale
        return torch.as_tensor(v, device=dev)

    n = V2_SOLVE_N
    cases = []
    A = f64((512, n))
    A[3] = 0.0
    cases.append((f"(512, {n}) with a zero row", A, [n + (-n) % 8, n]))
    cases.append(("(37, 53)", f64((37, 53)), [56, 55, 53]))
    cases.append(("(64, 384)", f64((64, 384)), [384, 392]))
    cases.append(("(40, 1207) rows of 1300", f64((40, 1300))[:, :1207], [1208]))
    cases.append(("(33, 120) subnormal lo parts", f64((33, 120), 1e-22), [120]))
    cases.append(("(3, 30011) rows too wide for shared memory", f64((3, 30011)), [30016]))
    nk5 = 0
    for name, A, widths in cases:
        d = torch.as_tensor(np.exp(rng.normal(0, 2, max(A.shape))), device=dev)
        for nsl in (8, 12, 16):
            for out_cols in widths:
                before = slicing.slice_triple.launches
                got = slicing.slice_rows_f64(A, d, nsl, out_cols)
                torch.cuda.synchronize()
                assert slicing.slice_triple.launches == before + 1, name
                ref = slicing.slice_rows_f64_plain(A, d, nsl, out_cols)
                for g, r in zip(got, ref):
                    assert g.shape == r.shape and torch.equal(g, r), \
                        f"K5 matrix stage {name} nsl={nsl} out_cols={out_cols}: differs"
                nk5 += 1
    for m, rows, ldo in [(n, 64, n + (-n) % 8), (1207, 16, 1210), (13, 12, 13)]:
        x = f64((m,))
        for nsl in (8, 12, 16):
            if nsl > rows:
                continue
            buf = torch.full((rows, ldo), 77, dtype=torch.int8, device=dev)
            want = buf.clone()
            s = slicing.slice_vec_f64(x, nsl, buf)
            torch.cuda.synchronize()
            rs = slicing.slice_vec_f64_plain(x, nsl, want)
            assert torch.equal(buf, want) and torch.equal(s, rs), \
                f"K5 vector stage ({m},) into ({rows}, {ldo}) nsl={nsl}: differs"
            nk5 += 1
    log(f"phase 3 K5 slice_rows_f64 / slice_vec_f64 stages: {nk5} checks bit-identical to the "
        f"twins (Ah, slices, scales; the operand's other rows untouched) over "
        f"{'; '.join(c[0] for c in cases)}; vectors ({n},), (1207,), (13,); nsl 8, 12, 16")


def phase_k5(rng):
    """K5 against its twin, bit for bit (slices and scales), rowwise and
    global, nsl 8 and 12, with and without padded output columns: the
    solve's row-chunk and vector shapes (odd width 13207: scalar loads), a
    zero row, aligned widths (float4 loads), a view off the 16-byte
    boundary, and values whose lo parts are f32 subnormals. Then the time
    at the solve's full (13207, 13207) rowwise nsl-12 launch."""
    import torch
    from sfft_tpu_torch.core import exact_fft, slicing, solve

    dev = torch.device("cuda")
    n = V2_SOLVE_N
    npad = n + (-n) % 8

    def wide(shape, scale=1.0):
        v = rng.normal(0, 7.3, shape) * np.exp(rng.normal(0, 4, shape)) * scale
        return torch.as_tensor(v, device=dev)

    zero_row = wide((512, n))
    zero_row[3] = 0.0
    tiny = solve._split3(wide((33, 120), 1e-22))
    nsub = int(((tiny[2] != 0) & (tiny[2].abs() < 1.17549435e-38)).sum())
    assert nsub > 0, "the subnormal case holds no subnormal lo part"
    flat = solve._split3(wide((64 * 384 + 4,)))
    cases = [
        (f"(512, {n}) with a zero row", solve._split3(zero_row), (None, npad)),
        (f"({n},)", solve._split3(wide((n,))), (None, npad)),
        ("(37, 53)", solve._split3(wide((37, 53))), (None, 56, 55)),
        ("(64, 384)", solve._split3(wide((64, 384))), (None, 392)),
        ("(3, 40, 130)", solve._split3(wide((3, 40, 130))), (None, 136)),
        (f"(33, 120) with {nsub} subnormal lo parts", tiny, (None,)),
        ("(64, 384) view 4 bytes off the 16-byte boundary",
         tuple(p[1:1 + 64 * 384].reshape(64, 384) for p in flat), (None, 392)),
        ("(24579,) view 4 bytes off the 16-byte boundary", tuple(p[1:] for p in flat),
         (None,)),
    ]
    del zero_row
    ndiff = nchecks = 0
    for name, parts, cols in cases:
        for rowwise in (True, False):
            for nsl in (8, 12):
                for out_cols in cols:
                    sl, s = exact_fft._slice_triple_real(*parts, nsl, rowwise, out_cols=out_cols)
                    torch.cuda.synchronize()
                    ref, sref = exact_fft._slice_triple_real(*parts, nsl, rowwise, plain=True,
                                                             out_cols=out_cols)
                    assert sl.shape == ref.shape, f"K5 {name}: shape {tuple(sl.shape)}"
                    ndiff += int((sl != ref).sum()) + int((s != sref).sum())
                    nchecks += 1
        assert ndiff == 0, f"K5 {name}: {ndiff} slices or scales differ from the twin"
        if "zero row" in name:
            sl, _ = exact_fft._slice_triple_real(*parts, 12, True)
            assert not bool(sl[:, 3].any()), "K5: a zero row gave non-zero slices"
    log(f"phase 3 K5 slice_triple: 0 slices or scales differ from the twin in {nchecks} "
        f"checks over {len(cases)} cases ({'; '.join(c[0] for c in cases)}) x (rowwise, "
        f"global) x nsl (8, 12) x output widths")
    del cases, tiny, flat, parts

    # the solve's one big launch: the equilibrated matrix, rowwise, 12
    # slices, rows written at the padded depth of the int8 product
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    v = torch.randn((n, n), dtype=torch.float64, device=dev, generator=g)
    v *= torch.exp(4.0 * torch.randn((n, n), dtype=torch.float64, device=dev, generator=g))
    h, m, lo = solve._split3(v, consume=True)
    del v
    s = exact_fft._pow2ceil_scalar(h.abs().amax(dim=-1, keepdim=True)).contiguous()
    out = slicing.slice_triple(h, m, lo, s, 12, npad)
    torch.cuda.synchronize()
    ref = slicing.slice_triple_plain(h, m, lo, s, 12, npad)
    nd = int((out != ref).sum())
    assert nd == 0, f"K5 ({n}, {n}): {nd} slices differ from the twin"
    del out, ref
    k5 = dict(ms=cuda_ms(lambda: slicing.slice_triple(h, m, lo, s, 12, npad), reps=3, inner=3),
              plain_ms=cuda_ms(lambda: slicing.slice_triple_plain(h, m, lo, s, 12, npad),
                               reps=3, inner=1))
    k5["bound_ms"], k5["bound_by"] = k5_bound((n, n), 12, True, npad)
    log(f"phase 3 K5 slice_triple ({n}, {n}) rowwise nsl=12 into {npad} columns: 0 differing "
        f"slices; kernel {k5['ms']:.4f} ms, plain twin {k5['plain_ms']:.4f} ms, bound "
        f"{k5['bound_ms']:.4f} ms ({k5['bound_by']}); no single PyTorch call computes it")
    del h, m, lo, s

    # the solve's setup as one stage: from A and d to Ah, slices and scales
    A = torch.randn((n, n), dtype=torch.float64, device=dev, generator=g)
    A *= torch.exp(4.0 * torch.randn((n, n), dtype=torch.float64, device=dev, generator=g))
    d = torch.exp(torch.randn((n,), dtype=torch.float64, device=dev, generator=g))
    got = slicing.slice_rows_f64(A, d, 12, npad)
    torch.cuda.synchronize()
    ref = slicing.slice_rows_f64_plain(A, d, 12, npad)
    nd = sum(int((a != b).sum()) for a, b in zip(got, ref))
    assert nd == 0, f"K5 matrix stage ({n}, {n}): {nd} values differ from the twin"
    del got, ref
    stage = dict(ms=cuda_ms(lambda: slicing.slice_rows_f64(A, d, 12, npad), reps=3, inner=3),
                 plain_ms=cuda_ms(lambda: slicing.slice_rows_f64_plain(A, d, 12, npad), reps=3,
                                  inner=1))
    stage["bound_ms"], stage["bound_by"] = k5_matrix_bound(n, 12, npad)
    k5["matrix_stage"] = stage
    log(f"phase 3 K5 slice_rows_f64 stage ({n}, {n}) from A and d, nsl=12 into {npad} columns: "
        f"Ah, slices and scales bit-identical to the twin; kernel {stage['ms']:.4f} ms, plain "
        f"twin {stage['plain_ms']:.4f} ms, bound {stage['bound_ms']:.4f} ms "
        f"({stage['bound_by']}, {100 * stage['bound_ms'] / stage['ms']:.1f}%)")
    return k5


def k5_bound(shape, nsl, rowwise, out_cols):
    """K5's bound: read (hi, mid, lo) f32 and the scales, write nsl int8
    planes at the output row width; ~16 operations for the scaling, the
    TwoSum and the injections and 4 per slice."""
    n = int(np.prod(shape))
    rows = n // shape[-1]
    return bound(12 * n + nsl * rows * (out_cols or shape[-1]) + 4 * (rows if rowwise else 1),
                 n * (16 + 4 * nsl), FP32_FLOP_PER_S)


def slicers_on_path(run, phase, path):
    """Two steps of one path (`run` drives one) with every K4 and K5 launch
    checked: its outputs (slices, scales, and Ah of the K5 matrix stage)
    against the plain stage twin on the same inputs, bit for bit. The first
    step runs with the static-table caches emptied, so the big static tables
    are sliced again; the second is a steady-state step. Then each distinct
    launch signature (shape, strides, alignment, rowwise, nsl, padded width,
    parts) is timed on its first inputs: the stage's device time (calls
    replayed in a CUDA graph), back to back from Python, its plain twin,
    the kernels one call launches and its bound, summed over the steady
    step's launches. Returns the report of each slicer that the path
    launched."""
    import torch
    from sfft_tpu_torch.core import exact_fft, slicing, solve

    launch4 = slicing._launch_pairs
    rows5, vec5 = solve.slice_rows_f64, solve.slice_vec_f64
    inputs = {}
    counts = [{}, {}]
    step = [0]

    def note(sig, same, make):
        assert same, f"{sig[0]} on the {path} path {sig[1:]}: differs from the twin"
        if sig not in inputs:
            inputs[sig] = make()
        counts[step[0]][sig] = counts[step[0]].get(sig, 0) + 1

    def checked4(parts, nsl, Kp, rowwise, scales=None):
        got = launch4(parts, nsl, Kp, rowwise, scales)
        if scales is None:
            ref = slicing.slice_pairs_plain(parts, nsl, Kp, rowwise)
        else:
            ref = [(slicing.slice_pair_plain(h, l, s, nsl), s)
                   for (h, l), s in zip(parts, scales)]
        h = parts[0][0]
        sig = ("slice_pair", tuple(h.shape), tuple(h.stride()), h.data_ptr() % 16 == 0,
               bool(rowwise), nsl, Kp, len(parts), scales is not None)
        same = all(torch.equal(a, b) and torch.equal(s, t) for (a, s), (b, t) in zip(got, ref))
        note(sig, same, lambda: ([(_clone_view(a), _clone_view(b)) for a, b in parts], scales))
        return got

    def checked_rows(A, d, nsl, out_cols=None):
        got = rows5(A, d, nsl, out_cols)
        ref = slicing.slice_rows_f64_plain(A, d, nsl, out_cols)
        sig = ("slice_rows_f64", tuple(A.shape), tuple(A.stride()), A.data_ptr() % 16 == 0,
               True, nsl, out_cols, 1, False)
        note(sig, all(torch.equal(a, b) for a, b in zip(got, ref)),
             lambda: (A.clone(), d.clone()))
        return got

    def checked_vec(x, nsl, out):
        want = out.clone()
        s = vec5(x, nsl, out)
        rs = slicing.slice_vec_f64_plain(x, nsl, want)
        sig = ("slice_vec_f64", tuple(x.shape), tuple(out.shape), True, False, nsl,
               out.shape[1], 1, False)
        note(sig, torch.equal(out, want) and torch.equal(s, rs),
             lambda: (x.clone(), out.clone()))
        return s

    exact_fft._static_slices_for.cache_clear()
    exact_fft._stacked.cache_clear()
    slicing._launch_pairs = checked4
    solve.slice_rows_f64, solve.slice_vec_f64 = checked_rows, checked_vec
    try:
        for step[0] in (0, 1):
            run()
            torch.cuda.synchronize()
    finally:
        slicing._launch_pairs = launch4
        solve.slice_rows_f64, solve.slice_vec_f64 = rows5, vec5
    reports = {}
    for sig, tensors in sorted(inputs.items(), key=lambda kv: str(kv[0])):
        name, shape, strides, aligned, rowwise, nsl, Kp, nparts, given = sig
        if name == "slice_pair":
            parts, scales = tensors
            if given:
                kernel = lambda: slicing.slice_pair(*parts[0], scales[0], nsl)
                twin = lambda: slicing.slice_pair_plain(*parts[0], scales[0], nsl)
            else:
                kernel = lambda: slicing.slice_pairs(parts, nsl, Kp, rowwise)
                twin = lambda: slicing.slice_pairs_plain(parts, nsl, Kp, rowwise)
            bms, by = k4_stage_bound(shape, nparts, nsl, Kp, rowwise)
            big = int(np.prod(shape)) > 2 ** 22
            report = "slice_pair"
        elif name == "slice_rows_f64":
            A, d = tensors
            kernel = lambda: slicing.slice_rows_f64(A, d, nsl, Kp)
            twin = lambda: slicing.slice_rows_f64_plain(A, d, nsl, Kp)
            bms, by = k5_matrix_bound(shape[0], nsl, Kp)
            big = True
            report = "slice_triple"
        else:
            x, buf = tensors
            kernel = lambda: slicing.slice_vec_f64(x, nsl, buf)
            twin = lambda: slicing.slice_vec_f64_plain(x, nsl, buf.clone())
            bms, by = k5_vector_bound(shape[0], nsl, Kp)
            big = False
            report = "slice_triple"
        # the kernels one call launches, from the wrappers' counts
        counters = (slicing.slice_pair.launches + slicing.slice_pair.scale_launches
                    + slicing.slice_triple.launches)
        kernel()
        nk = (slicing.slice_pair.launches + slicing.slice_pair.scale_launches
              + slicing.slice_triple.launches - counters)
        ms = graph_ms(kernel, calls=2 if big else 20, reps=3 if big else 7)
        ems = cuda_ms(kernel, reps=3 if big else 5, inner=3 if big else 10)
        pms = cuda_ms(twin, reps=3 if big else 5, inner=1 if big else 10)
        count = counts[1].get(sig, 0)
        r = reports.setdefault(report, dict(max_abs_err=0.0, ms=0.0, eager_ms=0.0, plain_ms=0.0,
                                            bound_ms=0.0, library_ms=None, bytes_ms=0.0,
                                            first=0, steady=0, kernels=0, signatures=0))
        r["ms"] += count * ms
        r["eager_ms"] += count * ems
        r["plain_ms"] += count * pms
        r["bound_ms"] += count * bms
        r["bytes_ms"] += count * bms * (by == "bytes")
        r["first"] += counts[0].get(sig, 0)
        r["steady"] += count
        r["kernels"] += count * nk
        r["signatures"] += 1
        log(f"phase {phase} {name} on the {path} path {shape} strides {strides} aligned={aligned} "
            f"rowwise={rowwise} nsl={nsl} Kp={Kp} parts={nparts}"
            f"{' given scale' if given else ''}: {counts[0].get(sig, 0)} launches at first use, "
            f"{count} per steady step, all bit-identical to the twin; {nk} kernel(s) a call, "
            f"device {ms:.4f} ms (graph replay), back to back {ems:.4f} ms, plain twin "
            f"{pms:.4f} ms, bound {bms:.4f} ms ({by})")
    for name, r in reports.items():
        r["bound_by"] = "bytes" if 2 * r.pop("bytes_ms") >= r["bound_ms"] else "operations"
        log(f"phase {phase} {name} on the {path} path: {r['first']} stage calls at first use and "
            f"{r['steady']} per steady step ({r['kernels']} kernels), {r['signatures']} "
            f"signatures, all bit-identical to the twins; per steady step device "
            f"{r['ms']:.4f} ms, back to back {r['eager_ms']:.4f} ms, plain twin "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of the device time); no single PyTorch call "
            f"computes it")
    return reports


def _clone_view(t):
    """A copy of t with t's sizes, strides and storage offset (so the same
    layout, alignment and vector width reach the slicer)."""
    import torch

    off = t.storage_offset()
    span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    base = torch.empty(off + span, dtype=t.dtype, device=t.device)
    out = base.as_strided(t.shape, t.stride(), off)
    out.copy_(t)
    return out


def stage_impls():
    """The slicing stages as this checkout has them: (K4 stage, K5 matrix
    stage, K5 vector stage, label), each taking plain=True for its plain
    twin. With the stage entries of core/slicing.py (slice_pairs,
    slice_rows_f64, slice_vec_f64) each stage is the entry; in a checkout
    without them (the older wrapper chain) each stage is the chain that the
    callers ran: _padk, the scale from amax and _pow2ceil_scalar,
    .contiguous() and one K4 launch per part; A * d * d, _split3, the scale
    and K5; _split3, K5, a zeroed (64, Kp) operand and the copy into it."""
    import torch
    from sfft_tpu_torch.core import exact_fft, slicing, solve

    if hasattr(slicing, "slice_pairs"):
        def k4(parts, nsl, Kp, rowwise, plain=False):
            fn = slicing.slice_pairs_plain if plain else slicing.slice_pairs
            return fn(parts, nsl, Kp, rowwise)

        def k5m(A, d, plain=False):
            fn = slicing.slice_rows_f64_plain if plain else slicing.slice_rows_f64
            return fn(A, d, solve._RESID_NSL, A.shape[1] + (-A.shape[1]) % 8)

        def k5v(x, Kp, buf, plain=False):
            fn = slicing.slice_vec_f64_plain if plain else slicing.slice_vec_f64
            return fn(x, solve._RESID_NSL, buf)

        label = "stage"
    else:
        def k4(parts, nsl, Kp, rowwise, plain=False):
            return [exact_fft._slice_pair_real(exact_fft._padk(h, Kp), exact_fft._padk(l, Kp),
                                               nsl, rowwise, plain) for h, l in parts]

        def k5m(A, d, plain=False):
            return solve._sliced_residual_setup(A, d, plain=plain)

        def k5v(x, Kp, buf, plain=False):
            nsl = solve._RESID_NSL
            xsl, sx = exact_fft._slice_triple_real(*solve._split3(x), nsl, plain=plain,
                                                   out_cols=Kp)
            X8 = torch.zeros((64, Kp), dtype=torch.int8, device=x.device)
            X8[:nsl] = xsl
            return X8, sx

        label = "chain"
    return k4, k5m, k5v, label


def device_launches(fn):
    """Kernels and copies one call of fn puts on the device (torch.profiler;
    the most over three profiled calls, as a trace can drop events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages()
                          if str(getattr(e, "device_type", "")).endswith("CUDA")))
    return max(counts)


def k4_stage_bound(shape, nparts, nsl, Kp, rowwise):
    """The K4 stage's bound: per part, 8 bytes in per live element, nsl
    bytes out per padded element and 4 bytes per scale; ~6 operations for
    the TwoSum and 4 per slice."""
    n = int(np.prod(shape))
    rows = n // shape[-1]
    return bound(nparts * (8 * n + nsl * rows * Kp + 4 * (rows if rowwise else 1)),
                 nparts * n * (6 + 4 * nsl), FP32_FLOP_PER_S)


def k5_matrix_bound(n, nsl, ldo):
    """The K5 matrix stage's bound: A (f64) and d in, Ah (f32), nsl int8
    planes of the padded rows and the row scales out; ~30 operations for the
    equilibration, the split, the TwoSum and the injections and 4 per slice."""
    return bound(8 * n * n + 8 * n + 4 * n * n + nsl * n * ldo + 4 * n,
                 n * n * (30 + 4 * nsl), FP32_FLOP_PER_S)


def k5_vector_bound(n, nsl, Kp):
    """The K5 vector stage's bound: x (f64) in, the nsl slice rows of the
    (64, Kp) operand and the scale out (the operand's other rows are zeros
    that a residual need not write)."""
    return bound(8 * n + nsl * Kp + 4, n * (30 + 4 * nsl), FP32_FLOP_PER_S)


def capture_stages(run):
    """Drive one step (`run`) and keep, per slicing-stage signature, the
    inputs of its first call (same layout) and its calls in the step. K4
    stages are taken where the callers hand their operands to the slicer
    (exact_fft._cmatmul_sliced: the producers' views, unpadded), K5 at
    solve._sliced_residual_setup and solve._sliced_matvec."""
    import torch
    from sfft_tpu_torch.core import exact_fft, pexact, solve

    sigs = {}

    def note(sig, make):
        if sig not in sigs:
            sigs[sig] = [make(), 0]
        sigs[sig][1] += 1

    real_cm, real_setup, real_mv = (exact_fft._cmatmul_sliced, solve._sliced_residual_setup,
                                    solve._sliced_matvec)

    def cm(data, W, rowwise=False, real_out=False, prof=None, plain=False):
        nsl = (prof or exact_fft.SliceProfile(exact_fft.NSL_DATA, exact_fft.NSL_STATIC,
                                              exact_fft.KMAX)).nsl_data
        K = W.host().shape[0]
        parts = [(data.rh, data.rl)] + ([] if data.is_real else [(data.ih, data.il)])
        sig = ("K4", tuple(data.rh.shape), tuple(data.rh.stride()),
               data.rh.data_ptr() % 16 == 0, bool(rowwise), nsl, K + (-K) % 8, len(parts))
        note(sig, lambda: [(_clone_view(h), _clone_view(l)) for h, l in parts])
        return real_cm(data, W, rowwise, real_out, prof, plain)

    def setup(A, d, *args, **kw):
        note(("K5 matrix", tuple(A.shape)), lambda: (A.clone(), d.clone()))
        return real_setup(A, d, *args, **kw)

    def mv(Asl_flat, sa, x, *args, **kw):
        note(("K5 vector", tuple(x.shape), Asl_flat.shape[1]), lambda: (x.clone(),))
        return real_mv(Asl_flat, sa, x, *args, **kw)

    exact_fft._cmatmul_sliced = pexact._cmatmul_sliced = cm
    solve._sliced_residual_setup, solve._sliced_matvec = setup, mv
    try:
        run()
        torch.cuda.synchronize()
    finally:
        exact_fft._cmatmul_sliced = pexact._cmatmul_sliced = real_cm
        solve._sliced_residual_setup, solve._sliced_matvec = real_setup, real_mv
    return sigs


def time_stages(sigs, path):
    """Each captured stage signature timed on its captured inputs: device
    time (calls in a CUDA graph, replayed), back-to-back time, the plain
    twins' time, the kernels and copies one call puts on the device, and its
    bound; summed over the step's calls. Returns the per-step sums by stage
    kind and the per-signature rows."""
    import torch

    k4, k5m, k5v, label = stage_impls()
    rows, sums = [], {}
    for sig, (inputs, count) in sorted(sigs.items(), key=lambda kv: str(kv[0])):
        kind = sig[0]
        if kind == "K4":
            _, shape, strides, aligned, rowwise, nsl, Kp, nparts = sig
            call = lambda plain=False: k4(inputs, nsl, Kp, rowwise, plain)
            bms, by = k4_stage_bound(shape, nparts, nsl, Kp, rowwise)
            big = int(np.prod(shape)) > 2 ** 22
        elif kind == "K5 matrix":
            A, d = inputs
            call = lambda plain=False: k5m(A, d, plain)
            n = A.shape[0]
            bms, by = k5_matrix_bound(n, 12, n + (-n) % 8)
            big = True
        else:
            (x,), Kp = inputs, sig[2]
            buf = torch.zeros((64, Kp), dtype=torch.int8, device=x.device)
            call = lambda plain=False: k5v(x, Kp, buf, plain)
            bms, by = k5_vector_bound(x.shape[0], 12, Kp)
            big = False
        ms = graph_ms(call, calls=3 if big else 20, reps=5)
        eager = cuda_ms(call, reps=3 if big else 5, inner=3 if big else 10)
        pms = cuda_ms(lambda: call(True), reps=3 if big else 5, inner=1 if big else 10)
        nlaunch = device_launches(call)
        torch.cuda.synchronize()
        row = dict(sig=[str(v) for v in sig], count=count, ms=ms, eager_ms=eager, plain_ms=pms,
                   launches=nlaunch, bound_ms=bms, bound_by=by)
        rows.append(row)
        s = sums.setdefault(kind, dict(ms=0.0, eager_ms=0.0, plain_ms=0.0, launches=0,
                                       bound_ms=0.0, calls=0, signatures=0))
        for k in ("ms", "eager_ms", "plain_ms", "bound_ms"):
            s[k] += count * row[k]
        s["launches"] += count * nlaunch
        s["calls"] += count
        s["signatures"] += 1
        log(f"stages {path} {label} {sig}: {count} calls per step; device {ms:.4f} ms (graph "
            f"replay), back to back {eager:.4f} ms, plain twins {pms:.4f} ms, {nlaunch} kernels "
            f"and copies per call, bound {bms:.4f} ms ({by})")
    for kind, s in sums.items():
        log(f"stages {path} {label} {kind} per step: {s['calls']} calls, {s['signatures']} "
            f"signatures, {s['launches']} kernels and copies; device {s['ms']:.4f} ms, back to "
            f"back {s['eager_ms']:.4f} ms, plain twins {s['plain_ms']:.4f} ms, bound "
            f"{s['bound_ms']:.4f} ms ({100 * s['bound_ms'] / s['ms']:.1f}% of it)")
    return sums, rows


def phase_stages(I, J, out_dir):
    """--stages: the slicing stages of one steady contract step and one
    steady v2 step, each signature timed on the path's own inputs (see
    time_stages); written to out_dir/stages_<label>.json."""
    import tempfile

    import torch
    from sfft_tpu_torch import BSplinePacket, PureTorchCustomizedPacket, make_config

    os.makedirs(out_dir, exist_ok=True)
    label = stage_impls()[3]
    cfg = make_config(N, N, KERHW, greek_backend="pexact", fdiff_backend="pexact",
                      solver="transformed")
    step = lambda: PureTorchCustomizedPacket.PCP(I, J, I, J, "REF", KERHW, cfg=cfg)
    step()
    report = {"contract": time_stages(capture_stages(step), "contract")}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        ref, sci = write_pair_fits(d)
        v2cfg = nircam_config(**EXACT_TRIO)
        step = lambda: BSplinePacket.BSP(ref, sci, ref, sci, cfg=v2cfg)
        step()
        report["v2"] = time_stages(capture_stages(step), "v2")
    with open(os.path.join(out_dir, f"stages_{label}.json"), "w") as f:
        json.dump(report, f, indent=1)


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
    sol64, diff64, step_s = run_pcp(I, J, cfg, plain=True, reps=1)
    assert bool(torch.isfinite(diff64).all())
    rms = float(torch.sqrt(torch.mean((diff_fast - diff64) ** 2)))
    assert rms < 0.05, f"fast vs f64 difference RMS {rms:.4e} >= 0.05"
    log(f"phase 5 f64 fft/fft/lu on the plain twins: step {step_s * 1e3:.1f} ms; "
        f"RMS(diff_fast - diff_f64) = {rms:.4e} (bound 0.05)")
    # the contract's yardstick: the same f64 tables solved by the refined
    # 'exact' solver. At this conditioning an unrefined f64 LU lands
    # anywhere in the cond * eps64 band in near-null directions (sfft_tpu's
    # bench.py cpu_oracle makes the same choice)
    xcfg = make_config(N, N, KERHW, solver="exact")
    solx, diffx, xstep_s = run_pcp(I, J, xcfg, plain=True, reps=1)
    assert bool(torch.isfinite(diffx).all())
    lu_rms = float(torch.sqrt(torch.mean((diff64 - diffx) ** 2)))
    lu_rel = float((sol64 - solx).abs().max() / solx.abs().max())
    log(f"phase 5 f64 fft/fft/exact on the plain twins: step {xstep_s * 1e3:.1f} ms; "
        f"lu vs exact solver: RMS(diff) = {lu_rms:.3e}, max-rel solution {lu_rel:.3e}")
    return solx, diffx, rms


def phase_contract(I, J, sol64, diff64):
    """The contract path (pexact / pexact / transformed at (8, 7, 6)) with
    the kernels and on the plain twins, then once with the 'exact' solver;
    each held to the f64 fft/fft/exact path."""
    import torch
    from sfft_tpu_torch import make_config
    from sfft_tpu_torch.core import greek, moments, slicing

    cfg = make_config(N, N, KERHW, greek_backend="pexact", fdiff_backend="pexact",
                      solver="transformed")
    assert cfg.NEQ == 1740 and cfg.pexact_prof == (8, 7, 6)
    c = slice(N // 4, 3 * N // 4)
    smax = float(sol64.abs().max())

    def check(name, sol, diff):
        assert sol.shape == (cfg.NEQ,) and diff.shape == (N, N)
        assert bool(torch.isfinite(sol).all()) and bool(torch.isfinite(diff).all())
        rms = float(torch.sqrt(torch.mean(diff[c, c] ** 2)))
        assert 1.3 <= rms <= 1.7, f"{name}: central difference RMS {rms:.4f} outside [1.3, 1.7]"
        drms = float(torch.sqrt(torch.mean((diff - diff64) ** 2)))
        assert drms < 1e-6, f"{name}: RMS(diff - diff_f64) {drms:.3e} >= 1e-6"
        srel = float((sol - sol64).abs().max()) / smax
        assert srel <= 1e-6, f"{name}: max|sol - sol_f64| / max|sol_f64| {srel:.3e} > 1e-6"
        return rms, drms, srel

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    moments.moments.launches = 0
    greek.corr_window.launches = 0
    slicing.slice_pair.launches = slicing.slice_pair.scale_launches = 0
    sol, diff, step_s = run_pcp(I, J, cfg, plain=False, reps=3)
    # K4: its slicing launches and its global-max launches (one source)
    launches = {"moments": moments.moments.launches,
                "corr_window": greek.corr_window.launches,
                "slice_pair": slicing.slice_pair.launches + slicing.slice_pair.scale_launches,
                "slice_pair_scale": slicing.slice_pair.scale_launches}
    peak = torch.cuda.max_memory_allocated()
    assert launches["moments"] > 0 and launches["slice_pair"] > 0, \
        f"a kernel of the contract path never launched: {launches}"
    rms, drms, srel = check("contract", sol, diff)
    log(f"phase 6 contract {N}^2 KerHW={KERHW} pexact/pexact/transformed prof (8, 7, 6): "
        f"median step {step_s * 1e3:.1f} ms over 3 runs; launches {launches} in 4 runs; "
        f"peak memory {peak / 2**30:.2f} GiB; central diff RMS {rms:.4f}; "
        f"RMS(diff - diff_f64) = {drms:.3e} (bound 1e-6); "
        f"max|sol - sol_f64|/max|sol_f64| = {srel:.3e} (bound 1e-6)")
    del sol, diff
    psol, pdiff, plain_s = run_pcp(I, J, cfg, plain=True, reps=3)
    check("contract plain", psol, pdiff)
    log(f"phase 6 same contract path on the plain twins: median step {plain_s * 1e3:.1f} ms")
    del psol, pdiff
    ecfg = make_config(N, N, KERHW, greek_backend="pexact", fdiff_backend="pexact",
                       solver="exact")
    esol, ediff, exact_s = run_pcp(I, J, ecfg, plain=False, reps=1)
    _, edrms, esrel = check("contract exact solver", esol, ediff)
    log(f"phase 6 contract with solver='exact': step {exact_s * 1e3:.1f} ms; "
        f"RMS(diff - diff_f64) = {edrms:.3e}; max|sol - sol_f64|/max = {esrel:.3e}")
    del esol, ediff
    from sfft_tpu_torch import PureTorchCustomizedPacket

    k4 = slicers_on_path(
        lambda: PureTorchCustomizedPacket.PCP(I, J, I, J, "REF", KERHW, cfg=cfg),
        6, "contract")["slice_pair"]
    return launches, step_s, plain_s, peak, drms, srel, k4


def nircam_config(lam=V2_LAMBDA, **backends):
    """The JWST/NIRCam configuration of sfft_tpu's bench.py (bench_bspline)
    at V2_N^2, GKerHW = V2_KERHW: degree-2 B-spline kernel with 2 x 2
    internal knots, SEPARATE-VARYING degree-2 polynomial scaling, degree-0
    background, Tikhonov regularization on 512 points from seed 10086."""
    from sfft_tpu_torch import make_bspline_config

    n = V2_N
    rng = np.random.default_rng(10086)
    xy = np.stack([rng.uniform(10.0, n - 10.0, 512), rng.uniform(10.0, n - 10.0, 512)], axis=1)
    return make_bspline_config(
        n, n, V2_KERHW, KerSpType="B-Spline", KerSpDegree=2,
        KerIntKnotX=[0.5 + n / 3, 0.5 + n * 2 / 3], KerIntKnotY=[0.5 + n / 3, 0.5 + n * 2 / 3],
        SEPARATE_SCALING=True, ScaSpType="Polynomial", ScaSpDegree=2,
        BkgSpType="Polynomial", BkgSpDegree=0,
        REGULARIZE_KERNEL=True, XY_REGULARIZE=xy, LAMBDA_REGULARIZE=lam, **backends)


EXACT_TRIO = dict(greek_backend="exact", fdiff_backend="exact", solver="exact")


def write_pair_fits(d):
    """The generator's pair at V2_N^2 as FITS files in directory d."""
    from sfft_tpu_torch.io import fits

    I, J = make_pair(V2_N)
    ref, sci = os.path.join(d, "ref.fits"), os.path.join(d, "sci.fits")
    fits.write(ref, I.T)
    fits.write(sci, J.T)
    return ref, sci


def run_bsp(ref, sci, cfg, plain, reps, **out):
    """One warm-up and `reps` timed calls of BSplinePacket.BSP (FITS in,
    arrays out; masked == unmasked); returns (solution, difference, median
    seconds)."""
    import torch
    from sfft_tpu_torch import BSplinePacket

    times = []
    for k in range(reps + 1):
        t0 = time.perf_counter()
        sol, diff = BSplinePacket.BSP(ref, sci, ref, sci, cfg=cfg, plain=plain, **out)
        torch.cuda.synchronize()
        if k:
            times.append(time.perf_counter() - t0)
    return sol, diff, statistics.median(times)


def phase_v2():
    """The v2 engine's contract path (exact / exact / exact on the NIRCam
    configuration) through BSplinePacket.BSP, with the kernels and on the
    plain twins, held to the f64 fft/fft/lu path of the same configuration;
    every K4 and K5 launch of a step held to its twin; the sliced route of
    the large solve held to its f64-matvec route on the path's own system."""
    import tempfile

    import torch
    from sfft_tpu_torch import BSplinePacket, read_bspline_solution_fits
    from sfft_tpu_torch.core import greek, moments, slicing, solve
    from sfft_tpu_torch.io import fits

    n = V2_N
    c = slice(n // 4, 3 * n // 4)
    counters = {"moments": moments.moments, "corr_window": greek.corr_window,
                "slice_pair": slicing.slice_pair, "slice_triple": slicing.slice_triple}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ref, sci = write_pair_fits(d)
        log(f"phase 7 pair {n}^2 made and written to FITS in {time.perf_counter() - t0:.1f} s")

        # first use (kernels and static tables warm up here). An f32
        # Cholesky factor that breaks down gives an all-NaN solution; the
        # documented recovery is a larger lambda, never another solver
        for lam in (V2_LAMBDA, 10 * V2_LAMBDA, 100 * V2_LAMBDA):
            cfg = nircam_config(lam, **EXACT_TRIO)
            assert cfg.NEQ == V2_NEQ and cfg.scaling_mode == "SEPARATE-VARYING", cfg.NEQ
            t0 = time.perf_counter()
            sol, _ = BSplinePacket.BSP(ref, sci, ref, sci, cfg=cfg)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            if np.isfinite(sol).all():
                break
            log(f"phase 7 v2: FINDING: the f32 Cholesky factor of the equilibrated system "
                f"broke down at lambda = {lam:g} (all-NaN solution); raising lambda")
        else:
            raise AssertionError("the f32 factor broke down at every lambda tried")

        # the main path: counts set to 0 just before, read just after
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for f in counters.values():
            f.launches = 0
        slicing.slice_pair.scale_launches = 0
        sol, diff, step_s = run_bsp(ref, sci, cfg, plain=False, reps=3)
        launches = {k: f.launches for k, f in counters.items()}
        launches["slice_pair_scale"] = slicing.slice_pair.scale_launches
        launches["slice_pair"] += launches["slice_pair_scale"]
        peak = torch.cuda.max_memory_allocated()
        assert launches["slice_pair"] > 0 and launches["slice_triple"] > 0, \
            f"a kernel of the v2 path never launched: {launches}"
        assert sol.shape == (cfg.NEQ,) and diff.shape == (n, n)
        assert np.isfinite(sol).all() and np.isfinite(diff).all()
        rms = float(np.sqrt(np.mean(diff[c, c] ** 2)))
        assert 1.3 <= rms <= 1.7, f"v2: central difference RMS {rms:.4f} outside [1.3, 1.7]"

        # the f64 yardstick: the same configuration through fft / fft / lu
        ycfg = nircam_config(lam)
        assert (ycfg.greek_backend, ycfg.fdiff_backend, ycfg.solver) == ("fft", "fft", "lu")
        ysol, ydiff, y_s = run_bsp(ref, sci, ycfg, plain=True, reps=1)
        assert np.isfinite(ydiff).all()
        smax = float(np.abs(ysol).max())

        def against_yardstick(name, s, dd):
            drms = float(np.sqrt(np.mean((dd - ydiff) ** 2)))
            srel = float(np.abs(s - ysol).max()) / smax
            assert drms < 1e-6, f"{name}: RMS(diff - diff_f64) {drms:.3e} >= 1e-6"
            assert srel <= 1e-6, f"{name}: max|sol - sol_f64| / max|sol_f64| {srel:.3e} > 1e-6"
            return drms, srel

        drms, srel = against_yardstick("v2", sol, diff)
        log(f"phase 7 v2 {n}^2 GKerHW={V2_KERHW} B-spline NIRCam configuration, lambda={lam:g}, "
            f"exact/exact/exact NEQ={cfg.NEQ} through BSplinePacket.BSP: first call "
            f"{first_s:.1f} s; median step {step_s * 1e3:.1f} ms over 3 runs; launches "
            f"{launches} in 4 runs; peak memory {peak / 2**30:.2f} GiB; central diff RMS "
            f"{rms:.4f}; f64 fft/fft/lu yardstick step {y_s * 1e3:.1f} ms; RMS(diff - diff_f64) "
            f"= {drms:.3e} (bound 1e-6); max|sol - sol_f64|/max|sol_f64| = {srel:.3e} "
            f"(bound 1e-6)")

        # the same path on the plain twins
        psol, pdiff, plain_s = run_bsp(ref, sci, cfg, plain=True, reps=3)
        pdrms, psrel = against_yardstick("v2 plain", psol, pdiff)
        kdiff = float(np.abs(psol - sol).max()) / smax
        log(f"phase 7 same v2 path on the plain twins: median step {plain_s * 1e3:.1f} ms; "
            f"RMS(diff - diff_f64) = {pdrms:.3e}; max-rel solution {psrel:.3e}; kernels vs "
            f"twins max-rel solution {kdiff:.3e}")
        del psol, pdiff

        # the FITS products: the difference and the solution read back
        dpath, spath = os.path.join(d, "diff.fits"), os.path.join(d, "solution.fits")
        fsol, fdiff = BSplinePacket.BSP(ref, sci, ref, sci, cfg=cfg, FITS_DIFF=dpath,
                                        FITS_Solution=spath)
        rsol, rcfg = read_bspline_solution_fits(spath)
        assert np.array_equal(rsol, fsol) and rcfg.NEQ == cfg.NEQ
        assert rcfg.kernel_basis == cfg.kernel_basis and rcfg.scaling_basis == cfg.scaling_basis
        assert np.array_equal(fits.getdata(dpath).T, fdiff)
        log(f"phase 7 v2 FITS products: difference and solution ({rsol.size} dofs, bases and "
            f"knots in the header) read back identical")
        del fsol, fdiff

        # every K4 and K5 launch of a step against its twin; the second
        # step also records the solve's own system and refinement
        real_solve = solve._refined_solve_f64
        seen = []

        def recording(A, b, **kw):
            info = {}
            x = real_solve(A, b, info=info, **kw)
            seen.append((A.clone(), b.clone(), info, x))
            del seen[:-1]
            return x

        solve._refined_solve_f64 = recording
        try:
            slicers = slicers_on_path(
                lambda: BSplinePacket.BSP(ref, sci, ref, sci, cfg=cfg), 7, "v2")
        finally:
            solve._refined_solve_f64 = real_solve
    assert seen, "the v2 path did not reach _refined_solve_f64"
    A, b, info, x_path = seen.pop()
    assert tuple(A.shape) == (V2_SOLVE_N, V2_SOLVE_N), tuple(A.shape)
    assert info["factor_ok"] and bool(torch.isfinite(x_path).all()), info
    log(f"phase 7 v2 solve on the path: system {tuple(A.shape)}, f32 Cholesky factor ok, "
        f"{info['steps']} refinement steps, |r|/|b| = {info['rel_residual']:.3e}, no NaN")

    # sliced residuals against f64-matvec residuals on the path's own system
    routes = {}
    for name, kw in [("sliced", {}), ("f64_matvec", dict(_f64_matvec=True))]:
        ts = []
        for _ in range(3):
            rinfo = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = solve._refined_solve_f64(A, b, info=rinfo, **kw)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        assert rinfo["factor_ok"] and bool(torch.isfinite(x).all()), (name, rinfo)
        routes[name] = (x, rinfo, statistics.median(ts))
    xs, xm = routes["sliced"][0], routes["f64_matvec"][0]
    rrel = float((xs - xm).abs().max() / xm.abs().max())
    prel = float((xs - x_path).abs().max() / xm.abs().max())
    assert prel <= 1e-12, f"the sliced route off the path vs on it: max-rel {prel:.3e} > 1e-12"
    assert rrel <= 1e-9, f"sliced vs f64-matvec route: max-rel {rrel:.3e} > 1e-9"
    log("phase 7 v2 _refined_solve_f64 routes on the path's system: " + "; ".join(
        f"{name} {r[2] * 1e3:.1f} ms (median of 3), {r[1]['steps']} steps, |r|/|b| = "
        f"{r[1]['rel_residual']:.3e}" for name, r in routes.items())
        + f"; max-rel difference of the solutions {rrel:.3e} (bound 1e-9)")

    # one residual each way (the matrix of the sliced route as the solve
    # holds it: 12 int8 planes against 1.4 GB of f64)
    d_eq = solve._equilibrate(A)
    _, Asl, sa = solve._sliced_residual_setup(A, d_eq)
    As = A * d_eq[:, None] * d_eq[None, :]
    xv = routes["sliced"][0] / d_eq
    mv_sliced = cuda_ms(lambda: solve._sliced_matvec(Asl, sa, xv), reps=3, inner=3)
    mv_f64 = cuda_ms(lambda: As @ xv, reps=3, inner=3)
    mrel = float((solve._sliced_matvec(Asl, sa, xv) - As @ xv).abs().max() / (As @ xv).abs().max())
    log(f"phase 7 v2 one residual product ({V2_SOLVE_N} dofs): sliced int8 "
        f"{mv_sliced:.3f} ms, f64 matvec {mv_f64:.3f} ms; max-rel difference {mrel:.3e}")
    return dict(launches=launches, step_s=step_s, plain_s=plain_s, first_s=first_s, peak=peak,
                drms=drms, srel=srel, rms=rms, lam=lam, yardstick_s=y_s, slicers=slicers,
                steps=info["steps"], rel_residual=info["rel_residual"],
                route_ms={k: r[2] * 1e3 for k, r in routes.items()},
                route_steps={k: r[1]["steps"] for k, r in routes.items()}, route_rel=rrel,
                residual_ms=dict(sliced=mv_sliced, f64_matvec=mv_f64))


def phase_steady(I, J, pairs):
    """--steady: the fast slice at steady state, kernels (K) against plain
    twins (P), in pairs of alternating order."""
    import torch
    from sfft_tpu_torch import PureTorchCustomizedPacket, make_config

    cfg = make_config(N, N, KERHW, greek_backend="peeled", fdiff_backend="fft32",
                      solver="refined")

    def step(plain):
        t0 = time.perf_counter()
        PureTorchCustomizedPacket.PCP(I, J, I, J, "REF", KERHW, cfg=cfg, plain=plain)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for plain in (False, True, False, True):
        step(plain)
    tk, tp = [], []
    for k in range(pairs):
        order = (False, True) if k % 2 == 0 else (True, False)
        got = {plain: step(plain) for plain in order}
        tk.append(got[False])
        tp.append(got[True])
    faster = sum(a < b for a, b in zip(tk, tp))
    log(f"steady fast slice {N}^2: median step {statistics.median(tk) * 1e3:.2f} ms with the "
        f"kernels, {statistics.median(tp) * 1e3:.2f} ms on the plain twins, over {pairs} "
        f"alternating pairs after 2 warm-ups each; kernels faster in {faster} of {pairs}")
    del I, J
    torch.cuda.empty_cache()

    # what the step pays for on the host: the time the K3 and K1 wrappers take
    # to enqueue one call at the slice's shapes (the device runs behind)
    calls = slice_kernel_calls()
    host = {}
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        windows = []
        for _ in range(7):
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            windows.append((time.perf_counter() - t0) / 20 * 1e6)
            torch.cuda.synchronize()
        host[name] = statistics.median(windows)
    log("steady host time to enqueue one wrapper call (median of 7 windows of 20): "
        + ", ".join(f"{k} {v:.1f} us" for k, v in host.items()))
    # and on the device: each wrapper call timed both ways, so that two
    # commits can be compared on one clock
    for name, fn in calls.items():
        log(f"steady {name}: {graph_ms(fn, calls=20 if name == 'K3' else 5):.4f} ms device "
            f"time (calls in a CUDA graph, replayed), {cuda_ms(fn):.4f} ms back to back from "
            f"Python")


def slice_kernel_calls():
    """The fast slice's three kernel calls on seeded inputs of its shapes:
    K3 (8, N) x (N, N) f64, K1 c64 on the OMG and the THE window."""
    import torch
    from sfft_tpu_torch.core import greek, moments

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    W = torch.randn((8, N), dtype=torch.float64, device=dev, generator=g)
    G = torch.randn((N, N), dtype=torch.float64, device=dev, generator=g)
    specs = torch.fft.rfft2(30.0 * torch.randn((7, N, N), dtype=torch.float32, device=dev,
                                               generator=g))
    specJ, specF = specs[0:1], specs[1:]
    return {
        "K3": lambda: moments.moments(W, G),
        "K1 omg": lambda: greek.corr_window_fft(specF, specF, N, N, 2 * KERHW, 2 * KERHW,
                                                method="kernel", symmetric=True),
        "K1 the": lambda: greek.corr_window_fft(specF, specJ, N, N, KERHW, KERHW,
                                                method="kernel"),
    }


def phase_kernel_profile(out_dir):
    """torch.profiler over three calls of K3 and of K1's two c64 windows at
    the fast slice's shapes: device time per kernel name (K1's two stages
    and the mirror's glue apart). The table goes to out_dir too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    each = slice_kernel_calls()

    def calls():
        for fn in each.values():
            fn()

    calls()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            calls()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    kernels = [e for e in ev if str(getattr(e, "device_type", "")).endswith("CUDA")]
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        log(f"kernel profile: {e.key[:90]:90s} {dev_us(e) / e.count / 1e3:9.4f} ms x{e.count}")
    with open(os.path.join(out_dir, "profile_kernels.txt"), "w") as f:
        f.write(ev.table(sort_by="self_cuda_time_total", row_limit=40, max_name_column_width=120))


def phase_profile(I, J, out_dir):
    """--profile: torch.profiler over one step of each path (after two
    warm-ups; the v2 path's step is one BSplinePacket.BSP call on FITS
    files in a temporary directory): device busy time (kernels and copies), idle share of the
    profiled wall, and the top operations by device and by host time. The
    full tables go to out_dir/profile_<path>.txt."""
    import torch
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    from sfft_tpu_torch import BSplinePacket, PureTorchCustomizedPacket, make_config

    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.TemporaryDirectory()
    ref, sci = write_pair_fits(tmp.name)
    v2cfg = nircam_config(**EXACT_TRIO)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    def on_device(e):
        # kernels and copies carry the device type; the host operators that
        # launched them report the same time again
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    def pcp(**backends):
        cfg = make_config(N, N, KERHW, **backends)
        return lambda: PureTorchCustomizedPacket.PCP(I, J, I, J, "REF", KERHW, cfg=cfg)

    paths = {
        "contract": pcp(greek_backend="pexact", fdiff_backend="pexact", solver="transformed"),
        "fast": pcp(greek_backend="peeled", fdiff_backend="fft32", solver="refined"),
        "v2": lambda: BSplinePacket.BSP(ref, sci, ref, sci, cfg=v2cfg),
    }
    for name, step in paths.items():
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        ev = prof.key_averages()
        kernels = [e for e in ev if on_device(e)]
        busy = sum(dev_us(e) for e in kernels) / 1e6
        cat = sum(dev_us(e) for e in kernels if "CatArrayBatchedCopy" in e.key) / 1e3
        log(f"profile {name}: wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms in "
            f"{sum(e.count for e in kernels)} kernels and copies, idle share "
            f"{1 - busy / wall:.3f}; concatenation copies {cat:.2f} ms; peak memory "
            f"{peak / 2**30:.2f} GiB")
        for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
            log(f"profile {name} device: {e.key[:60]:60s} {dev_us(e) / 1e3:9.2f} ms "
                f"x{e.count}")
        for e in sorted(ev, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
            log(f"profile {name} host: {e.key[:60]:60s} {e.self_cpu_time_total / 1e3:9.2f} ms "
                f"x{e.count}")
        with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
            f.write(ev.table(sort_by="self_cuda_time_total", row_limit=80))
    tmp.cleanup()


USAGE = ("usage: chip_smoke.py [--profile OUT_DIR | --steady PAIRS | --kernels OUT_DIR | "
         "--slicers OUT_DIR | --stages OUT_DIR]")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import sfft_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = phase_device()
    phase_build()
    ok_line = json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}})
    if sys.argv[1:2] in (["--kernels"], ["--slicers"]):
        if len(sys.argv) != 3:
            print(USAGE, file=sys.stderr)
            return 2
        if sys.argv[1] == "--kernels":
            phase_k3()
            phase_k1()
            phase_kernel_profile(sys.argv[2])
        else:
            rng = np.random.default_rng(6)
            phase_stage_checks(rng)
            phase_k5(rng)
        log(smi)
        print(ok_line, flush=True)
        return 0
    if sys.argv[1:2] in (["--profile"], ["--steady"], ["--stages"]):
        if len(sys.argv) != 3:
            print(USAGE, file=sys.stderr)
            return 2
        I, J = (torch.as_tensor(a, device="cuda") for a in make_pair(N))
        if sys.argv[1] == "--profile":
            phase_profile(I, J, sys.argv[2])
        elif sys.argv[1] == "--stages":
            phase_stages(I, J, sys.argv[2])
        else:
            phase_steady(I, J, int(sys.argv[2]))
        log(smi)
        print(ok_line, flush=True)
        return 0
    report = phase_kernels()
    t0 = time.perf_counter()
    I, J = make_pair(N)
    dev = torch.device("cuda")
    I = torch.as_tensor(I, device=dev)
    J = torch.as_tensor(J, device=dev)
    log(f"phase 4 pair {N}^2 made and uploaded in {time.perf_counter() - t0:.1f} s")
    diff_fast, launches, step_s, plain_s = phase_slice(I, J)
    sol64, diff64, rms64 = phase_f64(I, J, diff_fast)
    del diff_fast
    c_launches, c_step_s, c_plain_s, c_peak, c_drms, c_srel, report["slice_pair"] = \
        phase_contract(I, J, sol64, diff64)
    del I, J, sol64, diff64
    torch.cuda.empty_cache()
    v2 = phase_v2()
    report["slice_triple"] = v2["slicers"]["slice_triple"]
    v2_k4 = v2["slicers"]["slice_pair"]
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules), "jax imported"

    kernels = []
    for name, source, replaces in [
        ("moments", "sfft_tpu_torch/csrc/moments.cu", "sfft_tpu/core/pallas_moments.py:143"),
        ("corr_window", "sfft_tpu_torch/csrc/corr_window.cuh", "sfft_tpu/core/greek.py:94"),
        ("slice_pair", "sfft_tpu_torch/csrc/slice_pair.cu", "sfft_tpu/core/pallas_slice.py:135"),
        ("slice_triple", "sfft_tpu_torch/csrc/slice_triple.cu",
         "sfft_tpu/core/pallas_slice.py:214"),
    ]:
        # launches: the sum over the main paths' runs (fast, contract, v2);
        # times: K3 and K1 alone at the fast slice's shapes, K4 summed over
        # a steady contract step's launches, K5 over a steady v2 step's
        r = report[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=(launches.get(name, 0) + c_launches.get(name, 0)
                                      + v2["launches"][name]),
                            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    log(json.dumps({"slice_step_ms": step_s * 1e3, "slice_step_plain_ms": plain_s * 1e3,
                    "fast_vs_f64_rms": rms64, "contract_step_ms": c_step_s * 1e3,
                    "contract_step_plain_ms": c_plain_s * 1e3,
                    "contract_peak_bytes": c_peak, "contract_vs_f64_rms": c_drms,
                    "contract_vs_f64_sol_rel": c_srel,
                    "contract_launches_per_step": {k: v / 4 for k, v in c_launches.items()},
                    "v2_step_ms": v2["step_s"] * 1e3, "v2_step_plain_ms": v2["plain_s"] * 1e3,
                    "v2_first_call_s": v2["first_s"], "v2_yardstick_step_ms":
                    v2["yardstick_s"] * 1e3, "v2_lambda": v2["lam"],
                    "v2_peak_bytes": v2["peak"], "v2_vs_f64_rms": v2["drms"],
                    "v2_vs_f64_sol_rel": v2["srel"], "v2_central_rms": v2["rms"],
                    "v2_launches_per_step": {k: v / 4 for k, v in v2["launches"].items()},
                    "v2_refinement_steps": v2["steps"], "v2_rel_residual": v2["rel_residual"],
                    "v2_solve_route_ms": v2["route_ms"], "v2_solve_route_steps":
                    v2["route_steps"], "v2_solve_routes_rel": v2["route_rel"],
                    "v2_residual_ms": v2["residual_ms"],
                    "v2_k4_per_step": {k: v2_k4[k] for k in ("ms", "eager_ms", "plain_ms",
                                                             "bound_ms", "steady", "kernels",
                                                             "signatures")},
                    "k5_alone": report["slice_triple_alone"],
                    "k1_calls": {k: report["corr_window"][k]
                                 for k in ("omg", "the", "omg_general", "c128_omg")},
                    "k3_eager_ms": {k: report["moments"][k]
                                    for k in ("eager_ms", "library_eager_ms")},
                    "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(ok_line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
