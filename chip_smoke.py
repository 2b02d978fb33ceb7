#!/usr/bin/env python3
"""Smoke run of the sfft_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from sfft_tpu_torch/csrc, holds each
against its plain PyTorch twin on the card (K3 moments, K1 windowed
correlation, K2 fused model spectrum; K4 and K5 integer slicers, K7, the
epilogue of the sliced int8 products, and K6, the exact paths' pair
products (K6a pair_products, K6m pair_model, K6p the polynomial-plane stage
in its three modes pair_poly, pair_poly_sub, pair_poly_add64), bit for
bit),
then drives the port's paths at full size. On a 4096^2 pair (the benchmark pair's generator),
KerHW=8, poly2/poly2 (NEQ = 1740), through PureTorchCustomizedPacket.PCP ->
GeneralSFFT.GSS:

  * the 'fast' slice (peeled tables, fft32 difference, refined solve), which
    runs K3, K1 and K2;
  * the 'contract' path (pexact tables and difference at pexact_prof
    (8, 7, 6), transformed solve; what sfft_tpu runs on the TPU), which runs
    K3, K4, K7 and K6 (K6a, K6m, and K6p in its sub and add64 modes, three
    launches a step); and once with the 'exact' solver.

And on a 900^2 pair of the same generator, written to FITS, through
BSplinePacket.BSP -> GeneralSFFT.GSS:

  * the v2 (B-spline) engine's contract path on the JWST/NIRCam
    configuration of sfft_tpu's bench.py (GKerHW=11, degree-2 B-spline
    kernel with 2 x 2 internal knots, SEPARATE-VARYING degree-2 polynomial
    scaling, degree-0 background, Tikhonov lambda = 3e-5 on 512 seeded
    points: NEQ = 13226) with the exact / exact / exact backends, which runs
    K4 and K7 (every sliced product of the exact engine), K6a and K6m (its
    pair products and model spectrum) and K5 (the sliced residuals of the
    large f64 solve). The NIRCam image pair itself is not
    in the repository; the generated pair stands in for it.

and, on the same 900^2 pair and configuration, the two v2 fast modes:

  * fft32 / fft32 / refined (greek 'fft32': K1 in c64 at the v2 widths;
    the fft32 difference: K2);
  * peeled / fft32 / refined with f32 fluctuations (the piecewise peel of
    core/peel_pw.py, whose f64 products run K3 and whose fluctuation
    windows run K1; K2);

each held to the v2 f64 fft/fft/lu difference within the fast bound (RMS
< 0.05) or, where the mode's plain twins are farther than that (the fft32
mode's own f32 error on this system), no farther than the twins; K3, K1 and
K2 held to their twins on each mode's own operands; and then the NIRCam
post-processing on the peeled mode's solution (matching kernels on the tile
grid, BSplineDeCorrelation.BDC kernels from Gaussian PSFs made here,
BSplineGridConvolve.GSVC of the difference), on the card and on the CPU
within 1e-9. The fast slice runs K2 too (K3, K1, K2), its difference is
held to the f64 one with K2 and with K2's twin, and its K3, K1 and K2 calls
to their twins on the path's own operands.

Then phase 10, the automatic pipelines, on pairs made here from seeds and
written to FITS: EasySparsePacket.ESP on a DECam CCD (2046 x 4094, 2,500
stars, 8 galaxies, a transient, FWHM 3.2 / 4.1 px, PostAnomalyCheck) and
EasyCrowdedPacket.ECP on a TESS CCD (2048 x 2048, 20,000 stars, saturated
at 28000, MaskSatContam: GSS's contamination route). Each packet's prep
runs once on the host (numpy and the native C++ extension, which must
load); its subtraction then runs five times on the card: the default trio
(fft / fft / lu: K1 and K2 in complex128) with the kernels and on the
plain twins; the contract trio (pexact / pexact / exact at (8, 7, 6): K3,
K4, K6, K7) with the kernels, held to f64 fft / fft / exact on the plain
twins (RMS < 1e-6, solution within 1e-6 of its maximum); and fft / fft /
exact with the kernels (K1, K2), held to the same run on the twins
(difference within 1e-8 max|J|, solution within 1e-6). The default trio's
unrefined LU is not reproducible to those bounds on these systems (the
sparse one's condition number is ~1e18), so its two runs are reported
beside their distances from the refined solve. All runs must make the
same decisions (ConvdSide, KerHW, sub-sources, active pixels,
Post-Anomaly count; the NaN and contamination masks, which may differ only
at ties of the -0.001 threshold), write a difference FITS that reads back
equal, and leave a difference at the pair's noise level; every K1 and K2
launch of a default run and every K4, K6 and K7 launch of a contract run is
held to its twin on the path's operands, and one run of each trio is
profiled. Last, the contract trio on the golden sparse pair of tests/data
at pexact_prof (8, 7, 6) (reported: it misses the contract bound on that
masked system) and (10, 9, 8) (held to the bound).

Then phase 11, the survey entry points (sfft_tpu_torch.parallel, serve):
MultiEasySparsePacket.MESP on four DECam tasks (phase 10's pair, two more
seeds of its generator, and a pair whose SCI FITS has another shape) with
two prep threads and one subtract worker: statuses {2, 2, 2, -1}, task 0
bit for bit phase 10's single ESP call (decisions, solution, difference
FITS), every difference at its noise, K1 and K2 launched; each task's prep
and subtraction seconds, the subtractions again with no prep thread
running, and the overlap share 1 - wall / (sum prep + sum subtract); the
upload time of one pair's four planes from pinned memory; batched_subtract
on the OK tasks from the prep products MESP left, each pair bit for bit its
MESP result; an EngineServer on the card in a thread of this process,
driven by a client process that never initialises CUDA (warm, the 4096^2
pair in fast mode bit for bit phase 4's step, task 0's planes under the
contract trio bit for bit phase 10's contract run with K3, K4, K6 and K7
launched, apply-only, a float32 difference, mismatched masks refused while
ping answers), then a fresh daemon spawned by ensure_server, whose time to
first difference is printed beside the warm server's; and the solvers
'host' and 'blocked_cho' on the 4096^2 pair's f64 fft / fft tables, within
1e-6 of the refined 'exact' solve.

Then phase 12, the multi-device layer (sfft_tpu_torch.parallel.sharded_fft
and multihost), on the card named 4 or 8 times as the device list (every
row block and every exchange on one card): (12a) sharded_fft2 in c128 at
4096^2 over 4 and 8 blocks within 1e-12 of max of torch.fft.fft2, the
rfft2 / irfft2 round trip, the bytes the exchanges move and their copy
rate; (12b) sharded_exact_fft2_pair at 4096^2, half False and True, over 4
blocks within 1e-13 of max of exact_fft2_pair (and whether bit for bit),
with its K4, K7 and K6a launches; (12c) sharded_subtract_step on the four
engine families of __graft_entry__.py (fft/lu, contract-exact, pexact,
bspline-v2) at 128^2 over 8 blocks on its seed-77 pair (difference within
1e-7 of the local step), then fft/lu, contract-exact and pexact at 4096^2
(KerHW 8, poly2/poly2) and the NIRCam v2 configuration at 900^2 over 4
blocks: the normal system within 1e-12 of max of the local step's, the
difference within 1e-8 max|J| and the solution within 1e-6 of max, or for
the unrefined LU no farther than it lands from the refined solve on the
same tables (ROADMAP fault 3; both printed), with each step's wall, device
busy time and peak memory, local and sharded; (12d) two processes on the
card joined over gloo on localhost run run_survey_multihost on 6 fast
4096^2 tasks: each returns exactly its slab, every solution and difference
bit for bit this process's batched_subtract of the same pairs; a worker
that fails or outlives its timeout fails the phase.

Then phase 13, the FFT-free f64 route (greek 'corr' on K8, fdiff 'conv'
on K9), the host utility on K9 and the int16 upload: the evidence that
both kernels run on the FP64 tensor cores (DMMA and DFMA counts in the
built library's SASS, registers and spills from the build's ptxas report;
"not available" without cuobjdump; printed after 13c, the SASS dump running
under it); (13a) K8 on the
4096^2 step's Comg, Cgam and Cthe tables and the NIRCam v2 Comg and Pbs
tables, each within 1e-12 of its twin's max and bit for bit across two
launches, and the 4096^2 tables within 1e-12 of the f64 fft route's (K1
c128); (13b) K9 on the 4096^2 difference and the v2 one with its scaling
planes, and convolve2d on a 2046 x 4094 image with a 31 x 31 kernel in
each boundary mode and with NaN interpolation, each within 1e-12 of the
same call on K9's twin (time, bound, twin and grouped F.conv2d); (13c) the
main paths: PCP at 4096^2 with corr / conv / exact, held to fft / fft /
exact on the same pair (difference RMS < 1e-6, solution within 1e-6 of
max; corr / conv / lu printed beside it), fdiff_conv held to fdiff_fft on
one solution (1e-10 max|J|), and BSP on the NIRCam configuration with
corr / conv / exact held to its fft / fft / lu path as phase 7 holds the
exact one; each launching K8 and K9 (and K5 on v2), with wall, busy
time, idle share and the difference's noise level; (13d)
batched_subtract_packed on two fast 4096^2 pairs bit for bit
batched_subtract on the dequantized planes, with the upload of one pair
packed and in f64.

Then phase 14, the leading pair axis (core/engine.solve_and_subtract_
batched_fn: one set of the config's kernel launches and one pass of the
table algebra for a batch of pairs): the fast mode and the default trio at
4096^2 (KerHW 8, poly2 / poly2) for B = 1, 2, 4, 8 pairs (make_pair, seeds
40-47), the contract trio for B = 1, 2, 4, the polynomial exact trio for
B = 1, 2, and on the NIRCam configuration at 900^2 (seeds 40-47) the
default trio (B-spline bases) for B = 1, 2, the v2 fast trio (fft32 /
fft32 / refined) for B = 1, 2, 4 and the v2 contract (exact / exact /
exact) for B = 1, 2 on one card, each pair's solution and difference bit
for bit its single call, from stacks on the card and through
batched_subtract from host stacks; per pair wall (median of 3) and device
busy, launches a step (K5 once a pair's solve) and peak memory for each
B; every K3, K1 and K2 launch of one batched step (B = 4 fast, 2 the
others) held to its twin as phase 12c holds them, every K4, K5, K7 and K6
launch of the contract and exact trios' to its twin bit for bit, each
twice bit-equal, and each pair's share of it bit for bit the pair's own
launch; one pair of the contract and exact trios held to their f64 paths
(phases 6 and 7's bounds); the single step (the batched step of one pair,
which the survey paths' groups of one pair a device run) against the
batched step called on one pair, in alternating order; batched_subtract's
memory bound (max_batch) on the card, and 3 pairs at a lowered bound of 2
run as 2 batched steps, each pair bit for bit its single call.

Each path is driven with the launch counts set to 0 just before it and read
just after, and must have launched its kernels. The contract and the v2
step run once more with K7 alone on its twin and once with K6 alone on its
twins, which must give the same bits (solution and difference), and once
under the profiler (busy time, launches, idle share). Two more steps of the contract path and of the v2
path, the first with the static-table caches emptied, hold every launch of
the K4 and K5 slicing stages of the step (the static tables' and the
data's, on the views, depths and padded widths the path gives them) and
every K7 and K6 launch of the second (steady) step bit for bit against
the twins on the same inputs (slices, scales, the f32 matrix of the K5
setup, the pair planes of K7 and K6), and time each stage and kernel and
its twin on each distinct launch's inputs. The v2 path is held to the f64 fft/fft/lu
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

builds the kernels and times (median of three steps) and profiles one step
of each path (contract, fast, v2, v2-fast-fft32, v2-fast-peeled) instead
(device busy time, idle share, top operations; the full tables go to
OUT_DIR); then splits the contract and the v2 step's device time by
function (SPLIT: K7, K6's pair products and kernels, the K4 stage, the
int8 products, concatenation copies, the solve, the rest) and counts K6's
bound. It runs in
a checkout of an older commit too (copy the script into it), which is how
parent and change compare on one card.

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
checks and timings of K3, K1 (also at the v2 fast widths; each c64 call
also against the c128 twin on its spectra widened, whose time is K1's
library call, and stage 1's DMMA and DFMA counted in the SASS), K2, K7 and K6 (with a
profile of K3, K1 and K2 at the fast slice's shapes and K2 at the v2 ones:
device time of each stage by kernel name), or of the K4 and K5 slicing
stages, alone.

    python3 chip_smoke.py --fidelity

runs the fast slice and the v2-fast-fft32 mode alone and prints each one's
RMS(diff - diff_f64) with the kernels, on the plain twins, with one kernel
at a time on its twin, and (v2) with the f32 tables assembled and solved in
f64; it runs in a checkout of an older commit too (copy the script into
it), which is how a change to a kernel's summation order is followed across
commits in one call.

    python3 chip_smoke.py --easy

builds the kernels and runs phase 10 (the automatic pipelines) alone.

    python3 chip_smoke.py --survey

builds the kernels and runs phase 11 alone (its references, phase 10's
single ESP calls and phase 4's fast step, are run first), with the heavier
parts: MESP(MESH_BATCH=True) on the same queue, each task bit for bit its
per-task result, and MultiEasyCrowdedPacket.MECP on two TESS pairs (two
seeds of phase 10's crowded generator, MaskSatContam), whose statuses,
decisions and results must equal single ECP calls.

    python3 chip_smoke.py --sharded

builds the kernels and runs phase 12 (the multi-device layer) alone.

    python3 chip_smoke.py --direct

builds the kernels and runs phase 13 (the FFT-free f64 route, convolve2d
and the int16 upload) alone, and prints K8's and K9's kernels line.

    python3 chip_smoke.py --batched

builds the kernels and runs phase 14 (the batched steps of every batched
configuration; the v2 fast trio and the v2 contract for B = 1, 2, 4, 8)
alone, and prints their launches as a "batched_kernels" line.

    python3 chip_smoke.py --stages OUT_DIR

times the slicing stages of one steady contract step and one steady v2 step
on the path's own inputs (device, back to back, plain twins, K4 / K5 kernel
launches per call from the wrappers' counters and kernels and copies from
the profiler, bound; OUT_DIR/stages_<label>.json). It runs in a checkout
without the stage entries of core/slicing.py too, where each stage is the
wrapper chain the callers ran before them, so that two commits compare on
one card.
"""

import contextlib
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
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
# limit): HBM3, FP32 outside the tensor cores, and FP64 at its peak, which
# is the tensor cores' (DMMA; 34 TFLOP/s outside them)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 67e12
# f32 operations that are not fused multiply-adds (K6's _rn arithmetic): one
# per lane per clock, 132 SMs x 128 lanes x 1.98 GHz (half the FMA-counted
# FP32 rate)
FP32_NONFMA_OPS_PER_S = 33.5e12


def bound(nbytes, flops, peak):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# every process this script starts (spawn), and the sockets of the engine
# daemons it spawns (phase 11): stop_children ends whatever of them still
# runs when main returns or raises
_CHILDREN = []
_DAEMON_SOCKETS = []


def spawn(cmd, **kw):
    """subprocess.Popen, recorded for stop_children."""
    proc = subprocess.Popen(cmd, **kw)
    _CHILDREN.append(proc)
    return proc


def stop_children():
    """Kill and reap the processes spawn started that still run, and the
    engine daemons serving a socket of _DAEMON_SOCKETS (a daemon runs in a
    session of its own, so only its command line names it)."""
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for pid in (os.listdir("/proc") if _DAEMON_SOCKETS else ()):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().decode(errors="replace").split("\0")
        except (OSError, ValueError):
            continue
        if "sfft_tpu_torch.serve" in argv and any(sk in argv for sk in _DAEMON_SOCKETS):
            try:
                os.kill(int(pid), signal.SIGKILL)
            except ProcessLookupError:
                pass


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
    E0; each spectrum is read once, the real windows written once. The
    callers pass the peak of the sums' type: FP32 for c64, FP64 for c128, at
    the tensor cores' DMMA rate (67 TFLOP/s, the same number)."""
    cols = r1 // 2 + 1 if sym else r1
    return bound(itemsize * nspec * n0 * n1h + itemsize // 2 * npairs * r0 * r1,
                 npairs * n0 * n1h * (6 + 8 * cols) + 8 * npairs * r0 * n0 * r1, peak)


K1_DEVICE_FNS = {"sfft_corr_window_c64 / _c128": (
    "corr_window.cu", ("corr_stage1", "corr_stage2", "corr_stage2_sum"))}


def k1_isa_check(report):
    """Stage 1 on the FP64 tensor cores: DMMA in every corr_stage1
    instantiation (isa_report asserts it), and no DFMA in the c64 ones
    (their products are f32, their sums DMMAs; the c128 ones' DFMAs are the
    Hadamard products a * conj(b))."""
    for f, r in report[next(iter(K1_DEVICE_FNS))].items():
        if f.startswith("corr_stage1<float") and isinstance(r.get("sass"), dict):
            assert r["sass"]["DFMA"] == 0, f"{f}: {r['sass']['DFMA']} DFMA in its SASS"


def k1_library(call):
    """The library route of a K1 call on the same spectra widened to c128:
    torch.mul and two torch.einsum contractions (cuBLAS ZGEMM, f64 sums),
    the 'matmul' twin in c128; (its output, its time in ms)."""
    out = call("matmul")
    return out, cuda_ms(lambda: call("matmul"), reps=3, inner=3)


def phase_k1():
    """K1 against its matmul twin: c64 at the fast slice's two shapes (timed,
    launched twice: bit-equal; each also against the c128 twin on the same
    spectra widened, which is timed as the library route) and at ragged
    shapes, c128 at 512^2 and, timed, at the f64 'fft' greek backend's OMG
    call at 4096^2; then the SASS of stage 1 (DMMA, no DFMA in c64)."""
    import torch
    from sfft_tpu_torch.core import greek

    dev = torch.device("cuda")
    sass_job = sass_start()
    # the slice's two shapes in c64: 6 fluctuation spectra (N, N/2+1);
    # OMG window +-2w symmetric (21 pairs, 33 x 33), THE window +-w vs J
    # (6 pairs, 17 x 17)
    rng = np.random.default_rng(6)
    planes = torch.as_tensor(rng.normal(0, 30, (7, N, N)), dtype=torch.float32, device=dev)
    specs = torch.fft.rfft2(planes)
    del planes
    specs128 = specs.to(torch.complex128)

    def omg(m, sp):
        F = sp[1:]   # one tensor as both stacks: the symmetric triangle
        return greek.corr_window_fft(F, F, N, N, 2 * KERHW, 2 * KERHW, method=m,
                                     symmetric=True)

    def the(m, sp):
        return greek.corr_window_fft(sp[1:], sp[0:1], N, N, KERHW, KERHW, method=m)

    calls = {"omg": omg, "the": the}
    N1h = N // 2 + 1
    shapes = {"omg": (21, 4 * KERHW + 1, 6), "the": (6, 2 * KERHW + 1, 7)}
    k1 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
              bound_by="operations")
    for name, fn in calls.items():
        call = lambda m: fn(m, specs)
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
        k1["max_abs_err"] = max(k1["max_abs_err"], float((out - ref).abs().max()))
        del ref
        ref128, lms = k1_library(lambda m: fn(m, specs128))
        err128 = rel_err(out.double(), ref128)
        del ref128
        npairs, R, nspec = shapes[name]
        bms, by = k1_bound(npairs, nspec, N, N1h, R, R, 8, FP32_FLOP_PER_S, sym=True)
        k1["ms"] += ms
        k1["plain_ms"] += pms
        k1["library_ms"] += lms
        k1["bound_ms"] += bms
        k1[name] = dict(ms=ms, eager_ms=ems, plain_ms=pms, library_ms=lms, bound_ms=bms,
                        bound_by=by, rel_err=err, rel_err_c128=err128,
                        plan=greek._k1_plan(R, True))
        log(f"phase 3 K1 corr_window c64 {name} {tuple(out.shape)} plan (S, NT, nng) = "
            f"{k1[name]['plan']}: max|d|/max|ref| = {err:.3e} (bound 1e-5), from the c128 "
            f"twin on the spectra widened {err128:.3e}, two launches bit-equal; kernel "
            f"{ms:.4f} ms (5 calls in a CUDA graph, replayed; {ems:.4f} ms back to back from "
            f"Python; {100 * bms / ms:.1f}% of the bound), plain matmul twin {pms:.4f} ms, "
            f"library route (c128 torch.mul + 2 einsum, cuBLAS ZGEMM) {lms:.4f} ms, bound "
            f"{bms:.4f} ms ({by}, the conjugate-pair route's count)")
    # the general route (any weights; no caller on the port's paths) on the
    # OMG pair list, against its own bound
    del specs128
    specF = specs[1:]
    iu, ju = np.triu_indices(6)
    R = 4 * KERHW + 1
    E0, E1 = greek._idft_mats_on(N, N, 2 * KERHW, 2 * KERHW, specF.dtype, dev)
    out = greek.corr_window(specF, specF, iu, ju, E0, E1)
    err = rel_err(out, greek.corr_pairs_plain(specF, specF, iu, ju, E0, E1))
    assert err <= 1e-5, f"K1 c64 omg pair list, general weights: rel err {err:.3e} > 1e-5"
    gen = dict(ms=graph_ms(lambda: greek.corr_window(specF, specF, iu, ju, E0, E1), calls=5),
               plan=greek._k1_plan(R, False))
    gen["bound_ms"], gen["bound_by"] = k1_bound(21, 6, N, N1h, R, R, 8, FP32_FLOP_PER_S,
                                                sym=False)
    k1["omg_general"] = gen
    log(f"phase 3 K1 corr_window c64 omg pair list on the general route (any weights), plan "
        f"(S, NT, nng) = {gen['plan']}: max|d|/max|ref| = {err:.3e} (bound 1e-5); kernel "
        f"{gen['ms']:.4f} ms, bound {gen['bound_ms']:.4f} ms ({gen['bound_by']})")
    del specs, specF, out, E0, E1

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
                plan=greek._k1_plan(R, True))
    c128["library_ms"] = c128["plain_ms"]   # the twin is the c128 library route
    c128["bound_ms"], c128["bound_by"] = k1_bound(21, 6, N, N1h, R, R, 16, FP64_FLOP_PER_S, sym=True)
    k1["c128_omg"] = c128
    log(f"phase 3 K1 corr_window c128 omg {tuple(out.shape)} at {N}^2 plan (S, NT, nng) = "
        f"{c128['plan']}: max|d|/max|ref| = {err:.3e} (bound 1e-11), two launches bit-equal; "
        f"kernel {c128['ms']:.4f} ms ({100 * c128['bound_ms'] / c128['ms']:.1f}% of the bound), "
        f"plain matmul twin (the library route) {c128['plain_ms']:.4f} ms, bound "
        f"{c128['bound_ms']:.4f} ms ({c128['bound_by']}, FP64 at the DMMA peak)")
    del spec, out
    torch.cuda.empty_cache()
    k1["isa"] = isa_report(sass_job, K1_DEVICE_FNS, "3 K1")
    k1_isa_check(k1["isa"])
    return k1


def k2_bound(Fij, Fpq, nS, n0, n1h, L0, itemsize, peak):
    """K2's bound: each spectrum plane (FJ, the Fij FI, the Fpq FT, the nS
    FS) read once, FDIFF written once, the phase matrices and the solution
    read once; per half-spectrum element 8 flops per complex multiply-add of
    K' (Fij * L0 of them), 8 per FI term, 4 per FT / FS term and 2 for the
    subtraction."""
    planes = (2 + Fij + Fpq + nS) * n0 * n1h
    small = n0 * L0 + L0 * n1h
    return bound(itemsize * (planes + small) + itemsize // 2 * (Fij * L0 * L0 + Fpq),
                 n0 * n1h * (8 * Fij * L0 + 8 * Fij + 4 * (Fpq + nS) + 2), peak)


def k2_inputs(Fij, Fpq, nS, n0, n1, w, cdt, seed=7):
    """Seeded inputs of fdiff_model at one shape on the card, at the
    magnitudes of a fitted path: spectra of zero-mean unit-noise planes (J,
    SI, ST; no DC term to swamp the model), scaling planes, the path's SCALE
    1 / (n0 n1) and a solution whose kernel part is (n0 n1) times a unit
    center and 0.05-scale off-center coefficients, so that the model
    FJ - FDIFF is of the order of the planes and its K'-dependent part is
    about half of it; and the static phase matrices of a (2w+1)^2 kernel."""
    import torch
    from sfft_tpu_torch.core import fdiff

    dev = torch.device("cuda")
    rdt = torch.float32 if cdt == torch.complex64 else torch.float64
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    specs = torch.fft.rfft2(torch.randn((1 + Fij + Fpq, n0, n1), dtype=rdt, device=dev,
                                        generator=g))
    FS = torch.fft.rfft2(torch.randn((nS, n0, n1), dtype=rdt, device=dev, generator=g)) \
        if nS else None
    L = 2 * w + 1
    a = 0.05 * torch.randn((Fij, L, L), dtype=torch.float64, device=dev, generator=g)
    a[:, w, w] = 1.0
    sol = torch.cat([(n0 * n1) * a.reshape(-1),
                     torch.randn((Fpq,), dtype=torch.float64, device=dev, generator=g)])
    lag = np.arange(-w, w + 1)
    W0 = np.exp((-2j * np.pi / n0) * np.outer(np.arange(n0), lag))
    W1 = np.exp((-2j * np.pi / n1) * np.outer(lag, np.arange(n1 // 2 + 1)))
    return (specs, FS, sol.to(rdt), torch.as_tensor(W0, dtype=cdt, device=dev),
            torch.as_tensor(W1, dtype=cdt, device=dev), Fij, w, w, 1.0 / (n0 * n1)), fdiff


def k2_model_err(args, out, ref):
    """K2 against its twin on the model FJ - FDIFF, the part the kernel
    computes: max|out - ref| / max|FJ - ref|."""
    return float((out - ref).abs().max() / (args[0][0] - ref).abs().max())


def phase_k2():
    """K2 against its twin: the fast slice's shapes (Fij 6, Fpq 6,
    4096 x 2049, L 17) and the v2 ones (Fij 25, Fpq 1, 6 scaling planes,
    900 x 451, L 23), each in c64 and c128, and ragged shapes (odd N1, N0 off
    the row tile); the model (FJ - FDIFF) within 1e-5 (c64) and 1e-12 (c128)
    of its maximum, each launched twice (bit-equal); device time (graph
    replay) against the bound and the twin."""
    import torch

    cases = [("fast", 6, 6, 0, N, N, KERHW), ("v2", 25, 1, 6, V2_N, V2_N, V2_KERHW),
             ("ragged", 4, 2, 3, 1001, 999, 3), ("ragged1", 2, 0, 2, 37, 21, 1)]
    out = {}
    for name, Fij, Fpq, nS, n0, n1, w in cases:
        for cdt, tol in [(torch.complex64, 1e-5), (torch.complex128, 1e-12)]:
            args, fdiff = k2_inputs(Fij, Fpq, nS, n0, n1, w, cdt)
            fdiff.fdiff_model.launches = 0
            got = fdiff.fdiff_model(*args)
            again = fdiff.fdiff_model(*args)
            torch.cuda.synchronize()
            assert fdiff.fdiff_model.launches == 4, fdiff.fdiff_model.launches
            assert torch.equal(got, again), f"K2 {name} {cdt}: two launches differ"
            del again
            ref = fdiff.fdiff_model_plain(*args)
            err = k2_model_err(args, got, ref)
            assert err <= tol, f"K2 {name} {cdt}: model rel err {err:.3e} > {tol:g}"
            key = f"{name} {'c64' if cdt == torch.complex64 else 'c128'}"
            row = dict(max_abs_err=float((got - ref).abs().max()), rel_err=err)
            del got, ref
            if name in ("fast", "v2"):
                big = n0 == N
                row["ms"] = graph_ms(lambda: fdiff.fdiff_model(*args), calls=5 if big else 20)
                row["plain_ms"] = cuda_ms(lambda: fdiff.fdiff_model_plain(*args), reps=3,
                                          inner=3)
                peak = FP32_FLOP_PER_S if cdt == torch.complex64 else FP64_FLOP_PER_S
                row["bound_ms"], row["bound_by"] = k2_bound(
                    Fij, Fpq, nS, n0, n1 // 2 + 1, 2 * w + 1, cdt.itemsize, peak)
                timing = (f"; kernel {row['ms']:.4f} ms (calls in a CUDA graph, replayed), "
                          f"plain twin {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
                          f"ms ({row['bound_by']}; {100 * row['bound_ms'] / row['ms']:.1f}% "
                          f"of it)")
            else:
                timing = ""
            out[key] = row
            log(f"phase 3 K2 fdiff_model {key} Fij {Fij} Fpq {Fpq} nS {nS} "
                f"({n0}, {n1 // 2 + 1}) L {2 * w + 1}: max|d| / max|model| = {err:.3e} (bound "
                f"{tol:g}), two launches bit-equal{timing}")
            del args
            torch.cuda.empty_cache()
    # the main path's K2 is the fast slice's c64 call
    report = dict(out["fast c64"], library_ms=None)
    report["calls"] = out
    return report


def phase_k1_v2():
    """K1 (c64) at the v2 fast pair lists (900 x 451, 25 kernel planes):
    Comg symmetric (lags +-22, R 45: 23 slots on the conjugate-pair route),
    Cgam and Cthe (25 x 1 pairs, R 23), Pbs (25 x 25, R 23); and at the
    piecewise peel's (31 planes: kernel and scaling; FF symmetric R 45, FFJ
    31 x 1 R 23); each against its matmul twin within 1e-5 of max, launched
    twice (bit-equal), timed, and against the c128 twin on the spectra
    widened (the library route, timed too)."""
    import torch
    from sfft_tpu_torch.core import greek

    dev = torch.device("cuda")
    n, w = V2_N, V2_KERHW
    n1h = n // 2 + 1
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    specs = torch.fft.rfft2(30.0 * torch.randn((33, n, n), dtype=torch.float32, device=dev,
                                               generator=g))
    specs128 = specs.to(torch.complex128)
    # (A planes, B planes, lag half-width, symmetric) as slices of the stack
    J, T, I, F = slice(0, 1), slice(1, 2), slice(2, 27), slice(2, 33)
    calls = {
        "omg": (I, I, 2 * w, True), "gam": (I, T, w, False), "the": (I, J, w, False),
        "pbs": (I, I, w, False), "peel ff": (F, F, 2 * w, True), "peel ffj": (F, J, w, False),
    }
    rows = {}
    for name, (ia, ib, wx, sym) in calls.items():
        def on(sp, m):
            a = sp[ia]
            b = a if ib == ia else sp[ib]   # one tensor as both stacks, as on the paths
            return greek.corr_window_fft(a, b, n, n, wx, wx, method=m, symmetric=sym)

        call = lambda m: on(specs, m)
        a, b = specs[ia], specs[ib]
        out = call("kernel")
        again = call("kernel")
        torch.cuda.synchronize()
        assert torch.equal(out, again), f"K1 v2 {name}: two launches differ"
        err = rel_err(out, call("matmul"))
        assert err <= 1e-5, f"K1 v2 {name}: rel err {err:.3e} > 1e-5"
        ref128, lms = k1_library(lambda m: on(specs128, m))
        err128 = rel_err(out.double(), ref128)
        del ref128
        R = 2 * wx + 1
        npairs = a.shape[0] * (a.shape[0] + 1) // 2 if sym else a.shape[0] * b.shape[0]
        nspec = a.shape[0] + (0 if sym else b.shape[0])
        bms, by = k1_bound(npairs, nspec, n, n1h, R, R, 8, FP32_FLOP_PER_S, sym=True)
        rows[name] = dict(shape=list(out.shape), rel_err=err, rel_err_c128=err128,
                          ms=graph_ms(lambda: call("kernel")),
                          plain_ms=cuda_ms(lambda: call("matmul"), reps=3, inner=3),
                          library_ms=lms, bound_ms=bms, bound_by=by,
                          plan=greek._k1_plan(R, True))
        r = rows[name]
        log(f"phase 3 K1 corr_window c64 v2 {name} {tuple(out.shape)} plan (S, NT, nng) = "
            f"{r['plan']}: max|d|/max|ref| = {err:.3e} (bound 1e-5), from the c128 twin "
            f"{err128:.3e}, two launches bit-equal; kernel {r['ms']:.4f} ms (graph replay), "
            f"plain matmul twin {r['plain_ms']:.4f} ms, library route {lms:.4f} ms, bound "
            f"{bms:.4f} ms ({by}; {100 * bms / r['ms']:.1f}% of it)")
    del specs, specs128
    torch.cuda.empty_cache()
    return rows


def kernels_on_path(run, path, phase):
    """Drive one step (`run`) with the K3, K1 (greek._corr_window, which
    corr_window_fft calls) and K2 wrappers recording the operands of their
    first call at each shape, then hold each shape's kernel result to its
    twin on those operands, launched twice (bit-equal), and time it: K3
    scaled by max(|W| @ |G|) (the products' own magnitude: these sums
    cancel) within 1e-13; K1 against corr_pairs_plain within 1e-5 (c64) or
    1e-11 (c128) of its maximum; K2 on the model FJ - FDIFF within 1e-5
    (c64) or 1e-12 (c128) of its maximum."""
    import torch
    from sfft_tpu_torch.core import fdiff, greek, moments, peel

    seen3, seen1, seen2 = {}, {}, {}
    real3, real1, real2 = moments.moments, greek._corr_window, fdiff.fdiff_model

    def recording3(W, G):
        key = (W.shape[0], W.shape[1], G.shape[1])
        if key not in seen3:
            seen3[key] = [W.clone(), G.clone(), 0]
        seen3[key][2] += 1
        return real3(W, G)

    def recording1(specA, specB, ia, ib, E0, E1, sym=False, blocks=1):
        same = specA.data_ptr() == specB.data_ptr() and specA.shape == specB.shape
        key = (tuple(specA.shape), tuple(specB.shape), len(ia), tuple(E0.shape),
               tuple(E1.shape), str(specA.dtype), bool(sym), blocks, same)
        if key not in seen1:
            a = specA.clone()
            seen1[key] = [(a, a if same else specB.clone(), np.array(ia), np.array(ib), E0, E1,
                           sym, blocks), 0]
        seen1[key][1] += 1
        return real1(specA, specB, ia, ib, E0, E1, sym=sym, blocks=blocks)

    def recording2(specs, FS, solution, W0, W1, *rest):
        key = (tuple(specs.shape), 0 if FS is None else FS.shape[0], str(specs.dtype))
        if key not in seen2:
            seen2[key] = [(specs.clone(), None if FS is None else FS.clone(), solution.clone(),
                           W0, W1, *rest), 0]
        seen2[key][1] += 1
        return real2(specs, FS, solution, W0, W1, *rest)

    recording2.launches = 0
    # every f64 product of the peel goes through peel._exact_skinny_matmul,
    # which calls the wrapper by its name in core/peel.py; corr_window_fft
    # calls _corr_window by its name in core/greek.py, fdiff_fft calls
    # fdiff_model by its name in core/fdiff.py
    peel.moments, greek._corr_window, fdiff.fdiff_model = recording3, recording1, recording2
    try:
        run()
        torch.cuda.synchronize()
    finally:
        peel.moments, greek._corr_window, fdiff.fdiff_model = real3, real1, real2
    rows = {}
    for (S, N0, N1), (W, G, count) in sorted(seen3.items()):
        out = real3(W, G)
        again = real3(W, G)
        torch.cuda.synchronize()
        assert torch.equal(out, again), f"K3 {path} {(S, N0, N1)}: two launches differ"
        ref = moments.moments_plain(W, G)
        scale = float((W.abs() @ G.abs()).max())
        diff = float((out - ref).abs().max())
        err = diff / scale if scale else (0.0 if diff == 0.0 else float("inf"))
        assert err <= 1e-13, f"K3 {path} {(S, N0, N1)}: {err:.3e} of max(|W| @ |G|) > 1e-13"
        ms = graph_ms(lambda: real3(W, G))
        bms, by = bound(8 * (S * N0 + N0 * N1 + S * N1), 2 * S * N0 * N1, FP64_FLOP_PER_S)
        rows[f"K3 {(S, N0, N1)}"] = dict(calls=count, rel_err=err, ms=ms, bound_ms=bms,
                                         bound_by=by)
        log(f"phase {phase} K3 moments on the {path} path {(S, N0, N1)}: {count} calls per "
            f"step; max|d| = {err:.3e} of max(|W| @ |G|) (bound 1e-13), two launches "
            f"bit-equal; kernel {ms:.4f} ms (graph replay), bound {bms:.4f} ms ({by})")
    for key, (args, count) in sorted(seen1.items(), key=lambda kv: str(kv[0])):
        specA, specB, ia, ib, E0, E1, sym, blocks = args
        call = lambda: real1(specA, specB, ia, ib, E0, E1, sym=sym, blocks=blocks)
        out, again = call(), call()
        torch.cuda.synchronize()
        assert torch.equal(out, again), f"K1 {path} {key}: two launches differ"
        c64 = specA.dtype == torch.complex64
        tol = 1e-5 if c64 else 1e-11
        err = rel_err(out, greek.corr_pairs_plain(specA, specB, ia, ib, E0, E1))
        assert err <= tol, f"K1 {path} {key}: rel err {err:.3e} > {tol:g}"
        ms = graph_ms(call, calls=3, reps=3)
        nspec = specA.shape[0] + (0 if key[-1] else specB.shape[0])
        bms, by = k1_bound(len(ia), nspec, specA.shape[1], specA.shape[2], E0.shape[0],
                           E1.shape[1], specA.element_size(),
                           FP32_FLOP_PER_S if c64 else FP64_FLOP_PER_S, sym)
        rows[f"K1 {key[:3]} R {E0.shape[0]}x{E1.shape[1]}"] = dict(
            calls=count, rel_err=err, ms=ms, bound_ms=bms, bound_by=by)
        log(f"phase {phase} K1 corr_window on the {path} path, spectra {key[0]} x {key[1]} "
            f"{len(ia)} pairs window {E0.shape[0]} x {E1.shape[1]} "
            f"{'c64' if c64 else 'c128'} sym={sym}: {count} calls per step; max|d|/max|ref| = "
            f"{err:.3e} (bound {tol:g}), two launches bit-equal; kernel {ms:.4f} ms (graph "
            f"replay), bound {bms:.4f} ms ({by})")
    for (shape, nS, _), (args, count) in sorted(seen2.items()):
        out = real2(*args)
        again = real2(*args)
        torch.cuda.synchronize()
        assert torch.equal(out, again), f"K2 {path} {shape}: two launches differ"
        c64 = args[0].dtype == torch.complex64
        tol = 1e-5 if c64 else 1e-12
        err = k2_model_err(args, out, fdiff.fdiff_model_plain(*args))
        assert err <= tol, f"K2 {path} {shape}: model rel err {err:.3e} > {tol:g}"
        ms = graph_ms(lambda: real2(*args))
        Fij, L0 = args[5], args[3].shape[1]
        bms, by = k2_bound(Fij, shape[0] - 1 - Fij, nS, shape[1], shape[2], L0,
                           args[0].itemsize, FP32_FLOP_PER_S if c64 else FP64_FLOP_PER_S)
        rows[f"K2 {shape} nS {nS}"] = dict(calls=count, rel_err=err, ms=ms, bound_ms=bms,
                                           bound_by=by)
        log(f"phase {phase} K2 fdiff_model on the {path} path, spectra {shape} nS {nS} "
            f"{'c64' if c64 else 'c128'}: {count} calls per step; max|d| / max|model| = "
            f"{err:.3e} (bound {tol:g}), two launches bit-equal; kernel {ms:.4f} ms (graph "
            f"replay), bound {bms:.4f} ms ({by})")
    return rows


FAST_TRIO = dict(greek_backend="fft32", fdiff_backend="fft32", solver="refined")
PEELED_TRIO = dict(greek_backend="peeled", fdiff_backend="fft32", solver="refined",
                   fluct_dtype="float32")


def phase_v2_fast(lam, ydiff):
    """The two v2 fast modes on the NIRCam configuration through
    BSplinePacket.BSP: fft32 / fft32 / refined, and peeled (the piecewise
    peel) / fft32 / refined with f32 fluctuations. Each with the kernels
    (counts set to 0 just before, read just after) and on the plain twins;
    finite, at the pair's noise level (central RMS in [1.3, 1.7]); and each
    held the same way to the f64 fft/fft/lu difference of phase 7: RMS
    below the fast bound 0.05 or, where the mode's plain twins are farther
    than that (the mode's own f32 error, as the fft32 mode's c64 tables of
    the raw images on this 13k-dof system; PERF.md section 6), no farther
    than the twins: the kernels may not take a mode past the bound or past
    its own plain computation. K3 and K2 are then held to their twins on
    each mode's own operands (kernels_on_path)."""
    import tempfile

    import torch
    from sfft_tpu_torch import BSplinePacket
    from sfft_tpu_torch.core import fdiff, greek, moments, peel_pw

    n = V2_N
    c = slice(n // 4, 3 * n // 4)
    counters = {"moments": moments.moments, "corr_window": greek.corr_window,
                "fdiff_model": fdiff.fdiff_model}
    modes = {"v2-fast-fft32": (FAST_TRIO, ("corr_window", "fdiff_model")),
             "v2-fast-peeled": (PEELED_TRIO, ("moments", "corr_window", "fdiff_model"))}
    res = {}

    def rms_of(a, b=None):
        return float(np.sqrt(np.mean((a if b is None else a - b) ** 2)))

    with tempfile.TemporaryDirectory() as d:
        ref, sci = write_pair_fits(d)
        for mode, (backends, used) in modes.items():
            cfg = nircam_config(lam, **backends)
            assert cfg.NEQ == V2_NEQ
            if "peeled" in mode:
                assert peel_pw.pw_supported(cfg), "the NIRCam knots fail pw_supported"
            t0 = time.perf_counter()
            BSplinePacket.BSP(ref, sci, ref, sci, cfg=cfg)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            for f in counters.values():
                f.launches = 0
            sol, diff, step_s = run_bsp(ref, sci, cfg, plain=False, reps=3)
            launches = {k: counters[k].launches for k in used}
            peak = torch.cuda.max_memory_allocated()
            assert all(v > 0 for v in launches.values()), \
                f"{mode}: a kernel of the path never launched: {launches}"
            assert sol.shape == (cfg.NEQ,) and diff.shape == (n, n)
            psol, pdiff, plain_s = run_bsp(ref, sci, cfg, plain=True, reps=3)
            for name, dd in (("kernels", diff), ("plain twins", pdiff)):
                assert np.isfinite(dd).all(), f"{mode} {name}: not finite"
                crms = rms_of(dd[c, c])
                assert 1.3 <= crms <= 1.7, \
                    f"{mode} {name}: central difference RMS {crms:.4f} outside [1.3, 1.7]"
            rms, prms = rms_of(diff[c, c]), rms_of(pdiff[c, c])
            drms, pdrms = rms_of(diff, ydiff), rms_of(pdiff, ydiff)
            assert drms < 0.05 or drms <= pdrms, \
                f"{mode}: RMS(diff - diff_f64) {drms:.4e} above the fast bound 0.05 and the " \
                f"plain twins' {pdrms:.4e}"
            row = dict(step_s=step_s, plain_s=plain_s, first_s=first_s, peak=peak,
                       launches=launches, rms=rms, plain_rms=prms, drms=drms, plain_drms=pdrms,
                       kernels_vs_twins_rms=rms_of(diff, pdiff), within_fast_bound=drms < 0.05,
                       cfg=cfg, sol=sol, diff=diff)
            verdict = ("within the fast bound 0.05" if drms < 0.05 else
                       "FINDING: above the fast bound 0.05 (open), within the plain twins' "
                       "distance")
            log(f"phase 8 {mode} {n}^2 NEQ={cfg.NEQ} through BSplinePacket.BSP: first call "
                f"{first_s:.1f} s; median step {step_s * 1e3:.1f} ms over 3 runs (plain twins "
                f"{plain_s * 1e3:.1f} ms); launches {launches} in 4 runs; peak memory "
                f"{peak / 2**30:.2f} GiB; central diff RMS {rms:.4f} (plain twins {prms:.4f}); "
                f"RMS(diff - diff_f64) = {drms:.4e} (plain twins {pdrms:.4e}; {verdict}); "
                f"kernels vs twins RMS {row['kernels_vs_twins_rms']:.3e}")
            del psol, pdiff
            row["on_path"] = kernels_on_path(
                lambda: BSplinePacket.BSP(ref, sci, ref, sci, cfg=cfg), mode, 8)
            res[mode] = row
    return res


def gaussian_psf(size, sigma):
    x = np.arange(size) - (size - 1) / 2.0
    p = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / (2.0 * sigma ** 2))
    return p / p.sum()


def phase_post(sol, diff, cfg, devices=("cuda", "cpu")):
    """The NIRCam post-processing (examples/subtract_nircam.py steps 3-4) on
    phase 8's solution and difference (the peeled mode's, which meets the
    fast bound), on the card and on the CPU:
    matching kernels realized on the tile grid (TiHW = 5 GKerHW),
    decorrelation kernels per tile from Gaussian PSFs made here
    (BSplineDeCorrelation.BDC, denominator clipping at 1e5), and the grid
    convolution of the difference (BSplineGridConvolve.GSVC); card and CPU
    within 1e-9 of max (f64)."""
    import torch
    from sfft_tpu_torch import BSplineDeCorrelation, BSplineGridConvolve, BSplineMatchingKernel
    from sfft_tpu_torch.core import fdiff
    from sfft_tpu_torch.post.grid_convolve import make_tile_grid

    n = V2_N
    TiHW = round(5 * V2_KERHW)
    AllocatedL, XY_TiC = make_tile_grid(n, n, TiHW)
    MKerStack = BSplineMatchingKernel(XY_TiC).from_solution(sol, cfg)
    assert MKerStack.shape == (len(XY_TiC), cfg.L0, cfg.L1) and np.isfinite(MKerStack).all()
    psf_ref, psf_sci = gaussian_psf(31, 1.6), gaussian_psf(31, 2.0)
    out, secs, k9 = {}, {}, {}
    for dev in devices:
        t0 = time.perf_counter()
        k9[dev] = fdiff._K9.launches
        dk = np.array([BSplineDeCorrelation.BDC(
            MK_JLst=[psf_ref], SkySig_JLst=[1.0], MK_ILst=[psf_sci], SkySig_ILst=[1.0],
            MK_Fin=mk, KERatio=2.0, VERBOSE_LEVEL=0, device=dev) for mk in MKerStack])
        dc = BSplineGridConvolve(diff, AllocatedL, dk, nan_fill_value=0.0, use_fft=True,
                                 normalize_kernel=True, device=dev).GSVC(TiHW=TiHW)
        if dev == "cuda":
            torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
        k9[dev] = fdiff._K9.launches - k9[dev]
        out[dev] = (dk, dc)
    (dk, dc), (dk_c, dc_c) = out[devices[0]], out[devices[1]]
    assert np.isfinite(dk).all() and np.isfinite(dc).all() and dc.shape == (n, n)
    ek = float(np.abs(dk - dk_c).max() / np.abs(dk_c).max())
    ec = float(np.abs(dc - dc_c).max() / np.abs(dc_c).max())
    assert ek <= 1e-9 and ec <= 1e-9, f"post: card vs CPU {ek:.3e} / {ec:.3e} > 1e-9"
    log(f"phase 9 post-processing on the v2-fast-peeled solution: {len(XY_TiC)} tiles "
        f"(TiHW {TiHW}), matching kernels {MKerStack.shape[1:]}, decorrelation kernels "
        f"{dk.shape[1:]} (BDC), GSVC of the {n}^2 difference; card {secs[devices[0]]:.2f} s, "
        f"CPU {secs[devices[1]]:.2f} s; K9 launches on the card {k9[devices[0]]} (GSVC with "
        f"TiHW takes the batched uniform-grid route; its label route reaches K9 through "
        f"convolve2d); card vs CPU max|d|/max: kernels {ek:.3e}, decorrelated "
        f"difference {ec:.3e} (bound 1e-9)")
    return dict(tiles=len(XY_TiC), card_s=secs[devices[0]], cpu_s=secs[devices[1]], kernel_rel=ek,
                diff_rel=ec, k9_launches=k9[devices[0]])


def one_twin(mod, name, twin, run):
    """`run()` with mod.name replaced by `twin`."""
    real = getattr(mod, name)
    setattr(mod, name, twin)
    try:
        return run()
    finally:
        setattr(mod, name, real)


def k6_on_twins(run):
    """`run()` with K6's kernel wrappers (core/pairs.py; K6p's three modes
    each) replaced by their plain twins."""
    from sfft_tpu_torch.core import pairs

    real = {name: getattr(pairs, name) for name in K6_TWINS}
    for name, twin in K6_TWINS.items():
        setattr(pairs, name, getattr(pairs, twin))
    try:
        return run()
    finally:
        for name, fn in real.items():
            setattr(pairs, name, fn)


def k1_matmul_twin(a, b, ia, ib, E0, E1, sym=False, blocks=1):
    from sfft_tpu_torch.core import greek

    return greek.corr_pairs_plain(a, b, ia, ib, E0, E1)


def f32_tables_in_f64(run):
    """`run()` with the engine's assembly taking the f32 tables in f64 (the
    tables cast, then the f64 system and its solve)."""
    import torch
    from sfft_tpu_torch.core import engine
    from sfft_tpu_torch.core.assemble import GreekTables

    real = engine.assemble_system

    def in_f64(cfg, t, out_dtype=None, reg_terms=None):
        return real(cfg, GreekTables(*(x.double() for x in t)),
                    reg_terms=engine.regularization_terms_on(cfg, t.Pbb.device, torch.float64))

    return one_twin(engine, "assemble_system", in_f64, run)


def phase_fidelity(I, J):
    """--fidelity: where a fast mode's distance from its f64 path comes
    from. The 4096^2 fast slice against the f64 fft/fft/lu difference, and
    (where the checkout has K2) the v2-fast-fft32 mode on the NIRCam
    configuration against its f64 fft/fft/lu difference: with the kernels,
    on the plain twins, and with one kernel at a time on its twin (K1 on
    corr_pairs_plain, sfft_tpu's 'matmul' route in cuBLAS; K2 on
    fdiff_model_plain; K3 on moments_plain), and the v2 mode's f32 tables
    assembled and solved in f64. A change to a kernel's summation order
    runs it in a checkout of the parent and of the change in one call (the
    script copied into the parent's)."""
    import tempfile

    import torch
    from sfft_tpu_torch import BSplinePacket, make_config
    from sfft_tpu_torch.core import fdiff, greek, moments, peel

    cfg = make_config(N, N, KERHW, greek_backend="peeled", fdiff_backend="fft32",
                      solver="refined")
    _, d64, _ = run_pcp(I, J, make_config(N, N, KERHW), plain=True, reps=1)

    def rms(d):
        return float(torch.sqrt(torch.mean((d - d64) ** 2)))

    def pcp():
        return run_pcp(I, J, cfg, plain=False, reps=1)[1]

    out = {"fast": {}, "v2-fast-fft32": {}}

    def note(path, what, run, dist):
        """One line per reading; a route whose f32 system is not positive
        definite (the refined solve's Cholesky fails) is noted as such."""
        try:
            out[path][what] = dist(run())
            text = f"{out[path][what]:.4e}"
        except torch.linalg.LinAlgError as e:
            out[path][what] = None
            text = f"failed: {str(e).split(':')[-1].strip()}"
        log(f"fidelity {path} RMS(diff - diff_f64), {what}: {text}")

    note("fast", "kernels", pcp, rms)
    note("fast", "plain twins", lambda: run_pcp(I, J, cfg, plain=True, reps=1)[1], rms)
    note("fast", "kernels, K1 twin",
         lambda: one_twin(greek, "_corr_window", k1_matmul_twin, pcp), rms)
    note("fast", "kernels, K3 twin",
         lambda: one_twin(peel, "moments", moments.moments_plain, pcp), rms)
    if hasattr(fdiff, "fdiff_model"):
        note("fast", "kernels, K2 twin",
             lambda: one_twin(fdiff, "fdiff_model", fdiff.fdiff_model_plain, pcp), rms)
        with tempfile.TemporaryDirectory() as d:
            ref, sci = write_pair_fits(d)
            y64 = BSplinePacket.BSP(ref, sci, ref, sci, cfg=nircam_config(), plain=True)[1]
            vcfg = nircam_config(**FAST_TRIO)

            def bsp(plain=False):
                return BSplinePacket.BSP(ref, sci, ref, sci, cfg=vcfg, plain=plain)[1]

            def vrms(dd):
                return float(np.sqrt(np.mean((dd - y64) ** 2)))

            v2 = "v2-fast-fft32"
            note(v2, "kernels", bsp, vrms)
            note(v2, "plain twins", lambda: bsp(plain=True), vrms)
            note(v2, "kernels, K1 twin",
                 lambda: one_twin(greek, "_corr_window", k1_matmul_twin, bsp), vrms)
            note(v2, "kernels, K2 twin",
                 lambda: one_twin(fdiff, "fdiff_model", fdiff.fdiff_model_plain, bsp), vrms)
            note(v2, "kernels, f32 tables assembled and solved in f64",
                 lambda: f32_tables_in_f64(bsp), vrms)
            note(v2, "plain twins, f32 tables assembled and solved in f64",
                 lambda: f32_tables_in_f64(lambda: bsp(plain=True)), vrms)
    log(json.dumps({"fidelity": out}))


def k7_table(K, M, kind, seed):
    """A seeded static table (K, M) for the K7 cases: complex, or real ('r')."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(K, M))
    return W if kind == "r" else W + 1j * rng.normal(size=(K, M))


def k7_data(shape, kind, seed, dev):
    """A seeded pair operand over ~6 decades of row magnitudes on the card:
    real, or complex ('c')."""
    from sfft_tpu_torch.core import exact_fft

    rng = np.random.default_rng(seed)
    planes = []
    for _ in range(2 if kind == "c" else 1):
        x = rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, size=shape[:-1] + (1,))
        hi = x.astype(np.float32)
        planes += [hi, (x - hi.astype(np.float64)).astype(np.float32)]
    planes += [None] * (4 - len(planes))
    import torch

    return exact_fft.CPair(*(None if v is None else torch.as_tensor(v, device=dev)
                             for v in planes))


def k7_bound(P, plan, sd):
    """K7's bound for one call: the int32 values its terms need read once
    (every combo of every group, M true columns), the scales read once, the
    output planes written once; per element and term one integer add per
    combo and ~8 f32 operations per f32 value of the chain (two with the
    2^12 split), 6 for the scale and renormalisation, 16 for the
    recombination."""
    rows = int(np.prod(plan.lead))
    n = rows * plan.M
    terms = [t for t in plan.terms if t is not None]
    combos = sum(len(c) for c in plan.slabs)
    nout = 2 if plan.mode == 2 else 4
    nbytes = 4 * (len(terms) * combos * n + nout * n + sum(s.numel() for s in sd) + len(terms))
    vals = len(plan.slabs) * (2 if plan.split else 1)
    return bound(nbytes, n * (len(terms) * (combos + 8 * vals + 6) + 16), FP32_FLOP_PER_S)


def k7_signature(P, plan, sd):
    """The launch signature of a K7 call: products' shape, the plan (its
    static scales by kind), the data scales' shape."""
    terms = tuple(None if t is None else (t[0], t[1], type(t[2]).__name__) for t in plan.terms)
    return (tuple(P.shape), plan.lead, plan.M, plan.slabs, plan.weights, plan.split,
            plan.slab_stride, plan.ncols, terms, plan.mode, tuple(sd[0].shape))


def phase_k7():
    """K7 (the sliced product's epilogue) against its twin, bit for bit, on
    every route: shallow (K < 1024) and deep, the 2^12 split or not (shallow
    K = 1000), m <= 16 rows (the padded product), global and rowwise
    scales, static scales given as floats (small tables) and as device
    scalars (big tables), real data, complex data, real_out and a table
    with no imaginary part, at the profiles (9, 8, 8), (8, 7, 6) and
    (6, 6, 5); one launch per call, two launches bit-equal. Every K7 launch
    of a contract and a v2 step is held to the twin again in phases 6 and
    7."""
    import torch
    from sfft_tpu_torch.core import exact_fft
    from sfft_tpu_torch.core.statics import Static

    dev = torch.device("cuda")
    routes = {"shallow": (64, 64, (3, 40)), "shallow m<=16": (64, 33, (5,)),
              "shallow split": (1000, 17, (6, 9)), "deep": (2049, 17, (4, 5)),
              "deep m<=16": (1030, 23, (2,))}
    kinds = {"real data": ("r", "c", False), "complex": ("c", "c", False),
             "real_out": ("c", "c", True), "real table": ("c", "r", False)}
    real = exact_fft.sliced_epilogue
    n = 0
    seen = set()
    for ri, (route, (K, M, lead)) in enumerate(routes.items()):
        for ki, (kind, (dk, wk, real_out)) in enumerate(kinds.items()):
            data = k7_data(lead + (K,), dk, 10 * ri + ki, dev)
            W = Static(k7_table, (K, M, wk, 10 * ri + ki))
            for prof in [(9, 8, 8), (8, 7, 6), (6, 6, 5)]:
                for rowwise in (False, True):
                    plans = []

                    def capture(P, plan, sd):
                        plans.append(plan)
                        return real(P, plan, sd)

                    run = lambda: exact_fft._cmatmul_sliced(
                        data, W, rowwise=rowwise, real_out=real_out,
                        prof=exact_fft.SliceProfile(*prof))
                    before = real.launches
                    exact_fft.sliced_epilogue = capture
                    try:
                        got = run()
                        again = run()
                    finally:
                        exact_fft.sliced_epilogue = real
                    torch.cuda.synchronize()
                    assert real.launches == before + 2, (route, kind, prof)
                    exact_fft.sliced_epilogue = exact_fft.sliced_epilogue_plain
                    try:
                        ref = run()
                    finally:
                        exact_fft.sliced_epilogue = real
                    for g, a, r in zip(got, again, ref):
                        assert (g is None) == (r is None), (route, kind, prof, rowwise)
                        assert g is None or (torch.equal(g, a) and torch.equal(g, r)), \
                            f"K7 {route} {kind} {prof} rowwise={rowwise}: differs from the twin"
                    pl = plans[0]
                    seen.add((pl.split, pl.mode, isinstance(pl.terms[0][2], torch.Tensor),
                              pl.terms[1] is None))
                    n += 1
    # every route of the kernel was taken: split or not, the three modes,
    # static scales as floats and as device scalars, a table without an
    # imaginary part
    assert {k[0] for k in seen} == {True, False} and {k[1] for k in seen} == {0, 1, 2}
    assert {k[2] for k in seen} == {True, False} and {k[3] for k in seen} == {True, False}
    log(f"phase 3 K7 sliced_epilogue: {n} calls (5 routes x 4 kinds x 3 profiles x global / "
        f"rowwise scales) bit-identical to the twin, one launch each, two launches bit-equal")


# K6's kernel wrappers (core/pairs.py) and their plain twins; K6p's three
# modes are three wrappers of one kernel
K6_TWINS = {"pair_products": "pair_products_plain", "pair_model": "pair_model_spectrum_plain",
            "pair_poly": "pair_poly_plain", "pair_poly_sub": "pair_poly_sub_plain",
            "pair_poly_add64": "pair_poly_add64_plain"}
# K6's kernels, by the wrapper that carries the launch counter, and the
# wrappers (modes) that launch each
K6_KERNELS = {"pair_products": ("pair_products",), "pair_model": ("pair_model",),
              "pair_poly": ("pair_poly", "pair_poly_sub", "pair_poly_add64")}
# K6p's modes by wrapper (pair_poly.mode_launches' keys)
K6P_MODES = {"pair_poly": "plane", "pair_poly_sub": "sub", "pair_poly_add64": "add64"}
# f32 operations per output element: TwoProd 17, TwoSum 6, the rest one each
K6A_OPS = {"hadamard_conj": 94, "mul_static": 94, "mul_static_rr": 21, "sep_mul": 42}


def k6_call_bound(name, args):
    """The bound of one K6 wrapper call (k6_call_work): its f32 operations,
    none of which is a fused multiply-add, at the issue rate."""
    return bound(*k6_call_work(name, args), FP32_NONFMA_OPS_PER_S)


def k6p_work(mode, SP, n0, n1):
    """(bytes, operations) of K6p in `mode` at (n0, n1) with SP terms: the
    tables (SP x (n0 + n1) f32 pairs) read once, the image (sub, f64) or the
    pair Dfl (add64) read once, the output (a pair, or f64) written once;
    per element 13 operations for the first term and 21 for each other (the
    splits hoisted: 4 per table value), plus sub's 12 (TwoSum, the lo terms,
    the image's split: three conversions and an f64 subtraction) or add64's
    11 (TwoSum, two adds, two conversions, an f64 add)."""
    n = n0 * n1
    epi = {"plane": 0, "sub": 12, "add64": 11}[mode]
    nbytes = 8 * SP * (n0 + n1) + (8 * n if mode != "plane" else 0) + 8 * n
    return nbytes, n * (13 + 21 * (SP - 1) + epi) + 4 * SP * (n0 + n1)


def k6_call_work(name, args):
    """(bytes, operations) of one K6 wrapper call: every plane of its operands read
    once at its own size (a broadcast table as the table; of the model's
    plane spectra the 1 + Fk + nss planes it reads), the scalars read once,
    the output planes written once; operations per output element: K6A_OPS
    (both lanes of a complex pair in 'mul_static_rr'), per ij of the model
    118 (the shift, the product, the compensated add) and 58 per scaling
    plane plus 62; K6p's from k6p_work. A call over a batch of pairs (the
    batched step; the single step is its batch of one) counts each pair's
    work."""
    planes = lambda p: [v for v in p if v is not None]          # noqa: E731
    if name == "pair_products":
        mode, A, B = args[:3]
        C = args[3] if len(args) > 3 else None
        ops = [A, B] + ([C] if C is not None else [])
        shape = np.broadcast_shapes(*(tuple(p.rh.shape) for p in ops))
        n = int(np.prod(shape))
        nout = 2 if A.ih is None else 4
        nbytes = 4 * (sum(v.numel() for p in ops for v in planes(p)) + nout * n)
        flops = n * K6A_OPS[mode] * (nout // 2 if mode == "mul_static_rr" else 1)
    elif name == "pair_model":
        sp, K, c, a00, scale, fold = args
        *lead, Fk, N0, N1h = K.rh.shape
        pairs_ = int(np.prod(lead))
        nss = 0 if a00 is None else a00.shape[-1]
        n = pairs_ * N0 * N1h
        nbytes = (16 * n * (1 + Fk + nss + Fk + 1) + 8 * pairs_ * (Fk + nss) + 8
                  + (0 if fold is None else 4 * N1h))
        flops = n * (118 * Fk + 58 * nss + 62)
    else:
        Uh, Ul, Mh, Ml = args[-4:]
        plane = args[0] if name == "pair_poly_sub" else args[0].rh if name != "pair_poly" else Uh
        pairs_ = plane.shape[0] if plane.dim() == 3 else 1
        nbytes, flops = k6p_work(K6P_MODES[name], Uh.shape[-2], Uh.shape[-1], Mh.shape[-1])
        nbytes, flops = pairs_ * nbytes, pairs_ * flops
    return nbytes, flops


def k6_library(name, args):
    """The yardstick of a K6 call: one PyTorch call that computes its
    function in f64 / complex128 on the same values (each pair operand
    summed into one tensor beforehand), as a callable, or None where no
    single call does (the separable weights' two products, the model
    spectrum). A * conj(B) and the table products: torch.mul; K6p: the
    plane U^T M as torch.matmul, I - U^T M and Dfl + U^T M as torch.addmm
    (K = SP; torch.baddbmm over a batch of pairs). Timed here only; the
    port never calls them."""
    import torch

    def f64(p):
        re = p.rh.double() + p.rl
        return re if p.ih is None else torch.complex(re, p.ih.double() + p.il)

    if name == "pair_products":
        mode, A, B = args[:3]
        if mode == "sep_mul":
            return None
        a, b = f64(A), f64(B)
        if mode == "hadamard_conj":
            return lambda: torch.mul(a, b.conj())
        return lambda: torch.mul(a, b)
    if name in K6P_MODES:
        Uh, Ul, Mh, Ml = args[-4:]
        UT, M = (Uh.double() + Ul).transpose(-1, -2), Mh.double() + Ml
        if name == "pair_poly":
            return lambda: torch.matmul(UT, M)
        X = args[0] if name == "pair_poly_sub" else f64(args[0])
        alpha = -1 if name == "pair_poly_sub" else 1
        if X.dim() == 3:   # a batch of pairs (the single step: its batch of one)
            UT = UT.expand(X.shape[:1] + UT.shape[-2:])
            M = M.expand(X.shape[:1] + M.shape[-2:])
            return lambda: torch.baddbmm(X, UT, M, alpha=alpha)
        return lambda: torch.addmm(X, UT, M, alpha=alpha)
    return None


def k6_rand_pair(shape, seed, dev, real=False, view=None):
    """A seeded pair operand on the card over ~8 decades (lo ~2^-25 of hi);
    view(base) cuts each plane from a larger base tensor (an offset, a
    stride)."""
    import torch
    from sfft_tpu_torch.core import pairs

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    out = []
    for _ in range(1 if real else 2):
        mag = 10.0 ** (8 * torch.rand(shape, device=dev, generator=g) - 4)
        hi = (torch.randn(shape, device=dev, generator=g) * mag).float()
        lo = (hi * torch.randn(shape, device=dev, generator=g) * 2.0 ** -25).float()
        out += [hi, lo]
    if view is not None:
        out = [view(v) for v in out]
    return pairs.CPair(*out, *([None] * (4 - len(out))))


def k6_edge_pair(shape, seed, dev, real=False, ex=60):
    """A pair operand over 2^-ex .. 2^ex with +-0 and subnormal lo parts,
    as views at an offset of 1 element into their storage."""
    import torch
    from sfft_tpu_torch.core import pairs

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(1 if real else 2):
        x = rng.normal(size=shape) * 2.0 ** rng.integers(-ex, ex + 1, size=shape)
        hi = x.astype(np.float32)
        lo = (x - hi.astype(np.float64)).astype(np.float32)
        k = hi.size
        fh, fl = hi.reshape(-1), lo.reshape(-1)
        fh[: k // 8] = np.where(np.arange(k // 8) % 2, -0.0, 0.0)
        fl[: k // 8] = fh[: k // 8]
        fl[k // 8: k // 4] = rng.normal(size=k // 4 - k // 8) * 2.0 ** -135
        perm = rng.permutation(k)
        for v in (fh[perm], fl[perm]):
            base = torch.zeros(k + 1, dtype=torch.float32, device=dev)
            base[1:] = torch.as_tensor(v, device=dev)
            out.append(base[1:].view(shape))
    return pairs.CPair(*out, *([None] * (4 - len(out))))


def k6_equal(got, ref):
    """Two pairs' planes (or two tensors) equal bit for bit (values,
    whatever the layout)."""
    import torch

    if isinstance(got, torch.Tensor):
        return isinstance(ref, torch.Tensor) and torch.equal(got, ref)
    return all((g is None) == (r is None) and (g is None or torch.equal(g, r))
               for g, r in zip(got, ref))


def k6_numel(out):
    """Elements of a K6 call's first output plane."""
    import torch

    return (out if isinstance(out, torch.Tensor) else out[0]).numel()


def phase_k6():
    """K6 (the exact paths' pair products) against its twins, bit for bit,
    at the paths' shapes: the twiddles of a 4096-point DFT stage (2049 rows
    of (64, 64), the static table broadcast), A * conj(B) on a contract
    chunk (3 pairs at 4096 x 2049) and a v2 chunk (16 pairs at 900 x 451),
    the row weighting of both lanes of a strided (4096, 2049) view, a real
    plane times a row and a scalar, the separable weights at 900^2, the
    model spectrum at 4096 x 2049 (Fij 6) and 900 x 451 (Fij 25 + 6
    scaling planes), K6p's three modes at 4096^2 (the plane and the
    materialised difference at SP 6, the fluctuation at SP 4, as the
    contract path gives them); each launched twice (bit-equal, one launch
    each) and timed (graph replay) against its bound, its twin and, where
    one exists, the PyTorch call that computes the same function
    (k6_library); then every mode on +-0, subnormal lo parts and magnitudes
    near 2^+-60 on views at an offset, and K6p's modes on widths that are
    not a multiple of its column tile, odd widths and transposed inputs.
    Every K6 launch of a contract and a v2 step is held to the twins again
    in phases 6 and 7."""
    import torch
    from sfft_tpu_torch.core import exact_fft, pairs
    from sfft_tpu_torch.core.fdiff import _fold_weights
    from sfft_tpu_torch.core.statics import Static, table

    dev = torch.device("cuda")
    N1h = N // 2 + 1
    V1h = V2_N // 2 + 1

    def wr(shape, seed):
        return pairs.CPair(*exact_fft._split_on(Static(k6_table, (shape, seed)), dev), None,
                           None)

    def model_args(Fk, nss, n0, n1, seed):
        n1h = n1 // 2 + 1
        rng = np.random.default_rng(seed)
        sp = k6_rand_pair((1 + Fk + nss, n0, n1h), seed, dev)
        K = k6_rand_pair((Fk, n0, n1h), seed + 1, dev)
        c = torch.as_tensor(rng.normal(size=Fk) * 10.0 ** rng.uniform(-3, 1, Fk), device=dev)
        a00 = torch.as_tensor(rng.normal(size=nss), device=dev) if nss else None
        scale = exact_fft._split_on(Static(np.float64, (1.0 / (n0 * n1) * 1.1,)), dev)
        return sp, K, c, a00, scale, table(Static(_fold_weights, (n1,)), dev)

    tw = Static(exact_fft._dft_stage_mat, (N, False, "tw"))
    R, S = exact_fft._factor(N)
    cases = [
        ("pair_products", f"twiddle ({N1h}, {R}, {S}) x ({R}, {S})",
         lambda: ("mul_static", k6_rand_pair((N1h, R, S), 1, dev),
                  pairs.CPair(*exact_fft._split_on(Static(np.real, (tw,)), dev),
                              *exact_fft._split_on(Static(np.imag, (tw,)), dev)))),
        ("pair_products", f"A conj(B) contract chunk (3, {N}, {N1h})",
         lambda: ("hadamard_conj", k6_rand_pair((3, N, N1h), 2, dev),
                  k6_rand_pair((3, N, N1h), 3, dev))),
        ("pair_products", f"A conj(B) v2 chunk (16, {V2_N}, {V1h})",
         lambda: ("hadamard_conj", k6_rand_pair((16, V2_N, V1h), 4, dev),
                  k6_rand_pair((16, V2_N, V1h), 5, dev))),
        ("pair_products", f"row weighting, both lanes of a ({N}, {N1h}) view of row stride "
         f"{(R // 2 + 1) * S}",
         lambda: ("mul_static_rr", k6_rand_pair((N, (R // 2 + 1) * S), 6, dev,
                                                view=lambda v: v[:, :N1h]), wr((N, 1), 7))),
        ("pair_products", f"real ({N}, {N}) x a row (1, {N})",
         lambda: ("mul_static_rr", k6_rand_pair((N, N), 8, dev, real=True), wr((1, N), 9))),
        ("pair_products", f"real ({N}, {N}) x a scalar",
         lambda: ("mul_static_rr", k6_rand_pair((N, N), 10, dev, real=True), wr((), 11))),
        ("pair_products", f"separable weights ({V2_N}, {V2_N}) x ({V2_N}, 1) x (1, {V2_N})",
         lambda: ("sep_mul", k6_rand_pair((V2_N, V2_N), 12, dev, real=True), wr((V2_N, 1), 13),
                  wr((1, V2_N), 14))),
        ("pair_model", f"contract model ({N}, {N1h}) Fij 6", lambda: model_args(6, 0, N, N, 15)),
        ("pair_model", f"v2 model ({V2_N}, {V1h}) Fij 25 + 6",
         lambda: model_args(25, 6, V2_N, V2_N, 17)),
        ("pair_poly", f"polynomial plane ({N}, {N}) SP 6",
         lambda: k6_poly_args(6, N, N, 19, dev)),
        ("pair_poly_sub", f"image - polynomial plane ({N}, {N}) SP 4",
         lambda: k6_poly_args(4, N, N, 20, dev, "sub")),
        ("pair_poly_add64", f"pair + polynomial plane as f64 ({N}, {N}) SP 6",
         lambda: k6_poly_args(6, N, N, 21, dev, "add64")),
    ]
    report = {}
    for name, label, make in cases:
        args = make()
        wrapper, twin = getattr(pairs, name), getattr(pairs, K6_TWINS[name])
        # K6p's modes count on pair_poly
        counter = pairs.pair_poly if name in K6P_MODES else wrapper
        before = counter.launches
        got = wrapper(*args)
        again = wrapper(*args)
        torch.cuda.synchronize()
        assert counter.launches == before + 2, (name, label)
        ref = twin(*args)
        assert k6_equal(got, again), f"K6 {name} {label}: two launches differ"
        assert k6_equal(got, ref), f"K6 {name} {label}: differs from the twin"
        big = k6_numel(got) > 2 ** 24
        ms = graph_ms(lambda: wrapper(*args), calls=3 if big else 20, reps=3 if big else 7)
        pms = cuda_ms(lambda: twin(*args), reps=3, inner=1)
        lib = k6_library(name, args)
        lms = None if lib is None else graph_ms(lib, calls=3 if big else 20, reps=3 if big else 7)
        bms, by = k6_call_bound(name, args)
        report[label] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=lms)
        copy = ""
        if name in ("pair_poly_sub", "pair_poly_add64"):
            # the memory floor in practice: a copy of an f64 plane (the
            # bytes these modes move)
            plane = torch.empty(got.rh.shape if name == "pair_poly_sub" else got.shape,
                                dtype=torch.float64, device=dev)
            report[label]["copy_ms"] = graph_ms(lambda: plane.clone(), calls=3, reps=3)
            copy = f", an f64 copy of the same bytes {report[label]['copy_ms']:.4f} ms"
            del plane
        log(f"phase 3 K6 {name} {label}: bit-identical to the twin, two launches bit-equal; "
            f"device {ms:.4f} ms (graph replay), plain twin {pms:.3f} ms, library call "
            + ("none" if lms is None else f"{lms:.4f} ms") +
            f"{copy}, bound {bms:.4f} ms ({by}; {100 * bms / ms:.1f}% of it)")
        del args, got, again, ref, lib
    torch.cuda.empty_cache()

    # +-0, subnormal lo parts, magnitudes near 2^+-60, views at an offset
    shape = (3, 33, 47)
    A, B = k6_edge_pair(shape, 20, dev), k6_edge_pair(shape, 21, dev)
    real = pairs.CPair(A.rh, A.rl, None, None)
    # the tables of the real modes span 2^-30 .. 2^30, so that the chained
    # product of three factors stays finite
    col = k6_edge_pair((33, 1), 22, dev, real=True, ex=30)
    row = k6_edge_pair((1, 47), 23, dev, real=True, ex=30)
    n = 0
    for args in [("hadamard_conj", A, B), ("mul_static", A, k6_edge_pair((33, 47), 24, dev)),
                 ("mul_static_rr", A, col), ("mul_static_rr", real, row),
                 ("sep_mul", real, col, row)]:
        assert k6_equal(pairs.pair_products(*args), pairs.pair_products_plain(*args)), \
            f"K6 pair_products {args[0]} on edge values: differs from the twin"
        n += 1
    margs = model_args(5, 2, 40, 38, 25)
    margs = (margs[0], k6_edge_pair((5, 40, 20), 26, dev)) + margs[2:]
    assert k6_equal(pairs.pair_model(*margs), pairs.pair_model_spectrum_plain(*margs)), \
        "K6 pair_model on edge values: differs from the twin"
    # K6p's modes: edge values, then ragged widths (not a multiple of the
    # 128-column tile, odd: the scalar epilogue) and transposed inputs
    npoly = 0
    for n0, n1, edge, transposed in [(50, 70, True, False), (70, 50, True, True),
                                     (1000, 998, False, False), (130, 97, False, False),
                                     (998, 1000, False, True), (97, 130, False, True)]:
        for name in ("pair_poly", "pair_poly_sub", "pair_poly_add64"):
            if transposed and name == "pair_poly":
                continue
            args = k6_poly_args(4, n0, n1, 27, dev, K6P_MODES[name], edge, transposed)
            assert k6_equal(getattr(pairs, name)(*args), getattr(pairs, K6_TWINS[name])(*args)), \
                f"K6 {name} ({n0}, {n1}) edge={edge} transposed={transposed}: differs from the twin"
            npoly += 1
    torch.cuda.synchronize()
    log(f"phase 3 K6 on +-0, subnormal lo parts and magnitudes 2^-60 .. 2^60 (views at an "
        f"offset, broadcast tables): {n} pair_products modes, pair_model and K6p's modes "
        f"bit-identical to the twins; {npoly} K6p calls (edge values, ragged and odd widths, "
        f"transposed inputs) bit-identical to the twins")
    return report


def k6_table(shape, seed):
    """A seeded real static table for the K6 cases."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape) * 10.0 ** rng.uniform(-2, 2, size=shape)


def k6_poly_args(SP, n0, n1, seed, dev, mode="plane", edge=False, transposed=False):
    """K6p's arguments in `mode`: the tables as pexact makes them from
    seeded coefficients (U = coordinate powers (SP, n0), M = C @ V (SP,
    n1)), after an f64 image (sub) or a pair Dfl (add64) at the plane's
    scale over 3 decades; with edge=True the tables and the image or Dfl
    span 2^-60 .. 2^60 with +-0 and subnormal lo parts; transposed lays the
    image or Dfl out with strides (1, n0)."""
    import torch
    from sfft_tpu_torch.core import pairs, pexact

    rng = np.random.default_rng(seed)
    C = torch.as_tensor(rng.normal(size=(SP, SP)) * 10.0 ** rng.uniform(-3, 3, (SP, SP)),
                        device=dev)
    tabs = pexact._poly_tables(C, n0, n1)
    if edge:
        tabs = (k6_edge_pair((SP, n0), seed + 1, dev, real=True)[:2]
                + k6_edge_pair((SP, n1), seed + 2, dev, real=True)[:2])
    if mode == "plane":
        return tuple(tabs)
    if edge:
        d = k6_edge_pair((n0, n1), seed + 3, dev, real=True)
    else:
        x = rng.normal(size=(n0, n1)) * 10.0 ** rng.uniform(-2, 1, (n0, n1))
        x = torch.as_tensor(x, device=dev) * float(tabs[2].abs().max())
        hi = x.to(torch.float32)
        d = pairs.CPair(hi, (x - hi.double()).to(torch.float32), None, None)
    if transposed:
        d = pairs.CPair(*(v.t().contiguous().t() for v in d[:2]), None, None)
    if mode == "sub":
        return (d.rh.double() + d.rl,) + tuple(tabs)
    return (d,) + tuple(tabs)


def phase_kernels():
    import torch
    from sfft_tpu_torch.core import exact_fft

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    N1h = N // 2 + 1
    report = {"moments": phase_k3(), "corr_window": phase_k1()}
    torch.cuda.empty_cache()
    report["k1_v2"] = phase_k1_v2()
    report["fdiff_model"] = phase_k2()
    phase_k7()
    report["k6_alone"] = phase_k6()
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


def k6_signature(name, args):
    """The launch signature of a K6 wrapper call: its name, the mode, and
    each tensor operand's shape and strides (scalars and tables by shape)."""
    def sig(x):
        if x is None or isinstance(x, str):
            return x
        if isinstance(x, tuple):
            return tuple(sig(v) for v in x)
        return (tuple(x.shape), tuple(x.stride()))

    return (name,) + tuple(sig(a) for a in args)


def k6_label(sig):
    """A K6 signature as a log reads it: the mode and each operand's shape
    and strides (of a pair, its first plane's)."""
    def one(v):
        if isinstance(v, str):
            return v
        if len(v) == 2 and all(isinstance(t, tuple) and all(isinstance(i, int) for i in t)
                               for t in v):
            return "x".join(map(str, v[0])) + f"/{v[1]}"
        return one(v[0])

    return " ".join(one(v) for v in sig[1:] if v is not None)


def slicers_on_path(run, phase, path):
    """Two steps of one path (`run` drives one) with every K4 and K5 launch
    and the steady step's K7 launches checked: their outputs (slices,
    scales, and Ah of the K5 matrix stage; the K7 pair planes) against the
    plain twin on the same inputs, bit for bit. K7 launches are timed where
    their signature first appears in the steady step (their int32 products
    are too large to keep): device time (graph replay), the twin's, the
    bound. The first step runs with the static-table caches emptied, so the
    big static tables are sliced again; the second is a steady-state step.
    Then each distinct
    launch signature (shape, strides, alignment, rowwise, nsl, padded width,
    parts) is timed on its first inputs: the stage's device time (calls
    replayed in a CUDA graph), back to back from Python, its plain twin,
    the kernels one call launches and its bound, summed over the steady
    step's launches. Every K6 launch of the steady step (pair_products,
    pair_model, pair_poly) is held to its twin bit for bit and timed the same
    way, summed per steady step. Returns the report of each slicer and K6
    kernel that the path launched."""
    import torch
    from sfft_tpu_torch.core import exact_fft, pairs, slicing, solve

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

    def checked4(parts, nsl, Kp, rowwise, scales=None, batch=0):
        assert batch <= 1, f"a batch of {batch} pairs on the {path} path's single step"
        got = launch4(parts, nsl, Kp, rowwise, scales, batch)
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

    epi7 = exact_fft.sliced_epilogue
    counts7 = [{}, {}]
    rep7 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
                bytes_ms=0.0, first=0, steady=0, signatures=0)
    timed7 = {}

    def checked7(P, plan, sd):
        got = epi7(P, plan, sd)
        sig = k7_signature(P, plan, sd)
        counts7[step[0]][sig] = counts7[step[0]].get(sig, 0) + 1
        if step[0] == 0:
            return got
        ref = exact_fft.sliced_epilogue_plain(P, plan, sd)
        assert all((g is None) == (r is None) and (g is None or torch.equal(g, r))
                   for g, r in zip(got, ref)), \
            f"sliced_epilogue on the {path} path {sig[:3]} mode {plan.mode}: differs from the twin"
        if sig not in timed7:
            big = P.numel() > 2 ** 26
            ms = graph_ms(lambda: epi7(P, plan, sd), calls=3 if big else 20, reps=3 if big else 7)
            pms = cuda_ms(lambda: exact_fft.sliced_epilogue_plain(P, plan, sd), reps=3, inner=1)
            timed7[sig] = (ms, pms) + k7_bound(P, plan, sd)
        return got

    # K6: the callers reach the wrappers through the module, so replacing
    # them there intercepts every launch
    k6 = {name: getattr(pairs, name) for name in K6_TWINS}
    counts6 = [{}, {}]
    timed6 = {}

    def checked6(name):
        real, twin = k6[name], getattr(pairs, K6_TWINS[name])

        def run6(*args):
            got = real(*args)
            sig = k6_signature(name, args)
            counts6[step[0]][sig] = counts6[step[0]].get(sig, 0) + 1
            if step[0] == 0:
                return got
            assert k6_equal(got, twin(*args)), \
                f"{name} on the {path} path {k6_label(sig)}: differs from the twin"
            if sig not in timed6:
                big = k6_numel(got) > 2 ** 24
                ms = graph_ms(lambda: real(*args), calls=3 if big else 20, reps=3 if big else 7)
                pms = cuda_ms(lambda: twin(*args), reps=3, inner=1)
                lib = k6_library(name, args)
                lms = None if lib is None else graph_ms(lib, calls=3 if big else 20,
                                                        reps=3 if big else 7)
                timed6[sig] = (ms, pms, lms) + k6_call_bound(name, args)
            return got

        return run6

    exact_fft._static_slices_for.cache_clear()
    exact_fft._stacked.cache_clear()
    slicing._launch_pairs = checked4
    solve.slice_rows_f64, solve.slice_vec_f64 = checked_rows, checked_vec
    exact_fft.sliced_epilogue = checked7
    for name in k6:
        setattr(pairs, name, checked6(name))
    try:
        for step[0] in (0, 1):
            run()
            torch.cuda.synchronize()
    finally:
        slicing._launch_pairs = launch4
        solve.slice_rows_f64, solve.slice_vec_f64 = rows5, vec5
        exact_fft.sliced_epilogue = epi7
        for name, fn in k6.items():
            setattr(pairs, name, fn)
    # library_ms: the yardsticks summed where every signature has one
    rep6 = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                       bytes_ms=0.0, first=0, steady=0, signatures=0) for name in k6}
    for sig, (ms, pms, lms, bms, by) in sorted(timed6.items(), key=lambda kv: str(kv[0])):
        count, r = counts6[1][sig], rep6[sig[0]]
        r["ms"] += count * ms
        r["plain_ms"] += count * pms
        r["library_ms"] = None if lms is None or r["library_ms"] is None else \
            r["library_ms"] + count * lms
        r["bound_ms"] += count * bms
        r["bytes_ms"] += count * bms * (by == "bytes")
        r["first"] += counts6[0].get(sig, 0)
        r["steady"] += count
        r["signatures"] += 1
        log(f"phase {phase} {sig[0]} on the {path} path {k6_label(sig)}: {counts6[0].get(sig, 0)} "
            f"launches at first use, {count} per steady step, bit-identical to the twin; device "
            f"{ms:.4f} ms (graph replay), plain twin {pms:.4f} ms, library call "
            + ("none" if lms is None else f"{lms:.4f} ms") +
            f", bound {bms:.4f} ms ({by}; {100 * bms / ms:.1f}% of it)")
    for sig, (ms, pms, bms, by) in sorted(timed7.items(), key=lambda kv: str(kv[0])):
        count = counts7[1][sig]
        rep7["ms"] += count * ms
        rep7["plain_ms"] += count * pms
        rep7["bound_ms"] += count * bms
        rep7["bytes_ms"] += count * bms * (by == "bytes")
        rep7["first"] += counts7[0].get(sig, 0)
        rep7["steady"] += count
        rep7["signatures"] += 1
        log(f"phase {phase} sliced_epilogue on the {path} path P {sig[0]} out "
            f"{sig[1] + (sig[2],)} groups {len(sig[3])} combos "
            f"{sum(len(c) for c in sig[3])} split={sig[5]} mode {sig[9]} terms "
            f"{sum(t is not None for t in sig[8])}: {counts7[0].get(sig, 0)} launches at first "
            f"use, {count} per steady step, bit-identical to the twin; device {ms:.4f} ms "
            f"(graph replay), plain twin {pms:.4f} ms, bound {bms:.4f} ms ({by}; "
            f"{100 * bms / ms:.1f}% of it)")
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
            f"{r['steady']} per steady step ({r['kernels']} kernel launches, the wrappers' "
            f"counters), {r['signatures']} signatures, all bit-identical to the twins; per "
            f"steady step device "
            f"{r['ms']:.4f} ms, back to back {r['eager_ms']:.4f} ms, plain twin "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of the device time); no single PyTorch call "
            f"computes it")
    for name, r in rep6.items():
        if not r["steady"]:
            continue
        r["bound_by"] = "bytes" if 2 * r.pop("bytes_ms") >= r["bound_ms"] else "operations"
        reports[name] = r
        log(f"phase {phase} {name} on the {path} path: {r['first']} launches at first use and "
            f"{r['steady']} per steady step, {r['signatures']} signatures, the steady step's "
            f"bit-identical to the twin; per steady step device {r['ms']:.4f} ms, plain twin "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of the device time); library calls "
            + ("none for some signature" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms"))
    if rep7["steady"]:
        rep7["bound_by"] = "bytes" if 2 * rep7.pop("bytes_ms") >= rep7["bound_ms"] else \
            "operations"
        reports["sliced_epilogue"] = rep7
        log(f"phase {phase} sliced_epilogue on the {path} path: {rep7['first']} launches at "
            f"first use and {rep7['steady']} per steady step, {rep7['signatures']} signatures, "
            f"the steady step's bit-identical to the twin; per steady step device "
            f"{rep7['ms']:.4f} ms, plain "
            f"twin {rep7['plain_ms']:.4f} ms, bound {rep7['bound_ms']:.4f} ms "
            f"({rep7['bound_by']}, {100 * rep7['bound_ms'] / rep7['ms']:.1f}% of the device "
            f"time); no single PyTorch call computes it")
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


def wrapper_launches(fn):
    """Kernel launches of one call of fn as the K4 and K5 wrappers count
    them (slice_pair.launches and, where the checkout has it,
    slice_pair.scale_launches; slice_triple.launches)."""
    import torch
    from sfft_tpu_torch.core import slicing

    counters = [(slicing.slice_pair, "launches"), (slicing.slice_pair, "scale_launches"),
                (slicing.slice_triple, "launches")]
    counters = [(f, a) for f, a in counters if hasattr(f, a)]
    before = [getattr(f, a) for f, a in counters]
    fn()
    torch.cuda.synchronize()
    return sum(getattr(f, a) - b for (f, a), b in zip(counters, before))


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

    def cm(data, W, rowwise=False, real_out=False, prof=None, plain=False, **kw):
        assert kw.get("batch", 0) <= 1, "capture_stages drives single steps"
        nsl = (prof or exact_fft.SliceProfile(exact_fft.NSL_DATA, exact_fft.NSL_STATIC,
                                              exact_fft.KMAX)).nsl_data
        K = W.host().shape[0]
        parts = [(data.rh, data.rl)] + ([] if data.is_real else [(data.ih, data.il)])
        sig = ("K4", tuple(data.rh.shape), tuple(data.rh.stride()),
               data.rh.data_ptr() % 16 == 0, bool(rowwise), nsl, K + (-K) % 8, len(parts))
        note(sig, lambda: [(_clone_view(h), _clone_view(l)) for h, l in parts])
        return real_cm(data, W, rowwise, real_out, prof, plain, **kw)

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
        nkern = wrapper_launches(call)
        nops = device_launches(call)
        torch.cuda.synchronize()
        row = dict(sig=[str(v) for v in sig], count=count, ms=ms, eager_ms=eager, plain_ms=pms,
                   kernel_launches=nkern, device_ops=nops, bound_ms=bms, bound_by=by)
        rows.append(row)
        s = sums.setdefault(kind, dict(ms=0.0, eager_ms=0.0, plain_ms=0.0, kernel_launches=0,
                                       device_ops=0, bound_ms=0.0, calls=0, signatures=0))
        for k in ("ms", "eager_ms", "plain_ms", "bound_ms"):
            s[k] += count * row[k]
        s["kernel_launches"] += count * nkern
        s["device_ops"] += count * nops
        s["calls"] += count
        s["signatures"] += 1
        log(f"stages {path} {label} {sig}: {count} calls per step; device {ms:.4f} ms (graph "
            f"replay), back to back {eager:.4f} ms, plain twins {pms:.4f} ms; per call {nkern} "
            f"K4 / K5 kernel launches (the wrappers' counters) and {nops} kernels and copies "
            f"(profiler events, all kernels and copies of the stage); bound {bms:.4f} ms ({by})")
    for kind, s in sums.items():
        log(f"stages {path} {label} {kind} per step: {s['calls']} calls, {s['signatures']} "
            f"signatures, {s['kernel_launches']} K4 / K5 kernel launches (wrappers' counters), "
            f"{s['device_ops']} kernels and copies (profiler); device {s['ms']:.4f} ms, back to "
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


def _dev_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


# times a profile that lost device records is taken again (direct_profile,
# _warm_device_events)
PROFILE_TRIES = 4


def _on_device(e):
    # kernels and copies carry the device type; the host operators that
    # launched them report the same time again
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def profile_step(step):
    """torch.profiler over one call of `step` (ending in a synchronize):
    (profile, wall s, device busy s (kernels and copies), their count, idle
    share of the wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if _on_device(e)]
    busy = sum(_dev_us(e) for e in kernels) / 1e6
    return prof, wall, busy, sum(e.count for e in kernels), 1 - busy / wall


def device_busy(step):
    """Device busy seconds (kernels and copies) and their count over one call
    of `step`, from a profiler that traces the device only (tracing the
    host's operators too costs seconds on a step of 30k launches) and opens
    with a warm-up step, traced and dropped (after phases 1-12 a profile
    without it loses the start of a step: direct_profile)."""
    kernels = _warm_device_events(step)
    return sum(_dev_us(e) for e in kernels) / 1e6, sum(e.count for e in kernels)


def _warm_device_events(step):
    """The device's kernels and copies over the second of two calls of
    `step` (torch.profiler's schedule: one call traced and dropped, the
    next kept)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                step()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in prof.key_averages() if _on_device(e)]
        if events:
            return events
    raise AssertionError(f"{PROFILE_TRIES} profiles of a step held no device record")


def device_ms_of(step, keys):
    """Device ms of the kernels whose names hold one of `keys` over one call
    of `step` (a warmed device-only profile, as device_busy)."""
    return sum(_dev_us(e) for e in _warm_device_events(step)
               if any(k in e.key for k in keys)) / 1e3


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
    from sfft_tpu_torch import PureTorchCustomizedPacket, make_config
    from sfft_tpu_torch.core import fdiff, greek, moments

    cfg = make_config(N, N, KERHW, greek_backend="peeled", fdiff_backend="fft32",
                      solver="refined")
    assert cfg.NEQ == 1740 and cfg.fluct_dtype == "float32"
    moments.moments.launches = 0
    greek.corr_window.launches = 0
    fdiff.fdiff_model.launches = 0
    sol, diff, step_s = run_pcp(I, J, cfg, plain=False, reps=3)
    launches = {"moments": moments.moments.launches,
                "corr_window": greek.corr_window.launches,
                "fdiff_model": fdiff.fdiff_model.launches}
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
    # the same step with K2 alone on its twin (the f32 order of the
    # difference's sums is K2's own)
    real = fdiff.fdiff_model
    fdiff.fdiff_model = fdiff.fdiff_model_plain
    try:
        _, diff_k2twin, _ = run_pcp(I, J, cfg, plain=False, reps=1)
    finally:
        fdiff.fdiff_model = real
    on_path = kernels_on_path(
        lambda: PureTorchCustomizedPacket.PCP(I, J, I, J, "REF", KERHW, cfg=cfg), "fast", 4)
    return sol, diff, diff_k2twin, launches, step_s, plain_s, on_path


def phase_f64(I, J, diff_fast, diff_k2twin):
    import torch
    from sfft_tpu_torch import make_config

    cfg = make_config(N, N, KERHW)
    assert (cfg.greek_backend, cfg.fdiff_backend, cfg.solver) == ("fft", "fft", "lu")
    sol64, diff64, step_s = run_pcp(I, J, cfg, plain=True, reps=1)
    assert bool(torch.isfinite(diff64).all())
    rms = float(torch.sqrt(torch.mean((diff_fast - diff64) ** 2)))
    rms_twin = float(torch.sqrt(torch.mean((diff_k2twin - diff64) ** 2)))
    assert rms < 0.05, f"fast vs f64 difference RMS {rms:.4e} >= 0.05"
    assert rms_twin < 0.05, f"fast (K2 twin) vs f64 difference RMS {rms_twin:.4e} >= 0.05"
    log(f"phase 5 f64 fft/fft/lu on the plain twins: step {step_s * 1e3:.1f} ms; "
        f"RMS(diff_fast - diff_f64) = {rms:.4e} with K2, {rms_twin:.4e} with K2's twin "
        f"(bound 0.05)")
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
    return solx, diffx, rms, rms_twin


def phase_contract(I, J, sol64, diff64):
    """The contract path (pexact / pexact / transformed at (8, 7, 6)) with
    the kernels and on the plain twins, then once with the 'exact' solver;
    each held to the f64 fft/fft/exact path."""
    import torch
    from sfft_tpu_torch import PureTorchCustomizedPacket, make_config
    from sfft_tpu_torch.core import exact_fft, greek, moments, pairs, slicing

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
    exact_fft.sliced_epilogue.launches = 0
    for name in K6_KERNELS:
        getattr(pairs, name).launches = 0
    pairs.pair_poly.mode_launches = dict.fromkeys(pairs.pair_poly.mode_launches, 0)
    pairs.pair_products.copies = pairs.pair_model.copies = 0
    sol, diff, step_s = run_pcp(I, J, cfg, plain=False, reps=3)
    # K4: its slicing launches and its global-max launches (one source)
    launches = {"moments": moments.moments.launches,
                "corr_window": greek.corr_window.launches,
                "slice_pair": slicing.slice_pair.launches + slicing.slice_pair.scale_launches,
                "slice_pair_scale": slicing.slice_pair.scale_launches,
                "sliced_epilogue": exact_fft.sliced_epilogue.launches}
    launches.update({name: getattr(pairs, name).launches for name in K6_KERNELS})
    launches.update({name: pairs.pair_poly.mode_launches[mode]
                     for name, mode in K6P_MODES.items() if name != "pair_poly"})
    # operand planes that K6 had to make contiguous (planes of one pair with
    # different strides)
    launches["pair_copies"] = pairs.pair_products.copies + pairs.pair_model.copies
    peak = torch.cuda.max_memory_allocated()
    assert (launches["moments"] > 0 and launches["slice_pair"] > 0
            and launches["sliced_epilogue"] > 0
            and all(launches[name] > 0 for name in K6_KERNELS)), \
        f"a kernel of the contract path never launched: {launches}"
    # K6p: the two fluctuations (sub) and the difference (add64), one launch
    # each a step, never a bare plane
    assert (pairs.pair_poly.mode_launches == {"plane": 0, "sub": 8, "add64": 4}
            and launches["pair_poly"] == 12), \
        f"K6p on the contract path: {pairs.pair_poly.mode_launches} in 4 runs"
    rms, drms, srel = check("contract", sol, diff)
    log(f"phase 6 contract {N}^2 KerHW={KERHW} pexact/pexact/transformed prof (8, 7, 6): "
        f"median step {step_s * 1e3:.1f} ms over 3 runs; launches {launches} in 4 runs; "
        f"peak memory {peak / 2**30:.2f} GiB; central diff RMS {rms:.4f}; "
        f"RMS(diff - diff_f64) = {drms:.3e} (bound 1e-6); "
        f"max|sol - sol_f64|/max|sol_f64| = {srel:.3e} (bound 1e-6)")
    # the same step with K7 alone on its twin: the same bits
    step = lambda: PureTorchCustomizedPacket.PCP(I, J, I, J, "REF", KERHW, cfg=cfg)
    tsol, tdiff = one_twin(exact_fft, "sliced_epilogue", exact_fft.sliced_epilogue_plain, step)
    assert torch.equal(tsol, sol) and torch.equal(tdiff, diff), \
        "contract: the step with K7 differs from the step with K7 on its twin"
    # and with K6 (its three kernels) alone on its twins
    tsol, tdiff = k6_on_twins(step)
    assert torch.equal(tsol, sol) and torch.equal(tdiff, diff), \
        "contract: the step with K6 differs from the step with K6 on its twins"
    del sol, diff, tsol, tdiff
    _, wall, busy, nk, idle = profile_step(step)
    prof = dict(step_ms=step_s * 1e3, k7_launches=launches["sliced_epilogue"] / 4,
                k6_launches={name: launches[name] / 4 for name in K6_KERNELS},
                wall_ms=wall * 1e3, busy_ms=busy * 1e3, kernels=nk, idle=idle)
    log(f"phase 6 contract step with K7 alone on its twin and with K6 alone on its twins: "
        f"solution and difference bit-identical; per step {prof['k7_launches']:.0f} K7 "
        f"launches, K6 {prof['k6_launches']}; one profiled step: "
        f"wall {prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms in {nk} kernels "
        f"and copies, idle share {idle:.3f}")
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
    on_path = slicers_on_path(step, 6, "contract")
    return launches, step_s, plain_s, peak, drms, srel, on_path, prof


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
    from sfft_tpu_torch.core import exact_fft, greek, moments, pairs, slicing, solve
    from sfft_tpu_torch.io import fits

    n = V2_N
    c = slice(n // 4, 3 * n // 4)
    counters = {"moments": moments.moments, "corr_window": greek.corr_window,
                "slice_pair": slicing.slice_pair, "slice_triple": slicing.slice_triple,
                "sliced_epilogue": exact_fft.sliced_epilogue}
    counters.update({name: getattr(pairs, name) for name in K6_KERNELS})
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
        pairs.pair_products.copies = pairs.pair_model.copies = 0
        sol, diff, step_s = run_bsp(ref, sci, cfg, plain=False, reps=3)
        launches = {k: f.launches for k, f in counters.items()}
        launches["pair_copies"] = pairs.pair_products.copies + pairs.pair_model.copies
        launches["slice_pair_scale"] = slicing.slice_pair.scale_launches
        launches["slice_pair"] += launches["slice_pair_scale"]
        peak = torch.cuda.max_memory_allocated()
        # (the v2 exact path has no polynomial plane: pair_poly is pexact's)
        assert (launches["slice_pair"] > 0 and launches["slice_triple"] > 0
                and launches["sliced_epilogue"] > 0 and launches["pair_products"] > 0
                and launches["pair_model"] > 0), \
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

        # the same step with K7 alone on its twin: the same bits
        step = lambda: BSplinePacket.BSP(ref, sci, ref, sci, cfg=cfg)
        tsol, tdiff = one_twin(exact_fft, "sliced_epilogue", exact_fft.sliced_epilogue_plain,
                               step)
        assert np.array_equal(tsol, sol) and np.array_equal(tdiff, diff), \
            "v2: the step with K7 differs from the step with K7 on its twin"
        tsol, tdiff = k6_on_twins(step)
        assert np.array_equal(tsol, sol) and np.array_equal(tdiff, diff), \
            "v2: the step with K6 differs from the step with K6 on its twins"
        del tsol, tdiff
        _, wall, busy, nk, idle = profile_step(step)
        prof = dict(step_ms=step_s * 1e3, k7_launches=launches["sliced_epilogue"] / 4,
                    k6_launches={name: launches[name] / 4 for name in K6_KERNELS},
                    wall_ms=wall * 1e3, busy_ms=busy * 1e3, kernels=nk, idle=idle)
        log(f"phase 7 v2 step with K7 alone on its twin and with K6 alone on its twins: "
            f"solution and difference bit-identical; per step {prof['k7_launches']:.0f} K7 "
            f"launches, K6 {prof['k6_launches']}; one profiled "
            f"step: wall {prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms in {nk} "
            f"kernels and copies, idle share {idle:.3f}")

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
            slicers = slicers_on_path(step, 7, "v2")
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
                ydiff=ydiff, prof=prof,
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
    the fast slice's shapes, and of K2 (c64) at the fast and the v2 shapes:
    device time per kernel name (K1's two stages and the mirror's glue, K2's
    two launches apart). The table goes to out_dir too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    each = slice_kernel_calls()
    for name, (Fij, Fpq, nS, n, w) in {"K2 fast": (6, 6, 0, N, KERHW),
                                       "K2 v2": (25, 1, 6, V2_N, V2_KERHW)}.items():
        args, fdiff = k2_inputs(Fij, Fpq, nS, n, n, w, torch.complex64)
        each[name] = lambda args=args, fdiff=fdiff: fdiff.fdiff_model(*args)

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
    kernels = [e for e in ev if _on_device(e)]
    for e in sorted(kernels, key=_dev_us, reverse=True)[:12]:
        log(f"kernel profile: {e.key[:90]:90s} {_dev_us(e) / e.count / 1e3:9.4f} ms x{e.count}")
    with open(os.path.join(out_dir, "profile_kernels.txt"), "w") as f:
        f.write(ev.table(sort_by="self_cuda_time_total", row_limit=40, max_name_column_width=120))
    # K2's two launches at each shape apart (one kernel name serves both)
    for name in ("K2 fast", "K2 v2"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                each[name]()
            torch.cuda.synchronize()
        for e in sorted((e for e in prof.key_averages() if _on_device(e)), key=_dev_us,
                        reverse=True):
            log(f"kernel profile {name}: {e.key[:70]:70s} {_dev_us(e) / e.count / 1e3:9.4f} ms "
                f"x{e.count}")


# K6's functions as (module, name) and the f32 operations per output element
# of each (TwoProd 17, TwoSum 6, the rest one each), or None where
# k6_call_work counts the call (the kernel wrappers and their callers that
# take plain tensors); a function a checkout lacks is skipped
K6_FUNCS = {("exact_fft", "_pair_hadamard_conj"): 94, ("exact_fft", "_pair_mul_static"): 94,
            ("exact_fft", "_pair_mul_static_rr"): 21, ("exact_fft", "pair_sep_mul"): 42,
            ("exact_fft", "_two_prod"): 17, ("pexact", "pair_poly_plane"): None,
            ("pairs", "pair_products"): None, ("pairs", "pair_model"): None,
            ("pairs", "pair_poly"): None, ("pairs", "pair_poly_sub"): None,
            ("pairs", "pair_poly_add64"): None}


# --profile's split of the exact paths' device time by function: (category,
# the functions whose launches it takes, as (module, name), and the hand
# kernels it takes by name); a function that a checkout lacks is skipped, so
# the split runs in an older checkout too. Each function is wrapped from
# outside in a profiler range; a library kernel counts for the innermost
# range around the operator that launched it. The hand kernels launch from
# ctypes, outside any operator, and count by their names; concatenation
# copies by theirs.
SPLIT = [
    ("K7 epilogue", [("exact_fft", "sliced_epilogue"), ("exact_fft", "sliced_epilogue_plain"),
                     ("exact_fft", "_accum")], ["sliced_epilogue_kernel"]),
    ("K6 pair products", list(K6_FUNCS), ["pair_products_kernel", "pair_model_kernel",
                                          "pair_poly_kernel"]),
    ("K4 slicing stage", [("exact_fft", "_slice_pairs")],
     ["absmax_kernel", "pairs_row_kernel", "pairs_tile_kernel", "rowmax_tile_kernel"]),
    ("int8 products", [("exact_fft", "_int_mm")], []),
    ("rest of _cmatmul_sliced", [("exact_fft", "_cmatmul_sliced")], []),
    ("K3 moments", [("moments", "moments")], ["moments_kernel"]),
    ("K5 slicing", [], ["rows_f64_kernel", "triple_f32_kernel", "vec_f64_kernel"]),
    ("solve", [("solve", "solve_system")], []),
]


def wrap_everywhere(fn, wrapper, undo):
    """Replace fn by functools.wraps(fn)(wrapper) (its counters ride along)
    in every loaded module of the package that holds it; undo collects
    (module, name, fn) to restore."""
    import functools

    wrapped = functools.wraps(fn)(wrapper)
    for name, m in list(sys.modules.items()):
        if name.startswith("sfft_tpu_torch") and m is not None:
            for k, v in list(vars(m).items()):
                if v is fn:
                    setattr(m, k, wrapped)
                    undo.append((m, k, fn))


def split_ranges():
    """Wrap SPLIT's functions, wherever the package's modules hold them, in
    profiler ranges named 'split:<category>'; returns the function that
    restores them."""
    import torch

    undo = []
    for cat, funcs, _ in SPLIT:
        for mod, name in funcs:
            fn = package_attr(mod, name)
            if fn is None:
                continue

            def ranged(*args, _fn=fn, _label="split:" + cat, **kw):
                with torch.profiler.record_function(_label):
                    return _fn(*args, **kw)

            wrap_everywhere(fn, ranged, undo)

    def restore():
        for m, k, fn in undo:
            setattr(m, k, fn)

    return restore


def device_split(prof):
    """Device time (ms) of a profiled step by SPLIT category, and the total
    (kernels and copies; the ranges' own device annotations left out). Each
    device event counts once: by name (hand kernels, concatenation copies),
    else for the innermost range around the CUDA runtime call that launched
    it (the call carries the event's correlation id; operators' ids are
    another count and may collide with it)."""
    def by_name(name):
        if "CatArrayBatchedCopy" in name:
            return "concatenation copies"
        return next((c for c, _, kernels in SPLIT if any(k in name for k in kernels)), None)

    calls = {e.id: e for e in prof.events() if not _on_device(e) and e.name.startswith("cu")}
    out = dict.fromkeys([c for c, _, _ in SPLIT] + ["concatenation copies", "rest",
                                                    "no runtime call found"], 0.0)
    total = 0.0
    for e in prof.events():
        if not _on_device(e) or e.name.startswith("split:"):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        total += ms
        cat = by_name(e.name)
        if cat is None:
            p = calls.get(e.id)
            cat = "rest" if p is not None else "no runtime call found"
            while p is not None:
                if p.name.startswith("split:"):
                    cat = p.name[len("split:"):]
                    break
                p = p.cpu_parent
        out[cat] += ms
    return out, total


def package_attr(mod, name):
    """sfft_tpu_torch.core.<mod>.<name>, or None where the checkout lacks it."""
    import importlib

    try:
        return getattr(importlib.import_module(f"sfft_tpu_torch.core.{mod}"), name, None)
    except ModuleNotFoundError:
        return None


def k6_bound(step):
    """K6's bound over one step: every outermost call of K6_FUNCS (the
    kernel wrappers inside _pair_hadamard_conj and the like, pair_sep_mul's
    two inner products and TwoProds inside the others are part of their
    caller) reads its tensors and static tables once (a table's f32 (hi,
    lo) planes at its own shape, however broadcast) and writes its output
    planes once; operations per output element from K6_FUNCS, or the
    call's from k6_call_work, at the issue rate (none is a fused
    multiply-add). Returns (bound_ms, bound_by, calls)."""
    import torch
    from sfft_tpu_torch.core.statics import Static

    depth, acc = [0], dict(nbytes=0, flops=0, calls=0)

    def nbytes(x, planes):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        if isinstance(x, Static):
            return planes * 4 * int(np.asarray(x.host()).size)
        if isinstance(x, (tuple, list)):
            return sum(nbytes(v, planes) for v in x if v is not None)
        return 0

    def work(name, ops, planes, args, out):
        if ops is not None:
            return nbytes(args, planes) + nbytes(out, planes), ops * out[0].numel()
        if name == "pair_poly_plane":
            C, n0, n1 = args[:3]
            return k6p_work("plane", C.shape[0], n0, n1)
        return k6_call_work(name, args)

    undo = []
    for (mod, name), ops in K6_FUNCS.items():
        fn = package_attr(mod, name)
        if fn is None:
            continue
        # a complex static factor is four f32 planes (re, im; hi, lo), a real one two
        planes = 4 if name == "_pair_mul_static" else 2

        def counted(*args, _fn=fn, _name=name, _ops=ops, _planes=planes, **kw):
            depth[0] += 1
            try:
                out = _fn(*args, **kw)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                b, f = work(_name, _ops, _planes, args, out)
                acc["nbytes"] += b
                acc["flops"] += f
                acc["calls"] += 1
            return out

        wrap_everywhere(fn, counted, undo)
    try:
        step()
        torch.cuda.synchronize()
    finally:
        for m, k, fn in undo:
            setattr(m, k, fn)
    return bound(acc["nbytes"], acc["flops"], FP32_NONFMA_OPS_PER_S) + (acc["calls"],)


def phase_profile(I, J, out_dir):
    """--profile: the step time of each path (median of three, after two
    warm-ups), then torch.profiler over one more step (the v2 path's step is
    one BSplinePacket.BSP call on FITS files in a temporary directory):
    device busy time (kernels and copies),
    idle share of the profiled wall, and the top operations by device and by
    host time; the full tables go to out_dir/profile_<path>.txt. The
    contract and the v2 step are then profiled once more with SPLIT's ranges
    and their device time split by function (out_dir/split_<path>.json)."""
    import torch
    import tempfile

    from sfft_tpu_torch import BSplinePacket, PureTorchCustomizedPacket, make_config

    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.TemporaryDirectory()
    ref, sci = write_pair_fits(tmp.name)
    v2cfg = nircam_config(**EXACT_TRIO)
    fft32cfg = nircam_config(**FAST_TRIO)
    peeledcfg = nircam_config(**PEELED_TRIO)

    def pcp(**backends):
        cfg = make_config(N, N, KERHW, **backends)
        return lambda: PureTorchCustomizedPacket.PCP(I, J, I, J, "REF", KERHW, cfg=cfg)

    paths = {
        "contract": pcp(greek_backend="pexact", fdiff_backend="pexact", solver="transformed"),
        "fast": pcp(greek_backend="peeled", fdiff_backend="fft32", solver="refined"),
        "v2": lambda: BSplinePacket.BSP(ref, sci, ref, sci, cfg=v2cfg),
        "v2-fast-fft32": lambda: BSplinePacket.BSP(ref, sci, ref, sci, cfg=fft32cfg),
        "v2-fast-peeled": lambda: BSplinePacket.BSP(ref, sci, ref, sci, cfg=peeledcfg),
    }
    for name, step in paths.items():
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()
        prof, wall, busy, nk, idle = profile_step(step)
        peak = torch.cuda.max_memory_allocated()
        ev = prof.key_averages()
        kernels = [e for e in ev if _on_device(e)]
        cat = sum(_dev_us(e) for e in kernels if "CatArrayBatchedCopy" in e.key) / 1e3
        log(f"profile {name}: step {statistics.median(times) * 1e3:.1f} ms (median of 3, "
            f"unprofiled); profiled step: wall {wall * 1e3:.1f} ms, device busy "
            f"{busy * 1e3:.1f} ms in {nk} kernels and copies, idle share {idle:.3f}; "
            f"concatenation copies {cat:.2f} ms; peak memory {peak / 2**30:.2f} GiB")
        for e in sorted(kernels, key=_dev_us, reverse=True)[:12]:
            log(f"profile {name} device: {e.key[:60]:60s} {_dev_us(e) / 1e3:9.2f} ms "
                f"x{e.count}")
        for e in sorted(ev, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
            log(f"profile {name} host: {e.key[:60]:60s} {e.self_cpu_time_total / 1e3:9.2f} ms "
                f"x{e.count}")
        with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
            f.write(ev.table(sort_by="self_cuda_time_total", row_limit=80))
        if name not in ("contract", "v2"):
            continue
        restore = split_ranges()
        try:
            prof, swall, _, _, _ = profile_step(step)
        finally:
            restore()
        split, total = device_split(prof)
        b6, by6, calls6 = k6_bound(step)
        with open(os.path.join(out_dir, f"split_{name}.json"), "w") as f:
            json.dump(dict(wall_ms=swall * 1e3, busy_ms=total, split=split,
                           k6=dict(bound_ms=b6, bound_by=by6, calls=calls6),
                           unranged=dict(wall_ms=wall * 1e3, busy_ms=busy * 1e3, kernels=nk,
                                         idle=idle)), f, indent=1)
        log(f"profile {name} split of the device time (a step with the ranges: busy "
            f"{total:.1f} ms): " + "; ".join(
                f"{k} {v:.2f} ms" for k, v in sorted(split.items(), key=lambda kv: -kv[1])))
        log(f"profile {name} K6 pair products: {calls6} calls a step, bound {b6:.3f} ms "
            f"({by6}); {split['K6 pair products']:.2f} ms on the device, "
            f"{100 * b6 / split['K6 pair products']:.1f}% of it")
    tmp.cleanup()


# --- phase 10: the automatic pipelines (EasySparsePacket.ESP, EasyCrowdedPacket.ECP) ---

# a DECam CCD (NAXIS1 x NAXIS2, the reference's sparse example) and a TESS
# CCD (its crowded example)
EASY_SPARSE = (2046, 4094)
EASY_CROWDED = (2048, 2048)


def render_gaussians(shape, xs, ys, fluxes, vx, vy, hw):
    """Elliptical Gaussians of total flux `fluxes` and variances (vx, vy)
    (pixels^2, per object) evaluated at pixel centres within +-hw px of each
    object's nearest pixel: an image of `shape` (axis 0 = x). Objects lie
    at least hw px inside the image."""
    img = np.zeros(shape)
    off = np.arange(-hw, hw + 1)
    vx = np.broadcast_to(np.asarray(vx, float), xs.shape)
    vy = np.broadcast_to(np.asarray(vy, float), xs.shape)
    for k in range(0, len(xs), 2048):
        s = slice(k, k + 2048)
        px = np.rint(xs[s]).astype(np.int64)[:, None] + off
        py = np.rint(ys[s]).astype(np.int64)[:, None] + off
        gx = np.exp(-(px - xs[s, None]) ** 2 / (2 * vx[s, None]))
        gy = np.exp(-(py - ys[s, None]) ** 2 / (2 * vy[s, None]))
        amp = fluxes[s] / (2 * np.pi * np.sqrt(vx[s] * vy[s]))
        np.add.at(img, (px[:, :, None], py[:, None, :]),
                  amp[:, None, None] * gx[:, :, None] * gy[:, None, :])
    return img


def sparse_fields(seed=10):
    """A DECam-like sparse pair at EASY_SPARSE (axis 0 = x) from `seed`:
    2,500 point sources (fluxes 10^2.8-10^4.8) and 8 galaxies, FWHM 3.2 px
    in REF and 4.1 px in SCI, flux ratio 1.18, a background offset of 0.6 in
    SCI (the sparse prep takes the images as sky-subtracted: BACK_VALUE 0),
    unit noise, and one transient in SCI. Returns (ref, sci, transient (x,
    y), the difference's expected noise RMS)."""
    rng = np.random.default_rng(seed)
    shape, n, ng = EASY_SPARSE, 2500, 8
    xs, ys = rng.uniform(20, shape[0] - 20, n), rng.uniform(20, shape[1] - 20, n)
    fl = 10 ** rng.uniform(2.8, 4.8, n)
    gx, gy = rng.uniform(60, shape[0] - 60, ng), rng.uniform(60, shape[1] - 60, ng)
    gs2 = rng.uniform(3, 6, ng) ** 2
    gf = rng.uniform(2e3, 2e4, ng)
    vr, vs = (3.2 / 2.355) ** 2, (4.1 / 2.355) ** 2
    ref = (render_gaussians(shape, xs, ys, fl, vr, vr, 15)
           + render_gaussians(shape, gx, gy, gf, gs2 + vr, 2 * gs2 + vr, 45))
    sci = 1.18 * (render_gaussians(shape, xs, ys, fl, vs, vs, 15)
                  + render_gaussians(shape, gx, gy, gf, gs2 + vs, 2 * gs2 + vs, 45))
    t = (701.3, 1503.6)
    sci += render_gaussians(shape, np.array([t[0]]), np.array([t[1]]), np.array([4e4]), vs, vs,
                            15)
    ref += rng.normal(0, 1.0, shape)
    sci += 0.6 + rng.normal(0, 1.0, shape)
    # SCI's noise plus REF's through the matching kernel (a Gaussian of
    # variance vs - vr and sum 1.18: sum of squares 1.18^2 / (4 pi (vs - vr)))
    noise = np.sqrt(1.0 + 1.18 ** 2 / (4 * np.pi * (vs - vr)))
    return ref, sci, t, noise


def crowded_fields(seed=11):
    """A TESS-like crowded pair at EASY_CROWDED from `seed`: 20,000 stars at
    FWHM 3.0 px (fluxes 10^2.8-10^4.8, 200 of them 10^5-10^5.8) on a
    background of 600 with noise 2.5, clipped at SATURATE = 28000; SCI =
    1.12 (REF - 600) + 640 + noise, clipped
    (tools/make_golden_fixtures.py:60-68). Returns (ref, sci, the
    difference's expected noise RMS)."""
    rng = np.random.default_rng(seed)
    shape, n = EASY_CROWDED, 20000
    xs, ys = rng.uniform(20, shape[0] - 20, n), rng.uniform(20, shape[1] - 20, n)
    fl = 10 ** np.concatenate([rng.uniform(2.8, 4.8, n - 200), rng.uniform(5.0, 5.8, 200)])
    v = (3.0 / 2.355) ** 2
    ref = np.minimum(600.0 + render_gaussians(shape, xs, ys, fl, v, v, 15)
                     + rng.normal(0, 2.5, shape), 28000.0)
    sci = np.minimum(1.12 * (ref - 600.0) + 640.0 + rng.normal(0, 2.5, shape), 28000.0)
    return ref, sci, 2.5


def write_easy_pair(d, name, ref, sci, keys):
    """ref and sci (axis 0 = x) as float32 FITS files in d, with header
    keys."""
    from sfft_tpu_torch.io import fits

    hdr = fits.Header()
    for k, v in keys.items():
        hdr.add(k, v)
    paths = []
    for tag, img in (("ref", ref), ("sci", sci)):
        paths.append(os.path.join(d, f"{name}_{tag}.fits"))
        fits.write(paths[-1], img.T.astype(np.float32), hdr)
    return tuple(paths)


EASY_TRIOS = [
    # (label, backends, plain): the default trio with the kernels and on
    # the plain twins; the contract trio (sfft_tpu's TPU trio at pexact_prof
    # (8, 7, 6)) with the kernels and its yardstick, f64 fft / fft / exact,
    # on the plain twins; and fft / fft / exact with the kernels (K1, K2),
    # which holds the kernels' solution to the twins' through a refined
    # solve (an unrefined LU of these systems, cond ~1e18, moves the
    # solution by ~1e-6 of its maximum for rounding-level changes of the
    # tables)
    ("default", {}, False),
    ("default plain", {}, True),
    ("contract", dict(greek_backend="pexact", fdiff_backend="pexact", solver="exact"), False),
    ("fft/fft/exact plain", dict(solver="exact"), True),
    ("fft/fft/exact", dict(solver="exact"), False),
]


def zero_kernel_counts():
    """Every kernel wrapper's launch count to 0."""
    from sfft_tpu_torch.core import exact_fft, fdiff, greek, moments, pairs, slicing

    moments.moments.launches = 0
    greek.corr_window.launches = 0
    fdiff.fdiff_model.launches = 0
    greek._K8.launches = fdiff._K9.launches = 0
    slicing.slice_pair.launches = slicing.slice_pair.scale_launches = 0
    slicing.slice_triple.launches = 0
    exact_fft.sliced_epilogue.launches = 0
    for name in K6_KERNELS:
        getattr(pairs, name).launches = 0
    pairs.pair_poly.mode_launches = dict.fromkeys(pairs.pair_poly.mode_launches, 0)


def kernel_counts():
    """The wrappers' launch counts by the names of the kernels line (K4:
    its slicing and its scale launches; K6p: all modes, and each path mode
    on its own)."""
    from sfft_tpu_torch.core import exact_fft, fdiff, greek, moments, pairs, slicing

    counts = {"moments": moments.moments.launches,
              "corr_window": greek.corr_window.launches,
              "fdiff_model": fdiff.fdiff_model.launches,
              "corr_direct": greek._K8.launches, "conv_direct": fdiff._K9.launches,
              "slice_pair": slicing.slice_pair.launches + slicing.slice_pair.scale_launches,
              "slice_triple": slicing.slice_triple.launches,
              "sliced_epilogue": exact_fft.sliced_epilogue.launches}
    counts.update({name: getattr(pairs, name).launches for name in K6_KERNELS})
    counts.update({name: pairs.pair_poly.mode_launches[mode]
                   for name, mode in K6P_MODES.items() if name != "pair_poly"})
    return counts


@contextlib.contextmanager
def host_spans():
    """Host time and calls of the source extractor (prep/sex.py calls
    extract_sources, which calls _deblend_region per detected island),
    while the block runs: {name: [calls, seconds]}."""
    from sfft_tpu_torch.prep import extract, sex

    spans = {"extract_sources": [0, 0.0], "_deblend_region": [0, 0.0]}
    real = (sex.extract_sources, extract._deblend_region)

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spans[name][0] += 1
                spans[name][1] += time.perf_counter() - t0
        return wrapper

    sex.extract_sources = timed("extract_sources", real[0])
    extract._deblend_region = timed("_deblend_region", real[1])
    try:
        yield spans
    finally:
        sex.extract_sources, extract._deblend_region = real


def robust_rms(a):
    """1.4826 x the median absolute deviation of the finite values."""
    a = a[np.isfinite(a)]
    return float(1.4826 * np.median(np.abs(a - np.median(a))))


def easy_packet(name, d):
    """One automatic packet on its pair: the pair made and written to FITS,
    *_Prep once on the host, then *_Subtract five times on the card
    (EASY_TRIOS) with the counts zeroed before each run and read after it;
    the checks of phase 10; K1 / K2 of a default run and K4 / K6 / K7 of two
    contract runs held to their twins on the path's operands; one profiled
    run of each trio with the kernels. Returns the report."""
    import torch
    from sfft_tpu_torch import EasyCrowdedPacket, EasySparsePacket, make_config, native
    from sfft_tpu_torch.io import fits

    t0 = time.perf_counter()
    if name == "sparse":
        ref, sci, transient, noise = sparse_fields()
        paths = write_easy_pair(d, name, ref, sci, {"GAIN": 1.0, "ESATUR": 1e9})
        kw = dict(PostAnomalyCheck=True)
        prep_fn, sub = EasySparsePacket.ESP_Prep, EasySparsePacket.ESP_Subtract
        label = f"ESP {EASY_SPARSE[0]} x {EASY_SPARSE[1]} (DECam)"
    else:
        ref, sci, noise = crowded_fields()
        transient = None
        paths = write_easy_pair(d, name, ref, sci, {"GAIN": 1.0, "SATURATE": 28000.0})
        kw = dict(MaskSatContam=True)
        prep_fn, sub = EasyCrowdedPacket.ECP_Prep, EasyCrowdedPacket.ECP_Subtract
        label = f"ECP {EASY_CROWDED[0]} x {EASY_CROWDED[1]} (TESS)"
    del ref, sci
    make_s = time.perf_counter() - t0
    assert native.available(), "the native extension did not build or load"
    t0 = time.perf_counter()
    with host_spans() as spans:
        prep = prep_fn(*paths, VERBOSE_LEVEL=0, **kw)
    prep_s = time.perf_counter() - t0
    cfg = prep["cfg"]
    assert (cfg.greek_backend, cfg.fdiff_backend, cfg.solver) == ("fft", "fft", "lu")
    SS = prep["SFFTPrepDict"].get("SExCatalog-SubSource")
    nss = None if SS is None else len(SS)
    active = int(np.sum(prep["SFFTPrepDict"]["Active-Mask"]))
    nan_u = 0 if prep["NaNmask_U"] is None else int(prep["NaNmask_U"].sum())
    nsat = int(prep["SFFTPrepDict"]["REF-SAT-Mask"].sum()
               + prep["SFFTPrepDict"]["SCI-SAT-Mask"].sum())
    log(f"phase 10 {label}: pair made and written in {make_s:.1f} s; prep (host, numpy and "
        f"the native extension: loaded) {prep_s:.1f} s: ConvdSide {prep['ConvdSide']}, FWHM "
        f"REF {prep['FWHM_REF']:.3f} SCI {prep['FWHM_SCI']:.3f} -> KerHW {prep['KerHW']} "
        f"(NEQ {cfg.NEQ}), {nss} sub-sources, {active} active pixels, {nsat} saturated "
        f"pixels, masked pair {'==' if prep['PixA_mI'] is prep['PixA_I'] else '!='} unmasked, "
        f"layouts I {prep['PixA_I'].strides} mI {prep['PixA_mI'].strides}; in the prep: "
        + ", ".join(f"{n} {v[1]:.1f} s in {v[0]} calls" for n, v in spans.items()))

    def trio_prep(backends):
        if not backends:
            return prep
        return dict(prep, cfg=make_config(cfg.N0, cfg.N1, prep["KerHW"],
                                          KerPolyOrder=cfg.kernel_basis.degree,
                                          BGPolyOrder=cfg.bg_basis.degree,
                                          ConstPhotRatio=cfg.const_phot_ratio, **backends))

    def subtract(p, plain, fits_diff=None):
        return sub(p, *paths, FITS_DIFF=fits_diff, VERBOSE_LEVEL=0, plain=plain, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for tlabel, backends, plain in EASY_TRIOS:
        p = trio_prep(backends)
        out = os.path.join(d, f"{name}_{tlabel.replace(' ', '_').replace('/', '_')}.fits")
        zero_kernel_counts()
        t0 = time.perf_counter()
        res = subtract(p, plain, out)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = kernel_counts()
        diff, sol = res[0], res[2]
        assert isinstance(diff, np.ndarray) and isinstance(sol, np.ndarray)
        assert sol.shape == (p["cfg"].NEQ,) and np.isfinite(sol).all()
        npa = None if SS is None else int(np.sum(SS["MASK_PostAnomaly"]))
        fdiff_img, hdr = fits.read(out)
        assert np.array_equal(fdiff_img.T, diff, equal_nan=True), \
            f"{name} {tlabel}: the difference FITS differs from the difference returned"
        decisions = dict(ConvdSide=hdr["CONVD"], KerHW=hdr["KERHW"], subsources=nss,
                         active=active, post_anomaly=npa)
        runs[tlabel] = dict(diff=diff, sol=sol, s=sec, counts=counts, decisions=decisions,
                            cfg=p["cfg"], plain=plain)
        nnan = int(np.isnan(diff).sum())
        log(f"phase 10 {label} {tlabel} ({p['cfg'].greek_backend}/{p['cfg'].fdiff_backend}/"
            f"{p['cfg'].solver}{', plain twins' if plain else ''}): subtract {sec:.2f} s "
            f"(first call); launches {counts}; decisions {decisions}; NaN pixels {nnan} "
            f"({nnan - nan_u} contaminated); flux scaling {res[3]:.6f}")
    peak = torch.cuda.max_memory_allocated()
    k, kp, c, cy, kx = (runs[t[0]] for t in EASY_TRIOS)
    # the kernels ran where they should, and nowhere else
    for r in (k, kx):
        assert r["counts"]["corr_window"] > 0 and r["counts"]["fdiff_model"] > 0, \
            f"{name} fft/fft: K1 or K2 never launched: {r['counts']}"
    need = ("moments", "slice_pair", "sliced_epilogue", "pair_products", "pair_model",
            "pair_poly")
    assert all(c["counts"][n] > 0 for n in need), \
        f"{name} contract: a kernel never launched: {c['counts']}"
    assert not any(kp["counts"].values()) and not any(cy["counts"].values()), \
        f"{name}: a kernel launched on the plain twins: {kp['counts']} {cy['counts']}"
    # the same discrete decisions in all five runs
    for r in runs.values():
        assert r["decisions"] == k["decisions"], \
            f"{name}: decisions differ: {r['decisions']} vs {k['decisions']}"
    # the NaN masks: the union NaN mask, and the contamination mask (GSS:
    # the mask image convolved with the solution's kernel, below -0.001),
    # recomputed here for each run. A pixel may leave or join the mask only
    # where the threshold lies between the run's contamination image and
    # the f64 yardstick's (fft / fft / exact on the twins): a tie. The
    # images are the difference of the pair (mask, 0): with the kernels,
    # fft / fft / exact is held to the yardstick within 1e-8 of max|mask|
    # (the difference's bound), the contract trio within 1e-6 (its RMS
    # bound); the LU's images move with its solution (reported; their
    # differences are held above)
    nan_k = np.isnan(k["diff"])
    ties, spreads = {}, {}
    if prep["ContamMask_I"] is not None:
        from sfft_tpu_torch.core.engine import ElementalSFFT

        tI = torch.as_tensor(prep["ContamMask_I"], device="cuda").to(torch.float64)
        nan_u_mask = np.zeros(tI.shape, bool) if prep["NaNmask_U"] is None else \
            prep["NaNmask_U"]
        tD = {}
        for t, r in runs.items():
            tsol = torch.as_tensor(r["sol"], device="cuda").clone()
            tsol[-r["cfg"].Fpq:] = 0.0
            tD[t] = ElementalSFFT.ESS(tI, torch.zeros_like(tI), r["cfg"], tsol, Subtract=True,
                                      plain=r["plain"])[1].cpu().numpy()
            assert np.array_equal(np.isnan(r["diff"]),
                                  nan_u_mask | (tD[t] < -0.001) | prep["ContamMask_J"]), \
                f"{name} {t}: the NaN mask is not the NaN union and the contamination masks"
        yard = tD["fft/fft/exact plain"]
        for t, img in tD.items():
            spreads[t] = float(np.abs(img - yard).max())
            flips = (img < -0.001) != (yard < -0.001)
            ties[t] = int(flips.sum())
            log(f"phase 10 {label} {t}: contamination image {spreads[t]:.3e} from the "
                f"yardstick's, {int((img < -0.001).sum())} pixels below -0.001, {ties[t]} "
                f"flipped")
            assert (np.abs(yard[flips] + 0.001) <= spreads[t]).all(), \
                f"{name} {t}: the contamination mask differs away from the threshold"
        assert spreads["fft/fft/exact"] <= 1e-8 and spreads["contract"] <= 1e-6, \
            f"{name}: contamination images {spreads}"
        del tD, yard
    else:
        for r in runs.values():
            assert np.array_equal(np.isnan(r["diff"]), nan_k), f"{name}: NaN masks differ"
    ok = ~np.any([np.isnan(r["diff"]) for r in runs.values()], axis=0)
    J = np.nan_to_num(prep["PixA_J"])
    dbound = 1e-8 * np.abs(J).max()

    def dist(a, b):
        return (float(np.abs(a["diff"][ok] - b["diff"][ok]).max()),
                float(np.sqrt(np.mean((a["diff"][ok] - b["diff"][ok]) ** 2))),
                float(np.abs(a["sol"] - b["sol"]).max() / np.abs(b["sol"]).max()))

    # what the LU's spread rests on: the default trio's tables with the
    # kernels and on the twins, and the normal matrix's condition number
    from sfft_tpu_torch.core import engine

    mI, mJ = (torch.as_tensor(prep[k], device="cuda") for k in ("PixA_mI", "PixA_mJ"))
    (A, rhs), (Ap, rhsp) = (engine._normal_equations_impl(cfg, mI, mJ, plain=pl)
                            for pl in (False, True))
    tables = dict(lhs_rel=float((A - Ap).abs().max() / Ap.abs().max()),
                  rhs_rel=float((rhs - rhsp).abs().max() / rhsp.abs().max()),
                  cond=float(torch.linalg.cond(Ap)))
    del mI, mJ, A, rhs, Ap, rhsp
    # K1 and K2 against their twins end to end: fft / fft / exact with the
    # kernels against the same on the plain twins, at the bounds of
    # tests/test_engine.py:56-58. The default trio's unrefined LU is not
    # reproducible to those bounds on these systems (the sparse system's
    # condition number is ~1e18: tables that agree to ~1e-17 give solutions
    # ~1e-6 of their maximum apart): its two runs are reported beside their
    # distances from the refined solve
    dmax, lu_k_rms, lu_srel = dist(k, kp)
    xdmax, _, srel = dist(kx, cy)
    _, crms, csrel = dist(c, cy)
    _, lu_rms, lu_exact_srel = dist(kp, cy)
    _, lu_k_yard_rms, lu_k_yard_srel = dist(k, cy)
    assert xdmax <= dbound, \
        f"{name} fft/fft/exact: max|diff - diff_plain| {xdmax:.3e} > 1e-8 max|J|"
    assert srel <= 1e-6, \
        f"{name} fft/fft/exact: solution {srel:.3e} of max from the plain twins' > 1e-6"
    assert crms < 1e-6, f"{name} contract: RMS(diff - diff_f64) {crms:.3e} >= 1e-6"
    assert csrel <= 1e-6, f"{name} contract: solution {csrel:.3e} of max from f64 > 1e-6"
    # the difference at the pair's noise level (robust: the transient and
    # the residuals of saturated stars are outliers)
    n0, n1 = k["diff"].shape
    centre = (slice(n0 // 4, 3 * n0 // 4), slice(n1 // 4, 3 * n1 // 4))
    for t, r in runs.items():
        rrms = robust_rms(r["diff"][centre])
        assert abs(rrms / noise - 1) < 0.1, \
            f"{name} {t}: central robust RMS {rrms:.4f}, the pair's noise {noise:.4f}"
    rrms = robust_rms(k["diff"][centre])
    prms = float(np.sqrt(np.nanmean(k["diff"][centre] ** 2)))
    if transient is not None:
        tx, ty = (int(round(v)) for v in transient)
        peak_t = float(np.nanmax(np.abs(k["diff"][tx - 5:tx + 6, ty - 5:ty + 6])))
        assert peak_t > 20 * rrms, f"{name}: the transient {peak_t:.1f} is lost"
    log(f"phase 10 {label}: fft/fft/exact with the kernels vs the plain twins max|d| = "
        f"{xdmax:.3e} (bound 1e-8 max|J| = {dbound:.3e}), solution {srel:.3e} of max (bound "
        f"1e-6); contract vs fft/fft/exact RMS(diff) = {crms:.3e} (bound 1e-6), solution "
        f"{csrel:.3e} of max (bound 1e-6); default (lu) with the kernels vs the plain twins "
        f"max|d| = {dmax:.3e}, RMS {lu_k_rms:.3e}, solutions {lu_srel:.3e} of max apart (their "
        f"tables {tables['lhs_rel']:.1e} (matrix) and {tables['rhs_rel']:.1e} (vector) of max "
        f"apart, the matrix's condition number {tables['cond']:.2e}); from "
        f"the refined solve: the LU with the kernels RMS(diff) {lu_k_yard_rms:.3e}, solution "
        f"{lu_k_yard_srel:.3e}, on the twins {lu_rms:.3e}, {lu_exact_srel:.3e}; the same "
        f"decisions in all five runs and the same NaN masks but for "
        f"ties at the contamination threshold {ties}; every difference FITS reads back "
        f"equal; central RMS {prms:.4f}, robust {rrms:.4f} (the pair's noise {noise:.4f})"
        + ("" if transient is None else f"; transient peak {peak_t:.1f}")
        + f"; peak memory {peak / 2**30:.2f} GiB")
    # K1 and K2 of a steady default run, and K4 / K6 / K7 of two contract
    # runs, held to their twins on the path's own operands
    on_path = kernels_on_path(lambda: subtract(prep, False), f"{name} default", 10)
    assert {r[:2] for r in on_path} == {"K1", "K2"}, \
        f"{name} default: K1 or K2 was not called: {sorted(on_path)}"
    pc = trio_prep(EASY_TRIOS[2][1])
    slicers = slicers_on_path(lambda: subtract(pc, False), 10, f"{name} contract")
    prof = {}
    for tlabel, p in (("default", prep), ("contract", pc)):
        _, wall, busy, nk, idle = profile_step(lambda: subtract(p, False))
        prof[tlabel] = dict(wall_ms=wall * 1e3, busy_ms=busy * 1e3, kernels=nk, idle=idle)
        log(f"phase 10 {label} {tlabel}: one profiled subtract (steady): wall "
            f"{wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms in {nk} kernels and copies, "
            f"idle share {idle:.3f}")
    # phase 11 holds the survey entry points to these single calls
    single = dict(paths=paths, noise=noise, prep_s=prep_s,
                  default=dict(k, fits=os.path.join(d, f"{name}_default.fits")), contract=c)
    return dict(label=label, prep_s=prep_s, prep_spans=spans, make_s=make_s, single=single,
                KerHW=prep["KerHW"], NEQ=cfg.NEQ, ConvdSide=prep["ConvdSide"], peak_bytes=peak,
                subtract_s={t: r["s"] for t, r in runs.items()},
                launches={t: r["counts"] for t, r in runs.items()},
                decisions=dict(k["decisions"], nan=int(nan_k.sum())),
                contamination_ties=ties, contamination_spreads=spreads,
                kernels_vs_plain=dict(exact_max_abs=xdmax, exact_sol_rel=srel, lu_max_abs=dmax,
                                      lu_rms=lu_k_rms, lu_sol_rel=lu_srel),
                contract_vs_f64=dict(rms=crms, sol_rel=csrel), default_tables=tables,
                lu_vs_refined=dict(kernels_rms=lu_k_yard_rms, kernels_sol_rel=lu_k_yard_srel,
                                   plain_rms=lu_rms, plain_sol_rel=lu_exact_srel),
                central_rms=prms, robust_rms=rrms, noise=noise, profile=prof,
                on_path=on_path, slicers=slicers)


def golden_contract():
    """The contract trio on the golden sparse pair of tests/data (360 x
    340, KerHWLimit (2, 6): KerHW 6, a masked system with 3.6% of its
    pixels active) at pexact_prof (8, 7, 6) and (10, 9, 8) with the kernels,
    against fft / fft / exact on the plain twins. (8, 7, 6) is reported (it
    misses the contract bound on this pair); (10, 9, 8) must meet it.
    Returns {prof: (RMS, solution rel)}."""
    from sfft_tpu_torch import EasySparsePacket, make_config

    paths = [os.path.join(HERE, "tests", "data", f"golden_sparse_{s}.fits")
             for s in ("ref", "sci")]
    kw = dict(KerHWLimit=(2, 6), PostAnomalyCheck=True)
    prep = EasySparsePacket.ESP_Prep(*paths, VERBOSE_LEVEL=0, **kw)
    cfg = prep["cfg"]

    def run(plain, **backends):
        p = dict(prep, cfg=make_config(cfg.N0, cfg.N1, prep["KerHW"], **backends))
        diff, _, sol = EasySparsePacket.ESP_Subtract(p, *paths, VERBOSE_LEVEL=0, plain=plain,
                                                     **kw)[:3]
        return diff, sol

    yd, ys = run(True, solver="exact")
    out = {}
    for prof in ((8, 7, 6), (10, 9, 8)):
        d, sol = run(False, greek_backend="pexact", fdiff_backend="pexact", solver="exact",
                     pexact_prof=prof)
        out[prof] = (float(np.sqrt(np.mean((d - yd) ** 2))),
                     float(np.abs(sol - ys).max() / np.abs(ys).max()))
    log(f"phase 10 golden sparse pair {cfg.N0} x {cfg.N1} KerHW {prep['KerHW']}: contract trio "
        f"vs fft/fft/exact on the twins: " + "; ".join(
            f"pexact_prof {prof}: RMS(diff) {r:.3e}, solution {q:.3e} of max"
            for prof, (r, q) in out.items()) + " (bound 1e-6; (8, 7, 6) reported)")
    r, q = out[(10, 9, 8)]
    assert r < 1e-6 and q <= 1e-6, f"golden sparse pair, pexact (10, 9, 8): {r:.3e}, {q:.3e}"
    return out


def phase_easy(d):
    """Phase 10: EasySparsePacket.ESP on a DECam-size pair and
    EasyCrowdedPacket.ECP on a TESS-size pair (FITS in the directory d),
    each through easy_packet, then the contract trio on the golden sparse
    pair (golden_contract). Returns {packet: report}."""
    import torch

    out = {}
    for name in ("sparse", "crowded"):
        out[name] = easy_packet(name, d)
        torch.cuda.empty_cache()
    out["golden_contract"] = {str(k): v for k, v in golden_contract().items()}
    return out


# --- phase 11: the survey entry points (MESP / MECP, batched dispatch, the server, solvers) ---

# tasks 1 and 2 of the MESP queue (task 0 is phase 10's pair, seed 10), and
# the two TESS pairs of MECP (--survey)
SURVEY_SEEDS = (12, 13)
TESS_SEEDS = (11, 14)
PLANES = ("PixA_I", "PixA_J", "PixA_mI", "PixA_mJ")
FAST_CFG = dict(greek_backend="peeled", fdiff_backend="fft32", solver="refined")
CONTRACT_CFG = dict(greek_backend="pexact", fdiff_backend="pexact", solver="exact")

# the client of phase 11's server: a process of its own, which must never
# initialise CUDA (argv: repo, socket, directory of the inputs)
SURVEY_CLIENT = r'''
import json, pickle, sys, time
import numpy as np
import torch


def _no_cuda(*args, **kwargs):
    raise AssertionError("the client initialised CUDA")


torch.cuda._lazy_init = _no_cuda
sys.path.insert(0, sys.argv[1])
from sfft_tpu_torch.serve import EngineClient, EngineServerError

sock, d = sys.argv[2], sys.argv[3]
with open(f"{d}/configs.pkl", "rb") as f:
    cfgs = pickle.load(f)
load = lambda name: np.load(f"{d}/{name}.npy")
out, times = {}, {}
with EngineClient(sock) as c:
    t0 = time.perf_counter()
    while not c.ping()["warm"]:
        time.sleep(0.05)
    times["boot_wait_s"] = time.perf_counter() - t0
    times["warm_s"] = c.warm(cfgs["fast"])
    I, J = load("bench_I"), load("bench_J")
    t0 = time.perf_counter()
    out["fast_sol"], out["fast_diff"], _ = c.subtract(I, J, cfgs["fast"])
    times["fast_s"] = time.perf_counter() - t0
    out["fast_diff32"] = c.subtract(I, J, cfgs["fast"], diff_dtype="float32")[1]
    P = [load(f"task0_{k}") for k in ("I", "J", "mI", "mJ")]
    t0 = time.perf_counter()
    out["contract_sol"], out["contract_diff"], _ = c.subtract(P[0], P[1], cfgs["contract"],
                                                              mI=P[2], mJ=P[3])
    times["contract_s"] = time.perf_counter() - t0
    out["apply_diff"] = c.subtract(P[0], P[1], cfgs["contract"],
                                   solution=out["contract_sol"])[1]
    try:
        c.subtract(P[0], P[1], cfgs["contract"], mI=P[2])
        raise SystemExit("mismatched masks were accepted")
    except EngineServerError as e:
        assert "both mI and mJ" in str(e), e
    pong = c.ping()
    assert pong["ok"] and pong["warm"], pong
np.savez(f"{d}/client_out.npz", **out)
assert not torch.cuda.is_initialized(), "the client initialised CUDA"
print(json.dumps(dict(times, ping=pong, cuda_initialized=torch.cuda.is_initialized())))
'''


def packet_view(prep, diff):
    """A GSS difference as ESP_Subtract returns it (no MaskSatContam):
    negated when SCI was convolved, NaN on the union NaN mask."""
    if prep["ConvdSide"] == "SCI":
        diff = -diff
    if prep["NaNmask_U"] is not None:
        diff = np.where(prep["NaNmask_U"], np.nan, diff)
    return diff


def host_plane(x):
    """A plane as numpy in its own layout (a device tensor comes back with
    its strides)."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


@contextlib.contextmanager
def stage_spans(packet, names):
    """Wall intervals of the packet's stages while the block runs, by the
    FITS_SCI keyword: {stage: {sci: (t0, t1)}}. The stages are replaced on
    the class, where MultiEasy* looks them up at call time."""
    spans = {n: {} for n in names}
    real = {n: packet.__dict__[n] for n in names}

    def timed(n, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spans[n][kwargs.get("FITS_SCI")] = (t0, time.perf_counter())
        return staticmethod(wrapper)

    for n in names:
        setattr(packet, n, timed(n, real[n].__func__))
    try:
        yield spans
    finally:
        for n in names:
            setattr(packet, n, real[n])


def busy_within(span, others):
    """Seconds of `span` during which at least one of `others` ran."""
    a, b = span
    cuts = sorted((max(a, s), min(b, e)) for s, e in others if min(b, e) > max(a, s))
    total, end = 0.0, a
    for s, e in cuts:
        s = max(s, end)
        if e > s:
            total, end = total + e - s, e
    return total


def esp_single(d, paths, dev):
    """Phase 10's single ESP calls of the sparse pair (default trio and the
    contract trio, with the kernels), for phase 11 run alone."""
    from sfft_tpu_torch import EasySparsePacket, make_config

    t0 = time.perf_counter()
    prep = EasySparsePacket.ESP_Prep(*paths, VERBOSE_LEVEL=0, PostAnomalyCheck=True)
    prep_s = time.perf_counter() - t0
    cfg = prep["cfg"]
    pc = dict(prep, cfg=make_config(cfg.N0, cfg.N1, prep["KerHW"], **CONTRACT_CFG))
    out = {}
    for label, p in (("default", prep), ("contract", pc)):
        f = os.path.join(d, f"sparse_{label}.fits")
        res = EasySparsePacket.ESP_Subtract(p, *paths, FITS_DIFF=f, VERBOSE_LEVEL=0,
                                            PostAnomalyCheck=True, device=dev)
        out[label] = dict(diff=res[0], sol=res[2], cfg=p["cfg"], fits=f,
                          decisions=esp_decisions(res, f))
    return dict(out, paths=paths, prep_s=prep_s)


def esp_decisions(result, fits_path):
    """An ESP call's decisions as phase 10 records them (the difference
    FITS header's CONVD and KERHW, sub-sources, active pixels, Post-Anomaly
    sub-sources)."""
    from sfft_tpu_torch.io import fits

    hdr = fits.read(fits_path)[1]
    pd = result[1]
    SS = pd["SExCatalog-SubSource"]
    return dict(ConvdSide=hdr["CONVD"], KerHW=hdr["KERHW"], subsources=len(SS),
                active=int(np.sum(pd["Active-Mask"])),
                post_anomaly=int(np.sum(SS["MASK_PostAnomaly"])))


def survey_pairs(d, single):
    """The MESP queue: phase 10's pair, two more seeds of its generator, and
    a broken pair (phase 10's REF with a SCI of another shape)."""
    from sfft_tpu_torch.io import fits

    pairs = [single["paths"]]
    for seed in SURVEY_SEEDS:
        ref, sci, _, _ = sparse_fields(seed)
        pairs.append(write_easy_pair(d, f"survey{seed}", ref, sci, {"GAIN": 1.0, "ESATUR": 1e9}))
    hdr = fits.Header()
    hdr.add("GAIN", 1.0)
    broken = os.path.join(d, "survey_broken_sci.fits")
    fits.write(broken, sci.T[:sci.shape[1] // 4, :sci.shape[0] // 4].astype(np.float32), hdr)
    return pairs + [(pairs[0][0], broken)]


def survey_mesp(d, single, dev, noise, pairs, threads=2):
    """MESP on the four DECam tasks of `pairs` with `threads` prep threads
    and one subtract worker: statuses, task 0 bit for bit against phase 10's
    single call, every difference at its noise, K1 / K2 launched; the prep /
    subtraction timeline, and the subtractions again with no prep thread
    running."""
    import filecmp

    import torch
    from sfft_tpu_torch import EasySparsePacket, MultiEasySparsePacket

    diffs = [os.path.join(d, f"mesp{threads}_{t}.fits") for t in range(4)]
    mesp = MultiEasySparsePacket([p[0] for p in pairs], [p[1] for p in pairs],
                                 FITS_DIFF_Queue=diffs, PostAnomalyCheck=True,
                                 **({} if dev.type == "cuda" else {"device": dev}))
    zero_kernel_counts()
    with stage_spans(EasySparsePacket, ("ESP_Prep", "ESP_Subtract")) as spans:
        t0 = time.perf_counter()
        status, products = mesp.MESP(NUM_THREADS_4PREPROC=threads, NUM_THREADS_4SUBTRACT=1,
                                     VERBOSE_LEVEL=0)
        wall = time.perf_counter() - t0
    counts = kernel_counts()
    assert status == {0: 2, 1: 2, 2: 2, 3: -1}, f"MESP statuses {status}"
    if dev.type == "cuda":
        assert counts["corr_window"] > 0 and counts["fdiff_model"] > 0, \
            f"MESP: K1 or K2 never launched: {counts}"
    # task 0: phase 10's single call, bit for bit
    res0 = products[0]["result"]
    ref0 = single["default"]
    assert np.array_equal(res0[2], ref0["sol"]), "MESP task 0: solution differs from phase 10's"
    assert np.array_equal(res0[0], ref0["diff"], equal_nan=True), \
        "MESP task 0: difference differs from phase 10's"
    assert filecmp.cmp(diffs[0], ref0["fits"], shallow=False), \
        "MESP task 0: difference FITS differs from phase 10's"
    dec0 = esp_decisions(res0, diffs[0])
    assert dec0 == ref0["decisions"], f"MESP task 0 decisions {dec0} vs {ref0['decisions']}"
    rrms = []
    for t in range(3):
        diff = products[t]["result"][0]
        n0, n1 = diff.shape
        rrms.append(float(robust_rms(diff[n0 // 4:3 * n0 // 4, n1 // 4:3 * n1 // 4])))
        assert abs(rrms[-1] / noise - 1) < 0.1, f"MESP task {t}: robust RMS {rrms[-1]:.4f}"
    prep_spans = [spans["ESP_Prep"][p[1]] for p in pairs]
    sub_spans = [spans["ESP_Subtract"][p[1]] for p in pairs[:3]]
    prep_s = [b - a for a, b in prep_spans]
    sub_s = [b - a for a, b in sub_spans]
    with_prep = [busy_within(s, prep_spans) / (s[1] - s[0]) for s in sub_spans]
    overlap = 1 - wall / (sum(prep_s) + sum(sub_s))
    # the same subtractions again with no prep thread running
    alone = []
    for t in range(3):
        prep = products[t]["prep"]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        EasySparsePacket.ESP_Subtract(prep, *pairs[t], FITS_DIFF=os.path.join(d, "alone.fits"),
                                      VERBOSE_LEVEL=0, PostAnomalyCheck=True, device=dev)
        alone.append(time.perf_counter() - t0)
    log(f"phase 11 MESP: 4 DECam tasks ({EASY_SPARSE[0]} x {EASY_SPARSE[1]}), {threads} prep "
        f"thread(s), 1 subtract worker, default trio: statuses {status}; run {wall:.2f} s; prep "
        f"s {[round(v, 2) for v in prep_s]} (the broken pair's last; task 0's prep alone "
        f"{single['prep_s']:.2f} s); subtract s {[round(v, 3) for v in sub_s]}, with a prep thread "
        f"running for {[round(v, 2) for v in with_prep]} of each; the same subtractions alone "
        f"{[round(v, 3) for v in alone]} s; overlap share 1 - wall / (sum prep + sum subtract) "
        f"= {overlap:.3f}; prefetched (uploaded during an earlier task's subtraction): tasks "
        f"{[t for t in range(3) if products[t].get('prefetched')]}; task 0 bit for bit phase "
        f"10's single ESP call (solution, difference, "
        f"difference FITS, decisions {dec0}); robust central RMS {[round(v, 4) for v in rrms]} "
        f"(noise {noise:.4f}); launches {counts}")
    return dict(status=status, products=products, counts=counts, report=dict(
        threads=threads, wall_s=wall, prep_alone_s=single["prep_s"], prep_s=prep_s,
        subtract_s=sub_s, with_prep_share=with_prep, subtract_alone_s=alone,
        overlap_share=overlap, prefetched=[t for t in range(3) if products[t].get("prefetched")],
        robust_rms=rrms, decisions=dec0))


def survey_prefetch(mesp, pairs, dev):
    """The scheduler's per-task path with every prep done before the
    subtract worker starts (run_prep_only, as in tests/test_parallel.py's
    prefetch test), so that it uploads tasks 1 and 2 on its side stream
    during the subtractions before them (_prefetch_pair_planes, then
    await_prefetch when each starts): every plane on the card with the
    strides it has on the host, and each result bit for bit its MESP
    result."""
    from sfft_tpu_torch import EasySparsePacket
    from sfft_tpu_torch.parallel.scheduler import (MultiTaskScheduler, _prefetch_pair_planes,
                                                   await_prefetch, worker_device)

    products = mesp["products"]
    preps = {}
    for t in range(3):
        prep = {k: v for k, v in products[t]["prep"].items() if k != "h2d_event"}
        preps[t] = dict(prep, **{k: host_plane(prep[k]) for k in PLANES})

    def subtract_fn(t, prep):
        await_prefetch(prep)
        return EasySparsePacket.ESP_Subtract(prep, *pairs[t], VERBOSE_LEVEL=0,
                                             PostAnomalyCheck=True, device=worker_device())

    sched = MultiTaskScheduler(3, lambda t: preps[t], subtract_fn, NUM_THREADS_4PREPROC=1,
                               VERBOSE_LEVEL=0, prefetch_fn=_prefetch_pair_planes,
                               devices=[dev])
    sched.run_prep_only()
    t0 = time.perf_counter()
    status, prods = sched.run()
    sec = time.perf_counter() - t0
    assert status == {0: 2, 1: 2, 2: 2}, f"prefetch run statuses {status}"
    fetched = [t for t in range(3) if prods[t].get("prefetched")]
    assert len(fetched) == 2, f"prefetched {fetched}"
    for t in range(3):
        if dev.type == "cuda" and t in fetched:
            for k in PLANES:
                x, h = prods[t]["prep"][k], preps[t][k]
                assert x.device.type == "cuda" and \
                    x.stride() == tuple(v // h.itemsize for v in h.strides), (t, k)
        a, b = prods[t]["result"], products[t]["result"]
        assert np.array_equal(a[2], b[2]) and np.array_equal(a[0], b[0], equal_nan=True), \
            f"prefetched task {t} differs from its MESP result"
    log(f"phase 11 prefetch: every prep done first, 3 subtractions in {sec:.2f} s; tasks "
        f"{fetched} uploaded on the side stream during the subtraction before them, each plane "
        f"with its host strides; every result bit for bit its MESP result")
    return dict(s=sec, prefetched=fetched)


def pinned_upload_ms(prep, dev):
    """Device time of one pair's four planes going up from pinned memory
    (non_blocking copies into tensors of the same strides; median of 5)."""
    import torch

    host = [torch.as_tensor(host_plane(prep[k])).pin_memory() for k in PLANES]
    out = [torch.empty_strided(h.shape, h.stride(), dtype=h.dtype, device=dev) for h in host]

    def up():
        for o, h in zip(out, host):
            o.copy_(h, non_blocking=True)

    ms = cuda_ms(up, reps=5, inner=1)
    return ms, sum(h.numel() * h.element_size() for h in host)


def survey_batched(mesp, dev):
    """batched_subtract on MESP's OK tasks of task 0's config, from the prep
    products MESP left, each pair bit for bit against its MESP result."""
    import torch
    from sfft_tpu_torch.parallel.batch import batched_subtract

    products = mesp["products"]
    cfg = products[0]["prep"]["cfg"]
    group = [t for t in range(3) if products[t]["prep"]["cfg"] == cfg]
    zero_kernel_counts()
    t0 = time.perf_counter()
    sols, diffs, rms = batched_subtract(*([products[t]["prep"][k] for t in group] for k in PLANES),
                                        cfg, devices=[dev])
    sols, diffs, rms = sols.cpu().numpy(), diffs.cpu().numpy(), rms.cpu().numpy()
    sec = time.perf_counter() - t0
    counts = kernel_counts()
    for i, t in enumerate(group):
        res = products[t]["result"]
        assert np.array_equal(sols[i], res[2]), f"batched pair {t}: solution differs from MESP's"
        assert np.array_equal(packet_view(products[t]["prep"], diffs[i]), res[0], equal_nan=True), \
            f"batched pair {t}: difference differs from MESP's"
    if dev.type == "cuda":
        assert counts["corr_window"] > 0 and counts["fdiff_model"] > 0, counts
    log(f"phase 11 batched_subtract: {len(group)} pairs of one config on {dev} in {sec:.2f} s "
        f"(with the copies to the host), RMS {[round(float(v), 4) for v in rms]}; each pair bit "
        f"for bit its MESP result (solution, difference); launches {counts}")
    return dict(pairs=len(group), s=sec, counts=counts)


def survey_server(d, dev, single, mesp, fast_ref, bench):
    """An EngineServer on `dev` in a thread of this process (so that the
    wrappers' counters can be read here), driven by a client subprocess
    that never initialises CUDA; results bit for bit against the in-process
    fast step and phase 10's contract run; then ensure_server spawns a fresh
    daemon, whose time to first difference is taken beside the warm one's."""
    import pickle
    import threading

    from sfft_tpu_torch import EngineClient, EngineServer, ensure_server, make_config

    I, J = bench
    cfg_fast = make_config(I.shape[0], I.shape[1], KERHW, **FAST_CFG)
    cfg_contract = single["contract"]["cfg"]
    prep0 = mesp["products"][0]["prep"]
    with open(os.path.join(d, "configs.pkl"), "wb") as f:
        pickle.dump({"fast": cfg_fast, "contract": cfg_contract}, f)
    np.save(os.path.join(d, "bench_I.npy"), I)
    np.save(os.path.join(d, "bench_J.npy"), J)
    for k, key in zip(("I", "J", "mI", "mJ"), PLANES):
        np.save(os.path.join(d, f"task0_{k}.npy"), host_plane(prep0[key]))

    sock = os.path.join(d, "engine.sock")
    srv = EngineServer(sock, device=dev)
    per_request = []

    def counted(op, real):
        def handler(req):
            before, t0 = kernel_counts(), time.perf_counter()
            try:
                return real(req)
            finally:
                per_request.append((op, time.perf_counter() - t0, {
                    k: v - before[k] for k, v in kernel_counts().items()}))
        return handler

    srv._op_warm = counted("warm", srv._op_warm)
    srv._op_subtract = counted("subtract", srv._op_subtract)
    thread = threading.Thread(target=srv.serve_forever, name="survey-server", daemon=True)
    thread.start()
    try:
        client = subprocess.run([sys.executable, "-c", SURVEY_CLIENT, HERE, sock, d],
                                capture_output=True, text=True, timeout=600)
        assert client.returncode == 0, f"server client failed:\n{client.stdout}\n{client.stderr}"
        times = json.loads(client.stdout.strip().splitlines()[-1])
    finally:
        EngineClient(sock).shutdown()
        thread.join(30)
    assert not thread.is_alive(), "the server thread did not stop"
    assert times["cuda_initialized"] is False and times["ping"]["platform"] == dev.type
    out = np.load(os.path.join(d, "client_out.npz"))
    assert np.array_equal(out["fast_sol"], fast_ref[0]) and \
        np.array_equal(out["fast_diff"], fast_ref[1]), "server fast step differs from in-process"
    assert np.array_equal(out["fast_diff32"], fast_ref[1].astype(np.float32))
    c = single["contract"]
    assert np.array_equal(out["contract_sol"], c["sol"]), "server contract solution differs"
    assert np.array_equal(packet_view(prep0, out["contract_diff"]), c["diff"], equal_nan=True), \
        "server contract difference differs from phase 10's contract run"
    assert np.array_equal(out["apply_diff"], out["contract_diff"]), "apply-only differs"
    ops = [(op, {k: v for k, v in n.items() if v}) for op, _, n in per_request]
    if dev.type == "cuda":
        fast_n, contract_n = per_request[1][2], per_request[3][2]
        assert all(fast_n[k] > 0 for k in ("moments", "corr_window", "fdiff_model")), fast_n
        need = ("moments", "slice_pair", "pair_products", "pair_model", "pair_poly",
                "sliced_epilogue")
        assert all(contract_n[k] > 0 for k in need), f"server contract launches {contract_n}"
    counts = {k: sum(n[k] for _, _, n in per_request) for k in kernel_counts()}

    # a fresh daemon: spawn, first difference, shutdown
    sock2 = os.path.join(d, "cold.sock")
    _DAEMON_SOCKETS.append(sock2)
    t0 = time.perf_counter()
    pong = ensure_server(sock2, spawn_timeout=300.0,
                         device=None if dev.type == "cuda" else "cpu")
    spawn_s = time.perf_counter() - t0
    try:
        with EngineClient(sock2) as cl:
            sol, diff, _ = cl.subtract(I, J, cfg_fast)
            ttfd_cold = time.perf_counter() - t0
            while not (pong := cl.ping())["warm"]:
                time.sleep(0.05)
            cl.shutdown()
    finally:
        deadline = time.time() + 30
        while os.path.exists(sock2) and time.time() < deadline:
            time.sleep(0.1)
        try:
            os.kill(pong["pid"], signal.SIGTERM)  # gone already unless shutdown failed
        except ProcessLookupError:
            pass
    # (on the CPU a process of another thread count sums in another order)
    if dev.type == "cuda":
        assert np.array_equal(sol, fast_ref[0]) and np.array_equal(diff, fast_ref[1]), \
            "the fresh daemon's fast step differs"
    report = dict(client=times, requests=[(op, s) for op, s, _ in per_request],
                  ttfd_warm_s=times["fast_s"], ttfd_cold_s=ttfd_cold, spawn_s=spawn_s,
                  cold_attach_s=pong["attach_s"], warm_attach_s=times["ping"]["attach_s"])
    log(f"phase 11 server on {times['ping']['device']} (a thread of this process; the client a "
        f"process that never initialised CUDA): attach {times['ping']['attach_s']:.2f} s; warm "
        f"{I.shape[0]}^2 fast {times['warm_s']:.2f} s; first difference ({I.shape[0]}^2 fast, "
        f"client wall) "
        f"{times['fast_s']:.2f} s, bit for bit the in-process step; task 0's planes under the "
        f"contract trio {times['contract_s']:.2f} s, bit for bit phase 10's contract run; "
        f"apply-only and diff_dtype float32 equal; mismatched masks raised EngineServerError and "
        f"ping answered; launches per request {ops}. A fresh daemon (ensure_server): answered "
        f"ping after {spawn_s:.2f} s, first difference {ttfd_cold:.2f} s after the spawn "
        f"(attach {pong['attach_s']:.2f} s), bit for bit the warm server's; shut down")
    return report, counts


def survey_solvers(bench, dev):
    """host and blocked_cho on the 4096^2 pair's f64 fft / fft tables.
    blocked_cho (a Cholesky factor-and-solve) is held to the refined exact
    solve within 1e-6 of its maximum. host is sfft_tpu's unrefined LAPACK
    LU, whose forward error on this system is the grade of an unrefined LU
    (6.3e-6 of the maximum on an H100), as the card's f64 LU
    ('lu', the default trio's solver) shows beside it (6.3e-5): it is held
    to no farther from exact than 'lu', and to the backward error an LU
    guarantees, ||A x - b|| / (||A|| ||x|| + ||b||) <= 1e-12 (infinity
    norms)."""
    import dataclasses

    import torch
    from sfft_tpu_torch import make_config
    from sfft_tpu_torch.core import engine
    from sfft_tpu_torch.core.solve import _tweak_plan, solve_system

    cfg = make_config(bench[0].shape[0], bench[0].shape[1], KERHW)
    I, J = (torch.as_tensor(a, device=dev) for a in bench)
    zero_kernel_counts()
    lhs, rhs = engine._normal_equations_impl(cfg, I, J)
    counts = kernel_counts()
    out, ms = {}, {}
    for solver in ("exact", "lu", "host", "blocked_cho"):
        c = dataclasses.replace(cfg, solver=solver)
        solve_system(c, lhs, rhs)  # warm-up
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[solver] = solve_system(c, lhs, rhs).cpu().numpy()
        ms[solver] = (time.perf_counter() - t0) * 1e3
    ref = out["exact"]
    rel = {s: float(np.abs(out[s] - ref).max() / np.abs(ref).max())
           for s in ("lu", "host", "blocked_cho")}
    A, b = lhs.cpu().numpy(), rhs.cpu().numpy()
    keep = _tweak_plan(cfg)[0]  # the dofs the solve keeps (ConstPhotRatio's stripes go)
    keep = np.arange(cfg.NEQ) if keep is None else keep
    Ak, x = A[np.ix_(keep, keep)], out["host"][keep]
    backward = float(np.abs(Ak @ x - b[keep]).max()
                     / (np.abs(Ak).sum(axis=1).max() * np.abs(x).max() + np.abs(b[keep]).max()))
    assert rel["blocked_cho"] <= 1e-6, f"blocked_cho vs exact {rel}"
    assert rel["host"] <= rel["lu"], f"host farther from exact than lu: {rel}"
    assert backward <= 1e-12, f"host LU backward error {backward:.3e}"
    log(f"phase 11 solvers on the {I.shape[0]}^2 pair's f64 fft/fft tables (NEQ {cfg.NEQ}): "
        f"host {ms['host']:.1f} ms, blocked_cho {ms['blocked_cho']:.1f} ms, exact "
        f"{ms['exact']:.1f} ms, lu {ms['lu']:.1f} ms (host clock, synchronised); from exact "
        f"(of its max): {rel} (blocked_cho bound 1e-6; host and lu are unrefined LUs: host "
        f"bound lu's distance); host backward error {backward:.3e} (bound 1e-12)")
    return dict(ms=ms, rel=rel, host_backward=backward), counts


def survey_mesh_batch(d, mesp, dev, pairs):
    """--survey: MESP(MESH_BATCH=True) on the same queue, each task bit for
    bit its per-task MESP result."""
    from sfft_tpu_torch import MultiEasySparsePacket

    products = mesp["products"]
    diffs = [os.path.join(d, f"mesh_{t}.fits") for t in range(4)]
    m = MultiEasySparsePacket([p[0] for p in pairs], [p[1] for p in pairs],
                              FITS_DIFF_Queue=diffs, PostAnomalyCheck=True,
                              **({} if dev.type == "cuda" else {"device": dev}))
    zero_kernel_counts()
    t0 = time.perf_counter()
    status, prods = m.MESP(NUM_THREADS_4PREPROC=2, MESH_BATCH=True, VERBOSE_LEVEL=0)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    assert status == {0: 2, 1: 2, 2: 2, 3: -1}, f"MESP(MESH_BATCH) statuses {status}"
    for t in range(3):
        a, b = prods[t]["result"], products[t]["result"]
        assert np.array_equal(a[2], b[2]) and np.array_equal(a[0], b[0], equal_nan=True), \
            f"MESH_BATCH task {t} differs from the per-task path"
    log(f"phase 11 MESP(MESH_BATCH=True): statuses {status} in {wall:.2f} s, every task bit for "
        f"bit its per-task result; launches {counts}")
    return dict(wall_s=wall), counts


def survey_mecp(d, dev):
    """--survey: MECP on two TESS pairs (MaskSatContam), statuses, decisions
    and results equal to single ECP calls."""
    from sfft_tpu_torch import EasyCrowdedPacket, MultiEasyCrowdedPacket
    from sfft_tpu_torch.io import fits

    pairs = []
    for seed in TESS_SEEDS:
        ref, sci, noise = crowded_fields(seed)
        pairs.append(write_easy_pair(d, f"tess{seed}", ref, sci,
                                     {"GAIN": 1.0, "SATURATE": 28000.0}))
    del ref, sci
    kw = dict(MaskSatContam=True, **({} if dev.type == "cuda" else {"device": dev}))
    diffs = [os.path.join(d, f"mecp_{t}.fits") for t in range(2)]
    zero_kernel_counts()
    t0 = time.perf_counter()
    status, prods = MultiEasyCrowdedPacket([p[0] for p in pairs], [p[1] for p in pairs],
                                           FITS_DIFF_Queue=diffs, **kw).MECP(
        NUM_THREADS_4PREPROC=2, VERBOSE_LEVEL=0)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    assert status == {0: 2, 1: 2}, f"MECP statuses {status}"
    decisions = []
    for t, p in enumerate(pairs):
        single = os.path.join(d, f"ecp_{t}.fits")
        res = EasyCrowdedPacket.ECP(*p, FITS_DIFF=single, VERBOSE_LEVEL=0, **kw)
        got = prods[t]["result"]
        dec = [(h["CONVD"], h["KERHW"], int(np.isnan(x).sum()))
               for x, h in ((got[0], fits.read(diffs[t])[1]), (res[0], fits.read(single)[1]))]
        assert dec[0] == dec[1], f"MECP task {t} decisions {dec}"
        assert np.array_equal(got[2], res[2]) and np.array_equal(got[0], res[0], equal_nan=True), \
            f"MECP task {t} differs from the single ECP call"
        decisions.append(dec[0])
    log(f"phase 11 MECP: 2 TESS tasks ({EASY_CROWDED[0]}^2, MaskSatContam): statuses {status} in "
        f"{wall:.2f} s; decisions (ConvdSide, KerHW, NaN pixels) {decisions} and results equal "
        f"to single ECP calls; launches {counts}")
    return dict(wall_s=wall, decisions=decisions), counts


def phase_survey(d, dev, single=None, fast_ref=None, heavy=False):
    """Phase 11: the survey entry points on `dev` (survey_mesp,
    pinned_upload_ms, survey_batched, survey_server, survey_solvers; with
    heavy=True also survey_mesh_batch and survey_mecp). `single` is phase
    10's sparse single calls and `fast_ref` phase 4's fast step (solution,
    difference) as numpy; when None (phase 11 alone) they are run here.
    Returns (report, launches summed over the phase's runs)."""
    from sfft_tpu_torch import PureTorchCustomizedPacket, make_config

    t_start = time.perf_counter()
    if single is None:
        ref, sci, _, noise = sparse_fields()
        paths = write_easy_pair(d, "sparse", ref, sci, {"GAIN": 1.0, "ESATUR": 1e9})
        del ref, sci
        single = dict(esp_single(d, paths, dev), noise=noise)
    bench = make_pair(N)
    if fast_ref is None:
        import torch

        I, J = (torch.as_tensor(a, device=dev) for a in bench)
        sol, diff = PureTorchCustomizedPacket.PCP(I, J, I, J, "REF", KERHW,
                                                  cfg=make_config(N, N, KERHW, **FAST_CFG))
        fast_ref = (sol.cpu().numpy(), diff.cpu().numpy())
        del I, J, sol, diff
    t0 = time.perf_counter()
    pairs = survey_pairs(d, single)
    log(f"phase 11 two more DECam pairs (seeds {SURVEY_SEEDS}) and a broken one made and "
        f"written in {time.perf_counter() - t0:.1f} s")
    mesp = survey_mesp(d, single, dev, single["noise"], pairs)
    launches = dict(mesp["counts"])

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    report = dict(mesp=mesp["report"])
    if dev.type == "cuda":
        ms, nbytes = pinned_upload_ms(mesp["products"][0]["prep"], dev)
        report["upload"] = dict(ms=ms, bytes=nbytes)
        log(f"phase 11 upload of one DECam pair's four planes ({nbytes / 1e6:.1f} MB, "
            f"{mesp['products'][0]['prep']['PixA_I'].dtype}) from pinned memory: {ms:.3f} ms "
            f"({nbytes / ms / 1e6:.1f} GB/s), device time")
    zero_kernel_counts()
    report["prefetch"] = survey_prefetch(mesp, pairs, dev)
    add(kernel_counts())
    batched = survey_batched(mesp, dev)
    add(batched.pop("counts"))
    report["batched"] = batched
    report["server"], counts = survey_server(d, dev, single, mesp, fast_ref, bench)
    add(counts)
    report["solvers"], counts = survey_solvers(bench, dev)
    add(counts)
    if heavy:
        # the same queue with one prep thread: what the second thread buys
        one = survey_mesp(d, single, dev, single["noise"], pairs, threads=1)
        add(one["counts"])
        report["mesp_one_thread"] = one["report"]
        del one
        report["mesh_batch"], counts = survey_mesh_batch(d, mesp, dev, pairs)
        add(counts)
        report["mecp"], counts = survey_mecp(d, dev)
        add(counts)
    report["s"] = time.perf_counter() - t_start
    log(f"phase 11 done in {report['s']:.1f} s; launches {launches}")
    return report, launches


# ---------------------------------------------------------------------------
# phase 12: the multi-device layer (parallel/sharded_fft.py, multihost.py)
# ---------------------------------------------------------------------------

def example_pair(n0, n1, seed=0):
    """__graft_entry__.py's _example_pair (the dryrun's pair): eight
    gaussian sources on a tilted plane, J = 1.08 I + 3 + unit noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(n1), np.arange(n0))
    I = 100.0 + 0.02 * xx + 0.01 * yy
    for _ in range(8):
        x0, y0 = rng.uniform(4, n0 - 4), rng.uniform(4, n1 - 4)
        I = I + rng.uniform(50, 400) * np.exp(
            -((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * rng.uniform(1.0, 2.5) ** 2))
    J = 1.08 * I + 3.0 + rng.normal(0, 1.0, I.shape)
    I = I + rng.normal(0, 1.0, I.shape)
    return I, J


# phase 12's device: the card (a CPU rehearsal of the phase sets "cpu")
SHARD_DEV = "cuda"


def card_list(d):
    """The card named d times: every row block and every exchange of the
    sharded layer on one card."""
    import torch

    return [torch.device(SHARD_DEV)] * d


def dryrun_families(n):
    """The four engine families of __graft_entry__.py:238-247 at n^2 (w = 1;
    the B-spline family's knots at the middle, Tikhonov on 32 seeded points)."""
    import dataclasses

    from sfft_tpu_torch import make_bspline_config
    from sfft_tpu_torch.config import BasisSpec, SFFTConfig

    base = SFFTConfig(N0=n, N1=n, w0=1, w1=1, kernel_basis=BasisSpec("polynomial", 2),
                      bg_basis=BasisSpec("polynomial", 2), dtype="float64",
                      greek_backend="fft", fdiff_backend="fft", solver="lu")
    rng = np.random.default_rng(5)
    xy = np.stack([rng.uniform(4.0, 60.0, 32), rng.uniform(4.0, 60.0, 32)], axis=1)
    bsp = make_bspline_config(
        n, n, 2, KerSpType="B-Spline", KerSpDegree=2, KerIntKnotX=[n / 2 + 0.5],
        KerIntKnotY=[n / 2 + 0.5], SEPARATE_SCALING=True, ScaSpType="Polynomial",
        ScaSpDegree=1, BkgSpType="Polynomial", BkgSpDegree=0, REGULARIZE_KERNEL=True,
        XY_REGULARIZE=xy, LAMBDA_REGULARIZE=1e-5, greek_backend="fft", fdiff_backend="fft",
        solver="lu")
    return [("fft/lu", base),
            ("contract-exact", dataclasses.replace(base, greek_backend="exact",
                                                   fdiff_backend="exact", solver="exact")),
            ("pexact", dataclasses.replace(base, greek_backend="pexact", fdiff_backend="pexact",
                                           solver="exact")),
            ("bspline-v2", bsp),
            ("fast", dataclasses.replace(base, **PEELED_TRIO)),
            ("corr-conv", dataclasses.replace(base, **DIRECT_TRIO)),
            ("bspline-v2-peeled", dataclasses.replace(bsp, **PEELED_TRIO))]


# the fast modes (peeled / fft32 / refined: `fast`, and v2-fast-peeled with
# B-spline bases) against their local step, as the port's CPU fast-mode
# tests hold them to sfft_tpu's (tests/test_torch_engine.py
# test_fast_mode_matches_reference, tests/test_torch_v2_fast.py): the
# normal system within 1e-5 of its max (the f32 tables' bound), the
# solution within 3e-2 of its max, the difference within RMS 0.05 (the fast
# bound), which also bounds its RMS from the f64 fft / fft / lu difference
FAST_FAMILIES = ("fast", "bspline-v2-peeled", "v2-fast-peeled")
FAST_TABLES, FAST_SOL, FAST_RMS = 1e-5, 3e-2, 0.05


def phase_sharded_fft():
    """12a: sharded_fft2 in c128 at N^2 over 4 and 8 blocks against
    torch.fft.fft2 (1e-12 of max), the rfft2 / irfft2 round trip; local and
    sharded device times, the bytes exchanged and the copy rate."""
    import torch
    from sfft_tpu_torch.parallel import sharded_fft as sh

    gen = torch.Generator(device=SHARD_DEV).manual_seed(12)
    x = torch.complex(*(torch.randn((N, N), dtype=torch.float64, device=SHARD_DEV, generator=gen)
                        for _ in range(2)))
    ref = torch.fft.fft2(x)
    out = dict(local_ms=cuda_ms(lambda: torch.fft.fft2(x), reps=3, inner=3))
    for d in (4, 8):
        devs = card_list(d)
        sh.exchange.bytes = 0
        got = sh.gather_rows(sh.sharded_fft2(x, devs))
        nbytes = sh.exchange.bytes
        err = rel_err(got, ref)
        del got
        assert err <= 1e-12, f"sharded_fft2 x{d}: {err:.3e} of max from torch.fft.fft2"
        ms = cuda_ms(lambda: sh.sharded_fft2(x, devs), reps=3, inner=3)
        blocks = list(sh.shard_rows(torch.fft.fft(x, dim=-1), devs).blocks)
        cols = sh.exchange(blocks, devs, True)
        ex_ms = cuda_ms(lambda: (sh.exchange(blocks, devs, True),
                                 sh.exchange(cols, devs, False)), reps=3, inner=3)
        del blocks, cols
        xr = x.real.contiguous()
        back = sh.gather_rows(sh.sharded_irfft2(sh.sharded_rfft2(xr, devs), N))
        rt = rel_err(back, xr)
        del back, xr
        assert rt <= 1e-12, f"sharded rfft2 / irfft2 x{d}: {rt:.3e} of max"
        out[f"x{d}"] = dict(err=err, round_trip=rt, ms=ms, bytes=nbytes, exchange_ms=ex_ms,
                            copy_GBps=nbytes / ex_ms / 1e6)
        log(f"phase 12a sharded_fft2 c128 {N}^2 x{d}: {err:.2e} of max from torch.fft.fft2, "
            f"rfft2 / irfft2 round trip {rt:.2e}; {ms:.3f} ms (local {out['local_ms']:.3f} ms); "
            f"two exchanges {nbytes / 1e6:.1f} MB in {ex_ms:.3f} ms "
            f"({nbytes / ex_ms / 1e6:.1f} GB/s, device-to-device copies on one card)")
    torch.cuda.empty_cache()
    return out


def phase_sharded_exact_fft():
    """12b: sharded_exact_fft2_pair at N^2, half False and True, over 4
    blocks against exact_fft2_pair on the card (1e-13 of max); launches."""
    import torch
    from sfft_tpu_torch.core.exact_fft import exact_fft2_pair, pair_to_c128
    from sfft_tpu_torch.parallel import sharded_fft as sh

    F = torch.as_tensor(make_pair(N, seed=3)[0], device=SHARD_DEV)
    devs = card_list(4)
    out, launches = {}, {}
    for half in (False, True):
        ref = pair_to_c128(exact_fft2_pair(F, half=half))
        local = exact_fft2_pair(F, half=half)
        zero_kernel_counts()
        sharded = sh.gather_rows(sh.sharded_exact_fft2_pair(F, devs, half=half))
        torch.cuda.synchronize()
        counts = kernel_counts()
        bits = all(torch.equal(a, b) for a, b in zip(sharded, local))
        err = rel_err(pair_to_c128(sharded), ref)
        del sharded, local, ref
        assert err <= 1e-13, f"sharded_exact_fft2_pair half={half}: {err:.3e} of max"
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        ms = cuda_ms(lambda: sh.sharded_exact_fft2_pair(F, devs, half=half), reps=3, inner=1)
        local_ms = cuda_ms(lambda: exact_fft2_pair(F, half=half), reps=3, inner=1)
        out[f"half={half}"] = dict(err=err, bits=bits, ms=ms, local_ms=local_ms,
                                   launches={k: counts[k] for k in
                                             ("slice_pair", "sliced_epilogue", "pair_products")})
        log(f"phase 12b sharded_exact_fft2_pair {N}^2 half={half} x4: {err:.2e} of max from "
            f"exact_fft2_pair (bit for bit: {bits}); {ms:.2f} ms (local {local_ms:.2f} ms); "
            f"launches K4 "
            f"{counts['slice_pair']}, K7 {counts['sliced_epilogue']}, K6a "
            f"{counts['pair_products']}")
    torch.cuda.empty_cache()
    return out, launches


def sharded_family(name, cfg, I, J, d, full, yardstick=None):
    """One family's local and sharded steps on (I, J) (masked == unmasked):
    the difference and solution against the local step's, the halo rows'
    bytes of the sharded step; with `full`, the normal system against the
    local one, wall and device time and peak memory of one steady step
    each, and the fault-3 yardstick where the solver is an unrefined LU;
    with `yardstick` (an f64 fft / fft / lu difference of the pair), both
    steps' RMS from it."""
    import dataclasses

    import torch
    from sfft_tpu_torch.core.engine import (_subtract_impl, normal_equations_fn,
                                            solve_and_subtract_fn)
    from sfft_tpu_torch.core.solve import solve_system
    from sfft_tpu_torch.parallel import sharded_fft as sh

    local = solve_and_subtract_fn(cfg)
    run = sh.sharded_subtract_step(cfg, card_list(d))
    t0 = time.perf_counter()
    sol_l, diff_l = local(I, J, I, J)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    zero_kernel_counts()
    sh.halo_rows.bytes = 0
    sol_s, diff_s, (lhs_s, rhs_s) = run(I, J, I, J, with_system=True)
    torch.cuda.synchronize()
    counts = kernel_counts()
    first = dict(local_first_s=t1 - t0, sharded_first_s=time.perf_counter() - t1)
    ddiff = float((diff_s.double() - diff_l.double()).abs().max())
    srel = rel_err(sol_s, sol_l)
    r = dict(diff_abs=ddiff, sol_rel=srel, launches=counts, halo_bytes=sh.halo_rows.bytes,
             diff_rms=float(torch.sqrt(torch.mean((diff_s.double() - diff_l.double()) ** 2))),
             bits=torch.equal(sol_s, sol_l) and torch.equal(diff_s, diff_l), **first)
    if yardstick is not None:
        for label, dd in (("sharded", diff_s), ("local", diff_l)):
            r[f"{label}_rms_vs_f64"] = float(torch.sqrt(torch.mean((dd.double() - yardstick)
                                                                   ** 2)))
    if not full:
        return r
    lhs_l, rhs_l = normal_equations_fn(cfg)(I, J)
    r["lhs_rel"], r["rhs_rel"] = rel_err(lhs_s, lhs_l), rel_err(rhs_s, rhs_l)
    del lhs_s, rhs_s
    r["diff_rel_J"] = ddiff / float(J.abs().max())
    if cfg.solver == "lu":
        # how far the unrefined LU lands from the refined solve on the same tables
        sol_x = solve_system(dataclasses.replace(cfg, solver="exact"), lhs_l, rhs_l).to(sol_l.dtype)
        diff_x = _subtract_impl(cfg, I, J, sol_x)
        r["lu_vs_exact_sol_rel"] = rel_err(sol_l, sol_x)
        r["lu_vs_exact_diff_rel_J"] = float((diff_l - diff_x).abs().max() / J.abs().max())
        del sol_x, diff_x
    del lhs_l, rhs_l, sol_l, diff_l, sol_s, diff_s
    r["check_s"] = time.perf_counter() - t1
    for label, fn in (("local", lambda: local(I, J, I, J)),
                      ("sharded", lambda: run(I, J, I, J))):
        t2 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        r[f"{label}_wall_ms"] = (time.perf_counter() - t0) * 1e3
        r[f"{label}_peak_bytes"] = torch.cuda.max_memory_allocated()
        busy, nk = device_busy(fn)
        r[f"{label}_busy_ms"], r[f"{label}_kernels"] = busy * 1e3, nk
        r[f"{label}_timing_s"] = time.perf_counter() - t2
    torch.cuda.empty_cache()
    return r


def step_twins(run, label):
    """Drive one step (`run`) recording the operands of every K3, K1, K2, K8
    and K9 launch (the wrappers replaced from outside: peel.moments,
    greek._corr_window, fdiff.fdiff_model, greek._k8_launch,
    fdiff.conv_direct), then hold each launch to its twin on them, launched
    again twice (bit-equal): K8 and K9 within 1e-12 of max (an all-zero
    twin, as K9's non-finite codes on finite planes: equal), K3 within 1e-13
    of max(|W| @ |G|), K1 within 1e-5 (c64) or 1e-11 (c128) of max, K2 on
    the model within 1e-5 (c64) or 1e-12 (c128). These launches are not
    counted on the path. Returns {kernel: [launches held, max error]}."""
    import torch
    from sfft_tpu_torch.core import fdiff, greek, moments, peel

    real = {"K3": (peel, "moments"), "K1": (greek, "_corr_window"),
            "K2": (fdiff, "fdiff_model"), "K8": (greek, "_k8_launch"),
            "K9": (fdiff, "conv_direct")}
    fns = {k: getattr(mod, name) for k, (mod, name) in real.items()}
    calls = {k: [] for k in real}

    def clone(args):
        # clones that keep the identity of an operand passed twice
        seen = {}
        return tuple(seen.setdefault(id(a), a.clone()) if isinstance(a, torch.Tensor) else a
                     for a in args)

    def recorder(key):
        def call(*args, **kw):
            calls[key].append((clone(args), kw))
            return fns[key](*args, **kw)
        # K2's launch counts on its module attribute (the recorder here)
        call.launches = 0
        return call

    for key, (mod, name) in real.items():
        setattr(mod, name, recorder(key))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for key, (mod, name) in real.items():
            setattr(mod, name, fns[key])

    def twin(key, args, kw, out):
        if key == "K3":
            W, G = args
            diff = float((out - moments.moments_plain(W, G)).abs().max())
            scale = float((W.abs() @ G.abs()).max())
            return (diff / scale if scale else (0.0 if diff == 0.0 else float("inf"))), 1e-13
        if key == "K1":
            c64 = args[0].dtype == torch.complex64
            return rel_err(out, greek.corr_pairs_plain(*args[:6])), 1e-5 if c64 else 1e-11
        if key == "K2":
            c64 = args[0].dtype == torch.complex64
            return k2_model_err(args, out, fdiff.fdiff_model_plain(*args)), 1e-5 if c64 else 1e-12
        ref = (greek.corr_table_plain(*args) if key == "K8"
               else fdiff.conv_direct_plain(*args, **kw))
        top = float(ref.abs().max())
        return (rel_err(out, ref) if top else float((out - ref).abs().max())), 1e-12

    held = {}
    for key, launches in calls.items():
        worst = 0.0
        for args, kw in launches:
            out, again = fns[key](*args, **kw), fns[key](*args, **kw)
            torch.cuda.synchronize()
            assert torch.equal(out, again), f"{label} {key}: two launches differ"
            err, tol = twin(key, args, kw, out)
            shapes = [tuple(a.shape) for a in args if hasattr(a, "shape")]
            assert err <= tol, f"{label} {key} {shapes}: {err:.3e} from its twin (bound {tol:g})"
            worst = max(worst, err)
        held[key] = [len(launches), worst]
    del calls
    torch.cuda.empty_cache()
    return held


def phase_sharded_step():
    """12c: sharded_subtract_step, the dryrun's four families and the fast,
    corr-conv and bspline-v2-peeled families at 128^2 over 8 blocks (max
    |difference change| < 1e-7 against the local step; the fast ones within
    FAST_FAMILIES' bounds), then fft/lu, contract-exact, pexact, fast and
    corr / conv / exact at N^2 (KerHW 8, poly2/poly2) and the NIRCam v2
    configuration at 900^2 (contract, corr / conv / exact, v2-fast-peeled)
    over 4 blocks: the f64 families' normal system within 1e-12 of max of
    the local step's, the difference within 1e-8 max|J| and the solution
    within 1e-6 of max, or, for an unrefined LU, no farther than it lands
    from the refined solve on the same tables; the fast families within
    FAST_FAMILIES' bounds, with both steps' RMS from the f64 fft / fft / lu
    difference. Every K3, K1, K2, K8 and K9 launch of one sharded step of
    the peeled and corr / conv families is held to its twin (step_twins)."""
    import dataclasses

    import torch
    from sfft_tpu_torch import make_config
    from sfft_tpu_torch.core.engine import solve_and_subtract_fn
    from sfft_tpu_torch.parallel import sharded_fft as sh

    out, launches = {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    I, J = (torch.as_tensor(a, device=SHARD_DEV) for a in example_pair(128, 128, seed=77))
    for name, cfg in dryrun_families(128):
        r = sharded_family(name, cfg, I, J, 8, full=False)
        add(r["launches"])
        out[f"128 {name}"] = r
        if name in FAST_FAMILIES:
            assert r["sol_rel"] <= FAST_SOL and r["diff_rms"] < FAST_RMS, \
                f"[{name}] 128^2 x8: sharded vs local {r}"
            how = (f"RMS {r['diff_rms']:.2e} (< {FAST_RMS}), solution {r['sol_rel']:.2e} of max "
                   f"(<= {FAST_SOL})")
        else:
            assert r["diff_abs"] < 1e-7, f"[{name}] 128^2 x8: sharded vs local {r['diff_abs']:.3e}"
            how = (f"max |difference change| {r['diff_abs']:.2e} (< 1e-7), solution "
                   f"{r['sol_rel']:.2e} of max")
        log(f"phase 12c {name} 128^2 x8: {how} (bit for bit: {r['bits']}); halo rows "
            f"{r['halo_bytes'] / 1e6:.2f} MB")
    base = make_config(N, N, KERHW)
    fulls = [("fft/lu", base, make_pair(N)),
             ("contract-exact", dataclasses.replace(base, **EXACT_TRIO), None),
             ("pexact", dataclasses.replace(base, greek_backend="pexact", fdiff_backend="pexact",
                                            solver="exact"), None),
             ("fast", dataclasses.replace(base, **PEELED_TRIO), None),
             ("corr-conv", dataclasses.replace(base, **DIRECT_TRIO), None),
             ("v2 NIRCam", nircam_config(**EXACT_TRIO), make_pair(V2_N)),
             ("v2 corr-conv", nircam_config(**DIRECT_TRIO), None),
             ("v2-fast-peeled", nircam_config(**PEELED_TRIO), None)]
    pair = f64 = None
    for name, cfg, new_pair in fulls:
        if new_pair is not None:
            pair = tuple(torch.as_tensor(a, device=SHARD_DEV) for a in new_pair)
            # the f64 fft / fft / lu difference of the pair: the fast bound's
            # yardstick
            f64 = solve_and_subtract_fn(dataclasses.replace(cfg, greek_backend="fft",
                                                            fdiff_backend="fft", solver="lu"))(
                *pair, *pair)[1].double()
        assert cfg.NEQ in (1740, V2_NEQ)
        fast = name in FAST_FAMILIES
        t0 = time.perf_counter()
        r = sharded_family(name, cfg, *pair, 4, full=True, yardstick=f64 if fast else None)
        add(r["launches"])
        out[name] = r
        if fast:
            held = (r["lhs_rel"] <= FAST_TABLES and r["rhs_rel"] <= FAST_TABLES
                    and r["sol_rel"] <= FAST_SOL and r["diff_rms"] < FAST_RMS
                    and r["sharded_rms_vs_f64"] < FAST_RMS)
            how = (f"fast bounds: tables <= {FAST_TABLES:g}, solution <= {FAST_SOL:g}, RMS from "
                   f"the local difference {r['diff_rms']:.3e} and from the f64 fft / fft / lu "
                   f"difference sharded {r['sharded_rms_vs_f64']:.4e} / local "
                   f"{r['local_rms_vs_f64']:.4e} (< {FAST_RMS})")
        else:
            assert r["lhs_rel"] <= 1e-12 and r["rhs_rel"] <= 1e-12, (
                f"[{name}] tables {r['lhs_rel']:.3e} / {r['rhs_rel']:.3e} of max from the "
                f"local step")
            held = r["diff_rel_J"] <= 1e-8 and r["sol_rel"] <= 1e-6
            how = "difference <= 1e-8 max|J|, solution <= 1e-6"
            if not held and "lu_vs_exact_sol_rel" in r:
                held = (r["sol_rel"] <= r["lu_vs_exact_sol_rel"]
                        and r["diff_rel_J"] <= r["lu_vs_exact_diff_rel_J"])
                how = (f"held to the local LU's distance from the refined solve: solution "
                       f"{r['lu_vs_exact_sol_rel']:.2e}, difference "
                       f"{r['lu_vs_exact_diff_rel_J']:.2e} max|J|")
        assert held, f"[{name}] sharded vs local: {r}"
        extra = ""
        run = sh.sharded_subtract_step(cfg, card_list(4))
        if cfg.greek_backend == "corr":
            # K8's plane operand is zero on the halo rows: work on padded rows
            r["k8_padded_rows_share"] = 2 * cfg.w0 / (cfg.N0 // 4)
            local = solve_and_subtract_fn(cfg)
            r["device_ms"] = {label: {k: device_ms_of(lambda: fn(*pair, *pair), fns)
                                      for k, fns in (("K8", ("corr_mma", "sum_bands")),
                                                     ("K9", ("conv_mma",)))}
                              for label, fn in (("local", local), ("sharded", run))}
            extra += (f"; K8 work on padded rows {100 * r['k8_padded_rows_share']:.1f}% "
                      f"({2 * cfg.w0} rows on {cfg.N0 // 4}); device ms local / sharded: K8 "
                      f"{r['device_ms']['local']['K8']:.2f} / {r['device_ms']['sharded']['K8']:.2f}"
                      f", K9 {r['device_ms']['local']['K9']:.3f} / "
                      f"{r['device_ms']['sharded']['K9']:.3f}")
        if cfg.greek_backend in ("peeled", "corr"):
            r["twins"] = step_twins(lambda: run(*pair, *pair), f"12c {name}")
            extra += "; held to their twins: " + ", ".join(
                f"{k} {n} launches (max {e:.1e})" for k, (n, e) in r["twins"].items() if n)
        r["s"] = time.perf_counter() - t0
        log(f"phase 12c {name} {cfg.N0}^2 NEQ {cfg.NEQ} x4: tables {r['lhs_rel']:.2e} / "
            f"{r['rhs_rel']:.2e} of max, difference {r['diff_rel_J']:.2e} max|J|, solution "
            f"{r['sol_rel']:.2e} of max ({how}; bit for bit: {r['bits']}); step wall local "
            f"{r['local_wall_ms']:.1f} / "
            f"sharded {r['sharded_wall_ms']:.1f} ms, device busy {r['local_busy_ms']:.1f} / "
            f"{r['sharded_busy_ms']:.1f} ms in {r['local_kernels']} / {r['sharded_kernels']} "
            f"kernels and copies, peak {r['local_peak_bytes'] / 2**30:.2f} / "
            f"{r['sharded_peak_bytes'] / 2**30:.2f} GiB; halo rows "
            f"{r['halo_bytes'] / 1e6:.2f} MB; launches of the sharded step "
            f"{ {k: v for k, v in r['launches'].items() if v} }{extra}; seconds: first local "
            f"{r['local_first_s']:.1f}, first sharded {r['sharded_first_s']:.1f}, checks "
            f"{r['check_s']:.1f}, timing local {r['local_timing_s']:.1f} / sharded "
            f"{r['sharded_timing_s']:.1f}, family {r['s']:.1f}")
    del pair, f64
    torch.cuda.empty_cache()
    return out, launches


# a process of the two-process survey (argv: repo, rank file prefix,
# coordinator address, process id, device ("cuda" takes the default, this
# process's cards), image side); prints its own launch counts
MULTIHOST_WORKER = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import chip_smoke as cs
from sfft_tpu_torch import make_config
from sfft_tpu_torch.parallel import multihost as mh

spec = mh.MultiHostSpec(sys.argv[3], 2, int(sys.argv[4]))
cs.N = int(sys.argv[6])
cfg = make_config(cs.N, cs.N, cs.KERHW, **cs.FAST_CFG)
cs.zero_kernel_counts()
t0 = time.perf_counter()
res = mh.run_survey_multihost(list(range(cs.MULTIHOST_TASKS)), cs.multihost_load, cfg,
                              spec=spec, devices=None if sys.argv[5] == "cuda" else [sys.argv[5]],
                              with_difference=True, timeout_s=cs.MULTIHOST_TIMEOUT_S)
wall = time.perf_counter() - t0
keys = sorted(res)
np.savez(f"{sys.argv[2]}{spec.process_id}.npz", keys=np.array(keys, int),
         sols=np.stack([res[k][0] for k in keys]), diffs=np.stack([res[k][2] for k in keys]))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "sfft_tpu")]
assert not bad, bad
print(json.dumps({"rank": spec.process_id, "keys": keys, "wall_s": wall,
                  "launches": cs.kernel_counts()}), flush=True)
'''
MULTIHOST_TASKS = 6
MULTIHOST_TIMEOUT_S = 300


def multihost_load(t):
    """Task t of the two-process survey: the bench generator's pair at
    N^2 from seed 20 + t (masked == unmasked)."""
    I, J = make_pair(N, seed=20 + t)
    return I, J, I, J


def phase_multihost(d):
    """12d: two processes on the first card, joined over gloo on localhost
    (a port from a bound socket), run run_survey_multihost over 6 tasks at
    N^2 in the fast configuration; each must return exactly its slab, every
    solution and difference bit for bit this process's batched_subtract of
    the same pairs on the same card."""
    import socket

    import torch
    from sfft_tpu_torch import make_config
    from sfft_tpu_torch.parallel import multihost as mh
    from sfft_tpu_torch.parallel.batch import batched_subtract

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    prefix = os.path.join(d, "multihost_rank")
    env = {k: v for k, v in os.environ.items()
           if k not in ("SFFT_COORDINATOR_ADDRESS", "WORLD_SIZE", "RANK")}
    t0 = time.perf_counter()
    procs = [spawn([sys.executable, "-c", MULTIHOST_WORKER, HERE, prefix,
                    f"localhost:{port}", str(pid), SHARD_DEV, str(N)], env=env,
                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in range(2)]
    try:
        # the reference while the workers run: every task's pair through
        # batched_subtract on this card
        cfg = make_config(N, N, KERHW, **FAST_CFG)
        zero_kernel_counts()
        ref = {}
        for t in range(MULTIHOST_TASKS):
            I, J, _, _ = multihost_load(t)
            sols, diffs, _ = batched_subtract(I[None], J[None], I[None], J[None], cfg,
                                              devices=card_list(1))
            ref[t] = (sols[0].cpu().numpy(), diffs[0].cpu().numpy())
        counts = kernel_counts()
        outs = [p.communicate(timeout=MULTIHOST_TIMEOUT_S + 120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    children = []
    for pid, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"multihost worker {pid} exited {p.returncode}:\n{so}\n{se[-4000:]}"
        children.append(json.loads(so.strip().splitlines()[-1]))
    for pid, child in enumerate(children):
        slab = mh.assign_tasks(MULTIHOST_TASKS, pid, 2).tolist()
        assert child["keys"] == slab, f"worker {pid} returned {child['keys']}, its slab {slab}"
        r = np.load(f"{prefix}{pid}.npz")
        for k, sol, diff in zip(r["keys"], r["sols"], r["diffs"]):
            assert np.array_equal(sol, ref[int(k)][0]) and np.array_equal(diff, ref[int(k)][1]), (
                f"task {k}: worker {pid}'s result differs from batched_subtract's")
        log(f"phase 12d worker {pid}: tasks {child['keys']} bit for bit batched_subtract; "
            f"{child['wall_s']:.1f} s in run_survey_multihost; launches {child['launches']}")
    torch.cuda.empty_cache()
    log(f"phase 12d two processes over gloo on {SHARD_DEV}: {MULTIHOST_TASKS} tasks at {N}^2 "
        f"(fast) in {wall:.1f} s wall (the workers' start, loads and steps beside this "
        f"process's reference); reference launches {counts}")
    return dict(wall_s=wall, workers=children), counts


def phase_sharded(d):
    """Phase 12: 12a-12d; returns (report, the launches of this process)."""
    t0 = time.perf_counter()
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    zero_kernel_counts()
    report = dict(fft=phase_sharded_fft())
    add(kernel_counts())
    report["exact_fft"], counts = phase_sharded_exact_fft()
    add(counts)
    t12 = [time.perf_counter()]
    report["step"], counts = phase_sharded_step()
    add(counts)
    t12.append(time.perf_counter())
    report["multihost"], counts = phase_multihost(d)
    add(counts)
    t12.append(time.perf_counter())
    report["s"] = t12[-1] - t0
    report["parts_s"] = dict(transforms=t12[0] - t0, step=t12[1] - t12[0],
                             multihost=t12[2] - t12[1])
    log(f"phase 12 parts: 12a-b {t12[0] - t0:.1f} s, 12c {t12[1] - t12[0]:.1f} s, "
        f"12d {t12[2] - t12[1]:.1f} s")
    log(f"phase 12 done in {report['s']:.1f} s; launches {launches}")
    return report, launches


# --------------------------------------------------------------------------
# phase 13: the FFT-free f64 route (K8, K9), the host utilities on K9 and
# the int16 upload

DIRECT_TRIO = dict(greek_backend="corr", fdiff_backend="conv", solver="exact")
DIRECT_KERNELS = [("corr_direct", "sfft_tpu_torch/csrc/corr_direct.cu", "sfft_tpu/core/greek.py:152"),
                  ("conv_direct", "sfft_tpu_torch/csrc/conv_direct.cu", "sfft_tpu/core/fdiff.py:107")]
CONV2D_SHAPE = (2046, 4094)   # a DECam CCD
CONV2D_KERNEL = 31
CONV2D_WIDE = 95              # past K9's 63-tap chunk: 2 x 2 chunks
# the device of phase 13 (a CPU rehearsal sets "cpu", a small N and V2_N,
# and replaces the timers)
DIRECT_DEV = "cuda"


def once_ms(fn):
    """(fn(), its device time in ms): one call between two CUDA events (for
    the plain twins, which take seconds)."""
    import torch

    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def k8_bound(Fa, Fb, R0, R1, n0, n1, same):
    """K8's least time for one (Fa, Fb, R0, R1) table: one FP64 multiply-add
    per pixel and distinct pair-lag (B is A: the pairs a < b at every lag
    and the pairs a = a at (R0 R1 + 1) / 2 lags, CC(A_a, A_a)[d] being
    CC(A_a, A_a)[-d]; else all Fa Fb pairs), against the planes read once
    and the table written once."""
    lags = R0 * R1
    pair_lags = Fa * (Fa - 1) // 2 * lags + Fa * (lags + 1) // 2 if same else Fa * Fb * lags
    return bound(8.0 * ((Fa if same else Fa + Fb) * n0 * n1 + Fa * Fb * lags),
                 2.0 * pair_lags * n0 * n1, FP64_FLOP_PER_S)


def k9_bound(F, L0, L1, n0, n1, H, W, nextra):
    """K9's least time: one FP64 multiply-add per plane, tap and pixel (and
    per background / scaling plane), against the planes, taps and extra
    planes read once and the output written once."""
    return bound(8.0 * (F * H * W + F * L0 * L1 + (nextra + 1) * n0 * n1),
                 2.0 * (F * L0 * L1 + nextra) * n0 * n1, FP64_FLOP_PER_S)


# the device functions of K8's and K9's C entries
DIRECT_DEVICE_FNS = {"sfft_corr_direct": ("corr_direct.cu", ("corr_mma", "sum_bands")),
                     "sfft_conv_direct": ("conv_direct.cu", ("conv_mma",))}


def _cuda_tool(name):
    """Path of a CUDA toolkit tool (nvcc's directory, then triton's copy), or
    None."""
    import shutil

    from sfft_tpu_torch import _kernels

    cands = [os.path.join(os.path.dirname(_kernels._nvcc()), name)]
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin",
                                  name))
    except ImportError:
        pass
    found = shutil.which(name)
    return found or next((c for c in cands if os.path.exists(c)), None)


def sass_start():
    """(process, file): cuobjdump -sass of the built library, started in the
    background (the whole library's SASS takes seconds of host time, which
    run under the phase that reads it), or None without cuobjdump."""
    from sfft_tpu_torch import _kernels

    tool = _cuda_tool("cuobjdump")
    if tool is None:
        return None
    f = tempfile.TemporaryFile(mode="w+")
    return spawn([tool, "-sass", _kernels.library_path()], stdout=f,
                  stderr=subprocess.DEVNULL, text=True), f


def _device_fn_key(mangled, fns):
    """A device function of `fns` by its mangled name (matched with its
    length prefix, so corr_stage2 is not corr_stage2_sum), an instantiation
    by its template arguments (corr_mma<5>, corr_stage1<float,5,32,2>)."""
    import re

    f = next((f for f in fns if f"{len(f)}{f}" in mangled), None)
    if f is None:
        return None
    m = re.search(f"{len(f)}{f}" + r"I((?:[a-z]|Li\d+E)+)E", mangled)
    if not m:
        return f
    args = re.findall(r"Li(\d+)E|([a-z])", m.group(1))
    names = {"f": "float", "d": "double"}
    return f"{f}<{','.join(n or names.get(c, c) for n, c in args)}>"


def isa_report(sass_job, device_fns, phase):
    """The DMMA and DFMA instructions of each device function of the C
    entries in `device_fns` ({entry: (source, function names)}) in the built
    library's SASS (``sass_start``'s job), and its registers and spills from
    the build's ptxas report (-v, kept beside the library); where a tool or
    the report is missing, "not available" (and without cuobjdump the PTX
    line of each source's f64 mma, from one more compile). Asserts a DMMA in
    every instantiation of each entry's first function (or, without
    cuobjdump, the f64 mma in its PTX)."""
    import re

    from sfft_tpu_torch import _kernels

    t0 = time.perf_counter()
    report = {}
    with tempfile.TemporaryDirectory() as d:
        path = _kernels.build_report_path()
        ptxas = open(path).read() if os.path.exists(path) else ""
        cuobjdump = sass_job is not None
        sass = ""
        if cuobjdump:
            proc, f = sass_job
            proc.wait()
            f.seek(0)
            sass = f.read()
            f.close()
        for entry, (src, fns) in device_fns.items():
            # ptxas: "Compiling entry function '<mangled>'" (for the source
            # after its "ptxas info : ..." lines), then "N bytes spill
            # stores, N bytes spill loads" and "Used N registers"
            res, cur = {}, None
            for line in ptxas.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    cur = _device_fn_key(m.group(1), fns)
                    if cur:
                        res[cur] = {"registers": "not available", "spill_bytes": "not available"}
                elif cur and "spill stores" in line:
                    st = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                    if st:
                        res[cur]["spill_bytes"] = [int(st.group(1)), int(st.group(2))]
                elif cur and "Used" in line:
                    m = re.search(r"Used (\d+) registers", line)
                    if m:
                        res[cur]["registers"] = int(m.group(1))
            counts, cur = {}, None
            for line in sass.splitlines():
                m = re.search(r"Function : (\S+)", line)
                if m:
                    cur = _device_fn_key(m.group(1), fns)
                elif cur:
                    op = re.search(r"\b(DMMA|DFMA)\b", line)
                    if op:
                        counts.setdefault(cur, {"DMMA": 0, "DFMA": 0})[op.group(1)] += 1
            for f in counts:
                res.setdefault(f, {"registers": "not available",
                                   "spill_bytes": "not available"})
            for f in res:
                res[f]["sass"] = counts.get(f, {"DMMA": 0, "DFMA": 0}) if cuobjdump else \
                    "not available"
            if not cuobjdump:
                ptx = os.path.join(d, src + ".ptx")
                subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-ptx",
                                os.path.join(_kernels.CSRC, src), "-o", ptx], capture_output=True)
                lines = open(ptx).read().splitlines() if os.path.exists(ptx) else []
                res["ptx_mma"] = next((ln.strip() for ln in lines
                                       if "mma.sync" in ln and "f64" in ln), None)
            report[entry] = res
            log(f"phase {phase} {entry} ({src}): " + ("; ".join(
                f"{f}: SASS DMMA / DFMA "
                + (f"{r['sass']['DMMA']} / {r['sass']['DFMA']}" if isinstance(r["sass"], dict)
                   else "not available (no cuobjdump)")
                + f", {r['registers']} registers, spill stores / loads {r['spill_bytes']} bytes"
                for f, r in sorted(res.items()) if f != "ptx_mma")
                or "no build report, no cuobjdump")
                + (f"; PTX: {res.get('ptx_mma')}" if not cuobjdump else ""))
    for entry, (_, fns) in device_fns.items():
        # a DMMA in every instantiation's SASS, or (no cuobjdump) the f64 mma
        # in the PTX
        if "ptx_mma" in report[entry]:
            assert report[entry]["ptx_mma"], f"{entry}: no f64 mma.sync in its PTX"
            continue
        mains = [f for f in report[entry] if f.split("<")[0] == fns[0]]
        assert mains, f"{entry}: neither the build's report nor the SASS lists {fns[0]}"
        for f in mains:
            assert report[entry][f]["sass"]["DMMA"] > 0, f"{f}: no DMMA in its SASS"
    report["s"] = time.perf_counter() - t0
    return report


def direct_k8_calls(name, A, B, w, reps=3):
    """One K8 table on the card (B is A: every pair at the lag rows rho >=
    0, mirrored):
    launched twice (bit for bit), timed, held to its twin within 1e-12 of
    the table's max; returns (table, row). library_ms comes later, from
    ``phase_direct_library``."""
    import torch
    from sfft_tpu_torch.core import greek

    R = 2 * w + 1
    out = greek.corr_window_conv(A, B, w, w)
    again = greek.corr_window_conv(A, B, w, w)
    ref, plain_ms = once_ms(lambda: greek.corr_window_conv_plain(A, B, w, w))
    torch.cuda.synchronize()
    assert torch.equal(out, again), f"K8 {name}: two launches differ"
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    assert rel <= 1e-12, f"K8 {name}: {rel:.3e} of max from its twin (bound 1e-12)"
    ms = cuda_ms(lambda: greek.corr_window_conv(A, B, w, w), reps=reps, inner=1)
    Fa, Fb = A.shape[0], B.shape[0]
    npairs = Fa * (Fa + 1) // 2 if A is B else Fa * Fb
    bms, by = k8_bound(Fa, Fb, R, R, A.shape[1], A.shape[2], A is B)
    # the launch's plan (B is A: the lag rows rho >= 0; the roles as the
    # wrapper assigns them)
    nrho = w + 1 if A is B else R
    swap = greek._k8_padded(Fb, Fa, R) < greek._k8_padded(Fa, Fb, R)
    plan = greek._k8_plan(*((Fb, Fa) if swap else (Fa, Fb)), A.shape[1], A.shape[2], nrho, w)
    plan = {k: plan[k] for k in ("NT", "RT", "W", "CS", "nunits", "nbands", "smem")}
    row = dict(shape=[Fa, Fb, A.shape[1], A.shape[2], R, R], pairs=npairs, max_abs_err=err,
               rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               share=bms / ms, library_ms=None, plan=plan, swap=swap)
    log(f"phase 13a K8 {name} {tuple(out.shape)} ({npairs} pairs): {ms:.3f} ms, bound "
        f"{bms:.3f} ms ({by}; {100 * bms / ms:.1f}%), twin {plain_ms:.1f} ms; {rel:.2e} of max "
        f"from the twin, two launches bit for bit; plan {plan}{', roles swapped' if swap else ''}")
    return out, row


# K8's library yardstick, table by table in a child process, least
# multiply-adds first
K8_LIBRARY_TABLES = ("cthe", "v2_pbs", "cgam", "comg", "v2_comg")
K8_LIBRARY_TIMEOUT_S = 150
K8_LIBRARY_CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs

cs.N, cs.V2_N, cs.KERHW, cs.V2_KERHW = (int(a) for a in sys.argv[2:6])
cs.DIRECT_DEV = sys.argv[6]
for key in sys.argv[8:]:
    print(json.dumps(cs.k8_library_call(key, float(sys.argv[7]))), flush=True)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "sfft_tpu")]
assert not bad, bad
'''
_K8_OPERANDS = {}


def k8_table_operands(key, lam):
    """(A, B, w) of one of phase 13a's K8 tables, made as 13a makes them."""
    import torch
    from sfft_tpu_torch import make_config
    from sfft_tpu_torch.core import engine

    v2 = key.startswith("v2_")
    if v2 not in _K8_OPERANDS:
        n = V2_N if v2 else N
        I, J = (torch.as_tensor(a, device=DIRECT_DEV) for a in make_pair(n))
        cfg = nircam_config(lam, **DIRECT_TRIO) if v2 else make_config(N, N, KERHW, **DIRECT_TRIO)
        SI, ST, SSc = engine._plane_stacks(cfg, I)
        _K8_OPERANDS.clear()
        _K8_OPERANDS[v2] = (SI, ST, J, None if SSc is None else
                            SSc[:cfg.scaling_basis.num_funcs()].contiguous())
    SI, ST, J, SScA = _K8_OPERANDS[v2]
    w = V2_KERHW if v2 else KERHW
    return dict(comg=(SI, SI, 2 * w), cgam=(SI, ST, w), cthe=(SI, J[None], w),
                v2_comg=(SI, SI, 2 * w), v2_pbs=(SI, SScA, w))[key]


def k8_library_call(key, lam):
    """The library yardstick of one K8 table (run by phase_direct_library's
    child): sfft_tpu's own formulation as one PyTorch call, F.conv2d of the
    wrap-padded B stack (Fb images of one channel) with the A planes as its
    weight (cuDNN in float64), timed by CUDA events (a second call unless
    the first took over 10 s), and its distance from K8's table; a call
    the card refuses gives its error."""
    import torch.nn.functional as F_
    from sfft_tpu_torch.core import greek

    A, B, w = k8_table_operands(key, lam)
    Bp = F_.pad(B[:, None], (w, w, w, w), mode="circular")
    call = lambda: F_.conv2d(Bp, A[:, None])  # noqa: E731
    try:
        out, ms = once_ms(call)
        if ms < 10000:
            out, ms = once_ms(call)
    except RuntimeError as e:   # torch.OutOfMemoryError among them
        return dict(table=key, ms=None, failure=f"{type(e).__name__}: "
                    + (str(e).strip().splitlines() or [""])[0][:200])
    ref = greek.corr_window_conv(A, B, w, w)
    rel = float((out.transpose(0, 1) - ref).abs().max() / ref.abs().max())
    return dict(table=key, ms=ms, rel_err=rel, failure=None)


def phase_direct_library(lam):
    """13a's library yardsticks: k8_library_call on every table, in a child
    process (a CUDA context of its own, under a time limit: cuDNN's f64
    route may take minutes on a table); {table: result}. A table the child
    did not report gets its failure: the error that ended the child, or the
    time limit that stopped it (the table it was on), and the tables after
    that one are not run."""
    proc = spawn([sys.executable, "-c", K8_LIBRARY_CHILD, HERE,
                  *(str(v) for v in (N, V2_N, KERHW, V2_KERHW)), DIRECT_DEV,
                  repr(lam), *K8_LIBRARY_TABLES],
                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=K8_LIBRARY_TIMEOUT_S)
        why = f"the child exited {proc.returncode}: " + " ".join(err.strip().splitlines()[-1:])
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        why = f"not done within {K8_LIBRARY_TIMEOUT_S} s (the child was stopped)"
    res = {}
    for line in out.splitlines():
        if line.startswith("{"):
            d = json.loads(line)
            res[d["table"]] = d
    first = next((k for k in K8_LIBRARY_TABLES if k not in res), None)
    for key in K8_LIBRARY_TABLES:
        if key not in res:
            res[key] = dict(table=key, ms=None, failure=why if key == first else
                            f"not run: the child ended on {first}")
    return res


def direct_k9_call(name, planes, taps, wrap, extra=None, reps=5):
    """One K9 call on the card: twice (bit for bit), timed against its twin
    and the library's grouped F.conv2d of the same planes, held to the twin
    within 1e-12 of max; returns (output, row)."""
    import torch
    import torch.nn.functional as F_
    from sfft_tpu_torch.core import fdiff

    extra = extra or {}
    out = fdiff.conv_direct(planes, taps, wrap, **extra)
    again = fdiff.conv_direct(planes, taps, wrap, **extra)
    ref, plain_ms = once_ms(lambda: fdiff.conv_direct_plain(planes, taps, wrap, **extra))
    torch.cuda.synchronize()
    assert torch.equal(out, again), f"K9 {name}: two launches differ"
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    assert rel <= 1e-12, f"K9 {name}: {rel:.3e} of max from its twin (bound 1e-12)"
    ms = cuda_ms(lambda: fdiff.conv_direct(planes, taps, wrap, **extra), reps=reps, inner=2)
    F, L0, L1 = taps.shape
    x = planes[None]
    if wrap:
        x = F_.pad(x, (L1 // 2, L1 // 2, L0 // 2, L0 // 2), mode="circular")
    kf = torch.flip(taps, dims=(1, 2))[:, None]
    lib_ms = cuda_ms(lambda: F_.conv2d(x, kf, groups=F), reps=3, inner=1)
    n0, n1 = out.shape
    nextra = sum(extra[k].shape[0] for k in ("ST", "SSc") if extra.get(k) is not None)
    bms, by = k9_bound(F, L0, L1, n0, n1, planes.shape[1], planes.shape[2],
                       nextra + (1 if extra.get("J") is not None else 0))
    row = dict(shape=[F, n0, n1, L0, L1], wrap=bool(wrap), max_abs_err=err, rel_err=rel, ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by, share=bms / ms, library_ms=lib_ms)
    log(f"phase 13b K9 {name} ({F} planes {n0} x {n1}, taps {L0} x {L1}, "
        f"{'wrap' if wrap else 'padded'}): {ms:.3f} ms, bound {bms:.3f} ms ({by}; "
        f"{100 * bms / ms:.1f}%), twin {plain_ms:.2f} ms, F.conv2d(groups={F}) {lib_ms:.3f} ms; "
        f"{rel:.2e} of max from the twin, two launches bit for bit")
    return out, row


def direct_profile(step, nk8, nk9, k_ms):
    """(busy s, kernels and copies, unwarmed) of one step, from a
    device-only profile that opens with a warm-up step (torch.profiler's
    schedule: one step traced and dropped, the next kept). After phases
    1-12 a profile without it loses the start of the step (13c's first K8
    tables); `unwarmed` is such a profile's (busy s, K8 launches seen),
    kept to show it. The kept step must hold its nk8 K8 and nk9 K9 launches,
    and its busy time must be at least k_ms, their CUDA-event times from
    13a-b. The warmed profile, too, has come back without a single device
    record; one that lost records is taken again, up to PROFILE_TRIES
    times, and the last is held to the check."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def read(ev):
        return (sum(_dev_us(e) for e in ev) / 1e6, sum(e.count for e in ev),
                sum(e.count for e in ev if "corr_mma" in e.key),
                sum(e.count for e in ev if "conv_mma" in e.key))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    ubusy, _, un8, _ = read([e for e in prof.key_averages() if _on_device(e)])
    for attempt in range(1, PROFILE_TRIES + 1):
        busy, nk, n8, n9 = read(_warm_device_events(step))
        if (n8, n9) == (nk8, nk9) and busy * 1e3 >= k_ms:
            break
        log(f"phase 13c profile {attempt} of {PROFILE_TRIES} lost records: {n8} K8 and {n9} "
            f"K9 launches of {nk8}, {nk9}, {busy * 1e3:.1f} ms busy")
    assert (n8, n9) == (nk8, nk9) and busy * 1e3 >= k_ms, (
        f"the profiled step holds {n8} K8 and {n9} K9 launches (the step launches {nk8}, {nk9}) "
        f"and {busy * 1e3:.1f} ms busy (its K8 and K9 take {k_ms:.1f} ms by CUDA events)")
    return busy, nk, (ubusy, un8)


def phase_direct_path(I, J, lam):
    """13c: PCP at 4096^2 and BSP on the NIRCam v2 configuration with corr /
    conv / exact (the main paths of the FFT-free route), each against the
    f64 fft route of the same pair; and, on their operands, 13a's K8 and
    13b's K9 checks (the references run first, so that K9 sees a real
    solution)."""
    import tempfile

    import torch
    from sfft_tpu_torch import BSplinePacket, PureTorchCustomizedPacket, make_config
    from sfft_tpu_torch.core import engine, fdiff, greek

    report, rows = {}, {}
    c = slice(N // 4, 3 * N // 4)
    # the yardstick: fft / fft / exact (K1, K2 in c128) on the same pair
    xcfg = make_config(N, N, KERHW, solver="exact")
    solx, diffx = PureTorchCustomizedPacket.PCP(I, J, I, J, "REF", KERHW, cfg=xcfg)
    lcfg = make_config(N, N, KERHW, greek_backend="corr", fdiff_backend="conv")
    cfg = make_config(N, N, KERHW, **DIRECT_TRIO)
    assert cfg.NEQ == (1740 if KERHW == 8 else cfg.NEQ)

    # 13a: K8 on the 4096^2 step's three tables, and the f64 fft tables
    SI, ST, _ = engine._plane_stacks(cfg, I)
    w = KERHW
    Comg, rows["comg"] = direct_k8_calls(f"{N}^2 Comg", SI, SI, 2 * w)
    Cgam, rows["cgam"] = direct_k8_calls(f"{N}^2 Cgam", SI, ST, w)
    Cthe, rows["cthe"] = direct_k8_calls(f"{N}^2 Cthe", SI, J[None], w)
    fft_tables = greek.greek_tables(SI, ST, J, w, w, backend="fft")
    k1 = {}
    for name, t, f in (("Comg", Comg, fft_tables[0]), ("Cgam", Cgam, fft_tables[1]),
                       ("Cthe", Cthe[:, 0], fft_tables[2])):
        k1[name] = float((t - f).abs().max() / f.abs().max())
        assert k1[name] <= 1e-12, f"K8 {name} vs the fft route's (K1 c128): {k1[name]:.3e}"
    log(f"phase 13a K8's {N}^2 tables vs the f64 fft route's (K1 c128): "
        + ", ".join(f"{k} {v:.2e}" for k, v in k1.items()) + " of max (bound 1e-12)")
    report["k8_vs_fft_tables"] = k1
    del Comg, Cgam, Cthe, fft_tables

    # 13b: K9 on the step's difference (the yardstick's solution)
    a_ijab, b_pq = fdiff.split_solution(cfg, solx)
    Astd = fdiff.standard_kernel_coeffs(cfg, a_ijab)
    _, rows["fdiff_4096"] = direct_k9_call(
        f"fdiff {N}^2", SI, Astd, True, dict(J=J, ST=ST, b=b_pq, scale=cfg.SCALE))
    conv_fd = fdiff.fdiff_conv(cfg, solx, SI, ST, J)
    fft_fd = fdiff.fdiff_fft(cfg, solx, SI, ST, J)
    fd_err = float((conv_fd - fft_fd).abs().max() / J.abs().max())
    assert fd_err <= 1e-10, f"fdiff_conv vs fdiff_fft on one solution: {fd_err:.3e} max|J|"
    log(f"phase 13c fdiff_conv (K9) vs fdiff_fft (K2, cuFFT) on the fft / fft / exact "
        f"solution: {fd_err:.3e} max|J| (bound 1e-10)")
    report["fdiff_conv_vs_fft"] = fd_err
    # the cost of fdiff_conv's non-finite repair (conv_direct_nonfinite: the
    # planes' non-finite values zeroed, a second K9 launch on their codes,
    # the terms decoded), all of it paid on this all-finite step
    nf_ms = cuda_ms(lambda: fdiff.fdiff_conv(cfg, solx, SI, ST, J), reps=5, inner=2)
    k9_ms = cuda_ms(lambda: fdiff.conv_direct(SI, Astd, True, J=J, ST=ST, b=b_pq,
                                              scale=cfg.SCALE), reps=5, inner=2)
    report["nonfinite_repair"] = dict(fdiff_conv_ms=nf_ms, k9_alone_ms=k9_ms,
                                      cost_ms=nf_ms - k9_ms)
    log(f"phase 13c fdiff_conv's non-finite repair on the {N}^2 conv step: fdiff_conv "
        f"{nf_ms:.3f} ms against its K9 launch alone {k9_ms:.3f} ms: the repair costs "
        f"{nf_ms - k9_ms:.3f} ms a step (no host sync)")
    del SI, ST, conv_fd, fft_fd

    # 13c: the main path at 4096^2, counts set to 0 just before
    zero_kernel_counts()
    sol, diff, step_s = run_pcp(I, J, cfg, plain=False, reps=1)
    launches = kernel_counts()
    # K9: the difference and the non-finite codes, a launch each a step
    assert launches["corr_direct"] == 6 and launches["conv_direct"] == 4, \
        f"the 4096^2 corr / conv path: {launches}"
    assert sol.shape == (cfg.NEQ,) and bool(torch.isfinite(diff).all())
    rms = float(torch.sqrt(torch.mean(diff[c, c] ** 2)))
    assert 1.3 <= rms <= 1.7, f"corr/conv/exact: central difference RMS {rms:.4f}"
    drms = float(torch.sqrt(torch.mean((diff - diffx) ** 2)))
    srel = float((sol - solx).abs().max() / solx.abs().max())
    assert drms < 1e-6, f"corr/conv/exact: RMS(diff - fft/fft/exact) {drms:.3e} >= 1e-6"
    assert srel <= 1e-6, f"corr/conv/exact: solution {srel:.3e} of max from fft/fft/exact"
    step = lambda: PureTorchCustomizedPacket.PCP(I, J, I, J, "REF", KERHW, cfg=cfg)  # noqa: E731
    busy, nk, unwarmed = direct_profile(
        step, 3, 2, sum(rows[k]["ms"] for k in ("comg", "cgam", "cthe", "fdiff_4096")))
    idle = 1 - busy / step_s
    lsol, ldiff, lstep_s = run_pcp(I, J, lcfg, plain=False, reps=1)
    ldrms = float(torch.sqrt(torch.mean((ldiff - diffx) ** 2)))
    lsrel = float((lsol - solx).abs().max() / solx.abs().max())
    report["pcp_4096"] = dict(step_ms=step_s * 1e3, busy_ms=busy * 1e3, kernels=nk, idle=idle,
                              unwarmed_profile=dict(busy_ms=unwarmed[0] * 1e3,
                                                    k8_launches_seen=unwarmed[1]),
                              launches=launches, central_rms=rms,
                              vs_fft_exact_rms=drms, vs_fft_exact_sol_rel=srel,
                              lu=dict(step_ms=lstep_s * 1e3, vs_fft_exact_rms=ldrms,
                                      vs_fft_exact_sol_rel=lsrel))
    log(f"phase 13c PCP {N}^2 KerHW={KERHW} corr/conv/exact: step {step_s * 1e3:.1f} ms; one "
        f"profiled step: busy {busy * 1e3:.1f} ms in {nk} kernels and copies, idle share of "
        f"the step {idle:.3f} (a profile without the warm-up step: busy "
        f"{unwarmed[0] * 1e3:.1f} ms, {unwarmed[1]} of the 3 K8 launches); launches {launches} "
        f"in 2 runs; central diff RMS {rms:.4f}; vs fft/fft/exact: RMS(diff) {drms:.3e} (bound 1e-6), solution {srel:.3e} of max "
        f"(bound 1e-6); corr/conv/lu beside it (unrefined LU, ROADMAP fault 3): step "
        f"{lstep_s * 1e3:.1f} ms, RMS(diff) {ldrms:.3e}, solution {lsrel:.3e} of max")
    del sol, diff, lsol, ldiff, solx, diffx
    torch.cuda.empty_cache()

    # the v2 NIRCam configuration through BSP
    n = V2_N
    cv = slice(n // 4, 3 * n // 4)
    with tempfile.TemporaryDirectory() as d:
        ref, sci = write_pair_fits(d)
        vcfg = nircam_config(lam, **DIRECT_TRIO)
        ycfg = nircam_config(lam)
        assert vcfg.NEQ == V2_NEQ and vcfg.scaling_mode == "SEPARATE-VARYING"
        ysol, ydiff = BSplinePacket.BSP(ref, sci, ref, sci, cfg=ycfg)
        Iv = torch.as_tensor(make_pair(n)[0], device=DIRECT_DEV)
        SIv, STv, SScv = engine._plane_stacks(vcfg, Iv)
        nact = vcfg.scaling_basis.num_funcs()
        wv = V2_KERHW
        _, rows["v2_comg"] = direct_k8_calls(f"v2 {n}^2 Comg", SIv, SIv, 2 * wv, reps=2)
        _, rows["v2_pbs"] = direct_k8_calls(f"v2 {n}^2 Pbs", SIv, SScv[:nact].contiguous(), wv)
        ya, yb = fdiff.split_solution(vcfg, torch.as_tensor(ysol, device=DIRECT_DEV))
        Av = ya.clone()
        Av[:, wv, wv] = -(ya.sum(dim=(1, 2)) - ya[:, wv, wv])
        Jv = torch.as_tensor(make_pair(n)[1], device=DIRECT_DEV)
        _, rows["fdiff_v2"] = direct_k9_call(
            f"fdiff v2 {n}^2 with SSc", SIv, Av, True,
            dict(J=Jv, ST=STv, b=yb, SSc=SScv[:nact].contiguous(),
                 a00=ya[:nact, wv, wv].contiguous(), scale=vcfg.SCALE))
        del SIv, STv, SScv, Iv, Jv
        zero_kernel_counts()
        vsol, vdiff, vstep_s = run_bsp(ref, sci, vcfg, plain=False, reps=1)
        vl = kernel_counts()
        assert vl["corr_direct"] == 8 and vl["conv_direct"] == 4 and vl["slice_triple"] > 0, \
            f"the v2 corr / conv / exact path: {vl}"
        assert np.isfinite(vsol).all() and np.isfinite(vdiff).all()
        vrms = float(np.sqrt(np.mean(vdiff[cv, cv] ** 2)))
        assert 1.3 <= vrms <= 1.7, f"v2 corr/conv/exact: central difference RMS {vrms:.4f}"
        vdrms = float(np.sqrt(np.mean((vdiff - ydiff) ** 2)))
        vsrel = float(np.abs(vsol - ysol).max() / np.abs(ysol).max())
        assert vdrms < 1e-6, f"v2 corr/conv/exact: RMS(diff - fft/fft/lu) {vdrms:.3e} >= 1e-6"
        assert vsrel <= 1e-6, f"v2 corr/conv/exact: solution {vsrel:.3e} of max from fft/fft/lu"
        vstep = lambda: BSplinePacket.BSP(ref, sci, ref, sci, cfg=vcfg)  # noqa: E731
        vbusy, vnk, vunwarmed = direct_profile(
            vstep, 4, 2, sum(rows[k]["ms"] for k in ("v2_comg", "v2_pbs", "fdiff_v2")))
        vidle = 1 - vbusy / vstep_s
    report["bsp_v2"] = dict(lam=lam, step_ms=vstep_s * 1e3, busy_ms=vbusy * 1e3, kernels=vnk,
                            idle=vidle, unwarmed_profile=dict(busy_ms=vunwarmed[0] * 1e3,
                                                              k8_launches_seen=vunwarmed[1]),
                            launches=vl,
                            central_rms=vrms, vs_fft_lu_rms=vdrms, vs_fft_lu_sol_rel=vsrel)
    log(f"phase 13c BSP v2 {n}^2 GKerHW={V2_KERHW} NIRCam configuration, lambda={lam:g}, "
        f"corr/conv/exact NEQ={vcfg.NEQ}: step {vstep_s * 1e3:.1f} ms; one profiled step: "
        f"busy {vbusy * 1e3:.1f} ms in {vnk} kernels and copies, idle share of the step "
        f"{vidle:.3f} (a profile without the warm-up step: busy {vunwarmed[0] * 1e3:.1f} ms, "
        f"{vunwarmed[1]} of the 4 K8 launches); launches {vl} in 2 runs; central diff RMS "
        f"{vrms:.4f}; vs fft/fft/lu: "
        f"RMS(diff) {vdrms:.3e} (bound 1e-6), solution {vsrel:.3e} of max (bound 1e-6)")
    return report, rows, {k: launches[k] + vl[k] for k in launches}


def phase_direct_convolve2d():
    """13b: convolve2d (the host utility on K9) on a DECam-sized image with a
    31 x 31 kernel in each boundary mode, with a NaN fill (NaN exactly in
    the edge strips where the twin has it) and with NaN interpolation, and
    with a 95 x 95 kernel (K9's taps in chunks), held to the same call on
    K9's twin within 1e-12 of max."""
    import torch
    from sfft_tpu_torch.core import fdiff
    from sfft_tpu_torch.utils.convolve import convolve2d

    rng = np.random.default_rng(13)
    img = torch.as_tensor(rng.normal(300.0, 20.0, CONV2D_SHAPE), device=DIRECT_DEV)
    holed = img.clone()
    holed[5:9, 20:80] = float("nan")
    holed[3 * CONV2D_SHAPE[0] // 4, 3 * CONV2D_SHAPE[1] // 4] = float("nan")
    ker = gaussian_psf(CONV2D_KERNEL, 4.0)
    rows = {}
    for name, x, k, kw in [("extend", img, ker, dict(boundary="extend")),
                           ("fill", img, ker, dict(boundary="fill", fill_value=5.0)),
                           ("NaN fill", img, ker, dict(boundary="fill", fill_value=np.nan)),
                           ("wrap", img, ker, dict(boundary="wrap")),
                           ("interpolate", holed, ker, dict(boundary="extend",
                                                            nan_treatment="interpolate")),
                           ("wide extend", img,
                            gaussian_psf(CONV2D_WIDE, 12.0), dict(boundary="extend"))]:
        out = convolve2d(x, k, **kw)
        ref = one_twin(fdiff, "conv_direct", fdiff.conv_direct_plain,
                       lambda: convolve2d(x, k, **kw))
        torch.cuda.synchronize()
        fin = torch.isfinite(ref)
        assert torch.equal(torch.isfinite(out), fin), f"convolve2d {name}: NaN pattern differs"
        rel = float((out[fin] - ref[fin]).abs().max() / ref[fin].abs().max())
        assert rel <= 1e-12, f"convolve2d {name}: {rel:.3e} of max from K9's twin"
        ms = cuda_ms(lambda: convolve2d(x, k, **kw), reps=3, inner=2)
        rows[name] = dict(rel_err=rel, ms=ms)
        log(f"phase 13b convolve2d {CONV2D_SHAPE} {k.shape[0]}x{k.shape[1]} {name}: "
            f"{ms:.3f} ms a call; {rel:.2e} of max from the call on K9's twin")
    taps = torch.as_tensor(ker, device=DIRECT_DEV)[None]
    h = CONV2D_KERNEL // 2
    padded = torch.nn.functional.pad(img[None, None], (h, h, h, h), mode="replicate")[0]
    _, rows["k9"] = direct_k9_call(f"convolve2d's plane {CONV2D_SHAPE}", padded, taps, False)
    return rows


def phase_direct_packed():
    """13d: batched_subtract_packed on two fast 4096^2 pairs, bit for bit
    batched_subtract on the dequantized planes; the upload of one pair's
    four planes packed (int16 + scales) against f64."""
    import torch
    from sfft_tpu_torch import make_config
    from sfft_tpu_torch.parallel import batch
    from sfft_tpu_torch.utils import pack

    cfg = make_config(N, N, KERHW, greek_backend="peeled", fdiff_backend="fft32",
                      solver="refined")
    pairs = [make_pair(N, seed) for seed in (30, 31)]
    Is, Js = [p[0] for p in pairs], [p[1] for p in pairs]
    mIs, mJs = [a.copy() for a in Is], [a.copy() for a in Js]
    out = batch.batched_subtract_packed(Is, Js, mIs, mJs, cfg, devices=[DIRECT_DEV])

    def deq(a):
        pk = pack.pack_i16(np.ascontiguousarray(a, np.float32))
        return pack.unpack_i16(torch.as_tensor(pk.q), torch.as_tensor(pk.scales), pk.n0, pk.block)

    ref = batch.batched_subtract(*([deq(a) for a in s] for s in (Is, Js, mIs, mJs)), cfg,
                                 devices=[DIRECT_DEV])
    torch.cuda.synchronize()
    for name, o, r in zip(("solutions", "differences", "rms"), out, ref):
        assert torch.equal(o, r), f"batched_subtract_packed: {name} differ"
    rms = [float(v) for v in out[2]]
    planes = [Is[0], Js[0], mIs[0], mJs[0]]
    t0 = time.perf_counter()
    packs = [pack.pack_i16(np.ascontiguousarray(a, np.float32)) for a in planes]
    pack_s = time.perf_counter() - t0
    del packs
    up = {}
    for name, fn in (("f64", batch.upload_planes), ("packed", batch.upload_packed)):
        ts = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tensors, event = fn(planes, torch.device(DIRECT_DEV))
            if event is not None:
                event.synchronize()
            ts.append(time.perf_counter() - t0)
            del tensors
        up[name] = statistics.median(ts[1:]) * 1e3
    log(f"phase 13d batched_subtract_packed on two fast {N}^2 pairs: solutions, differences "
        f"and RMS bit for bit batched_subtract on the dequantized planes (RMS {rms}); one "
        f"pair's four planes: f64 upload {up['f64']:.2f} ms ({4 * N * N * 8 / 1e6:.1f} MB), "
        f"packed upload and dequantization {up['packed']:.2f} ms (host packing of the four "
        f"planes {pack_s * 1e3:.0f} ms, counted in it: median of 3 after a first call)")
    return dict(rms=rms, upload_f64_ms=up["f64"], upload_packed_ms=up["packed"],
                pack_host_ms=pack_s * 1e3)


def phase_direct(lam=V2_LAMBDA):
    """Phase 13: 13a-13d; returns (report, the kernels line's rows of K8 and
    K9, the main paths' launches)."""
    import torch

    t0 = time.perf_counter()
    sass_job = sass_start()
    I, J = (torch.as_tensor(a, device=DIRECT_DEV) for a in make_pair(N))
    report, rows, launches = phase_direct_path(I, J, lam)
    report["isa"] = isa_report(sass_job, DIRECT_DEVICE_FNS, "13a-b")
    del I, J
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    report["convolve2d"] = phase_direct_convolve2d()
    t2 = time.perf_counter()
    report["packed"] = phase_direct_packed()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    lib = phase_direct_library(lam)
    for key, r in lib.items():
        rows[key]["library_ms"] = r["ms"]
        if r["ms"] is None:
            rows[key]["library_failure"] = r["failure"]
            log(f"phase 13a K8 {key}: the library call (F.conv2d with the planes as its weight, "
                f"cuDNN f64) gave no time: {r['failure']}")
        else:
            rows[key]["library_rel_err"] = r["rel_err"]
            log(f"phase 13a K8 {key}: the library call (F.conv2d with the planes as its weight, "
                f"cuDNN f64) {r['ms']:.3f} ms against K8's {rows[key]['ms']:.3f} ms; "
                f"{r['rel_err']:.2e} of max from K8's table")
    report["k8"], report["k9"] = ({k: rows[k] for k in keys} for keys in (
        ("comg", "cgam", "cthe", "v2_comg", "v2_pbs"), ("fdiff_4096", "fdiff_v2")))
    report["k9"]["convolve2d"] = report["convolve2d"].pop("k9")
    report["s"] = time.perf_counter() - t0
    log(f"phase 13 parts: 13a-c {t1 - t0:.1f} s, 13b convolve2d {t2 - t1:.1f} s, "
        f"13d {t3 - t2:.1f} s, 13a's library calls {time.perf_counter() - t3:.1f} s; done in "
        f"{report['s']:.1f} s; launches {launches}")
    # the kernels line: K8 over the 4096^2 step's three tables, K9 its
    # difference
    k8 = [rows[k] for k in ("comg", "cgam", "cthe")]
    lib8 = [r["library_ms"] for r in k8]
    line = {"corr_direct": dict(
        {k: sum(r[k] for r in k8) for k in ("ms", "plain_ms", "bound_ms")},
        max_abs_err=max(r["max_abs_err"] for r in k8), bound_by="operations",
        library_ms=None if None in lib8 else sum(lib8)),
        "conv_direct": {k: rows["fdiff_4096"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                            "bound_ms", "bound_by",
                                                            "library_ms")}}
    return report, line, launches


# --------------------------------------------------------------------------
# phase 14: the leading pair axis (core/engine.solve_and_subtract_batched_fn)
# --------------------------------------------------------------------------

# the kernels of the batched step (the --batched run's kernels line)
BATCHED_KERNELS = [
    ("moments", "sfft_tpu_torch/csrc/moments.cu", "sfft_tpu/core/pallas_moments.py:143"),
    ("corr_window", "sfft_tpu_torch/csrc/corr_window.cuh", "sfft_tpu/core/greek.py:94"),
    ("fdiff_model", "sfft_tpu_torch/csrc/fdiff_model.cu", "sfft_tpu/core/fdiff.py:90"),
    ("slice_pair", "sfft_tpu_torch/csrc/slice_pair.cu", "sfft_tpu/core/pallas_slice.py:135"),
    ("slice_triple", "sfft_tpu_torch/csrc/slice_triple.cu", "sfft_tpu/core/pallas_slice.py:214"),
    ("sliced_epilogue", "sfft_tpu_torch/csrc/sliced_epilogue.cu",
     "sfft_tpu/core/exact_fft.py:372"),
    ("pair_products", "sfft_tpu_torch/csrc/pair_products.cu", "sfft_tpu/core/exact_fft.py:963"),
    ("pair_model", "sfft_tpu_torch/csrc/pair_model.cu", "sfft_tpu/core/pexact.py:397"),
    ("pair_poly", "sfft_tpu_torch/csrc/pair_poly.cu", "sfft_tpu/core/pexact.py:71")]
# the configurations of phase 14: (image, backends) with the image "N" (the
# 4096^2 fast slice's shape: make_config(N, N, KERHW), poly2 / poly2) or
# "V2" (the NIRCam configuration at V2_N^2: nircam_config); the batch sizes
# (per configuration where they differ, each as far as max_batch allows; a
# --batched run takes the v2 trios' larger batches too), the seed of the
# first pair, the batch whose kernel launches are held to their twins and
# to their per-pair launches
BATCH_TRIOS = {"fast": ("N", FAST_CFG),
               "default": ("N", dict(greek_backend="fft", fdiff_backend="fft", solver="lu")),
               "contract": ("N", dict(greek_backend="pexact", fdiff_backend="pexact",
                                      solver="transformed")),
               "exact": ("N", EXACT_TRIO),
               "bsp-default": ("V2", {}),
               "v2-fast-fft32": ("V2", FAST_TRIO),
               "v2-contract": ("V2", EXACT_TRIO)}
BATCH_SIZES = (1, 2, 4, 8)
BATCH_SIZES_OF = {"contract": (1, 2, 4), "exact": (1, 2), "bsp-default": (1, 2),
                  "v2-fast-fft32": (1, 2, 4), "v2-contract": (1, 2)}
BATCH_SIZES_HEAVY = {"v2-fast-fft32": (1, 2, 4, 8), "v2-contract": (1, 2, 4, 8)}
BATCH_SEED = 40
BATCH_TWIN_B = {"fast": 4, "default": 2, "contract": 2, "exact": 2, "bsp-default": 2,
                "v2-fast-fft32": 2, "v2-contract": 2}
# one set of the config's launches a batched step, whatever B (K2's counter
# counts its two launches a call; K4 its slicing and its scale launches;
# K6p all its modes, and the sub and add64 modes each); the configurations
# not listed launch what their single step launches (K5 once for each
# pair's solve)
BATCH_LAUNCHES = {"fast": {"moments": 2, "corr_window": 2, "fdiff_model": 2},
                  "default": {"corr_window": 3, "fdiff_model": 2},
                  "contract": {"moments": 2, "slice_pair": 83, "sliced_epilogue": 46,
                               "pair_products": 32, "pair_model": 1, "pair_poly": 3,
                               "pair_poly_sub": 2, "pair_poly_add64": 1}}


def batch_cfg(name: str):
    """The SFFTConfig of phase 14's configuration `name`."""
    from sfft_tpu_torch import make_config

    image, backends = BATCH_TRIOS[name]
    return nircam_config(**backends) if image == "V2" else make_config(N, N, KERHW, **backends)


def batched_twins(step, label):
    """Drive one batched step (`step`) recording the operands of every K3,
    K1 and K2 launch, then hold each launch to its twin (step_twins'
    bounds), launched again twice (bit-equal), and each pair's share of it
    bit for bit that pair's own launch: K3 M[b] = W @ G[b], K1 the pair's
    segment of the list on its own planes, K2 the pair's model spectrum.
    The contract and exact trios' K4, K5, K7, K6a, K6m and K6p launches are
    held as they run (``exact_twins_inline``). These launches are not counted on the
    path. Returns {kernel: [launches held, max error against the twin]}."""
    import torch
    from sfft_tpu_torch.core import fdiff, greek, moments, peel

    real = {"K3": (peel, "moments"), "K1": (greek, "_corr_window"),
            "K2": (fdiff, "fdiff_model")}
    fns = {k: getattr(mod, name) for k, (mod, name) in real.items()}
    calls = {k: [] for k in real}

    def recorder(key):
        def call(*args, **kw):
            seen = {}
            calls[key].append((tuple(seen.setdefault(id(a), a.clone())
                                     if isinstance(a, torch.Tensor) else a for a in args), kw))
            return fns[key](*args, **kw)
        call.launches = 0
        return call

    for key, (mod, name) in real.items():
        setattr(mod, name, recorder(key))
    try:
        with exact_twins_inline(label) as inline:
            step()
            torch.cuda.synchronize()
    finally:
        for key, (mod, name) in real.items():
            setattr(mod, name, fns[key])

    def pairs_of(key, args, kw, out):
        # each pair's share of the batched launch and the pair's own launch
        if key == "K3":
            W, G = args
            return [(out[b], fns[key](W, G[b].contiguous())) for b in range(G.shape[0])]
        if key == "K2":
            specs, FS, sol = args[:3]
            return [(out[b], fns[key](specs[b], None if FS is None else FS[b], sol[b], *args[3:]))
                    for b in range(specs.shape[0])]
        A, Bv, ia, ib, E0, E1 = args
        blocks = kw.get("blocks", 1)
        n = len(ia) // blocks
        one = A.data_ptr() == Bv.data_ptr() and A.shape == Bv.shape
        res = []
        for z in range(blocks):
            seg = slice(z * n, (z + 1) * n)
            if one:   # one stack: the pair's planes of it, as its single call has them
                loa = lob = int(min(ia[seg].min(), ib[seg].min()))
                hia = hib = int(max(ia[seg].max(), ib[seg].max())) + 1
            else:
                loa, hia = int(ia[seg].min()), int(ia[seg].max()) + 1
                lob, hib = int(ib[seg].min()), int(ib[seg].max()) + 1
            ownA = A[loa:hia]
            ownB = ownA if one else Bv[lob:hib]
            res.append((out[seg], fns[key](ownA, ownB, np.asarray(ia[seg]) - loa,
                                           np.asarray(ib[seg]) - lob, E0, E1,
                                           sym=kw.get("sym"))))
        return res

    held = {}
    for key, launches in calls.items():
        worst = 0.0
        for args, kw in launches:
            out, again = fns[key](*args, **kw), fns[key](*args, **kw)
            torch.cuda.synchronize()
            assert torch.equal(out, again), f"{label} {key}: two batched launches differ"
            for b, (mine, own) in enumerate(pairs_of(key, args, kw, out)):
                assert torch.equal(mine, own), \
                    f"{label} {key}: pair {b} differs from its own launch"
            if key == "K3":
                W, G = args
                diff = float((out - moments.moments_plain(W, G)).abs().max())
                scale = float((W.abs() @ G.abs()).max())
                err, tol = diff / scale, 1e-13
            elif key == "K1":
                c64 = args[0].dtype == torch.complex64
                err, tol = rel_err(out, greek.corr_pairs_plain(*args[:6])), 1e-5 if c64 else 1e-11
            else:
                c64 = args[0].dtype == torch.complex64
                ref = fdiff.fdiff_model_plain(*args)
                err = float((out - ref).abs().max() / (args[0][:, 0] - ref).abs().max())
                tol = 1e-5 if c64 else 1e-12
            assert err <= tol, f"{label} {key}: {err:.3e} from its twin (bound {tol:g})"
            worst = max(worst, err)
            del out, again
        held[key] = [len(launches), worst]
    del calls
    held.update({k: v for k, v in inline.items() if v[0]})
    torch.cuda.empty_cache()
    return held


def _pair_share(t, b: int, B: int):
    """Pair b's operand of a batched launch: t[b] where t carries the
    batch's leading pair axis (B > 1), else t itself (a shared table)."""
    return t[b] if t is not None and B > 1 and t.dim() >= 3 and t.shape[0] == B else t


def _k7_pair_share(P, plan, sd, b: int, B: int):
    """K7's operands for pair b of a batched epilogue (products of every
    pair's rows): the pair's rows of each slab, laid out as its own
    product would be (``exact_fft._sliced_products``: shallow (nd, groups,
    rows, ncols), deep (nd, slabs x rows, ncols); at least 17 rows)."""
    import torch

    rows = int(np.prod(plan.lead, dtype=np.int64))
    r1 = rows // B
    nd = P.shape[0]
    nslab = P.shape[1] if P.dim() == 4 else P[0].numel() // plan.slab_stride
    S = P.as_strided((nd, nslab, rows, plan.ncols),
                     (P.stride(0), plan.slab_stride, plan.ncols, 1))[:, :, b * r1:(b + 1) * r1]
    if P.dim() == 4:
        Pb = torch.zeros((nd, nslab, max(r1, 17), plan.ncols), dtype=P.dtype, device=P.device)
        Pb[:, :, :r1] = S
        stride = max(r1, 17) * plan.ncols
    else:
        Pb = torch.zeros((nd, max(nslab * r1, 17), plan.ncols), dtype=P.dtype, device=P.device)
        Pb[:, :nslab * r1] = S.reshape(nd, nslab * r1, plan.ncols)
        stride = r1 * plan.ncols
    sdb = [s[b:b + 1].contiguous() if s.dim() else s for s in sd]
    return Pb, plan._replace(lead=(1,) + tuple(plan.lead[1:]), slab_stride=stride), sdb


@contextlib.contextmanager
def exact_twins_inline(label):
    """While the block runs, hold every K4, K5, K7, K6a, K6m and K6p launch
    as it runs (their operands are too large to keep for the whole step):
    the launch again (bit-equal), its plain twin bit for bit, and, for a
    launch over a batch of B pairs, each pair's share bit for bit the
    kernel on that pair's own operands (K4 with its own global scale; K5
    runs in each pair's own solve). Yields {kernel: [launches held, 0.0]}
    (the twins are bit-exact)."""
    import torch
    from sfft_tpu_torch.core import exact_fft, pairs, slicing, solve

    held = {k: [0, 0.0] for k in ("slice_pair", "slice_triple", "sliced_epilogue",
                                  "pair_products", "pair_model", "pair_poly")}
    launch4, epi7 = slicing._launch_pairs, exact_fft.sliced_epilogue
    rows5, vec5 = solve.slice_rows_f64, solve.slice_vec_f64
    k6 = {n: getattr(pairs, n) for n in ("pair_products", "pair_model", "pair_poly_sub",
                                         "pair_poly_add64")}

    def eq(a, b):
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(eq(x, y) for x, y in zip(a, b))
        return (a is None and b is None) or (a is not None and b is not None
                                            and a.shape == b.shape and torch.equal(a, b))

    def k4(parts, nsl, Kp, rowwise, scales=None, batch=0):
        got = launch4(parts, nsl, Kp, rowwise, scales, batch)
        assert eq(got, launch4(parts, nsl, Kp, rowwise, scales, batch)), \
            f"{label} K4: two launches differ"
        assert eq(got, slicing.slice_pairs_plain(parts, nsl, Kp, rowwise, scales, batch)), \
            f"{label} K4: differs from its twin"
        B = parts[0][0].shape[0]
        if scales is None and B > 1 and (rowwise or batch > 1):
            for b in range(B):
                own = launch4([(h[b], lo[b]) for h, lo in parts], nsl, Kp, rowwise)
                for (sl, sc), (osl, osc) in zip(got, own):
                    assert torch.equal(sl[:, b], osl) and torch.equal(
                        sc[b], osc.expand_as(sc[b])), f"{label} K4: pair {b} differs"
        held["slice_pair"][0] += 1
        return got

    def k5_rows(A, d, nsl, out_cols=None):
        got = rows5(A, d, nsl, out_cols)
        assert eq(got, rows5(A, d, nsl, out_cols)), f"{label} K5: two launches differ"
        assert eq(got, slicing.slice_rows_f64_plain(A, d, nsl, out_cols)), \
            f"{label} K5: differs from its twin"
        held["slice_triple"][0] += 1
        return got

    def k5_vec(x, nsl, out):
        want, again = out.clone(), out.clone()
        got = vec5(x, nsl, out)
        assert eq(got, vec5(x, nsl, again)) and eq(out, again), \
            f"{label} K5 (vector): two launches differ"
        assert eq(got, slicing.slice_vec_f64_plain(x, nsl, want)) and eq(out, want), \
            f"{label} K5 (vector): differs from its twin"
        held["slice_triple"][0] += 1
        return got

    def k7(P, plan, sd):
        got = epi7(P, plan, sd)
        assert eq(got, epi7(P, plan, sd)), f"{label} K7: two launches differ"
        assert eq(got, exact_fft.sliced_epilogue_plain(P, plan, sd)), \
            f"{label} K7: differs from its twin"
        B = plan.lead[0]
        if B > 1:
            for b in range(B):
                own = epi7(*_k7_pair_share(P, plan, sd, b, B))
                assert eq([None if g is None else g[b] for g in got],
                          [None if o is None else o[0] for o in own]), \
                    f"{label} K7: pair {b} differs"
        held["sliced_epilogue"][0] += 1
        return got

    def k6_wrap(name):
        real = k6[name]
        twin = getattr(pairs, K6_TWINS[name])
        key = name if name in held else "pair_poly"

        def run(*args):
            got = real(*args)
            assert k6_equal(got, real(*args)), f"{label} {name}: two launches differ"
            assert k6_equal(got, twin(*args)), f"{label} {name}: differs from its twin"
            out0 = got if isinstance(got, torch.Tensor) else got[0]
            B = out0.shape[0] if out0.dim() >= 3 else 1
            if B > 1:
                for b in range(B):
                    mine = (got[b] if isinstance(got, torch.Tensor)
                            else type(got)(*(None if v is None else v[b] for v in got)))
                    if name == "pair_model":   # sp, K, c, a00: the pair's own
                        sp, K, c, a00 = args[:4]
                        own = real(pairs._plane(sp, b), pairs._plane(K, b), c[b],
                                   None if a00 is None else a00[b], *args[4:])
                    else:
                        own = real(*(type(a)(*(_pair_share(v, b, B) for v in a))
                                     if isinstance(a, pairs.CPair) else
                                     _pair_share(a, b, B) if isinstance(a, torch.Tensor)
                                     else a for a in args))
                    assert k6_equal(mine, own), f"{label} {name}: pair {b} differs"
            held[key][0] += 1
            return got

        return run

    slicing._launch_pairs, exact_fft.sliced_epilogue = k4, k7
    solve.slice_rows_f64, solve.slice_vec_f64 = k5_rows, k5_vec
    for n in k6:
        setattr(pairs, n, k6_wrap(n))
    try:
        yield held
    finally:
        slicing._launch_pairs, exact_fft.sliced_epilogue = launch4, epi7
        solve.slice_rows_f64, solve.slice_vec_f64 = rows5, vec5
        for n, fn in k6.items():
            setattr(pairs, n, fn)


def phase_batched(heavy: bool = False):
    """Phase 14: the batched steps of BATCH_TRIOS on one card: fast and
    default at 4096^2 (KerHW 8, poly2 / poly2) for B = 1, 2, 4, 8 pairs, the
    contract trio (pexact / pexact / transformed) for B = 1, 2, 4, the
    polynomial exact trio at 4096^2 and the NIRCam configuration's default
    trio (fft / fft / lu, B-spline) for B = 1, 2, its v2 fast trio (fft32 /
    fft32 / refined) for B = 1, 2, 4 and its v2 contract (exact / exact /
    exact, the K5 solve once a pair) for B = 1, 2 (`heavy`, the --batched
    run: both v2 trios for B = 1, 2, 4, 8); each size as far as
    ``max_batch`` allows (the sizes left out are logged): each pair's
    solution and difference bit for bit its single call; per-pair wall
    (median of 3 after a warm-up) and device busy (a warmed profile) of the
    batched step on stacks already on the card, launches a step (one set
    of the config's launches whatever B, K5 once a pair) and peak memory;
    the same batches through batched_subtract from host stacks; every K3,
    K1 and K2 launch of one batched step held to its twin and to its
    per-pair launches (``batched_twins``), and every K4, K5, K7, K6a, K6m
    and K6p launch of the contract and exact trios' (``exact_twins_inline``);
    one pair of the contract and exact trios held to the f64 fft tables
    solved by 'exact' (phase 6's bound; 1e-5 for the unpeeled exact trio,
    whose own tables' floor sfft_tpu measured at 5.7e-6 there), one v2
    contract pair to the f64 fft / fft / lu path of its configuration
    (phase 7's bound). Returns
    (report, launches of the timed steps)."""
    import torch
    from sfft_tpu_torch import make_config
    from sfft_tpu_torch.core.engine import solve_and_subtract_batched_fn, solve_and_subtract_fn
    from sfft_tpu_torch.parallel import batch as pbatch
    from sfft_tpu_torch.parallel.batch import batched_subtract

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    sizes_of = dict(BATCH_SIZES_OF, **(BATCH_SIZES_HEAVY if heavy else {}))
    # the pairs of each image size, on the host and on the card
    stacks = {}
    for image in ("N", "V2"):
        n = N if image == "N" else V2_N
        nmax = max(max(sizes_of.get(name, BATCH_SIZES)) for name, (im, _) in BATCH_TRIOS.items()
                   if im == image)
        nmax = max(nmax, 3)
        host = [make_pair(n, BATCH_SEED + k) for k in range(nmax)]
        Ih, Jh = (np.stack([p[r] for p in host]) for r in range(2))
        del host
        stacks[image] = (Ih, Jh) + tuple(torch.as_tensor(a, device=dev) for a in (Ih, Jh))
        log(f"phase 14 {nmax} pairs {n}^2 made and uploaded in "
            f"{time.perf_counter() - t_start:.1f} s")
    report, launches = {}, {}
    for name, (image, _) in BATCH_TRIOS.items():
        t_trio = time.perf_counter()
        Ih, Jh, I, J = stacks[image]
        n = I.shape[-1]
        cfg = batch_cfg(name)
        step = solve_and_subtract_batched_fn(cfg)
        single = solve_and_subtract_fn(cfg)
        # the exact engines share their spectra where the masked stacks are
        # the unmasked ones: one stack object a role pair
        shares = cfg.greek_backend in ("pexact", "exact")
        # the sizes this card's memory takes (max_batch), before any step
        torch.cuda.empty_cache()
        cap = pbatch.max_batch(cfg, dev)
        wanted = sizes_of.get(name, BATCH_SIZES)
        sizes = [B for B in wanted if B <= cap]
        log(f"phase 14 {name}: max_batch {cap} pairs at {n}^2 on this card; B run {sizes}"
            + (f"; left out (beyond max_batch) {[B for B in wanted if B > cap]}"
               if len(sizes) < len(wanted) else ""))
        # each single call with the masked planes the unmasked ones (one
        # object a role, as PCP and BSP pass them: the exact engines share
        # their spectra then); the launches of each pair's single step
        ones, single_counts = [], []
        for k in range(max(max(sizes), 3)):
            Ik, Jk = I[k], J[k]
            zero_kernel_counts()
            s1, d1 = single(Ik, Jk, Ik, Jk)
            torch.cuda.synchronize()
            single_counts.append(kernel_counts())
            ones.append((s1.cpu(), d1.cpu()))
        rows = {}
        for B in sizes:
            Ib, Jb = I[:B], J[:B]
            run = lambda: step(Ib, Jb, Ib, Jb)   # noqa: E731
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            sol, diff = run()
            torch.cuda.synchronize()
            for k in range(B):
                assert torch.equal(sol[k].cpu(), ones[k][0]), \
                    f"phase 14 {name} B={B}: pair {k}'s solution differs from its single call"
                assert torch.equal(diff[k].cpu(), ones[k][1]), \
                    f"phase 14 {name} B={B}: pair {k}'s difference differs from its single call"
            del sol, diff
            zero_kernel_counts()
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                del out
            counts = kernel_counts()
            peak = torch.cuda.max_memory_allocated()
            busy, nk = device_busy(run)
            torch.cuda.empty_cache()
            hw = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hI, hJ = Ih[:B], Jh[:B]
                out = batched_subtract(hI, hJ, *((hI, hJ) if shares else (Ih[:B], Jh[:B])),
                                       cfg, devices=[dev])
                torch.cuda.synchronize()
                hw.append(time.perf_counter() - t0)
                for k in range(B):
                    assert torch.equal(out[0][k].cpu(), ones[k][0]) and \
                        torch.equal(out[1][k].cpu(), ones[k][1]), \
                        f"phase 14 {name} B={B}: batched_subtract pair {k} differs"
                del out
            per = {k: v / 3 for k, v in counts.items() if v}
            if name in BATCH_LAUNCHES:
                want = BATCH_LAUNCHES[name]
            else:
                # the single step's launches (the last single: static tables
                # built), K5 once for each pair's solve
                want = {k: v for k, v in single_counts[-1].items() if v and k != "slice_triple"}
                k5 = sum(c["slice_triple"] for c in single_counts[:B])
                if k5:
                    want["slice_triple"] = k5
            if dev.type == "cuda":
                assert per == want, f"phase 14 {name} B={B}: launches a step {per}, not {want}"
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            rows[B] = dict(wall_ms_per_pair=statistics.median(walls) * 1e3 / B,
                           busy_ms_per_pair=busy * 1e3 / B, device_events=nk,
                           launches_per_step=per, peak_bytes=peak,
                           host_stacks_ms_per_pair=min(hw) * 1e3 / B)
            log(f"phase 14 {name} B={B}: each pair bit for bit its single call (solution, "
                f"difference; device stacks and batched_subtract from host stacks); per pair "
                f"wall {rows[B]['wall_ms_per_pair']:.2f} ms (median of 3; walls "
                f"{[round(w * 1e3, 1) for w in walls]} ms), busy "
                f"{rows[B]['busy_ms_per_pair']:.2f} ms ({nk} kernels and copies a step), "
                f"host stacks {rows[B]['host_stacks_ms_per_pair']:.2f} ms; launches a step "
                f"{per}; peak {peak / 2**30:.2f} GiB ({peak / 2**30 / B:.2f} GiB a pair)")
        # the survey paths' groups are one pair a device: the single step,
        # which is the batched step of one pair, against that batched step
        # called directly, in alternating order
        t_one, t_b1 = [], []
        I0, J0, I1, J1 = I[0], J[0], I[:1], J[:1]
        for k in range(6):
            for which in ((0, 1) if k % 2 == 0 else (1, 0)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = (single(I0, J0, I0, J0) if which == 0 else step(I1, J1, I1, J1))
                torch.cuda.synchronize()
                (t_one if which == 0 else t_b1).append(time.perf_counter() - t0)
                del out
        one_ms, b1_ms = (statistics.median(t) * 1e3 for t in (t_one, t_b1))
        log(f"phase 14 {name}: single step {one_ms:.2f} ms, batched step of one pair "
            f"{b1_ms:.2f} ms (medians of 6, alternating; walls "
            f"{[round(t * 1e3, 1) for t in t_one]} / {[round(t * 1e3, 1) for t in t_b1]} ms)")
        vs64 = None
        if name in ("contract", "exact", "v2-contract"):
            # the contract's bound 1e-6; the unpeeled exact trio at 4096^2
            # sits at its own tables' pair-representation floor, amplified
            # by the poly2 system (sfft_tpu measured 5.7e-6 / 2.5e-6 there,
            # DESIGN.md): held to 1e-5
            bound = 1e-5 if name == "exact" else 1e-6
            if image == "V2":
                # phase 7's bound: the f64 fft / fft / lu path of the
                # configuration
                cfg64, what = nircam_config(), "the f64 fft / fft / lu path"
            else:
                # phase 6's bound: the f64 fft tables solved by 'exact'
                cfg64 = make_config(N, N, KERHW, greek_backend="fft", fdiff_backend="fft",
                                    solver="exact")
                what = "the f64 fft tables solved by 'exact'"
            s64, d64 = (t.cpu() for t in solve_and_subtract_fn(cfg64)(I0, J0, I0, J0))
            drms = float(torch.sqrt(torch.mean((ones[0][1] - d64) ** 2)))
            srel = float((ones[0][0] - s64).abs().max() / s64.abs().max())
            assert drms < bound and srel <= bound, \
                f"phase 14 {name}: RMS(diff - diff_f64) {drms:.3e}, solution {srel:.3e} of max"
            log(f"phase 14 {name} pair 0: RMS(diff - diff_f64) = {drms:.3e} (bound {bound:g}), "
                f"max|sol - sol_f64|/max|sol_f64| = {srel:.3e} (bound {bound:g}; {what})")
            vs64 = dict(rms=drms, sol_rel=srel)
            del s64, d64
        # a batch beyond a lowered bound split into steps, bit for bit
        real_cap = pbatch.max_batch
        pbatch.max_batch = lambda cfg, device: 2
        try:
            steps0 = solve_and_subtract_batched_fn.steps
            I3, J3 = I[:3], J[:3]
            out = batched_subtract(I3, J3, I3, J3, cfg, devices=[dev])
            nsteps = solve_and_subtract_batched_fn.steps - steps0
        finally:
            pbatch.max_batch = real_cap
        assert nsteps == 2, f"phase 14 {name}: 3 pairs at a bound of 2 took {nsteps} steps"
        for k in range(3):
            assert torch.equal(out[0][k].cpu(), ones[k][0]) and \
                torch.equal(out[1][k].cpu(), ones[k][1]), \
                f"phase 14 {name}: pair {k} of the split batch differs from its single call"
        del out
        log(f"phase 14 {name}: 3 pairs at a bound of 2 ran as {nsteps} batched steps, each pair "
            f"bit for bit its single call")
        twin_b = BATCH_TWIN_B[name]
        It, Jt = I[:twin_b], J[:twin_b]
        held = batched_twins(lambda: step(It, Jt, It, Jt),
                             f"phase 14 {name} B={twin_b}")
        log(f"phase 14 {name} B={twin_b}: every kernel launch of the batched step held to its "
            f"twin (K4, K5, K7, K6 bit for bit) and each pair's share bit for bit its own "
            f"launch, two launches bit-equal: {held}")
        report[name] = dict(rows=rows, twins=held, twin_batch=twin_b, single_ms=one_ms,
                            batched_one_ms=b1_ms, max_batch=cap, sizes=sizes,
                            s=time.perf_counter() - t_trio)
        if vs64 is not None:
            report[name]["vs_f64"] = vs64
        log(f"phase 14 {name} done in {report[name]['s']:.1f} s")
        torch.cuda.empty_cache()
    del stacks, I, J
    torch.cuda.empty_cache()
    report["s"] = time.perf_counter() - t_start
    log(f"phase 14 done in {report['s']:.1f} s; launches {launches}")
    return report, launches


USAGE = ("usage: chip_smoke.py [--profile OUT_DIR | --steady PAIRS | --kernels OUT_DIR | "
         "--fidelity | --easy | --survey | --sharded | --direct | --batched | "
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
            phase_k1_v2()
            phase_k2()
            phase_k7()
            phase_k6()
            phase_kernel_profile(sys.argv[2])
        else:
            rng = np.random.default_rng(6)
            phase_stage_checks(rng)
            phase_k5(rng)
        log(smi)
        print(ok_line, flush=True)
        return 0
    if sys.argv[1:] == ["--fidelity"]:
        phase_fidelity(*(torch.as_tensor(a, device="cuda") for a in make_pair(N)))
        log(smi)
        print(ok_line, flush=True)
        return 0
    if sys.argv[1:] == ["--batched"]:
        batched, counts = phase_batched(heavy=True)
        log(json.dumps({"batched": batched, "batched_launches": counts}))
        log(json.dumps({"batched_kernels": [dict(name=name, route="cuda", source=source,
                                                 replaces=replaces, launches=counts.get(name, 0))
                                            for name, source, replaces in BATCHED_KERNELS]}))
        log(smi)
        print(ok_line, flush=True)
        return 0
    if sys.argv[1:] == ["--direct"]:
        direct, line, counts = phase_direct()
        log(json.dumps({"direct": direct, "direct_launches": counts}))
        log(json.dumps({"kernels": [dict(name=name, route="cuda", source=source, replaces=replaces,
                                         launches=counts[name], **line[name])
                                    for name, source, replaces in DIRECT_KERNELS]}))
        log(smi)
        print(ok_line, flush=True)
        return 0
    if sys.argv[1:] in (["--easy"], ["--survey"], ["--sharded"]):
        with tempfile.TemporaryDirectory() as d:
            if sys.argv[1] == "--easy":
                phase_easy(d)
            elif sys.argv[1] == "--sharded":
                sharded, counts = phase_sharded(d)
                log(json.dumps({"sharded": sharded, "sharded_launches": counts}))
            else:
                _, counts = phase_survey(d, torch.device("cuda"), heavy=True)
                log(json.dumps({"survey_launches": counts}))
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
    t_start = time.perf_counter()
    report = phase_kernels()
    log(f"phases 2-3 done at {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    I, J = make_pair(N)
    dev = torch.device("cuda")
    I = torch.as_tensor(I, device=dev)
    J = torch.as_tensor(J, device=dev)
    log(f"phase 4 pair {N}^2 made and uploaded in {time.perf_counter() - t0:.1f} s")
    sol_fast, diff_fast, diff_k2twin, launches, step_s, plain_s, on_path = phase_slice(I, J)
    fast_ref = (sol_fast.cpu().numpy(), diff_fast.cpu().numpy())  # phase 11's server check
    del sol_fast
    sol64, diff64, rms64, rms64_twin = phase_f64(I, J, diff_fast, diff_k2twin)
    del diff_fast, diff_k2twin
    c_launches, c_step_s, c_plain_s, c_peak, c_drms, c_srel, c_on_path, c_prof = \
        phase_contract(I, J, sol64, diff64)
    report["slice_pair"] = c_on_path["slice_pair"]
    del I, J, sol64, diff64
    torch.cuda.empty_cache()
    log(f"phases 4-6 done at {time.perf_counter() - t_start:.1f} s")
    v2 = phase_v2()
    log(f"phase 7 done at {time.perf_counter() - t_start:.1f} s")
    report["slice_triple"] = v2["slicers"]["slice_triple"]
    v2_k4 = v2["slicers"]["slice_pair"]
    # K7: summed over a steady contract step's launches and a steady v2 step's
    c7, v7 = c_on_path["sliced_epilogue"], v2["slicers"]["sliced_epilogue"]
    report["sliced_epilogue"] = dict(
        {k: c7[k] + v7[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")},
        library_ms=None,
        bound_by=c7["bound_by"] if c7["bound_by"] == v7["bound_by"] else "bytes")
    # K6: summed over a steady contract step's launches and a steady v2
    # step's, each kernel over its modes (K6p runs on the contract path
    # alone: its sub and add64 modes also on their own); the yardsticks
    # summed where every launch has one
    def k6_sum(parts):
        lib = [r["library_ms"] for r in parts]
        return dict(
            {k: sum(r[k] for r in parts) for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")},
            library_ms=None if None in lib else sum(lib),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in parts) else "operations")

    for kernel, names in K6_KERNELS.items():
        report[kernel] = k6_sum([r[name] for r in (c_on_path, v2["slicers"]) for name in names
                                 if name in r])
    for name in ("pair_poly_sub", "pair_poly_add64"):
        report[name] = k6_sum([c_on_path[name]])
    k6_steps = {name: {path: r[name] for path, r in (("contract", c_on_path),
                                                       ("v2", v2["slicers"])) if name in r}
                for name in K6_TWINS}
    torch.cuda.empty_cache()
    fast = phase_v2_fast(v2["lam"], v2["ydiff"])
    pw = fast["v2-fast-peeled"]
    log(f"phase 8 done at {time.perf_counter() - t_start:.1f} s")
    post = phase_post(pw["sol"], pw["diff"], pw["cfg"])
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        easy = phase_easy(d)
        log(f"phase 10 done at {time.perf_counter() - t_start:.1f} s")
        single = easy["sparse"].pop("single")
        easy["crowded"].pop("single")
        survey, survey_launches = phase_survey(d, torch.device("cuda"), single=single,
                                               fast_ref=fast_ref)
        del single, fast_ref
        log(f"phase 11 done at {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        sharded, sharded_launches = phase_sharded(d)
    log(f"phase 12 done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    direct, direct_line, direct_launches = phase_direct(v2["lam"])
    report.update(direct_line)
    log(f"phase 13 done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    batched, batched_launches = phase_batched()
    log(f"phase 14 done at {time.perf_counter() - t_start:.1f} s")
    assert not any(m == "jax" or m.startswith("jax.") or m == "sfft_tpu"
                   or m.startswith("sfft_tpu.") for m in sys.modules), "jax or sfft_tpu imported"

    kernels = []
    for name, source, replaces in [
        ("moments", "sfft_tpu_torch/csrc/moments.cu", "sfft_tpu/core/pallas_moments.py:143"),
        ("corr_window", "sfft_tpu_torch/csrc/corr_window.cuh", "sfft_tpu/core/greek.py:94"),
        ("slice_pair", "sfft_tpu_torch/csrc/slice_pair.cu", "sfft_tpu/core/pallas_slice.py:135"),
        ("slice_triple", "sfft_tpu_torch/csrc/slice_triple.cu",
         "sfft_tpu/core/pallas_slice.py:214"),
        ("fdiff_model", "sfft_tpu_torch/csrc/fdiff_model.cu", "sfft_tpu/core/fdiff.py:90"),
        ("sliced_epilogue", "sfft_tpu_torch/csrc/sliced_epilogue.cu",
         "sfft_tpu/core/exact_fft.py:372"),
        ("pair_products", "sfft_tpu_torch/csrc/pair_products.cu",
         "sfft_tpu/core/exact_fft.py:963"),
        ("pair_model", "sfft_tpu_torch/csrc/pair_model.cu", "sfft_tpu/core/pexact.py:397"),
        ("pair_poly", "sfft_tpu_torch/csrc/pair_poly.cu", "sfft_tpu/core/pexact.py:71"),
        ("pair_poly_sub", "sfft_tpu_torch/csrc/pair_poly.cu", "sfft_tpu/core/pexact.py:185"),
        ("pair_poly_add64", "sfft_tpu_torch/csrc/pair_poly.cu", "sfft_tpu/core/pexact.py:488"),
    ] + DIRECT_KERNELS:
        # launches: the sum over the main paths' runs (fast, contract, v2,
        # the two v2 fast modes, the automatic packets' runs with the
        # kernels, phase 11's survey entry points and phase 12's sharded
        # runs and reference batch); times: K3, K1 and
        # K2 alone at the fast slice's shapes, K4 summed over a steady
        # contract step's launches, K5 over a steady v2 step's, K7 and K6
        # over both
        r = report[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=(launches.get(name, 0) + c_launches.get(name, 0)
                                      + v2["launches"].get(name, 0)
                                      + fast["v2-fast-fft32"]["launches"].get(name, 0)
                                      + fast["v2-fast-peeled"]["launches"].get(name, 0)
                                      + sum(easy[p]["launches"][t].get(name, 0)
                                            for p in ("sparse", "crowded")
                                            for t in ("default", "contract",
                                                      "fft/fft/exact"))
                                      + survey_launches.get(name, 0)
                                      + sharded_launches.get(name, 0)
                                      + direct_launches.get(name, 0)
                                      + batched_launches.get(name, 0)),
                            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    log(json.dumps({"slice_step_ms": step_s * 1e3, "slice_step_plain_ms": plain_s * 1e3,
                    "fast_vs_f64_rms": rms64, "fast_k2_twin_vs_f64_rms": rms64_twin,
                    "slice_launches_per_step": {k: v / 4 for k, v in launches.items()},
                    "v2_fast": {m: {k: v for k, v in fast[m].items()
                                    if k not in ("cfg", "sol", "diff", "launches")}
                                | {"launches_per_step": {k: v / 4 for k, v in
                                                         fast[m]["launches"].items()}}
                                for m in ("v2-fast-fft32", "v2-fast-peeled")},
                    "fast_on_path": on_path, "k1_v2": report["k1_v2"],
                    "k2_calls": report["fdiff_model"]["calls"], "post": post,
                    "contract_step_ms": c_step_s * 1e3,
                    "contract_step_plain_ms": c_plain_s * 1e3,
                    "contract_peak_bytes": c_peak, "contract_vs_f64_rms": c_drms,
                    "contract_vs_f64_sol_rel": c_srel,
                    "contract_launches_per_step": {k: v / 4 for k, v in c_launches.items()},
                    "contract_step_profile": c_prof, "v2_step_profile": v2["prof"],
                    "k7_per_step": {"contract": c7, "v2": v7},
                    "k6_per_step": k6_steps, "k6_alone": report["k6_alone"],
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
                                 for k in ("omg", "the", "omg_general", "c128_omg", "isa")},
                    "k3_eager_ms": {k: report["moments"][k]
                                    for k in ("eager_ms", "library_eager_ms")},
                    "easy": {p: ({k: v for k, v in e.items() if k not in ("on_path", "slicers")}
                                 if p != "golden_contract" else e) for p, e in easy.items()},
                    "survey": survey, "sharded": sharded, "direct": direct,
                    "batched": batched, "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(ok_line, flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_children()
    sys.exit(code)
