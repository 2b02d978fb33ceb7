"""Times sfft_tpu_torch's single solve+subtract step
(core/engine.solve_and_subtract_fn) on the card, for the fast mode
(peeled / fft32 / refined), the default trio (fft / fft / lu), the
contract trio (pexact / pexact / transformed) and the polynomial exact trio
(exact / exact / exact) at 4096^2, KerHW 8, poly2 / poly2, and for the v2
contract (exact / exact / exact) and the v2 fast trio (fft32 / fft32 /
refined) on the NIRCam configuration at 900^2 (chip_smoke.nircam_config),
on chip_smoke.py's benchmark pairs (seed 40), with the masked pair the
unmasked one, as the survey paths' groups of one pair a device run it.
Each checkout named on the command line runs in a process of its own, in
the order given, so that two commits are compared on one card in one call
(give them as parent, change, change, parent, ...):

    python3 tools/single_step_timing.py [--only NAME,...] [--reps N]
                                        [--stages] [--calls] ROOT [ROOT ...]

Each process builds the checkout's kernels (or finds them built), warms each
config with 3 steps and times N (default 12; wall, synchronized), then
prints one JSON line: {"root": ..., "fast": {"median_ms": ..., "ms": [...],
"sha256": ...}, "default": ..., "contract": ..., "exact": ...,
"v2-contract": ..., "v2-fast-fft32": ...} (only the configs named by
--only, when given); sha256 is the digest of the last step's solution and
difference bytes, so that equal digests across checkouts show the same
bits. --stages adds "stages_ms": the medians of the step's parts, each
timed between synchronizations (the exact plane spectra, the tables and
assembly, the solve, the difference; the synchronizations lengthen the
step, so these sum to more than its wall). --calls adds "calls_per_step"
and "profiled_ms": the Python function calls of one step and its wall
under cProfile, the mean of 3 steps, a count of the host's work that the
host's varying speed does not move.
The card's name and power limit are printed first. Needs a CUDA card.
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

N, KERHW, SEED, WARM = 4096, 8, 40, 3
EXACT = dict(greek_backend="exact", fdiff_backend="exact", solver="exact")
# name: (image, backends); image "N" is N^2 (KerHW 8, poly2 / poly2), "V2"
# the NIRCam configuration
TRIOS = {"fast": ("N", dict(greek_backend="peeled", fdiff_backend="fft32", solver="refined")),
         "default": ("N", dict(greek_backend="fft", fdiff_backend="fft", solver="lu")),
         "contract": ("N", dict(greek_backend="pexact", fdiff_backend="pexact",
                                solver="transformed")),
         "exact": ("N", EXACT),
         "v2-contract": ("V2", EXACT),
         "v2-fast-fft32": ("V2", dict(greek_backend="fft32", fdiff_backend="fft32",
                                      solver="refined"))}


def _stage_timers(acc: dict):
    """Wraps the single step's parts (by the names both the batched and the
    unbatched step call them through) with synchronized timers that append
    to acc[part]; returns the function that puts the parts back."""
    import torch
    from sfft_tpu_torch.core import engine, greek

    parts = ((greek, "exact_plane_spectra", "spectra"),
             (engine, "_normal_equations_impl", "tables+assembly"),
             (engine, "solve_system", "solve"), (engine, "_subtract_impl", "difference"))
    real = [getattr(mod, name) for mod, name, _ in parts]

    def timed(fn, key):
        def f(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            acc.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
            return out

        return f

    for (mod, name, key), fn in zip(parts, real):
        setattr(mod, name, timed(fn, key))

    def restore():
        for (mod, name, _), fn in zip(parts, real):
            setattr(mod, name, fn)

    return restore


def run_one(root: str, only, reps: int, stages: bool, calls: bool) -> dict:
    """The timings of the checkout at `root` (in this process)."""
    sys.path.insert(0, root)
    import cProfile
    import pstats

    import torch
    from chip_smoke import V2_N, make_pair, nircam_config
    from sfft_tpu_torch import make_config
    from sfft_tpu_torch.core.engine import solve_and_subtract_fn

    dev = torch.device("cuda")
    names = [n for n in TRIOS if not only or n in only]
    images = {TRIOS[n][0] for n in names}
    pairs = {image: tuple(torch.as_tensor(a, device=dev) for a in make_pair(n, SEED))
             for image, n in (("N", N), ("V2", V2_N)) if image in images}
    out = {"root": root}
    for name in names:
        image, trio = TRIOS[name]
        cfg = nircam_config(**trio) if image == "V2" else make_config(N, N, KERHW, **trio)
        step = solve_and_subtract_fn(cfg)
        I, J = pairs[image]
        walls = []
        for k in range(WARM + reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = step(I, J, I, J)
            torch.cuda.synchronize()
            if k >= WARM:
                walls.append((time.perf_counter() - t0) * 1e3)
            if k < WARM + reps - 1:
                del res
        digest = hashlib.sha256()
        for t in res:
            digest.update(t.detach().cpu().contiguous().numpy().tobytes())
        del res
        out[name] = dict(median_ms=statistics.median(walls), ms=[round(w, 2) for w in walls],
                         sha256=digest.hexdigest()[:16])
        if calls:
            prof = cProfile.Profile()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prof.enable()
            for _ in range(3):
                res = step(I, J, I, J)
                del res
            torch.cuda.synchronize()
            prof.disable()
            out[name]["profiled_ms"] = round((time.perf_counter() - t0) * 1e3 / 3, 2)
            out[name]["calls_per_step"] = pstats.Stats(prof).total_calls / 3
        if stages:
            acc = {}
            restore = _stage_timers(acc)
            for _ in range(WARM + reps):
                res = step(I, J, I, J)
                del res
            restore()
            out[name]["stages_ms"] = {k: round(statistics.median(v[WARM:]), 2)
                                      for k, v in acc.items()}
        del step
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description="single-step walls of one or more checkouts")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--only", default="", help="comma-separated config names")
    ap.add_argument("--reps", type=int, default=12, help="timed steps a config")
    ap.add_argument("--stages", action="store_true", help="time the step's parts")
    ap.add_argument("--calls", action="store_true", help="count a step's Python calls")
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args()
    only = [n for n in args.only.split(",") if n]
    unknown = [n for n in only if n not in TRIOS]
    if unknown:
        ap.error(f"unknown configs {unknown}; known: {list(TRIOS)}")
    if args.one:
        print(json.dumps(run_one(os.path.abspath(args.roots[0]), only, args.reps, args.stages,
                                 args.calls)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    flags = [f"--only={args.only}", f"--reps={args.reps}"] + \
        ["--stages"] * args.stages + ["--calls"] * args.calls
    rc = 0
    for root in args.roots:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", *flags,
                              root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
