"""Times sfft_tpu_torch's single solve+subtract step
(core/engine.solve_and_subtract_fn) on the card, for the fast mode
(peeled / fft32 / refined), the default trio (fft / fft / lu) and the
contract trio (pexact / pexact / transformed) at 4096^2,
KerHW 8, poly2 / poly2, on chip_smoke.py's benchmark pair (seed 40), with
the masked pair the unmasked one, as the survey paths' groups of one pair a
device run it. Each checkout named on the command line runs in a process
of its own, in the order given, so that two commits are compared on one
card in one call (give them as parent, change, change, parent):

    python3 tools/single_step_timing.py ROOT [ROOT ...]

Each process builds the checkout's kernels (or finds them built), warms each
config with 3 steps and times 12 (wall, synchronized), then prints one JSON
line: {"root": ..., "fast": {"median_ms": ..., "ms": [...], "sha256": ...},
"default": ..., "contract": ...}; sha256 is the digest of the last step's
solution and difference bytes, so that equal digests across checkouts show
the same bits.
The card's name and power limit are printed first. Needs a CUDA card.
"""

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

N, KERHW, SEED, WARM, REPS = 4096, 8, 40, 3, 12
TRIOS = {"fast": dict(greek_backend="peeled", fdiff_backend="fft32", solver="refined"),
         "default": dict(greek_backend="fft", fdiff_backend="fft", solver="lu"),
         "contract": dict(greek_backend="pexact", fdiff_backend="pexact", solver="transformed")}


def run_one(root: str) -> dict:
    """The timings of the checkout at `root` (in this process)."""
    sys.path.insert(0, root)
    import torch
    from chip_smoke import make_pair
    from sfft_tpu_torch import make_config
    from sfft_tpu_torch.core.engine import solve_and_subtract_fn

    dev = torch.device("cuda")
    I, J = (torch.as_tensor(a, device=dev) for a in make_pair(N, SEED))
    out = {"root": root}
    for name, trio in TRIOS.items():
        step = solve_and_subtract_fn(make_config(N, N, KERHW, **trio))
        walls = []
        for k in range(WARM + REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = step(I, J, I, J)
            torch.cuda.synchronize()
            if k >= WARM:
                walls.append((time.perf_counter() - t0) * 1e3)
            if k < WARM + REPS - 1:
                del res
        digest = hashlib.sha256()
        for t in res:
            digest.update(t.detach().cpu().contiguous().numpy().tobytes())
        del res
        out[name] = dict(median_ms=statistics.median(walls), ms=[round(w, 2) for w in walls],
                         sha256=digest.hexdigest()[:16])
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(run_one(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    rc = 0
    for root in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
