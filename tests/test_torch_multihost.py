"""The multi-host survey layer of sfft_tpu_torch (parallel/multihost.py) on
the CPU.

- The single-process degeneracies of tests/test_parallel.py:321-350: no
  process group, one process's devices, the task slabs (against sfft_tpu's
  assign_tasks), and process_local_batch against batch.batched_subtract
  (rtol 1e-12); a B_local that is not a multiple of the device count raises.
- The 11-task run of tests/test_parallel.py:353 over ["cpu"] * 8: two
  batches, the second padded; every result bit for bit its pair's own step.
- Two real processes joined over gloo on localhost (after
  tests/test_parallel.py:404): 6 tasks, each process on ["cpu", "cpu"],
  each returns only its slab, and the solutions match a single-process run
  within 1e-12. The worker script imports neither jax nor sfft_tpu: it
  carries its own copy of the pair generator.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from sfft_tpu_torch.config import BasisSpec, SFFTConfig
from sfft_tpu_torch.parallel import multihost as mh
from sfft_tpu_torch.parallel.batch import batched_subtract

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_engine.py's make_pair and base_cfg(N0=32, N1=32, w=1), for the
# test and (as source) for the worker processes
PAIR_SOURCE = '''
def make_pair(rng, N0=32, N1=32, nsrc=12):
    yy, xx = np.meshgrid(np.arange(N1), np.arange(N0))
    I = 10.0 + 0.01 * xx + 0.02 * yy
    for _ in range(nsrc):
        x0, y0 = rng.uniform(2, N0 - 2), rng.uniform(2, N1 - 2)
        amp = rng.uniform(50, 300)
        sig = rng.uniform(0.8, 1.6)
        I = I + amp * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * sig**2))
    J = I * 1.12 + 3.0
    J = J + rng.normal(0, 0.8, size=I.shape)
    I = I + rng.normal(0, 0.5, size=I.shape)
    return I, J


def load_fn(t):
    I, J = make_pair(np.random.default_rng(t))
    return I, J, I, J


CFG = SFFTConfig(N0=32, N1=32, w0=1, w1=1, kernel_basis=BasisSpec("polynomial", 2),
                 bg_basis=BasisSpec("polynomial", 2), const_phot_ratio=True)
'''
exec(PAIR_SOURCE)


@pytest.fixture
def no_launch_env(monkeypatch):
    for k in ("SFFT_COORDINATOR_ADDRESS", "SFFT_NUM_PROCESSES", "SFFT_PROCESS_ID",
              "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)


def test_multihost_single_process(no_launch_env, monkeypatch):
    from sfft_tpu.parallel import multihost as jmh

    assert mh.init_multihost() == 1
    assert mh.MultiHostSpec.from_env().num_processes == 1
    glob = mh.global_data_devices(["cpu", "cpu"])
    assert glob.per_process == (2,) and glob.count == 2
    for pc in (1, 3, 5):
        got = [mh.assign_tasks(11, p, pc) for p in range(pc)]
        np.testing.assert_array_equal(np.sort(np.concatenate(got)), np.arange(11))
        for p in range(pc):
            np.testing.assert_array_equal(got[p], jmh.assign_tasks(11, p, pc))
    np.testing.assert_array_equal(mh.assign_tasks(11), np.arange(11))

    loaded = [load_fn(t) for t in range(8)]
    I = np.stack([p[0] for p in loaded])
    J = np.stack([p[1] for p in loaded])
    sols, diffs, rms = mh.process_local_batch(I, J, I, J, CFG, devices=["cpu", "cpu"])
    sols_ref, diffs_ref, rms_ref = batched_subtract(I, J, I, J, CFG, devices=["cpu", "cpu"])
    np.testing.assert_allclose(sols, sols_ref.numpy(), rtol=1e-12)
    np.testing.assert_allclose(diffs, diffs_ref.numpy(), rtol=1e-12)
    np.testing.assert_allclose(rms, rms_ref.numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="multiple"):
        mh.process_local_batch(I[:3], J[:3], I[:3], J[:3], CFG, devices=["cpu", "cpu"])

    # the launch descriptions it reads
    monkeypatch.setenv("SFFT_COORDINATOR_ADDRESS", "localhost:1234")
    monkeypatch.setenv("SFFT_NUM_PROCESSES", "3")
    monkeypatch.setenv("SFFT_PROCESS_ID", "2")
    assert mh.MultiHostSpec.from_env() == mh.MultiHostSpec("localhost:1234", 3, 2)
    monkeypatch.delenv("SFFT_COORDINATOR_ADDRESS")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "1")
    assert mh.MultiHostSpec.from_env() == mh.MultiHostSpec(None, 4, 1)


def test_multihost_survey_driver(no_launch_env):
    """11 tasks over 8 devices: two batches, the second padded; each
    result is its pair's own step, bit for bit."""
    pairs = list(range(11))
    results = mh.run_survey_multihost(pairs, load_fn, CFG, devices=["cpu"] * 8)
    assert sorted(results) == pairs
    for t in pairs:
        sol, rms = results[t]
        I, J, _, _ = load_fn(t)
        sol_ref, diff_ref, _ = batched_subtract(I[None], J[None], I[None], J[None], CFG,
                                                devices=["cpu"])
        assert sol.shape == (CFG.NEQ,)
        np.testing.assert_array_equal(sol, sol_ref[0].numpy())
        assert rms == float(np.sqrt(np.mean(diff_ref[0].numpy() ** 2)))


def test_multihost_two_real_processes(tmp_path, no_launch_env):
    """Two OS processes, each on ['cpu', 'cpu'], joined over gloo through
    the SFFT_* variables: each returns only its slab, and the solutions
    match the single-process run within 1e-12."""
    worker = tmp_path / "mh_worker.py"
    worker.write_text(textwrap.dedent('''
        import sys
        sys.path.insert(0, sys.argv[1])
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from sfft_tpu_torch.config import BasisSpec, SFFTConfig
        from sfft_tpu_torch.parallel.multihost import _rank, run_survey_multihost
    ''') + PAIR_SOURCE + textwrap.dedent('''
        res = run_survey_multihost(list(range(6)), load_fn, CFG, devices=["cpu", "cpu"],
                                   timeout_s=120)
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "sfft_tpu")]
        assert not bad, bad
        keys = sorted(res)
        np.savez(sys.argv[2], keys=np.array(keys, int),
                 sols=np.stack([res[k][0] for k in keys]),
                 rms=np.array([res[k][1] for k in keys]))
        print("WORKER_OK", _rank(), keys, flush=True)
    '''))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        env = dict(os.environ, SFFT_COORDINATOR_ADDRESS=f"localhost:{port}",
                   SFFT_NUM_PROCESSES="2", SFFT_PROCESS_ID=str(pid))
        env.pop("PYTHONPATH", None)
        procs.append(subprocess.Popen([sys.executable, str(worker), REPO,
                                       str(tmp_path / f"res{pid}.npz")],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
    r0 = np.load(tmp_path / "res0.npz")
    r1 = np.load(tmp_path / "res1.npz")
    np.testing.assert_array_equal(r0["keys"], [0, 1, 2])
    np.testing.assert_array_equal(r1["keys"], [3, 4, 5])
    single = mh.run_survey_multihost(list(range(6)), load_fn, CFG, devices=["cpu", "cpu"])
    for r in (r0, r1):
        for k, sol, rms in zip(r["keys"], r["sols"], r["rms"]):
            np.testing.assert_allclose(sol, single[int(k)][0], rtol=1e-12)
            np.testing.assert_allclose(rms, single[int(k)][1], rtol=1e-12)
