"""The resident engine server of sfft_tpu_torch (serve.py): a REAL server
subprocess on the CPU (``--device cpu``), driven through the stdlib + numpy
client (tests/test_serve.py's cases). Every result is held bit for bit to
the port's in-process GeneralSFFT.GSS / ElementalSFFT.ESS on the same
arrays, and the plain subtraction within the bounds of
tests/test_engine.py:56-58 to sfft_tpu's GSS.
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import sfft_tpu  # noqa: F401  (x64)
from sfft_tpu.core.engine import GeneralSFFT as JGSFFT

from sfft_tpu_torch.core.engine import ElementalSFFT, GeneralSFFT
from sfft_tpu_torch.serve import EngineClient, EngineServerError, _ping_path, ensure_server

from test_torch_engine import REPO, cfgs, make_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def server_socket(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "engine.sock")
    # a lean CPU server: two threads, as every port test module
    env = dict(os.environ, OMP_NUM_THREADS="2")
    resp = ensure_server(path, spawn_timeout=180.0, env=env, device="cpu")
    assert resp["ok"] and resp["platform"] == "cpu"
    yield path
    with EngineClient(path) as c:
        c.shutdown()
    deadline = time.time() + 30
    while os.path.exists(path) and time.time() < deadline:
        time.sleep(0.1)
    assert not os.path.exists(path), "server did not unlink its socket"


def _equal(a, b):
    return np.array_equal(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b)


def test_subtract_matches_inprocess_and_reference(server_socket):
    I, J = make_pair(41, 64, 56)
    jc, tc = cfgs(N0=64, N1=56, w=2)
    with EngineClient(server_socket) as c:
        sol, diff, contam = c.subtract(I, J, tc)
    assert contam is None
    sol_t, diff_t, _ = GeneralSFFT.GSS(I, J, I, J, tc, device="cpu")
    assert _equal(sol, sol_t) and _equal(diff, diff_t)
    sol_j, diff_j, _ = JGSFFT.GSS(I, J, I, J, jc)
    sol_j = np.asarray(sol_j)
    np.testing.assert_allclose(sol, sol_j, rtol=1e-6, atol=1e-7 * np.abs(sol_j).max())
    np.testing.assert_allclose(diff, np.asarray(diff_j), rtol=0, atol=1e-8 * np.abs(J).max())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_masked_pair_and_apply_only(server_socket, dtype):
    """A masked pair (the unmasked one transposed in memory, as the
    automatic packets give it; float32 payloads too), then the apply-only
    resume path with the returned solution."""
    I, J = make_pair(42, 48, 48)
    I, J = np.asfortranarray(I.astype(dtype)), np.asfortranarray(J.astype(dtype))
    mI, mJ = np.ascontiguousarray(I), np.ascontiguousarray(J)
    mI[10:16, 20:26] = 0.0
    mJ[10:16, 20:26] = 0.0
    _, tc = cfgs(N0=48, N1=48, w=1)
    with EngineClient(server_socket) as c:
        sol, diff, _ = c.subtract(I, J, tc, mI=mI, mJ=mJ)
        sol2, diff2, _ = c.subtract(I, J, tc, solution=sol)
    sol_t, diff_t, _ = GeneralSFFT.GSS(I, J, mI, mJ, tc, device="cpu")
    assert _equal(sol, sol_t) and _equal(diff, diff_t)
    assert np.array_equal(sol2, sol)
    _, diff_apply = ElementalSFFT.ESS(I, J, tc, SFFTSolution=sol, Subtract=True, device="cpu")
    assert _equal(diff2, diff_apply)


def test_contamination_mask_matches_inprocess(server_socket):
    I, J = make_pair(43, 48, 48)
    mask = np.zeros((48, 48))
    mask[20:23, 30:33] = 1.0
    _, tc = cfgs(N0=48, N1=48, w=1)
    with EngineClient(server_socket) as c:
        sol, diff, contam = c.subtract(I, J, tc, contam_mask=mask)
    sol_t, diff_t, contam_t = GeneralSFFT.GSS(I, J, I, J, tc, ContamMask_I=mask, device="cpu")
    assert _equal(sol, sol_t) and _equal(diff, diff_t) and _equal(contam, contam_t)
    assert contam.dtype == np.bool_ and contam.any()


def test_mismatched_mask_args_rejected(server_socket):
    I, J = make_pair(44, 48, 48)
    _, tc = cfgs(N0=48, N1=48, w=1)
    with EngineClient(server_socket) as c:
        with pytest.raises(EngineServerError, match="both mI and mJ"):
            c.subtract(I, J, tc, mI=I)


def test_diff_dtype_downcast(server_socket):
    I, J = make_pair(45, 48, 48)
    _, tc = cfgs(N0=48, N1=48, w=1)
    with EngineClient(server_socket) as c:
        _sol, diff, _ = c.subtract(I, J, tc, diff_dtype="float32")
    assert diff.dtype == np.float32
    _, diff_t, _ = GeneralSFFT.GSS(I, J, I, J, tc, device="cpu")
    assert _equal(diff, diff_t.to(torch.float32))


def test_error_propagates_and_server_survives(server_socket):
    I, J = make_pair(46, 48, 48)
    _, tc = cfgs(N0=32, N1=32, w=1)  # wrong shape for these images
    with EngineClient(server_socket) as c:
        with pytest.raises(EngineServerError):
            c.subtract(I, J, tc)
        pong = c.ping()
    assert pong["ok"] and pong["platform"] == "cpu" and pong["device"] == "cpu"
    assert pong["warm"] and pong["attach_s"] >= 0.0 and pong["pid"] != os.getpid()


def test_warm_runs_the_step(server_socket):
    _, tc = cfgs(N0=40, N1=40, w=1)
    fast = dict(greek_backend="peeled", fdiff_backend="fft32", solver="refined")
    _, tf = cfgs(N0=40, N1=40, w=1, **fast)
    with EngineClient(server_socket) as c:
        first = c.warm(tc)
        second = c.warm(tc)
        assert c.warm(tf) >= 0.0
    assert first >= 0.0
    assert second < max(0.5, 0.5 * first)


def test_ensure_server_reuses_live_server(server_socket):
    pid0 = _ping_path(server_socket)["pid"]
    resp = ensure_server(server_socket)  # must NOT spawn a second daemon
    assert resp["pid"] == pid0


def test_client_process_never_initialises_cuda(server_socket, tmp_path):
    """A REAL client process performs a subtraction with CUDA's
    initialisation made to raise: the client path never touches a device."""
    I, J = make_pair(47, 48, 48)
    np.savez(tmp_path / "pair.npz", I=I, J=J)
    script = tmp_path / "client.py"
    script.write_text(textwrap.dedent("""
        import sys
        sys.path.insert(0, sys.argv[1])
        import numpy as np
        import torch

        def _boom(*a, **k):
            raise AssertionError("the client initialised CUDA")

        torch.cuda._lazy_init = _boom
        from sfft_tpu_torch import EngineClient, make_config
        d = np.load(sys.argv[3])
        cfg = make_config(48, 48, 1)
        with EngineClient(sys.argv[2]) as c:
            sol, diff, _ = c.subtract(d["I"], d["J"], cfg)
        assert sol.size == cfg.NEQ, sol.shape
        assert diff.shape == (48, 48)
        assert not torch.cuda.is_initialized()
        print("CLIENT_OK", flush=True)
    """))
    out = subprocess.run([sys.executable, str(script), REPO, server_socket,
                          str(tmp_path / "pair.npz")],
                         capture_output=True, text=True, timeout=300, env=dict(os.environ))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "CLIENT_OK" in out.stdout


def test_server_without_a_card_raises(monkeypatch):
    from sfft_tpu_torch.serve import EngineServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineServer("/nonexistent/engine.sock")
