"""The large-system f64 solve of sfft_tpu_torch (core/solve.py:
_sliced_residual_setup, _sliced_matvec, _refined_solve_f64) against
sfft_tpu's and against numpy oracles.

Inputs are made from seeds with numpy and fed to both packages; on CPU
tensors the port slices with the plain twin of K5. The sliced matvec must
sit at the f64 dot's grade against a longdouble oracle (5e-14 of the
maximum, the bound of tests/test_engine.py) and reproduce sfft_tpu's integer
sums (1e-15 of the maximum; both of its row layouts). Solutions are compared,
not refinement step counts: XLA:CPU's f32 Cholesky is ~15x less accurate
than LAPACK's, so the two packages contract at different rates.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sfft_tpu  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from sfft_tpu.config import BasisSpec as JB, SFFTConfig as JC
from sfft_tpu.core import solve as jsolve

from sfft_tpu_torch.config import config_from_fields
from sfft_tpu_torch.core import solve as tsolve

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)


def _spd_cond1e7(seed, n):
    """The SPD systems of tests/test_engine.py: a dense logspace(0, -7)
    spectrum (cond 1e7 after equilibration, the grade of the regularized
    13k-dof system)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = (Q * np.logspace(0, -7, n)) @ Q.T
    A = 0.5 * (A + A.T)
    return A, A @ rng.normal(size=n)


def _gram_system(seed, n):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(n, n)) * np.exp(rng.normal(0, 2, size=(1, n)))
    A = G.T @ G + n * np.eye(n)
    d = 1.0 / np.sqrt(np.abs(np.diag(A)))
    x = rng.normal(size=n) * np.exp(rng.normal(0, 2, size=n))
    return A, d, x


def _maxrel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def test_split3_is_exact():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=500) * np.exp(rng.normal(0, 6, size=500)))
    keep = x.clone()
    hi, mid, lo = tsolve._split3(x)
    assert torch.equal(x, keep) and hi.dtype == mid.dtype == lo.dtype == torch.float32
    assert torch.equal(hi.double() + mid.double() + lo.double(), x)
    tsolve._split3(x, consume=True)
    assert not torch.equal(x, keep)


@pytest.mark.parametrize("row_chunk", [None, 512])
def test_sliced_matvec_f64_grade_and_reference_sums(row_chunk):
    """n = 1203 is odd, so the int8 depth is padded (1203 -> 1208) as on the
    13207-dof path. sfft_tpu's row_chunk=512 is its chunk-major layout."""
    n = 1203
    A, d, x = _gram_system(6, n)
    Ah, Asl, sa = tsolve._sliced_residual_setup(torch.as_tensor(A), torch.as_tensor(d))
    assert tuple(Asl.shape) == (12 * n, 1208) and Asl.dtype == torch.int8
    assert not Asl[:, n:].any()
    As = A * d[:, None] * d[None, :]
    np.testing.assert_array_equal(Ah.numpy(), As.astype(np.float32))
    out = tsolve._sliced_matvec(Asl, sa, torch.as_tensor(x)).numpy()
    ld = (As.astype(np.longdouble) @ x.astype(np.longdouble)).astype(np.float64)
    assert _maxrel(out, ld) < 5e-14

    def mv(A, d, x):
        _, Asl, sa, chk = jsolve._sliced_residual_setup(A, d, row_chunk=row_chunk)
        return jsolve._sliced_matvec(Asl, sa, x, chunk=chk)

    ref = np.asarray(jax.jit(mv)(jnp.asarray(A), jnp.asarray(d), jnp.asarray(x)))
    assert _maxrel(out, ref) < 1e-15


@pytest.mark.parametrize("route", ["sliced", "f64_matvec"])
def test_refined_solve_f64_reaches_f64_floor(route):
    A, b = _spd_cond1e7(414, 384)
    info = {}
    x = tsolve._refined_solve_f64(torch.as_tensor(A), torch.as_tensor(b),
                                  _f64_matvec=route == "f64_matvec", info=info).numpy()
    assert info["factor_ok"] and 1 <= info["steps"] <= 12
    assert _maxrel(x, np.linalg.solve(A, b)) < 1e-9
    ref = np.asarray(jax.jit(jsolve._refined_solve_f64)(jnp.asarray(A), jnp.asarray(b)))
    assert _maxrel(x, ref) < 1e-9


def test_refined_solve_f64_routes_agree():
    A, b = _spd_cond1e7(415, 1001)
    sl, mv = {}, {}
    xs = tsolve._refined_solve_f64(torch.as_tensor(A), torch.as_tensor(b), info=sl).numpy()
    xm = tsolve._refined_solve_f64(torch.as_tensor(A), torch.as_tensor(b), _f64_matvec=True,
                                   info=mv).numpy()
    assert _maxrel(xs, xm) < 1e-9
    assert sl["rel_residual"] < 1e-13 and mv["rel_residual"] < 1e-13


def test_refined_solve_f64_breakdown_is_loud():
    """An f32 factor that breaks down gives an all-NaN solution, never a
    silent switch of solver."""
    A, b = _spd_cond1e7(416, 96)
    A[5, 5] = -A[5, 5]
    info = {}
    x = tsolve._refined_solve_f64(torch.as_tensor(A), torch.as_tensor(b), info=info)
    assert not info["factor_ok"] and bool(torch.isnan(x).all())


def test_solve_system_exact_takes_sliced_route_for_large_regularized(monkeypatch):
    """solver='exact' sends a regularized f64 system of NEQ >= LARGE_NEQ to
    _refined_solve_f64 (sliced route), and anything else to _exact_solve."""
    jc = JC(N0=40, N1=36, w0=2, w1=2, kernel_basis=JB("polynomial", 1),
            bg_basis=JB("polynomial", 0), scaling_basis=JB("polynomial", 1), solver="exact",
            regularize_lambda=1e-3, reg_xy=((10.0, 10.0), (30.0, 20.0)), const_phot_ratio=False)
    tc = config_from_fields(dataclasses.asdict(jc))
    A, b = _spd_cond1e7(417, tc.NEQ)
    calls = []
    real = tsolve._refined_solve_f64

    def spy(A, b, **kw):
        calls.append(kw)
        return real(A, b, **kw)

    monkeypatch.setattr(tsolve, "_refined_solve_f64", spy)
    assert tsolve.LARGE_NEQ == 8192
    small = tsolve.solve_system(tc, torch.as_tensor(A), torch.as_tensor(b)).numpy()
    assert not calls
    monkeypatch.setattr(tsolve, "LARGE_NEQ", 64)
    large = tsolve.solve_system(tc, torch.as_tensor(A), torch.as_tensor(b), plain=True).numpy()
    assert calls == [dict(plain=True)]
    assert _maxrel(large, small) < 1e-9
    off = dataclasses.replace(tc, regularize_lambda=0.0)
    tsolve.solve_system(off, torch.as_tensor(A), torch.as_tensor(b))
    assert len(calls) == 1


def test_host_solve_is_the_reference_lapack_lu():
    """solver='host' runs numpy's LU on the host, as sfft_tpu's pure_callback
    does: the same bits on the same system."""
    A, b = _spd_cond1e7(418, 200)
    x = tsolve._host_solve(torch.as_tensor(A), torch.as_tensor(b))
    assert x.dtype == torch.float64 and x.device.type == "cpu"
    ref = np.asarray(jax.jit(jsolve._host_solve)(jnp.asarray(A), jnp.asarray(b)))
    assert np.array_equal(x.numpy(), ref)


@pytest.mark.parametrize("solver", ["host", "blocked_cho"])
def test_host_and_blocked_cho_match_reference_and_lu(solver):
    """The engine with solver 'host' / 'blocked_cho' against sfft_tpu's same
    solver and the port's f64 'lu', within 1e-6 of the solution's maximum
    (tests/test_engine.py:115)."""
    from test_engine import make_pair

    from sfft_tpu.core.engine import ElementalSFFT as JESS
    from sfft_tpu_torch.core.engine import ElementalSFFT

    I, J = make_pair(np.random.default_rng(50), 24, 20)
    jc = JC(N0=24, N1=20, w0=1, w1=1, kernel_basis=JB("polynomial", 2),
            bg_basis=JB("polynomial", 2), solver=solver)
    tc = config_from_fields(dataclasses.asdict(jc))
    sol = ElementalSFFT.ESS(I, J, tc, device="cpu")[0].numpy()
    ref = np.asarray(JESS.ESS(I, J, jc)[0])
    lu = ElementalSFFT.ESS(I, J, dataclasses.replace(tc, solver="lu"), device="cpu")[0].numpy()
    assert _maxrel(sol, ref) < 1e-6 and _maxrel(sol, lu) < 1e-6
