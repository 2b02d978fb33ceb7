"""The contract path of sfft_tpu_torch (pexact tables and difference, the
transformed and exact solvers) against sfft_tpu on the CPU.

The pair is tests/test_pexact.py's 80x64, w=3 pair from its seed; sfft_tpu
runs its own CPU route (jitted, XLA slicing chain). Each sfft_tpu reference
is computed once per module. Bounds: tables 1e-12 * max (the pexact bound
of tests/test_pexact.py); solutions 1e-6 * max|sol| and differences
1e-8 * max|J| (tests/test_engine.py). The balanced profile (6, 6, 5) captures
36 bits of the fluctuation scale: the two packages round the compensation
terms of their pair arithmetic differently (eager PyTorch never contracts a
product into an FMA, XLA:CPU may), and at that depth such a difference can
flip a last slice. Each package then sits ~6e-6 from the f64 oracle on this
pair and ~2e-6 from the other, so that case is held to 1e-5 of the
reference and of the f64 oracle (tests/test_pexact.py holds sfft_tpu's
balanced profile to 1e-4 of the oracle).
"""

import dataclasses

import numpy as np
import pytest
import torch

try:
    import sfft_tpu  # noqa: F401  (x64)
    import jax
    import jax.numpy as jnp
    from sfft_tpu.config import BasisSpec
    from sfft_tpu.core import engine as jengine
    from sfft_tpu.core import solve as jsolve
    from test_pexact import _cfg, _pair
except ImportError:   # a machine without jax (the card's): only the `gpu` case runs there
    from sfft_tpu_torch.config import BasisSpec

from sfft_tpu_torch import make_config
from sfft_tpu_torch.config import config_from_fields
from sfft_tpu_torch.core import engine as tengine
from sfft_tpu_torch.core import exact_fft as texact
from sfft_tpu_torch.core import pairs as tpairs
from sfft_tpu_torch.core import pexact as tpexact
from sfft_tpu_torch.core import slicing as tslicing
from sfft_tpu_torch.core import solve as tsolve

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)

CASES = {
    "contract": dict(solver="transformed"),
    "exact": dict(solver="exact"),
    "balanced": dict(solver="transformed", pexact_prof=(6, 6, 5)),
    "separate-varying": dict(solver="exact", scaling_basis=BasisSpec("polynomial", 1)),
    "odd-N1": dict(solver="transformed", N1=63),
}


def _pair_for(name, seed=None):
    """The case's pair, or (seed) another pair of its shape."""
    if name == "odd-N1":
        return _pair(np.random.default_rng(7 if seed is None else seed), 80, 63)
    return _pair(np.random.default_rng(42 if seed is None else seed))


def _cfgs(name):
    jc = _cfg("pexact", "pexact", **CASES[name])
    return jc, config_from_fields(dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def refs():
    """sfft_tpu's (solution, difference) per case (and pair seed), computed
    on first use."""
    cache = {}

    def get(name, seed=None):
        if (name, seed) not in cache:
            I, J = _pair_for(name, seed)
            jc, _ = _cfgs(name)
            sol, diff, _ = jengine.GeneralSFFT.GSS(I, J, I, J, jc)
            cache[name, seed] = (np.asarray(sol), np.asarray(diff))
        return cache[name, seed]

    return get


@pytest.fixture(scope="module")
def contract_system():
    """sfft_tpu's pexact normal equations of the contract case."""
    I, J = _pair_for("contract")
    jc, _ = _cfgs("contract")
    lhs, rhs = jax.jit(lambda a, b: jengine._normal_equations_impl(jc, a, b))(
        jnp.asarray(I), jnp.asarray(J))
    return np.array(lhs), np.array(rhs)


def test_pexact_normal_equations_match_reference(contract_system):
    I, J = _pair_for("contract")
    _, tc = _cfgs("contract")
    lhs_j, rhs_j = contract_system
    lhs, rhs = tengine.normal_equations_fn(tc)(torch.as_tensor(I), torch.as_tensor(J))
    assert lhs.dtype == torch.float64 and lhs.shape == (tc.NEQ, tc.NEQ)
    assert np.abs(lhs.numpy() - lhs_j).max() < 1e-12 * np.abs(lhs_j).max()
    assert np.abs(rhs.numpy() - rhs_j).max() < 1e-12 * np.abs(rhs_j).max()


@pytest.mark.parametrize("name", ["contract", "exact", "separate-varying", "odd-N1"])
def test_gss_matches_reference(refs, name):
    I, J = _pair_for(name)
    _, tc = _cfgs(name)
    sj, dj = refs(name)
    st, dt, _ = tengine.GeneralSFFT.GSS(I, J, I, J, tc, device="cpu")
    assert st.dtype == torch.float64 and dt.shape == I.shape
    assert np.abs(st.numpy() - sj).max() <= 1e-6 * np.abs(sj).max()
    assert np.abs(dt.numpy() - dj).max() <= 1e-8 * np.abs(J).max()


def test_gss_balanced_profile(refs):
    I, J = _pair_for("balanced")
    _, tc = _cfgs("balanced")
    sj, dj = refs("balanced")
    st, dt, _ = tengine.GeneralSFFT.GSS(I, J, I, J, tc, device="cpu")
    st = st.numpy()
    assert np.abs(st - sj).max() <= 1e-5 * np.abs(sj).max()
    assert np.abs(dt.numpy() - dj).max() <= 1e-8 * np.abs(J).max()
    # the f64 fft/fft/lu oracle of tests/test_pexact.py
    so, do, _ = jengine.GeneralSFFT.GSS(I, J, I, J, _cfg("fft", "fft"))
    so = np.asarray(so)
    assert np.abs(st - so).max() <= 1e-5 * np.abs(so).max()
    assert np.sqrt(np.mean((dt.numpy() - np.asarray(do)) ** 2)) < 1e-5


def test_masked_pair_takes_separate_spectra(monkeypatch):
    """Masked == unmasked (the same arrays) shares one plane-spectra pass
    between tables and difference; a distinct masked pair computes its own."""
    I, J = _pair_for("contract")
    _, tc = _cfgs("contract")
    calls = []
    real = tpexact.pexact_plane_spectra

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tpexact, "pexact_plane_spectra", counted)
    s1, d1, _ = tengine.GeneralSFFT.GSS(I, J, I, J, tc, device="cpu")
    assert len(calls) == 1
    s2, d2, _ = tengine.GeneralSFFT.GSS(I, J, I.copy(), J.copy(), tc, device="cpu")
    assert len(calls) == 3
    np.testing.assert_allclose(s2.numpy(), s1.numpy(), rtol=0, atol=1e-12 * float(s1.abs().max()))
    np.testing.assert_allclose(d2.numpy(), d1.numpy(), rtol=0, atol=1e-12 * np.abs(J).max())


@pytest.mark.parametrize("solver", ["transformed", "exact"])
def test_solve_system_matches_reference(contract_system, solver):
    """Both packages solve sfft_tpu's pexact system (cross-fed as numpy)."""
    lhs, rhs = contract_system
    jc, tc = _cfgs("contract")
    jc = dataclasses.replace(jc, solver=solver)
    tc = dataclasses.replace(tc, solver=solver)
    ref = np.asarray(jax.jit(lambda a, b: jsolve.solve_system(jc, a, b))(
        jnp.asarray(lhs), jnp.asarray(rhs)))
    out = tsolve.solve_system(tc, torch.as_tensor(lhs), torch.as_tensor(rhs)).numpy()
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()
    removed = np.setdiff1d(np.arange(tc.NEQ), tsolve._tweak_plan(tc)[0])
    assert np.all(out[removed] == 0.0)


def test_transformed_solve_falls_back_to_exact(contract_system, monkeypatch):
    """With no refinement the certificate (residual <= 1e-12 |b|) fails and
    the transformed system goes to _exact_solve; the result is the same
    solution."""
    lhs, rhs = map(torch.as_tensor, contract_system)
    _, tc = _cfgs("contract")
    calls = []
    real = tsolve._exact_solve

    def counted(A, b, iters=2):
        calls.append(A.shape)
        return real(A, b, iters)

    monkeypatch.setattr(tsolve, "_exact_solve", counted)
    good = tsolve._transformed_solve(tc, lhs, rhs)
    assert calls == []
    fell = tsolve._transformed_solve(tc, lhs, rhs, iters=0)
    assert calls == [(tc.NEQ, tc.NEQ)]
    assert float((fell - good).abs().max()) <= 1e-6 * float(good.abs().max())


def test_legendre_congruence_matches_reference():
    for degree in range(4):
        np.testing.assert_array_equal(tsolve._legendre_congruence(degree),
                                      jsolve._legendre_congruence(degree))


@pytest.mark.parametrize("n", [100, 300, 600])
def test_exact_solver_reaches_f64_floor(n):
    """tests/test_exact_fft.py's ill-conditioned SPD system (cond 1e9), at
    three sizes."""
    rng = np.random.default_rng(20260816)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.logspace(0, -9, n)) @ Q.T
    A = 0.5 * (A + A.T)
    b = A @ rng.standard_normal(n)
    x = tsolve._exact_solve(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    x_np = np.linalg.solve(A, b)
    assert np.linalg.norm(x - x_np) / np.linalg.norm(x_np) < 1e-5
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-12


def test_pexact_rejects_bspline():
    _, tc = _cfgs("contract")
    tc = dataclasses.replace(tc, kernel_basis=type(tc.kernel_basis)(
        "bspline", 2, int_knots_x=(40.0,), int_knots_y=(32.0,)))
    assert not tpexact.pexact_supported(tc)
    with pytest.raises(ValueError, match="polynomial"):
        tengine.GeneralSFFT.GSS(*(np.zeros((80, 64)),) * 4, tc, device="cpu")


# --- the leading pair axis: a batch of pairs as one batched step -----------


def _single(tc, I, J):
    """The port's single call of a pair (solution, difference)."""
    return tengine.solve_and_subtract_fn(tc)(I, J, I, J)


@pytest.mark.parametrize("name", ["contract", "separate-varying"])
def test_batched_step_is_the_single_calls(refs, name):
    """Two pairs of one shape (the case's pair and one from another seed)
    as one batched step: each pair bit for bit its single call; the
    contract case also within the file's bounds of sfft_tpu's GSS of each
    pair (the separate-varying case runs the exact solver)."""
    _, tc = _cfgs(name)
    assert tengine.batched_step_supported(tc)
    planes = [_pair_for(name), _pair_for(name, 5)]
    I, J = (torch.stack([torch.as_tensor(p[r]) for p in planes]) for r in range(2))
    steps = tengine.solve_and_subtract_batched_fn.steps
    sol, diff = tengine.solve_and_subtract_batched_fn(tc)(I, J, I, J)
    assert tengine.solve_and_subtract_batched_fn.steps == steps + 1
    assert sol.shape == (2, tc.NEQ) and diff.shape == I.shape
    for k, seed in enumerate((None, 5)):
        s1, d1 = _single(tc, I[k], J[k])
        assert torch.equal(sol[k], s1) and torch.equal(diff[k], d1)
        if name == "contract":
            sj, dj = refs(name, seed)
            assert np.abs(sol[k].numpy() - sj).max() <= 1e-6 * np.abs(sj).max()
            assert np.abs(diff[k].numpy() - dj).max() <= 1e-8 * np.abs(J[k].numpy()).max()


def test_batched_step_slices_each_pair_with_its_own_scale(monkeypatch):
    """A batch whose second pair is the first scaled by 2^-20: every K4
    stage call of the batched step gives each pair the slices and scales of
    that pair's single call, every K7 epilogue its output, and the
    solutions and differences are the single calls' bit for bit (one data
    scale shared by the batch would lose 20 bits of the small pair)."""
    _, tc = _cfgs("contract")
    I0, J0 = (torch.as_tensor(a) for a in _pair_for("contract"))
    I = torch.stack([I0, I0 * 2.0 ** -20])
    J = torch.stack([J0, J0 * 2.0 ** -20])
    _single(tc, I[1], J[1])       # the static tables' slices, cached from here on
    k4, k7 = tslicing.slice_pairs, texact.sliced_epilogue
    log = []

    def rec4(*args, **kw):
        out = k4(*args, **kw)
        log[-1][0].append(out)
        return out

    def rec7(*args):
        out = k7(*args)
        log[-1][1].append(out)
        return out

    monkeypatch.setattr(texact, "slice_pairs", rec4)
    monkeypatch.setattr(texact, "sliced_epilogue", rec7)
    runs = []
    for k in range(2):
        log.append(([], []))
        runs.append(_single(tc, I[k], J[k]))
    log.append(([], []))
    sol, diff = tengine.solve_and_subtract_batched_fn(tc)(I, J, I, J)
    (b4, b7), singles = log[-1], log[:2]
    assert len(b4) > 20 and len(b7) > 20
    for k, (s4, s7) in enumerate(singles):
        assert torch.equal(sol[k], runs[k][0]) and torch.equal(diff[k], runs[k][1])
        assert len(s4) == len(b4) and len(s7) == len(b7)
        for got, own in zip(b4, s4):
            for (sl, sc), (osl, osc) in zip(got, own):
                assert torch.equal(sl[:, k], osl[:, 0])
                assert torch.equal(sc[k], osc[0].expand_as(sc[k]) if osc.dim() else
                                   osc.expand_as(sc[k]))
        for got, own in zip(b7, s7):
            assert all((g is None and o is None) or torch.equal(g[k], o[0])
                       for g, o in zip(got, own))


@pytest.mark.gpu
def test_batched_contract_kernels_on_the_card():
    """On the card: one batched contract step of two pairs at 128^2
    launches K4, K7, K6a, K6m and K6p once a set for the batch (the same
    counts as the single step), and each pair's solution and difference is
    its single call bit for bit (chip_smoke.py phase 14 holds every launch
    to its twin at 4096^2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    cfg = make_config(128, 128, 4, greek_backend="pexact", fdiff_backend="pexact",
                      solver="transformed")
    rng = np.random.default_rng(40)
    sky = 100.0 + 10.0 * rng.random((2, 128, 128))
    I = torch.as_tensor(sky + rng.normal(0, 1, sky.shape), device=dev)
    J = torch.as_tensor(1.1 * sky + 5.0 + rng.normal(0, 1, sky.shape), device=dev)
    counters = (tslicing.slice_pair, texact._K7, tpairs._K6A, tpairs._K6M, tpairs._K6P)

    def counts():
        return [c.launches for c in counters]

    _single(cfg, I[1], J[1])      # the static tables, built from here on
    c0 = counts()
    ones = [_single(cfg, I[k], J[k]) for k in range(2)]
    c1 = counts()
    sol, diff = tengine.solve_and_subtract_batched_fn(cfg)(I, J, I, J)
    torch.cuda.synchronize()
    c2 = counts()
    single = [(b - a) // 2 for a, b in zip(c0, c1)]
    assert [b - a for a, b in zip(c1, c2)] == single and min(single) >= 1
    for k in range(2):
        assert torch.equal(sol[k], ones[k][0]) and torch.equal(diff[k], ones[k][1])
