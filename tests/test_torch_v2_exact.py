"""The v2 engine of sfft_tpu_torch on its contract path (greek 'exact',
fdiff 'exact', solver 'exact') against sfft_tpu's, on the CPU.

The same seeded numpy pair goes through both packages; sfft_tpu runs its
fused step jitted (its Pallas slicers are off on the CPU, so its XLA chains
are the reference), the port runs on CPU tensors, where K4 and K5 take their
plain twins. Bounds: solution within 1e-6 of its maximum (the contract's
bound), difference within 1e-8 of max|J|.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sfft_tpu  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from sfft_tpu.core import engine as jengine

from sfft_tpu_torch.core import engine as tengine
from sfft_tpu_torch.core import solve as tsolve

import v2_cases

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)

EXACT = dict(greek_backend="exact", fdiff_backend="exact", solver="exact")
_STEPS = {}


def _same_step(case):
    """The port's shared-spectra step of a case on the module's pair, computed
    once per module."""
    if case not in _STEPS:
        I, J = v2_cases.make_pair()
        _, tc = v2_cases.configs(case, **EXACT)
        _STEPS[case] = tengine.solve_and_subtract_same_fn(tc)(torch.as_tensor(I),
                                                              torch.as_tensor(J))
    return _STEPS[case]


@pytest.mark.parametrize("case", sorted(v2_cases.CASES))
def test_v2_exact_path_matches_reference(case):
    I, J = v2_cases.make_pair()
    jc, _ = v2_cases.configs(case, **EXACT)
    sol_j, diff_j = jax.jit(jengine.solve_and_subtract_same_fn(jc))(
        jnp.asarray(I), jnp.asarray(J))
    sol_j, diff_j = np.asarray(sol_j), np.asarray(diff_j)
    sol_t, diff_t = _same_step(case)
    np.testing.assert_allclose(sol_t.numpy(), sol_j, rtol=0, atol=1e-6 * np.abs(sol_j).max())
    np.testing.assert_allclose(diff_t.numpy(), diff_j, rtol=0, atol=1e-8 * np.abs(J).max())
    # and the port's own f64 fft/fft/lu path as the yardstick of the contract
    _, fc = v2_cases.configs(case)
    sol_f, diff_f = tengine.ElementalSFFT.ESS(I, J, fc, Subtract=True, device="cpu")
    assert float((sol_t - sol_f).abs().max()) <= 1e-6 * float(sol_f.abs().max())
    assert float((diff_t - diff_f).abs().max()) <= 1e-8 * np.abs(J).max()


@pytest.mark.parametrize("case", ["bspline_entangled", "bspline_tikhonov"])
def test_shared_spectra_step_equals_two_call_step(case):
    """Masked == unmasked: the step computes the plane spectra once and hands
    them to the tables and the difference; the numbers are those of the two
    separate calls. The shared step is the one the parity test above ran on
    the same pair."""
    I, J = v2_cases.make_pair()
    _, tc = v2_cases.configs(case, **EXACT)
    sol_s, diff_s = _same_step(case)
    sol_2, diff_2 = tengine.ElementalSFFT.ESS(I, J, tc, Subtract=True, device="cpu")
    assert torch.equal(sol_s, sol_2) and torch.equal(diff_s, diff_2)
    # GSS takes the shared step for the same arrays and two calls otherwise
    sol_g, diff_g, _ = tengine.GeneralSFFT.GSS(I, J, I.copy(), J.copy(), tc, device="cpu")
    assert torch.equal(sol_g, sol_2) and torch.equal(diff_g, diff_2)


def test_exact_path_walks_the_sliced_solve_at_small_size(monkeypatch):
    """With the size gate lowered, the Tikhonov case takes
    _refined_solve_f64's sliced route (the plain twin of K5 on the CPU) and
    lands on the same solution as the f64 Cholesky route."""
    I, J = v2_cases.make_pair(4)
    _, tc = v2_cases.configs("bspline_tikhonov", **EXACT)
    sol_c, _ = tengine.ElementalSFFT.ESS(I, J, tc, device="cpu")
    seen = []
    real = tsolve._sliced_matvec
    monkeypatch.setattr(tsolve, "_sliced_matvec",
                        lambda *a, **kw: seen.append(kw) or real(*a, **kw))
    monkeypatch.setattr(tsolve, "LARGE_NEQ", 64)
    sol_s, _ = tengine.ElementalSFFT.ESS(I, J, tc, device="cpu")
    assert seen and not any(kw["plain"] for kw in seen)
    assert float((sol_s - sol_c).abs().max()) <= 1e-9 * float(sol_c.abs().max())
    # without Tikhonov the gate keeps the unconditional f64 route
    del seen[:]
    tengine.ElementalSFFT.ESS(I, J, dataclasses.replace(tc, regularize_lambda=0.0),
                              device="cpu")
    assert not seen
