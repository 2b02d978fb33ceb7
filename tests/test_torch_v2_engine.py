"""The v2 (B-spline) engine of sfft_tpu_torch on its f64 fft/fft/lu path, and
the direct-call `exact` table functions, against sfft_tpu.

The same seeded numpy pair goes through both packages on the CPU
(device="cpu" for the port). Bounds: solution within 1e-6 of its maximum,
difference within 1e-8 of max|J| (the f64 bounds of tests/test_engine.py);
exact-grade tables within 1e-12 of their maximum (the grade of
tests/test_exact_fft.py).
"""

import numpy as np
import pytest
import torch

import sfft_tpu  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from sfft_tpu.core import engine as jengine
from sfft_tpu.core import greek as jgreek

from sfft_tpu_torch.core import engine as tengine
from sfft_tpu_torch.core import greek as tgreek

import test_v2_engine
import v2_cases

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)


def _close(out, ref, tol, scale=None):
    ref = np.asarray(ref)
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("case", sorted(v2_cases.CASES))
def test_v2_fft_path_matches_reference(case):
    I, J = v2_cases.make_pair()
    jc, tc = v2_cases.configs(case)
    assert (tc.greek_backend, tc.fdiff_backend, tc.solver) == ("fft", "fft", "lu")
    sol_j, diff_j = jengine.ElementalSFFT.ESS(I, J, jc, Subtract=True)
    sol_t, diff_t = tengine.ElementalSFFT.ESS(I, J, tc, Subtract=True, device="cpu")
    _close(sol_t, sol_j, 1e-6)
    _close(diff_t, diff_j, 1e-8, np.abs(J).max())
    if tc.regularize_lambda == 0.0:
        # the dense spatial-domain LSQ oracle of tests/test_v2_engine.py
        sol_o = test_v2_engine.oracle_solve_general(I, J, jc)
        _close(sol_t, sol_o, 3e-5)


def test_separate_constant_poly_equals_v1_const_phot_ratio():
    I, J = v2_cases.make_pair()
    _, t2 = v2_cases.configs("separate_constant_poly")
    t1 = v2_cases.config_from_fields(dict(N0=t2.N0, N1=t2.N1, w0=1, w1=1,
                                          const_phot_ratio=True))
    s1, _ = tengine.ElementalSFFT.ESS(I, J, t1, device="cpu")
    s2, _ = tengine.ElementalSFFT.ESS(I, J, t2, device="cpu")
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=1e-10)


def _stacks(case):
    I, J = v2_cases.make_pair(2)
    jc, tc = v2_cases.configs(case)
    SI, ST, SSc = tengine._plane_stacks(tc, torch.as_tensor(I))
    return jc, tc, SI, ST, SSc, torch.as_tensor(J)


def test_greek_tables_exact_direct_call_matches_reference():
    """greek_tables(backend='exact') with the background basis given: the
    sliced pair-FFT windows, and the rolled-basis moments through the K3
    wrapper (its plain twin on CPU tensors)."""
    jc, tc, SI, ST, _, J = _stacks("bspline_entangled")
    ref = jax.jit(lambda a, b, c: jgreek.greek_tables(
        a, b, c, 1, 1, backend="exact", bg_spec=jc.bg_basis))(
        *(jnp.asarray(v.numpy()) for v in (SI, ST, J)))
    out = tgreek.greek_tables(SI, ST, J, 1, 1, backend="exact", bg_spec=tc.bg_basis)
    f64 = tgreek.greek_tables(SI, ST, J, 1, 1, backend="fft")
    for o, r, f in zip(out, ref, f64):
        _close(o, r, 1e-12)
        _close(o, f, 1e-12)
    # without the basis spec every background block takes the spectral route
    gen = tgreek.greek_tables(SI, ST, J, 1, 1, backend="exact")
    for g, f in zip(gen, f64):
        _close(g, f, 1e-12)


def test_greek_tables_separate_exact_direct_call_matches_reference():
    jc, tc, SI, ST, SSc, J = _stacks("bspline_separate_varying")
    n_active = tc.scaling_basis.num_funcs()
    assert SSc.shape[0] == tc.Fij > n_active
    ref = jax.jit(lambda a, b, c, d: jgreek.greek_tables_separate(
        a, b, c, d, 1, 1, backend="exact", n_active=n_active))(
        *(jnp.asarray(v.numpy()) for v in (SI, SSc, ST, J)))
    out = tgreek.greek_tables_separate(SI, SSc, ST, J, 1, 1, backend="exact",
                                       n_active=n_active)
    f64 = tgreek.greek_tables_separate(SI, SSc, ST, J, 1, 1, backend="fft")
    jf64 = jgreek.greek_tables_separate(*(jnp.asarray(v.numpy()) for v in (SI, SSc, ST, J)),
                                        1, 1, backend="fft")
    for o, r, f, jf in zip(out, ref, f64, jf64):
        _close(o, r, 1e-12)
        _close(o, f, 1e-12)
        _close(f, jf, 1e-12)
    with_spec = tgreek.greek_tables_separate(SI, SSc, ST, J, 1, 1, backend="exact",
                                             bg_spec=tc.bg_basis, n_active=n_active)
    for o, f in zip(with_spec, f64):
        _close(o, f, 1e-12)


def test_unported_backends_raise():
    _, tc, SI, ST, SSc, J = _stacks("separate_varying_poly")
    # every backend of sfft_tpu is ported: only an unknown name raises
    with pytest.raises(ValueError):
        tgreek.greek_tables(SI, ST, J, 1, 1, backend="nope")
    with pytest.raises(ValueError):
        tgreek.greek_tables_separate(SI, SSc, ST, J, 1, 1, backend="nope")
    # 'corr' is ported: the FFT-free tables equal the fft route's
    n_active = tc.scaling_basis.num_funcs()
    for fn, args in ((tgreek.greek_tables, (SI, ST, J, 1, 1)),
                     (tgreek.greek_tables_separate, (SI, SSc, ST, J, 1, 1))):
        kw = {} if fn is tgreek.greek_tables else {"n_active": n_active}
        for o, f in zip(fn(*args, backend="corr", **kw), fn(*args, backend="fft", **kw)):
            _close(o, f.numpy(), 1e-12)
    # 'fft32' is ported (f32 tables; held to sfft_tpu in test_torch_v2_fast.py)
    out = tgreek.greek_tables_separate(SI, SSc, ST, J, 1, 1, backend="fft32")
    assert all(o.dtype == torch.float32 for o in out)
