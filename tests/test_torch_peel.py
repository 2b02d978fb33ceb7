"""Peeled (smooth/fluctuation) tables of sfft_tpu_torch against sfft_tpu.

Same inputs (the large-smooth-background pair of tests/test_peel.py, made
from a seed) go through both packages. With fluct_dtype='float64' every
table is exact algebra plus an f64 FFT, so the bound is that of
tests/test_peel.py:58, 1e-9 * max|ref|. Every table must be float64 where
sfft_tpu's is.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sfft_tpu  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from sfft_tpu.config import BasisSpec as JB, SFFTConfig as JC
from sfft_tpu.core import peel as jpeel

from sfft_tpu_torch.config import config_from_fields
from sfft_tpu_torch.core import peel as tpeel

import test_peel

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)

NAMES = ["Comg", "Cgam", "Cthe", "Cphi", "Cdel"]


def make_pair(seed, N0=48, N1=40, mean=500.0):
    """tests/test_peel.py's pair (a LARGE smooth background, the
    cancellation stress case) from its own seed."""
    return test_peel.make_pair(np.random.default_rng(seed), N0, N1, mean)


def _jref_tables(I, J, jc):
    """sfft_tpu's peeled tables, jitted (its eager op-by-op run takes ~10 s)."""
    return jax.jit(lambda a, b: jpeel.peeled_greek_tables(a, b, jc))(
        jnp.asarray(I), jnp.asarray(J))


def _close(a, b, rel=1e-9, what=""):
    b = np.asarray(b)
    a_np = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    assert a_np.shape == b.shape, (what, a_np.shape, b.shape)
    scale = np.abs(b).max()
    err = np.abs(a_np - b).max()
    assert err <= rel * scale, f"{what}: max abs diff {err:.3e} vs scale {scale:.3e}"


def _cfgs(w, **kw):
    jc = JC(N0=48, N1=40, w0=w, w1=w, kernel_basis=JB("polynomial", 2),
            bg_basis=JB("polynomial", 2), greek_backend="peeled", **kw)
    return jc, config_from_fields(dataclasses.asdict(jc))


@pytest.mark.parametrize("w0,w1", [(1, 1), (2, 3), (4, 0), (0, 2)])
def test_moment_set_matches_reference(w0, w1):
    I, _ = make_pair(1)
    SP, SG, EMAX = 6, 8, 18
    args_j = (48, 40, w0, w1, SG, jpeel.axis_static(48, w0, SP, EMAX),
              jpeel.axis_static(40, w1, SP, EMAX))
    args_t = (48, 40, w0, w1, SG, tpeel.axis_static(48, w0, SP, EMAX),
              tpeel.axis_static(40, w1, SP, EMAX))
    ref = jax.jit(lambda g: jpeel.moment_set(g, *args_j))(jnp.asarray(I))
    out = tpeel.moment_set(torch.as_tensor(I), *args_t)
    for name, a, b in zip(ref._fields, out, ref):
        assert a.dtype == torch.float64, name
        _close(a, b, 1e-13, name)


def test_poly_algebra_matches_reference():
    """poly_moment_set, polycorr, shift_moment_set and fit_poly_coeffs on
    shared inputs."""
    I, _ = make_pair(2)
    SP, SG, EMAX, w = 6, 8, 18, 2
    axj = [jpeel.axis_static(n, w, SP, EMAX) for n in (48, 40)]
    axt = [tpeel.axis_static(n, w, SP, EMAX) for n in (48, 40)]
    for a, b in zip(axt[0], axj[0]):
        np.testing.assert_array_equal(a, b)
    Q = np.random.default_rng(3).normal(0, 1, (3, SP, SP))
    pj = jpeel.poly_moment_set(jnp.asarray(Q), w, w, SP, SG, *axj)
    pt = tpeel.poly_moment_set(torch.as_tensor(Q), w, w, SP, SG, *axt)
    for name, a, b in zip(pj._fields, pt, pj):
        _close(a, b, 1e-13, "poly_moment_set " + name)
    momj = jax.jit(lambda g: jpeel.moment_set(g, 48, 40, w, w, SG, *axj))(jnp.asarray(I))
    momt = tpeel.moment_set(torch.as_tensor(I), 48, 40, w, w, SG, *axt)
    exps = np.array([(0, 0), (1, 0), (0, 2)])
    shj = jpeel.shift_moment_set(momj, exps, SP)
    sht = tpeel.shift_moment_set(momt, exps, SP)
    for name, a, b in zip(shj._fields, sht, shj):
        _close(a, b, 1e-13, "shift_moment_set " + name)
    _close(tpeel.polycorr(torch.as_tensor(Q), sht, *axt),
           jpeel.polycorr(jnp.asarray(Q), shj, *axj), 1e-12, "polycorr")
    _close(tpeel.polycorr(torch.as_tensor(Q), momt, *axt),
           jpeel.polycorr(jnp.asarray(Q), momj, *axj), 1e-12, "polycorr (unbatched mom)")
    _close(tpeel.fit_poly_coeffs(momt.M, 3, *axt),
           jpeel.fit_poly_coeffs(momj.M, 3, *axj), 1e-9, "fit_poly_coeffs")


@pytest.mark.parametrize("w", [1, 2, 3])
def test_peeled_tables_f64_match_reference(w):
    I, J = make_pair(10 + w)
    jc, tc = _cfgs(w, fluct_dtype="float64")
    ref = _jref_tables(I, J, jc)
    out = tpeel.peeled_greek_tables(torch.as_tensor(I), torch.as_tensor(J), tc)
    for name, a, b in zip(NAMES, out, ref):
        assert a.dtype == torch.float64, name
        _close(a, b, 1e-9, name)
    # plain=True (no hand kernels) is the same computation on the CPU
    outp = tpeel.peeled_greek_tables(torch.as_tensor(I), torch.as_tensor(J), tc, plain=True)
    for name, a, b in zip(NAMES, outp, out):
        _close(a, b.numpy(), 1e-12, name + " plain")


def test_peeled_tables_f32_fluct_match_reference():
    """The fast mode's tables: the fluct x fluct part runs in complex64 in
    both packages through different FFT libraries, so they agree to the c64
    FFT floor of that part — stated as 1e-6 * max|ref| of each table (the
    f32 part is a small fraction of each table's exact-f64 total)."""
    I, J = make_pair(20)
    jc, tc = _cfgs(2, fluct_dtype="float32")
    ref = _jref_tables(I, J, jc)
    out = tpeel.peeled_greek_tables(torch.as_tensor(I), torch.as_tensor(J), tc)
    for name, a, b in zip(NAMES, out, ref):
        assert a.dtype == torch.float64, name
        _close(a, b, 1e-6, name)


def test_peeled_separate_varying_tables_match_reference():
    I, J = make_pair(30)
    jc, tc = _cfgs(2, fluct_dtype="float64", scaling_basis=JB("polynomial", 1))
    jc = dataclasses.replace(jc, bg_basis=JB("polynomial", 1))
    tc = config_from_fields(dataclasses.asdict(jc))
    assert tc.scaling_mode == "SEPARATE-VARYING"
    ref = _jref_tables(I, J, jc)
    out = tpeel.peeled_greek_tables(torch.as_tensor(I), torch.as_tensor(J), tc)
    assert len(out) == 6 and len(out[5]) == 4
    for name, a, b in zip(NAMES, out, ref):
        _close(a, b, 1e-9, name)
    for name, a, b in zip(["Pbs", "Pss", "Pgs", "Pts"], out[5], ref[5]):
        assert a.dtype == torch.float64, name
        _close(a, b, 1e-9, name)


def test_peeled_bspline_raises():
    """B-spline bases dispatch to the piecewise peel (core/peel_pw.py, held to
    sfft_tpu in test_torch_peel_pw.py), which raises where its knot layout is
    not supported (a knot closer than 2W to the edge)."""
    from sfft_tpu_torch.core import peel_pw as tpw

    jc, tc = _cfgs(1, fluct_dtype="float64")
    tc = dataclasses.replace(tc, kernel_basis=dataclasses.replace(
        tc.kernel_basis, kind="bspline", int_knots_x=(2.0,)))
    assert not tpw.pw_supported(tc)
    with pytest.raises(ValueError, match="edge"):
        tpeel.peeled_greek_tables(torch.zeros((48, 40), dtype=torch.float64),
                                  torch.zeros((48, 40), dtype=torch.float64), tc)
