"""Tikhonov regularization of sfft_tpu_torch (core/regularize.py,
core/basis.basis_at_points) against sfft_tpu's.

The terms are static numpy in both packages, built from the same seeded
sample points: they must agree to 1e-14 of their maximum. The streamed form
(assemble_system reg_terms) must equal the dense apply_regularization, and
both sfft_tpu's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sfft_tpu  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from sfft_tpu.config import BasisSpec as JB, SFFTConfig as JC
from sfft_tpu.core import basis as jbasis
from sfft_tpu.core import engine as jengine
from sfft_tpu.core import regularize as jreg

from sfft_tpu_torch.config import config_from_fields
from sfft_tpu_torch.core import basis as tbasis
from sfft_tpu_torch.core import engine as tengine
from sfft_tpu_torch.core import regularize as treg

import test_v2_engine

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)


def _xy(seed, n=12):
    rng = np.random.default_rng(seed)
    return tuple((float(x), float(y)) for x, y in rng.uniform(3, 30, size=(n, 2)))


def _pair(**kw):
    jc = JC(N0=40, N1=36, w0=2, w1=2, **kw)
    return jc, config_from_fields(dataclasses.asdict(jc))


MODES = {
    "entangled": dict(kernel_basis=JB("polynomial", 1), bg_basis=JB("polynomial", 1)),
    "separate_constant": dict(kernel_basis=JB("bspline", 2, (20.0,), (18.0,)),
                              bg_basis=JB("polynomial", 1),
                              scaling_basis=JB("polynomial", 0)),
    "separate_varying": dict(kernel_basis=JB("bspline", 2, (20.0,), (18.0,)),
                             bg_basis=JB("polynomial", 0),
                             scaling_basis=JB("polynomial", 2)),
    "weights_keep_center": dict(kernel_basis=JB("polynomial", 2),
                                scaling_basis=JB("polynomial", 1),
                                reg_weights=tuple(float(w) for w in range(1, 13)),
                                ignore_laplacian_kercent=False),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_regularization_terms_match_reference(mode):
    jc, tc = _pair(regularize_lambda=3e-5, reg_xy=_xy(7), **MODES[mode])
    ref = jreg.regularization_terms(jc)
    out = treg.regularization_terms(tc)
    assert len(out) == len(ref) == (4 if tc.scaling_mode == "SEPARATE-VARYING" else 1)
    for (M, R), (Mr, Rr) in zip(out, ref):
        np.testing.assert_allclose(M, Mr, rtol=0, atol=1e-14 * np.abs(Mr).max())
        np.testing.assert_array_equal(R, Rr)
    np.testing.assert_array_equal(treg._iregmat(tc), jreg._iregmat(jc))


def test_regularization_off_adds_nothing():
    _, tc = _pair(reg_xy=_xy(7))
    assert treg.regularization_terms(tc) is None
    assert treg.regularization_terms_on(tc, torch.device("cpu"), torch.float64) is None
    lhs = torch.ones((tc.NEQ, tc.NEQ), dtype=torch.float64)
    assert treg.apply_regularization(tc, lhs) is lhs


@pytest.mark.parametrize("kind", ["polynomial", "bspline"])
def test_basis_at_points_matches_reference(kind):
    spec = (("polynomial", 3) if kind == "polynomial"
            else ("bspline", 2, (13.5, 27.0), (18.0,)))
    rng = np.random.default_rng(8)
    sx, sy = rng.uniform(0.05, 0.95, 20), rng.uniform(0.05, 0.95, 20)
    ref = jbasis.basis_at_points(JB(*spec), 40, 36, sx, sy)
    out = tbasis.basis_at_points(tbasis.BasisSpec(*spec), 40, 36, sx, sy)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-15)


@pytest.mark.parametrize("mode", ["entangled", "separate_varying"])
def test_regularization_streamed_equals_dense_and_reference(mode):
    """The streamed form exists because a dense (Fijab, Fijab) REGMAT
    temporary is as large as the system itself at 13k dof."""
    I, J = test_v2_engine.make_pair(np.random.default_rng(9))
    jc, tc = _pair(regularize_lambda=7.5, reg_xy=_xy(10), **MODES[mode])
    jc0 = dataclasses.replace(jc, regularize_lambda=0.0)
    tc0 = dataclasses.replace(tc, regularize_lambda=0.0)
    It, Jt = torch.as_tensor(I), torch.as_tensor(J)
    lhs_str, rhs_str = tengine.normal_equations_fn(tc)(It, Jt)
    lhs_raw, rhs_raw = tengine.normal_equations_fn(tc0)(It, Jt)
    lhs_dense = treg.apply_regularization(tc, lhs_raw)
    scale = float(lhs_dense.abs().max())
    assert float((lhs_dense - lhs_raw).abs().max()) > 1e-6 * scale   # the terms are live
    np.testing.assert_allclose(lhs_str.numpy(), lhs_dense.numpy(), rtol=0, atol=1e-12 * scale)
    np.testing.assert_array_equal(rhs_str.numpy(), rhs_raw.numpy())
    lhs_j, rhs_j = jax.jit(jengine.normal_equations_fn(jc))(jnp.asarray(I), jnp.asarray(J))
    np.testing.assert_allclose(lhs_str.numpy(), np.asarray(lhs_j), rtol=0, atol=1e-10 * scale)
    lhs_jd = jreg.apply_regularization(jc, jax.jit(jengine.normal_equations_fn(jc0))(
        jnp.asarray(I), jnp.asarray(J))[0])
    np.testing.assert_allclose(lhs_dense.numpy(), np.asarray(lhs_jd), rtol=0,
                               atol=1e-10 * scale)
