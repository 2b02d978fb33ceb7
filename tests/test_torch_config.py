"""sfft_tpu_torch config, index tables and basis planes against sfft_tpu.

The port's configs must describe the same systems as the reference's: every
derived size, the scaling mode, make_config's backend resolution on a
CPU/GPU, and the static tables derived from a config are held equal here
(integers exactly, basis planes bit-equal or within 1e-15).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import sfft_tpu  # noqa: F401  (x64)
from sfft_tpu import config as jconfig
from sfft_tpu.core import basis as jbasis
from sfft_tpu.core import indices as jindices

from sfft_tpu_torch import config as tconfig
from sfft_tpu_torch.core import basis as tbasis
from sfft_tpu_torch.core import indices as tindices

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)


def _spec_pair(kind, degree, kx=(), ky=()):
    return (jconfig.BasisSpec(kind, degree, kx, ky),
            tconfig.BasisSpec(kind, degree, kx, ky))


_BSPL = ("bspline", 2, (30.0,), (20.0, 40.0))
_CASES = [
    # (w, kernel spec, bg spec, scaling spec or None, const_phot_ratio)
    (1, ("polynomial", 2), ("polynomial", 2), None, True),
    (2, ("polynomial", 0), ("polynomial", 1), None, True),
    (3, ("polynomial", 3), ("polynomial", 0), None, False),
    (8, ("polynomial", 2), ("polynomial", 2), None, True),
    (2, ("polynomial", 2), ("polynomial", 1), ("polynomial", 0), True),
    (2, ("polynomial", 2), ("polynomial", 1), ("polynomial", 1), True),
    (2, _BSPL, ("polynomial", 1), None, True),
    (1, _BSPL, _BSPL, ("bspline", 0), True),
    (1, _BSPL, ("polynomial", 2), ("bspline", 1, (30.0,), ()), True),
]


def _cfg_pair(w, ks, bs, ss, cpr, N0=64, N1=60):
    kj, kt = _spec_pair(*ks)
    bj, bt = _spec_pair(*bs)
    sj, st_ = _spec_pair(*ss) if ss is not None else (None, None)
    common = dict(N0=N0, N1=N1, w0=w, w1=w, const_phot_ratio=cpr)
    return (jconfig.SFFTConfig(kernel_basis=kj, bg_basis=bj, scaling_basis=sj, **common),
            tconfig.SFFTConfig(kernel_basis=kt, bg_basis=bt, scaling_basis=st_, **common))


_DERIVED = ["L0", "L1", "Fab", "Fij", "Fpq", "Fijab", "NEQ", "SCALE", "center_ab",
            "scaling_mode", "ScaFij", "NEQt", "NEQ_FSfree"]


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_derived_sizes_equal(case):
    jc, tc = _cfg_pair(*_CASES[case])
    for name in _DERIVED:
        assert getattr(tc, name) == getattr(jc, name), name
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(KerPolyOrder=1, BGPolyOrder=0, ConstPhotRatio=False),
    dict(greek_backend="peeled", fdiff_backend="fft32", solver="refined"),
    dict(mode="fast"),
    dict(mode="contract", greek_chunk=5),
    dict(dtype="float32", pexact_prof=(6, 6, 5)),
])
def test_make_config_matches(kw):
    """Defaults resolve as sfft_tpu resolves them on a CPU/GPU (fft/fft/lu,
    mode= ignored); explicit backends pass through."""
    jc = jconfig.make_config(64, 60, 3, **kw)
    tc = tconfig.make_config(64, 60, 3, **kw)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tconfig.np_dtype(tc) == jconfig.np_dtype(jc)
    assert tconfig.complex_dtype(tc) == jconfig.complex_dtype(jc)


def test_make_config_rejects_like_reference():
    for mk in (jconfig.make_config, tconfig.make_config):
        with pytest.raises(ValueError):
            mk(64, 60, 3, mode="speedy")
        with pytest.raises(ValueError):
            mk(16, 16, 4)   # image too small for the half-width
    assert tconfig.TPU_MODES == jconfig.TPU_MODES


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_config_from_fields_round_trip(case):
    jc, tc = _cfg_pair(*_CASES[case])
    d = dataclasses.asdict(jc)
    assert tconfig.config_from_fields(d) == tc
    # through JSON (tuples become lists) the config stays equal and hashable
    back = tconfig.config_from_fields(json.loads(json.dumps(d)))
    assert back == tc and hash(back) == hash(tc)
    with pytest.raises(ValueError):
        tconfig.config_from_fields({**d, "no_such_field": 1})


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_index_tables_equal(case):
    jc, tc = _cfg_pair(*_CASES[case])
    for spec_j, spec_t in [(jc.kernel_basis, tc.kernel_basis), (jc.bg_basis, tc.bg_basis)]:
        np.testing.assert_array_equal(tindices.ref_basis_exponents(spec_t),
                                      jindices.ref_basis_exponents(spec_j))
    np.testing.assert_array_equal(tindices.ref_ab(tc.w0, tc.w1), jindices.ref_ab(jc.w0, jc.w1))
    np.testing.assert_array_equal(tindices.stripe_indices(tc), jindices.stripe_indices(jc))
    for a, b in zip(tindices.ab_tables(tc), jindices.ab_tables(jc)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tindices.kernel_sum_dof_index(tc),
                                  jindices.kernel_sum_dof_index(jc))


@pytest.mark.parametrize("spec", [("polynomial", 0), ("polynomial", 1), ("polynomial", 2),
                                  ("polynomial", 3), _BSPL])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_basis_planes_equal(spec, dtype):
    import jax.numpy as jnp

    sj, st_ = _spec_pair(*spec)
    ref = np.asarray(jbasis.basis_planes(sj, 64, 60, dtype=jnp.dtype(dtype)))
    out = tbasis.basis_planes(st_, 64, 60, dtype=tconfig.torch_dtype(dtype))
    assert out.dtype == tconfig.torch_dtype(dtype) and out.shape == ref.shape
    # one rounding of a two-factor product: identical up to the last ulp
    tol = 1e-15 if dtype == "float64" else 1e-7
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)
    Uj, Vj = jbasis.basis_1d_tables(sj, 64, 60)
    Ut, Vt = tbasis.basis_1d_tables(st_, 64, 60)
    np.testing.assert_array_equal(Ut, Uj)
    np.testing.assert_array_equal(Vt, Vj)


def test_basis_planes_device_and_dtype_follow_arguments():
    spec = tconfig.BasisSpec("polynomial", 2)
    out = tbasis.basis_planes(spec, 32, 30, dtype=torch.float32, device="cpu")
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    assert out.shape == (6, 32, 30) and out.is_contiguous()
