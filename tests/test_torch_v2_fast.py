"""The v2 (B-spline) engine's fast trio in sfft_tpu_torch — greek 'fft32',
fdiff 'fft32', solver 'refined' — against sfft_tpu, on the CPU.

* greek 'fft32' (``greek_tables`` and ``greek_tables_separate``) against
  sfft_tpu's on the B-spline cases of tests/v2_cases.py: f32 tables within
  1e-5 of max|table| (the two packages' c64 FFTs round differently).
* The fast trio through GeneralSFFT.GSS, and once through
  BSplinePacket.BSP, held to sfft_tpu's f64 fft/fft/lu result: the
  difference within the fast bound (RMS < 0.05, PERF.md section 2). It is
  not held to sfft_tpu's own fft32 solve, which XLA:CPU's f32 LU leaves
  short (ROADMAP.md section 3, "Handled").
"""

from functools import partial

import numpy as np
import pytest
import torch

import sfft_tpu  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from sfft_tpu.api import bspline as jbsp
from sfft_tpu.core import engine as jengine
from sfft_tpu.core import greek as jgreek
from sfft_tpu.io import fits as jfits

from sfft_tpu_torch.api import bspline as tbsp
from sfft_tpu_torch.core import engine as tengine
from sfft_tpu_torch.core import greek as tgreek

import v2_cases

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)

FAST = dict(greek_backend="fft32", fdiff_backend="fft32", solver="refined")
BSPLINE = ["bspline_entangled", "bspline_separate_varying", "bspline_tikhonov"]
FAST_BOUND = 0.05


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(a.numpy() - b).max() / np.abs(b).max())


@pytest.mark.parametrize("case", BSPLINE)
def test_greek_fft32_tables_match_reference(case):
    I, J = v2_cases.make_pair(2)
    jc, tc = v2_cases.configs(case)
    jSI, jST, jSSc = jengine._plane_stacks(jc, jnp.asarray(I))
    SI, ST, SSc = tengine._plane_stacks(tc, torch.as_tensor(I))
    # jitted: sfft_tpu's eager op-by-op run compiles every operation anew
    ref = jax.jit(partial(jgreek.greek_tables, w0=jc.w0, w1=jc.w1, backend="fft32"))(
        jSI, jST, jnp.asarray(J))
    out = tgreek.greek_tables(SI, ST, torch.as_tensor(J), tc.w0, tc.w1, backend="fft32")
    for name, a, b in zip(["Comg", "Cgam", "Cthe", "Cphi", "Cdel"], out, ref):
        assert a.dtype == torch.float32 and tuple(a.shape) == np.asarray(b).shape, name
        assert _rel(a, b) <= 1e-5, (name, _rel(a, b))
    if SSc is not None:
        n = tc.scaling_basis.num_funcs()
        ref = jax.jit(partial(jgreek.greek_tables_separate, w0=jc.w0, w1=jc.w1,
                              backend="fft32", n_active=n))(jSI, jSSc, jST, jnp.asarray(J))
        out = tgreek.greek_tables_separate(SI, SSc, ST, torch.as_tensor(J), tc.w0, tc.w1,
                                           backend="fft32", n_active=n)
        for name, a, b in zip(["Pbs", "Pss", "Pgs", "Pts"], out, ref):
            assert a.dtype == torch.float32 and tuple(a.shape) == np.asarray(b).shape, name
            assert _rel(a, b) <= 1e-5, (name, _rel(a, b))


@pytest.mark.parametrize("case", BSPLINE)
def test_fast_trio_through_gss_within_fast_bound(case):
    I, J = v2_cases.make_pair()
    jc, _ = v2_cases.configs(case)
    _, tc = v2_cases.configs(case, **FAST)
    _, dj, _ = jengine.GeneralSFFT.GSS(I, J, I, J, jc)
    st, dt, _ = tengine.GeneralSFFT.GSS(I, J, I, J, tc, device="cpu")
    assert st.dtype == torch.float64 and bool(torch.isfinite(st).all())
    assert dt.shape == I.shape and bool(torch.isfinite(dt).all())
    rms = float(np.sqrt(np.mean((dt.numpy() - np.asarray(dj)) ** 2)))
    assert rms < FAST_BOUND, rms


def test_fast_trio_through_bsp_within_fast_bound(tmp_path):
    """The NIRCam configuration's shape at 40 x 36 (the B-spline packet's
    test configuration), FITS in and out."""
    from test_torch_bspline_api import KW

    I, J = v2_cases.make_pair(5)
    paths = []
    for name, a in [("ref", I), ("sci", J)]:
        paths.append(str(tmp_path / f"{name}.fits"))
        jfits.write(paths[-1], a.T)
    same = (paths[0], paths[1], paths[0], paths[1])
    _, dj = jbsp.BSplinePacket.BSP(*same, GKerHW=2, **KW)
    dpath = str(tmp_path / "diff.fits")
    st, dt = tbsp.BSplinePacket.BSP(*same, GKerHW=2, device="cpu", FITS_DIFF=dpath, **KW,
                                    **FAST)
    assert np.isfinite(st).all() and dt.shape == I.shape
    rms = float(np.sqrt(np.mean((dt - np.asarray(dj)) ** 2)))
    assert rms < FAST_BOUND, rms
    np.testing.assert_array_equal(jfits.getdata(dpath).T, dt)
