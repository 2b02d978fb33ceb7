"""The B-spline packet of sfft_tpu_torch (api/bspline.py, post/solution.py)
against sfft_tpu's: FITS in, FITS out.

Both packages read the same FITS files (written from a seeded numpy pair)
and run on the CPU (device="cpu" for the port). Bounds: solution within 1e-6
of its maximum and difference within 1e-8 of max|J| (the f64 bounds of
tests/test_engine.py); realized kernels within 1e-12. A solution FITS
written by either package must read back in the other.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sfft_tpu  # noqa: F401  (x64)
from sfft_tpu.api import bspline as jbsp
from sfft_tpu.io import fits as jfits
from sfft_tpu.post import solution as jsolution

import sfft_tpu_torch
from sfft_tpu_torch.api import bspline as tbsp
from sfft_tpu_torch.core import solve as tsolve
from sfft_tpu_torch.post import solution as tsolution

import v2_cases

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)

N0, N1 = v2_cases.N0, v2_cases.N1
# the NIRCam configuration's shape at a small size: degree-2 B-spline kernel
# with internal knots, SEPARATE-VARYING degree-2 polynomial scaling, degree-0
# background, Tikhonov regularization on seeded points
KW = dict(
    KerSpType="B-Spline", KerSpDegree=2, KerIntKnotX=[0.5 + N0 / 2], KerIntKnotY=[0.5 + N1 / 2],
    SEPARATE_SCALING=True, ScaSpType="Polynomial", ScaSpDegree=2,
    BkgSpType="Polynomial", BkgSpDegree=0,
    REGULARIZE_KERNEL=True, XY_REGULARIZE=np.array(v2_cases.reg_points()),
    LAMBDA_REGULARIZE=3e-5)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bsp")
    I, J = v2_cases.make_pair(5)
    paths = {}
    for name, a in [("ref", I), ("sci", J)]:
        holed = a.copy()
        holed[7:9, 11:13] = np.nan
        for tag, arr in [(name, holed), ("m" + name, a)]:
            paths[tag] = str(d / f"{tag}.fits")
            jfits.write(paths[tag], arr.T)
    paths["dir"] = d
    return paths


def _args(f):
    return f["ref"], f["sci"], f["mref"], f["msci"]


def test_make_bspline_config_matches_reference():
    jc = jbsp.make_bspline_config(N0, N1, 2, **KW)
    tc = tbsp.make_bspline_config(N0, N1, 2, **KW)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.greek_backend, tc.fdiff_backend, tc.solver) == ("fft", "fft", "lu")
    assert tc.scaling_mode == "SEPARATE-VARYING" and tc.NEQ == 16 * 25 + 1
    ec = tbsp.make_bspline_config(N0, N1, 2, **KW, greek_backend="exact",
                                  fdiff_backend="exact", solver="exact")
    assert (ec.greek_backend, ec.fdiff_backend, ec.solver) == ("exact",) * 3
    with pytest.raises(ValueError):
        tbsp.make_bspline_config(N0, N1, 2, KerSpDegree=0, ScaSpDegree=2)
    with pytest.raises(ValueError):
        tbsp.make_bspline_config(N0, N1, 2, REGULARIZE_KERNEL=True)
    with pytest.warns(UserWarning):
        tbsp.make_bspline_config(400, 400, 9, KerSpType="B-Spline", KerSpDegree=2,
                                 KerIntKnotX=[100.5, 200.5, 300.5],
                                 KerIntKnotY=[100.5, 200.5, 300.5], solver="exact")


@pytest.mark.parametrize("force", ["REF", "SCI"])
def test_bsp_fits_in_fits_out_matches_reference(files, force):
    d = files["dir"]
    out = {}
    for tag, mod, extra in [("j", jbsp, {}), ("t", tbsp, dict(device="cpu"))]:
        sol, diff = mod.BSplinePacket.BSP(
            *_args(files), FITS_DIFF=str(d / f"diff_{tag}_{force}.fits"),
            FITS_Solution=str(d / f"sol_{tag}_{force}.fits"), ForceConv=force, GKerHW=2,
            **KW, **extra)
        out[tag] = (np.asarray(sol), np.asarray(diff))
    (sj, dj), (st, dt) = out["j"], out["t"]
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6 * np.abs(sj).max())
    hole = np.isnan(dj)
    assert hole.sum() == 4 and np.array_equal(np.isnan(dt), hole)
    np.testing.assert_allclose(dt[~hole], dj[~hole], rtol=0, atol=1e-8 * 2000.0)
    # the files: each package reads the other's solution and difference
    for writer in ("j", "t"):
        path = str(d / f"sol_{writer}_{force}.fits")
        s_j, c_j = jbsp.read_bspline_solution_fits(path)
        s_t, c_t = tbsp.read_bspline_solution_fits(path)
        np.testing.assert_array_equal(s_t, s_j)
        np.testing.assert_array_equal(s_t, out[writer][0])
        assert dataclasses.asdict(c_t) == dataclasses.asdict(c_j)
        assert c_t.kernel_basis.int_knots_x == (0.5 + N0 / 2,)
    dfits = sfft_tpu_torch.io.fits.getdata(str(d / f"diff_t_{force}.fits")).T
    np.testing.assert_array_equal(np.isnan(dfits), hole)
    np.testing.assert_array_equal(dfits[~hole], dt[~hole])
    _, hdr = sfft_tpu_torch.io.fits.read(str(d / f"diff_t_{force}.fits"))
    assert str(hdr["CONVD"]).strip() == force and int(hdr["KERHW"]) == 2


def test_bsp_exact_trio_matches_reference_and_walks_sliced_solve(files, monkeypatch):
    """The contract trio through BSP, masked == unmasked (one shared pass of
    plane spectra), with the size gate of the large-system solve lowered so
    the path runs _refined_solve_f64's sliced route on the CPU. plain=True
    reaches the solve too; that routing is checked on the f64 fft tables
    (the same solve, without the exact engine's tables), where both runs
    are the plain twins on the CPU."""
    trio = dict(greek_backend="exact", fdiff_backend="exact", solver="exact")
    same = (files["mref"], files["msci"], files["mref"], files["msci"])
    sj, dj = jbsp.BSplinePacket.BSP(*same, GKerHW=2, **KW, **trio)
    calls = []
    real = tsolve._refined_solve_f64
    monkeypatch.setattr(tsolve, "_refined_solve_f64",
                        lambda A, b, **kw: calls.append(kw) or real(A, b, **kw))
    monkeypatch.setattr(tsolve, "LARGE_NEQ", 64)
    st, dt = tbsp.BSplinePacket.BSP(*same, GKerHW=2, device="cpu", **KW, **trio)
    assert calls == [dict(plain=False)]
    cheap = dict(trio, greek_backend="fft", fdiff_backend="fft")
    sc, dc = tbsp.BSplinePacket.BSP(*same, GKerHW=2, device="cpu", **KW, **cheap)
    sp, dp = tbsp.BSplinePacket.BSP(*same, GKerHW=2, device="cpu", plain=True, **KW, **cheap)
    assert calls[1:] == [dict(plain=False), dict(plain=True)]
    np.testing.assert_array_equal(sp, sc)       # on the CPU both are the plain twins
    np.testing.assert_array_equal(dp, dc)
    sj, dj = np.asarray(sj), np.asarray(dj)
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6 * np.abs(sj).max())
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-8 * 2000.0)


def test_bsp_refusals(files):
    with pytest.raises(ValueError):
        tbsp.BSplinePacket.BSP(*_args(files), ForceConv="AUTO", GKerHW=2, device="cpu")
    with pytest.raises(ValueError):      # NaN in a masked image
        tbsp.BSplinePacket.BSP(files["ref"], files["sci"], files["ref"], files["sci"],
                               GKerHW=2, device="cpu")


@pytest.mark.parametrize("mode", ["entangled", "separate_constant", "separate_varying"])
def test_bspline_matching_kernel_matches_reference(files, mode):
    kw = dict(KerSpType="B-Spline", KerSpDegree=2, KerIntKnotX=[20.5], KerIntKnotY=[18.5],
              BkgSpDegree=1)
    kw.update({"entangled": dict(SEPARATE_SCALING=False),
               "separate_constant": dict(ScaSpDegree=0),
               "separate_varying": dict(ScaSpDegree=1)}[mode])
    jc = jbsp.make_bspline_config(N0, N1, 2, **kw)
    tc = tbsp.make_bspline_config(N0, N1, 2, **kw)
    rng = np.random.default_rng(6)
    sol = rng.normal(size=tc.NEQ)
    XY = rng.uniform(2.0, 34.0, size=(9, 2))
    ref = jbsp.BSplineMatchingKernel(XY).from_solution(sol, jc)
    out = tbsp.BSplineMatchingKernel(XY).from_solution(sol, tc)
    assert out.shape == (9, 5, 5)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    path = str(files["dir"] / f"mk_{mode}.fits")
    tbsp.write_bspline_solution_fits(path, sol, tc)
    np.testing.assert_allclose(jbsp.BSplineMatchingKernel(XY).from_fits(path), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    np.testing.assert_array_equal(tbsp.BSplineMatchingKernel(XY).from_fits(path), out)


def test_post_solution_matches_reference(files):
    """The copied readers: delta <-> standard basis, kernel and flux-scaling
    realization, and the polynomial solution FITS across both packages."""
    from sfft_tpu_torch.api.customized import write_solution_fits

    tc = sfft_tpu_torch.make_config(N0, N1, 2)
    jc = sfft_tpu.make_config(N0, N1, 2)
    rng = np.random.default_rng(7)
    sol = rng.normal(size=tc.NEQ)
    c = rng.normal(size=(3, 5, 5))
    np.testing.assert_array_equal(tsolution.sfft2standard(c, 2, 2),
                                  jsolution.sfft2standard(c, 2, 2))
    np.testing.assert_array_equal(tsolution.standard2sfft(c, 2, 2),
                                  jsolution.standard2sfft(c, 2, 2))
    np.testing.assert_allclose(
        tsolution.standard2sfft(tsolution.sfft2standard(c, 2, 2), 2, 2), c, atol=1e-13)
    XY = rng.uniform(2.0, 34.0, size=(5, 2))
    for name in ("RealizeMatchingKernel", "RealizeFluxScaling"):
        ref = getattr(jsolution, name)(XY).from_solution(sol, jc)
        out = getattr(tsolution, name)(XY).from_solution(sol, tc)
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    path = str(files["dir"] / "poly_solution.fits")
    write_solution_fits(path, sol, tc)
    s_t, c_t = tsolution.read_solution_fits(path)
    s_j, c_j = jsolution.read_solution_fits(path)
    np.testing.assert_array_equal(s_t, s_j)
    assert dataclasses.asdict(c_t) == dataclasses.asdict(c_j)
    d_t = tsolution.sfft_dict_from_solution(sol, tc)
    d_j = jsolution.sfft_dict_from_solution(sol, jc)
    assert sorted(d_t) == sorted(d_j)
    for k in d_t:
        np.testing.assert_array_equal(d_t[k], d_j[k])
