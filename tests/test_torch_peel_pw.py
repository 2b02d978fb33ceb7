"""The piecewise (truncated-power) peel of sfft_tpu_torch (core/peel_pw.py)
against sfft_tpu's, on the CPU.

* The numpy builders the port copies equal sfft_tpu's exactly, on the cases
  of tests/test_peel_pw.py.
* The device functions get the same inputs in both packages: pw_moment_set
  (1e-13 of max), pw_contract_basis and pw_corr (1e-11 of max, the inputs
  cross-fed from sfft_tpu's moments) at tests/test_peel_pw.py's geometries.
* peeled_pw_greek_tables on the v2 cases with fluct_dtype "float64": every
  table within 1e-10 of its max, except Comg within 1e-9. The packages part
  in the smooth fit: fit_poly_coeffs multiplies the moments by the inverse
  of a ridged, Hilbert-like Gram matrix, so the order of that small product
  and of the moment sums (MKL's against XLA's) moves the fit's coefficients
  in their 14th digit; the fluctuation moments are differences of moments
  ~30x larger, and Comg = SS + SF + FS + FF cancels terms an order of
  magnitude larger than itself, which leaves the two Comg tables several
  1e-10 of max apart.
  Matching at 1e-10 would take XLA's summation order in every f64 product.
  Both packages are also held to the f64 'fft' tables within 1e-9. With
  "float32" the fluct x fluct windows carry c64 FFT rounding: 1e-6 of max.
* pw_supported agrees with sfft_tpu's on passing and failing knot layouts;
  a failing layout raises.
* End to end, the port's peeled tables give the solution and difference of
  its f64 'fft' tables within 1e-6 of their max (the bound of
  tests/test_peel_pw.py) in the three scaling modes.

Each sfft_tpu reference is jitted once per module.
"""

from functools import partial

import numpy as np
import pytest
import torch

import sfft_tpu  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from sfft_tpu.config import BasisSpec as JB
from sfft_tpu.core import peel_pw as jp
from sfft_tpu.core.engine import _plane_stacks as jstacks
from sfft_tpu.core.greek import greek_tables as jgreek_tables

from sfft_tpu_torch.api.bspline import make_bspline_config
from sfft_tpu_torch.config import BasisSpec as TB
from sfft_tpu_torch.core import engine as tengine
from sfft_tpu_torch.core import peel_pw as tp

import v2_cases

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)


def t(a):
    return torch.as_tensor(np.array(a))


def rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    m = np.abs(ref).max()
    return float(np.abs(got - ref).max() / m) if m else float(np.abs(got).max())


# ----------------------------------------------------------- host builders


def test_host_builders_equal_reference():
    for knots, k, N in [((100.0, 180.5, 240.0), 3, 300), ((50.0,), 3, 128),
                        ((80.0,), 3, 128), ((100.0,), 2, 256), ((128.0,), 1, 256)]:
        t1, r1 = tp.bspline_axis_reps(knots, k, N)
        t2, r2 = jp.bspline_axis_reps(knots, k, N)
        assert t1 == t2 and np.array_equal(r1, r2)
    for d in range(4):
        assert all(np.array_equal(a, b) for a, b in zip(tp.poly_axis_reps(d),
                                                        jp.poly_axis_reps(d)))
    for kind, kw in [("polynomial", {}), ("bspline", dict(int_knots_x=(40.0,),
                                                          int_knots_y=(30.0, 60.0)))]:
        for axis in (0, 1):
            a = tp.basis_axis_reps(TB(kind, 2, **kw), axis, 96)
            b = jp.basis_axis_reps(JB(kind, 2, **kw), axis, 96)
            assert a[0] == b[0] and np.array_equal(a[1], b[1])
    thr, reps = jp.bspline_axis_reps((40.0,), 2, 96)
    assert np.array_equal(tp.embed_reps(reps, thr, (0, 20, 39, 70), 4),
                          jp.embed_reps(reps, thr, (0, 20, 39, 70), 4))
    for args in [(96, 3, (0, 30, 60), 4, 12), (112, 4, (0, 45, 80), 4, 12),
                 (128, 6, (0, 49), 4, 13)]:
        a, b = tp.pw_axis(*args), jp.pw_axis(*args)
        for f in jp.PWAxis._fields:
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        M = len(a.thr)
        for SG in (4, 6):
            assert np.array_equal(tp._suffix_weight_rows(a, SG), jp._suffix_weight_rows(b, SG))
            assert np.array_equal(tp._suffix_ct(a, SG, 3), jp._suffix_ct(b, SG, 3))
        assert np.array_equal(tp._sliver_mask(M, a.lags), jp._sliver_mask(M, b.lags))
        assert np.array_equal(tp._bnd_mask(M, a.lags), jp._bnd_mask(M, b.lags))
        assert np.array_equal(tp._bnd_transfer(a, 4), jp._bnd_transfer(b, 4))
        assert np.array_equal(tp._monomial_channel_reps(M, 3, 4),
                              jp._monomial_channel_reps(M, 3, 4))
    assert np.array_equal(tp._shifted_basis_reps(reps, 3), jp._shifted_basis_reps(reps, 3))


# --------------------------------------------------------- device functions

GEOM = dict(N0=96, N1=112, ax0=(96, 3, (0, 30, 60), 4, 12), ax1=(112, 4, (0, 45, 80), 4, 12),
            SG=6)
CONTRACT = dict(N=128, knots=((50.0,), (80.0,)), k=3, w=3, SPA=4)


@pytest.fixture(scope="module")
def unit_refs():
    """sfft_tpu's moment set, static channels and moments, windowed
    correlations and basis contraction on seeded inputs (one jit)."""
    rng = np.random.default_rng(11)
    G = rng.normal(1000.0, 40.0, (GEOM["N0"], GEOM["N1"]))
    ax0, ax1 = jp.pw_axis(*GEOM["ax0"]), jp.pw_axis(*GEOM["ax1"])
    M0, M1 = len(ax0.thr), len(ax1.thr)
    A2 = rng.normal(size=(3, M0, 4, M1, 4))
    rep = rng.normal(size=(2, 1, M0, 3))
    C = rng.normal(size=(2, 2))

    c = CONTRACT
    thrx, repx = jp.bspline_axis_reps(c["knots"][0], c["k"], c["N"])
    thry, repy = jp.bspline_axis_reps(c["knots"][1], c["k"], c["N"])
    SG2 = c["SPA"] + c["k"]
    cxa = (c["N"], c["w"], thrx, c["SPA"], SG2 + c["SPA"] + 2)
    cya = (c["N"], c["w"], thry, c["SPA"], SG2 + c["SPA"] + 2)
    cx, cy = jp.pw_axis(*cxa), jp.pw_axis(*cya)
    G2 = rng.normal(0.0, 1.0, (c["N"], c["N"]))
    pairs = [(0, 0), (2, 1), (1, 3)]
    RX = np.stack([repx[i] for i, _ in pairs])
    RY = np.stack([repy[j] for _, j in pairs])
    B2 = rng.normal(size=(2, len(thrx), c["SPA"], len(thry), c["SPA"]))

    @jax.jit
    def run(G, A2, rep, C, G2, B2):
        mom = jp.pw_moment_set(G, ax0, ax1, GEOM["SG"])
        ch0 = jp.pw_static_channels(rep, ax0, GEOM["SG"])
        ch1 = jp.pw_static_channels(rep[:, :, :M1], ax1, GEOM["SG"])
        smom = jp.pw_static_moments(C, ch0, ch1)
        mom2 = jp.pw_moment_set(G2, cx, cy, SG2)
        momb = jp.pw_contract_basis(mom2, RX, RY, cx, cy, c["SPA"])
        return (mom, ch0, smom, jp.pw_corr(A2, mom, ax0, ax1), mom2, momb,
                jp.pw_corr(B2, momb, cx, cy))

    out = jax.tree_util.tree_map(np.asarray, run(G, A2, rep, C, G2, B2))
    return dict(G=G, A2=A2, rep=rep, C=C, G2=G2, B2=B2, RX=RX, RY=RY, cx=cxa, cy=cya,
                SG2=SG2, out=out)


def test_pw_moment_set_matches_reference(unit_refs):
    u = unit_refs
    ax0, ax1 = tp.pw_axis(*GEOM["ax0"]), tp.pw_axis(*GEOM["ax1"])
    mom = tp.pw_moment_set(t(u["G"]), ax0, ax1, GEOM["SG"])
    for f, a, b in zip(tp.PWMoments._fields, mom, u["out"][0]):
        assert rel(a, b) <= 1e-13, f
    mom2 = tp.pw_moment_set(t(u["G2"]), tp.pw_axis(*u["cx"]), tp.pw_axis(*u["cy"]), u["SG2"])
    for f, a, b in zip(tp.PWMoments._fields, mom2, u["out"][4]):
        assert rel(a, b) <= 1e-13, f


def test_pw_static_channels_and_moments_match_reference(unit_refs):
    u = unit_refs
    ax0, ax1 = tp.pw_axis(*GEOM["ax0"]), tp.pw_axis(*GEOM["ax1"])
    M1 = len(ax1.thr)
    ch0 = tp.pw_static_channels(t(u["rep"]), ax0, GEOM["SG"])
    ch1 = tp.pw_static_channels(t(u["rep"][:, :, :M1]), ax1, GEOM["SG"])
    for a, b in zip(ch0, u["out"][1]):
        assert rel(a, b) <= 1e-14
    smom = tp.pw_static_moments(t(u["C"]), ch0, ch1)
    for f, a, b in zip(tp.PWMoments._fields, smom, u["out"][2]):
        assert rel(a, b) <= 1e-13, f


def test_pw_corr_and_contract_basis_match_reference(unit_refs):
    u = unit_refs
    ax0, ax1 = tp.pw_axis(*GEOM["ax0"]), tp.pw_axis(*GEOM["ax1"])
    cx, cy = tp.pw_axis(*u["cx"]), tp.pw_axis(*u["cy"])
    mom = tp.PWMoments(*(t(m) for m in u["out"][0]))
    assert rel(tp.pw_corr(t(u["A2"]), mom, ax0, ax1), u["out"][3]) <= 1e-11
    mom2 = tp.PWMoments(*(t(m) for m in u["out"][4]))
    momb = tp.pw_contract_basis(mom2, u["RX"], u["RY"], cx, cy, CONTRACT["SPA"])
    for f, a, b in zip(tp.PWMoments._fields, momb, u["out"][5]):
        assert rel(a, b) <= 1e-11, f
    momb_j = tp.PWMoments(*(t(m) for m in u["out"][5]))
    assert rel(tp.pw_corr(t(u["B2"]), momb_j, cx, cy), u["out"][6]) <= 1e-11


# ------------------------------------------------------------------ tables

TABLE_CASES = {"bspline_tikhonov": "float64", "bspline_separate_varying": "float32"}
NAMES = ["Comg", "Cgam", "Cthe", "Cphi", "Cdel", "Pbs", "Pss", "Pgs", "Pts"]


def _flat(out):
    return list(out[:5]) + (list(out[5]) if len(out) > 5 else [])


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_peeled_pw_tables_match_reference(case):
    fluct = TABLE_CASES[case]
    jc, tc = v2_cases.configs(case, greek_backend="peeled", fluct_dtype=fluct)
    I, J = v2_cases.make_pair(2)
    ref = jax.jit(partial(jp.peeled_pw_greek_tables, cfg=jc))(jnp.asarray(I), jnp.asarray(J))
    ref = _flat(jax.tree_util.tree_map(np.asarray, ref))
    got = _flat(tp.peeled_pw_greek_tables(t(I), t(J), tc))
    plain = _flat(tp.peeled_pw_greek_tables(t(I), t(J), tc, plain=True))
    assert len(got) == len(ref) == 9
    for name, a, b, p in zip(NAMES, got, ref, plain):
        assert a.dtype == torch.float64 and torch.equal(a, p), name
        tol = 1e-6 if fluct == "float32" else (1e-9 if name == "Comg" else 1e-10)
        assert rel(a, b) <= tol, (name, rel(a, b))
    if fluct == "float64":
        # both packages against the f64 'fft' tables of the same pair
        SI, ST, _ = jstacks(jc, jnp.asarray(I))
        truth = jax.jit(partial(jgreek_tables, w0=jc.w0, w1=jc.w1, backend="fft"))(
            SI, ST, jnp.asarray(J))
        for name, a, b, tr in zip(NAMES, got, ref, truth):
            assert rel(a, tr) <= 1e-9 and rel(b, tr) <= 1e-9, name


def test_pw_supported_agrees_and_failing_layouts_raise():
    base = dict(KerSpType="B-Spline", KerSpDegree=2, BkgSpType="B-Spline", BkgSpDegree=1,
                SEPARATE_SCALING=False)
    layouts = {  # (x knots, y knots): supported at 96^2, GKerHW = 2 (W = 4)?
        ((40.0,), (48.0,)): True,
        ((30.0, 60.0), (48.0,)): True,
        ((6.0,), (48.0,)): False,          # too close to the edge
        ((40.0, 45.0), (48.0,)): False,    # knots closer than 2W
    }
    from sfft_tpu.api.bspline import make_bspline_config as jmake

    for (kx, ky), ok in layouts.items():
        kw = dict(base, KerIntKnotX=list(kx), KerIntKnotY=list(ky), BkgIntKnotX=list(kx),
                  BkgIntKnotY=list(ky))
        tc = make_bspline_config(96, 96, 2, greek_backend="peeled", **kw)
        jc = jmake(96, 96, 2, greek_backend="peeled", **kw)
        assert tp.pw_supported(tc) == jp.pw_supported(jc) == ok, (kx, ky)
        if not ok:
            with pytest.raises(ValueError):
                tp.peeled_pw_greek_tables(torch.zeros((96, 96), dtype=torch.float64),
                                          torch.zeros((96, 96), dtype=torch.float64), tc)


# -------------------------------------------------------------- end to end


@pytest.mark.parametrize("mode_kw", [
    dict(SEPARATE_SCALING=False),
    dict(SEPARATE_SCALING=True, ScaSpType="Polynomial", ScaSpDegree=0),
    dict(SEPARATE_SCALING=True, ScaSpType="B-Spline", ScaSpDegree=1,
         ScaIntKnotX=[40.0], ScaIntKnotY=[48.0]),
], ids=["entangled", "sep-const", "sep-varying"])
def test_peeled_equals_fft_end_to_end(mode_kw):
    """tests/test_peel_pw.py's parity at 96^2: B-spline kernel and
    background bases, the peeled tables (fluct f64) against the f64 'fft'
    tables, both solved by LU."""
    from scipy import ndimage as ndi

    rng = np.random.default_rng(3)
    N = 96
    base = rng.normal(1000.0, 30.0, (N, N))
    I = base + rng.normal(0, 5.0, (N, N))
    J = (ndi.gaussian_filter(base, 1.0, mode="wrap") * 1.03 + 5.0
         + rng.normal(0, 5.0, (N, N)))

    def run(greek):
        cfg = make_bspline_config(
            N, N, GKerHW=2, KerSpType="B-Spline", KerSpDegree=2,
            KerIntKnotX=[40.0], KerIntKnotY=[48.0], BkgSpType="B-Spline", BkgSpDegree=2,
            BkgIntKnotX=[40.0], BkgIntKnotY=[48.0], greek_backend=greek,
            fdiff_backend="fft", solver="lu", fluct_dtype="float64", **mode_kw)
        assert greek != "peeled" or tp.pw_supported(cfg)
        sol, diff = tengine.solve_and_subtract_same_fn(cfg)(t(I), t(J))
        return sol.numpy(), diff.numpy()

    s_ref, d_ref = run("fft")
    s_pw, d_pw = run("peeled")
    assert np.abs(s_pw - s_ref).max() / np.abs(s_ref).max() < 1e-6
    assert np.abs(d_pw - d_ref).max() / np.abs(d_ref).max() < 1e-6
