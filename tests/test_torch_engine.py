"""sfft_tpu_torch assembly, solve, difference, engine and packets against
sfft_tpu and the dense-LSQ oracle (tests/oracle.py).

Inputs are made from seeds with numpy and fed to both packages; states cross
as numpy arrays (the solution vector, in both directions). Bounds follow
the reference's own: solution rtol 1e-6 / atol 1e-7 * max and difference
atol 1e-8 * max|J| for the f64 paths (tests/test_engine.py:56-58,
tests/test_peel.py:70).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sfft_tpu  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from sfft_tpu.config import BasisSpec as JB, SFFTConfig as JC, make_config as jmake
from sfft_tpu.core import engine as jengine
from sfft_tpu.core import solve as jsolve

import sfft_tpu_torch
from sfft_tpu_torch.config import config_from_fields
from sfft_tpu_torch.core import assemble as tassemble
from sfft_tpu_torch.core import engine as tengine
from sfft_tpu_torch.core import solve as tsolve

import test_engine
from oracle import design_matrix, model_image, solve_oracle

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_pair(seed, N0=24, N1=20):
    """tests/test_engine.py's pair (gaussian sources + smooth background,
    J a scaled copy with noise) from its own seed."""
    return test_engine.make_pair(np.random.default_rng(seed), N0, N1)


def make_bench_pair(n, seed=0, k=40):
    """The 4096^2 benchmark pair's generator (bench.py make_pair) at a small
    size: smooth sky, k point sources, J = 1.1 I + 5 + noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    I = 200.0 * (1.0 + 0.2 * xx / n + 0.3 * (yy / n) ** 2)
    xs = rng.integers(4, n - 4, k)
    ys = rng.integers(4, n - 4, k)
    amps = rng.uniform(100, 2000, k)
    psf = np.outer([0.1, 0.5, 1.0, 0.5, 0.1], [0.1, 0.5, 1.0, 0.5, 0.1])
    for x, y, a in zip(xs, ys, amps):
        I[x - 2 : x + 3, y - 2 : y + 3] += a * psf
    J = 1.1 * I + 5.0 + rng.normal(0, 1.0, (n, n))
    I = I + rng.normal(0, 1.0, (n, n))
    return I, J


def cfgs(N0=24, N1=20, w=1, DK=2, DB=2, cpr=True, **kw):
    jc = JC(N0=N0, N1=N1, w0=w, w1=w, kernel_basis=JB("polynomial", DK),
            bg_basis=JB("polynomial", DB), const_phot_ratio=cpr, **kw)
    return jc, config_from_fields(dataclasses.asdict(jc))


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("w,cpr", [(1, True), (2, False)])
def test_assemble_system_matches_reference_and_oracle(w, cpr):
    I, J = make_pair(1)
    jc, tc = cfgs(w=w, cpr=cpr)
    lhs_j, rhs_j = jax.jit(jengine.normal_equations_fn(jc))(jnp.asarray(I), jnp.asarray(J))
    lhs_t, rhs_t = tengine.normal_equations_fn(tc)(t(I), t(J))
    lhs_j, rhs_j = np.asarray(lhs_j), np.asarray(rhs_j)
    assert lhs_t.dtype == torch.float64 and tuple(lhs_t.shape) == (tc.NEQ, tc.NEQ)
    np.testing.assert_allclose(lhs_t.numpy(), lhs_j, rtol=0, atol=1e-10 * np.abs(lhs_j).max())
    np.testing.assert_allclose(rhs_t.numpy(), rhs_j, rtol=0, atol=1e-10 * np.abs(rhs_j).max())
    # the oracle's explicit design matrix: LH = SCALE X^T X, RH = SCALE X^T J
    # (the reference's Pre-table normalization)
    X = design_matrix(I, 24, 20, w, w, 2, 2)
    np.testing.assert_allclose(lhs_t.numpy(), tc.SCALE * (X.T @ X), rtol=0,
                               atol=1e-10 * np.abs(lhs_j).max())
    np.testing.assert_allclose(rhs_t.numpy(), tc.SCALE * (X.T @ J.ravel()), rtol=0,
                               atol=1e-10 * np.abs(rhs_j).max())


def test_assemble_chunked_omg_equals_unchunked():
    """The row-chunked OMG build (taken when out_dtype narrows the system,
    or at Fij*Fab >= 8192) gives the same system."""
    I, J = make_pair(2, N0=32, N1=32)
    _, tc = cfgs(N0=32, N1=32, w=4)
    from sfft_tpu_torch.core.greek import greek_tables

    SI, ST, _ = tengine._plane_stacks(tc, t(I))
    s = tc.SCALE
    C = greek_tables(SI, ST, t(J), 4, 4)
    tab = tassemble.entangled_tables(tc, s**3 * C[0], s**2 * C[1], s**2 * C[2],
                                     s * C[3], s * C[4])
    full, rhs = tassemble.assemble_system(tc, tab)
    narrow, rhs32 = tassemble.assemble_system(tc, tab, out_dtype=torch.float32)
    assert narrow.dtype == torch.float32 and tassemble._omg_chunk(tc.Fab) < tc.Fab
    np.testing.assert_allclose(narrow.numpy(), full.numpy().astype(np.float32), rtol=1e-6,
                               atol=1e-6 * float(full.abs().max()))
    np.testing.assert_allclose(rhs32.numpy(), rhs.numpy().astype(np.float32), rtol=1e-6)


@pytest.mark.parametrize("solver", ["lu", "cho", "refined"])
def test_solve_system_matches_reference(solver):
    """Both packages solve sfft_tpu's assembled system (cross-fed as numpy).
    lu / cho: two f64 factorizations, ~cond*eps64 apart. refined: f32 LU +
    3 f64-residual refinements in two LAPACKs; this well-conditioned pair
    converges both to the f64 solution."""
    I, J = make_pair(3)
    jc, tc = cfgs(solver=solver)
    lhs, rhs = jax.jit(jengine.normal_equations_fn(jc))(jnp.asarray(I), jnp.asarray(J))
    ref = np.asarray(jax.jit(lambda a, b: jsolve.solve_system(jc, a, b))(lhs, rhs))
    out = tsolve.solve_system(tc, t(lhs), t(rhs)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-8 * np.abs(ref).max())
    removed = np.setdiff1d(np.arange(tc.NEQ), tsolve._tweak_plan(tc)[0])
    assert np.all(out[removed] == 0.0)


def test_solve_tweak_helpers_match_reference():
    for kw in [dict(), dict(cpr=False),
               dict(DB=1, scaling_basis=JB("polynomial", 0)),
               dict(DB=1, scaling_basis=JB("polynomial", 1))]:
        jc, tc = cfgs(w=2, **kw)
        pj, aj, ij = jsolve._tweak_plan(jc)
        pt, at, it = tsolve._tweak_plan(tc)
        assert (pj is None) == (pt is None) and aj == at
        np.testing.assert_array_equal(it, ij)
        if pj is not None:
            np.testing.assert_array_equal(pt, pj)
            assert tsolve._contig_segments(pt) == jsolve._contig_segments(pj)
            M = np.arange(tc.NEQ ** 2, dtype=np.float64).reshape(tc.NEQ, tc.NEQ)
            np.testing.assert_array_equal(tsolve._select_rows_cols(t(M), pt).numpy(),
                                          M[np.ix_(pt, pt)])


@pytest.mark.parametrize("fdiff", ["fft", "fft32"])
def test_difference_with_cross_fed_solution(fdiff):
    """The port's difference from sfft_tpu's solution equals sfft_tpu's
    difference: 1e-8 * max|J| in f64; fft32 carries c64 FFT rounding of
    the ~2e3-sized spectra in both packages (2e-6 * max|J|)."""
    I, J = make_pair(4)
    jc, tc = cfgs(w=2, fdiff_backend=fdiff)
    sol, dj = jengine.ElementalSFFT.ESS(I, J, jc, Subtract=True)
    _, dt = tengine.ElementalSFFT.ESS(I, J, tc, SFFTSolution=np.asarray(sol), Subtract=True,
                                     device="cpu")
    bound = 1e-8 if fdiff == "fft" else 2e-6
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                               atol=bound * np.abs(J).max())


@pytest.mark.parametrize("greek", ["fft", "peeled"])
def test_ess_f64_matches_reference_and_oracle(greek):
    I, J = make_pair(5, N0=48, N1=40)
    jc, tc = cfgs(N0=48, N1=40, w=2, greek_backend=greek, fluct_dtype="float64")
    sj, dj = jengine.ElementalSFFT.ESS(I, J, jc, Subtract=True)
    st_, dt = tengine.ElementalSFFT.ESS(I, J, tc, Subtract=True, device="cpu")
    sj, dj = np.asarray(sj), np.asarray(dj)
    assert st_.dtype == torch.float64 and dt.dtype == torch.float64
    np.testing.assert_allclose(st_.numpy(), sj, rtol=1e-6, atol=1e-7 * np.abs(sj).max())
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=1e-8 * np.abs(J).max())
    so = solve_oracle(I, J, 2, 2, 2, 2)
    np.testing.assert_allclose(st_.numpy(), so, rtol=1e-6, atol=1e-7 * np.abs(so).max())
    np.testing.assert_allclose(dt.numpy(), J - model_image(I, so, 2, 2), rtol=0,
                               atol=1e-8 * np.abs(J).max())


def test_gss_masked_matches_reference():
    I, J = make_pair(6)
    mI, mJ = I.copy(), J.copy()
    mI[5:8, 5:8] = 0.0
    mJ[5:8, 5:8] = 0.0
    jc, tc = cfgs()
    sj, dj, cj = jengine.GeneralSFFT.GSS(I, J, mI, mJ, jc)
    st_, dt, ct = tengine.GeneralSFFT.GSS(I, J, mI, mJ, tc, device="cpu")
    assert cj is None and ct is None
    sj = np.asarray(sj)
    np.testing.assert_allclose(st_.numpy(), sj, rtol=1e-6, atol=1e-7 * np.abs(sj).max())
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-8 * np.abs(J).max())
    # masked == unmasked (same objects) takes the two-input step; same result
    # as distinct equal arrays
    s1, d1, _ = tengine.GeneralSFFT.GSS(I, J, I, J, tc, device="cpu")
    s2, d2, _ = tengine.GeneralSFFT.GSS(I, J, I.copy(), J.copy(), tc, device="cpu")
    np.testing.assert_array_equal(s1.numpy(), s2.numpy())
    np.testing.assert_array_equal(d1.numpy(), d2.numpy())


def test_contamination_mask_matches_reference():
    I, J = make_pair(7)
    contam = np.zeros(I.shape, dtype=bool)
    contam[10:13, 10:13] = True
    jc, tc = cfgs()
    _, _, cj = jengine.GeneralSFFT.GSS(I, J, I, J, jc, ContamMask_I=contam)
    _, _, ct = tengine.GeneralSFFT.GSS(I, J, I, J, tc, ContamMask_I=contam, device="cpu")
    assert ct.dtype == torch.bool
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert ct.numpy().sum() >= contam.sum()


def test_separate_varying_ess_matches_reference():
    I, J = make_pair(8, N0=48, N1=40)
    jc, tc = cfgs(N0=48, N1=40, w=2, DB=1, greek_backend="peeled", fluct_dtype="float64",
                  scaling_basis=JB("polynomial", 1))
    sj, dj = jengine.ElementalSFFT.ESS(I, J, jc, Subtract=True)
    st_, dt = tengine.ElementalSFFT.ESS(I, J, tc, Subtract=True, device="cpu")
    sj = np.asarray(sj)
    np.testing.assert_allclose(st_.numpy(), sj, rtol=1e-6, atol=1e-7 * np.abs(sj).max())
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-8 * np.abs(J).max())


def test_fast_mode_matches_reference():
    """The fast backends (peeled tables with c64 fluctuation FFTs, fft32
    difference, f32-LU refined solve) in both packages, on a 128^2 pair:
    the c64 FFTs of two libraries and two f32 LUs differ at the f32 level,
    which the ill-conditioned solve amplifies. Measured spread on this pair:
    solution 3.0e-3 max-rel, difference RMS 9.2e-4; bounds 3e-2 and 0.05
    (tests/test_peel.py:86)."""
    from test_torch_peel import make_pair as peel_pair

    I, J = peel_pair(3, 128, 128, 200.0)
    jc, tc = cfgs(N0=128, N1=128, w=2, greek_backend="peeled", fdiff_backend="fft32",
                  solver="refined")
    sj, dj = jengine.ElementalSFFT.ESS(I, J, jc, Subtract=True)
    st_, dt = tengine.ElementalSFFT.ESS(I, J, tc, Subtract=True, device="cpu")
    sj, dj = np.asarray(sj), np.asarray(dj)
    assert np.abs(st_.numpy() - sj).max() <= 3e-2 * np.abs(sj).max()
    assert np.sqrt(np.mean((dt.numpy() - dj) ** 2)) < 0.05


def test_fast_slice_config_matches_f64_path():
    """The slice's configuration (KerHW=8, poly2/poly2, peeled / fft32 /
    refined, as bench.py's cfg_fast) on the benchmark pair's generator at
    128^2, through PCP, against the port's own f64 fft/fft/lu path: the
    difference agrees to < 0.05 RMS (30x below the unit pixel noise).
    sfft_tpu's fast config is not the yardstick here: at KerHW=8 its
    XLA:CPU f32 LU leaves the refinement short of the f64 solution (up to
    0.47 RMS measured on this generator), while LAPACK's f32 LU converges."""
    I, J = make_bench_pair(128, seed=0)
    fast = sfft_tpu_torch.make_config(128, 128, 8, greek_backend="peeled",
                                      fdiff_backend="fft32", solver="refined")
    assert fast.NEQ == 6 * 17 ** 2 + 6 and fast.fluct_dtype == "float32"
    P = sfft_tpu_torch.PureTorchCustomizedPacket
    s_fast, d_fast = P.PCP(I, J, I, J, "REF", 8, cfg=fast, device="cpu")
    s_64, d_64 = P.PCP(I, J, I, J, "REF", 8, plain=True, device="cpu")
    assert torch.isfinite(s_fast).all() and torch.isfinite(d_fast).all()
    assert float(torch.sqrt(torch.mean((d_fast - d_64) ** 2))) < 0.05
    c = slice(32, 96)
    rms = float(torch.sqrt(torch.mean(d_fast[c, c] ** 2)))
    assert 1.3 <= rms <= 1.7, rms   # sqrt(1 + 1.1^2) of the pair's noise


def test_pcp_forceconv_sci_sign_and_nan():
    P = sfft_tpu_torch.PureTorchCustomizedPacket
    A, B = make_pair(9)
    mA, mB = A.copy(), B.copy()
    A[3, 4] = np.nan
    s_sci, d_sci = P.PCP(A, B, mA, mB, "SCI", 1, device="cpu")
    s_ref, d_ref = P.PCP(B, A, mB, mA, "REF", 1, device="cpu")
    np.testing.assert_array_equal(s_sci.numpy(), s_ref.numpy())
    d1, d2 = d_sci.numpy(), d_ref.numpy()
    assert np.isnan(d1[3, 4]) and np.isnan(d2[3, 4])
    mask = ~np.isnan(d1)
    np.testing.assert_array_equal(mask, ~np.isnan(d2))
    np.testing.assert_array_equal(d1[mask], -d2[mask])
    from sfft_tpu.api.customized import PureJAXCustomizedPacket as JP

    sj, dj = JP.PCP(A, B, mA, mB, "SCI", 1)
    sj, dj = np.asarray(sj), np.asarray(dj)
    np.testing.assert_allclose(s_sci.numpy(), sj, rtol=1e-6, atol=1e-7 * np.abs(sj).max())
    np.testing.assert_array_equal(np.isnan(d1), np.isnan(dj))
    np.testing.assert_allclose(d1[mask], dj[mask], rtol=0, atol=1e-8 * np.nanmax(np.abs(B)))
    with pytest.raises(ValueError):
        P.PCP(A, B, mA, mB, "AUTO", 1, device="cpu")


def test_cp_golden_sparse_matches_reference(tmp_path):
    from sfft_tpu.api.customized import CustomizedPacket as JCP
    from sfft_tpu_torch.io import fits

    paths = {}
    for name in ("ref", "sci"):
        src = os.path.join(DATA, f"golden_sparse_{name}.fits")
        img, _ = fits.read(src)
        paths[name] = src
        paths["m" + name] = str(tmp_path / f"m{name}.fits")
        fits.write(paths["m" + name], np.nan_to_num(img, nan=0.0).astype(np.float64))
    args = (paths["ref"], paths["sci"], paths["mref"], paths["msci"], "REF", 3)
    sj, dj = JCP.CP(*args, FITS_DIFF=str(tmp_path / "dj.fits"),
                    FITS_Solution=str(tmp_path / "sj.fits"))
    st_, dt = sfft_tpu_torch.CustomizedPacket.CP(*args, FITS_DIFF=str(tmp_path / "dt.fits"),
                                                 FITS_Solution=str(tmp_path / "st.fits"),
                                                 device="cpu")
    assert isinstance(st_, np.ndarray) and isinstance(dt, np.ndarray)
    np.testing.assert_allclose(st_, sj, rtol=1e-6, atol=1e-7 * np.abs(sj).max())
    ref_img, _ = fits.read(paths["sci"])
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-8 * np.nanmax(np.abs(ref_img)))
    for a, b in [("dt", "dj"), ("st", "sj")]:
        da, ha = fits.read(str(tmp_path / f"{a}.fits"))
        db, hb = fits.read(str(tmp_path / f"{b}.fits"))
        assert list(ha.cards) == list(hb.cards)
        assert da.shape == db.shape


def test_unported_backends_raise():
    """Every backend of sfft_tpu is ported: only unknown names raise. greek
    'fft32' and 'corr', greek and fdiff 'exact', fdiff 'conv', lambda > 0
    and the solvers 'blocked_cho' and 'host' run (held to sfft_tpu in
    test_torch_v2_fast.py, test_torch_v2_exact.py, test_torch_v2_engine.py,
    test_torch_solve_f64.py and test_torch_corr_conv.py)."""
    I, J = make_pair(10)
    for kw in [dict(greek_backend="nope"), dict(fdiff_backend="nope")]:
        _, tc = cfgs(**kw)
        with pytest.raises(ValueError):
            tengine.ElementalSFFT.ESS(I, J, tc, Subtract=True, device="cpu")
    for kw in [dict(greek_backend="exact", fdiff_backend="exact", regularize_lambda=0.1,
                    reg_xy=((5.0, 5.0),)), dict(greek_backend="fft32"),
               dict(solver="blocked_cho"), dict(solver="host"),
               dict(greek_backend="corr"), dict(fdiff_backend="conv")]:
        _, tc = cfgs(**kw)
        sol, diff = tengine.ElementalSFFT.ESS(I, J, tc, Subtract=True, device="cpu")
        assert bool(torch.isfinite(sol).all()) and bool(torch.isfinite(diff).all())


def test_standard_kernel_coeffs_match_reference():
    from sfft_tpu.core.fdiff import standard_kernel_coeffs as jstd
    from sfft_tpu_torch.core.fdiff import standard_kernel_coeffs as tstd

    jc, tc = cfgs(w=2)
    a = np.random.default_rng(12).normal(0, 1, (tc.Fij, tc.L0, tc.L1))
    np.testing.assert_allclose(tstd(tc, t(a)).numpy(), np.asarray(jstd(jc, jnp.asarray(a))),
                               rtol=1e-15, atol=1e-15)


def test_make_config_resolution_matches_reference():
    assert dataclasses.asdict(sfft_tpu_torch.make_config(24, 20, 1, mode="fast")) == \
        dataclasses.asdict(jmake(24, 20, 1, mode="fast"))


def test_import_leaves_jax_out():
    code = ("import sys, sfft_tpu_torch, sfft_tpu_torch.core.peel, sfft_tpu_torch._kernels, "
            "sfft_tpu_torch.core.exact_fft, sfft_tpu_torch.core.pairs, "
            "sfft_tpu_torch.core.slicing, "
            "sfft_tpu_torch.core.pexact, sfft_tpu_torch.core.solve, "
            "sfft_tpu_torch.core.regularize, sfft_tpu_torch.api.bspline, "
            "sfft_tpu_torch.core.peel_pw, sfft_tpu_torch.core.fdiff, "
            "sfft_tpu_torch.post.solution, sfft_tpu_torch.post.fftkits, "
            "sfft_tpu_torch.post.decorrelation, sfft_tpu_torch.post.grid_convolve, "
            "sfft_tpu_torch.io.fits, sfft_tpu_torch.native, sfft_tpu_torch.utils.table, "
            "sfft_tpu_torch.utils.quantile, sfft_tpu_torch.utils.match, "
            "sfft_tpu_torch.utils.hough, sfft_tpu_torch.utils.canny, "
            "sfft_tpu_torch.prep.background, sfft_tpu_torch.prep.extract, "
            "sfft_tpu_torch.prep.sex, sfft_tpu_torch.prep.morph_classifier, "
            "sfft_tpu_torch.prep.sparse_prep, sfft_tpu_torch.prep.crowded_prep, "
            "sfft_tpu_torch.prep.sky_subtract, sfft_tpu_torch.api.easy_sparse, "
            "sfft_tpu_torch.api.easy_crowded, sfft_tpu_torch.utils.multiproc, "
            "sfft_tpu_torch.parallel.batch, sfft_tpu_torch.parallel.scheduler, "
            "sfft_tpu_torch.parallel.sharded_fft, sfft_tpu_torch.parallel.multihost, "
            "sfft_tpu_torch.serve, sfft_tpu_torch.utils.convolve, sfft_tpu_torch.utils.sky, "
            "sfft_tpu_torch.utils.wcs, sfft_tpu_torch.utils.stamp, sfft_tpu_torch.utils.pack, "
            "sfft_tpu_torch.utils.profiling, sfft_tpu_torch.prep.resample; "
            "import threading; assert threading.active_count() == 1, threading.enumerate(); "
            "assert sfft_tpu_torch.native.available(); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'sfft_tpu' or m.startswith('sfft_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("entry", ["PCP", "ESS", "GSS", "CP", "BSP", "ESP", "ECP"])
def test_numpy_input_without_device_never_runs_on_cpu(entry, tmp_path, monkeypatch):
    """Numpy input with no device goes to the CUDA card: on a machine
    without one the entry points raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    I, J = make_pair(11)
    _, tc = cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "PCP":
            sfft_tpu_torch.PureTorchCustomizedPacket.PCP(I, J, I, J, "REF", 1)
        elif entry == "ESS":
            tengine.ElementalSFFT.ESS(I, J, tc, Subtract=True)
        elif entry == "GSS":
            tengine.GeneralSFFT.GSS(I, J, I.copy(), J.copy(), tc)
        elif entry == "ESP":
            sfft_tpu_torch.EasySparsePacket.ESP(
                *(os.path.join(DATA, f"golden_sparse_{s}.fits") for s in ("ref", "sci")),
                KerHWLimit=(2, 6), VERBOSE_LEVEL=0)
        elif entry == "ECP":
            sfft_tpu_torch.EasyCrowdedPacket.ECP(
                *(os.path.join(DATA, f"golden_crowded_{s}.fits") for s in ("ref", "sci")),
                ForceConv="REF", GKerHW=3, MaskSatContam=True, VERBOSE_LEVEL=0)
        else:
            from sfft_tpu_torch.io import fits

            paths = []
            for name, img in [("r", I), ("s", J), ("mr", I), ("ms", J)]:
                paths.append(str(tmp_path / f"{name}.fits"))
                fits.write(paths[-1], img.T)
            if entry == "CP":
                sfft_tpu_torch.CustomizedPacket.CP(*paths, "REF", 1)
            else:
                sfft_tpu_torch.BSplinePacket.BSP(*paths, GKerHW=1)
    # CPU tensors stay on the CPU without a device
    sol, diff = sfft_tpu_torch.PureTorchCustomizedPacket.PCP(t(I), t(J), t(I), t(J), "REF", 1)
    assert sol.device.type == "cpu" and diff.device.type == "cpu"
