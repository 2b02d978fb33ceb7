"""The row-sharded transforms and the row-sharded single-pair step of
sfft_tpu_torch (parallel/sharded_fft.py) on the CPU.

- sharded_fft2 over ["cpu"] * 8 against sfft_tpu's sharded_fft2 on the
  conftest's 8-device CPU mesh and against np.fft.fft2 (64 x 48, rtol 1e-10,
  atol 1e-8: tests/test_parallel.py:110); the rfft2 / irfft2 round trip.
- sharded_exact_fft2_pair (half False and True, 128 x 96, 8 blocks) against
  sfft_tpu's exact_fft2_pair within 1e-13 of max (tests/test_parallel.py:588);
  the sharded exact inverse against the local one.
- sharded_subtract_step: fft/lu, corr/conv/lu and peeled (f64
  fluctuations)/fft/lu at 64^2, w = 1, against sfft_tpu's (solution rtol
  1e-8 / atol 1e-10, difference rtol 1e-7 / atol 1e-9:
  tests/test_parallel.py:126-129); contract-exact, pexact, bspline-v2,
  peeled-f64, corr-conv and bspline-v2-corr on __graft_entry__.py's pair
  generator (seed 77) at 64^2 over 8 blocks against the port's local step,
  max |difference change| < 1e-7 (the dryrun's bound; chip_smoke.py runs
  the dryrun's 128^2), the contract-exact step and its normal system bit
  for bit; the fast trio and v2-fast-peeled within FAST_TRIO's bounds. The local step is held to
  sfft_tpu by the other test files, which keeps the jitted exact compiles
  out of this one.
- halo_rows against torch.roll (halos deeper than one block too); the
  corr route's tables and the conv difference over 4 row blocks with K8's
  and K9's launches emulated (tests/test_torch_corr_conv.py), against the
  twins on the whole planes within 1e-12 of max.
- N0 % d != 0 raises; with no card the default devices raise.

The references are imported inside the tests, so the `gpu` cases also run
where jax is absent (``pytest --noconftest -m gpu``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from sfft_tpu_torch.config import BasisSpec, SFFTConfig
from sfft_tpu_torch.core.engine import normal_equations_fn, solve_and_subtract_fn
from sfft_tpu_torch.core.exact_fft import (exact_dft_axis, exact_fft2_pair, pair_from_f64,
                                           pair_to_c128, _pmap, _swap)
from sfft_tpu_torch.core.fdiff import exact_inverse_axis1
from sfft_tpu_torch.parallel import sharded_fft as sh

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


def example_pair(n0, n1, seed=0):
    """__graft_entry__.py's _example_pair: eight gaussian sources on a
    tilted plane, J = 1.08 I + 3 + unit noise, I + unit noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(n1), np.arange(n0))
    I = 100.0 + 0.02 * xx + 0.01 * yy
    for _ in range(8):
        x0, y0 = rng.uniform(4, n0 - 4), rng.uniform(4, n1 - 4)
        I = I + rng.uniform(50, 400) * np.exp(
            -((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * rng.uniform(1.0, 2.5) ** 2))
    J = 1.08 * I + 3.0 + rng.normal(0, 1.0, I.shape)
    I = I + rng.normal(0, 1.0, I.shape)
    return I, J


def poly_cfg(n, w=1):
    return SFFTConfig(N0=n, N1=n, w0=w, w1=w, kernel_basis=BasisSpec("polynomial", 2),
                      bg_basis=BasisSpec("polynomial", 2), dtype="float64",
                      greek_backend="fft", fdiff_backend="fft", solver="lu")


def families(n):
    """The four engine families of __graft_entry__.py:238-247 at n^2."""
    from sfft_tpu_torch.api.bspline import make_bspline_config

    rng = np.random.default_rng(5)
    xy = np.stack([rng.uniform(4.0, 60.0, 32), rng.uniform(4.0, 60.0, 32)], axis=1)
    base = poly_cfg(n)
    bsp = make_bspline_config(
        n, n, 2, KerSpType="B-Spline", KerSpDegree=2, KerIntKnotX=[n / 2 + 0.5],
        KerIntKnotY=[n / 2 + 0.5], SEPARATE_SCALING=True, ScaSpType="Polynomial",
        ScaSpDegree=1, BkgSpType="Polynomial", BkgSpDegree=0, REGULARIZE_KERNEL=True,
        XY_REGULARIZE=xy, LAMBDA_REGULARIZE=1e-5, greek_backend="fft", fdiff_backend="fft",
        solver="lu")
    return {
        "fft/lu": base,
        "contract-exact": dataclasses.replace(base, greek_backend="exact",
                                              fdiff_backend="exact", solver="exact"),
        "pexact": dataclasses.replace(base, greek_backend="pexact", fdiff_backend="pexact",
                                      solver="exact"),
        "bspline-v2": bsp,
        "fast": dataclasses.replace(base, **FAST_TRIO),
        "peeled-f64": dataclasses.replace(base, greek_backend="peeled", fluct_dtype="float64"),
        "corr-conv": dataclasses.replace(base, greek_backend="corr", fdiff_backend="conv",
                                         solver="exact"),
        "bspline-v2-corr": dataclasses.replace(bsp, greek_backend="corr", fdiff_backend="conv"),
        "bspline-v2-peeled": dataclasses.replace(bsp, **FAST_TRIO),
    }


# the fast trio (config.TPU_MODES["fast"]; with B-spline bases the
# v2-fast-peeled mode): f32 fluctuation windows, the fft32 difference and the
# f32-LU refined solve. Held to the local step as the port's fast-mode tests
# hold it to sfft_tpu's (tests/test_torch_engine.py
# test_fast_mode_matches_reference, tests/test_torch_v2_fast.py): the tables
# within 1e-5 of their max, the solution within 3e-2 of its max, the
# difference within RMS 0.05
FAST_TRIO = dict(greek_backend="peeled", fdiff_backend="fft32", solver="refined",
                 fluct_dtype="float32")
FAST_FAMILIES = ("fast", "bspline-v2-peeled")


def test_sharded_fft2_matches_reference_and_numpy():
    import jax.numpy as jnp
    from sfft_tpu.parallel.batch import make_data_mesh
    from sfft_tpu.parallel.sharded_fft import sharded_fft2 as jsharded_fft2

    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 48)) + 1j * rng.normal(size=(64, 48))
    sh.exchange.bytes = 0
    out = sh.sharded_fft2(x, CPU8)
    assert len(out.blocks) == 8 and all(tuple(b.shape) == (8, 48) for b in out.blocks)
    # two exchanges, each moving 7 of every block's 8 chunks
    assert sh.exchange.bytes == 2 * 64 * 48 * 16 * 7 // 8
    got = sh.gather_rows(out).numpy()
    np.testing.assert_allclose(got, np.fft.fft2(x), rtol=1e-10, atol=1e-8)
    ref = np.asarray(jsharded_fft2(jnp.asarray(x), make_data_mesh(8)))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-8)


@pytest.mark.parametrize("n1", [48, 50])
def test_sharded_rfft2_round_trip(n1):
    """The half spectrum (its 25 or 26 columns padded to 32 for the
    exchange) against numpy, and back."""
    x = np.random.default_rng(6).normal(size=(3, 64, n1))
    spec = sh.sharded_rfft2(x, CPU8)
    np.testing.assert_allclose(sh.gather_rows(spec).numpy(), np.fft.rfft2(x), rtol=1e-10,
                               atol=1e-8)
    back = sh.gather_rows(sh.sharded_irfft2(spec, n1)).numpy()
    np.testing.assert_allclose(back, x, rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def exact_reference():
    """sfft_tpu's exact_fft2_pair of the test plane, full and half, from one
    jitted call (one compile for both)."""
    import jax
    import jax.numpy as jnp
    from sfft_tpu.core.exact_fft import exact_fft2_pair as jexact_fft2_pair
    from sfft_tpu.core.exact_fft import pair_to_c128 as jpair_to_c128

    F = np.random.default_rng(9).normal(100.0, 30.0, (128, 96))
    both = jax.jit(lambda f: tuple(jpair_to_c128(jexact_fft2_pair(f, half=h))
                                   for h in (False, True)))(jnp.asarray(F))
    return F, {False: np.asarray(both[0]), True: np.asarray(both[1])}


@pytest.mark.parametrize("half", [False, True])
def test_sharded_exact_fft2_pair_matches_reference(half, exact_reference):
    F, refs = exact_reference
    sharded = sh.gather_rows(sh.sharded_exact_fft2_pair(F, CPU8, half=half))
    got = pair_to_c128(sharded).numpy()
    ref = refs[half]
    assert got.shape == ref.shape == (128, 49 if half else 96)
    assert np.max(np.abs(got - ref)) < 1e-13 * np.max(np.abs(ref))
    # every block is sliced with the whole plane's scales: the port's local
    # transform, bit for bit
    local = exact_fft2_pair(torch.as_tensor(F), half=half)
    assert all(torch.equal(a, b) for a, b in zip(sharded, local))


def test_sharded_exact_fft2_pair_stack_is_local_bits():
    """A stack runs in exact_fft2_pair's plane chunks over 4 blocks."""
    F = torch.as_tensor(np.random.default_rng(4).normal(100.0, 30.0, (3, 64, 40)))
    sharded = sh.gather_rows(sh.sharded_exact_fft2_pair(F, ["cpu"] * 4, half=True))
    local = exact_fft2_pair(F, half=True)
    assert all(torch.equal(a, b) for a, b in zip(sharded, local))


def test_split_contractions_are_local_bits():
    """The products whose contraction runs over the row blocks (the windows'
    partial inverse DFT, the background correlation) sum the blocks' int32
    products under the whole operand's scales: the local results' bits. At
    256 rows the whole static tables are sliced on the device and the
    blocks' would not be by size alone (their slicing follows the whole
    table's)."""
    from sfft_tpu_torch.core.exact_fft import exact_corr_window
    from sfft_tpu_torch.core.greek import exact_bg_corr_pair

    F = torch.as_tensor(np.random.default_rng(2).normal(100.0, 30.0, (3, 256, 16)))
    sp_local = exact_fft2_pair(F, half=True)
    sp = sh.sharded_exact_fft2_pair(F, ["cpu"] * 4, half=True)
    ia, jb = np.array([0, 0, 1, 2]), np.array([0, 1, 2, 2])
    got = sh._corr_window_blocks(sp, 256, 16, 3, 2, ia, jb)
    ref = exact_corr_window(sp_local, sp_local, 256, 16, 3, 2, pairs=(ia, jb))
    assert torch.equal(got, ref)
    bg = BasisSpec("polynomial", 0)
    pairs = sh.shard_rows(pair_from_f64(F), ["cpu"] * 4)
    got = sh._bg_corr_blocks(list(pairs.blocks), pairs.spans(), bg, 256, 16, 3, 2)
    assert torch.equal(got, exact_bg_corr_pair(pair_from_f64(F), bg, 256, 16, 3, 2))


def test_sharded_exact_inverse_matches_local():
    """The sharded exact inverse of a folded half spectrum (axis 0 between
    two exchanges, the half-input real inverse per row block) against the
    local chain of fdiff_exact."""
    rng = np.random.default_rng(10)
    n0, n1 = 64, 40
    re, im = (pair_from_f64(torch.as_tensor(rng.normal(size=(n0, n1 // 2 + 1))))
              for _ in range(2))
    Zc = sh.CPair(re.rh, re.rl, im.rh, im.rl)
    zt = exact_dft_axis(_pmap(Zc, _swap), n0, inverse=True)
    ref = pair_to_c128(exact_inverse_axis1(_pmap(zt, _swap), n1)).numpy()
    got = pair_to_c128(sh.gather_rows(sh.sharded_exact_irfft2_pair(Zc, n1, CPU8))).numpy()
    assert got.shape == ref.shape == (n0, n1)
    assert np.max(np.abs(got - ref)) < 1e-13 * np.max(np.abs(ref))


@pytest.mark.parametrize("backends", [
    "fft/lu", "corr/conv/lu", "peeled(f64)/fft/lu"])
def test_sharded_subtract_step_fft_lu_matches_reference(backends):
    """The port's step against sfft_tpu's sharded_subtract_step on the
    conftest's 8-device CPU mesh: the fft route, the FFT-free route (K8's
    and K9's twins on halo-extended row blocks) and the peeled tables with
    f64 fluctuations."""
    from sfft_tpu.parallel.batch import make_data_mesh
    from sfft_tpu.parallel.sharded_fft import sharded_subtract_step as jstep
    from test_engine import base_cfg, make_pair

    kw = {"fft/lu": {}, "corr/conv/lu": dict(greek_backend="corr", fdiff_backend="conv"),
          "peeled(f64)/fft/lu": dict(greek_backend="peeled", fluct_dtype="float64")}[backends]
    I, J = make_pair(np.random.default_rng(6), N0=64, N1=64)
    jcfg = dataclasses.replace(base_cfg(N0=64, N1=64, w=1), **kw)
    sol_ref, diff_ref = jstep(jcfg, make_data_mesh(8))(I, J, I, J)
    sol, diff = sh.sharded_subtract_step(dataclasses.replace(poly_cfg(64), **kw), CPU8)(I, J, I, J)
    np.testing.assert_allclose(sol.numpy(), np.asarray(sol_ref), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(diff.numpy(), np.asarray(diff_ref), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("family", ["contract-exact", "pexact", "bspline-v2", "pexact-masked",
                                    "fast", "peeled-f64", "corr-conv", "bspline-v2-corr",
                                    "bspline-v2-peeled"])
def test_sharded_subtract_step_families_match_local_step(family):
    """Every engine family of the dryrun's leg 5, and the peeled and corr /
    conv backends, over 8 row blocks against the port's local step;
    pexact-masked solves on a masked pair and subtracts the unmasked one
    (no spectra shared). The fast families (FAST_TRIO) are held to its
    bounds."""
    n = 64
    cfg = families(n)[family.replace("-masked", "")]
    I, J = (torch.as_tensor(a) for a in example_pair(n, n, seed=77))
    mI, mJ = I, J
    if family.endswith("masked"):
        keep = torch.as_tensor(np.random.default_rng(1).uniform(size=(n, n)) > 0.05)
        mI, mJ = I * keep, J * keep
    sol, diff, (lhs, rhs) = sh.sharded_subtract_step(cfg, CPU8)(I, J, mI, mJ, with_system=True)
    sol_ref, diff_ref = solve_and_subtract_fn(cfg)(I, J, mI, mJ)
    assert diff.shape == diff_ref.shape and diff.dtype == diff_ref.dtype
    if family in FAST_FAMILIES:
        lhs_ref, rhs_ref = normal_equations_fn(cfg)(mI, mJ)
        for t, ref in ((lhs, lhs_ref), (rhs, rhs_ref)):
            assert float((t - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
        assert float((sol - sol_ref).abs().max()) <= 3e-2 * float(sol_ref.abs().max())
        assert float(torch.sqrt(torch.mean((diff - diff_ref) ** 2))) < 0.05
        return
    assert float((diff - diff_ref).abs().max()) < 1e-7
    assert float((sol - sol_ref).abs().max()) <= 1e-6 * float(sol_ref.abs().max())
    if family == "contract-exact":
        # the exact engine's products slice each block as the whole operand
        # and sum the blocks' int32 products: the local step's bits
        lhs_ref, rhs_ref = normal_equations_fn(cfg)(mI, mJ)
        assert torch.equal(lhs, lhs_ref) and torch.equal(rhs, rhs_ref)
        assert torch.equal(sol, sol_ref) and torch.equal(diff, diff_ref)


@pytest.mark.parametrize("above,below", [(2, 3), (0, 19), (11, 1)])
def test_halo_rows_match_roll(above, below):
    """Each block extended by its neighbours' rows, wrapping mod N0, against
    torch.roll of the whole array; halos of 19 and 11 rows span two and
    three 8-row blocks. The bytes counted are those of other blocks."""
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(2, 64, 12)))
    blocks = sh.shard_rows(x, CPU8)
    sh.halo_rows.bytes, calls = 0, sh.halo_rows.calls
    ext = sh.halo_rows(blocks, above, below)
    assert sh.halo_rows.calls == calls + 1
    for k, e in enumerate(ext):
        ref = torch.roll(x, shifts=above - 8 * k, dims=1)[:, :8 + above + below]
        assert torch.equal(e, ref)
    assert sh.halo_rows.bytes == 8 * (above + below) * 2 * 12 * 8


def _blocked_cfg(n, **kw):
    return dataclasses.replace(poly_cfg(n, w=2), **kw)


def test_blocked_k8_partials_emulated(monkeypatch):
    """The corr route's tables over 4 row blocks with K8's launches
    emulated (tests/test_torch_corr_conv.py ``k8_launch_emulated``): each
    block's halo-extended operands (A zero outside the block's rows, the
    operand swap of Cthe's), the partials summed, Comg's rows rho < 0
    mirrored from the sum; within 1e-12 of max of the whole planes'
    corr_window_conv_plain."""
    from sfft_tpu_torch.core import greek as tgreek
    from sfft_tpu_torch.core.engine import _plane_stacks
    from test_torch_corr_conv import k8_launch_emulated

    n = 32
    # a degree-3 kernel (10 planes against Cgam's 6 background planes) makes
    # the background planes the launch's plane operand
    cfg = _blocked_cfg(n, greek_backend="corr", N1=24, kernel_basis=BasisSpec("polynomial", 3))
    I, J = (torch.as_tensor(a) for a in example_pair(n, 24, seed=4))
    launches = []

    def launch(A, B, rho_lo, nrho, wy):
        launches.append((A.shape, B.shape[0], rho_lo, nrho))
        return torch.as_tensor(k8_launch_emulated(A.numpy(), B.numpy(), rho_lo, nrho, wy))

    monkeypatch.setattr(tgreek, "_k8_launch", launch)
    monkeypatch.setattr(tgreek, "corr_table",
                        lambda A, B, rho_lo, nrho, wy, plain: tgreek._k8_table(
                            A.contiguous(), B.contiguous(), rho_lo, nrho, wy))
    devs = ["cpu"] * 4
    (Comg, Cgam, Cthe, _, _), extra = sh._corr_tables(cfg, sh.shard_rows(I, devs),
                                                      sh.shard_rows(J, devs), plain=False)
    assert extra is None and len(launches) == 12
    assert all(shape[1] == 8 + 2 * cfg.w0 for shape, *_ in launches)
    assert [shape[0] for shape, *_ in launches[:3]] == [10, 6, 10]   # Cgam's swapped
    SI, ST, _ = _plane_stacks(cfg, I)
    for got, ref in ((Comg, tgreek.corr_window_conv_plain(SI, SI, 4, 4)),
                     (Cgam, tgreek.corr_window_conv_plain(SI, ST, 2, 2)),
                     (Cthe, tgreek.corr_window_conv_plain(SI, J[None], 2, 2)[:, 0])):
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def test_blocked_k9_emulated(monkeypatch):
    """The conv difference over 4 row blocks with K9's launches emulated
    (``k9_emulated``): each block's halo rows, its planes padded
    circularly by L1 // 2 columns, the padded-plane mode's (n, N1) output;
    within 1e-12 of max of conv_direct_plain on the whole planes."""
    from sfft_tpu_torch.core import fdiff as tfdiff
    from sfft_tpu_torch.core.engine import _plane_stacks
    from test_torch_corr_conv import k9_emulated

    n = 32
    cfg = dataclasses.replace(_blocked_cfg(n, fdiff_backend="conv"), N1=24)
    I, J = (torch.as_tensor(a) for a in example_pair(n, 24, seed=5))
    sol = torch.as_tensor(np.random.default_rng(6).normal(0, 0.1, cfg.NEQ))
    launches = []

    def emulated(planes, taps, wrap=True, *extra):
        launches.append((tuple(planes.shape), wrap))
        extra = [v.numpy() if isinstance(v, torch.Tensor) else v for v in extra]
        return torch.as_tensor(k9_emulated(planes.numpy(), taps.numpy(), wrap, *extra))

    monkeypatch.setattr(tfdiff, "conv_direct", emulated)
    devs = ["cpu"] * 4
    D = sh._fdiff_conv(cfg, [sol] * 4, sh.shard_rows(I, devs), sh.shard_rows(J, devs),
                       plain=False)
    # per block the difference and its non-finite codes
    assert launches == [((cfg.Fij, 8 + 2 * cfg.w0, 24 + 2 * cfg.w1), False)] * 8
    SI, ST, _ = _plane_stacks(cfg, I)
    Astd, b, _ = tfdiff.conv_taps(cfg, sol)
    ref = tfdiff.conv_direct_plain(SI, Astd, True, J, ST, b, scale=cfg.SCALE)
    got = sh.gather_rows(D)
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def test_rows_not_divisible_by_devices_raise():
    with pytest.raises(ValueError, match="divisible"):
        sh.sharded_subtract_step(poly_cfg(60), CPU8)
    with pytest.raises(ValueError, match="divisible"):
        sh.sharded_fft2(np.zeros((60, 48), complex), CPU8)
    with pytest.raises(ValueError, match="divisible"):
        sh.sharded_exact_fft2_pair(np.zeros((60, 48)), CPU8)


def test_default_devices_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sh.sharded_fft2(np.zeros((64, 48), complex))
    with pytest.raises(RuntimeError, match="CUDA"):
        sh.sharded_subtract_step(poly_cfg(64))


@pytest.fixture
def cuda4():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return [torch.device("cuda", 0)] * 4


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["corr-conv", "fast"])
def test_sharded_step_on_card(cuda4, family):
    """The corr / conv step (K8, K9 on halo-extended row blocks) and the
    fast step (K3 per block, K1 per frequency-row block, K2) over four row
    blocks on one card against the local step there: the f64 family within
    the CPU test's bounds, the fast one within FAST_TRIO's; every kernel of
    the path launched."""
    from sfft_tpu_torch.core import fdiff, greek, moments

    n = 256
    cfg = families(n)[family]
    I, J = (torch.as_tensor(a, device="cuda") for a in example_pair(n, n, seed=77))
    counts = {"K8": greek._K8, "K9": fdiff._K9, "K3": moments.moments,
              "K2": fdiff.fdiff_model, "K1": greek.corr_window}
    before = {k: f.launches for k, f in counts.items()}
    sol, diff, (lhs, rhs) = sh.sharded_subtract_step(cfg, cuda4)(I, J, I, J, with_system=True)
    torch.cuda.synchronize()
    ran = {k: f.launches - before[k] for k, f in counts.items()}
    sol_ref, diff_ref = solve_and_subtract_fn(cfg)(I, J, I, J)
    lhs_ref, rhs_ref = normal_equations_fn(cfg)(I, J)
    if family == "fast":
        assert min(ran["K3"], ran["K1"], ran["K2"]) > 0, ran
        for t, ref in ((lhs, lhs_ref), (rhs, rhs_ref)):
            assert float((t - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
        assert float((sol - sol_ref).abs().max()) <= 3e-2 * float(sol_ref.abs().max())
        assert float(torch.sqrt(torch.mean((diff - diff_ref) ** 2))) < 0.05
    else:
        assert ran["K8"] == 3 * 4 and ran["K9"] == 2 * 4, ran
        for t, ref in ((lhs, lhs_ref), (rhs, rhs_ref)):
            assert float((t - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
        assert float((diff - diff_ref).abs().max()) < 1e-7
        assert float((sol - sol_ref).abs().max()) <= 1e-6 * float(sol_ref.abs().max())


@pytest.mark.gpu
def test_sharded_fft2_on_card(cuda4):
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(512, 256)) + 1j * rng.normal(size=(512, 256)),
                        device="cuda")
    got = sh.gather_rows(sh.sharded_fft2(x, cuda4))
    ref = torch.fft.fft2(x)
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    xr = x.real.contiguous()
    back = sh.gather_rows(sh.sharded_irfft2(sh.sharded_rfft2(xr, cuda4), 256))
    assert float((back - xr).abs().max()) <= 1e-12 * float(xr.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("half", [False, True])
def test_sharded_exact_fft2_pair_on_card(cuda4, half):
    F = torch.as_tensor(np.random.default_rng(9).normal(100.0, 30.0, (256, 192)),
                        device="cuda")
    got = pair_to_c128(sh.gather_rows(sh.sharded_exact_fft2_pair(F, cuda4, half=half)))
    ref = pair_to_c128(exact_fft2_pair(F, half=half))
    assert float((got - ref).abs().max()) <= 1e-13 * float(ref.abs().max())
