"""The leading pair axis of sfft_tpu_torch's any-basis exact engine and of
its B-spline configs (core/engine.solve_and_subtract_batched_fn), the
counterpart of sfft_tpu's jax.vmap of the fused step
(sfft_tpu/parallel/batch.py).

On the CPU the wrappers run their plain twins; the cases hold:
- the batched steps of the v2 contract (exact / exact / exact, the
  Tikhonov-regularized NIRCam-shaped case of tests/v2_cases.py, its solve
  on the K5-sliced refinement route with the size gate lowered), the v2
  fast trio (fft32 / fft32 / refined), the default trio with B-spline
  bases and the polynomial exact trio bit for bit against each pair's
  single call, through parallel/batch.batched_subtract (one batched step,
  counted), with the masked planes the unmasked ones (one set of plane
  spectra for the tables and the difference) and, for the exact trio,
  other planes;
- a batch with a pair scaled by 2^-20 (each pair sliced under its own
  global scale: the DFT stages and exact_bg_corr_pair's products);
- the exact engine's K4 / K7 / K6a / K6m call counts of a batched step,
  equal for B = 1 and B = 3, and each pair's solution row on its single
  call's 512-byte alignment;
- a batch whose planes mix layouts taking the per-pair loop;
- the batched polynomial exact trio against sfft_tpu's jax.vmap of its
  fused step (tests/test_parallel.py's exact config; 31 x 29, prime sides,
  each DFT axis one product: the reference's trace and compile is the
  file's largest cost), solutions within 1e-6 of their max and
  differences within 1e-8 of max|J| (tests/test_engine.py's bounds);
- ``max_batch`` with the (NEQ, NEQ) systems' bytes, the device's memory
  monkeypatched.
The B-spline steps reach sfft_tpu through their single calls, which
tests/test_torch_v2_exact.py and tests/test_torch_v2_fast.py hold to it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sfft_tpu  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from sfft_tpu.core import engine as jengine

from sfft_tpu_torch import make_bspline_config
from sfft_tpu_torch.config import config_from_fields
from sfft_tpu_torch.core import engine as tengine
from sfft_tpu_torch.core import exact_fft as texact
from sfft_tpu_torch.core import pairs as tpairs
from sfft_tpu_torch.core import solve as tsolve
from sfft_tpu_torch.core.engine import GeneralSFFT
from sfft_tpu_torch.parallel import batch as tbatch

import test_engine
import v2_cases

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)

B = 3
EXACT = dict(greek_backend="exact", fdiff_backend="exact", solver="exact")
TRIOS = {"v2-contract": ("bspline_tikhonov", EXACT),
         "v2-fast-fft32": ("bspline_tikhonov",
                           dict(greek_backend="fft32", fdiff_backend="fft32", solver="refined")),
         "bsp-default": ("bspline_tikhonov", {}),
         "poly-exact": (None, EXACT)}


def _poly_cfg(N0=32, N1=32, **kw):
    """tests/test_parallel.py's exact config (poly2 / poly2, w = 1): the
    sfft_tpu config and the port's from its fields."""
    jc = test_engine.base_cfg(N0=N0, N1=N1, w=1, **EXACT, **kw)
    return jc, config_from_fields(dataclasses.asdict(jc))


def _cfg(name):
    case, trio = TRIOS[name]
    return _poly_cfg()[1] if case is None else v2_cases.configs(case, **trio)[1]


def _pairs(name, masked=False, n=B):
    """n pairs of the case's shape (I, J, mI, mJ lists); the masked planes
    are the unmasked ones (the same objects) unless `masked`: then copies
    with a zeroed patch."""
    out = [[], [], [], []]
    for k in range(n):
        if TRIOS[name][0] is None:
            I, J = test_engine.make_pair(np.random.default_rng(60 + k), 32, 32)
        else:
            I, J = v2_cases.make_pair(1 + k)
        mI, mJ = I, J
        if masked:
            mI, mJ = I.copy(), J.copy()
            mI[8 + k:12 + k, 10:14] = 0.0
            mJ[8 + k:12 + k, 10:14] = 0.0
        for s, a in zip(out, (I, J, mI, mJ)):
            s.append(a)
    return out


def _equal(a, b):
    return a.shape == b.shape and torch.equal(a, b)


def _batched_is_singles(cfg, stacks):
    """batched_subtract of the stacks as one batched step, each pair bit for
    bit its single GSS call (solution, difference, RMS): with the masked
    planes the unmasked ones the batch of one (which
    tests/test_torch_v2_exact.py holds to the two-call route), else the
    two-call route itself (solve on the masked pair, then subtract)."""
    steps = tengine.solve_and_subtract_batched_fn.steps
    sols, diffs, rms = tbatch.batched_subtract(*stacks, cfg, devices=["cpu"])
    assert tengine.solve_and_subtract_batched_fn.steps == steps + 1
    assert sols.shape == (len(stacks[0]), cfg.NEQ)
    for k in range(len(stacks[0])):
        sol1, diff1, _ = GeneralSFFT.GSS(*(s[k] for s in stacks), cfg, device="cpu")
        assert _equal(sols[k], sol1) and _equal(diffs[k], diff1), k
        assert float(rms[k]) == float(torch.sqrt(torch.mean(diff1.float() ** 2)))
    return sols, diffs


@pytest.mark.parametrize("name", sorted(TRIOS))
def test_batched_step_is_the_single_calls(name, monkeypatch):
    """B = 3 pairs of each config as one batched step, masked == unmasked:
    each pair bit for bit its single call. The v2 contract's systems take
    _refined_solve_f64's K5-sliced route (the size gate lowered, as the
    13k-dof NIRCam system takes it), once a pair."""
    cfg = _cfg(name)
    assert tengine.batched_step_supported(cfg)
    seen = []
    if name == "v2-contract":
        real = tsolve._refined_solve_f64
        monkeypatch.setattr(tsolve, "_refined_solve_f64",
                            lambda *a, **kw: seen.append(a[0].shape) or real(*a, **kw))
        monkeypatch.setattr(tsolve, "LARGE_NEQ", 64)
    _batched_is_singles(cfg, _pairs(name))
    if name == "v2-contract":
        # 3 batched solves and 3 single calls
        assert len(seen) == 2 * B and seen[0][0] > 64


def test_batched_exact_step_with_other_masked_planes():
    """The exact trio with masked planes other than the unmasked ones: the
    tables' spectra from the masked stacks, the difference's from the
    unmasked ones, each pair bit for bit its single GSS call (its two-call
    route)."""
    _batched_is_singles(_cfg("poly-exact"), _pairs("poly-exact", masked=True, n=2))


def test_batched_exact_step_slices_each_pair_with_its_own_scale():
    """A batch whose second pair is the first scaled by 2^-20: every DFT
    stage and both products of exact_bg_corr_pair slice each pair under its
    own global scale, so each pair is bit for bit its single call (one
    scale for the batch would lose 20 bits of the small pair)."""
    cfg = _cfg("poly-exact")
    I, J, _, _ = _pairs("poly-exact", n=1)
    I, J = [I[0], I[0] * 2.0 ** -20], [J[0], J[0] * 2.0 ** -20]
    sols, diffs = _batched_is_singles(cfg, (I, J, I, J))
    assert float(sols[1].abs().max()) > 0 and float(diffs[1].abs().max()) > 0


def test_exact_launch_counts_do_not_depend_on_the_batch(monkeypatch):
    """The exact engine's K4 stage, K7, K6a and K6m calls of a batched step
    (the wrappers counted) are the same for one pair and for three."""
    cfg = _cfg("poly-exact")
    I, J, _, _ = _pairs("poly-exact")
    It, Jt = (torch.as_tensor(np.stack(s)) for s in (I, J))
    step = tengine.solve_and_subtract_batched_fn(cfg)
    step(It[:1], Jt[:1], It[:1], Jt[:1])      # the static tables, built from here on
    calls = dict.fromkeys(("K4", "K7", "K6a", "K6m"), 0)

    def counted(key, fn):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(texact, "slice_pairs", counted("K4", texact.slice_pairs))
    monkeypatch.setattr(texact, "sliced_epilogue", counted("K7", texact.sliced_epilogue))
    monkeypatch.setattr(tpairs, "pair_products", counted("K6a", tpairs.pair_products))
    monkeypatch.setattr(tpairs, "pair_model", counted("K6m", tpairs.pair_model))
    got = []
    for n in (1, B):
        for k in calls:
            calls[k] = 0
        sol, _ = step(It[:n], Jt[:n], It[:n], Jt[:n])
        got.append(dict(calls))
    assert got[0] == got[1] and min(got[0].values()) >= 1 and got[0]["K6m"] == 1, got
    # each pair's solution row starts on a 512-byte boundary of the batch's
    # (a single call's own tensor's alignment: the card's reductions over a
    # pair's view order their sums by it)
    assert all((sol[k].data_ptr() - sol[0].data_ptr()) % 512 == 0 for k in range(B))


def test_mixed_layout_batch_takes_the_loop():
    """The exact trio's spectra read the masked planes and its difference
    the unmasked ones in their layout: a batch with one column-major plane
    in a role takes the per-pair loop (each pair its single call); planes
    of one layout a role batch."""
    cfg = _cfg("poly-exact")
    I, J, mI, mJ = _pairs("poly-exact", masked=True, n=2)
    fmI = [np.asfortranarray(a) for a in mI]
    assert tbatch._batchable(cfg, (I, J, fmI, mJ))
    for stacks in ((I, J, [fmI[0]] + mI[1:], mJ), ([np.asfortranarray(I[0])] + I[1:], J, mI, mJ)):
        assert not tbatch._batchable(cfg, stacks)
    stacks = (I, J, [fmI[0]] + mI[1:], mJ)
    steps = tengine.solve_and_subtract_batched_fn.steps
    sols, diffs, _ = tbatch.batched_subtract(*stacks, cfg, devices=["cpu"])
    assert tengine.solve_and_subtract_batched_fn.steps == steps
    for k in range(2):
        sol1, diff1, _ = GeneralSFFT.GSS(*(s[k] for s in stacks), cfg, device="cpu")
        assert _equal(sols[k], sol1) and _equal(diffs[k], diff1)


def test_batched_exact_trio_holds_sfft_tpu_vmap():
    """The batched polynomial exact trio against sfft_tpu's jax.vmap of its
    fused step (masked == unmasked, as tests/test_parallel.py batches it),
    B = 2 on one CPU device: each pair's solution within 1e-6 of its max
    and its difference within 1e-8 of max|J|."""
    jc, tc = _poly_cfg(31, 29)
    pairs = [test_engine.make_pair(np.random.default_rng(70 + k), 31, 29) for k in range(2)]
    I, J = (np.stack([p[r] for p in pairs]) for r in range(2))
    sol_j, diff_j = jax.jit(jax.vmap(jengine.solve_and_subtract_same_fn(jc)))(
        jnp.asarray(I), jnp.asarray(J))
    It, Jt = torch.as_tensor(I), torch.as_tensor(J)
    sol_t, diff_t = tengine.solve_and_subtract_batched_fn(tc)(It, Jt, It, Jt)
    for k in range(2):
        sj, dj = np.asarray(sol_j[k]), np.asarray(diff_j[k])
        assert np.abs(sol_t[k].numpy() - sj).max() <= 1e-6 * np.abs(sj).max()
        assert np.abs(diff_t[k].numpy() - dj).max() <= 1e-8 * np.abs(J[k]).max()


def test_max_batch_counts_the_systems(monkeypatch):
    """``max_batch`` of the v2 NIRCam configuration (900^2, NEQ 13226) on a
    card with 80 GB free, held to chip_smoke.py phase 14's peaks on the
    card (H100 80GB HBM3; the phase's own planes included): the v2
    contract's step 8.53 GiB for one pair and 5.64 GiB a further pair (its
    f64 (NEQ, NEQ) systems), the v2 fast trio's 5.20 and 2.93 GiB. It takes
    no more pairs than those peaks fit, and at least the 8 of phase 14's
    --batched run; a card whose free memory holds less than one pair's
    step still takes one pair, and the CPU bound reads the available
    physical memory."""
    n = 900
    rng = np.random.default_rng(10086)
    xy = np.stack([rng.uniform(10.0, n - 10.0, 512), rng.uniform(10.0, n - 10.0, 512)], axis=1)
    v2 = make_bspline_config(
        n, n, 11, KerSpType="B-Spline", KerSpDegree=2,
        KerIntKnotX=[0.5 + n / 3, 0.5 + n * 2 / 3], KerIntKnotY=[0.5 + n / 3, 0.5 + n * 2 / 3],
        SEPARATE_SCALING=True, ScaSpType="Polynomial", ScaSpDegree=2,
        BkgSpType="Polynomial", BkgSpDegree=0, REGULARIZE_KERNEL=True, XY_REGULARIZE=xy,
        LAMBDA_REGULARIZE=3e-5, **EXACT)
    assert v2.NEQ == 13226
    free = [80e9]
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (int(free[0]), 0))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0)

    def fits(one_gib, further_gib, nbytes):
        """the pairs a step whose peaks are these fits in `nbytes`"""
        return 1 + int((nbytes / 2 ** 30 - one_gib) // further_gib)

    got = tbatch.max_batch(v2, "cuda")
    assert 8 <= got <= fits(8.53, 5.64, free[0]), got
    fast = dataclasses.replace(v2, greek_backend="fft32", fdiff_backend="fft32",
                               solver="refined")
    got_fast = tbatch.max_batch(fast, "cuda")
    assert max(8, got + 1) <= got_fast <= fits(5.20, 2.93, free[0]), got_fast
    small = dataclasses.replace(v2, kernel_basis=type(v2.kernel_basis)("polynomial", 0))
    assert small.NEQ < 600 and tbatch.max_batch(small, "cuda") > got
    free[0] = 2e9
    assert tbatch.max_batch(v2, "cuda") == 1
    monkeypatch.setattr(tbatch.os, "sysconf",
                        lambda k: {"SC_AVPHYS_PAGES": 10 ** 7, "SC_PAGE_SIZE": 4096}[k])
    got_cpu = tbatch.max_batch(v2, "cpu")
    assert 1 <= got_cpu <= fits(8.53, 5.64, 4096e7) and got_cpu < got, got_cpu
