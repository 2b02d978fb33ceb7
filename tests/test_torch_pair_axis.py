"""The leading pair axis of sfft_tpu_torch's fast and default engines
(core/engine.solve_and_subtract_batched_fn), the counterpart of sfft_tpu's
jax.vmap of the fused step (sfft_tpu/parallel/batch.py).

On the CPU the wrappers run their plain twins; the cases hold:
- the batched twins of K3 (moments), K1 (corr_window_fft) and K2
  (fdiff_model) bit for bit against their per-pair calls, and K1's batched
  schedule through the numpy emulation of the kernel
  (tests/test_torch_greek.py k1_call_emulated);
- the batched fast tables against sfft_tpu's peeled_greek_tables under
  jax.vmap, at tests/test_torch_peel.py's bounds;
- the batched fast and default steps (both scaling modes) bit for bit
  against the single GSS calls, through parallel/batch.batched_subtract
  (one batched step a device, counted), its packed route, and a config
  outside the slice taking the per-pair loop.
Every case runs in seconds at the sizes of tests/test_torch_parallel.py
(56 x 48, w = 2, 3 pairs). The `gpu` case launches each batched kernel
against its twin and its per-pair launches on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sfft_tpu_torch import make_config
from sfft_tpu_torch.config import BasisSpec
from sfft_tpu_torch.core import engine as tengine
from sfft_tpu_torch.core import fdiff as tfdiff
from sfft_tpu_torch.core import greek as tgreek
from sfft_tpu_torch.core import moments as tmom
from sfft_tpu_torch.core import peel as tpeel
from sfft_tpu_torch.core.engine import GeneralSFFT
from sfft_tpu_torch.parallel import batch as tbatch
from sfft_tpu_torch.utils import pack as tpack

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)

N0, N1, W, B = 56, 48, 2, 3
FAST = dict(greek_backend="peeled", fdiff_backend="fft32", solver="refined")


def _cfg(trio, separate=False):
    cfg = make_config(N0, N1, W, **trio)
    if separate:   # SEPARATE-VARYING: a degree-1 scaling basis (and background)
        cfg = dataclasses.replace(cfg, scaling_basis=BasisSpec("polynomial", 1),
                                  bg_basis=BasisSpec("polynomial", 1))
        assert cfg.scaling_mode == "SEPARATE-VARYING"
    return cfg


def _pairs(n=B):
    """tests/test_torch_parallel.py's pairs: the masked planes with a zeroed
    patch."""
    import test_engine   # imports sfft_tpu: not on a machine without jax

    out = [[], [], [], []]
    for k in range(n):
        I, J = test_engine.make_pair(np.random.default_rng(30 + k), N0, N1)
        mI, mJ = I.copy(), J.copy()
        mI[10 + k:16 + k, 20:26] = 0.0
        mJ[10 + k:16 + k, 20:26] = 0.0
        for s, a in zip(out, (I, J, mI, mJ)):
            s.append(a)
    return out


def _equal(a, b):
    return a.shape == b.shape and torch.equal(a, b)


def test_moments_batch_is_its_pairs():
    rng = np.random.default_rng(1)
    W = torch.as_tensor(rng.normal(size=(20, N0)) * np.logspace(0, 6, N0))
    G = torch.as_tensor(rng.normal(size=(B, N0, N1)) + 1e4)
    out = tmom.moments(W, G)
    assert out.shape == (B, 20, N1)
    assert all(_equal(out[b], tmom.moments(W, G[b])) for b in range(B))
    assert tmom.moments(W, G[:0]).shape == (0, 20, N1)
    with pytest.raises(ValueError):
        tmom.moments(W, G[..., :-1, :])


def test_fdiff_model_batch_is_its_pairs():
    rng = np.random.default_rng(2)
    Fij, Fpq, L = 3, 3, 5
    N1h = N1 // 2 + 1

    def c(*shape):
        return torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape))

    specs, FS = c(B, 1 + Fij + Fpq, N0, N1h), c(B, 2, N0, N1h)
    sol = torch.as_tensor(rng.normal(size=(B, Fij * L * L + Fpq)))
    W0, W1 = c(N0, L), c(L, N1h)
    for fs in (None, FS):
        out = tfdiff.fdiff_model(specs, fs, sol, W0, W1, Fij, 2, 2, 0.7)
        for b in range(B):
            one = tfdiff.fdiff_model(specs[b], None if fs is None else fs[b], sol[b], W0, W1,
                                     Fij, 2, 2, 0.7)
            assert _equal(out[b], one)
    with pytest.raises(ValueError):
        tfdiff.fdiff_model(specs, None, sol[:2], W0, W1, Fij, 2, 2, 0.7)


def _window_stacks(specs, symmetric, b):
    """corr_window_fft's operands for a batch: views of one transform along
    its plane axis, the same object twice when symmetric."""
    A = specs[:, 1:5]
    return A, (A if symmetric else specs[:, b[0]:b[1]])


@pytest.mark.parametrize("symmetric,chunk", [(True, 0), (False, 0), (True, 4)])
def test_corr_window_batch_is_its_pairs(symmetric, chunk):
    """corr_window_fft on a batch on the CPU ('irfft') and through the
    matmul twin of K1, against corr_window_fft pair by pair."""
    rng = np.random.default_rng(3)
    specs = torch.fft.rfft2(torch.as_tensor(rng.normal(10, 3, (B, 5, 40, 36))))
    A, Bs = _window_stacks(specs, symmetric, (0, 2))
    for method in ("irfft", "matmul"):
        out = tgreek.corr_window_fft(A, Bs, 40, 36, 3, 2, chunk=chunk, symmetric=symmetric,
                                     method=method)
        for z in range(B):
            Az = A[z]
            one = tgreek.corr_window_fft(Az, Az if symmetric else Bs[z], 40, 36, 3, 2,
                                         chunk=chunk, symmetric=symmetric, method=method)
            assert _equal(out[z], one)


@pytest.mark.parametrize("symmetric", [True, False])
def test_k1_batched_schedule_emulated(monkeypatch, symmetric):
    """The kernel route of corr_window_fft on a batch (the batch folded into
    K1's plane axis without a copy, one launch, the pairs' lists offset and
    scheduled apart) with the launch emulated (k1_call_emulated), bit for
    bit the single calls' kernel route emulated the same way; each pair's
    groups those of its own list, no group mixing two pairs."""
    from test_torch_greek import k1_call_emulated

    rng = np.random.default_rng(4)
    specs = torch.fft.rfft2(torch.as_tensor(rng.normal(10, 3, (B, 5, 40, 36))))
    A, Bs = _window_stacks(specs, symmetric, (0, 1))
    blocks, ptrs = [], []
    real_launch = tgreek._corr_launch

    def launch(*args, **kw):
        blocks.append(kw.get("blocks", 1))
        ptrs.append(args[0].data_ptr())
        return real_launch(*args, **kw)

    monkeypatch.setattr(tgreek, "_k1_call", k1_call_emulated)
    monkeypatch.setattr(tgreek, "_corr_window", launch)
    out = tgreek.corr_window_fft(A, Bs, 40, 36, 3, 2, symmetric=symmetric, method="kernel")
    assert blocks == [B] and ptrs == [A.data_ptr()]   # the views, not a copy
    for z in range(B):
        Az = A[z].contiguous()
        one = tgreek.corr_window_fft(Az, Az if symmetric else Bs[z].contiguous(), 40, 36, 3, 2,
                                     symmetric=symmetric, method="kernel")
        assert _equal(out[z], one)
    # the schedule: segment k's groups are its own list's, offset
    iu, ju = np.triu_indices(4)
    off = 5 * np.arange(B)[:, None]
    ia, ib = (off + 1 + iu).ravel(), (off + 1 + ju).ravel()
    groups = tgreek._batch_groups(ia, ib, True, 4, B)
    n = len(iu)
    for k in range(B):
        mine = [g for g in groups if all(k * n <= c < (k + 1) * n for _, _, c in g[1])]
        single = tgreek._pair_groups(ia[k * n:(k + 1) * n], ib[k * n:(k + 1) * n], True, 4)
        assert [[(sa, sb, c - k * n) for sa, sb, c in p] for _, p in mine] == \
            [p for _, p in single]
    assert sum(len(p) for _, p in groups) == B * n


def test_peeled_tables_batch_matches_vmapped_reference():
    """The batched fast tables (fluct_dtype float32) against sfft_tpu's
    peeled_greek_tables under jax.vmap at tests/test_torch_peel.py's bound
    for them (1e-6 of each table's max), and bit for bit the single calls."""
    import sfft_tpu  # noqa: F401  (x64)
    import jax
    import jax.numpy as jnp
    from sfft_tpu.config import BasisSpec as JB, SFFTConfig as JC
    from sfft_tpu.core import peel as jpeel

    from sfft_tpu_torch.config import config_from_fields
    from test_torch_peel import make_pair

    jc = JC(N0=48, N1=40, w0=2, w1=2, kernel_basis=JB("polynomial", 2),
            bg_basis=JB("polynomial", 2), greek_backend="peeled", fluct_dtype="float32")
    tc = config_from_fields(dataclasses.asdict(jc))
    pairs = [make_pair(20 + k) for k in range(B)]
    I, J = (np.stack([p[r] for p in pairs]) for r in range(2))
    ref = jax.jit(jax.vmap(lambda a, b: jpeel.peeled_greek_tables(a, b, jc)))(
        jnp.asarray(I), jnp.asarray(J))
    out = tpeel.peeled_greek_tables(torch.as_tensor(I), torch.as_tensor(J), tc)
    for name, a, r in zip(["Comg", "Cgam", "Cthe", "Cphi", "Cdel"], out, ref):
        r = np.asarray(r)
        assert tuple(a.shape) == r.shape, name
        assert np.abs(a.numpy() - r).max() <= 1e-6 * np.abs(r).max(), name
        for b in range(B):
            one = tpeel.peeled_greek_tables(torch.as_tensor(I[b]), torch.as_tensor(J[b]), tc)
            assert _equal(a[b], one[["Comg", "Cgam", "Cthe", "Cphi", "Cdel"].index(name)]), name


@pytest.mark.parametrize("trio,separate", [(FAST, False), (FAST, True), ({}, False), ({}, True)],
                         ids=["fast", "fast-separate", "default", "default-separate"])
def test_batched_step_is_the_single_calls(trio, separate):
    """batched_subtract on a batched config: one batched step for the
    device's pairs, each pair's solution, difference and RMS bit for bit its
    single GSS call; a (B, N0, N1) stack runs as its list of planes."""
    cfg = _cfg(trio, separate)
    assert tengine.batched_step_supported(cfg)
    stacks = _pairs()
    steps = tengine.solve_and_subtract_batched_fn.steps
    sols, diffs, rms = tbatch.batched_subtract(*stacks, cfg, devices=["cpu"])
    assert tengine.solve_and_subtract_batched_fn.steps == steps + 1
    for k in range(B):
        sol1, diff1, _ = GeneralSFFT.GSS(*(s[k] for s in stacks), cfg, device="cpu")
        assert _equal(sols[k], sol1) and _equal(diffs[k], diff1)
        assert float(rms[k]) == float(torch.sqrt(torch.mean(diff1.float() ** 2)))
    st = tbatch.batched_subtract(*(np.stack(s) for s in stacks), cfg, devices=["cpu"])
    assert _equal(st[0], sols) and _equal(st[1], diffs)


def test_batched_step_over_two_devices_and_shared_planes():
    """Pairs k % 2 on two device entries: a batched step each; a masked
    stack that is the unmasked one (the same object) is one stack."""
    cfg = _cfg(FAST)
    I, J, _, _ = _pairs()
    steps = tengine.solve_and_subtract_batched_fn.steps
    sols, diffs, _ = tbatch.batched_subtract(I, J, I, J, cfg, devices=["cpu", "cpu"])
    assert tengine.solve_and_subtract_batched_fn.steps == steps + 2
    for k in range(B):
        sol1, diff1, _ = GeneralSFFT.GSS(I[k], J[k], I[k], J[k], cfg, device="cpu")
        assert _equal(sols[k], sol1) and _equal(diffs[k], diff1)


def test_batched_steps_bounded_by_memory(monkeypatch):
    """A device's pairs beyond ``max_batch`` run as several batched steps
    (here at most 2 pairs a step: 3 pairs take 2 steps), each pair bit for
    bit its single call, for the fast and the default trio; the bound is at
    least one pair and falls as the image grows."""
    stacks = _pairs()
    for trio in (FAST, {}):
        cfg = _cfg(trio)
        with monkeypatch.context() as m:
            m.setattr(tbatch, "max_batch", lambda cfg, device: 2)
            steps = tengine.solve_and_subtract_batched_fn.steps
            sols, diffs, _ = tbatch.batched_subtract(*stacks, cfg, devices=["cpu"])
            assert tengine.solve_and_subtract_batched_fn.steps == steps + 2
        for k in range(B):
            sol1, diff1, _ = GeneralSFFT.GSS(*(s[k] for s in stacks), cfg, device="cpu")
            assert _equal(sols[k], sol1) and _equal(diffs[k], diff1)
        big = make_config(4096, 4096, 8, **trio)
        assert tbatch.max_batch(cfg, "cpu") > tbatch.max_batch(big, "cpu") >= 1
        huge = dataclasses.replace(big, N0=1 << 20, N1=1 << 20)
        assert tbatch.max_batch(huge, "cpu") == 1


def test_batched_step_keeps_the_masked_planes_layout():
    """Column-major masked planes (the layout of a transposed prep product)
    run as one batched step in that layout, bit for bit the single calls on
    them; a fast or contract batch whose masked planes mix layouts takes the
    per-pair loop (the peel's and pexact's moment products read them in
    their layout), the default trio (layout-free) stays batched."""
    I, J, mI, mJ = _pairs()
    fI, fJ = [np.asfortranarray(a) for a in mI], [np.asfortranarray(a) for a in mJ]
    mixed = [fI[0]] + mI[1:]
    # the contract trio's moments read every role's planes in their layout
    contract = _cfg(dict(greek_backend="pexact", fdiff_backend="pexact", solver="transformed"))
    assert tbatch._batchable(contract, (I, J, fI, fJ))
    assert not tbatch._batchable(contract, (I, J, mixed, mJ))
    assert not tbatch._batchable(contract, ([np.asfortranarray(I[0])] + I[1:], J, mI, mJ))
    for cfg, masked, batched in [(_cfg(FAST), (fI, fJ), True), (_cfg(FAST), (mixed, mJ), False),
                                 (_cfg({}), (mixed, mJ), True)]:
        steps = tengine.solve_and_subtract_batched_fn.steps
        sols, diffs, _ = tbatch.batched_subtract(I, J, *masked, cfg, devices=["cpu"])
        assert tengine.solve_and_subtract_batched_fn.steps == steps + batched
        for k in range(B):
            sol1, diff1, _ = GeneralSFFT.GSS(I[k], J[k], masked[0][k], masked[1][k], cfg,
                                             device="cpu")
            assert _equal(sols[k], sol1) and _equal(diffs[k], diff1)


def test_packed_route_is_batched_subtract_on_the_dequantized_planes():
    cfg = _cfg(FAST)
    stacks = _pairs()
    out = tbatch.batched_subtract_packed(*stacks, cfg, devices=["cpu"])

    def deq(a):
        pk = tpack.pack_i16(np.ascontiguousarray(a, np.float32))
        return tpack.unpack_i16(torch.as_tensor(pk.q), torch.as_tensor(pk.scales), pk.n0,
                                pk.block)

    ref = tbatch.batched_subtract(*([deq(a) for a in s] for s in stacks), cfg, devices=["cpu"])
    for o, r in zip(out, ref):
        assert _equal(o, r)
    # a stack dequantizes in one pass, bit for bit plane by plane
    pks = [tpack.pack_i16(np.ascontiguousarray(a, np.float32)) for a in stacks[0]]
    q = torch.as_tensor(np.stack([p.q for p in pks]))
    sc = torch.as_tensor(np.stack([p.scales for p in pks]))
    both = tpack.unpack_i16(q, sc, N0, 64)
    assert all(_equal(both[k], deq(stacks[0][k])) for k in range(B))


def test_config_outside_the_slice_takes_the_loop():
    """corr / conv (and any backend pair outside BATCHED_BACKENDS, or the
    peel and pexact with B-spline bases) runs its pairs one by one: no
    batched step, each pair its single call. The solver does not decide:
    the contract backends (pexact / pexact, polynomial bases, either
    scaling mode) and the default, v2 fast and exact backends (any bases)
    are inside with every solver; pexact tables with the exact difference
    and corr / conv are not."""
    cfg = _cfg(dict(greek_backend="corr", fdiff_backend="conv"))
    assert not tengine.batched_step_supported(cfg)
    bsp = dataclasses.replace(_cfg(FAST), kernel_basis=BasisSpec("bspline", 1, (28.5,), (24.5,)))
    assert not tengine.batched_step_supported(bsp)
    solvers = ("transformed", "exact", "lu", "cho", "refined", "host", "blocked_cho")
    for solver in solvers:
        for separate in (False, True):
            pex = _cfg(dict(greek_backend="pexact", fdiff_backend="pexact", solver=solver),
                       separate)
            assert tengine.batched_step_supported(pex), (solver, separate)
    for (greek, fd), inside in ((("exact", "exact"), True), (("fft32", "fft32"), True),
                                (("fft", "fft"), True), (("pexact", "exact"), False),
                                (("corr", "conv"), False)):
        for solver in ("exact", "lu", "cho", "refined"):
            trio = dict(greek_backend=greek, fdiff_backend=fd, solver=solver)
            assert tengine.batched_step_supported(_cfg(trio)) == inside, trio
            bspline = dataclasses.replace(
                _cfg(trio), kernel_basis=BasisSpec("bspline", 1, (28.5,), (24.5,)))
            assert tengine.batched_step_supported(bspline) == inside, trio
    pbsp = dataclasses.replace(_cfg(dict(greek_backend="pexact", fdiff_backend="pexact",
                                         solver="transformed")),
                               kernel_basis=BasisSpec("bspline", 1, (28.5,), (24.5,)))
    assert not tengine.batched_step_supported(pbsp)
    with pytest.raises(ValueError):
        tengine.solve_and_subtract_batched_fn(cfg)
    stacks = _pairs(2)
    steps = tengine.solve_and_subtract_batched_fn.steps
    sols, diffs, _ = tbatch.batched_subtract(*stacks, cfg, devices=["cpu"])
    assert tengine.solve_and_subtract_batched_fn.steps == steps
    for k in range(2):
        sol1, diff1, _ = GeneralSFFT.GSS(*(s[k] for s in stacks), cfg, device="cpu")
        assert _equal(sols[k], sol1) and _equal(diffs[k], diff1)


@pytest.mark.gpu
@pytest.mark.parametrize("trio,expect", [(FAST, (2, 2, 2)), ({}, (0, 3, 2))],
                         ids=["fast", "default"])
def test_batched_kernels_on_the_card(trio, expect):
    """On the card: one batched step launches K3, K1 and K2 once a set for
    the batch (the counters; K2 counts its two launches a call); each pair's
    solution and difference bit for bit its single call; K3 on the batch bit
    for bit its per-pair launches and within its twin's bound (chip_smoke.py
    holds K1 and K2 the same way at 4096^2, phase 14)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    cfg = make_config(128, 128, 4, **trio)
    rng = np.random.default_rng(40)
    sky = 100.0 + 10.0 * rng.random((B, 128, 128))
    I = torch.as_tensor(sky + rng.normal(0, 1, sky.shape), device=dev)
    J = torch.as_tensor(1.1 * sky + 5.0 + rng.normal(0, 1, sky.shape), device=dev)
    counts = (tmom.moments.launches, tgreek.corr_window.launches, tfdiff.fdiff_model.launches)
    sol, diff = tengine.solve_and_subtract_batched_fn(cfg)(I, J, I, J)
    torch.cuda.synchronize()
    got = (tmom.moments.launches - counts[0], tgreek.corr_window.launches - counts[1],
           tfdiff.fdiff_model.launches - counts[2])
    assert got == expect, got
    for b in range(B):
        s1, d1 = tengine.solve_and_subtract_fn(cfg)(I[b], J[b], I[b], J[b])
        assert _equal(sol[b], s1) and _equal(diff[b], d1)
    W = torch.as_tensor(np.random.default_rng(5).normal(size=(7, 128)), device=dev)
    M = tmom.moments(W, I)
    assert all(_equal(M[b], tmom.moments(W, I[b].contiguous())) for b in range(B))
    ref = tmom.moments_plain(W, I)
    assert float((M - ref).abs().max() / (W.abs() @ I.abs()).max()) <= 1e-13
