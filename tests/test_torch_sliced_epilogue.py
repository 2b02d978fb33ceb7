"""K7, the epilogue of the sliced int8 product (core/exact_fft.py
``sliced_epilogue``, csrc/sliced_epilogue.cu), and its plain twin
``sliced_epilogue_plain``.

Inputs are made from seeds with numpy and fed to both packages. On the CPU:

  * the twin's compensated chain (``_accum``) against sfft_tpu's, jitted, on
    the same int32 group sums and scales: the f32 hi and lo parts bit for
    bit, with and without the 2^12 split, sums up to the product bound
    64 * 33 * combos * K, global and rowwise scales, the weights of the
    three slicing profiles;
  * ``_cmatmul_sliced`` (products + twin) against sfft_tpu's, jitted, within
    1e-13 of max: the shallow and the deep route (K >= 1024, few rows), real
    and complex data, real_out, and a table with no imaginary part;
  * the kernel's launch arguments (``_epi_args``: offsets, terms, the
    TwoSum / plain split of the chain) run through a numpy emulation of the
    kernel's arithmetic, which must equal the twin bit for bit: the plan
    the kernel gets reads and combines what the twin does.

The `gpu` cases hold the kernel to the twin on the card, bit for bit, one
launch per ``_cmatmul_sliced`` call. The reference is imported inside the
CPU tests, so they also run where jax is absent (``pytest --noconftest -m
gpu``).
"""

import numpy as np
import pytest
import torch

from sfft_tpu_torch.core import exact_fft as tef
from sfft_tpu_torch.core.statics import Static

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)

PROFILES = [(9, 8, 8), (8, 7, 6), (6, 6, 5)]


def _jef():
    import sfft_tpu  # noqa: F401  (x64)
    from sfft_tpu.core import exact_fft

    return exact_fft


def _table(K, M, kind, seed):
    """A seeded static table (K, M): complex, or real ('r')."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(K, M))
    return W if kind == "r" else W + 1j * rng.normal(size=(K, M))


def _data(shape, kind, seed):
    """A seeded pair operand over ~6 decades of row magnitudes: real or
    complex ('c')."""
    rng = np.random.default_rng(seed)
    planes = []
    for _ in range(2 if kind == "c" else 1):
        x = rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, size=shape[:-1] + (1,))
        hi = x.astype(np.float32)
        planes += [hi, (x - hi.astype(np.float64)).astype(np.float32)]
    return planes + [None] * (4 - len(planes))


def _group_sums(rng, nsl_d, nsl_w, kmax, K, rows, M, big):
    """Seeded int32 group sums of one term at a profile: up to the product
    bound 64 * 33 * combos * K (big), or below 2^24 (exact in f32)."""
    groups = tef._group_combos(nsl_d, nsl_w, kmax)
    outs = []
    for _, combos in groups:
        bound = min(64 * 33 * len(combos) * K, 2 ** 31 - 1) if big else 2 ** 24 - 1
        outs.append(rng.integers(-bound, bound + 1, size=(rows, M), dtype=np.int64)
                    .astype(np.int32))
    weights = [2.0 ** (-tef.NB * (s_ + 2)) for s_, _ in groups]
    return outs, weights


@pytest.mark.parametrize("prof", PROFILES)
@pytest.mark.parametrize("big", [True, False])
@pytest.mark.parametrize("rowwise", [True, False])
def test_accum_twin_bit_identical_to_reference(prof, big, rowwise):
    import jax
    import jax.numpy as jnp

    jef = _jef()
    rng = np.random.default_rng(sum(prof) + 2 * big + rowwise)
    rows, M, K = 24, 40, 4096
    outs, weights = _group_sums(rng, *prof, K, rows, M, big)
    sc = 2.0 ** rng.integers(-12, 12, size=(rows, 1) if rowwise else ())
    sc = np.asarray(sc, np.float32)
    h, l = tef._accum([torch.as_tensor(o) for o in outs], weights, torch.as_tensor(sc), big)
    rh, rl = jax.jit(lambda os_, s: jef._accum(os_, weights, s, big))(
        [jnp.asarray(o) for o in outs], jnp.asarray(sc))
    assert np.array_equal(h.numpy().view(np.int32), np.asarray(rh).view(np.int32))
    assert np.array_equal(l.numpy().view(np.int32), np.asarray(rl).view(np.int32))


# (K, M, lead): shallow (K < 1024) and deep with few rows
ROUTES = {"shallow": (64, 64, (3, 40)), "shallow_odd": (33, 17, (5,)),
          "deep": (1030, 17, (4,))}
# (data kind, table kind, real_out): real data, complex data, real_out,
# and a table with no imaginary part
KINDS = {"real_data": ("r", "c", False), "complex": ("c", "c", False),
         "real_out": ("c", "c", True), "real_table": ("c", "r", False)}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("route", ["shallow", "deep"])     # odd widths: the emulation test
def test_cmatmul_sliced_matches_reference(route, kind):
    import jax
    import jax.numpy as jnp

    jef = _jef()
    K, M, lead = ROUTES[route]
    dk, wk, real_out = KINDS[kind]
    seed = len(route) * 7 + len(kind)
    W = _table(K, M, wk, seed)
    planes = _data(lead + (K,), dk, seed)
    prof = tef.SliceProfile(8, 7, 6)
    rowwise = route == "shallow"
    got = tef._cmatmul_sliced(tef.CPair(*(None if v is None else torch.as_tensor(v)
                                          for v in planes)),
                              Static(_table, (K, M, wk, seed)), rowwise=rowwise,
                              real_out=real_out, prof=prof)
    Wim = None if wk == "r" else np.imag(W)

    def ref_fn(*vs):
        data = jef.CPair(*(list(vs) + [None] * (4 - len(vs))))
        return jef._cmatmul_sliced(data, np.real(W), Wim, rowwise=rowwise, real_out=real_out,
                                   prof=jef.SliceProfile(8, 7, 6))

    ref = jax.jit(ref_fn)(*(jnp.asarray(v) for v in planes if v is not None))
    assert (got.ih is None) == (ref.ih is None)
    g, r = tef.pair_to_c128(got).numpy(), np.asarray(jef.pair_to_c128(ref))
    assert g.shape == r.shape == lead + (M,)
    assert np.abs(g - r).max() <= 1e-13 * np.abs(r).max()


def _emulate(P, plan, sd):
    """csrc/sliced_epilogue.cu's arithmetic in numpy f32 (IEEE, rounded to
    nearest, one operation at a time, vectorised over the elements), driven
    by the launch arguments ``_epi_args`` builds: pointers resolved back to
    the tensors, element offsets, terms, the chain's TwoSum / plain split."""
    outs = [torch.zeros(plan.lead + (plan.M,), dtype=torch.float32)
            for _ in range(2 if plan.mode == 2 else 4)]
    a = tef._epi_args(P, plan, sd, outs)
    f32 = np.float32
    flat = P.reshape(-1).numpy()
    base = P.data_ptr()
    scales = {s.data_ptr(): s.numpy().reshape(-1) for s in sd}
    for t in plan.terms:
        if t is not None and isinstance(t[2], torch.Tensor):
            scales[t[2].data_ptr()] = t[2].numpy().reshape(-1)
    rows = a.rows
    e = np.arange(rows * a.M, dtype=np.int64)
    row, col = e // a.M, e % a.M

    def two_sum(x, y):
        s = f32(x + y)
        v = f32(s - x)
        return s, f32(f32(x - f32(s - v)) + f32(y - v))

    def term(t):
        d = a.term_d[t]
        p = (a.prod[d] - base) // 4 + row * a.row_stride + a.term_base[t] + col
        h = l = tail = None
        for g in range(a.ngroups):
            x = np.zeros(e.shape, np.int32)
            for k in range(a.ncombo[g]):
                x = (x + flat[p + a.off[g][k]]).astype(np.int32)
            if a.split:
                top = (x >> 12) << 12
                vals = [top.astype(f32), (x - top).astype(f32)]
            else:
                vals = [x.astype(f32)]
            for v in vals:
                gw = f32(v * f32(a.w[g]))
                if g < a.nbig:
                    if h is None:
                        h, l = gw, np.zeros_like(gw)
                    else:
                        h, err = two_sum(h, gw)
                        l = f32(l + err)
                else:
                    tail = gw if tail is None else f32(tail + gw)
        if tail is not None:
            l = f32(l + tail)
        h2 = f32(h + l)
        l2 = f32(l - f32(h2 - h))
        sdv = scales[a.sd[d]][row if a.sd_rowwise else 0]
        sw = scales[a.swp[t]][0] if a.swp[t] else f32(a.swv[t])
        sc = f32(sdv * sw)
        return f32(h2 * sc), f32(l2 * sc)

    z = np.zeros(e.shape, f32)
    h = [term(t) if a.term_d[t] >= 0 else (z, z) for t in range(4)]
    if a.mode == 0:
        got = [h[0][0], h[0][1], h[1][0], h[1][1]]
    else:
        zr, e1 = two_sum(h[0][0], -h[3][0])
        got = [zr, f32(f32(h[0][1] - h[3][1]) + e1)]
        if a.mode == 1:
            zi, e2 = two_sum(h[1][0], h[2][0])
            got += [zi, f32(f32(h[1][1] + h[2][1]) + e2)]
    return [g.reshape(plan.lead + (plan.M,)) for g in got]


def _captured_epilogues(route, kind, prof, rowwise, monkeypatch):
    """The products, plan and scales of one _cmatmul_sliced call, with the
    twin's result."""
    K, M, lead = ROUTES[route]
    dk, wk, real_out = KINDS[kind]
    seed = 3 + len(kind)
    planes = _data(lead + (K,), dk, seed)
    seen = []
    real = tef.sliced_epilogue

    def capture(P, plan, sd):
        out = real(P, plan, sd)
        seen.append((P, plan, list(sd), out))
        return out

    monkeypatch.setattr(tef, "sliced_epilogue", capture)
    tef._cmatmul_sliced(tef.CPair(*(None if v is None else torch.as_tensor(v) for v in planes)),
                        Static(_table, (K, M, wk, seed)), rowwise=rowwise, real_out=real_out,
                        prof=tef.SliceProfile(*prof))
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("prof", PROFILES)
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("route", ["shallow_odd", "deep"])
def test_kernel_plan_emulated_bit_identical_to_twin(route, kind, prof, monkeypatch):
    P, plan, sd, out = _captured_epilogues(route, kind, prof, route == "deep", monkeypatch)
    want = [v.numpy() for v in out if v is not None]
    got = _emulate(P, plan, sd)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.view(np.int32), w.view(np.int32))


def test_epilogue_counts_and_refusals():
    K, M, lead = ROUTES["shallow_odd"]
    planes = _data(lead + (K,), "c", 1)
    before = tef.sliced_epilogue.launches
    tef._cmatmul_sliced(tef.CPair(*(torch.as_tensor(v) for v in planes)),
                        Static(_table, (K, M, "c", 1)))
    assert tef.sliced_epilogue.launches == before      # CPU tensors take the twin
    seen = []
    real = tef.sliced_epilogue
    tef.sliced_epilogue = lambda *args: seen.append(args) or real(*args)
    try:
        tef._cmatmul_sliced(tef.CPair(*(torch.as_tensor(v) for v in planes)),
                            Static(_table, (K, M, "c", 1)))
    finally:
        tef.sliced_epilogue = real
    P, plan, sd = seen[0]
    with pytest.raises(ValueError):
        tef.sliced_epilogue(P.to(torch.int64), plan, sd)
    with pytest.raises(ValueError):
        tef.sliced_epilogue(P, plan, sd[:1])
    with pytest.raises(ValueError):
        tef.sliced_epilogue(P, plan, [sd[0], sd[1].double()])


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


GPU_ROUTES = {"shallow": (64, 64, (3, 40)), "shallow_odd": (33, 17, (5,)),
              "deep": (1030, 17, (4,)), "deep_m16": (2049, 23, (2,)),
              "stage": (64, 33, (4096, 64))}


@pytest.mark.gpu
@pytest.mark.parametrize("prof", PROFILES)
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("route", sorted(GPU_ROUTES))
def test_sliced_epilogue_kernel_bit_identical_to_twin_on_gpu(cuda, route, kind, prof):
    K, M, lead = GPU_ROUTES[route]
    dk, wk, real_out = KINDS[kind]
    seed = len(route) + 5 * len(kind)
    planes = _data(lead + (K,), dk, seed)
    data = tef.CPair(*(None if v is None else torch.as_tensor(v, device=cuda) for v in planes))
    W = Static(_table, (K, M, wk, seed))
    for rowwise in (False, True):
        before = tef.sliced_epilogue.launches
        got = tef._cmatmul_sliced(data, W, rowwise=rowwise, real_out=real_out,
                                  prof=tef.SliceProfile(*prof))
        again = tef._cmatmul_sliced(data, W, rowwise=rowwise, real_out=real_out,
                                    prof=tef.SliceProfile(*prof))
        torch.cuda.synchronize()
        assert tef.sliced_epilogue.launches == before + 2
        # the same K4 slices, the epilogue on its twin
        real = tef.sliced_epilogue
        tef.sliced_epilogue = tef.sliced_epilogue_plain
        try:
            ref = tef._cmatmul_sliced(data, W, rowwise=rowwise, real_out=real_out,
                                      prof=tef.SliceProfile(*prof))
        finally:
            tef.sliced_epilogue = real
        for g, a, r in zip(got, again, ref):
            assert (g is None) == (r is None)
            if g is not None:
                assert torch.equal(g, r) and torch.equal(g, a)


@pytest.mark.gpu
def test_sliced_epilogue_refusals_on_gpu(cuda):
    K, M, lead = ROUTES["shallow_odd"]
    planes = _data(lead + (K,), "c", 2)
    seen = []
    real = tef.sliced_epilogue
    tef.sliced_epilogue = lambda *args: seen.append(args) or real(*args)
    try:
        tef._cmatmul_sliced(tef.CPair(*(torch.as_tensor(v, device=cuda) for v in planes)),
                            Static(_table, (K, M, "c", 2)))
    finally:
        tef.sliced_epilogue = real
    P, plan, sd = seen[0]
    with pytest.raises(ValueError):
        tef.sliced_epilogue(P, plan, [s.cpu() for s in sd])
    with pytest.raises(ValueError):
        tef.sliced_epilogue(P[:, :, :5], plan, sd)
