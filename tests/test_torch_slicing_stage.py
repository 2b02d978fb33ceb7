"""The slicing stages of sfft_tpu_torch/core/slicing.py (K4 ``slice_pairs``,
K5 ``slice_rows_f64`` and ``slice_vec_f64``) against sfft_tpu, and their
launch plans.

Inputs are made from seeds with numpy. On CPU tensors a stage runs its plain
twin, which must match sfft_tpu's chain bit for bit: for K4 the caller's zero
pad of the contraction axis followed by ``exact_fft._slice_pair_real`` (XLA
chain, jitted on the CPU, where sfft_tpu's Pallas slicer is off), on
transposed and strided views, ragged K, Kp > K, rowwise and global scales;
for K5 ``solve._sliced_residual_setup`` (its ``slice_rows``: equilibration,
exact split, row scales, 12 slices) and the vector slicing of
``_sliced_matvec``. The launch plans (pure functions of shapes and strides)
must make the kernels write every output element exactly once and read every
element of the view exactly once. The `gpu` cases hold the CUDA kernels to
the twins on the card (``pytest --noconftest -m gpu``: the reference is
imported inside the tests)."""

import numpy as np
import pytest
import torch

from sfft_tpu_torch.core import slicing as tsl
from sfft_tpu_torch.core import solve as tsolve


def _wide_pair(seed, shape, zero_row=False, scale=1.0):
    """A (hi, lo) f32 pair of values over ~14 decades (optionally a zero
    first row, or scaled down so that the lo parts are f32 subnormals)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 7.3, shape) * np.exp(rng.normal(0, 4, shape)) * scale
    if zero_row:
        v[..., 0, :] = 0.0
    hi = v.astype(np.float32)
    return hi, (v - hi.astype(np.float64)).astype(np.float32)


# (name, stored shape, view of the stored array, zero row, scale)
VIEWS = [
    ("contiguous ragged K", (6, 37), lambda t: t, False, 1.0),
    ("transposed", (45, 16), lambda t: t.transpose(-1, -2), True, 1.0),
    ("batched transpose", (3, 13, 20), lambda t: t.transpose(-1, -2), False, 1.0),
    ("leading axis of stride 1", (9, 10, 7), lambda t: t.permute(2, 0, 1), False, 1.0),
    ("rows longer than K", (5, 40), lambda t: t[:, :29], False, 1.0),
]
# values near 1e-33, whose lo parts are f32 subnormals: XLA:CPU flushes
# subnormal f32 results to zero, so sfft_tpu's chain on the CPU is no bit
# reference here; the twin is held to the slices' representation bound, and
# the kernel to the twin on the card
SUBNORMAL = ("subnormal lo parts", (4, 24), lambda t: t, False, 1e-33)


def _view(arr, fn, device="cpu"):
    return fn(torch.as_tensor(arr, device=device))


def _operand(case, nparts, device="cpu"):
    _, shape, fn, zero, scale = case
    return [tuple(_view(a, fn, device) for a in _wide_pair(3 + p, shape, zero, scale))
            for p in range(nparts)]


@pytest.mark.parametrize("case", VIEWS, ids=[v[0] for v in VIEWS])
def test_k4_stage_twin_bit_identical_to_reference(case):
    import jax
    import jax.numpy as jnp
    import sfft_tpu  # noqa: F401  (x64)
    from sfft_tpu.core import exact_fft as jef

    parts = _operand(case, 2)
    K = parts[0][0].shape[-1]
    lead = parts[0][0].dim() - 1
    combos = [(K, 6, True), (K + (-K) % 8, 8, False), (K + 11, 7, True), (K + 11, 8, False)]

    def reference(h, l):
        # the caller's zero pad, then sfft_tpu's chain, for every combination
        out = []
        for Kp, nsl, rowwise in combos:
            pad = [(0, 0)] * lead + [(0, Kp - K)]
            out.append(jef._slice_pair_real(jnp.pad(h, pad), jnp.pad(l, pad), nsl, rowwise))
        return out

    fn = jax.jit(reference)
    refs = [fn(jnp.asarray(h.numpy()), jnp.asarray(l.numpy())) for h, l in parts]
    for c, (Kp, nsl, rowwise) in enumerate(combos):
        before = tsl.slice_pair.launches
        got = tsl.slice_pairs(parts, nsl, Kp, rowwise)
        assert tsl.slice_pair.launches == before          # the CPU twin launches nothing
        for (sl, s), (h, _), ref in zip(got, parts, refs):
            assert sl.dtype == torch.int8 and sl.shape == (nsl,) + tuple(h.shape[:-1]) + (Kp,)
            np.testing.assert_array_equal(sl.numpy(), np.asarray(ref[c][0]))
            np.testing.assert_array_equal(s.numpy(), np.asarray(ref[c][1]))


@pytest.mark.parametrize("rowwise", [True, False])
def test_k4_stage_twin_keeps_subnormal_lo_parts(rowwise):
    (h, l), = _operand(SUBNORMAL, 1)
    assert bool(((l != 0) & (l.abs() < 1.17549435e-38)).any())
    nsl = 8
    (sl, s), = tsl.slice_pairs([(h, l)], nsl, 32, rowwise)
    w = 2.0 ** (-tsl.NB * (np.arange(nsl) + 1.0))
    val = np.tensordot(w, sl.numpy().astype(np.float64), axes=1) * s.numpy().astype(np.float64)
    ref = np.pad(h.numpy().astype(np.float64) + l.numpy(), [(0, 0), (0, 8)])
    # truncation below the last slice plus the rounding of the lo injection
    assert np.all(np.abs(val - ref) <= 2.0 ** -48 * s.numpy())
    assert not np.array_equal(val, np.pad(h.numpy().astype(np.float64), [(0, 0), (0, 8)]))


def _spd_with_d(seed, n):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(n, n)) * np.exp(rng.normal(0, 2, size=(1, n)))
    A = G.T @ G + n * np.eye(n)
    A[5] *= 1e-20          # a row of tiny values: subnormal lo parts after the split
    A[:, 5] *= 1e-20
    return A, 1.0 / np.sqrt(np.abs(np.diag(A)))


@pytest.mark.parametrize("n", [40, 131, 256])
def test_k5_matrix_stage_twin_bit_identical_to_reference(n):
    import sfft_tpu  # noqa: F401  (x64)
    from sfft_tpu.core import solve as jsolve

    import jax

    A, d = _spd_with_d(n, n)
    Ah_j, Asl_j, sa_j, chunk = jax.jit(jsolve._sliced_residual_setup)(A, d)
    assert chunk is None
    np_ = n + (-n) % 8
    Ah, sl, s = tsl.slice_rows_f64(torch.as_tensor(A), torch.as_tensor(d), 12, np_)
    np.testing.assert_array_equal(Ah.numpy(), np.asarray(Ah_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sa_j))
    np.testing.assert_array_equal(sl[..., :n].reshape(12 * n, n).numpy(), np.asarray(Asl_j))
    assert not sl[..., n:].any()
    # the solve's own setup is this stage
    Ah2, Asl2, sa2 = tsolve._sliced_residual_setup(torch.as_tensor(A), torch.as_tensor(d))
    assert torch.equal(Ah2, Ah) and torch.equal(sa2, s)
    assert torch.equal(Asl2, sl.reshape(12 * n, np_))


def test_k5_vector_stage_twin_bit_identical_to_reference():
    import jax.numpy as jnp
    import sfft_tpu  # noqa: F401  (x64)
    from sfft_tpu.core import exact_fft as jef

    rng = np.random.default_rng(9)
    n = 203
    x = rng.normal(size=n) * np.exp(rng.normal(0, 6, size=n))
    hi = x.astype(np.float32)
    rem = x - hi
    mid = rem.astype(np.float32)
    lo = (rem - mid).astype(np.float32)
    sl_j, s_j = jef._slice_triple_real(jnp.asarray(hi), jnp.asarray(mid), jnp.asarray(lo), 12,
                                       rowwise=False)
    buf = torch.full((64, 208), 77, dtype=torch.int8)
    s = tsl.slice_vec_f64(torch.as_tensor(x), 12, buf)
    np.testing.assert_array_equal(buf[:12, :n].numpy(), np.asarray(sl_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    assert not buf[:12, n:].any() and bool((buf[12:] == 77).all())


# ----------------------------------------------------------------------------
# launch plans: every output element written once, every view element read once
# ----------------------------------------------------------------------------

PLAN_CASES = [
    ((6, 37), (37, 1), 40), ((1001,), (1,), 1008), ((3, 40, 13), (520, 1, 40), 16),
    ((3, 40, 256), (1, 768, 3), 256), ((64, 29), (40, 1), 32), ((5, 33, 130), (4290, 1, 33), 136),
    ((2, 7, 300), (2100, 300, 1), 300), ((4, 50, 5000), (250000, 5000, 1), 5000),
    ((451, 30, 30), (1, 13530, 451), 32), ((16, 45, 900), (40500, 1, 45), 904),
    ((1, 1, 90), (90, 90, 1), 96), ((2, 3, 4, 9), (108, 36, 9, 1), 16),
    ((451, 30, 30), (900, 1, 30), 32),
]


def _view_offsets(shape, strides):
    idx = np.indices(shape).reshape(len(shape), -1)
    return (np.asarray(strides)[:, None] * idx).sum(0)


def _emulate(plan, shape, Kp):
    """(output writes per (row, col), input offsets read per pass) of the
    kernel that `plan` launches, following slice_pair.cu's index arithmetic
    (all 256 threads of a block at once)."""
    K = shape[-1]
    rows = plan["n_outer"] * plan["n_inner"]
    writes = np.zeros((rows, Kp), np.int64)
    reads = []
    so, si, sk = plan["strides"][0]

    def cover(orow, c0, ok, n):
        # n columns from c0 for the threads with ok, inside the row
        c = c0[ok, None] + np.arange(n)
        r = np.broadcast_to(orow[ok, None], c.shape)
        inside = c < Kp
        np.add.at(writes, (r[inside], c[inside]), 1)

    def read(o, i, c0, ok, n):
        c = c0[ok, None] + np.arange(n)
        base = np.broadcast_to((o * so + i * si)[ok, None], c.shape)
        live = c < K
        reads.append((base + c * sk)[live])

    if plan["mode"] == 0:
        # 8 neighbouring columns per thread
        G, threads = plan["G"], plan["threads"]
        t = np.arange(threads)
        span = G * 8
        for bx in range(plan["blocks"]):
            row = bx * (threads // G) + t // G
            ok = row < rows
            o, i = np.divmod(row, plan["n_inner"])
            for tile in range(-(-Kp // span)):
                c0 = tile * span + (t % G) * 8
                go = ok & (c0 < Kp)
                cover(row, c0, go, 8)
                read(o, i, c0, go, 8)
        return writes, np.concatenate(reads)
    # 16 neighbouring columns per thread
    WC, threads = plan["WC"], plan["threads"]
    t = np.arange(threads)
    TR, TC = threads // WC, 16 * WC
    ntiles = -(-Kp // TC)
    for bx in range(plan["blocks"]):
        kb, rest = bx % plan["kblocks"], bx // plan["kblocks"]
        it, o = rest % plan["tiles_inner"], rest // plan["tiles_inner"]
        for kt in range(kb, ntiles, plan["kblocks"]):
            i = it * TR + (t // 32 // WC) * 32 + t % 32
            read(np.full(threads, o), i, kt * TC + (t // 32 % WC) * 16, i < plan["n_inner"], 16)
            # the write-out through the shared tile: thread -> (row, 16 columns)
            wi, wc = it * TR + t // WC, kt * TC + (t % WC) * 16
            cover(o * plan["o_outer"] + wi * plan["o_inner"], wc,
                  (wi < plan["n_inner"]) & (wc < Kp), 16)
    return writes, np.concatenate(reads)


def _emulate_rowmax(plan, shape):
    """The (row, column) elements the row-max launch reads, per row."""
    K = shape[-1]
    tiles32 = -(-plan["n_inner"] // 32)
    kc = plan["rowmax"]
    cw = -(-K // kc)
    seen = np.zeros((plan["n_outer"] * plan["n_inner"], K), np.int64)
    lane, warp = np.arange(256) % 32, np.arange(256) // 32
    for bx in range(plan["n_outer"] * tiles32 * kc):
        k, tile = bx % kc, bx // kc
        it, o = tile % tiles32, tile // tiles32
        i = it * 32 + lane
        for c in range(k * cw, min(K, (k + 1) * cw)):
            ok = (i < plan["n_inner"]) & (warp == (c - k * cw) % 8)
            np.add.at(seen, (o * plan["o_outer"] + i[ok] * plan["o_inner"], c), 1)
    return seen


@pytest.mark.parametrize("rowwise", [True, False])
@pytest.mark.parametrize("shape,strides,Kp", PLAN_CASES)
def test_pairs_plan_covers_every_element_once(shape, strides, Kp, rowwise):
    plan = tsl._pairs_plan(shape, [strides, strides], Kp, rowwise)
    assert (plan["mode"] == 0) == (strides[-1] == 1 or shape[-1] == 1)
    writes, reads = _emulate(plan, shape, Kp)
    assert writes.shape[0] == int(np.prod(shape[:-1])) and np.all(writes == 1)
    np.testing.assert_array_equal(np.sort(reads), np.sort(_view_offsets(shape, strides)))
    if plan["rowmax"]:
        assert rowwise and plan["mode"] == 1
        assert np.all(_emulate_rowmax(plan, shape) == 1)
    # the output rows are the logical rows of the view, in order
    if plan["mode"] == 1:
        rows = [(o * plan["o_outer"] + i * plan["o_inner"])
                for o in range(plan["n_outer"]) for i in range(plan["n_inner"])]
        assert sorted(rows) == list(range(len(rows)))


@pytest.mark.parametrize("shape,strides,Kp", PLAN_CASES)
def test_absmax_plan_reads_the_view_once(shape, strides, Kp):
    mn, ms, dense = tsl._absmax_plan(shape, strides)
    assert int(np.prod(mn)) == int(np.prod(shape))
    offs = _view_offsets(mn, ms)
    np.testing.assert_array_equal(np.sort(offs), np.sort(_view_offsets(shape, strides)))
    assert dense == (np.array_equal(np.sort(offs), np.arange(offs.size)))


def test_stage_refusals():
    h = torch.ones((4, 8))
    with pytest.raises(TypeError):
        tsl.slice_pairs([(h.double(), h.double())], 8)
    with pytest.raises(ValueError):
        tsl.slice_pairs([(h, h), (h, h), (h, h)], 8)               # three parts
    with pytest.raises(ValueError):
        tsl.slice_pairs([(h, h), (h[:, :4], h[:, :4])], 8)        # parts of two shapes
    with pytest.raises(ValueError):
        tsl.slice_pairs([(h, h)], 17)                              # nsl out of range
    with pytest.raises(ValueError):
        tsl.slice_pairs([(h, h)], 8, Kp=7)                         # Kp < K
    with pytest.raises(ValueError):                                # three row axes
        tsl._row_dims((2, 3, 4, 5), [(1, 100, 7, 1000)])
    A = torch.ones((4, 6), dtype=torch.float64)
    with pytest.raises(ValueError):
        tsl.slice_rows_f64(A, torch.ones(4, dtype=torch.float64), 12)   # d shorter than K
    with pytest.raises(ValueError):
        tsl.slice_rows_f64(A, torch.ones(6, dtype=torch.float64), 7)    # nsl < 8
    with pytest.raises(ValueError):
        tsl.slice_vec_f64(A[0], 12, torch.zeros((8, 8), dtype=torch.int8))  # rows < nsl


# ----------------------------------------------------------------------------
# the kernels against the twins, on the card
# ----------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rowwise", [True, False])
@pytest.mark.parametrize("case", VIEWS + [SUBNORMAL], ids=[v[0] for v in VIEWS + [SUBNORMAL]])
def test_k4_stage_kernel_bit_identical_to_twin_on_gpu(cuda, case, rowwise):
    for nparts in (1, 2):
        parts = _operand(case, nparts, cuda)
        K = parts[0][0].shape[-1]
        for Kp, nsl in [(K, 1), (K + (-K) % 8, 9), (K + 21, 16)]:
            before = tsl.slice_pair.launches
            got = tsl.slice_pairs(parts, nsl, Kp, rowwise)
            torch.cuda.synchronize()
            assert tsl.slice_pair.launches == before + 1
            for (sl, s), (rsl, rs) in zip(got, tsl.slice_pairs_plain(parts, nsl, Kp, rowwise)):
                assert torch.equal(sl, rsl) and torch.equal(s, rs)


@pytest.mark.gpu
@pytest.mark.parametrize("n,K,out_cols", [(64, 1207, 1208), (37, 53, 55), (16, 384, 384),
                                          (3, 30011, 30016)])
def test_k5_stages_bit_identical_to_twins_on_gpu(cuda, n, K, out_cols):
    rng = np.random.default_rng(n)
    A = torch.as_tensor(rng.normal(size=(n, K)) * np.exp(rng.normal(0, 4, size=(n, K))),
                        device=cuda)
    A[1] = 0.0
    d = torch.as_tensor(np.exp(rng.normal(0, 2, size=max(n, K))), device=cuda)
    for nsl in (8, 12, 16):
        got = tsl.slice_rows_f64(A, d, nsl, out_cols)
        torch.cuda.synchronize()
        for g, r in zip(got, tsl.slice_rows_f64_plain(A, d, nsl, out_cols)):
            assert torch.equal(g, r)
    x = A[0].contiguous()
    buf = torch.full((16, out_cols), 5, dtype=torch.int8, device=cuda)
    want = buf.clone()
    s = tsl.slice_vec_f64(x, 12, buf)
    assert torch.equal(s, tsl.slice_vec_f64_plain(x, 12, want)) and torch.equal(buf, want)
