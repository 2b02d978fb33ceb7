"""Windowed correlations (K1 and its plain twins) and the 'fft' greek tables
against sfft_tpu.

On the CPU the port's corr_window wrapper runs the plain 'matmul' twin; all
methods are held to sfft_tpu's corr_window_fft on the same spectra, at the
bounds of tests/test_peel.py:111 (rtol 1e-10, atol 1e-8) in complex128. The
CUDA kernel is held to the twin by the `gpu`-marked cases (and by
chip_smoke.py). The reference is imported inside the tests, so the `gpu`
cases also run where jax is absent (``pytest --noconftest -m gpu``).
"""

import numpy as np
import pytest
import torch

from sfft_tpu_torch.core import greek as tgreek

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _stack(seed=11, F=4, N0=48, N1=40):
    return np.random.default_rng(seed).normal(10, 3, (F, N0, N1))


def _ref_corr(A, B, wx, wy, **kw):
    import jax.numpy as jnp
    from sfft_tpu.core.greek import corr_window_fft

    sa = jnp.fft.rfft2(jnp.asarray(A))
    sb = sa if B is None else jnp.fft.rfft2(jnp.asarray(B))
    return np.asarray(corr_window_fft(sa, sb, A.shape[1], A.shape[2], wx, wy, **kw))


def _port_corr(A, B, wx, wy, dtype=torch.float64, **kw):
    sa = torch.fft.rfft2(torch.as_tensor(A, dtype=dtype))
    sb = sa if B is None else torch.fft.rfft2(torch.as_tensor(B, dtype=dtype))
    return tgreek.corr_window_fft(sa, sb, A.shape[1], A.shape[2], wx, wy, **kw).numpy()


@pytest.mark.parametrize("method,kw", [
    ("irfft", {}),
    ("matmul", {}),
    ("matmul", {"chunk": 5}),
    ("matmul", {"symmetric": True}),
    ("kernel", {}),
    ("kernel", {"symmetric": True, "chunk": 5}),
    ("auto", {"symmetric": True}),
])
def test_corr_window_matches_reference(method, kw):
    A = _stack()
    ref = _ref_corr(A, None, 5, 4, method="irfft")
    out = _port_corr(A, None, 5, 4, method=method, **kw)
    assert out.shape == (4, 4, 11, 9) and out.dtype == np.float64
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-8)
    if method != "kernel":
        ref_m = _ref_corr(A, None, 5, 4, method=method if method != "auto" else "irfft", **kw)
        np.testing.assert_allclose(out, ref_m, rtol=1e-10, atol=1e-8)


def test_corr_window_cross_stacks():
    A = _stack(seed=3, F=3)
    B = _stack(seed=4, F=2)
    ref = _ref_corr(A, B, 3, 2, method="matmul", chunk=4)
    for method in ("irfft", "matmul", "kernel"):
        out = _port_corr(A, B, 3, 2, method=method, chunk=4)
        assert out.shape == (3, 2, 7, 5)
        np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-8)


def test_corr_window_complex64_twin():
    """c64 spectra (the peeled path's fluctuation planes): f32 sums in
    another order than the f64 reference, so the bound is relative to the
    table scale: 1e-5 * max|ref| (about 100 f32 ulps of accumulated
    rounding over a 48 x 21 spectrum)."""
    A = _stack(seed=7) - 10.0   # fluctuation-like, zero mean
    ref = _ref_corr(A, None, 5, 4, method="irfft")
    scale = np.abs(ref).max()
    for method in ("irfft", "matmul", "kernel"):
        out = _port_corr(A, None, 5, 4, dtype=torch.float32, method=method, symmetric=True)
        assert out.dtype == np.float32
        assert np.abs(out - ref).max() <= 1e-5 * scale, method


def test_partial_idft_mats_equal():
    from sfft_tpu.core import greek as jgreek

    for N0, N1, wx, wy in [(48, 40, 5, 4), (33, 31, 2, 3), (64, 64, 16, 16)]:
        np.testing.assert_array_equal(tgreek._window_row_indices(N0, wx),
                                      jgreek._window_row_indices(N0, wx))
        for cd in (np.complex128, np.complex64):
            for a, b in zip(tgreek._partial_idft_mats(N0, N1, wx, wy, cd),
                            jgreek._partial_idft_mats(N0, N1, wx, wy, cd)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("w", [1, 3])
def test_greek_tables_fft_match_reference(w):
    import jax.numpy as jnp
    from sfft_tpu.config import BasisSpec as JB
    from sfft_tpu.core.basis import basis_planes as jplanes
    from sfft_tpu.core.greek import greek_tables as jgreek_tables
    from sfft_tpu_torch.config import BasisSpec as TB
    from sfft_tpu_torch.core.basis import basis_planes as tplanes

    rng = np.random.default_rng(21 + w)
    I = 100 + rng.normal(0, 5, (48, 40))
    J = 1.1 * I + rng.normal(0, 1, (48, 40))
    SIj = jnp.asarray(I)[None] * jplanes(JB("polynomial", 2), 48, 40)
    STj = jplanes(JB("polynomial", 1), 48, 40)
    ref = jgreek_tables(SIj, STj, jnp.asarray(J), w, w, backend="fft")
    SIt = torch.as_tensor(I)[None] * tplanes(TB("polynomial", 2), 48, 40)
    STt = tplanes(TB("polynomial", 1), 48, 40)
    for plain in (False, True):
        out = tgreek.greek_tables(SIt, STt, torch.as_tensor(J), w, w, backend="fft",
                                  plain=plain)
        for name, a, b in zip(["Comg", "Cgam", "Cthe", "Cphi", "Cdel"], out, ref):
            b = np.asarray(b)
            assert a.dtype == torch.float64 and tuple(a.shape) == b.shape, name
            assert np.abs(a.numpy() - b).max() <= 1e-9 * np.abs(b).max(), name


def test_greek_tables_unported_backends_raise():
    SI = torch.zeros((6, 32, 32), dtype=torch.float64)
    # every backend of sfft_tpu is ported: only an unknown name raises
    with pytest.raises(ValueError):
        tgreek.greek_tables(SI, SI[:3], SI[0], 1, 1, backend="nope")
    # 'corr' is ported (K8's twin; held to sfft_tpu in test_torch_corr_conv.py)
    out = tgreek.greek_tables(SI, SI[:3], SI[0], 1, 1, backend="corr")
    assert tuple(out[0].shape) == (6, 6, 5, 5) and not any(bool(o.any()) for o in out)
    # 'fft32' is ported (f32 tables; held to sfft_tpu in test_torch_v2_fast.py)
    out = tgreek.greek_tables(SI, SI[:3], SI[0], 1, 1, backend="fft32")
    assert all(o.dtype == torch.float32 for o in out)
    # 'exact' is ported (held to sfft_tpu in test_torch_v2_engine.py)
    out = tgreek.greek_tables(SI, SI[:3], SI[0], 1, 1, backend="exact")
    assert tuple(out[0].shape) == (6, 6, 5, 5) and not any(bool(o.any()) for o in out)


def test_corr_window_wrapper_refusals():
    spec = torch.fft.rfft2(torch.as_tensor(_stack()))
    E0, E1 = tgreek._idft_mats_on(48, 40, 5, 4, spec.dtype, spec.device)
    ia, ib = [0, 1], [1, 2]
    with pytest.raises(ValueError):   # lazy conjugate view
        tgreek.corr_window(spec, spec.conj(), ia, ib, E0, E1)
    with pytest.raises(ValueError):   # non-contiguous
        tgreek.corr_window(spec[:, :, ::2], spec[:, :, ::2], ia, ib, E0, E1[::2])
    with pytest.raises(TypeError):    # mixed dtypes
        tgreek.corr_window(spec, spec.to(torch.complex64), ia, ib, E0, E1)
    with pytest.raises(TypeError):    # real input
        tgreek.corr_window(spec.real.contiguous(), spec.real.contiguous(), ia, ib, E0, E1)
    with pytest.raises(ValueError):   # E1 of the wrong length
        tgreek.corr_window(spec, spec, ia, ib, E0, E1[:-1])
    with pytest.raises(IndexError):
        tgreek.corr_window(spec, spec, [0, 4], [0, 0], E0, E1)
    before = tgreek.corr_window.launches
    out = tgreek.corr_window(spec, spec, ia, ib, E0, E1)
    assert out.shape == (2, 11, 9) and tgreek.corr_window.launches == before


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("R1", [1, 2, 3, 4, 9, 10, 17, 23, 33, 47, 63, 64])
def test_corr_plan_covers_every_lag_once(R1, sym):
    """The lag groups of a K1 launch tile the lag slots: every slot in
    exactly one group, no group empty, within the kernel's limits; with the
    conjugate-pair lags the slots d = 0..w stand for the columns w + d and
    w - d, which together are every column once."""
    ty, ne = tgreek._corr_plan(R1, sym)
    assert 1 <= ty <= tgreek._MAX_GROUPS and ne in tgreek._LAGS_PER_THREAD
    L = R1 // 2 + 1 if sym else R1
    groups = [range(g * ne, min(L, (g + 1) * ne)) for g in range(ty)]
    assert all(len(g) > 0 for g in groups)
    slots = sorted(d for g in groups for d in g)
    assert slots == list(range(L))
    if sym and R1 % 2:
        w = R1 // 2
        cols = sorted([w + d for d in slots] + [w - d for d in slots if d > 0])
        assert cols == list(range(R1))
    assert 1 <= tgreek._pairs_per_block(ty) <= 4


def test_corr_plan_fast_slice_shapes():
    # the peeled path's two windows: 17 slots of lag pairs in 2 groups of 9,
    # 9 slots in 2 groups of 5; one warp per pair, so four pairs per block
    assert tgreek._corr_plan(33, True) == (2, 9)
    assert tgreek._corr_plan(17, True) == (2, 5)
    assert tgreek._corr_plan(33, False) == (4, 9)
    assert tgreek._pairs_per_block(2) == 4 and tgreek._pairs_per_block(4) == 2
    assert tgreek._pairs_per_block(8) == 1


def _pair_lists():
    iu, ju = np.triu_indices(6)
    ia, ib = np.meshgrid(np.arange(6), np.arange(3), indexing="ij")
    return {
        "symmetric": (iu, ju, True),
        "cross": (ia.ravel(), ib.ravel(), False),
        "against_one": (np.arange(6), np.zeros(6, int), False),
        "one_against": (np.zeros(5, int), np.arange(5), False),
        "chunk_of_triangle": (iu[3:8], ju[3:8], True),
        "repeated": ([3, 0, 3, 1, 1, 0, 2, 3, 3, 3, 3, 3], [1, 1, 3, 0, 1, 2, 2, 0, 1, 1, 1, 1],
                     True),
        "repeated_cross": ([2, 2, 2, 2, 2, 0], [1, 1, 1, 1, 1, 1], False),
        "single": ([4], [2], False),
        "single_self": ([4], [4], True),
    }


@pytest.mark.parametrize("ppb", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(_pair_lists()))
def test_pair_groups_cover_every_pair_once(name, ppb):
    """The schedule of a K1 launch: every pair of the list in exactly one
    group, with the planes it names; at most ppb pairs and 4 planes a
    group; the table the kernel reads says the same."""
    ia, ib, same = _pair_lists()[name]
    groups = tgreek._pair_groups(ia, ib, same, ppb)
    seen = []
    for slots, pairs in groups:
        assert 1 <= len(pairs) <= ppb and 1 <= len(slots) <= tgreek._GROUP_SLOTS
        assert len(set(slots)) == len(slots)
        used = set()
        for sa, sb, c in pairs:
            assert slots[sa] == (0, int(ia[c]))
            assert slots[sb] == (0 if same else 1, int(ib[c]))
            used.update((sa, sb))
            seen.append(c)
        assert used == set(range(len(slots)))      # no plane copied for nothing
    assert sorted(seen) == list(range(len(ia)))
    tab = tgreek._group_table(groups)
    assert tab.shape == (len(groups), tgreek._GROUP_INTS) and tab.dtype == np.int32
    back = []
    for row in tab:
        for k in range(row[0]):
            sa, sb = row[10 + k] % 4, row[10 + k] // 4
            assert sa < row[1] and sb < row[1]
            back.append((row[14 + k], row[2 + sa], row[6 + sa], row[2 + sb], row[6 + sb]))
    assert sorted(back) == [(c, int(ia[c]), 0, int(ib[c]), 0 if same else 1)
                            for c in range(len(ia))]


def test_pair_groups_share_planes():
    # the 21 pairs of six planes in 6 groups that copy 18 plane tiles, not 42
    iu, ju = np.triu_indices(6)
    groups = tgreek._pair_groups(iu, ju, True, 4)
    assert len(groups) == 6 and sum(len(s) for s, _ in groups) == 18
    # six planes against one: 2 groups of 3 pairs, 8 tiles, not 12
    groups = tgreek._pair_groups(np.arange(6), np.zeros(6, int), False, 4)
    assert [len(p) for _, p in groups] == [3, 3] and sum(len(s) for s, _ in groups) == 8


@pytest.mark.parametrize("symmetric,chunk", [(True, 0), (True, 4), (True, 1), (False, 0),
                                             (False, 5), (False, 1)])
def test_corr_window_fft_pair_schedule(monkeypatch, symmetric, chunk):
    """Every pair of the window tensor goes to the pair function exactly
    once (the upper triangle when symmetric), whatever the chunk."""
    spec = torch.fft.rfft2(torch.as_tensor(_stack(F=5)))
    seen = []
    real = tgreek.corr_pairs_plain

    def recording(sa, sb, ia, ib, E0, E1):
        assert chunk == 0 or len(ia) <= chunk
        seen.extend(zip(map(int, ia), map(int, ib)))
        return real(sa, sb, ia, ib, E0, E1)

    monkeypatch.setattr(tgreek, "corr_pairs_plain", recording)
    out = tgreek.corr_window_fft(spec, spec, 48, 40, 3, 2, method="matmul",
                                 symmetric=symmetric, chunk=chunk)
    want = [(a, b) for a in range(5) for b in range(5) if not symmetric or a <= b]
    assert sorted(seen) == want
    monkeypatch.undo()
    ref = tgreek.corr_window_fft(spec, spec, 48, 40, 3, 2, method="irfft")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-10, atol=1e-8)


def test_corr_window_unordered_repeated_and_single_pairs():
    spec = torch.fft.rfft2(torch.as_tensor(_stack()))
    E0, E1 = tgreek._idft_mats_on(48, 40, 5, 4, spec.dtype, spec.device)
    ia, ib = [3, 0, 3, 1, 1, 0, 2, 3], [1, 1, 3, 0, 1, 2, 2, 0]
    out = tgreek.corr_window(spec, spec, ia, ib, E0, E1)
    for c, (a, b) in enumerate(zip(ia, ib)):
        one = tgreek.corr_window(spec, spec, [a], [b], E0, E1)
        assert one.shape == (1, 11, 9)
        np.testing.assert_allclose(out[c].numpy(), one[0].numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bound", [(torch.complex64, 1e-5), (torch.complex128, 1e-11)])
@pytest.mark.parametrize("symmetric", [True, False])
def test_corr_window_kernel_matches_twin_on_gpu(cuda, dtype, bound, symmetric):
    rng = np.random.default_rng(2)
    real = torch.float32 if dtype == torch.complex64 else torch.float64
    A = torch.as_tensor(rng.normal(0, 1, (6, 512, 512)), dtype=real, device=cuda)
    spec = torch.fft.rfft2(A)
    for wx, wy, chunk in [(16, 16, 0), (8, 8, 5), (5, 3, 0)]:
        before = tgreek.corr_window.launches
        out = tgreek.corr_window_fft(spec, spec, 512, 512, wx, wy, method="kernel",
                                     symmetric=symmetric, chunk=chunk)
        torch.cuda.synchronize()
        assert tgreek.corr_window.launches > before
        ref = tgreek.corr_window_fft(spec, spec, 512, 512, wx, wy, method="matmul",
                                     symmetric=symmetric, chunk=chunk)
        err = float((out - ref).abs().max() / ref.abs().max())
        assert err <= bound, (wx, wy, chunk, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bound", [(torch.complex64, 1e-5), (torch.complex128, 1e-11)])
@pytest.mark.parametrize("N0,N1h", [(100, 51), (131, 52), (64, 17)])
def test_corr_window_kernel_ragged_and_deterministic_on_gpu(cuda, dtype, bound, N0, N1h):
    """Rows off the row tile, odd and even N1h, 1 to 64 lags, general and
    conjugate-symmetric weights, an unordered pair list with repeated planes
    and a single pair; twice, bit-equal."""
    rng = np.random.default_rng(4)

    def cplx(*shape):
        return torch.view_as_complex(torch.as_tensor(
            rng.normal(0, 1, shape + (2,)), device=cuda)).to(dtype)

    sa, sb = cplx(4, N0, N1h), cplx(4, N0, N1h)
    ia, ib = np.array([3, 0, 3, 1, 1, 0, 2, 3]), np.array([1, 1, 3, 0, 1, 2, 2, 0])
    for R0, R1 in [(1, 1), (17, 17), (33, 33), (5, 64), (7, 10)]:
        E0, E1 = cplx(R0, N0), cplx(N1h, R1)
        variants = [(E1, False)]
        if R1 % 2:   # conjugate-symmetric weights: the half-work variant, and the general one
            w = R1 // 2
            Es = torch.cat([torch.flip(E1[:, w + 1:], dims=(1,)).conj(), E1[:, w:]],
                           dim=1).resolve_conj().contiguous()
            variants += [(Es, True), (Es, False)]
        for E, sym in variants:
            for pa, pb in [(ia, ib), (ia[:1], ib[:1])]:
                before = tgreek.corr_window.launches
                out = tgreek._corr_window(sa, sb, pa, pb, E0, E, sym=sym)
                again = tgreek._corr_window(sa, sb, pa, pb, E0, E, sym=sym)
                torch.cuda.synchronize()
                assert tgreek.corr_window.launches == before + 2
                assert torch.equal(out, again)
                ref = tgreek.corr_pairs_plain(sa, sb, pa, pb, E0, E)
                err = float((out - ref).abs().max() / ref.abs().max())
                assert err <= bound, (R0, R1, sym, len(pa), err)


@pytest.mark.gpu
def test_corr_window_kernel_on_side_stream_on_gpu(cuda):
    rng = np.random.default_rng(5)
    A = torch.as_tensor(rng.normal(0, 1, (5, 200, 150)), dtype=torch.float32, device=cuda)
    spec = torch.fft.rfft2(A)
    ref = tgreek.corr_window_fft(spec, spec, 200, 150, 8, 16, method="matmul", symmetric=True)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        out = tgreek.corr_window_fft(spec, spec, 200, 150, 8, 16, method="kernel",
                                     symmetric=True, chunk=4)
    side.synchronize()
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-5


@pytest.mark.gpu
def test_corr_window_refusals_on_gpu(cuda):
    spec = torch.fft.rfft2(torch.as_tensor(_stack(), device=cuda))
    E0, E1 = tgreek._idft_mats_on(48, 40, 5, 4, spec.dtype, spec.device)
    ia, ib = [0, 1], [1, 2]
    with pytest.raises(ValueError):   # lazy conjugate view
        tgreek.corr_window(spec, spec.conj(), ia, ib, E0, E1)
    with pytest.raises(ValueError):   # no pairs
        tgreek.corr_window(spec, spec, [], [], E0, E1)
    with pytest.raises(ValueError):   # more than 64 lags along axis 1
        wide = torch.zeros((21, 65), dtype=spec.dtype, device=cuda)
        tgreek.corr_window(spec, spec, ia, ib, E0, wide)
    with pytest.raises(ValueError):   # operands on two devices
        tgreek.corr_window(spec, spec, ia, ib, E0.cpu(), E1)
    with pytest.raises(IndexError):
        tgreek.corr_window(spec, spec, [0, 4], [0, 0], E0, E1)
