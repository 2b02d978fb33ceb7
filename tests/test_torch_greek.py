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
def test_k1_plan_covers_every_lag_once(R1, sym):
    """The n-groups of a K1 launch tile the lag slots: every slot in exactly
    one n-group, none empty, within the kernel's limits; with the
    conjugate-pair lags the slots d = 0..w stand for the columns w + d and
    w - d, which together are every column once. The packed E1 holds each
    part of each column the slots read exactly once, at row v of the lane
    (g, t) with v % 4 == t, and zeros elsewhere."""
    S, NT, nng = tgreek._k1_plan(R1, sym)
    assert S == (R1 // 2 + 1 if sym else R1)
    assert 1 <= NT <= tgreek._K1_NT_MAX and 1 <= nng <= 3
    slot_groups = [range(4 * NT * ng, min(S, 4 * NT * (ng + 1))) for ng in range(nng)]
    assert all(len(r) > 0 for r in slot_groups)
    slots = sorted(d for r in slot_groups for d in r)
    assert slots == list(range(S))
    if sym and R1 % 2:
        w = R1 // 2
        cols = sorted([w + d for d in slots] + [w - d for d in slots if d > 0])
        assert cols == list(range(R1))
    ppb = tgreek._k1_pairs_per_block(nng)
    assert 1 <= ppb and ppb * nng <= tgreek._BLOCK_WARPS
    if sym and R1 % 2 == 0:
        return                    # the launch takes the general route for an even R1
    N1h = 37
    idx = tgreek._k1_e1_index(N1h, R1, sym, NT * nng)
    assert idx.shape == (-(-N1h // 64) * 16, NT * nng, 32)
    zero = 2 * N1h * R1
    got = np.sort(idx[idx != zero])
    first = R1 // 2 if sym else 0
    want = [(v * R1 + c) * 2 + p for v in range(N1h) for c in range(first, R1) for p in (0, 1)]
    assert got.tolist() == want
    k, n, lane = np.nonzero(idx != zero)
    v, rem = np.divmod(idx[k, n, lane] // 2, R1)
    assert (v == 4 * k + (lane & 3)).all() and (rem - first == 4 * n + (lane >> 3)).all()
    assert (idx[k, n, lane] % 2 == (lane >> 2) % 2).all()


def test_k1_plan_fast_slice_and_v2_shapes():
    # (S, NT, nng): the 4096^2 OMG window's 17 conjugate-pair slots in 5
    # n-tiles (40 columns of 34), THE's 9 in 3 (24 of 18), v2 Comg's 23 in 6
    # (48 of 46), v2 Cgam / Cthe / Pbs' 12 in 3 (24, none padded); one warp
    # a pair, four pairs a block. The general route: 33 columns in 2 n-groups
    # of 5 n-tiles (two pairs a block), 64 in 3 of 6 (one pair).
    assert tgreek._k1_plan(33, True) == (17, 5, 1)
    assert tgreek._k1_plan(17, True) == (9, 3, 1)
    assert tgreek._k1_plan(45, True) == (23, 6, 1)
    assert tgreek._k1_plan(23, True) == (12, 3, 1)
    assert tgreek._k1_plan(33, False) == (33, 5, 2)
    assert tgreek._k1_plan(64, False) == (64, 6, 3)
    assert [tgreek._k1_pairs_per_block(n) for n in (1, 2, 3)] == [4, 2, 1]


_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3   # lane (g, t) of an mma.sync fragment


def _frags(a0, a1, b):
    """The matrices of one mma.sync.m16n8k4 (f64) from its lanes' fragments
    (..., 32): lane (g, t) holds A[g, t] (a0), A[g + 8, t] (a1) and B[t, g]
    (b); returns A (..., 16, 4) and B (..., 4, 8)."""
    Am = np.zeros(a0.shape[:-1] + (16, 4))
    Am[..., _G, _T] = a0
    Am[..., _G + 8, _T] = a1
    Bm = np.zeros(b.shape[:-1] + (4, 8))
    Bm[..., _T, _G] = b
    return Am, Bm


def k1_call_emulated(specA, specB, groups, ngroups, npairs, E0, E1p, R1, NT, nng, sym):
    """csrc/corr_window.cuh (corr_stage1, corr_stage2, corr_stage2_sum) in
    numpy, in complex128, block by block and warp by warp, lanes vectorised:
    the group table as the kernel reads it, the staged tiles of each slot
    (16 rows, zero past N0; columns past N1h hold finite junk, as a c64 tile
    buffer's stale columns may: the packed E1's zero rows meet them; a c128
    tensor box reads zeros there), each lane's fragment row (tile row 2 (g %
    4) + g / 4 of its m-tile) and column t, its h = a * conj(b), the packed
    E1's B fragments of its n-group, the accumulators of each (m-tile,
    n-tile) and the in-thread store of P1, P3, P4, P2 into T1 at w + s and
    w - s (each element written once); then stage 2's ranges of u in
    order."""
    A, B = specA.numpy(), specB.numpy()
    assert A.dtype == np.complex128
    tab = groups.numpy().reshape(ngroups, tgreek._GROUP_INTS)
    E1p, E0 = E1p.numpy(), E0.numpy()
    N0, N1h = A.shape[1], A.shape[2]
    UT, VT = tgreek._K1_ROWS, 16
    ntiles = -(-N1h // VT)
    nk = ntiles * VT // 4
    assert E1p.shape[1:] == (NT * nng, 32) and E1p.shape[0] >= nk
    S = R1 // 2 + 1 if sym else R1
    w = R1 // 2 if sym else 0
    junk = np.random.default_rng(0).normal(0, 1e3, (UT, ntiles * VT - N1h, 2)) @ [1, 1j]
    T1 = np.full((npairs, N0, R1), np.nan, complex)
    for bx in range(-(-N0 // UT) * ngroups):
        grp = tab[bx % ngroups]
        u0 = (bx // ngroups) * UT
        nr = min(UT, N0 - u0)
        tiles = []
        for s in range(grp[1]):
            tile = np.zeros((UT, ntiles * VT), complex)
            tile[:nr, :N1h] = (B if grp[6 + s] else A)[grp[2 + s], u0:u0 + nr]
            tile[:nr, N1h:] = junk[:nr]
            tiles.append(tile)
        for warp in range(tgreek._BLOCK_WARPS):
            pair, ng = divmod(warp, nng)
            if pair >= grp[0]:
                continue
            sa, sb = grp[10 + pair] % 4, grp[10 + pair] // 4
            assert max(sa, sb) < grp[1]
            cols = 4 * np.arange(nk)[:, None] + _T                        # (nk, 32)
            bf = E1p[:nk, ng * NT:(ng + 1) * NT]                           # (nk, NT, 32)
            _, Bm = _frags(bf, bf, bf)
            for mt in range(2):
                r = 8 * mt + 2 * (_G & 3) + (_G >> 2)
                h = tiles[sa][r, cols] * np.conj(tiles[sb][r, cols])
                Am, _ = _frags(h.real, h.imag, h.real)
                D = np.einsum("kij,knjc->nic", Am, Bm)                    # (NT, 16, 8)
                u = u0 + r
                for nt in range(NT):
                    c0, c1, c2, c3 = (D[nt, _G + 8 * (q >> 1), 2 * _T + (q & 1)]
                                      for q in range(4))
                    s = (ng * NT + nt) * 4 + _T
                    ok = (u < N0) & (s < S)
                    dst = (grp[14 + pair], u[ok], w + s[ok])
                    assert np.isnan(T1[dst]).all()
                    T1[dst] = ((c0 - c3) + 1j * (c1 + c2))[ok]
                    if sym:
                        ok &= s > 0
                        dst = (grp[14 + pair], u[ok], w - s[ok])
                        assert np.isnan(T1[dst]).all()
                        T1[dst] = ((c0 + c3) + 1j * (c2 - c1))[ok]
    assert not np.isnan(T1).any()
    chunk = -(-N0 // tgreek._U_RANGES)
    out = np.zeros((npairs, E0.shape[0], R1))
    for ub in range(0, N0, chunk):
        out += np.real(np.einsum("ru,cue->cre", E0[:, ub:ub + chunk], T1[:, ub:ub + chunk]))
    return torch.as_tensor(out)


def _k1_case(N0, N1h, R1, sym, same, seed):
    rng = np.random.default_rng(seed)

    def cplx(*shape):
        return torch.as_tensor(rng.normal(0, 1, shape) + 1j * rng.normal(0, 1, shape))

    sa = cplx(4, N0, N1h)
    sb = sa if same else cplx(4, N0, N1h)
    E0, E1 = cplx(7, N0), cplx(N1h, R1)
    if sym:   # conjugate-symmetric weights about the middle column
        w = R1 // 2
        E1 = torch.cat([torch.flip(E1[:, w + 1:], dims=(1,)).conj(), E1[:, w:]],
                       dim=1).resolve_conj().contiguous()
    return sa, sb, E0, E1


@pytest.mark.parametrize("N0,N1h,R1,sym,same", [
    (37, 21, 9, True, True),      # ragged rows and columns; slots share planes
    (37, 21, 9, False, False),
    (20, 36, 33, True, False),    # the OMG window's 17 slots in 5 n-tiles
    (20, 36, 33, False, True),    # 33 columns: two n-groups, two pairs a block
    (16, 9, 64, False, False),    # 64 columns: three n-groups of 6 n-tiles
    (45, 70, 45, True, True),     # v2 Comg's 23 slots in 6 n-tiles; five column tiles
    (8, 5, 1, False, False),      # one column, one n-tile
    (24, 33, 17, True, False)])   # THE's 9 slots in 3 n-tiles
def test_k1_launch_emulated(monkeypatch, N0, N1h, R1, sym, same):
    """K1's launch (plan, pair schedule, packed E1) with its kernel
    emulated (``k1_call_emulated``) on an unordered pair list with repeated
    planes, and on a single pair: within 1e-12 of the twin's max in
    complex128."""
    sa, sb, E0, E1 = _k1_case(N0, N1h, R1, sym, same, seed=N0 + R1)
    monkeypatch.setattr(tgreek, "_k1_call", k1_call_emulated)
    ia, ib = np.array([3, 0, 3, 1, 1, 0, 2, 3]), np.array([1, 1, 3, 0, 1, 2, 2, 0])
    for pa, pb in [(ia, ib), (ia[:1], ib[:1])]:
        out = tgreek._corr_launch(sa, sb, pa, pb, E0, E1, sym=sym)
        ref = tgreek.corr_pairs_plain(sa, sb, pa, pb, E0, E1)
        assert out.shape == ref.shape
        err = float((out - ref).abs().max() / ref.abs().max())
        assert err <= 1e-12, (len(pa), err)


@pytest.mark.parametrize("symmetric,chunk", [(True, 0), (True, 4), (False, 5)])
def test_k1_corr_window_fft_emulated(monkeypatch, symmetric, chunk):
    """corr_window_fft's 'kernel' method (the conjugate-pair route, the
    upper triangle mirrored when symmetric, chunks splitting a plane's
    pairs) with the launch emulated: within 1e-12 of the irfft route."""
    spec = torch.fft.rfft2(torch.as_tensor(_stack(F=5)))
    monkeypatch.setattr(tgreek, "_k1_call", k1_call_emulated)
    monkeypatch.setattr(tgreek, "_corr_window", tgreek._corr_launch)
    out = tgreek.corr_window_fft(spec, spec, 48, 40, 5, 4, method="kernel",
                                 symmetric=symmetric, chunk=chunk)
    monkeypatch.undo()
    ref = tgreek.corr_window_fft(spec, spec, 48, 40, 5, 4, method="irfft")
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-12


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
