"""The FFT-free f64 route of sfft_tpu_torch (greek 'corr' with K8, fdiff
'conv' with K9) against sfft_tpu on the CPU, and the two kernels against
their plain twins on the card.

- K8's twin (``greek.corr_window_conv_plain``) against sfft_tpu's
  corr_window_conv, within 1e-12 of the table's max (f64 sums over at most
  64^2 pixels; the two only order them differently).
- K9's twin (``fdiff.conv_direct_plain`` through ``fdiff_conv``) against
  sfft_tpu's fdiff_conv, with and without the scaling planes, within 1e-10
  of max|J|.
- ESS / GSS with corr / conv / lu and the NIRCam-shaped SEPARATE-VARYING
  configuration through BSP against sfft_tpu with the same configs:
  solution within 1e-6 of its max, difference within 1e-8 max|J| (the
  parity bounds of tests/test_engine.py:56-58).
- The launch plans of both kernels transliterated to numpy (every index of
  csrc/corr_direct.cu and csrc/conv_direct.cu: the lanes' fragment
  elements of mma.sync m16n8k4, the register blocking, the padding of
  planes, lags and K, Comg's mirrored half, the band partials and their
  fixed-order sum, K9's runs of one reach and tap chunks; every
  shared-memory slot written before it is read) through the wrappers' own
  plans, against the twins, within 1e-13 of max; convolve2d with a
  non-finite fill through K9's emulation against sfft_tpu's convolve2d.
- ``gpu``: the kernels against their twins on the card, ``corr_direct``'s
  pair lists, and convolve2d with a non-finite fill against sfft_tpu's
  numpy loop (skipped here).
"""

import dataclasses
import itertools
from functools import lru_cache

import numpy as np
import pytest
import torch

from sfft_tpu_torch.api import bspline as tbsp
from sfft_tpu_torch.core import engine as tengine
from sfft_tpu_torch.core import fdiff as tfdiff
from sfft_tpu_torch.core import greek as tgreek

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)

# sfft_tpu (and JAX) are imported inside the CPU tests: the `gpu` tests run
# on a machine without JAX


@lru_cache(maxsize=None)
def _jcorr():
    import sfft_tpu  # noqa: F401  (x64)
    import jax
    from sfft_tpu.core import greek as jgreek

    return jax.jit(jgreek.corr_window_conv, static_argnums=(2, 3))


def _cfgs(**kw):
    from test_torch_engine import cfgs

    return cfgs(**kw)


@pytest.mark.parametrize("Fa,Fb,N0,N1,w", [(3, 2, 64, 48, 1), (2, 4, 40, 64, 2), (4, 1, 33, 29, 3)])
def test_corr_twin_matches_reference(Fa, Fb, N0, N1, w):
    rng = np.random.default_rng(100 + w)
    A, B = rng.normal(size=(Fa, N0, N1)), rng.normal(size=(Fb, N0, N1))
    wx, wy = w, w + 1
    ref = np.asarray(_jcorr()(A, B, wx, wy))
    out = tgreek.corr_window_conv(torch.as_tensor(A), torch.as_tensor(B), wx, wy)
    assert out.shape == ref.shape == (Fa, Fb, 2 * wx + 1, 2 * wy + 1)
    assert np.abs(out.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    # the pair-list twin of K8 picks the same windows
    ia, ib = np.array([Fa - 1, 0]), np.array([0, Fb - 1])
    sub = tgreek.corr_direct(torch.as_tensor(A), torch.as_tensor(B), ia, ib, wx, wy)
    assert torch.equal(sub, out[ia, ib])


@pytest.mark.parametrize("separate", [False, True])
def test_conv_twin_matches_reference(separate):
    import jax
    import jax.numpy as jnp
    from sfft_tpu.core import fdiff as jfdiff

    rng = np.random.default_rng(7)
    jc, tc = _cfgs(N0=48, N1=40, w=2)
    Fij, Fpq = tc.Fij, tc.Fpq
    SI = rng.normal(100, 10, (Fij, 48, 40))
    ST = rng.normal(size=(Fpq, 48, 40))
    J = rng.normal(1000, 30, (48, 40))
    sol = rng.normal(0, 0.1, tc.Fijab + Fpq)
    SSc = rng.normal(50, 5, (Fij, 48, 40)) if separate else None
    fn = jax.jit(lambda s, a, t, j, c: jfdiff.fdiff_conv(jc, s, a, t, j, c))
    ref = np.asarray(fn(*(None if x is None else jnp.asarray(x) for x in (sol, SI, ST, J, SSc))))
    T = [None if x is None else torch.as_tensor(x) for x in (sol, SI, ST, J, SSc)]
    out = tfdiff.fdiff_conv(tc, *T)
    assert np.abs(out.numpy() - ref).max() <= 1e-10 * np.abs(J).max()
    # dispatch from fdiff, and the SEPARATE-VARYING form on the active planes
    # alone (the engine's call)
    tcc = dataclasses.replace(tc, fdiff_backend="conv")
    assert torch.equal(tfdiff.fdiff(tcc, *T), out)
    if separate:
        act = tfdiff.fdiff_conv(tc, T[0], T[1], T[2], T[3], T[4][:2])
        cut = T[4].clone()
        cut[2:] = 0.0
        assert np.abs((act - tfdiff.fdiff_conv(tc, T[0], T[1], T[2], T[3], cut)).numpy()).max() \
            <= 1e-12 * np.abs(J).max()


@pytest.mark.parametrize("backends", [dict(greek_backend="corr", fdiff_backend="conv"),
                                      dict(greek_backend="corr"), dict(fdiff_backend="conv")])
def test_ess_corr_conv_matches_reference(backends):
    """tests/test_engine.py::test_backend_consistency's pair, KerHW 2,
    poly2/poly2, through both packages' ESS with the same backends."""
    from sfft_tpu.core import engine as jengine
    from test_torch_engine import make_pair

    I, J = make_pair(3, 32, 28)
    jc, tc = _cfgs(N0=32, N1=28, w=2, **backends)
    sj, dj = jengine.ElementalSFFT.ESS(I, J, jc, Subtract=True)
    st, dt = tengine.ElementalSFFT.ESS(I, J, tc, Subtract=True, device="cpu")
    sj, dj = np.asarray(sj), np.asarray(dj)
    np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=1e-6 * np.abs(sj).max())
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=1e-8 * np.abs(J).max())


def test_gss_corr_conv_matches_fft_route_and_reference():
    """GSS on the benchmark pair's generator (masked planes differ from the
    unmasked): corr / conv / lu against sfft_tpu's and against the port's
    own fft / fft / lu."""
    from sfft_tpu.core import engine as jengine
    from test_torch_engine import make_bench_pair

    I, J = make_bench_pair(48, seed=4, k=12)
    mI, mJ = I.copy(), J.copy()
    mI[10:14, 20:26] = 0.0
    mJ[10:14, 20:26] = 0.0
    jc, tc = _cfgs(N0=48, N1=48, w=3, greek_backend="corr", fdiff_backend="conv")
    sj, dj, _ = jengine.GeneralSFFT.GSS(I, J, mI, mJ, jc)
    st, dt, _ = tengine.GeneralSFFT.GSS(I, J, mI, mJ, tc, device="cpu")
    sj, dj = np.asarray(sj), np.asarray(dj)
    np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=1e-6 * np.abs(sj).max())
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=1e-8 * np.abs(J).max())
    _, tf = _cfgs(N0=48, N1=48, w=3)
    sf, df, _ = tengine.GeneralSFFT.GSS(I, J, mI, mJ, tf, device="cpu")
    np.testing.assert_allclose(st.numpy(), sf.numpy(), rtol=0, atol=1e-6 * np.abs(sf.numpy()).max())
    np.testing.assert_allclose(dt.numpy(), df.numpy(), rtol=0, atol=1e-8 * np.abs(J).max())


def test_bsp_separate_varying_corr_conv_matches_reference(tmp_path):
    """The NIRCam-shaped v2 configuration (B-spline kernel, SEPARATE-VARYING
    degree-2 scaling, Tikhonov) through both packages' BSP with corr / conv
    / lu, on tests/test_torch_bspline_api.py's FITS pair: K8 on the Pbs
    table, K9 with the a00 planes."""
    from sfft_tpu.api import bspline as jbsp
    from sfft_tpu_torch.io import fits
    from test_torch_bspline_api import KW
    import v2_cases

    I, J = v2_cases.make_pair(5)
    files = []
    for name, a in [("ref", I), ("sci", J)]:
        holed = a.copy()
        holed[7:9, 11:13] = np.nan
        for tag, arr in [(name, holed), ("m" + name, a)]:
            files.append(str(tmp_path / f"{tag}.fits"))
            fits.write(files[-1], arr.T)
    args = (files[0], files[2], files[1], files[3])
    trio = dict(greek_backend="corr", fdiff_backend="conv", solver="lu")
    sj, dj = jbsp.BSplinePacket.BSP(*args, GKerHW=2, **KW, **trio)
    st, dt = tbsp.BSplinePacket.BSP(*args, GKerHW=2, device="cpu", **KW, **trio)
    sj, dj = np.asarray(sj), np.asarray(dj)
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6 * np.abs(sj).max())
    hole = np.isnan(dj)
    assert np.array_equal(np.isnan(dt), hole)
    np.testing.assert_allclose(dt[~hole], dj[~hole], rtol=0, atol=1e-8 * 2000.0)


# ---------------------------------------------------------------------------
# the launch plans, transliterated to numpy

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


def _lane_acc(D, q):
    """Accumulator register q (0..3) of every lane from D (..., 16, 8): lane
    (g, t) holds D[g, 2t], D[g, 2t + 1], D[g + 8, 2t], D[g + 8, 2t + 1]."""
    return D[..., _G + 8 * (q >> 1), 2 * _T + (q & 1)]


def k8_launch_emulated(A, B, rho_lo, nrho, wy):
    """csrc/corr_direct.cu (corr_mma, then sum_bands) in numpy, block by
    block and warp by warp, lanes vectorised: the plan of greek._k8_plan,
    the column tiles of each column split, the two staging buffers in turn
    (NaN until staged: a read of a slot that no copy of this tile wrote
    reaches the table), the m-tile's real planes (the padded lanes read
    zeros), each lane's fragment elements (lag j's A row at each B row) and
    accumulators, the skipped lag pairs and n-tiles, the partials (each
    written once), then the partials in order."""
    Fa, N0, N1 = A.shape
    Fb = B.shape[0]
    p = tgreek._k8_plan(Fa, Fb, N0, N1, nrho, wy)
    P, TY, MT = tgreek._K8_P, tgreek._K8_TY, tgreek._K8_MT
    NT, R1, RT, W, CS, nrg, NN = p["NT"], p["R1"], p["RT"], p["W"], p["CS"], p["nrg"], p["NN"]
    tile0 = [tgreek._k8_group_tile(ng, p["ntiles"], p["nng"]) for ng in range(p["nng"] + 1)]
    assert all(0 < b - a <= NT for a, b in zip(tile0, tile0[1:]))
    SA, SB, BW, RA, nA = p["SA"], p["SB"], p["BW"], p["RA"], p["nA"]
    assert SA % 16 == 4 and 2 * wy + 1 == R1 and CS <= p["nchunks"]
    lag = np.arange(P)
    part = np.full((p["nbands"] * CS, Fa, Fb, nrho, R1), np.nan)
    for band, z, bx in itertools.product(range(p["nbands"]), range(CS),
                                         range(p["nmt"] * p["bpb"])):
        mt, blk = divmod(bx, p["bpb"])
        (rg_lo, rg_hi), _, (n_lo, n_hi) = tgreek._k8_block_span(p, blk)
        i_lo, span = rg_lo * P, (rg_hi - rg_lo + 1) * P
        ra = RT + span - 1
        b_lo, nbp = n_lo // R1, n_hi // R1 - n_lo // R1 + 1
        na = min(MT, Fa - mt * MT)
        assert nbp <= p["nbp"] and b_lo + nbp <= Fb and na <= nA and ra <= RA
        xa0, rb0 = band * RT - i_lo - span + 1, rho_lo + band * RT
        units = {u: tgreek._k8_unit(u, nrg) for u in range(blk * W, min(blk * W + W, p["nunits"]))}
        c_lo, c_hi = z * p["nchunks"] // CS, (z + 1) * p["nchunks"] // CS
        bufs = [np.full(p["buf"], np.nan) for _ in range(2)]
        acc = {u: np.zeros((P // 2, NT, 16, 8)) for u in units}
        for ci in range(c_lo, c_hi):
            buf = bufs[(ci - c_lo) & 1]
            y0 = ci * TY
            q, ia, c = np.meshgrid(np.arange(na), np.arange(ra), np.arange(TY), indexing="ij")
            x, y = xa0 + ia, y0 + c
            ok = (x >= 0) & (x < N0) & (y < N1)
            buf[q * SA + ia * TY + c] = np.where(ok, A[mt * MT + q, np.clip(x, 0, N0 - 1),
                                                       np.minimum(y, N1 - 1)], 0.0)
            q, lr, c = np.meshgrid(np.arange(nbp), np.arange(RT), np.arange(BW), indexing="ij")
            buf[nA * SA + q * SB + lr * BW + c] = B[b_lo + q, (rb0 + lr) % N0,
                                                   (y0 - wy + c) % N1]
            As, Bs = buf[:nA * SA], buf[nA * SA:]
            for u in acc:
                rg, ng = units[u]
                base = i_lo + span - P - rg * P
                assert base >= 0 and base + RT + P - 2 < ra
                jv = min(P // 2, (nrho - rg * P + 1) // 2)
                tv = tile0[ng + 1] - tile0[ng]
                n = (tile0[ng] + np.arange(NT)[:, None]) * 8 + _G
                n = np.where((np.arange(NT)[:, None] >= tv) | (n >= NN), n_lo, n)
                boff = (n // R1 - b_lo) * SB + n % R1 + _T                   # (NT, 32)
                on = (np.arange(P // 2) < jv)[:, None] & (np.arange(NT) < tv)[None]
                gv = _G < na
                for yk in range(0, TY, 4):
                    # lag j of B row lr: As row lr + base + P - 1 - j
                    aw = np.where(gv, _G, 0) * SA + (base + P - 1) * TY + yk + _T
                    rows = np.arange(RT)[:, None] - lag[None]                    # (RT, P)
                    a0 = np.where(gv, As[aw + rows[:, 0::2, None] * TY], 0.0)   # (RT, P/2, 32)
                    a1 = np.where(gv, As[aw + rows[:, 1::2, None] * TY], 0.0)
                    bf = Bs[boff + (np.arange(RT) * BW)[:, None, None] + yk]  # (RT, NT, 32)
                    Am, _ = _frags(a0, a1, a0)
                    _, Bm = _frags(bf, bf, bf)
                    D = np.einsum("rjmk,rnkc->jnmc", Am, Bm)
                    acc[u] += np.where(on[:, :, None, None], D, 0.0)
        for u, D in acc.items():
            rg, ng = units[u]
            for jp, nt, qq in itertools.product(range(P // 2), range(NT), range(4)):
                a = mt * MT + _G
                i = rg * P + 2 * jp + (qq >> 1)
                n = (tile0[ng] + nt) * 8 + 2 * _T + (qq & 1)
                w = (a < Fa) & (n < NN)
                if i >= nrho or nt >= tile0[ng + 1] - tile0[ng]:
                    continue
                dst = (band * CS + z, a[w], n[w] // R1, i, n[w] % R1)
                assert np.isnan(part[dst]).all()
                part[dst] = _lane_acc(D[jp, nt], qq)[w]
    assert not np.isnan(part).any()
    out = part[0].copy()
    for b in range(1, len(part)):
        out += part[b]
    return out


@pytest.mark.parametrize("Fa,Fb,N0,N1,wx,wy", [
    (2, 3, 40, 50, 2, 3), (2, 0, 36, 20, 8, 7),   # ragged bands and column tiles; B is A
    (1, 2, 24, 15, 40, 13),                        # 81 lag rows: 14 lag groups
    (6, 0, 40, 44, 4, 4),                          # Comg's shape: half of 9 lag rows (odd)
    (25, 6, 20, 24, 3, 3),                         # Pbs's: 6 planes pad to 8, 175 columns to 176
    (25, 0, 20, 22, 4, 5),                         # v2 Comg's: 25 planes pad to 32 (4 m-tiles)
    (6, 1, 30, 34, 3, 8),                          # Cthe's: one B plane, 17 lags
    (1, 6, 26, 22, 2, 3),                          # one A plane: B is the kernel's plane operand
    (3, 40, 18, 20, 1, 0),                         # one lag a row: 40 B planes in a block
    (2, 170, 12, 20, 1, 0)])                       # 4-warp blocks do not fit: a warp a block
def test_k8_launch_plan_emulated(monkeypatch, Fa, Fb, N0, N1, wx, wy):
    """corr_window_conv's K8 route with the launch emulated: the operand
    swap, Comg's half of the lag rows (rho = 0 among them) and its mirror,
    the padding of planes, lags and lag rows; within 1e-13 of the twin's
    max."""
    rng = np.random.default_rng(Fa * 100 + wx)
    A = torch.as_tensor(rng.normal(size=(Fa, N0, N1)))
    B = A if Fb == 0 else torch.as_tensor(rng.normal(size=(Fb, N0, N1)))
    launches = []

    def launch(X, Y, rho_lo, nrho, w):
        launches.append((X.shape[0], rho_lo, nrho))
        return torch.as_tensor(k8_launch_emulated(X.numpy(), Y.numpy(), rho_lo, nrho, w))

    monkeypatch.setattr(tgreek, "_k8_launch", launch)
    out = tgreek._corr_window_k8(A, B, wx, wy).numpy()
    ref = tgreek.corr_window_conv_plain(A, B, wx, wy).numpy()
    Fy = B.shape[0]
    swap = tgreek._k8_padded(Fy, Fa, 2 * wy + 1) < tgreek._k8_padded(Fa, Fy, 2 * wy + 1)
    assert swap == ((Fa, Fb) in ((2, 3), (25, 6), (1, 6), (1, 2)))   # both roles exercised
    assert launches == [(Fy if swap else Fa,) + ((0, wx + 1) if B is A else (-wx, 2 * wx + 1))]
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-13 * np.abs(ref).max()


def _k9_runs_cover(reach, xw, c0, rt_n):
    """conv_mma's runs of staged rows with one reach mask, as its loop
    forms them: they tile the warp's rows in order, each row's mask is the
    row tiles it reaches, and no run is empty."""
    s, s_end, seen = xw, xw + rt_n * 8 + c0 - 1, []
    while s < s_end:
        mask, nxt = 0, s_end
        for rt in range(rt_n):
            lo, hi = xw + 8 * rt, xw + 8 * rt + c0 + 7
            if lo <= s < hi:
                mask |= 1 << rt
            if s < lo < nxt:
                nxt = lo
            if s < hi < nxt:
                nxt = hi
        assert 0 < mask < 8 and nxt > s
        seen += [mask] * (nxt - s)
        s = nxt
    assert seen == [int(sum(1 << r for r in range(rt_n) if row[r])) for row in reach]


# csrc/conv_direct.cu: row tiles (8 rows) and column tiles (16 columns) of
# a warp, warps of a block along rows and columns
_K9_RT, _K9_CT, _K9_WR, _K9_WC = 3, 2, 2, 2


def _k9_band_width(c0):
    """csrc/conv_direct.cu ``band_width``: c0 + 14 rounded up to 8 mod 16."""
    w = c0 + 14
    return w + (8 - w % 16) % 16


def k9_emulated(planes, taps, wrap, J=None, ST=None, b=None, SSc=None, a00=None, scale=1.0,
                side=63):
    """csrc/conv_direct.cu in numpy, block by block and warp by warp, lanes
    vectorised: the tap chunks of at most side x side (the kernel's kSide),
    each plane's halo tile (NaN until staged: a slot no copy of this plane
    wrote reaches the output), the tap band with the padded tap columns,
    the runs of rows with one reach, each lane's fragment elements and
    accumulators, and the epilogue."""
    F, H, W = planes.shape
    L0, L1 = taps.shape[1:]
    N0, N1 = (H, W) if wrap else (H - L0 + 1, W - L1 + 1)
    RT, CT, WR, WC = _K9_RT, _K9_CT, _K9_WR, _K9_WC
    BR, BC = WR * RT * 8, WC * CT * 16
    w0, w1 = L0 // 2, L1 // 2
    out = np.full((N0, N1), np.nan)
    for x0 in range(0, N0, BR):
        for y0 in range(0, N1, BC):
            acc = np.zeros((WR * WC, RT, CT, 16, 8))  # warp, row tile, column tile, D (y, x)
            for A0 in range(0, L0, side):
                c0 = min(side, L0 - A0)
                th, bw = BR + c0 - 1, _k9_band_width(c0)
                for B0 in range(0, L1, side):
                    c1 = min(side, L1 - B0)
                    tw, kp = BC + c1 - 1, -(-c1 // 4) * 4
                    for f in range(F):
                        tile = np.full(th * tw, np.nan)
                        r, c = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")
                        if wrap:
                            v = planes[f][(x0 + A0 + r - w0) % H, (y0 + B0 + c - w1) % W]
                        else:
                            ok = (x0 + A0 + r < H) & (y0 + B0 + c < W)
                            v = np.where(ok, planes[f][np.minimum(x0 + A0 + r, H - 1),
                                                       np.minimum(y0 + B0 + c, W - 1)], 0.0)
                        tile[r * tw + c] = v
                        k, d = np.arange(kp)[:, None], np.arange(bw)[None] - 7
                        on = (k < c1) & (d >= 0) & (d < c0)
                        band = np.where(on, taps[f][np.clip(L0 - 1 - A0 - d, 0, L0 - 1),
                                                    L1 - 1 - B0 - np.minimum(k, c1 - 1)],
                                        0.0).ravel()
                        k0 = np.arange(0, kp, 4)
                        ko = np.minimum(k0[:, None] + _T, c1 - 1)               # (nk, 32)
                        for wp in range(WR * WC):
                            xw, yw = (wp // WC) * RT * 8, (wp % WC) * CT * 16
                            s = np.arange(xw, xw + RT * 8 + c0 - 1)
                            dd = s[:, None] - xw - 8 * np.arange(RT)              # (ns, RT)
                            reach = (dd >= 0) & (dd <= c0 + 6)
                            _k9_runs_cover(reach, xw, c0, RT)
                            tr = ((yw + _G + 16 * np.arange(CT)[:, None])[None, None]
                                  + ko[None, :, None] + (s * tw)[:, None, None, None])
                            Am, _ = _frags(tile[tr], tile[tr + 8], tile[tr])     # (ns, nk, CT, ...)
                            bi = ((k0[:, None] + _T) * bw + 7 - _G)[None, :, None] \
                                + np.where(reach, dd, 0)[:, None, :, None]      # (ns, nk, RT, 32)
                            _, Bm = _frags(band[bi], band[bi], band[bi])
                            D = np.einsum("sktmq,skrqn->srtmn", Am, Bm)
                            acc[wp] += np.where(reach[:, :, None, None, None], D, 0.0).sum(0)
            for wp in range(WR * WC):
                xw, yw = (wp // WC) * RT * 8, (wp % WC) * CT * 16
                for rt in range(RT):
                    for ct in range(CT):
                        for qq in range(4):
                            x = x0 + xw + rt * 8 + 2 * _T + (qq & 1)
                            y = y0 + yw + ct * 16 + _G + 8 * (qq >> 1)
                            w = (x < N0) & (y < N1)
                            xo, yo = x[w], y[w]
                            model = scale * _lane_acc(acc[wp, rt, ct], qq)[w]
                            if ST is not None:
                                model = model + np.tensordot(b, ST[:, xo, yo], axes=(0, 0))
                            if SSc is not None:
                                model = model + scale * np.tensordot(a00, SSc[:, xo, yo],
                                                                     axes=(0, 0))
                            assert np.isnan(out[xo, yo]).all()
                            out[xo, yo] = model if J is None else J[xo, yo] - model
    assert not np.isnan(out).any()
    return out


def _k9_case(F, N0, N1, L0, L1, wrap, extras):
    """(planes, taps, keyword arguments, the twin's output) of one K9 case."""
    rng = np.random.default_rng(L0)
    taps = rng.normal(size=(F, L0, L1))
    planes = rng.normal(size=(F, N0, N1) if wrap else (F, N0 + L0 - 1, N1 + L1 - 1))
    kw = {}
    if extras:
        kw = dict(J=rng.normal(size=(N0, N1)), ST=rng.normal(size=(2, N0, N1)), b=rng.normal(size=2),
                  SSc=rng.normal(size=(3, N0, N1)), a00=rng.normal(size=3), scale=1.7)
    ref = tfdiff.conv_direct(torch.as_tensor(planes), torch.as_tensor(taps), wrap,
                             **{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                                for k, v in kw.items()}).numpy()
    return planes, taps, kw, ref


@pytest.mark.parametrize("F,N0,N1,L0,L1,wrap,extras", [
    (3, 40, 70, 5, 7, True, True), (1, 35, 20, 3, 9, False, False),
    (2, 33, 65, 17, 11, True, False),
    (6, 52, 40, 5, 5, True, True),      # fdiff's six planes, K 5 padded to 8
    (25, 30, 36, 3, 3, True, True),     # v2's 25 planes, K 3 padded to 4
    (1, 50, 20, 9, 9, False, False)])   # convolve2d's one plane, padded
def test_k9_launch_plan_emulated(F, N0, N1, L0, L1, wrap, extras):
    planes, taps, kw, ref = _k9_case(F, N0, N1, L0, L1, wrap, extras)
    out = k9_emulated(planes, taps, wrap, **kw)
    assert np.abs(out - ref).max() <= 1e-13 * np.abs(ref).max()


@pytest.mark.parametrize("F,N0,N1,L0,L1,wrap,extras,side", [
    (1, 20, 30, 67, 65, False, False, 63),   # the kernel's kSide: 63 + 4 by 63 + 2
    (2, 40, 30, 13, 9, True, True, 5)])      # a lowered side: ragged chunks on both axes
def test_k9_tap_chunks_emulated(F, N0, N1, L0, L1, wrap, extras, side):
    """K9 walks a kernel with a side over 63 in chunks of at most 63 x 63
    taps; within 1e-13 of the twin's max."""
    planes, taps, kw, ref = _k9_case(F, N0, N1, L0, L1, wrap, extras)
    out = k9_emulated(planes, taps, wrap, side=side, **kw)
    assert np.abs(out - ref).max() <= 1e-13 * np.abs(ref).max()


def _nonfinite_case(fill):
    """(image, kernel) for a convolve2d with a non-finite fill: a NaN and
    an inf pixel; for an infinite fill a kernel with a zero tap and one
    negative corner, so that the padding meets every kind of tap (NaN and
    +-inf strips), for a NaN fill a 5 x 3 kernel (the strips two rows
    deep, where an 8-row tile reaches farther)."""
    rng = np.random.default_rng(7)
    img = rng.normal(100.0, 5.0, (61, 70))
    img[30, 33], img[9, 50] = np.nan, np.inf
    if np.isnan(fill):
        return img, rng.uniform(0.1, 1.0, (5, 3))
    ker = rng.uniform(0.1, 1.0, (7, 5))
    ker[3, 0], ker[6, 4] = 0.0, -0.5
    return img, ker


def _same_nonfinite(out, ref):
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(out), test(ref))
    fin = np.isfinite(ref)
    assert fin.any() and np.abs(out[fin] - ref[fin]).max() <= 1e-12 * np.abs(ref[fin]).max()


@pytest.mark.parametrize("fill,nan_treatment", [(np.nan, "fill"), (np.nan, "interpolate"),
                                                (np.inf, "fill"), (-np.inf, "interpolate")])
def test_convolve2d_nonfinite_fill_emulated(monkeypatch, fill, nan_treatment):
    """convolve2d's 'fill' boundary with a NaN or infinite fill, K9's launch
    emulated: K9 takes finite planes only (its band's zeros times a NaN
    reach every row of an 8-row tile), so the padding is zero and the
    fill's terms are added after; NaN and +-inf where sfft_tpu's
    convolve2d has them, the rest within 1e-12 of max."""
    from sfft_tpu.utils import convolve as jconv
    from sfft_tpu_torch.utils import convolve as tconv

    def emulated(planes, taps, wrap=True, **kw):
        assert not kw
        return torch.as_tensor(k9_emulated(planes.numpy(), taps.numpy(), wrap))

    monkeypatch.setattr(tfdiff, "conv_direct", emulated)
    img, ker = _nonfinite_case(fill)
    kw = dict(boundary="fill", fill_value=fill, nan_treatment=nan_treatment)
    ref = jconv.convolve2d(img, ker, use_jax=True, **kw)
    _same_nonfinite(tconv.convolve2d(img, ker, device="cpu", **kw), ref)


def test_gss_conv_nonfinite_pixel_emulated(monkeypatch):
    """A NaN and a +inf pixel in I (mI finite) through GSS with corr / conv
    / lu, K9's launches emulated: K9 spreads a staged non-finite value over
    its 8-row output tile, so fdiff_conv zeroes the planes' non-finite
    values and takes their terms from a second launch on their codes
    (``conv_direct_nonfinite``). The NaN and +-inf pixels of the port's
    difference are sfft_tpu's, the rest within 1e-8 max|J|."""
    from sfft_tpu.core import engine as jengine
    from test_torch_engine import make_bench_pair

    I, J = make_bench_pair(64, seed=5, k=20)
    mI, mJ = I.copy(), J.copy()
    I[20, 31], I[47, 3] = np.nan, np.inf
    jc, tc = _cfgs(N0=64, N1=64, w=2, greek_backend="corr", fdiff_backend="conv")
    launches = []

    def emulated(planes, taps, wrap=True, *extra):
        launches.append(planes.shape[0])
        extra = [v.numpy() if isinstance(v, torch.Tensor) else v for v in extra]
        return torch.as_tensor(k9_emulated(planes.numpy(), taps.numpy(), wrap, *extra))

    monkeypatch.setattr(tfdiff, "conv_direct", emulated)
    st, dt, _ = tengine.GeneralSFFT.GSS(I, J, mI, mJ, tc, device="cpu")
    sj, dj, _ = jengine.GeneralSFFT.GSS(I, J, mI, mJ, jc)
    assert launches == [tc.Fij, tc.Fij]          # the difference and its codes
    sj, dj, dt = np.asarray(sj), np.asarray(dj), dt.numpy()
    np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=1e-6 * np.abs(sj).max())
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(dt), test(dj))
    fin = np.isfinite(dj)
    assert 0 < (~fin).sum() < 200
    assert np.abs(dt[fin] - dj[fin]).max() <= 1e-8 * np.abs(J).max()


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the K8 / K9 kernels)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("Fa,Fb,N,wx,wy", [(3, 2, 200, 1, 2), (6, 6, 257, 16, 16), (5, 1, 130, 22, 22),
                                            (25, 25, 120, 22, 22), (25, 6, 150, 11, 11),
                                            (1, 6, 140, 3, 5)])
def test_k8_matches_twin_on_card(cuda, Fa, Fb, N, wx, wy):
    rng = np.random.default_rng(N)
    A = torch.as_tensor(rng.normal(100, 10, (Fa, N, N + 3)), device=cuda)
    B = A if Fa == Fb else torch.as_tensor(rng.normal(100, 10, (Fb, N, N + 3)), device=cuda)
    before = tgreek._K8.launches
    out = tgreek.corr_window_conv(A, B, wx, wy)
    again = tgreek.corr_window_conv(A, B, wx, wy)
    ref = tgreek.corr_window_conv_plain(A, B, wx, wy)
    torch.cuda.synchronize()
    assert tgreek._K8.launches == before + 2
    assert torch.equal(out, again)
    assert float((out - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("F,N0,N1,L,wrap", [(6, 300, 260, 17, True), (25, 90, 100, 23, True),
                                            (1, 200, 131, 31, False), (1, 150, 170, 129, False),
                                            (2, 120, 90, 71, True), (25, 97, 131, 23, False),
                                            (5, 49, 65, 3, True)])
def test_k9_matches_twin_on_card(cuda, F, N0, N1, L, wrap):
    rng = np.random.default_rng(L)
    t = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    H, W = (N0, N1) if wrap else (N0 + L - 1, N1 + L - 1)
    planes, taps = t(rng.normal(100, 10, (F, H, W))), t(rng.normal(0, 0.1, (F, L, L)))
    kw = dict(J=t(rng.normal(1000, 30, (N0, N1))), ST=t(rng.normal(size=(6, N0, N1))),
              b=t(rng.normal(size=6)), SSc=t(rng.normal(size=(3, N0, N1))),
              a00=t(rng.normal(size=3)), scale=1.3) if wrap else {}
    before = tfdiff.conv_direct.launches
    out = tfdiff.conv_direct(planes, taps, wrap, **kw)
    again = tfdiff.conv_direct(planes, taps, wrap, **kw)
    ref = tfdiff.conv_direct_plain(planes, taps, wrap, **kw)
    torch.cuda.synchronize()
    assert tfdiff.conv_direct.launches == before + 2
    assert torch.equal(out, again)
    assert float((out - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("Fa,Fb,N,wx,wy", [(6, 6, 257, 16, 16), (25, 6, 150, 11, 11)])
def test_k8_corr_direct_pairs_on_card(cuda, Fa, Fb, N, wx, wy):
    """``corr_direct`` (a pair list; the table in one launch, the listed
    pairs taken from it) against its twin."""
    rng = np.random.default_rng(N + 1)
    A = torch.as_tensor(rng.normal(100, 10, (Fa, N, N + 3)), device=cuda)
    B = torch.as_tensor(rng.normal(100, 10, (Fb, N, N + 3)), device=cuda)
    ia, ib = rng.integers(0, Fa, 9), rng.integers(0, Fb, 9)
    before = tgreek._K8.launches
    out = tgreek.corr_direct(A, B, ia, ib, wx, wy)
    ref = tgreek.corr_direct_plain(A, B, ia, ib, wx, wy)
    torch.cuda.synchronize()
    assert tgreek._K8.launches == before + 1
    assert out.shape == ref.shape == (9, 2 * wx + 1, 2 * wy + 1)
    assert float((out - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("fill,nan_treatment", [(np.nan, "fill"), (np.nan, "interpolate"),
                                                (np.inf, "fill")])
def test_convolve2d_nonfinite_fill_on_card(cuda, fill, nan_treatment):
    """convolve2d with a NaN or infinite fill on the card against sfft_tpu's
    numpy loop (``use_jax=False``, held bit for bit to sfft_tpu's in
    tests/test_torch_utils.py)."""
    from sfft_tpu_torch.utils import convolve as tconv

    img, ker = _nonfinite_case(fill)
    kw = dict(boundary="fill", fill_value=fill, nan_treatment=nan_treatment)
    out = tconv.convolve2d(torch.as_tensor(img, device=cuda), ker, **kw).cpu().numpy()
    _same_nonfinite(out, tconv.convolve2d(img, ker, use_jax=False, **kw))
