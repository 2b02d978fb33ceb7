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
  csrc/corr_direct.cu and csrc/conv_direct.cu, every shared-memory slot
  written before it is read) against the twins, within 1e-13 of max.
- ``gpu``: the kernels against their twins on the card (skipped here).
"""

import dataclasses
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

_K8_ROWS, _K8_CHUNKS, _THREADS = 32, 6, 256


def _wrap(v, n):
    return np.mod(v, n)


def k8_emulated(A, B, ia, ib, wx, wy):
    """csrc/corr_direct.cu, block by block (threads vectorised): the A
    and wrapped B tiles, each thread's lag strip over its rows, the row
    groups' fixed-order sum, the partials (NaN until written: each is
    written once), then the sum over the bands."""
    N0, N1 = A.shape[1:]
    R0, R1 = 2 * wx + 1, 2 * wy + 1
    S, nstrips, R0c = tgreek._k8_plan(R0, R1)
    K = min(_THREADS // (R0c * nstrips), _K8_ROWS)
    TY = S * _K8_CHUNKS
    BW, BH = TY + nstrips * S, _K8_ROWS + R0c - 1
    nb = -(-N0 // _K8_ROWS)
    part = np.full((nb, len(ia), R0, R1), np.nan)
    for band in range(nb):
        x0 = band * _K8_ROWS
        for p in range(len(ia)):
            for z in range(-(-R0 // R0c)):
                rho0 = z * R0c
                nr = min(R0c, R0 - rho0)
                NI = nr * nstrips
                items = np.arange(NI * K)
                item, sub = items % NI, items // NI
                ri, e0 = item // nstrips, (item % nstrips) * S
                acc = np.zeros((NI * K, S))
                for y0 in range(0, N1, TY):
                    xs, ys = x0 + np.arange(_K8_ROWS)[:, None], y0 + np.arange(TY)[None]
                    As = np.where((xs < N0) & (ys < N1),
                                  A[ia[p]][np.minimum(xs, N0 - 1), np.minimum(ys, N1 - 1)], 0.0)
                    Bs = B[ib[p]][_wrap(x0 - wx + rho0 + np.arange(BH), N0)[:, None],
                                  _wrap(y0 - wy + np.arange(BW), N1)[None]]
                    js = np.arange(S)[:, None] + np.arange(S)[None]   # j + s
                    for xr in range(_K8_ROWS):
                        on = (xr - sub) % K == 0
                        rows = (xr + ri[on])[:, None, None]
                        for c in range(_K8_CHUNKS):
                            y = c * S
                            win = Bs[rows, y + e0[on][:, None, None] + js[None]]   # (n, j, s)
                            acc[on] += np.einsum("j,njs->ns", As[xr, y:y + S], win)
                red = acc.reshape(K, NI, S)
                tot = red[0].copy()
                for k in range(1, K):
                    tot += red[k]
                for it in range(NI):
                    for s in range(S):
                        if e0[it] + s < R1:
                            part[band, p, rho0 + ri[it], e0[it] + s] = tot[it, s]
    assert not np.isnan(part).any()
    out = part[0].copy()
    for b in range(1, nb):
        out += part[b]
    return out


def k9_emulated(planes, taps, wrap, J=None, ST=None, b=None, SSc=None, a00=None, scale=1.0,
                side=63):
    """csrc/conv_direct.cu, tile by tile (threads vectorised): the flipped
    taps in chunks of at most side x side (the kernel's kSide), each chunk's
    halo tile, and the mod-8 register window."""
    F, H, W = planes.shape
    L0, L1 = taps.shape[1:]
    N0, N1 = (H, W) if wrap else (H - L0 + 1, W - L1 + 1)
    rows, cols, px = 32, 64, 8
    out = np.full((N0, N1), np.nan)
    j, grp = np.arange(256) % cols, np.arange(256) // cols
    for x0 in range(0, N0, rows):
        for y0 in range(0, N1, cols):
            acc = np.zeros((256, px))
            for f in range(F):
                kf = taps[f][::-1, ::-1]
                for A0 in range(0, L0, side):
                    c0 = min(side, L0 - A0)
                    for B0 in range(0, L1, side):
                        c1 = min(side, L1 - B0)
                        r = np.arange(rows + c0 - 1)[:, None]
                        c = np.arange(cols + c1 - 1)[None]
                        if wrap:
                            tile = planes[f][_wrap(x0 - L0 // 2 + A0 + r, H),
                                             _wrap(y0 - L1 // 2 + B0 + c, W)]
                        else:
                            ok = (x0 + A0 + r < H) & (y0 + B0 + c < W)
                            tile = np.where(ok, planes[f][np.minimum(x0 + A0 + r, H - 1),
                                                          np.minimum(y0 + B0 + c, W - 1)], 0.0)
                        kc = kf[A0:A0 + c0, B0:B0 + c1]
                        for bb in range(c1):
                            win = [None] * px
                            for q in range(px - 1):
                                win[q] = tile[grp * px + q, j + bb]
                            for a0 in range(0, c0, px):
                                for u in range(px):
                                    a = a0 + u
                                    if a < c0:
                                        win[(u + px - 1) % px] = tile[grp * px + a + px - 1, j + bb]
                                        for p in range(px):
                                            acc[:, p] += kc[a, bb] * win[(u + p) % px]
            for p in range(px):
                x, y = x0 + grp * px + p, y0 + j
                on = (x < N0) & (y < N1)
                xo, yo = x[on], y[on]
                model = scale * acc[on, p]
                if ST is not None:
                    model = model + np.tensordot(b, ST[:, xo, yo], axes=(0, 0))
                if SSc is not None:
                    model = model + scale * np.tensordot(a00, SSc[:, xo, yo], axes=(0, 0))
                out[xo, yo] = model if J is None else J[xo, yo] - model
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("Fa,N0,N1,wx,wy,sym", [(2, 40, 50, 2, 3, False), (2, 36, 20, 8, 7, True),
                                                (1, 24, 15, 40, 13, False)])
def test_k8_launch_plan_emulated(Fa, N0, N1, wx, wy, sym):
    """Ragged bands and column tiles, the symmetric pair list, and lag rows
    split over the grid's z (81 rows: R0c = 64)."""
    rng = np.random.default_rng(wx)
    A = rng.normal(size=(Fa, N0, N1))
    B = A if sym else rng.normal(size=(Fa + 1, N0, N1))
    ia, ib = (np.triu_indices(Fa) if sym else
              [x.ravel() for x in np.meshgrid(np.arange(Fa), np.arange(Fa + 1), indexing="ij")])
    ref = tgreek.corr_direct(torch.as_tensor(A), torch.as_tensor(B), ia, ib, wx, wy).numpy()
    out = k8_emulated(A, B, ia, ib, wx, wy)
    assert np.abs(out - ref).max() <= 1e-13 * np.abs(ref).max()


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


@pytest.mark.parametrize("F,N0,N1,L0,L1,wrap,extras", [(3, 40, 70, 5, 7, True, True),
                                                        (1, 35, 20, 3, 9, False, False),
                                                        (2, 33, 65, 17, 11, True, False)])
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


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the K8 / K9 kernels)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("Fa,Fb,N,wx,wy", [(3, 2, 200, 1, 2), (6, 6, 257, 16, 16), (5, 1, 130, 22, 22)])
def test_k8_matches_twin_on_card(cuda, Fa, Fb, N, wx, wy):
    rng = np.random.default_rng(N)
    A = torch.as_tensor(rng.normal(100, 10, (Fa, N, N + 3)), device=cuda)
    B = A if Fa == Fb else torch.as_tensor(rng.normal(100, 10, (Fb, N, N + 3)), device=cuda)
    before = tgreek.corr_direct.launches
    out = tgreek.corr_window_conv(A, B, wx, wy)
    again = tgreek.corr_window_conv(A, B, wx, wy)
    ref = tgreek.corr_window_conv_plain(A, B, wx, wy)
    torch.cuda.synchronize()
    assert tgreek.corr_direct.launches == before + 2
    assert torch.equal(out, again)
    assert float((out - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("F,N0,N1,L,wrap", [(6, 300, 260, 17, True), (25, 90, 100, 23, True),
                                            (1, 200, 131, 31, False), (1, 150, 170, 129, False),
                                            (2, 120, 90, 71, True)])
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
