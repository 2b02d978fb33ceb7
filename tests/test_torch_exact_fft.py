"""The sliced exact engine (sfft_tpu_torch/core/exact_fft.py) and the K4
slicer (core/slicing.py) against sfft_tpu.core.exact_fft.

Inputs are made from seeds with numpy and fed to both packages. sfft_tpu
runs jitted on the CPU, where its Pallas slicer is off, so its XLA chain is
the reference. The slicer must match it bit for bit (slices and scales);
transforms and windows agree to 1e-13 of their maximum (the contract grade
of tests/test_exact_fft.py). The reference is imported inside the tests, so
the `gpu` cases, which hold the CUDA kernel to its twin on the card, also
run where jax is absent (``pytest --noconftest -m gpu``).
"""

import numpy as np
import pytest
import torch

from sfft_tpu_torch.core import exact_fft as tef
from sfft_tpu_torch.core import peel as tpeel
from sfft_tpu_torch.core import slicing as tsl
from sfft_tpu_torch.core.statics import Static

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)

SLICE_SHAPES = [(64, 384), (3, 40, 256), (130, 120)]


def _jef():
    import sfft_tpu  # noqa: F401  (x64)
    from sfft_tpu.core import exact_fft

    return exact_fft


def _pair_parts(v):
    hi = v.astype(np.float32)
    return hi, (v - hi.astype(np.float64)).astype(np.float32)


def _wide_range(seed, shape):
    """Values over ~14 decades (the inputs of tests/test_exact_fft.py's
    slicer test)."""
    rng = np.random.default_rng(seed)
    return rng.normal(0, 7.3, shape) * np.exp(rng.normal(0, 4, shape))


def _tp(p):
    return tef.CPair(*(None if v is None else torch.as_tensor(np.asarray(v)) for v in p))


def _c128(p):
    return tef.pair_to_c128(p).numpy()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SLICE_SHAPES)
@pytest.mark.parametrize("rowwise", [True, False])
def test_slice_pair_real_bit_identical_to_reference(shape, rowwise):
    import jax
    import jax.numpy as jnp

    jef = _jef()
    hi, lo = _pair_parts(_wide_range(1, shape))
    for nsl in (8, 9):
        sl_j, s_j = jax.jit(lambda h, l: jef._slice_pair_real(h, l, nsl, rowwise))(
            jnp.asarray(hi), jnp.asarray(lo))
        before = tsl.slice_pair.launches
        sl_t, s_t = tef._slice_pair_real(torch.as_tensor(hi), torch.as_tensor(lo), nsl, rowwise)
        assert tsl.slice_pair.launches == before      # the CPU twin launches nothing
        assert sl_t.dtype == torch.int8 and sl_t.shape == (nsl,) + shape
        np.testing.assert_array_equal(sl_t.numpy(), np.asarray(sl_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        # the representation invariant: the slices carry hi + lo
        w = 2.0 ** (-tef.NB * (np.arange(nsl) + 1.0))
        val = np.tensordot(w, sl_t.numpy().astype(np.float64), axes=1) * s_t.numpy()
        ref = hi.astype(np.float64) + lo
        # truncation below the last slice plus the rounding of the lo injection
        assert np.all(np.abs(val - ref) <= 2.0 ** -48 * s_t.numpy())


def test_pow2ceil_matches_reference():
    import jax.numpy as jnp

    jef = _jef()
    m = np.array([0.0, 1e-35, 1e-30, 0.3, 1.0, 1.5, 2.0, 3.99, 4096.0, 7e12, 3e37],
                 np.float32)
    out = tef._pow2ceil_scalar(torch.as_tensor(m)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jef._pow2ceil_scalar(jnp.asarray(m))))
    big = m >= 1e-30
    assert np.all(out[big] > m[big]) and np.all(out[big] <= 2 * m[big])
    assert np.all(np.log2(out) == np.round(np.log2(out)))


def test_two_sum_two_prod_exact():
    rng = np.random.default_rng(2)
    a = torch.as_tensor((rng.normal(size=20000) * 3.5e7).astype(np.float32))
    b = torch.as_tensor((rng.normal(size=20000) * 3.5e7).astype(np.float32))
    x, y = a * b, -(b * (a + 2.0))
    s, e = tef._two_sum(x, y)
    np.testing.assert_array_equal(s.double().numpy() + e.double().numpy(),
                                  x.double().numpy() + y.double().numpy())
    p, pe = tef._two_prod(a, b)
    np.testing.assert_array_equal(p.double().numpy() + pe.double().numpy(),
                                  a.double().numpy() * b.double().numpy())


def test_slice_static_matches_reference():
    jef = _jef()
    M = np.exp(2j * np.pi * np.outer(np.arange(40), np.arange(24)) / 40)
    for part in (M.real, M.imag * 1e-3):
        sl_t, s_t = tef._slice_static(part, 8)
        sl_j, s_j = jef._slice_static(part, 8)
        np.testing.assert_array_equal(sl_t, sl_j)
        assert s_t == s_j


@pytest.mark.parametrize("N", [64, 80, 97, 63])
def test_exact_dft_axis_matches_reference(N):
    import jax
    import jax.numpy as jnp

    jef = _jef()
    rng = np.random.default_rng(N)
    x = 2000.0 * (1 + np.linspace(0, 1, N)) + rng.normal(0, 1, (3, N))
    ref_j = np.asarray(jef.pair_to_c128(jax.jit(
        lambda v: jef.exact_dft_axis(jef.pair_from_f64(v), N))(jnp.asarray(x))))
    out = _c128(tef.exact_dft_axis(tef.pair_from_f64(torch.as_tensor(x)), N))
    assert np.abs(out - ref_j).max() <= 1e-13 * np.abs(ref_j).max()
    ref = np.fft.fft(x, axis=-1)
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 1e-13
    # the half-output and inverse variants agree with numpy too
    half = _c128(tef.exact_dft_axis(tef.pair_from_f64(torch.as_tensor(x)), N, half_out=True))
    assert np.linalg.norm(half - ref[:, : N // 2 + 1]) / np.linalg.norm(ref) < 1e-13
    inv = _c128(tef.exact_dft_axis(tef.pair_from_f64(torch.as_tensor(x)), N, inverse=True))
    refi = np.fft.ifft(x, axis=-1) * N
    assert np.linalg.norm(inv - refi) / np.linalg.norm(refi) < 1e-13


@pytest.mark.parametrize("N", [64, 100, 10])
def test_exact_idft_halfin_real_matches_reference(N):
    import jax
    import jax.numpy as jnp

    jef = _jef()
    rng = np.random.default_rng(N + 1)
    Nh = N // 2 + 1
    x = 2000.0 * (1 + np.linspace(0, 1, N)) + rng.normal(0, 1, (3, N))
    x *= np.exp(rng.normal(0, 2, x.shape))
    fold = np.full(Nh, 2.0)
    fold[0] = fold[-1] = 1.0
    Zf = np.fft.rfft(x, axis=-1) * fold
    parts = (*_pair_parts(Zf.real), *_pair_parts(Zf.imag))
    yj = jax.jit(lambda a, b, c, d: jef.exact_idft_halfin_real(jef.CPair(a, b, c, d), N))(
        *map(jnp.asarray, parts))
    ref_j = np.asarray(yj.rh, np.float64) + np.asarray(yj.rl)
    yt = tef.exact_idft_halfin_real(_tp(parts), N)
    out = yt.rh.double().numpy() + yt.rl.numpy()
    assert np.abs(out - ref_j).max() <= 1e-13 * np.abs(ref_j).max()
    assert np.abs(out / N - x).max() / np.abs(x).max() < 1e-13


def _spectra(N0, N1, seed):
    """Half spectra of a bright smooth background with stars (the content of
    tests/test_exact_fft.py's smoothy_stack), as pair parts."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid((np.arange(N1) + 1.0) / N1, (np.arange(N0) + 1.0) / N0)
    I = 2000.0 * (1 + 0.5 * xx + 0.3 * yy * yy)
    for _ in range(8):
        x0, y0 = rng.uniform(0.1, 0.9, 2)
        I += rng.uniform(1e4, 1e5) * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * 0.03 ** 2))
    I += rng.normal(0, 1.0, I.shape)
    stack = np.stack([I, I * xx * yy, I * xx ** 2])
    S = np.fft.rfft2(stack)
    return stack, S, (*_pair_parts(S.real), *_pair_parts(S.imag))


@pytest.mark.parametrize("mode", ["symmetric", "pairs"])
def test_exact_corr_window_matches_reference(mode):
    import jax
    import jax.numpy as jnp

    jef = _jef()
    N0, N1, w = 40, 36, 3
    stack, S, parts = _spectra(N0, N1, 3)
    kw = (dict(symmetric=True) if mode == "symmetric"
          else dict(pairs=(np.array([0, 1, 2, 2]), np.array([1, 1, 0, 2])), chunk=3))
    ref_j = np.asarray(jax.jit(lambda a, b, c, d: jef.exact_corr_window(
        jef.CPair(a, b, c, d), jef.CPair(a, b, c, d), N0, N1, 2 * w, w, **kw))(
        *map(jnp.asarray, parts)))
    sp = _tp(parts)
    out = tef.exact_corr_window(sp, sp, N0, N1, 2 * w, w, **kw).numpy()
    assert out.shape == ref_j.shape and out.dtype == np.float64
    assert np.abs(out - ref_j).max() <= 1e-13 * np.abs(ref_j).max()
    # against the plain f64 correlation of the planes
    lag0, lag1 = np.arange(-2 * w, 2 * w + 1), np.arange(-w, w + 1)
    full = np.fft.fft2(stack)
    want = []
    for a, b in ([(a, b) for a in range(3) for b in range(3)] if mode == "symmetric"
                 else zip(*kw["pairs"])):
        cc = np.real(np.fft.ifft2(full[a] * np.conj(full[b])))
        want.append(cc[np.ix_((-lag0) % N0, (-lag1) % N1)])
    want = np.stack(want).reshape(out.shape)
    assert np.abs(out - want).max() <= 1e-12 * np.abs(want).max()


def test_exact_sep_weighted_spectra_matches_reference():
    import jax
    import jax.numpy as jnp

    jef = _jef()
    N0, N1 = 40, 36
    rng = np.random.default_rng(4)
    base = rng.normal(0, 30.0, (N0, N1))
    head = rng.normal(0, 50.0, (N0, N1))
    c0 = (np.arange(N0) + 1.0) / N0
    c1 = (np.arange(N1) + 1.0) / N1
    exps = [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (2, 0)]
    U = np.stack([c0 ** i for i, _ in exps])
    V = np.stack([c1 ** j for _, j in exps])

    def jfn(b, h):
        return jef.exact_sep_weighted_spectra([jef.pair_from_f64(h)], jef.pair_from_f64(b),
                                              U, V)

    ref_j = np.asarray(jef.pair_to_c128(jax.jit(jfn)(jnp.asarray(base), jnp.asarray(head))))
    Us = Static(tpeel.coord_powers_of, (N0, tuple(i for i, _ in exps)))
    Vs = Static(tpeel.coord_powers_of, (N1, tuple(j for _, j in exps)))
    np.testing.assert_array_equal(Us.host(), U)
    np.testing.assert_array_equal(Vs.host(), V)
    out = _c128(tef.exact_sep_weighted_spectra(
        [tef.pair_from_f64(torch.as_tensor(head))], tef.pair_from_f64(torch.as_tensor(base)),
        Us, Vs))
    assert out.shape == (1 + len(exps), N0, N1 // 2 + 1)
    assert np.abs(out - ref_j).max() <= 1e-13 * np.abs(ref_j).max()
    want = np.fft.rfft2(np.concatenate([head[None], base[None] * U[:, :, None] * V[:, None, :]]))
    assert np.abs(out - want).max() <= 1e-13 * np.abs(want).max()
    # sfft_tpu would drop the imaginary parts of complex inputs silently
    cpx = tef.CPair(*(torch.zeros(N0, N1) for _ in range(4)))
    with pytest.raises(ValueError, match="real"):
        tef.exact_sep_weighted_spectra([cpx], tef.pair_from_f64(torch.as_tensor(base)),
                                       Us, Vs)


def test_static_tables_built_once_per_device():
    cpu = torch.device("cpu")
    DS = Static(tef._dft_stage_mat, (4096, False, "DS"))       # (64, 64)
    a = tef._static_slices_for(Static(np.real, (DS,)), 8, cpu)
    b = tef._static_slices_for(Static(np.real, (Static(tef._dft_stage_mat,
                                                       (4096, False, "DS")),)), 8, cpu)
    assert a is b
    assert a.slT.shape == (8, 64, 64) and a.slT.dtype == torch.int8
    # an all-zero table (the imaginary part of a real one) has no slices
    assert tef._static_slices_for(Static(np.imag, (Static(np.real, (DS,)),)), 8, cpu) is None
    E1 = Static(np.real, (Static(tef._corr_emat, (4096, 4096, 16, 16, True, "E1")),))
    st = tef._static_slices_for(E1, 7, cpu)
    # big tables are sliced from their f32 pair (the data slicer); columns
    # padded to 64, the contraction axis to a multiple of 8
    assert st.slT.shape == (7, 64, 2056) and isinstance(st.scale, torch.Tensor)
    assert int(st.slT[:, 33:].abs().sum()) == 0 and int(st.slT[..., 2049:].abs().sum()) == 0
    # the plain twin's slices are a table of their own, with the same bits
    stp = tef._static_slices_for(E1, 7, cpu, plain=True)
    assert stp is not st and torch.equal(stp.slT, st.slT)
    assert tef._split_on(E1, cpu)[0] is tef._split_on(E1, cpu)[0]


@pytest.mark.parametrize("m,k,n", [(5, 13, 7), (40, 64, 128), (17, 2056, 896)])
def test_int_mm_exact_with_padding(m, k, n):
    rng = np.random.default_rng(m)
    A = rng.integers(-64, 65, (m, k)).astype(np.int8)
    B = rng.integers(-64, 65, (n, k)).astype(np.int8)
    kp = k + (-k) % 8
    At = tef._padk(torch.as_tensor(A), kp)
    Bt = tef._padk(torch.as_tensor(B), kp)
    out = tef._int_mm(At, Bt)
    assert out.dtype == torch.int32 and out.shape == (m, n)
    np.testing.assert_array_equal(out.numpy(), A.astype(np.int64) @ B.T.astype(np.int64))


def test_slice_pair_refusals():
    hi = torch.ones((4, 8))
    s = torch.ones(())
    with pytest.raises(TypeError):
        tsl.slice_pair(hi.double(), hi.double(), s.double(), 8)
    with pytest.raises(ValueError):
        tsl.slice_pair(hi, hi[:, :4], s, 8)                    # shapes differ
    with pytest.raises(ValueError):
        tsl.slice_pair(hi, hi, torch.ones((4,)), 8)            # scale neither () nor (4, 1)
    with pytest.raises(ValueError):
        tsl.slice_pair(hi.T, hi.T, s, 8)                       # non-contiguous
    with pytest.raises(ValueError):
        tsl.slice_pair(hi, hi, s, 17)                          # nsl out of range
    assert tsl.INJECT == 4 and tsl.NB == 6


GPU_CASES = [((64, 384), True), ((3, 40, 256), False), ((130, 120), True),
             ((7, 33), True), ((1001,), False), ((4096, 2049), True), ((4096, 2049), False)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,rowwise", GPU_CASES)
def test_slice_pair_kernel_bit_identical_to_twin_on_gpu(cuda, shape, rowwise):
    hi, lo = _pair_parts(_wide_range(5, shape))
    h = torch.as_tensor(hi, device=cuda)
    l = torch.as_tensor(lo, device=cuda)
    for nsl in (7, 8, 9):
        before = tsl.slice_pair.launches
        sl, s = tef._slice_pair_real(h, l, nsl, rowwise)
        torch.cuda.synchronize()
        assert tsl.slice_pair.launches == before + 1
        ref, s_ref = tef._slice_pair_real(h, l, nsl, rowwise, plain=True)
        assert torch.equal(sl, ref) and torch.equal(s, s_ref)
    # a view that starts off the 16-byte boundary takes the scalar path
    sl, s = tef._slice_pair_real(h.reshape(-1)[1:], l.reshape(-1)[1:], 8, rowwise)
    ref, _ = tef._slice_pair_real(h.reshape(-1)[1:], l.reshape(-1)[1:], 8, rowwise, plain=True)
    assert torch.equal(sl, ref)


@pytest.mark.gpu
def test_contract_path_on_gpu_matches_cpu(cuda):
    """The contract step on the card (K3 and K4 launched) against the same
    step on the CPU twins, on tests/test_pexact.py's kind of pair."""
    import sfft_tpu_torch
    from sfft_tpu_torch.core import engine, moments

    rng = np.random.default_rng(42)
    yy, xx = np.meshgrid(np.arange(64), np.arange(80))
    I = 100.0 + 0.3 * xx + 0.5 * yy + 0.002 * xx * yy
    for _ in range(25):
        x0, y0 = rng.uniform(3, 77), rng.uniform(3, 61)
        I = I + rng.uniform(50, 400) * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2)
                                              / (2 * rng.uniform(0.8, 1.8) ** 2))
    J = I * 1.1 + 4.0 + rng.normal(0, 1.0, I.shape)
    I = I + rng.normal(0, 0.7, I.shape)
    cfg = sfft_tpu_torch.make_config(80, 64, 3, greek_backend="pexact",
                                     fdiff_backend="pexact", solver="transformed")
    s_cpu, d_cpu, _ = engine.GeneralSFFT.GSS(I, J, I, J, cfg, device="cpu")
    k3, k4 = moments.moments.launches, tsl.slice_pair.launches
    s_gpu, d_gpu, _ = engine.GeneralSFFT.GSS(I, J, I, J, cfg, device=cuda)
    torch.cuda.synchronize()
    assert moments.moments.launches > k3 and tsl.slice_pair.launches > k4
    assert float((s_gpu.cpu() - s_cpu).abs().max()) <= 1e-6 * float(s_cpu.abs().max())
    assert float((d_gpu.cpu() - d_cpu).abs().max()) <= 1e-8 * np.abs(J).max()
