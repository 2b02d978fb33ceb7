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
    for backend in ("fft32", "corr"):
        with pytest.raises(NotImplementedError):
            tgreek.greek_tables(SI, SI[:3], SI[0], 1, 1, backend=backend)
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
