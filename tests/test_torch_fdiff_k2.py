"""K2 (the fused model spectrum of the Fourier-space difference) and its plain
twin.

On the CPU, sfft_tpu_torch's 'fft' and 'fft32' differences run the twin
``fdiff_model_plain`` between the forward and the inverse rfft2; they are
held to sfft_tpu's ``fdiff`` on the same seeded planes and solution: c128
within 1e-12 of max|difference|, fft32 within 1e-5 (f32 rounding of a
difference that cancels two planes of ~2e3). Cases: odd N1, SEPARATE-VARYING
scaling (the port hands the difference its active scaling planes only, the
padded ones being zeros) and Fpq = 1. The CUDA kernel is held to the twin on
the card by the `gpu`-marked cases (and by chip_smoke.py): c64 within 1e-5
of max|twin|, c128 within 1e-12, ragged shapes (rows off the 32- and
64-row tiles, odd N1h, both row counts per thread, shared tiles past 48 KB),
two launches bit-equal.
The reference is imported inside the CPU tests, so the `gpu` cases also run
where jax is absent (``pytest --noconftest -m gpu``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from sfft_tpu_torch.core import engine as tengine
from sfft_tpu_torch.core import fdiff as tfdiff

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)

# (v2 case, N1): odd N1, SEPARATE-VARYING with Fpq = 1, ENTANGLED
CASES = {"odd_n1_entangled": ("bspline_entangled", 35),
         "separate_varying_fpq1": ("bspline_tikhonov", 36),
         "separate_varying_bspline": ("bspline_separate_varying", 35)}
BACKENDS = {"fft": 1e-12, "fft32": 1e-5}


@pytest.fixture(scope="module")
def refs():
    """sfft_tpu's difference per (case, backend), with its inputs (jitted:
    its eager op-by-op run compiles every operation anew)."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import v2_cases
    from sfft_tpu.core import engine as jengine

    out = {}
    for name, (case, n1) in CASES.items():
        jc, tc = v2_cases.configs(case)
        jc = dataclasses.replace(jc, N1=n1)
        tc = dataclasses.replace(tc, N1=n1)
        I, J = v2_cases.make_pair(7)
        I, J = I[:, :n1], J[:, :n1]
        sol = np.random.default_rng(11).normal(0, 0.05, tc.NEQ)
        for be in BACKENDS:
            jb = dataclasses.replace(jc, fdiff_backend=be)
            ref = np.asarray(jax.jit(partial(jengine._subtract_impl, jb))(
                jnp.asarray(I), jnp.asarray(J), jnp.asarray(sol)))
            out[name, be] = (dataclasses.replace(tc, fdiff_backend=be), I, J, sol, ref)
    return out


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_fdiff_with_plain_model_matches_reference(refs, case, backend):
    cfg, I, J, sol, ref = refs[case, backend]
    tfdiff.fdiff_model.launches = 0
    got = tengine._subtract_impl(cfg, torch.as_tensor(I), torch.as_tensor(J),
                                 torch.as_tensor(sol)).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=BACKENDS[backend] * np.abs(ref).max())
    assert tfdiff.fdiff_model.launches == 0     # CPU tensors take the twin


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_twin_takes_all_or_active_scaling_planes(refs, case):
    """The twin with the padded scaling stack equals the twin with its active
    planes (the padding is zeros), and the wrapper on CPU tensors is the
    twin."""
    cfg, I, J, sol, _ = refs[case, "fft"]
    SI, ST, SSc = tengine._plane_stacks(cfg, torch.as_tensor(I))
    specs = torch.fft.rfft2(torch.cat([torch.as_tensor(J)[None], SI, ST], dim=0))
    W0 = torch.as_tensor(tfdiff.phase_matrix(cfg, True, 0))
    W1 = torch.as_tensor(tfdiff.phase_matrix(cfg, True, 1))
    s = torch.as_tensor(sol)
    args = (s, W0, W1, cfg.Fij, cfg.w0, cfg.w1, cfg.SCALE)
    if SSc is None:
        full = tfdiff.fdiff_model_plain(specs, None, *args)
        act = tfdiff.fdiff_model(specs, None, *args)
    else:
        full = tfdiff.fdiff_model_plain(specs, torch.fft.rfft2(SSc), *args)
        act = tfdiff.fdiff_model(specs, torch.fft.rfft2(
            SSc[: cfg.scaling_basis.num_funcs()].contiguous()), *args)
    assert float((full - act).abs().max()) <= 1e-12 * float(full.abs().max())


def test_model_refusals():
    z = torch.zeros((3, 8, 5), dtype=torch.complex128)
    W0 = torch.zeros((8, 3), dtype=torch.complex128)
    W1 = torch.zeros((3, 5), dtype=torch.complex128)
    sol = torch.zeros(1 * 9 + 1, dtype=torch.float64)
    tfdiff.fdiff_model(z, None, sol, W0, W1, 1, 1, 1, 1.0)
    with pytest.raises(TypeError):
        tfdiff.fdiff_model(z, None, sol.float(), W0, W1, 1, 1, 1, 1.0)
    with pytest.raises(ValueError):
        tfdiff.fdiff_model(z, None, sol[:-1], W0, W1, 1, 1, 1, 1.0)
    with pytest.raises(ValueError):
        tfdiff.fdiff_model(z.transpose(1, 2), None, sol, W0, W1, 1, 1, 1, 1.0)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _model_inputs(Fij, Fpq, nS, N0, N1, w0, w1, cdt, dev, seed=3):
    rng = np.random.default_rng(seed)
    N1h = N1 // 2 + 1
    rdt = torch.float32 if cdt == torch.complex64 else torch.float64
    planes = rng.normal(1000.0, 30.0, (1 + Fij + Fpq, N0, N1))
    specs = torch.fft.rfft2(torch.as_tensor(planes, dtype=rdt, device=dev))
    FS = None
    if nS:
        FS = torch.fft.rfft2(torch.as_tensor(rng.normal(0, 30.0, (nS, N0, N1)), dtype=rdt,
                                             device=dev))
    L0, L1 = 2 * w0 + 1, 2 * w1 + 1
    sol = torch.as_tensor(rng.normal(0, 0.05, Fij * L0 * L1 + Fpq), dtype=rdt, device=dev)
    a = np.arange(-w0, w0 + 1)
    b = np.arange(-w1, w1 + 1)
    W0 = np.exp((-2j * np.pi / N0) * np.outer(np.arange(N0), a))
    W1 = np.exp((-2j * np.pi / N1) * np.outer(b, np.arange(N1h)))
    return (specs, FS, sol, torch.as_tensor(W0, dtype=cdt, device=dev),
            torch.as_tensor(W1, dtype=cdt, device=dev), Fij, w0, w1, 0.8125)


@pytest.mark.gpu
@pytest.mark.parametrize("cdt,tol", [(torch.complex64, 1e-5), (torch.complex128, 1e-12)])
@pytest.mark.parametrize("Fij,Fpq,nS,N0,N1,w0,w1", [
    (6, 6, 0, 256, 256, 8, 8),        # the fast slice's counts
    (25, 1, 6, 130, 121, 11, 11),     # the v2 counts; odd N1, N0 off the row tile
    (4, 0, 4, 37, 20, 2, 3),          # no background, ragged rows
    (6, 6, 0, 33, 63, 8, 8),          # 4 rows a thread: N0 one past a tile, N1h 32
    (13, 2, 3, 71, 65, 10, 9),        # 8 rows a thread (Fij L0 >= 256): odd N1h 33
    (10, 1, 2, 50, 47, 13, 13),       # 8 rows: c128's shared tiles past 48 KB
])
def test_fdiff_model_kernel_matches_twin_on_gpu(cuda, cdt, tol, Fij, Fpq, nS, N0, N1, w0, w1):
    args = _model_inputs(Fij, Fpq, nS, N0, N1, w0, w1, cdt, cuda)
    ref = tfdiff.fdiff_model_plain(*args)
    tfdiff.fdiff_model.launches = 0
    out = tfdiff.fdiff_model(*args)
    again = tfdiff.fdiff_model(*args)
    torch.cuda.synchronize()
    assert tfdiff.fdiff_model.launches == 4
    assert out.dtype == cdt and out.shape == ref.shape
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    assert torch.equal(out, again)


@pytest.mark.gpu
def test_fdiff_model_refusals_on_gpu(cuda):
    args = list(_model_inputs(2, 1, 0, 16, 16, 1, 1, torch.complex64, cuda))
    args[0] = args[0].cpu()
    with pytest.raises(ValueError):
        tfdiff.fdiff_model(*args)
