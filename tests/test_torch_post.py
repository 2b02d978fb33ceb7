"""Post-processing of sfft_tpu_torch (post/fftkits.py, post/decorrelation.py,
post/grid_convolve.py) against sfft_tpu's, on the cases of tests/test_post.py.

Both packages get the same seeded numpy inputs; the port runs with
device="cpu" (torch f64, pocketfft), the reference on numpy / XLA:CPU in
f64. Bound: 1e-10 of the reference's maximum (both are f64 FFT or direct
sums of the same terms in another order).
"""

import numpy as np
import pytest
import torch

import sfft_tpu  # noqa: F401  (x64)
from sfft_tpu.post import decorrelation as jdec
from sfft_tpu.post import fftkits as jfk
from sfft_tpu.post import grid_convolve as jgc

import sfft_tpu_torch
from sfft_tpu_torch.post import decorrelation as tdec
from sfft_tpu_torch.post import fftkits as tfk
from sfft_tpu_torch.post import grid_convolve as tgc

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)
CPU = "cpu"


def close(got, ref, tol=1e-10):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def test_csz_and_its_inverse_match_reference():
    k = np.random.default_rng(0).normal(size=(5, 7))
    kimg = tfk.kernel_csz(torch.as_tensor(k), 32, 32)
    close(kimg, jfk.kernel_csz(k, 32, 32))
    close(tfk.kernel_csz(torch.as_tensor(k), 32, 30, normalize=True),
          jfk.kernel_csz(k, 32, 30, normalize=True))
    k2, lost = tfk.kernel_csz_inv(kimg, 5, 7)
    k2j, lostj = jfk.kernel_csz_inv(jfk.kernel_csz(k, 32, 32), 5, 7)
    close(k2, k2j)
    assert abs(float(lost) - float(lostj)) < 1e-12
    assert float(kimg[0, 0]) == k[2, 3]


@pytest.mark.parametrize("normalize", [False, True])
def test_fft_convolve_matches_reference(normalize):
    rng = np.random.default_rng(1)
    img = rng.normal(10, 2, (40, 36))
    img[3, 4] = np.nan
    k = rng.normal(size=(5, 5)) + 0.5
    got = tfk.fft_convolve(img, k, nan_fill_value=0.0, normalize_kernel=normalize, device=CPU)
    close(got, jfk.fft_convolve(img, k, nan_fill_value=0.0, normalize_kernel=normalize))


@pytest.mark.parametrize("use_fft", [False, True])
def test_grid_convolve_uniform_matches_reference(use_fft):
    rng = np.random.default_rng(3)
    img = rng.normal(5, 1, (64, 60))
    img[10, 11] = np.inf
    TiHW = 7
    AllocatedL, XY = tgc.make_tile_grid(*img.shape, TiHW)
    jl, jxy = jgc.make_tile_grid(*img.shape, TiHW)
    assert np.array_equal(AllocatedL, jl) and np.array_equal(XY, jxy)
    kers = rng.normal(0.2, 0.05, (AllocatedL.max() + 1, 5, 5)) + 0.5
    got = tgc.grid_convolve_uniform(img, kers, TiHW, use_fft=use_fft, device=CPU)
    close(got, jgc.grid_convolve_uniform(img, kers, TiHW, use_fft=use_fft))


def test_grid_convolve_labels_and_facade_match_reference():
    rng = np.random.default_rng(9)
    img = rng.normal(5, 1, (64, 60))
    TiHW = 7
    AllocatedL, _ = tgc.make_tile_grid(64, 60, TiHW)
    kers = rng.normal(0.2, 0.05, (AllocatedL.max() + 1, 5, 5)) + 0.5
    close(tgc.grid_convolve_labels(img, AllocatedL, kers, device=CPU),
          jgc.grid_convolve_labels(img, AllocatedL, kers))
    for tihw in (TiHW, None):
        got = tgc.BSplineGridConvolve(img, AllocatedL, kers, device=CPU).GSVC(TiHW=tihw)
        assert isinstance(got, np.ndarray)
        close(got, jgc.BSplineGridConvolve(img, AllocatedL, kers).GSVC(TiHW=tihw))


def _kernels():
    rng = np.random.default_rng(4)
    mk = np.zeros((5, 5))
    mk[2, 2] = 0.8
    mk[1, 2] = mk[3, 2] = 0.1
    psf = np.exp(-((np.arange(9) - 4.0)[:, None] ** 2 + (np.arange(9) - 4.0)[None] ** 2) / 4.0)
    return mk, psf / psf.sum(), np.abs(rng.normal(0.1, 0.02, (7, 7)))


@pytest.mark.parametrize("clip", [None, 1e5, 1.5])
def test_decorrelation_kernels_match_reference(clip):
    mk, psf, fin = _kernels()
    kw = dict(MK_JLst=[psf], SkySig_JLst=[1.3], MK_ILst=[mk], SkySig_ILst=[0.7],
              MK_Fin=fin, VERBOSE_LEVEL=0)
    got = tdec.decorrelation_kernel(**kw, DENO_CLIP_RATIO=clip, device=CPU)
    close(got, jdec.decorrelation_kernel(**kw, DENO_CLIP_RATIO=clip))
    if clip is None:
        close(tdec.DeCorrelationCalculator.DCC(**kw, device=CPU),
              jdec.DeCorrelationCalculator.DCC(**kw))
    else:
        close(tdec.BSplineDeCorrelation.BDC(**kw, DENO_CLIP_RATIO=clip, device=CPU),
              jdec.BSplineDeCorrelation.BDC(**kw, DENO_CLIP_RATIO=clip))
    # image-stacking mode
    st = dict(MK_JLst=[psf, mk], SkySig_JLst=[1.0, 2.0], VERBOSE_LEVEL=0)
    close(tdec.decorrelation_kernel(**st, device=CPU), jdec.decorrelation_kernel(**st))


def test_bdc_clipping_saves_a_spectral_zero():
    """An exact spectral zero: unclipped DCC is non-finite in both packages,
    BDC's clipping keeps it finite and equal to the reference's."""
    mk = np.zeros((5, 5))
    mk[2, 2] = mk[2, 3] = 0.5
    kw = dict(MK_JLst=[mk], SkySig_JLst=[1.0], MK_ILst=[mk], SkySig_ILst=[1.0], MK_Fin=None,
              VERBOSE_LEVEL=0)
    assert not np.isfinite(tdec.DeCorrelationCalculator.DCC(**kw, device=CPU)).all()
    got = tdec.BSplineDeCorrelation.BDC(**kw, DENO_CLIP_RATIO=100.0, device=CPU)
    assert np.isfinite(got).all()
    close(got, jdec.BSplineDeCorrelation.BDC(**kw, DENO_CLIP_RATIO=100.0))
    with pytest.raises(ValueError):
        tdec.decorrelation_kernel([mk], [1.0], device=CPU)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("clip", [None, 10.0])
def test_decorrelation_transfer_matches_reference(real, clip):
    mk, psf, fin = _kernels()
    args = (32, 30, [psf], [1.3], [mk], [0.7])
    kw = dict(MATCH_KERNEL=fin, REAL_OUTPUT=real, REAL_OUTPUT_SIZE=(9, 11) if real else None,
              NORMALIZE_OUTPUT=True, DENO_CLIP_RATIO=clip, VERBOSE_LEVEL=0)
    got = tdec.decorrelation_transfer(*args, **kw, device=CPU)
    close(got, jdec.decorrelation_transfer(*args, **kw))


def test_post_exports():
    assert sfft_tpu_torch.BSplineDeCorrelation is tdec.BSplineDeCorrelation
    assert sfft_tpu_torch.DeCorrelationCalculator is tdec.DeCorrelationCalculator
    assert sfft_tpu_torch.BSplineGridConvolve is tgc.BSplineGridConvolve
