"""The host utilities of sfft_tpu_torch (utils/convolve.py on K9,
post/grid_convolve.py's label route, utils/sky.py, utils/wcs.py,
utils/stamp.py, prep/resample.py, utils/profiling.py) against sfft_tpu's on
the same seeded inputs, on the CPU.

convolve2d runs K9's twin here and is held to sfft_tpu's lax.conv route
within 1e-12 of the output's max (f64 sums in another order); its numpy
route and the host copies (sky, WCS, stamps, resampling) are the same
numpy code as sfft_tpu's and are held bit for bit.
"""

import os
import stat
import sys

import numpy as np
import pytest
import torch

import sfft_tpu  # noqa: F401  (x64)
from sfft_tpu.io import fits as jfits
from sfft_tpu.post import grid_convolve as jgrid
from sfft_tpu.prep import resample as jres
from sfft_tpu.utils import convolve as jconv
from sfft_tpu.utils import sky as jsky
from sfft_tpu.utils import stamp as jstamp
from sfft_tpu.utils import wcs as jwcs

from sfft_tpu_torch.io import fits as tfits
from sfft_tpu_torch.post import grid_convolve as tgrid
from sfft_tpu_torch.prep import resample as tres
from sfft_tpu_torch.utils import convolve as tconv
from sfft_tpu_torch.utils import profiling as tprof
from sfft_tpu_torch.utils import sky as tsky
from sfft_tpu_torch.utils import stamp as tstamp
from sfft_tpu_torch.utils import wcs as twcs

from test_wcs_utils import tan_header

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)


def _image(seed, shape=(40, 36), nan=True):
    rng = np.random.default_rng(seed)
    img = rng.normal(100.0, 5.0, shape)
    if nan:
        img[5, 7] = img[20:23, 30] = np.nan
        img[0, 0] = np.inf
    return img


def _same(a, b):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.nan_to_num(a), np.nan_to_num(b))


@pytest.mark.parametrize("boundary", ["extend", "fill", "wrap"])
@pytest.mark.parametrize("nan_treatment", ["interpolate", "fill"])
@pytest.mark.parametrize("normalize", [False, True])
def test_convolve2d_matches_reference(boundary, nan_treatment, normalize):
    img = _image(1)
    ker = np.random.default_rng(2).uniform(0.0, 1.0, (5, 7))
    kw = dict(boundary=boundary, fill_value=3.0, normalize_kernel=normalize,
              nan_treatment=nan_treatment)
    ref = jconv.convolve2d(img, ker, use_jax=True, **kw)
    out = tconv.convolve2d(img, ker, device="cpu", **kw)
    assert isinstance(out, np.ndarray) and out.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    fin = np.isfinite(ref)
    assert np.abs(out[fin] - ref[fin]).max() <= 1e-12 * np.abs(ref[fin]).max()
    # the numpy route is sfft_tpu's loop, bit for bit
    _same(tconv.convolve2d(img, ker, use_jax=False, **kw),
          jconv.convolve2d(img, ker, use_jax=False, **kw))
    # a tensor in gives a tensor on its device
    t = tconv.convolve2d(torch.as_tensor(img), ker, **kw)
    assert isinstance(t, torch.Tensor) and torch.equal(t.isnan(), torch.as_tensor(np.isnan(out)))


def test_convolve2d_goes_through_k9(monkeypatch):
    from sfft_tpu_torch.core import fdiff

    calls = []
    real = fdiff.conv_direct

    def spy(planes, taps, wrap=True, **kw):
        calls.append((tuple(planes.shape), tuple(taps.shape), wrap))
        return real(planes, taps, wrap, **kw)

    monkeypatch.setattr(fdiff, "conv_direct", spy)
    tconv.convolve2d(_image(3), np.ones((3, 5)), boundary="extend", device="cpu")
    tconv.convolve2d(_image(3, nan=False), np.ones((3, 5)), boundary="wrap", device="cpu")
    assert calls == [((1, 42, 40), (1, 3, 5), False), ((1, 42, 40), (1, 3, 5), False),
                     ((1, 40, 36), (1, 3, 5), True)]


def test_grid_convolve_labels_matches_reference():
    rng = np.random.default_rng(4)
    img = rng.normal(10.0, 2.0, (30, 34))
    img[3, 4] = np.nan
    lab = np.zeros((30, 34), int)
    lab[:, 17:] = 1
    lab[12:20, 5:25] = 2
    kers = rng.uniform(0.0, 1.0, (3, 5, 5))
    for normalize in (True, False):
        ref = jgrid.grid_convolve_labels(img, lab, kers, nan_fill_value=0.5,
                                         normalize_kernel=normalize)
        out = tgrid.grid_convolve_labels(img, lab, kers, nan_fill_value=0.5,
                                         normalize_kernel=normalize, device="cpu")
        assert np.abs(out.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def test_sky_matches_reference():
    rng = np.random.default_rng(5)
    sky = rng.normal(300.0, 12.0, 5000)
    sky[:200] += rng.exponential(400.0, 200)   # stars skew the distribution
    sky[7] = np.nan
    assert tsky.mmm(sky) == jsky.mmm(sky)
    np.testing.assert_array_equal(tsky.mmm(sky[:10]), jsky.mmm(sky[:10]))   # too few
    img = sky[:4900].reshape(70, 70)
    assert tsky.SkyLevelEstimator.SLE(img) == jsky.SkyLevelEstimator.SLE(img)


def test_wcs_matches_reference():
    pix = np.array([[10.0, 20.0], [100.5, 120.5], [199.0, 3.0]])
    tpv = tan_header()
    for k, v in [("CTYPE1", "RA---TPV"), ("CTYPE2", "DEC--TPV"), ("PV1_1", 1.0),
                 ("PV1_4", 0.002), ("PV2_1", 1.0), ("PV2_5", -0.001)]:
        tpv.add(k, v)
    for hdr in (tan_header(rot_deg=23.0), tpv):
        wj, wt = jwcs.WCS(hdr), twcs.WCS(hdr)
        rd = wt.all_pix2world(pix, 1)
        np.testing.assert_array_equal(rd, wj.all_pix2world(pix, 1))
        back = wt.all_world2pix(rd, 1)
        np.testing.assert_array_equal(back, wj.all_world2pix(rd, 1))
        np.testing.assert_allclose(back, pix, atol=1e-6)
    h1, h2 = tan_header(rot_deg=0.0), tan_header(rot_deg=35.0)
    assert twcs.PatternRotationCalculator.PRC(h1, h2) == jwcs.PatternRotationCalculator.PRC(h1, h2)
    base = tan_header(crval=(10.0, 10.0))
    base.add("GAIN", 2.5)
    out = twcs.CombineHeader.CH(base, tan_header(crval=(99.0, -20.0)))
    ref = jwcs.CombineHeader.CH(base, tan_header(crval=(99.0, -20.0)))
    assert dict(out) == dict(ref) and out["CRVAL1"] == 99.0 and out["GAIN"] == 2.5
    field = np.random.default_rng(6).normal(0, 1, (120, 120))
    cov_t, lev_t = twcs.NeighboringPixelCovariance.NPC(field)
    cov_j, lev_j = jwcs.NeighboringPixelCovariance.NPC(field)
    np.testing.assert_array_equal(cov_t, cov_j)
    assert lev_t == lev_j


def test_stamps_match_reference(tmp_path):
    img = _image(7, (50, 44), nan=False)
    path = str(tmp_path / "img.fits")
    tfits.write(path, img.T)
    coord = np.array([[10.3, 12.0], [1.0, 1.0], [49.6, 43.2], [25.0, 60.0]])
    kw = dict(COORD=coord, STAMP_IMGSIZE=(9, 7), VERBOSE_LEVEL=0)
    out = tstamp.StampGenerator.SG(FITS_obj=path, FITS_StpLst=[str(tmp_path / f"s{k}.fits")
                                                              for k in range(4)], **kw)
    ref = jstamp.StampGenerator.SG(PixA_obj=img, **kw)
    assert len(out) == len(ref) == 4
    for a, b in zip(out, ref):
        _same(a, b)
    _same(jfits.getdata(str(tmp_path / "s2.fits")).T, ref[2])


def test_resample_matches_reference(tmp_path):
    yy, xx = np.meshgrid(np.arange(60), np.arange(50), indexing="xy")
    img = 100 + 20 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
    tfits.write(str(tmp_path / "obj.fits"), img, tan_header(rot_deg=3.0, crpix=(26.0, 31.0),
                                                            naxis=(50, 60)))
    tfits.write(str(tmp_path / "ref.fits"), np.zeros_like(img),
                tan_header(crpix=(25.5, 30.5), naxis=(50, 60)))
    args = [str(tmp_path / n) for n in ("obj.fits", "ref.fits")]
    out = tres.PYSWarp.PS(*args, str(tmp_path / "t.fits"), VERBOSE_LEVEL=0, use_binary=False)
    ref = jres.PYSWarp.PS(*args, str(tmp_path / "j.fits"), VERBOSE_LEVEL=0, use_binary=False)
    _same(out, ref)
    _same(tfits.getdata(str(tmp_path / "t.fits")), jfits.getdata(str(tmp_path / "j.fits")))
    psf = np.exp(-((xx[:32, :32] - 15.5) ** 2 + (yy[:32, :32] - 15.5) ** 2) / 18.0)
    for kw in (dict(PATTERN_ROTATE_ANGLE=37.0), dict(ZOOM_SCAL_x=1.3, ZOOM_SCAL_y=0.8)):
        _same(tres.ImageZoomRotate.IZR(psf, VERBOSE_LEVEL=0, **kw),
              jres.ImageZoomRotate.IZR(psf, VERBOSE_LEVEL=0, **kw))


def test_resample_binary_route_with_stub(tmp_path, monkeypatch):
    """The swarp subprocess route against a stub executable that honours
    -dd, the patched config, the .head target grid and the weight map
    (tests/test_wcs_utils.py::test_pyswarp_binary_path_with_stub), in both
    packages."""
    stub = tmp_path / "swarp"
    # the stub loads the port's FITS module alone (no torch: it starts fast)
    stub.write_text(f"""#!{sys.executable}
import importlib.util, sys, os
import numpy as np
spec = importlib.util.spec_from_file_location("fits", {repr(tfits.__file__)})
fits = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fits)
if "-dd" in sys.argv:
    print("IMAGEOUT_NAME coadd.fits")
    print("WEIGHTOUT_NAME coadd.weight.fits")
    print("RESAMPLING_TYPE LANCZOS3")
    print("SUBTRACT_BACK Y")
    raise SystemExit(0)
conf = sys.argv[sys.argv.index("-c") + 1]
kv = dict(line.split()[:2] for line in open(conf) if len(line.split()) >= 2)
assert kv["SUBTRACT_BACK"] == "N"
out_name = kv["IMAGEOUT_NAME"]
assert os.path.exists(out_name[:-5] + ".head"), "missing .head target grid"
src = fits.getdata(sys.argv[1]).astype(np.float64)
wt = np.ones_like(src); wt[:2, :] = 0.0
hdr = fits.Header(); hdr.add("SATURATE", 12345.0)
fits.write(out_name, src + 1.0, hdr)
fits.write(kv["WEIGHTOUT_NAME"], wt)
""")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    img = 50.0 + np.arange(300.0).reshape(15, 20)
    h_obj = tan_header(rot_deg=2.0, crpix=(8.0, 8.0))
    h_obj.add("SATURATE", 60000.0)
    h_obj.add("GAIN", 2.0)
    tfits.write(str(tmp_path / "obj.fits"), img, h_obj)
    tfits.write(str(tmp_path / "ref.fits"), np.zeros_like(img), tan_header(crpix=(7.5, 7.5)))
    outs = {}
    for tag, mod in (("t", tres), ("j", jres)):
        outs[tag] = mod.PYSWarp.PS(str(tmp_path / "obj.fits"), str(tmp_path / "ref.fits"),
                                   str(tmp_path / f"r{tag}.fits"), FILL_VALUE=np.nan,
                                   use_binary=True, VERBOSE_LEVEL=0)
    _same(outs["t"], outs["j"])
    assert np.isnan(outs["t"][:2, :]).all() and np.allclose(outs["t"][2:], img[2:] + 1.0)
    _, hdr = tfits.read(str(tmp_path / "rt.fits"))
    _, hdr_j = jfits.read(str(tmp_path / "rj.fits"))
    assert hdr["SWARP_O"] == hdr_j["SWARP_O"] == "obj.fits"
    assert hdr["SATURATE"] == 12345.0 and hdr["GAIN"] == 2.0 and abs(hdr["CRPIX1"] - 7.5) < 1e-9


def test_phase_timer_and_trace(tmp_path):
    timer = tprof.PhaseTimer(verbose_level=0)
    with timer.phase("solve") as box:
        box["result"] = (torch.ones(3), {"x": torch.zeros(2)})
    with timer.phase("solve", sync_result=[1, torch.ones(1)]):
        pass
    with timer.phase("subtract"):
        pass
    rep = timer.report()
    assert list(rep) == ["solve", "subtract"] and all(v >= 0 for v in rep.values())
    assert tprof.sync(None) == 0.0 and tprof.sync([]) == 0.0
    with tprof.torch_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64) @ torch.ones(64)
    assert len(prof.key_averages()) > 0
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
