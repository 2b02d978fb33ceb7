"""The automatic packets of sfft_tpu_torch (EasySparsePacket.ESP,
EasyCrowdedPacket.ECP) against sfft_tpu's on the CPU, from the committed
golden FITS pairs (tests/data/golden_*.fits, tools/make_golden_fixtures.py).

One more pair is derived from them here: the crowded pair with its
SATURATE key lowered to 5000, so that stars saturate and MaskSatContam has
a contamination mask to propagate, and a NaN patch in the science image
(the NaN union is patched from the masked images and masked again in the
difference; both packets share that code).

- Preprocessing: AutoSparsePrep.HoughAutoMask / AutoCrowdedPrep.AutoMask
  give bit-identical prep dictionaries in both packages (every array,
  every catalog column, the FWHMs).
- Packets under the default trio (fft / fft / lu) on the CPU: solution
  within 1e-6 of max|solution| and difference within 1e-8 max|J| (the
  bounds of tests/test_engine.py:56-58), the same discrete decisions
  (ConvdSide, KerHW, sub-sources, active pixels, Post-Anomaly count) and
  the same NaN and contamination masks.
- The port meets tests/data/golden_auto_expected.json at
  tests/test_golden_sparse.py's and test_golden_crowded.py's tolerances.
"""

import json
import os

import numpy as np
import pytest
import torch

import sfft_tpu  # noqa: F401  (x64)
from sfft_tpu.api.easy_crowded import EasyCrowdedPacket as JECP
from sfft_tpu.api.easy_sparse import EasySparsePacket as JESP

from sfft_tpu_torch import EasyCrowdedPacket, EasySparsePacket
from sfft_tpu_torch.io import fits

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")

# case -> (flavor, pair, packet keywords)
CASES = {
    "sparse": ("sparse", "golden", dict(PostAnomalyCheck=True, KerHWLimit=(2, 6))),
    "crowded": ("crowded", "golden", dict(ForceConv="REF", GKerHW=3)),
    "crowded_contam": ("crowded", "saturated", dict(ForceConv="REF", GKerHW=3,
                                                     MaskSatContam=True)),
}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """FITS paths (ref, sci) of each pair, and "tmp": a directory."""
    d = tmp_path_factory.mktemp("easy")
    out = {(f, "golden"): tuple(os.path.join(DATA, f"golden_{f}_{s}.fits")
                                for s in ("ref", "sci"))
           for f in ("sparse", "crowded")}
    paths = []
    for s in ("ref", "sci"):
        data, hdr = fits.read(out[("crowded", "golden")][s == "sci"])
        hdr.set("SATURATE", 5000.0)
        if s == "sci":
            data = data.copy()
            data[100:109, 200:214] = np.nan  # (y, x): rows are FITS y
        paths.append(str(d / f"crowded_sat_{s}.fits"))
        fits.write(paths[-1], data, hdr)
    out[("crowded", "saturated")] = tuple(paths)
    out["tmp"] = str(d)
    return out


_RUNS = {}


def _snapshot(prepdict):
    """The prep dictionary as *_Prep returned it (the subtraction adds the
    Post-Anomaly columns to its catalog)."""
    return {k: v.copy() if hasattr(v, "colnames") else v for k, v in prepdict.items()}


def run_packets(case, pairs):
    """(sfft_tpu's result, the port's result, their difference FITS paths,
    their prep dictionaries as *_Prep returned them) of the case's packet
    on the CPU, computed once per module."""
    if case not in _RUNS:
        flavor, pair, kw = CASES[case]
        paths = pairs[(flavor, pair)]
        out = [os.path.join(pairs["tmp"], f"{case}_{who}_diff.fits") for who in ("j", "t")]
        packets = (JESP, EasySparsePacket) if flavor == "sparse" else (JECP, EasyCrowdedPacket)
        results, dicts = [], []
        for packet, fits_diff, dev in zip(packets, out, ({}, {"device": "cpu"})):
            prep_fn, sub = ((packet.ESP_Prep, packet.ESP_Subtract) if flavor == "sparse"
                            else (packet.ECP_Prep, packet.ECP_Subtract))
            prep = prep_fn(*paths, VERBOSE_LEVEL=0, **kw)
            dicts.append(_snapshot(prep["SFFTPrepDict"]))
            results.append(sub(prep, *paths, FITS_DIFF=fits_diff, VERBOSE_LEVEL=0, **dev, **kw))
        _RUNS[case] = (results[0], results[1], out, dicts)
    return _RUNS[case]


def assert_prep_dicts_equal(jd, td):
    assert sorted(jd) == sorted(td)
    for key in jd:
        a, b = jd[key], td[key]
        if a is None or b is None:
            assert a is None and b is None, key
        elif hasattr(a, "colnames"):
            assert a.colnames == b.colnames, key
            for col in a.colnames:
                ca, cb = np.asarray(a[col]), np.asarray(b[col])
                assert ca.dtype == cb.dtype and ca.shape == cb.shape, (key, col)
                assert np.array_equal(ca, cb, equal_nan=ca.dtype.kind == "f"), (key, col)
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), key
        else:
            assert type(a) is type(b) and (a == b or (a != a and b != b)), key


@pytest.mark.parametrize("case", list(CASES))
def test_prep_dicts_bit_identical(case, pairs):
    """*_Prep's AutoSparsePrep.HoughAutoMask / AutoCrowdedPrep.AutoMask
    dictionaries, bit for bit."""
    flavor, pair, kw = CASES[case]
    jd, td = run_packets(case, pairs)[3]
    assert_prep_dicts_equal(jd, td)
    if pair == "saturated":
        assert td["Union-NaN-Mask"].sum() == 9 * 14
        assert td["REF-SAT-Mask"].sum() > 0 and td["SCI-SAT-Mask"].sum() > 0


@pytest.mark.parametrize("case", list(CASES))
def test_packet_matches_reference(case, pairs):
    flavor, pair, kw = CASES[case]
    (jdiff, jprep, jsol, jfs, *_), (tdiff, tprep, tsol, tfs, *_), out, _ = \
        run_packets(case, pairs)
    # the decisions in the difference's header (ConvdSide, KerHW), and the
    # difference as written
    (jfd, jhdr), (tfd, thdr) = fits.read(out[0]), fits.read(out[1])
    assert (thdr["CONVD"], thdr["KERHW"]) == (jhdr["CONVD"], jhdr["KERHW"])
    assert thdr["CONVD"] == kw.get("ForceConv", "REF")
    np.testing.assert_array_equal(tfd.T, tdiff)
    jsol = np.asarray(jsol)
    assert isinstance(tsol, np.ndarray) and isinstance(tdiff, np.ndarray)
    assert tsol.shape == jsol.shape and tdiff.shape == jdiff.shape
    np.testing.assert_allclose(tsol, jsol, rtol=0, atol=1e-6 * np.abs(jsol).max())
    # the NaN union and the contamination mask: the same pixels
    np.testing.assert_array_equal(np.isnan(tdiff), np.isnan(jdiff))
    J = np.nan_to_num(fits.getdata(pairs[(flavor, pair)][1]).T)
    ok = ~np.isnan(jdiff)
    np.testing.assert_allclose(tdiff[ok], jdiff[ok], rtol=0, atol=1e-8 * np.abs(J).max())
    assert abs(tfs - jfs) <= 1e-6 * abs(jfs)
    assert int(np.sum(tprep["Active-Mask"])) == int(np.sum(jprep["Active-Mask"]))
    if flavor == "sparse":
        ts, js = tprep["SExCatalog-SubSource"], jprep["SExCatalog-SubSource"]
        assert len(ts) == len(js)
        np.testing.assert_array_equal(ts["MASK_PostAnomaly"], js["MASK_PostAnomaly"])
    n_nan = int(np.isnan(tdiff).sum())
    if pair == "saturated":
        # the NaN patch, and the saturated cores grown by the kernel
        sat = tprep["REF-SAT-Mask"] | tprep["SCI-SAT-Mask"]
        assert np.isnan(tdiff[tprep["Union-NaN-Mask"]]).all()
        assert n_nan > int(sat.sum()) + 9 * 14 > 9 * 14
    else:
        assert n_nan == 0


@pytest.mark.parametrize("case", ["sparse", "crowded"])
def test_port_meets_golden_expected(case, pairs):
    """tests/test_golden_sparse.py's and test_golden_crowded.py's checks and
    tolerances, on the port."""
    with open(os.path.join(DATA, "golden_auto_expected.json")) as f:
        exp = json.load(f)[case]
    result = run_packets(case, pairs)[1]
    diff, prepdict, sol, fscal = result[:4]
    act = prepdict["Active-Mask"]
    assert int(np.sum(act)) == exp["n_active_pix"]
    np.testing.assert_allclose(
        float(np.sqrt(np.nanmean(diff[act] ** 2))), exp["diff_rms_active"], rtol=1e-4)
    np.testing.assert_allclose(float(np.sum(np.abs(sol))), exp["sol_l1"], rtol=1e-5)
    if case == "crowded":
        np.testing.assert_allclose(fscal, exp["flux_scal"], rtol=1e-4)
        return
    ss = prepdict["SExCatalog-SubSource"]
    assert len(ss) == exp["n_subsource"]
    assert int(np.sum(np.asarray(ss["MASK_PostAnomaly"]))) == exp["n_post_anomaly"]
    np.testing.assert_allclose(prepdict["FWHM_REF"], exp["fwhm_ref"], rtol=1e-3)
    np.testing.assert_allclose(prepdict["FWHM_SCI"], exp["fwhm_sci"], rtol=1e-3)
    np.testing.assert_allclose(fscal, exp["flux_scal_mean"], rtol=1e-4)
    np.testing.assert_allclose(result[4], exp["flux_scal_sig"], atol=1e-6)
    np.testing.assert_allclose(float(np.sqrt(np.nanmean(diff ** 2))), exp["diff_rms_all"],
                               rtol=1e-4)
    # the planted transient at (251, 77) survives subtraction at high S/N
    assert np.nanmax(np.abs(diff[246:256, 72:82])) > 20 * exp["diff_rms_active"]
