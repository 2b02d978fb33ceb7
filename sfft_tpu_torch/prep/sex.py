"""PY_SEx-compatible source-extraction front end.

Reference: sfft/utils/pyAstroMatic/PYSEx.py — a SExtractor subprocess wrapper.
Here PYSEx.PS keeps the same calling contract and return shape
(AstSEx, PixA_CheckLst, FITS_SExCat, FITS_SExCheckLst). When a SExtractor
binary (`sex` / `sextractor` / `source-extractor`) exists it is used for
bit-exact catalogs (config generated by dumping tool defaults and patching
keys, as AMConfig_Maker does); otherwise the built-in extractor
(prep/extract.py) provides the same columns. A copy of sfft_tpu/prep/sex.py.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sfft_tpu_torch.io import fits
from sfft_tpu_torch.prep.extract import extract_sources
from sfft_tpu_torch.utils.table import Table


def parse_ldac_catalog(catf: str, ONLY_FLAGS=None, XBoundary: float = 0,
                       YBoundary: float = 0, N0: int = 0, N1: int = 0,
                       VERBOSE_LEVEL: int = 0) -> Table:
    """Parse a SExtractor FITS_LDAC catalog file and apply the reference
    PYSEx post-filters (sfft/utils/pyAstroMatic/PYSEx.py:644-700):
    negative-flux MAG_AUTO correction to the 99.0 sentinel, FLAGS
    whitelisting, and image-boundary rejection. Split out of the subprocess
    path so the binary-catalog byte format is testable without a `sex`
    binary (tests/test_ldac_fixture.py)."""
    cols, _imhdr = fits.read_ldac(catf)
    cat = Table({k: np.asarray(v) for k, v in cols.items()})
    # negative-flux MAG correction (reference PYSEx: recompute rather than
    # keep SExtractor's 99.0 sentinel)
    if "MAG_AUTO" in cat.colnames and "FLUX_AUTO" in cat.colnames:
        bad = np.asarray(cat["FLUX_AUTO"]) <= 0
        if bad.any():
            mag = np.asarray(cat["MAG_AUTO"], np.float64).copy()
            mag[bad] = 99.0
            cat["MAG_AUTO"] = mag
    if ONLY_FLAGS is not None and len(cat) and "FLAGS" in cat.colnames:
        cat = cat[np.isin(cat["FLAGS"], ONLY_FLAGS)]
    if (XBoundary > 0 or YBoundary > 0) and len(cat):
        if N0 <= 0 or N1 <= 0:
            # with default N0=N1=0 the filter below degenerates to
            # x < 1 - XBoundary and would silently reject EVERY source
            raise ValueError(
                "parse_ldac_catalog: XBoundary/YBoundary > 0 requires the "
                "image dimensions N0/N1 (got N0=%r, N1=%r)" % (N0, N1))
        x, y = np.asarray(cat["X_IMAGE"]), np.asarray(cat["Y_IMAGE"])
        cat = cat[(x > XBoundary) & (x < N0 - XBoundary + 1)
                  & (y > YBoundary) & (y < N1 - YBoundary + 1)]
    if VERBOSE_LEVEL in (1, 2):
        print(f"MeLOn CheckPoint: FITS_LDAC catalog contains "
              f"[{len(cat)}] sources after filtering!")
    return cat


def _find_sex_binary() -> Optional[str]:
    for name in ("sex", "sextractor", "source-extractor"):
        path = shutil.which(name)
        if path:
            return path
    return None


class PYSEx:
    @staticmethod
    def PS(
        FITS_obj: str = None,
        PixA_obj: Optional[np.ndarray] = None,
        SExParam: Sequence[str] = (),
        GAIN_KEY: str = "GAIN",
        SATUR_KEY: str = "SATURATE",
        BACK_TYPE: str = "AUTO",
        BACK_VALUE: float = 0.0,
        BACK_SIZE: int = 64,
        BACK_FILTERSIZE: int = 3,
        DETECT_THRESH: float = 1.5,
        ANALYSIS_THRESH: float = 1.5,
        DETECT_MINAREA: int = 5,
        DETECT_MAXAREA: int = 0,
        DEBLEND_MINCONT: float = 0.005,
        BACKPHOTO_TYPE: str = "LOCAL",
        CHECKIMAGE_TYPE: str = "NONE",
        AddRD: bool = False,
        ONLY_FLAGS: Optional[List[int]] = None,
        XBoundary: float = 0.0,
        YBoundary: float = 0.0,
        MDIR: Optional[str] = None,
        VERBOSE_LEVEL: int = 1,
        use_binary: Optional[bool] = None,
    ):
        """Returns (AstSEx, PixA_SExCheckLst, FITS_SExCat, FITS_SExCheckLst)."""
        if PixA_obj is None:
            data, hdr = fits.read(FITS_obj)
            PixA_obj = data.T.astype(np.float64)
        else:
            hdr = fits.Header()

        gain = float(hdr.get(GAIN_KEY, 1.0) or 1.0)
        satur = float(hdr.get(SATUR_KEY, 5.0e4) or 5.0e4)

        binary = _find_sex_binary() if use_binary in (None, True) else None
        if binary is not None and FITS_obj is not None:
            try:
                return _run_binary(
                    binary, FITS_obj, SExParam, gain, satur, BACK_TYPE,
                    BACK_VALUE, BACK_SIZE, BACK_FILTERSIZE, DETECT_THRESH,
                    ANALYSIS_THRESH, DETECT_MINAREA, DETECT_MAXAREA,
                    DEBLEND_MINCONT, BACKPHOTO_TYPE, CHECKIMAGE_TYPE,
                    ONLY_FLAGS, XBoundary, YBoundary, VERBOSE_LEVEL,
                )
            except Exception as exc:  # pragma: no cover
                if VERBOSE_LEVEL >= 1:
                    print(f"MeLOn WARNING: SExtractor binary failed ({exc}); "
                          "falling back to internal extractor")

        cat, seg = extract_sources(
            PixA_obj, gain=gain, satur_level=satur, back_type=BACK_TYPE,
            back_value=BACK_VALUE, back_size=BACK_SIZE,
            back_filtersize=BACK_FILTERSIZE, detect_thresh=DETECT_THRESH,
            detect_minarea=DETECT_MINAREA, detect_maxarea=DETECT_MAXAREA,
        )

        # FLAGS filter
        if ONLY_FLAGS is not None and len(cat):
            keep = np.isin(cat["FLAGS"], ONLY_FLAGS)
            cat = cat[keep]
        # boundary filter (reference: drop sources within the boundary margin)
        if (XBoundary > 0 or YBoundary > 0) and len(cat):
            N0, N1 = PixA_obj.shape
            x, y = cat["X_IMAGE"], cat["Y_IMAGE"]
            inb = ((x > XBoundary) & (x < N0 - XBoundary + 1)
                   & (y > YBoundary) & (y < N1 - YBoundary + 1))
            cat = cat[inb]

        checks = []
        ctypes = [c.strip() for c in CHECKIMAGE_TYPE.split(",") if c.strip()]
        from sfft_tpu_torch.prep.background import Background

        for ct in ctypes:
            if ct == "NONE":
                continue
            if ct == "SEGMENTATION":
                # re-number segmentation to match the filtered catalog rows
                if len(cat) and "SEGLABEL" in cat.colnames:
                    keepmap = np.zeros(int(seg.max()) + 1, dtype=np.int32)
                    for newidx, slab in enumerate(
                        np.asarray(cat["SEGLABEL"], int), start=1
                    ):
                        keepmap[slab] = newidx
                    checks.append(keepmap[seg])
                else:
                    checks.append(seg)
            elif ct == "OBJECTS":
                bkg = Background(PixA_obj, bw=BACK_SIZE, bh=BACK_SIZE,
                                 fw=BACK_FILTERSIZE, fh=BACK_FILTERSIZE)
                sub = PixA_obj - bkg.back()
                checks.append(np.where(seg > 0, sub, 0.0))
            elif ct == "BACKGROUND":
                bkg = Background(PixA_obj, bw=BACK_SIZE, bh=BACK_SIZE,
                                 fw=BACK_FILTERSIZE, fh=BACK_FILTERSIZE)
                checks.append(bkg.back())
            elif ct == "-BACKGROUND":
                bkg = Background(PixA_obj, bw=BACK_SIZE, bh=BACK_SIZE,
                                 fw=BACK_FILTERSIZE, fh=BACK_FILTERSIZE)
                checks.append(PixA_obj - bkg.back())
            else:
                raise ValueError(f"unsupported CHECKIMAGE_TYPE {ct!r}")

        if VERBOSE_LEVEL in (1, 2):
            print(f"MeLOn CheckPoint: PYSEx output catalog contains "
                  f"[{len(cat)}] sources!")
        return cat, checks, None, None


def _run_binary(binary, FITS_obj, SExParam, gain, satur, BACK_TYPE, BACK_VALUE,
                BACK_SIZE, BACK_FILTERSIZE, DETECT_THRESH, ANALYSIS_THRESH,
                DETECT_MINAREA, DETECT_MAXAREA, DEBLEND_MINCONT,
                BACKPHOTO_TYPE, CHECKIMAGE_TYPE, ONLY_FLAGS, XBoundary,
                YBoundary, VERBOSE_LEVEL):  # pragma: no cover - needs binary
    """SExtractor subprocess path (reference PYSEx.PS + AMConfig_Maker)."""
    import tempfile

    tdir = tempfile.mkdtemp(prefix="pysex_")
    conf = os.path.join(tdir, "sex.config")
    parf = os.path.join(tdir, "sex.param")
    catf = os.path.join(tdir, "cat.fits")
    ctypes = [c.strip() for c in CHECKIMAGE_TYPE.split(",")
              if c.strip() and c.strip() != "NONE"]
    checkfs = [os.path.join(tdir, f"check_{i}.fits") for i in range(len(ctypes))]
    with open(parf, "w") as f:
        f.write("\n".join(SExParam) + "\n")
    dump = subprocess.run([binary, "-dd"], capture_output=True, text=True).stdout
    patches = {
        "CATALOG_NAME": catf, "CATALOG_TYPE": "FITS_LDAC",
        "PARAMETERS_NAME": parf, "DETECT_THRESH": str(DETECT_THRESH),
        "ANALYSIS_THRESH": str(ANALYSIS_THRESH),
        "DETECT_MINAREA": str(DETECT_MINAREA),
        "DEBLEND_MINCONT": str(DEBLEND_MINCONT),
        "BACK_TYPE": BACK_TYPE, "BACK_VALUE": str(BACK_VALUE),
        "BACK_SIZE": str(BACK_SIZE), "BACK_FILTERSIZE": str(BACK_FILTERSIZE),
        "BACKPHOTO_TYPE": BACKPHOTO_TYPE, "GAIN": str(gain),
        "SATUR_LEVEL": str(satur),
        "CHECKIMAGE_TYPE": ",".join(ctypes) if ctypes else "NONE",
        "CHECKIMAGE_NAME": ",".join(checkfs) if checkfs else "check.fits",
        "FILTER": "N",
    }
    lines = []
    for line in dump.splitlines():
        key = line.split()[0] if line.split() else ""
        if key in patches:
            line = f"{key} {patches.pop(key)}"
        lines.append(line)
    for k, v in patches.items():
        lines.append(f"{k} {v}")
    with open(conf, "w") as f:
        f.write("\n".join(lines) + "\n")
    subprocess.run([binary, FITS_obj, "-c", conf], check=True,
                   capture_output=True, cwd=tdir)

    hdr0 = fits.getheader(FITS_obj)
    cat = parse_ldac_catalog(
        catf, ONLY_FLAGS=ONLY_FLAGS, XBoundary=XBoundary, YBoundary=YBoundary,
        N0=int(hdr0.get("NAXIS1", 0)), N1=int(hdr0.get("NAXIS2", 0)))
    checks = [fits.getdata(cf).T for cf in checkfs]
    if VERBOSE_LEVEL in (1, 2):
        print(f"MeLOn CheckPoint: PYSEx (binary) output catalog contains "
              f"[{len(cat)}] sources!")
    return cat, checks, None, None
