"""Image resampling: SWarp-equivalent WCS alignment + PSF zoom/rotate.

Reference: PY_SWarp.PS (sfft/utils/pyAstroMatic/PYSWarp.py) shells out to the
SWarp binary to resample an image onto a reference WCS; Image_ZoomRotate.IZR
(sfft/utils/ImageZoomRotate.py) zooms/rotates PSF stamps through a synthetic
WCS + SWarp. Without the binary, both are implemented here by direct inverse
coordinate mapping (our WCS module + scipy.ndimage.map_coordinates), with an
optional subprocess path when `swarp` exists.

A copy of sfft_tpu/prep/resample.py (numpy and scipy, on the host).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np
from scipy import ndimage as ndi

from sfft_tpu_torch.io import fits
from sfft_tpu_torch.utils.wcs import CombineHeader, ReadWCS


def _find_swarp_binary() -> Optional[str]:
    for name in ("swarp", "SWarp"):
        path = shutil.which(name)
        if path:
            return path
    return None


def _run_swarp_binary(binary: str, FITS_obj: str, FITS_ref: str,
                      FITS_resamp: Optional[str], GAIN_KEY: str,
                      SATUR_KEY: str, OVERSAMPLING: int,
                      RESAMPLING_TYPE: str, FILL_VALUE: float,
                      VERBOSE_LEVEL: int) -> np.ndarray:
    """SWarp subprocess path (reference PY_SWarp.PS,
    sfft/utils/pyAstroMatic/PYSWarp.py:15-212 + AMConfigMaker.py:29-53):
    dump the tool's default config (`swarp -dd`), patch keys, point the
    output grid at FITS_ref's WCS via a `.head` file, run, and read back the
    resampled image with weight==0 pixels filled."""
    tdir = tempfile.mkdtemp(prefix="pyswarp_")
    try:
        conf = os.path.join(tdir, "pyswarp.swarp")
        out_fits = os.path.join(tdir, "resamp.fits")
        out_wt = os.path.join(tdir, "resamp.weight.fits")
        dump = subprocess.run([binary, "-dd"], capture_output=True,
                              text=True).stdout
        patches = {
            "IMAGEOUT_NAME": out_fits, "WEIGHTOUT_NAME": out_wt,
            "GAIN_KEYWORD": GAIN_KEY, "SATLEV_KEYWORD": SATUR_KEY,
            "OVERSAMPLING": str(OVERSAMPLING),
            "RESAMPLING_TYPE": RESAMPLING_TYPE,
            "SUBTRACT_BACK": "N", "COMBINE": "Y", "COMBINE_TYPE": "MEDIAN",
            "WEIGHT_SUFFIX": ".weight.fits", "WRITE_XML": "N",
            "VERBOSE_TYPE": "QUIET" if VERBOSE_LEVEL < 2 else "NORMAL",
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

        # target grid: .head file named like the output image, carrying the
        # reference WCS cards + dimensions
        hdr_ref = fits.getheader(FITS_ref)
        head_keys = set(CombineHeader.WCS_KEYS) | {
            "BITPIX", "NAXIS", "NAXIS1", "NAXIS2"}
        head_cards = []
        for key, value, comment in hdr_ref.cards:
            if key in head_keys or key.startswith("PV"):
                if isinstance(value, bool):
                    field = "T" if value else "F"
                elif isinstance(value, str):
                    field = f"'{value:<8}'"
                else:
                    field = repr(value)
                head_cards.append(f"{key:<8}= {field:>21}"[:80])
        head_cards.append("END")
        with open(out_fits[:-5] + ".head", "w") as f:
            f.write("\n".join(head_cards) + "\n")

        subprocess.run([binary, os.path.abspath(FITS_obj), "-c", conf],
                       check=True, capture_output=True, cwd=tdir)

        data_out, hdr_out_sw = fits.read(out_fits)
        wt = fits.getdata(out_wt)
        out = data_out.astype(np.float64)
        out[wt == 0] = FILL_VALUE

        if FITS_resamp is not None:
            hdr_obj = fits.getheader(FITS_obj)
            hdr_op = CombineHeader.CH(hdr_base=hdr_obj, hdr_wcs=hdr_ref)
            new_satur = hdr_out_sw.get("SATURATE")
            if new_satur is not None and SATUR_KEY in hdr_op:
                hdr_op.set(SATUR_KEY, new_satur, "MeLOn: PYSWarp")
            hdr_op.add("SWARP_O", os.path.basename(FITS_obj), "MeLOn: PYSWarp")
            hdr_op.add("SWARP_R", os.path.basename(FITS_ref), "MeLOn: PYSWarp")
            fits.write(FITS_resamp, out, hdr_op)
        if VERBOSE_LEVEL in (1, 2):
            print("MeLOn CheckPoint: PYSWarp (binary) resampling done!")
        return out
    finally:
        shutil.rmtree(tdir, ignore_errors=True)


class PYSWarp:
    @staticmethod
    def PS(FITS_obj: str, FITS_ref: str, FITS_resamp: str,
           GAIN_KEY: str = "GAIN", SATUR_KEY: str = "SATURATE",
           OVERSAMPLING: int = 1, RESAMPLING_TYPE: str = "LANCZOS3",
           FILL_VALUE: float = np.nan, VERBOSE_LEVEL: int = 1,
           use_binary: Optional[bool] = None):
        """Resample FITS_obj onto FITS_ref's pixel grid (WCS-aligned).

        Uses the swarp binary when available (bit-faithful to the reference's
        resampler); otherwise exact inverse-mapping interpolation (spline
        order 3 for LANCZOS3, order 1 for BILINEAR)."""
        binary = _find_swarp_binary() if use_binary in (None, True) else None
        if binary is not None:
            try:
                return _run_swarp_binary(
                    binary, FITS_obj, FITS_ref, FITS_resamp, GAIN_KEY,
                    SATUR_KEY, OVERSAMPLING, RESAMPLING_TYPE, FILL_VALUE,
                    VERBOSE_LEVEL)
            except Exception as exc:
                if VERBOSE_LEVEL >= 1:
                    print(f"MeLOn WARNING: swarp binary failed ({exc}); "
                          "falling back to internal resampler")

        data_obj, hdr_obj = fits.read(FITS_obj)
        data_ref, hdr_ref = fits.read(FITS_ref)
        obj = data_obj.astype(np.float64)          # FITS row-major (y, x)
        w_obj = ReadWCS.RW(hdr_obj)
        w_ref = ReadWCS.RW(hdr_ref)

        n1r = int(hdr_ref["NAXIS1"])
        n2r = int(hdr_ref["NAXIS2"])
        # ref grid pixel centers, 1-based
        xx, yy = np.meshgrid(np.arange(1, n1r + 1), np.arange(1, n2r + 1))
        rd = w_ref.all_pix2world(
            np.stack([xx.ravel(), yy.ravel()], axis=1), 1)
        pix_obj = w_obj.all_world2pix(rd, 1)
        # map to 0-based array indices (FITS data: axis0 = y = NAXIS2)
        cx = (pix_obj[:, 1] - 1.0).reshape(n2r, n1r)
        cy = (pix_obj[:, 0] - 1.0).reshape(n2r, n1r)
        order = 1 if RESAMPLING_TYPE.upper() == "BILINEAR" else 3
        out = ndi.map_coordinates(np.nan_to_num(obj, nan=0.0), [cx, cy],
                                  order=order, mode="constant", cval=np.nan)
        # mark off-frame regions
        bad = ((cx < -0.5) | (cx > obj.shape[0] - 0.5)
               | (cy < -0.5) | (cy > obj.shape[1] - 0.5))
        out[bad] = FILL_VALUE

        hdr_out = fits.Header()
        for key, value, comment in hdr_ref.cards:
            hdr_out.add(key, value, comment)
        for key in (GAIN_KEY, SATUR_KEY):
            if key in hdr_obj:
                hdr_out.set(key, hdr_obj[key], "sfft_tpu: from input image")
        fits.write(FITS_resamp, out, hdr_out)
        return out


class ImageZoomRotate:
    @staticmethod
    def IZR(PixA_obj: np.ndarray, ZOOM_SCAL_x: float = 1.0,
            ZOOM_SCAL_y: float = 1.0, PATTERN_ROTATE_ANGLE: float = 0.0,
            RESAMPLING_TYPE: str = "LANCZOS3", FILL_VALUE: float = 0.0,
            VERBOSE_LEVEL: int = 1) -> np.ndarray:
        """Zoom + counterclockwise-rotate an image about its center with
        approximate flux conservation (reference Image_ZoomRotate.IZR)."""
        img = np.nan_to_num(np.asarray(PixA_obj, np.float64), nan=FILL_VALUE)
        N0, N1 = img.shape
        c0, c1 = (N0 - 1) / 2.0, (N1 - 1) / 2.0
        th = np.deg2rad(PATTERN_ROTATE_ANGLE)
        # output pixel -> input pixel: rotate by -th then unzoom
        R = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
        S = np.diag([1.0 / ZOOM_SCAL_x, 1.0 / ZOOM_SCAL_y])
        M = S @ R
        xx, yy = np.meshgrid(np.arange(N0), np.arange(N1), indexing="ij")
        d = np.stack([xx.ravel() - c0, yy.ravel() - c1])
        src = (M @ d)
        cx = (src[0] + c0).reshape(N0, N1)
        cy = (src[1] + c1).reshape(N0, N1)
        order = 1 if RESAMPLING_TYPE.upper() == "BILINEAR" else 3
        out = ndi.map_coordinates(img, [cx, cy], order=order,
                                  mode="constant", cval=FILL_VALUE)
        # flux conservation under zoom
        out = out / (ZOOM_SCAL_x * ZOOM_SCAL_y)
        return out
