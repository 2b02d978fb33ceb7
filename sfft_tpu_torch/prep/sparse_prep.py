"""Automatic image masking for sparse fields.

Reference: Auto_SparsePrep (sfft/AutoSparsePrep.py): per-image catalogs +
SEGMENTATION, Hough point-source classification, symmetric cross-match,
top-flattened weighted-median magnitude offset, coarse (CVREJ) and elaborate
(EVREJ) variable rejection, then label surgery / prohibited zones / dilation
to produce the masked image pair for the solver. fastremap label surgery is
done with numpy mapping arrays.

A copy of sfft_tpu/prep/sparse_prep.py (numpy, on the host).
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
from scipy import ndimage

from sfft_tpu_torch.io import fits
from sfft_tpu_torch.prep.morph_classifier import HoughMorphClassifier
from sfft_tpu_torch.prep.sex import PYSEx
from sfft_tpu_torch.utils.match import SymmetricMatch
from sfft_tpu_torch.utils.quantile import TopFlattenWeightedQuantile
from sfft_tpu_torch.utils.table import Table


def _remap_negate(seg: np.ndarray, old_labels, new_labels) -> np.ndarray:
    """seg values in old_labels -> +new_labels; all OTHER positive labels are
    FLIPPED to negative (they become prohibited-zone markers). Equivalent to
    the reference's fastremap negate/flip trick (sfft/AutoSparsePrep.py:60-77:
    remap old -> -new with preserve_missing_labels, then multiply by -1, so
    SubSources end positive and every non-SubSource island ends negative)."""
    out = np.zeros_like(seg)
    maxlab = int(seg.max())
    # default: non-SubSource island label L -> -L (prohibited zone)
    lut = -np.arange(maxlab + 1, dtype=seg.dtype)
    for lo, ln in zip(np.asarray(old_labels, int), np.asarray(new_labels, int)):
        if 0 < lo <= maxlab:
            lut[lo] = ln
    pos = seg > 0
    out[pos] = lut[seg[pos]]
    return out


class AutoSparsePrep:
    def __init__(self, FITS_REF=None, FITS_SCI=None, PixA_REF=None, PixA_SCI=None,
                 REF_header=None, SCI_header=None,
                 GAIN_KEY="GAIN", SATUR_KEY="ESATUR", BACK_TYPE="MANUAL",
                 BACK_VALUE=0.0, BACK_SIZE=64, BACK_FILTERSIZE=3,
                 DETECT_THRESH=2.0, ANALYSIS_THRESH=2.0, DETECT_MINAREA=5,
                 DETECT_MAXAREA=0, DEBLEND_MINCONT=0.005,
                 BACKPHOTO_TYPE="LOCAL", ONLY_FLAGS=[0], BoundarySIZE=30,
                 VERBOSE_LEVEL=1):
        self.FITS_REF = FITS_REF
        self.FITS_SCI = FITS_SCI
        if PixA_REF is None:
            PixA_REF, REF_header = fits.read(FITS_REF)
            PixA_REF = PixA_REF.T.astype(np.float64)
        if PixA_SCI is None:
            PixA_SCI, SCI_header = fits.read(FITS_SCI)
            PixA_SCI = PixA_SCI.T.astype(np.float64)
        self.PixA_REF = PixA_REF
        self.PixA_SCI = PixA_SCI
        self.REF_header = REF_header or fits.Header()
        self.SCI_header = SCI_header or fits.Header()
        self.GAIN_KEY = GAIN_KEY
        self.SATUR_KEY = SATUR_KEY
        self.sex_kwargs = dict(
            GAIN_KEY=GAIN_KEY, SATUR_KEY=SATUR_KEY, BACK_TYPE=BACK_TYPE,
            BACK_VALUE=BACK_VALUE, BACK_SIZE=BACK_SIZE,
            BACK_FILTERSIZE=BACK_FILTERSIZE, DETECT_THRESH=DETECT_THRESH,
            ANALYSIS_THRESH=ANALYSIS_THRESH, DETECT_MINAREA=DETECT_MINAREA,
            DETECT_MAXAREA=DETECT_MAXAREA, DEBLEND_MINCONT=DEBLEND_MINCONT,
            BACKPHOTO_TYPE=BACKPHOTO_TYPE, ONLY_FLAGS=ONLY_FLAGS,
            BoundarySIZE=BoundarySIZE,
        )
        self.VERBOSE_LEVEL = VERBOSE_LEVEL

    # ------------------------------------------------------------------
    def run_image_mask(self, AstSEx_SS: Table, PixA_SEGr, PixA_SEGs,
                       StarExt_iter: int, XY_PriorBan) -> Dict:
        PixA_REF, PixA_SCI = self.PixA_REF, self.PixA_SCI
        SATLEVEL_REF = float(self.REF_header.get(self.SATUR_KEY, np.inf) or np.inf)
        SATLEVEL_SCI = float(self.SCI_header.get(self.SATUR_KEY, np.inf) or np.inf)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            SatMask_REF = PixA_REF >= SATLEVEL_REF
            SatMask_SCI = PixA_SCI >= SATLEVEL_SCI

        SEGL_SSr = np.array(AstSEx_SS["SEGLABEL_REF"]).astype(int)
        SEGL_SSs = np.array(AstSEx_SS["SEGLABEL_SCI"]).astype(int)
        SEGL_SS = np.array(AstSEx_SS["SEGLABEL"]).astype(int)

        PixA_SEGr = _remap_negate(PixA_SEGr, SEGL_SSr, SEGL_SS)
        PixA_SEGs = _remap_negate(PixA_SEGs, SEGL_SSs, SEGL_SS)

        # Prohibited zone: pixels of NON-SubSource islands (negative labels
        # after the remap) plus NaN pixels — dilation below must never extend
        # a kept star's mask into them (reference sfft/AutoSparsePrep.py:83:
        # ProZone = (PixA_SEGr < 0) | (PixA_SEGs < 0)).
        NaNmask_U = None
        NaNmask_REF = np.isnan(PixA_REF)
        NaNmask_SCI = np.isnan(PixA_SCI)
        ProZone = np.logical_or(PixA_SEGr < 0, PixA_SEGs < 0)
        if NaNmask_REF.any() or NaNmask_SCI.any():
            NaNmask_U = np.logical_or(NaNmask_REF, NaNmask_SCI)
            ProZone[NaNmask_U] = True

        SFFTLmap = np.max(np.array([PixA_SEGr, PixA_SEGs]), axis=0)
        SFFTLmap[ProZone] = 0
        struct0 = ndimage.generate_binary_structure(2, 1)
        struct = ndimage.iterate_structure(struct0, StarExt_iter)
        SFFTLmap = ndimage.grey_dilation(SFFTLmap, footprint=struct)
        SFFTLmap[ProZone] = -128

        if XY_PriorBan is not None:
            SEGL_PB = np.unique([
                SFFTLmap[int(_x - 0.5), int(_y - 0.5)] for _x, _y in XY_PriorBan
            ])
            SEGL_PB = SEGL_PB[SEGL_PB > 0]
            PBMASK_SS = np.isin(SEGL_SS, SEGL_PB)
            AstSEx_SS["MASK_PriorBan"] = PBMASK_SS
            if self.VERBOSE_LEVEL in (1, 2):
                print(f"MeLOn CheckPoint: Find / Given [{PBMASK_SS.sum()} / "
                      f"{len(XY_PriorBan)}] Prior-Banned in current "
                      f"[{len(AstSEx_SS)}] SubSources!")
            ban = np.isin(SFFTLmap, SEGL_SS[PBMASK_SS])
            SFFTLmap[ban] = -64

        ActiveMask = SFFTLmap > 0
        if self.VERBOSE_LEVEL in (1, 2):
            prop = ActiveMask.mean()
            print(f"MeLOn CheckPoint: Active-Mask Pixel Proportion [{prop:.2%}]")

        PixA_mREF = np.where(ActiveMask, PixA_REF, 0.0)
        PixA_mSCI = np.where(ActiveMask, PixA_SCI, 0.0)

        return {
            "PixA_REF": PixA_REF, "PixA_SCI": PixA_SCI,
            "REF-SAT-Mask": SatMask_REF, "SCI-SAT-Mask": SatMask_SCI,
            "Union-NaN-Mask": NaNmask_U,
            "SATLEVEL_REF": SATLEVEL_REF, "SATLEVEL_SCI": SATLEVEL_SCI,
            "SExCatalog-SubSource": AstSEx_SS, "SFFT-LabelMap": SFFTLmap,
            "Active-Mask": ActiveMask,
            "PixA_mREF": PixA_mREF, "PixA_mSCI": PixA_mSCI,
        }

    # ------------------------------------------------------------------
    def HoughAutoMask(self, Hough_MINFR=0.1, Hough_MAXFR=10.0,
                      Hough_PeakClip=0.7, BeltHW=0.2, PointSource_MINELLIP=0.3,
                      MatchTol=None, MatchTolFactor=3.0,
                      COARSE_VAR_REJECTION=True, CVREJ_MAGD_THRESH=0.12,
                      ELABO_VAR_REJECTION=False, EVREJ_RATIO_THREH=5.0,
                      EVREJ_SAFE_MAGDEV=0.04, StarExt_iter=4,
                      XY_PriorBan=None) -> Dict:
        def main_hough(pix, hdr):
            cat, checks, _, _ = HoughMorphClassifier.MakeCatalog(
                PixA_obj=pix, CHECKIMAGE_TYPE="SEGMENTATION", AddSNR=False,
                VERBOSE_LEVEL=self.VERBOSE_LEVEL, **{
                    k: v for k, v in self.sex_kwargs.items()
                    if k != "BoundarySIZE"
                }, BoundarySIZE=self.sex_kwargs["BoundarySIZE"],
            )
            seg = checks[0].astype(int)
            hc = HoughMorphClassifier.Classifier(
                AstSEx=cat, Hough_MINFR=Hough_MINFR, Hough_MAXFR=Hough_MAXFR,
                Hough_PeakClip=Hough_PeakClip, BeltHW=BeltHW,
                PointSource_MINELLIP=PointSource_MINELLIP,
                VERBOSE_LEVEL=self.VERBOSE_LEVEL,
            )
            fwhm = hc[5]
            cat_gs = cat[hc[3]]
            return cat_gs, fwhm, seg

        AstSEx_GSr, FWHM_REF, PixA_SEGr = main_hough(self.PixA_REF, self.REF_header)
        AstSEx_GSs, FWHM_SCI, PixA_SEGs = main_hough(self.PixA_SCI, self.SCI_header)

        XY_GSr = np.array([AstSEx_GSr["X_IMAGE"], AstSEx_GSr["Y_IMAGE"]]).T
        XY_GSs = np.array([AstSEx_GSs["X_IMAGE"], AstSEx_GSs["Y_IMAGE"]]).T
        tol = MatchTol or float(np.sqrt((FWHM_REF / MatchTolFactor) ** 2
                                        + (FWHM_SCI / MatchTolFactor) ** 2))
        Symm = SymmetricMatch.SM(XY_A=XY_GSr, XY_B=XY_GSs, tol=tol)
        AstSEx_MGSr = AstSEx_GSr[Symm[:, 0]]
        AstSEx_MGSs = AstSEx_GSs[Symm[:, 1]]
        NUM_MGS = Symm.shape[0]

        MAGD = np.array(AstSEx_MGSs["MAG_AUTO"]) - np.array(AstSEx_MGSr["MAG_AUTO"])
        mo_r = TopFlattenWeightedQuantile.TFWQ(
            values=MAGD, weights=np.array(AstSEx_MGSr["FLUX_AUTO"]),
            quantiles=[0.5], NUM_TOP_END=30)[0]
        mo_s = TopFlattenWeightedQuantile.TFWQ(
            values=MAGD, weights=np.array(AstSEx_MGSs["FLUX_AUTO"]),
            quantiles=[0.5], NUM_TOP_END=30)[0]
        MAG_OFFSET = (mo_r + mo_s) / 2.0

        if COARSE_VAR_REJECTION:
            cv = np.abs(MAGD - MAG_OFFSET) > CVREJ_MAGD_THRESH
            AstSEx_iSSr = AstSEx_MGSr[~cv]
            AstSEx_iSSs = AstSEx_MGSs[~cv]
            if self.VERBOSE_LEVEL in (1, 2):
                print(f"MeLOn CheckPoint: Coarse Variable Rejection "
                      f"[{cv.sum()} / {NUM_MGS}]!")
        else:
            AstSEx_iSSr, AstSEx_iSSs = AstSEx_MGSr, AstSEx_MGSs

        if ELABO_VAR_REJECTION and len(AstSEx_iSSr):
            MAGD_i = (np.array(AstSEx_iSSs["MAG_AUTO"])
                      - np.array(AstSEx_iSSr["MAG_AUTO"]))
            fscal = 10 ** (MAG_OFFSET / -2.5)
            sfr = fscal * np.array(AstSEx_iSSr["FLUX_AUTO"])
            sfer = fscal * np.array(AstSEx_iSSr["FLUXERR_AUTO"])
            data = np.array(AstSEx_iSSs["FLUX_AUTO"]) - sfr
            sigma = np.sqrt(sfer ** 2 + np.array(AstSEx_iSSs["FLUXERR_AUTO"]) ** 2)
            out = np.abs(data) > EVREJ_RATIO_THREH * sigma
            safe = np.abs(MAGD_i - MAG_OFFSET) <= EVREJ_SAFE_MAGDEV
            ev = np.logical_and(out, ~safe)
            AstSEx_SSr = AstSEx_iSSr[~ev]
            AstSEx_SSs = AstSEx_iSSs[~ev]
            if self.VERBOSE_LEVEL in (1, 2):
                print(f"MeLOn CheckPoint: Elaborate Variable Rejection "
                      f"[{ev.sum()} / {NUM_MGS}]!")
        else:
            AstSEx_SSr, AstSEx_SSs = AstSEx_iSSr, AstSEx_iSSs

        data = {}
        for coln in AstSEx_SSr.colnames:
            data[coln + "_REF"] = AstSEx_SSr[coln]
        for coln in AstSEx_SSs.colnames:
            data[coln + "_SCI"] = AstSEx_SSs[coln]
        AstSEx_SS = Table(data)
        AstSEx_SS["SEGLABEL"] = 1 + np.arange(len(AstSEx_SS))
        if self.VERBOSE_LEVEL in (1, 2):
            print(f"MeLOn CheckPoint: SubSources out of Matched-GoodSources "
                  f"[{len(AstSEx_SS)} / {NUM_MGS}]!")

        d = self.run_image_mask(AstSEx_SS, PixA_SEGr, PixA_SEGs,
                                StarExt_iter, XY_PriorBan)
        d["MAG_OFFSET"] = MAG_OFFSET
        d["FWHM_REF"] = FWHM_REF
        d["FWHM_SCI"] = FWHM_SCI
        return d

    # ------------------------------------------------------------------
    def SemiAutoMask(self, XY_PriorSelect=None, MatchTol=None,
                     MatchTolFactor=3.0, StarExt_iter=4,
                     XY_PriorBan=None) -> Dict:
        def func4phot(pix):
            cat, checks, _, _ = PYSEx.PS(
                PixA_obj=pix,
                SExParam=["X_IMAGE", "Y_IMAGE", "FLUX_AUTO", "FLUXERR_AUTO",
                          "MAG_AUTO", "MAGERR_AUTO", "FLAGS", "FLUX_RADIUS",
                          "FWHM_IMAGE", "A_IMAGE", "B_IMAGE"],
                CHECKIMAGE_TYPE="SEGMENTATION",
                XBoundary=self.sex_kwargs["BoundarySIZE"],
                YBoundary=self.sex_kwargs["BoundarySIZE"],
                VERBOSE_LEVEL=self.VERBOSE_LEVEL, **{
                    k: v for k, v in self.sex_kwargs.items()
                    if k != "BoundarySIZE"
                },
            )
            seg = checks[0].astype(int)
            vals = np.array(cat["FWHM_IMAGE"])
            wts = np.array(cat["FLUX_AUTO"]) / np.clip(vals, 1.0, None) ** 2
            fwhm = TopFlattenWeightedQuantile.TFWQ(
                values=vals, weights=wts, quantiles=[0.5], NUM_TOP_END=30)[0]
            return cat, fwhm, seg

        AstSExr, FWHM_REF, PixA_SEGr = func4phot(self.PixA_REF)
        AstSExs, FWHM_SCI, PixA_SEGs = func4phot(self.PixA_SCI)

        XYr = np.array([AstSExr["X_IMAGE"], AstSExr["Y_IMAGE"]]).T
        XYs = np.array([AstSExs["X_IMAGE"], AstSExs["Y_IMAGE"]]).T
        tol = MatchTol or float(np.sqrt((FWHM_REF / MatchTolFactor) ** 2
                                        + (FWHM_SCI / MatchTolFactor) ** 2))
        Symm = SymmetricMatch.SM(XY_A=XYr, XY_B=XYs, tol=tol)
        Mr = AstSExr[Symm[:, 0]]
        Ms = AstSExs[Symm[:, 1]]

        MAGD = np.array(Ms["MAG_AUTO"]) - np.array(Mr["MAG_AUTO"])
        mo_r = TopFlattenWeightedQuantile.TFWQ(
            values=MAGD, weights=np.array(Mr["FLUX_AUTO"]),
            quantiles=[0.5], NUM_TOP_END=30)[0]
        mo_s = TopFlattenWeightedQuantile.TFWQ(
            values=MAGD, weights=np.array(Ms["FLUX_AUTO"]),
            quantiles=[0.5], NUM_TOP_END=30)[0]
        MAG_OFFSET = (mo_r + mo_s) / 2.0

        data = {}
        for coln in Mr.colnames:
            data[coln + "_REF"] = Mr[coln]
        for coln in Ms.colnames:
            data[coln + "_SCI"] = Ms[coln]
        AstSEx_iSS = Table(data)
        xmean = (data["X_IMAGE_REF"] + data["X_IMAGE_SCI"]) / 2.0
        ymean = (data["Y_IMAGE_REF"] + data["Y_IMAGE_SCI"]) / 2.0
        AstSEx_iSS["X_IMAGE_REF_SCI_MEAN"] = xmean
        AstSEx_iSS["Y_IMAGE_REF_SCI_MEAN"] = ymean

        XY_iSS = np.array([xmean, ymean]).T
        Symm2 = SymmetricMatch.SM(XY_A=np.asarray(XY_PriorSelect, float),
                                  XY_B=XY_iSS, tol=tol)
        AstSEx_SS = AstSEx_iSS[Symm2[:, 1]]
        AstSEx_SS["INDEX_PRIOR_SELECTION"] = Symm2[:, 0]
        AstSEx_SS["SEGLABEL"] = 1 + np.arange(len(AstSEx_SS))
        if self.VERBOSE_LEVEL in (1, 2):
            print(f"MeLOn CheckPoint: Find / Given [{len(AstSEx_SS)} / "
                  f"{len(XY_PriorSelect)}] Prior-Selected in "
                  f"[{len(AstSEx_iSS)}] Matched-Sources!")

        d = self.run_image_mask(AstSEx_SS, PixA_SEGr, PixA_SEGs,
                                StarExt_iter, XY_PriorBan)
        d["MAG_OFFSET"] = MAG_OFFSET
        d["FWHM_REF"] = FWHM_REF
        d["FWHM_SCI"] = FWHM_SCI
        return d
