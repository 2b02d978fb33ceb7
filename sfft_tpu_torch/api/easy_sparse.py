"""Easy sparse packet: fully automatic sparse-field subtraction
(counterpart of sfft_tpu/api/easy_sparse.py).

Reference: Easy_SparsePacket.ESP (sfft/EasySparsePacket.py:17-600):
Auto_SparsePrep (HOUGH-AUTO or SEMI-AUTO) -> auto ConvdSide by FWHM comparison
-> KerHW = clip(KerHWRatio * maxFWHM, KerHWLimit) -> solve+subtract ->
flux-scaling estimate (center point or 64-px grid) -> optional Post-Anomaly
Check on labeled difference flux sums -> NaN/saturation masking and
GAIN/SATUR header rescaling when SCI is convolved.

The preprocessing (``ESP_Prep``) is numpy on the host and touches no
device. ``ESP_Subtract`` runs GeneralSFFT.GSS on `device` (the CUDA card
when None; without one it raises; pass device="cpu" for the CPU), or on
the plain twins with plain=True, and brings the solution, the difference
and the contamination mask to the host once each; everything after the
solve is numpy.
"""

from __future__ import annotations

import os.path as pa
import time
from typing import Optional, Tuple

import numpy as np
from scipy import ndimage

from sfft_tpu_torch.config import make_config
from sfft_tpu_torch.core.engine import GeneralSFFT
from sfft_tpu_torch.io import fits
from sfft_tpu_torch.post.solution import RealizeFluxScaling
from sfft_tpu_torch.prep.sparse_prep import AutoSparsePrep


def assemble_inputs(SFFTPrepDict: dict, ForceConv: str, GKerHW, KerHWRatio: float,
                    KerHWLimit, KerPolyOrder: int, BGPolyOrder: int,
                    ConstPhotRatio: bool, MaskSatContam: bool,
                    cfg_overrides: Optional[dict]) -> dict:
    """The decisions after either packet's preprocessing (ConvdSide by FWHM,
    KerHW), the config, and the masked / unmasked image pair with the NaN
    union patched from the masked images (sfft_tpu's ESP_Prep / ECP_Prep
    tail)."""
    FWHM_REF = SFFTPrepDict["FWHM_REF"]
    FWHM_SCI = SFFTPrepDict["FWHM_SCI"]
    assert ForceConv in ("AUTO", "REF", "SCI")
    if ForceConv == "AUTO":
        ConvdSide = "REF" if FWHM_SCI >= FWHM_REF else "SCI"
    else:
        ConvdSide = ForceConv
    if GKerHW is None:
        KerHW = int(np.clip(KerHWRatio * max(FWHM_REF, FWHM_SCI),
                            KerHWLimit[0], KerHWLimit[1]))
    else:
        KerHW = GKerHW

    PixA_REF = SFFTPrepDict["PixA_REF"]
    PixA_SCI = SFFTPrepDict["PixA_SCI"]
    cfg = make_config(
        NX=PixA_REF.shape[0], NY=PixA_REF.shape[1], KerHW=KerHW,
        KerPolyOrder=KerPolyOrder, BGPolyOrder=BGPolyOrder,
        ConstPhotRatio=ConstPhotRatio, **(cfg_overrides or {}),
    )

    SatMask_REF = SFFTPrepDict["REF-SAT-Mask"]
    SatMask_SCI = SFFTPrepDict["SCI-SAT-Mask"]
    NaNmask_U = SFFTPrepDict["Union-NaN-Mask"]
    PixA_mREF = SFFTPrepDict["PixA_mREF"]
    PixA_mSCI = SFFTPrepDict["PixA_mSCI"]

    if ConvdSide == "REF":
        PixA_mI, PixA_mJ = PixA_mREF, PixA_mSCI
        base_I, base_J = PixA_REF, PixA_SCI
        ContamMask_I = SatMask_REF if MaskSatContam else None
        ContamMask_J = SatMask_SCI
    else:
        PixA_mI, PixA_mJ = PixA_mSCI, PixA_mREF
        base_I, base_J = PixA_SCI, PixA_REF
        ContamMask_I = SatMask_SCI if MaskSatContam else None
        ContamMask_J = SatMask_REF
    if NaNmask_U is not None:
        PixA_I = np.where(NaNmask_U, PixA_mI, base_I)
        PixA_J = np.where(NaNmask_U, PixA_mJ, base_J)
    else:
        PixA_I, PixA_J = base_I, base_J

    return {
        "SFFTPrepDict": SFFTPrepDict, "cfg": cfg, "ConvdSide": ConvdSide,
        "KerHW": KerHW, "FWHM_REF": FWHM_REF, "FWHM_SCI": FWHM_SCI,
        "PixA_I": PixA_I, "PixA_J": PixA_J,
        "PixA_mI": PixA_mI, "PixA_mJ": PixA_mJ,
        "ContamMask_I": ContamMask_I, "ContamMask_J": ContamMask_J,
        "NaNmask_U": NaNmask_U,
    }


def solve_and_mask(prep: dict, MaskSatContam: bool, VERBOSE_LEVEL: int, precomputed,
                   plain: bool, device):
    """GSS on the prepared pair (or `precomputed` = (solution, difference)
    tensors), brought to the host; returns (solution, difference with the
    ConvdSide sign, the function that NaN-masks a difference)."""
    cfg = prep["cfg"]
    t0 = time.time()
    if precomputed is None:
        Solution, diff, ContamMask_CI = GeneralSFFT.GSS(
            prep["PixA_I"], prep["PixA_J"], prep["PixA_mI"], prep["PixA_mJ"], cfg,
            ContamMask_I=prep["ContamMask_I"], plain=plain, device=device)
    else:
        Solution, diff = precomputed
        ContamMask_CI = None
    Solution = Solution.cpu().numpy()
    PixA_DIFF = diff.cpu().numpy()
    if ContamMask_CI is not None:
        ContamMask_CI = ContamMask_CI.cpu().numpy()
    if VERBOSE_LEVEL in (1, 2):
        print(f"MeLOn Report: SFFT-SUBTRACTION TAKES [{time.time()-t0:.3f} s]!")
    if prep["ConvdSide"] == "SCI":
        PixA_DIFF = -PixA_DIFF

    def mask(PixA_DIFF):
        if prep["NaNmask_U"] is not None:
            PixA_DIFF = np.where(prep["NaNmask_U"], np.nan, PixA_DIFF)
        if MaskSatContam and ContamMask_CI is not None:
            ContamMask_DIFF = np.logical_or(ContamMask_CI, prep["ContamMask_J"])
            PixA_DIFF = np.where(ContamMask_DIFF, np.nan, PixA_DIFF)
        return PixA_DIFF

    return Solution, PixA_DIFF, mask


def diff_header(prep: dict, FITS_REF: str, FITS_SCI: str, KerPolyOrder: int,
                BGPolyOrder: int, ConstPhotRatio: bool):
    """The difference's FITS header: the science image's cards and the
    packet's keys; returns (header, the science header)."""
    _, sci_hdr = fits.read(FITS_SCI)
    hdr = fits.Header()
    for key, value, comment in sci_hdr.cards:
        hdr.add(key, value, comment)
    hdr.add("NAME_REF", pa.basename(FITS_REF), "MeLOn: SFFT")
    hdr.add("NAME_SCI", pa.basename(FITS_SCI), "MeLOn: SFFT")
    hdr.add("FWHM_REF", prep["FWHM_REF"], "MeLOn: SFFT")
    hdr.add("FWHM_SCI", prep["FWHM_SCI"], "MeLOn: SFFT")
    hdr.add("KERORDER", KerPolyOrder, "MeLOn: SFFT")
    hdr.add("BGORDER", BGPolyOrder, "MeLOn: SFFT")
    hdr.add("CPHOTR", str(ConstPhotRatio), "MeLOn: SFFT")
    hdr.add("KERHW", prep["KerHW"], "MeLOn: SFFT")
    hdr.add("CONVD", prep["ConvdSide"], "MeLOn: SFFT")
    return hdr, sci_hdr


class EasySparsePacket:
    @staticmethod
    def ESP_Prep(
        FITS_REF: str, FITS_SCI: str, ForceConv: str = "AUTO",
        GKerHW: Optional[int] = None, KerHWRatio: float = 2.0,
        KerHWLimit: Tuple[int, int] = (2, 20), KerPolyOrder: int = 2,
        BGPolyOrder: int = 2, ConstPhotRatio: bool = True,
        MaskSatContam: bool = False, GAIN_KEY: str = "GAIN",
        SATUR_KEY: str = "ESATUR", BACK_TYPE: str = "MANUAL",
        BACK_VALUE: float = 0.0, BACK_SIZE: int = 64,
        BACK_FILTERSIZE: int = 3, DETECT_THRESH: float = 2.0,
        ANALYSIS_THRESH: float = 2.0, DETECT_MINAREA: int = 5,
        DETECT_MAXAREA: int = 0, DEBLEND_MINCONT: float = 0.005,
        BACKPHOTO_TYPE: str = "LOCAL", ONLY_FLAGS=[0], BoundarySIZE: int = 30,
        XY_PriorSelect=None, Hough_MINFR: float = 0.1,
        Hough_PeakClip: float = 0.7, BeltHW: float = 0.2,
        PointSource_MINELLIP: float = 0.3, MatchTol=None,
        MatchTolFactor: float = 3.0, COARSE_VAR_REJECTION: bool = True,
        CVREJ_MAGD_THRESH: float = 0.12, ELABO_VAR_REJECTION: bool = False,
        EVREJ_RATIO_THREH: float = 5.0, EVREJ_SAFE_MAGDEV: float = 0.04,
        StarExt_iter: int = 4, XY_PriorBan=None,
        VERBOSE_LEVEL: int = 1, cfg_overrides: Optional[dict] = None,
        **_ignored,
    ) -> dict:
        """Host preprocessing stage: Auto_SparsePrep + ConvdSide/KerHW
        decision + masked/unmasked input assembly. Touches no device, so a
        survey scheduler can overlap it with the subtraction of other pairs
        (reference MultiEasySparsePacket.py:455-485)."""
        _ASP = AutoSparsePrep(
            FITS_REF=FITS_REF, FITS_SCI=FITS_SCI, GAIN_KEY=GAIN_KEY,
            SATUR_KEY=SATUR_KEY, BACK_TYPE=BACK_TYPE, BACK_VALUE=BACK_VALUE,
            BACK_SIZE=BACK_SIZE, BACK_FILTERSIZE=BACK_FILTERSIZE,
            DETECT_THRESH=DETECT_THRESH, ANALYSIS_THRESH=ANALYSIS_THRESH,
            DETECT_MINAREA=DETECT_MINAREA, DETECT_MAXAREA=DETECT_MAXAREA,
            DEBLEND_MINCONT=DEBLEND_MINCONT, BACKPHOTO_TYPE=BACKPHOTO_TYPE,
            ONLY_FLAGS=ONLY_FLAGS, BoundarySIZE=BoundarySIZE,
            VERBOSE_LEVEL=VERBOSE_LEVEL,
        )
        if XY_PriorSelect is None:
            if VERBOSE_LEVEL in (0, 1, 2):
                print("MeLOn CheckPoint: TRIGGER Sparse-Flavor Auto "
                      "Preprocessing [HOUGH-AUTO] MODE!")
            SFFTPrepDict = _ASP.HoughAutoMask(
                Hough_MINFR=Hough_MINFR, Hough_PeakClip=Hough_PeakClip,
                BeltHW=BeltHW, PointSource_MINELLIP=PointSource_MINELLIP,
                MatchTol=MatchTol, MatchTolFactor=MatchTolFactor,
                COARSE_VAR_REJECTION=COARSE_VAR_REJECTION,
                CVREJ_MAGD_THRESH=CVREJ_MAGD_THRESH,
                ELABO_VAR_REJECTION=ELABO_VAR_REJECTION,
                EVREJ_RATIO_THREH=EVREJ_RATIO_THREH,
                EVREJ_SAFE_MAGDEV=EVREJ_SAFE_MAGDEV,
                StarExt_iter=StarExt_iter, XY_PriorBan=XY_PriorBan,
            )
        else:
            if VERBOSE_LEVEL in (0, 1, 2):
                print("MeLOn CheckPoint: TRIGGER Sparse-Flavor Auto "
                      "Preprocessing [SEMI-AUTO] MODE!")
            SFFTPrepDict = _ASP.SemiAutoMask(
                XY_PriorSelect=XY_PriorSelect, MatchTol=MatchTol,
                MatchTolFactor=MatchTolFactor, StarExt_iter=StarExt_iter,
                XY_PriorBan=XY_PriorBan,
            )
        return assemble_inputs(SFFTPrepDict, ForceConv, GKerHW, KerHWRatio, KerHWLimit,
                               KerPolyOrder, BGPolyOrder, ConstPhotRatio, MaskSatContam,
                               cfg_overrides)

    @staticmethod
    def ESP_Subtract(
        prep: dict, FITS_REF: str, FITS_SCI: str,
        FITS_DIFF: Optional[str] = None, FITS_Solution: Optional[str] = None,
        KerPolyOrder: int = 2, BGPolyOrder: int = 2,
        ConstPhotRatio: bool = True, MaskSatContam: bool = False,
        GAIN_KEY: str = "GAIN", SATUR_KEY: str = "ESATUR",
        PostAnomalyCheck: bool = False, PAC_RATIO_THRESH: float = 5.0,
        VERBOSE_LEVEL: int = 1, precomputed=None, device=None, plain: bool = False,
        **_ignored,
    ):
        """Device stage: solve+subtract on the prepped arrays on `device`,
        then the host post-processing (flux scaling, Post-Anomaly Check,
        FITS output). `precomputed=(Solution, PixA_DIFF)` (tensors) skips
        the solve."""
        SFFTPrepDict = prep["SFFTPrepDict"]
        cfg = prep["cfg"]
        ConvdSide = prep["ConvdSide"]
        Solution, PixA_DIFF, mask = solve_and_mask(prep, MaskSatContam, VERBOSE_LEVEL,
                                                   precomputed, plain, device)

        # flux-scaling estimate
        N0, N1 = cfg.N0, cfg.N1
        if ConstPhotRatio:
            XY_q = np.array([[N0 / 2.0, N1 / 2.0]]) + 0.5
            fs = RealizeFluxScaling(XY_q).from_solution(Solution, cfg)
            SFFT_FSCAL_MEAN, SFFT_FSCAL_SIG = float(fs[0]), 0.0
        else:
            NTX = max(round(N0 / 64), 6)
            NTY = max(round(N1 / 64), 6)
            GX = np.linspace(0.5, N0 + 0.5, NTX + 1)
            GY = np.linspace(0.5, N1 + 0.5, NTY + 1)
            YY, XX = np.meshgrid(GY, GX)
            XY_q = np.array([XX.ravel(), YY.ravel()]).T
            fs = RealizeFluxScaling(XY_q).from_solution(Solution, cfg)
            SFFT_FSCAL_MEAN, SFFT_FSCAL_SIG = float(np.mean(fs)), float(np.std(fs))

        if VERBOSE_LEVEL in (1, 2):
            print(f"MeLOn CheckPoint: Flux Scaling through the convolution "
                  f"[{SFFT_FSCAL_MEAN:.6f} +/- {SFFT_FSCAL_SIG:.6f}]!")

        # Post-Anomaly Check
        if PostAnomalyCheck:
            AstSEx_SS = SFFTPrepDict["SExCatalog-SubSource"]
            SFFTLmap = SFFTPrepDict["SFFT-LabelMap"]
            if "MASK_PriorBan" in AstSEx_SS.colnames:
                nPB = ~np.array(AstSEx_SS["MASK_PriorBan"])
                AstSEx_vSS = AstSEx_SS[nPB]
            else:
                nPB = np.ones(len(AstSEx_SS), bool)
                AstSEx_vSS = AstSEx_SS
            FER = np.array(AstSEx_vSS["FLUXERR_AUTO_REF"])
            FES = np.array(AstSEx_vSS["FLUXERR_AUTO_SCI"])
            if ConvdSide == "REF":
                ExpDVAR = (FER * SFFT_FSCAL_MEAN) ** 2 + FES**2
            else:
                ExpDVAR = FER**2 + (FES * SFFT_FSCAL_MEAN) ** 2
            SEGL = np.array(AstSEx_vSS["SEGLABEL"], int)
            DFSUM = ndimage.labeled_comprehension(
                PixA_DIFF, SFFTLmap, SEGL, np.sum, float, 0.0)
            RATIO = DFSUM / np.clip(np.sqrt(ExpDVAR), 1e-8, None)
            PAMASK = np.abs(RATIO) > PAC_RATIO_THRESH
            if VERBOSE_LEVEL in (1, 2):
                print(f"MeLOn CheckPoint: Identified [{PAMASK.sum()}] "
                      f"PostAnomaly SubSources [> {PAC_RATIO_THRESH:.2f} "
                      f"sigma] out of [{len(AstSEx_vSS)}]!")
            for name, arr in [("ExpDVAR_PostAnomaly", ExpDVAR),
                              ("DFSUM_PostAnomaly", DFSUM),
                              ("RATIO_PostAnomaly", RATIO),
                              ("MASK_PostAnomaly", PAMASK)]:
                full = np.full(len(AstSEx_SS),
                               np.nan if arr.dtype.kind == "f" else False,
                               dtype=arr.dtype if arr.dtype.kind == "f" else bool)
                full[nPB] = arr
                AstSEx_SS[name] = full

        PixA_DIFF = mask(PixA_DIFF)

        if FITS_DIFF is not None:
            hdr, sci_hdr = diff_header(prep, FITS_REF, FITS_SCI, KerPolyOrder, BGPolyOrder,
                                       ConstPhotRatio)
            if ConvdSide == "SCI":
                # GAIN_DIFF = GAIN_SCI / fscal; SATUR_DIFF = SATUR_SCI * fscal
                # (reference remarks, sfft/EasySparsePacket.py:536-558)
                gain_sci = sci_hdr.get(GAIN_KEY)
                satur_sci = sci_hdr.get(SATUR_KEY)
                if gain_sci is not None:
                    hdr.set(GAIN_KEY, gain_sci / SFFT_FSCAL_MEAN, "MeLOn: SFFT")
                if satur_sci is not None:
                    hdr.set(SATUR_KEY, satur_sci * SFFT_FSCAL_MEAN, "MeLOn: SFFT")
            fits.write(FITS_DIFF, PixA_DIFF.T, hdr)

        if FITS_Solution is not None:
            from sfft_tpu_torch.api.customized import write_solution_fits

            write_solution_fits(FITS_Solution, Solution, cfg)

        return PixA_DIFF, SFFTPrepDict, Solution, SFFT_FSCAL_MEAN, SFFT_FSCAL_SIG

    @staticmethod
    def ESP(
        FITS_REF: str, FITS_SCI: str, FITS_DIFF: Optional[str] = None,
        FITS_Solution: Optional[str] = None, ForceConv: str = "AUTO",
        GKerHW: Optional[int] = None, KerHWRatio: float = 2.0,
        KerHWLimit: Tuple[int, int] = (2, 20), KerPolyOrder: int = 2,
        BGPolyOrder: int = 2, ConstPhotRatio: bool = True,
        MaskSatContam: bool = False, GAIN_KEY: str = "GAIN",
        SATUR_KEY: str = "ESATUR", BACK_TYPE: str = "MANUAL",
        BACK_VALUE: float = 0.0, BACK_SIZE: int = 64,
        BACK_FILTERSIZE: int = 3, DETECT_THRESH: float = 2.0,
        ANALYSIS_THRESH: float = 2.0, DETECT_MINAREA: int = 5,
        DETECT_MAXAREA: int = 0, DEBLEND_MINCONT: float = 0.005,
        BACKPHOTO_TYPE: str = "LOCAL", ONLY_FLAGS=[0], BoundarySIZE: int = 30,
        XY_PriorSelect=None, Hough_MINFR: float = 0.1,
        Hough_PeakClip: float = 0.7, BeltHW: float = 0.2,
        PointSource_MINELLIP: float = 0.3, MatchTol=None,
        MatchTolFactor: float = 3.0, COARSE_VAR_REJECTION: bool = True,
        CVREJ_MAGD_THRESH: float = 0.12, ELABO_VAR_REJECTION: bool = False,
        EVREJ_RATIO_THREH: float = 5.0, EVREJ_SAFE_MAGDEV: float = 0.04,
        StarExt_iter: int = 4, XY_PriorBan=None,
        PostAnomalyCheck: bool = False, PAC_RATIO_THRESH: float = 5.0,
        VERBOSE_LEVEL: int = 1, cfg_overrides: Optional[dict] = None,
        device=None, plain: bool = False,
    ):
        """Returns (difference, prep dictionary, solution, flux scaling mean,
        its spread) as numpy; the subtraction runs on `device` ('cuda' when
        None, or 'cpu'), with the plain twins when plain=True."""
        kw = dict(locals())
        prep = EasySparsePacket.ESP_Prep(**kw)
        return EasySparsePacket.ESP_Subtract(prep, **kw)
