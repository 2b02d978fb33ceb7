"""Easy crowded packet: automatic crowded-field subtraction
(counterpart of sfft_tpu/api/easy_crowded.py).

Reference: Easy_CrowdedPacket.ECP (sfft/EasyCrowdedPacket.py:14-397): same
skeleton as the sparse packet with Auto_CrowdedPrep preprocessing (saturation
masking + super-background fill), BGPolyOrder=2 default (images NOT
sky-subtracted), no Hough classification and no Post-Anomaly Check.

``ECP_Prep`` is numpy on the host; ``ECP_Subtract`` runs GeneralSFFT.GSS on
`device` (the CUDA card when None, or 'cpu'), or on the plain twins with
plain=True, as the sparse packet does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from sfft_tpu_torch.api.easy_sparse import assemble_inputs, diff_header, solve_and_mask
from sfft_tpu_torch.io import fits
from sfft_tpu_torch.post.solution import RealizeFluxScaling
from sfft_tpu_torch.prep.crowded_prep import AutoCrowdedPrep


class EasyCrowdedPacket:
    @staticmethod
    def ECP_Prep(
        FITS_REF: str, FITS_SCI: str, ForceConv: str = "AUTO",
        GKerHW: Optional[int] = None, KerHWRatio: float = 2.0,
        KerHWLimit: Tuple[int, int] = (2, 20), KerPolyOrder: int = 2,
        BGPolyOrder: int = 2, ConstPhotRatio: bool = True,
        MaskSatContam: bool = False, GAIN_KEY: str = "GAIN",
        SATUR_KEY: str = "SATURATE", BACK_TYPE: str = "AUTO",
        BACK_VALUE: float = 0.0, BACK_SIZE: int = 64,
        BACK_FILTERSIZE: int = 3, DETECT_THRESH: float = 5.0,
        ANALYSIS_THRESH: float = 5.0, DETECT_MINAREA: int = 5,
        DETECT_MAXAREA: int = 0, DEBLEND_MINCONT: float = 0.005,
        BACKPHOTO_TYPE: str = "LOCAL", ONLY_FLAGS=None, BoundarySIZE: int = 0,
        BACK_SIZE_SUPER: int = 128, StarExt_iter: int = 2,
        PriorBanMask=None, VERBOSE_LEVEL: int = 1,
        cfg_overrides: Optional[dict] = None, **_ignored,
    ) -> dict:
        """Host preprocessing stage (Auto_CrowdedPrep + decisions + input
        assembly); see EasySparsePacket.ESP_Prep. Reference slice:
        MultiEasyCrowdedPacket preproc threads."""
        _ACP = AutoCrowdedPrep(
            FITS_REF=FITS_REF, FITS_SCI=FITS_SCI, GAIN_KEY=GAIN_KEY,
            SATUR_KEY=SATUR_KEY, BACK_TYPE=BACK_TYPE, BACK_VALUE=BACK_VALUE,
            BACK_SIZE=BACK_SIZE, BACK_FILTERSIZE=BACK_FILTERSIZE,
            DETECT_THRESH=DETECT_THRESH, ANALYSIS_THRESH=ANALYSIS_THRESH,
            DETECT_MINAREA=DETECT_MINAREA, DETECT_MAXAREA=DETECT_MAXAREA,
            DEBLEND_MINCONT=DEBLEND_MINCONT, BACKPHOTO_TYPE=BACKPHOTO_TYPE,
            ONLY_FLAGS=ONLY_FLAGS, BoundarySIZE=BoundarySIZE,
            VERBOSE_LEVEL=VERBOSE_LEVEL,
        )
        if VERBOSE_LEVEL in (0, 1, 2):
            print("MeLOn CheckPoint: TRIGGER Crowded-Flavor Auto Preprocessing!")
        SFFTPrepDict = _ACP.AutoMask(
            BACK_SIZE_SUPER=BACK_SIZE_SUPER, StarExt_iter=StarExt_iter,
            PriorBanMask=PriorBanMask,
        )
        return assemble_inputs(SFFTPrepDict, ForceConv, GKerHW, KerHWRatio, KerHWLimit,
                               KerPolyOrder, BGPolyOrder, ConstPhotRatio, MaskSatContam,
                               cfg_overrides)

    @staticmethod
    def ECP_Subtract(
        prep: dict, FITS_REF: str, FITS_SCI: str,
        FITS_DIFF: Optional[str] = None, FITS_Solution: Optional[str] = None,
        KerPolyOrder: int = 2, BGPolyOrder: int = 2,
        ConstPhotRatio: bool = True, MaskSatContam: bool = False,
        VERBOSE_LEVEL: int = 1, precomputed=None, device=None, plain: bool = False,
        **_ignored,
    ):
        """Device stage: solve+subtract on `device`, then the host
        post-processing and FITS output. `precomputed=(Solution, PixA_DIFF)`
        (tensors) skips the solve."""
        SFFTPrepDict = prep["SFFTPrepDict"]
        cfg = prep["cfg"]
        Solution, PixA_DIFF, mask = solve_and_mask(prep, MaskSatContam, VERBOSE_LEVEL,
                                                   precomputed, plain, device)

        N0, N1 = cfg.N0, cfg.N1
        XY_q = np.array([[N0 / 2.0, N1 / 2.0]]) + 0.5
        fs = RealizeFluxScaling(XY_q).from_solution(Solution, cfg)
        SFFT_FSCAL_MEAN = float(fs[0])

        PixA_DIFF = mask(PixA_DIFF)

        if FITS_DIFF is not None:
            hdr, _ = diff_header(prep, FITS_REF, FITS_SCI, KerPolyOrder, BGPolyOrder,
                                 ConstPhotRatio)
            fits.write(FITS_DIFF, PixA_DIFF.T, hdr)

        if FITS_Solution is not None:
            from sfft_tpu_torch.api.customized import write_solution_fits

            write_solution_fits(FITS_Solution, Solution, cfg)

        return PixA_DIFF, SFFTPrepDict, Solution, SFFT_FSCAL_MEAN

    @staticmethod
    def ECP(
        FITS_REF: str, FITS_SCI: str, FITS_DIFF: Optional[str] = None,
        FITS_Solution: Optional[str] = None, ForceConv: str = "AUTO",
        GKerHW: Optional[int] = None, KerHWRatio: float = 2.0,
        KerHWLimit: Tuple[int, int] = (2, 20), KerPolyOrder: int = 2,
        BGPolyOrder: int = 2, ConstPhotRatio: bool = True,
        MaskSatContam: bool = False, GAIN_KEY: str = "GAIN",
        SATUR_KEY: str = "SATURATE", BACK_TYPE: str = "AUTO",
        BACK_VALUE: float = 0.0, BACK_SIZE: int = 64,
        BACK_FILTERSIZE: int = 3, DETECT_THRESH: float = 5.0,
        ANALYSIS_THRESH: float = 5.0, DETECT_MINAREA: int = 5,
        DETECT_MAXAREA: int = 0, DEBLEND_MINCONT: float = 0.005,
        BACKPHOTO_TYPE: str = "LOCAL", ONLY_FLAGS=None, BoundarySIZE: int = 0,
        BACK_SIZE_SUPER: int = 128, StarExt_iter: int = 2,
        PriorBanMask=None, VERBOSE_LEVEL: int = 1,
        cfg_overrides: Optional[dict] = None, device=None, plain: bool = False,
    ):
        """Returns (difference, prep dictionary, solution, flux scaling) as
        numpy; the subtraction runs on `device` ('cuda' when None, or
        'cpu'), with the plain twins when plain=True."""
        kw = dict(locals())
        prep = EasyCrowdedPacket.ECP_Prep(**kw)
        return EasyCrowdedPacket.ECP_Subtract(prep, **kw)
