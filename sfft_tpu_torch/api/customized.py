"""Customized packet: user-provided masked image pair, FITS or array I/O
(counterpart of sfft_tpu/api/customized.py).

Reference: Customized_Packet.CP (sfft/CustomizedPacket.py:12-223) and the
zero-copy PureCupy_Customized_Packet.PCCP (sfft/PureCupyCustomizedPacket.py:
39-187). The array-level entry point (PureTorchCustomizedPacket) takes
tensors on any device (or numpy arrays, placed on `device`, which defaults
to the CUDA card) and returns tensors there.

Conventions preserved from the reference:
  * Images are read as fits.getdata(...).T so axis0 = X = NAXIS1.
  * ForceConv='REF': DIFF = SCI - Conv(REF); ForceConv='SCI': the roles swap
    and the returned DIFF is negated, so transients on SCI stay positive.
  * NaN union of REF/SCI is patched with the masked images for the solve and
    re-masked to NaN in the output.
"""

from __future__ import annotations

import os.path as pa
from typing import Optional, Tuple

import numpy as np
import torch

from sfft_tpu_torch.config import SFFTConfig, make_config
from sfft_tpu_torch.core.engine import GeneralSFFT, _as_tensor
from sfft_tpu_torch.io import fits


class PureTorchCustomizedPacket:
    """Array-in/array-out customized subtraction (PureCupy packet analog)."""

    @staticmethod
    def PCP(
        PixA_REF,
        PixA_SCI,
        PixA_mREF,
        PixA_mSCI,
        ForceConv: str,
        GKerHW: int,
        KerPolyOrder: int = 2,
        BGPolyOrder: int = 2,
        ConstPhotRatio: bool = True,
        cfg: Optional[SFFTConfig] = None,
        device=None,
        plain: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (solution, difference) as tensors on the device of
        PixA_REF, or on `device` when it is given (numpy input without a
        device runs on the CUDA card; without one it raises)."""
        if ForceConv not in ("REF", "SCI"):
            raise ValueError(f"ForceConv must be 'REF' or 'SCI', got {ForceConv!r}")
        # masked == unmasked (the same objects): the NaN patch below is then
        # the identity on the masked images, so the solve and the difference
        # take the same tensors and the pexact backends share one pass of
        # plane spectra between them
        same = PixA_mREF is PixA_REF and PixA_mSCI is PixA_SCI
        PixA_REF = _as_tensor(PixA_REF, device)
        dev = PixA_REF.device
        PixA_SCI = _as_tensor(PixA_SCI, dev)
        PixA_mREF = PixA_REF if same else _as_tensor(PixA_mREF, dev)
        PixA_mSCI = PixA_SCI if same else _as_tensor(PixA_mSCI, dev)

        if cfg is None:
            cfg = make_config(
                NX=PixA_REF.shape[0],
                NY=PixA_REF.shape[1],
                KerHW=GKerHW,
                KerPolyOrder=KerPolyOrder,
                BGPolyOrder=BGPolyOrder,
                ConstPhotRatio=ConstPhotRatio,
            )

        nan_u = torch.isnan(PixA_REF) | torch.isnan(PixA_SCI)

        if ForceConv == "REF":
            mI, mJ = PixA_mREF, PixA_mSCI
            I = torch.where(nan_u, mI, PixA_REF)
            J = torch.where(nan_u, mJ, PixA_SCI)
        else:
            mI, mJ = PixA_mSCI, PixA_mREF
            I = torch.where(nan_u, mI, PixA_SCI)
            J = torch.where(nan_u, mJ, PixA_REF)
        if same:
            mI, mJ = I, J

        solution, diff, _ = GeneralSFFT.GSS(I, J, mI, mJ, cfg, plain=plain)
        diff = torch.where(nan_u, torch.full_like(diff, float("nan")), diff)
        if ForceConv == "SCI":
            diff = -diff
        return solution, diff


class CustomizedPacket:
    """FITS-level customized subtraction (reference Customized_Packet.CP)."""

    @staticmethod
    def CP(
        FITS_REF: str,
        FITS_SCI: str,
        FITS_mREF: str,
        FITS_mSCI: str,
        ForceConv: str,
        GKerHW: int,
        FITS_DIFF: Optional[str] = None,
        FITS_Solution: Optional[str] = None,
        KerPolyOrder: int = 2,
        BGPolyOrder: int = 2,
        ConstPhotRatio: bool = True,
        cfg: Optional[SFFTConfig] = None,
        VERBOSE_LEVEL: int = 1,
        device=None,
    ):
        """Returns (solution, difference) as numpy arrays; the solve runs on
        `device` ('cuda' when None, or 'cpu')."""
        PixA_REF = fits.getdata(FITS_REF).T.astype(np.float64)
        PixA_SCI = fits.getdata(FITS_SCI).T.astype(np.float64)
        PixA_mREF = fits.getdata(FITS_mREF).T.astype(np.float64)
        PixA_mSCI = fits.getdata(FITS_mSCI).T.astype(np.float64)

        if np.isnan(PixA_mREF).any() or np.isnan(PixA_mSCI).any():
            raise ValueError("the masked images must hold no NaN")

        if cfg is None:
            cfg = make_config(
                NX=PixA_REF.shape[0],
                NY=PixA_REF.shape[1],
                KerHW=GKerHW,
                KerPolyOrder=KerPolyOrder,
                BGPolyOrder=BGPolyOrder,
                ConstPhotRatio=ConstPhotRatio,
            )

        solution, diff = PureTorchCustomizedPacket.PCP(
            PixA_REF, PixA_SCI, PixA_mREF, PixA_mSCI, ForceConv, GKerHW, cfg=cfg,
            device=device,
        )
        solution = solution.cpu().numpy()
        PixA_DIFF = diff.cpu().numpy()

        if FITS_DIFF is not None:
            _, sci_hdr = fits.read(FITS_SCI)
            hdr = fits.Header()
            for key, value, comment in sci_hdr.cards:
                hdr.add(key, value, comment)
            hdr.add("NAME_REF", pa.basename(FITS_REF), "MeLOn: SFFT")
            hdr.add("NAME_SCI", pa.basename(FITS_SCI), "MeLOn: SFFT")
            hdr.add("KERORDER", KerPolyOrder, "MeLOn: SFFT")
            hdr.add("BGORDER", BGPolyOrder, "MeLOn: SFFT")
            hdr.add("CPHOTR", str(ConstPhotRatio), "MeLOn: SFFT")
            hdr.add("KERHW", GKerHW, "MeLOn: SFFT")
            hdr.add("CONVD", ForceConv, "MeLOn: SFFT")
            fits.write(FITS_DIFF, PixA_DIFF.T, hdr)

        if FITS_Solution is not None:
            write_solution_fits(FITS_Solution, solution, cfg)

        return solution, PixA_DIFF


def write_solution_fits(path: str, solution, cfg: SFFTConfig):
    """Solution FITS with the reference's header keys
    (sfft/CustomizedPacket.py:205-221): readers can reconstruct kernels and
    backgrounds anywhere from this file alone."""
    if isinstance(solution, torch.Tensor):
        solution = solution.cpu().numpy()
    hdr = fits.Header()
    hdr.add("N0", cfg.N0, "MeLOn: SFFT")
    hdr.add("N1", cfg.N1, "MeLOn: SFFT")
    if cfg.kernel_basis.kind == "polynomial":
        hdr.add("DK", cfg.kernel_basis.degree, "MeLOn: SFFT")
    if cfg.bg_basis.kind == "polynomial":
        hdr.add("DB", cfg.bg_basis.degree, "MeLOn: SFFT")
    hdr.add("L0", cfg.L0, "MeLOn: SFFT")
    hdr.add("L1", cfg.L1, "MeLOn: SFFT")
    hdr.add("FIJ", cfg.Fij, "MeLOn: SFFT")
    hdr.add("FAB", cfg.Fab, "MeLOn: SFFT")
    hdr.add("FPQ", cfg.Fpq, "MeLOn: SFFT")
    hdr.add("FIJAB", cfg.Fijab, "MeLOn: SFFT")
    fits.write(path, np.asarray(solution, np.float64).reshape(1, -1), hdr)
