"""Tikhonov kernel regularization of the v2 engine (counterpart of
sfft_tpu/core/regularize.py).

Reference: sfft/BSplineSFFT.py:2010-2168 and 3570-3700. Penalizes the
squared discrete Laplacian of the *standard-basis* matching kernel, averaged
over a static set of regularization sample points:

  penalty = lambda * SCALE^2 * sum_q w_q || LAP @ Kstd(x_q) ||^2

LAPMAT is the 4-neighbor graph Laplacian on the (L0, L1) kernel raster
(diagonal = neighbor count, off-diagonal = -1), optionally with the rows
touching the kernel center zeroed (IGNORE_LAPLACIAN_KERCENT). Since the solver
works in the delta basis, L^T L is conjugated by the delta<->standard change of
basis, which produces the reference's iREGMAT center-correction formula. The
spatial average over sample points gives small Gram matrices of the kernel
(and scaling) bases — SSTMAT / CSSTMAT / DSSTMAT — and

  REGMAT[k*Fab+c, k8*Fab+c8] = SCALE^2 * M_case[k, k8] * iREGMAT[c, c8]

with M_case selected by whether c / c8 is the center offset (SEPARATE-VARYING
mixes the kernel and scaling Gram matrices there). Everything is static per
config and built in numpy on the host; the assembly streams the Kronecker
factors into its OMG row chunks (core/assemble.py, reg_terms).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from sfft_tpu_torch.config import SFFTConfig
from sfft_tpu_torch.core.basis import basis_at_points


@lru_cache(maxsize=32)
def _iregmat(cfg: SFFTConfig) -> np.ndarray:
    """L^T L conjugated into the delta basis (reference fill_lapmat_nondiagonal
    + fill_iregmat, sfft/BSplineSFFT.py:2010-2088)."""
    L0, L1, w0, w1 = cfg.L0, cfg.L1, cfg.w0, cfg.w1
    Fab = cfg.Fab
    RR, CC = np.mgrid[0:L0, 0:L1]
    rr, ccs = RR.ravel(), CC.ravel()

    lap = np.zeros((Fab, Fab), dtype=np.int64)
    nbr = (
        (rr[:, None] == rr[None, :] - 1) & (ccs[:, None] == ccs[None, :])
        | (rr[:, None] == rr[None, :] + 1) & (ccs[:, None] == ccs[None, :])
        | (rr[:, None] == rr[None, :]) & (ccs[:, None] == ccs[None, :] - 1)
        | (rr[:, None] == rr[None, :]) & (ccs[:, None] == ccs[None, :] + 1)
    )
    lap[nbr] = -1
    deg = nbr.sum(axis=1)
    np.fill_diagonal(lap, deg)

    if cfg.ignore_laplacian_kercent:
        for idx in [
            (w0 - 1) * L1 + w1,
            w0 * L1 + w1 - 1,
            w0 * L1 + w1,
            w0 * L1 + w1 + 1,
            (w0 + 1) * L1 + w1,
        ]:
            lap[idx, :] = 0

    ltl = lap.T @ lap
    c0 = cfg.center_ab
    ireg = np.zeros((Fab, Fab), dtype=np.int64)
    for r in range(Fab):
        for c in range(Fab):
            if r != c0 and c != c0:
                ireg[r, c] = (ltl[r, c] + ltl[c, r] - ltl[c0, r] - ltl[c0, c]
                              - ltl[r, c0] - ltl[c, c0] + 2 * ltl[c0, c0])
            elif r != c0 and c == c0:
                ireg[r, c] = ltl[r, c0] + ltl[c0, r] - 2 * ltl[c0, c0]
            elif r == c0 and c != c0:
                ireg[r, c] = ltl[c, c0] + ltl[c0, c] - 2 * ltl[c0, c0]
            else:
                ireg[r, c] = 2 * ltl[c0, c0]
    return ireg.astype(np.float64)


@lru_cache(maxsize=32)
def _gram_mats(cfg: SFFTConfig):
    """SSTMAT / CSSTMAT / DSSTMAT: weighted Gram matrices of the spatial bases
    at the regularization points (reference sfft/BSplineSFFT.py:3572-3643)."""
    xy = np.asarray(cfg.reg_xy, dtype=np.float64)
    sx = xy[:, 0] / cfg.N0
    sy = xy[:, 1] / cfg.N1
    SP = basis_at_points(cfg.kernel_basis, cfg.N0, cfg.N1, sx, sy)  # (Fij, NREG)
    if cfg.reg_weights is None:
        W = np.full(xy.shape[0], 1.0 / xy.shape[0])
    else:
        W = np.asarray(cfg.reg_weights, dtype=np.float64)
        W = W / W.sum()
    SST = (SP * W) @ SP.T
    CSST = DSST = None
    if cfg.scaling_mode == "SEPARATE-VARYING":
        ScaSP = basis_at_points(cfg.scaling_basis, cfg.N0, cfg.N1, sx, sy)
        if ScaSP.shape[0] < cfg.Fij:  # zero-padded placeholder dofs
            ScaSP = np.concatenate(
                [ScaSP, np.zeros((cfg.Fij - ScaSP.shape[0], len(sx)))], axis=0
            )
        CSST = (SP * W) @ ScaSP.T
        DSST = (ScaSP * W) @ ScaSP.T
    return SST, CSST, DSST


def regularization_terms(cfg: SFFTConfig):
    """lambda * REGMAT as a list of static Kronecker factors [(M, R)] with
    REGMAT[k*Fab+c, K*Fab+C] = sum_terms M[k, K] * R[c, C] — one term for
    ENTANGLED/SEPARATE-CONSTANT, four (the center-offset case split) for
    SEPARATE-VARYING. Never materializes the (Fijab, Fijab) block: the
    assembly streams it into the OMG row chunks (assemble_system reg_terms),
    so no (Fijab, Fijab) temporary exists beside the system at 13k dof.
    Returns None when regularization is off."""
    if cfg.regularize_lambda == 0.0 or not cfg.reg_xy:
        return None
    ireg = _iregmat(cfg)
    SST, CSST, DSST = _gram_mats(cfg)
    lam = cfg.regularize_lambda * cfg.SCALE**2
    if cfg.scaling_mode != "SEPARATE-VARYING":
        return [(lam * SST, ireg)]
    nc = np.ones(cfg.Fab)
    nc[cfg.center_ab] = 0.0
    return [
        (lam * SST, ireg * np.outer(nc, nc)),
        (lam * CSST, ireg * np.outer(nc, 1 - nc)),
        (lam * CSST.T, ireg * np.outer(1 - nc, nc)),
        (lam * DSST, ireg * np.outer(1 - nc, 1 - nc)),
    ]


@lru_cache(maxsize=8)
def regularization_terms_on(cfg: SFFTConfig, device: torch.device, dtype: torch.dtype):
    """``regularization_terms`` as tensors on `device`, built and uploaded
    once per config (a step uploads nothing); None when regularization is
    off."""
    terms = regularization_terms(cfg)
    if terms is None:
        return None
    return [tuple(torch.tensor(x, dtype=dtype, device=device) for x in MR) for MR in terms]


def apply_regularization(cfg: SFFTConfig, lhs: torch.Tensor) -> torch.Tensor:
    """LHMAT + lambda * REGMAT (kernel block only) — the standalone dense form
    for callers that assembled without reg_terms. Returns a new tensor."""
    terms = regularization_terms(cfg)
    if terms is None:
        return lhs
    dt, dev = lhs.dtype, lhs.device
    Fijab = cfg.Fijab
    add = None
    for M, R in terms:
        t = (torch.as_tensor(M, dtype=dt, device=dev)[:, None, :, None]
             * torch.as_tensor(R, dtype=dt, device=dev)[None, :, None, :])
        add = t if add is None else add + t
    out = lhs.clone()
    out[:Fijab, :Fijab] += add.reshape(Fijab, Fijab)
    return out
