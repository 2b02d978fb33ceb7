"""Spatial basis evaluation: polynomial and B-spline, separable 1D x 1D form
(the counterpart of sfft_tpu/core/basis.py).

Every supported basis function is separable, B_k(x, y) = u_{i_k}(cx) *
v_{j_k}(cy), so only the 1D value tables U (N0, F1d) and V (N1, F1d) are held
on the host; planes are formed by an outer product on the target device.

Coordinates are ScaledFortranCoor: cx = (row + 1) / N0, cy = (col + 1) / N1
(reference: sfft/sfftcore/SFFTSubtract.py:545-560).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from sfft_tpu_torch.config import BasisSpec
from sfft_tpu_torch.core.indices import ref_basis_exponents


def scaled_coords_1d(N: int, dtype=np.float64) -> np.ndarray:
    """cx = (idx + 1) / N for idx in [0, N)."""
    return ((np.arange(N, dtype=np.float64) + 1.0) / N).astype(dtype)


@lru_cache(maxsize=64)
def basis_1d_tables(spec: BasisSpec, N0: int, N1: int) -> Tuple[np.ndarray, np.ndarray]:
    """1D basis value tables (U: (N0, F0), V: (N1, F1)) on the host.

    polynomial: U[:, i] = cx^i for i in 0..degree. bspline: clamped B-spline
    basis values with knot vector ([0.5]*(k+1) + int_knots + [N+0.5]*(k+1)) / N
    evaluated at cx (reference: sfft/BSplineSFFT.py:2624-2645).
    """
    cx = scaled_coords_1d(N0)
    cy = scaled_coords_1d(N1)
    if spec.kind == "polynomial":
        d = spec.degree
        U = np.stack([cx**i for i in range(d + 1)], axis=1)
        V = np.stack([cy**j for j in range(d + 1)], axis=1)
        return U, V
    if spec.kind == "bspline":
        U = _bspline_basis_values(cx, spec.int_knots_x, spec.degree, N0)
        V = _bspline_basis_values(cy, spec.int_knots_y, spec.degree, N1)
        return U, V
    raise ValueError(spec.kind)


def _bspline_basis_values(
    c: np.ndarray, int_knots: Tuple[float, ...], degree: int, N: int
) -> np.ndarray:
    """Values of all clamped B-spline basis functions at scaled coords c."""
    from scipy.interpolate import BSpline

    k = degree
    knots = np.concatenate(
        [np.full(k + 1, 0.5), np.asarray(int_knots, dtype=np.float64), np.full(k + 1, N + 0.5)]
    ) / float(N)
    nfun = len(knots) - k - 1
    out = np.zeros((len(c), nfun), dtype=np.float64)
    for m in range(nfun):
        coef = np.zeros(nfun)
        coef[m] = 1.0
        out[:, m] = BSpline(knots, coef, k, extrapolate=False)(c)
    return np.nan_to_num(out, nan=0.0)


def basis_planes(spec: BasisSpec, N0: int, N1: int, dtype=torch.float64,
                 device=None, rows=None) -> torch.Tensor:
    """(F, N0, N1) basis plane stack via 1D outer products, on `device`;
    rows = (r0, r1) gives the image rows [r0, r1) only, and an integer
    array of row indices those rows in its order (a row block with its halo
    rows, wrapped mod N0)."""
    U, V = basis_1d_tables(spec, N0, N1)
    exps = ref_basis_exponents(spec)
    if isinstance(rows, tuple):
        U = U[rows[0]:rows[1]]
    elif rows is not None:
        U = U[np.asarray(rows)]
    Ut = torch.as_tensor(U[:, exps[:, 0]], dtype=dtype, device=device)  # (N0, F)
    Vt = torch.as_tensor(V[:, exps[:, 1]], dtype=dtype, device=device)  # (N1, F)
    return Ut.T[:, :, None] * Vt.T[:, None, :]


def basis_at_points(spec: BasisSpec, N0: int, N1: int, sx: np.ndarray, sy: np.ndarray) -> np.ndarray:
    """Host-side basis values (F, Nq) at ScaledFortranCoor query points (for
    the regularization Gram matrices and kernel / flux-scaling realization;
    reference Realize_MatchingKernel, sfft/utils/SFFTSolutionReader.py:116-151)."""
    exps = ref_basis_exponents(spec)
    if spec.kind == "polynomial":
        return np.stack([sx ** i * sy ** j for (i, j) in exps], axis=0)
    if spec.kind == "bspline":
        Uq = _bspline_basis_values(np.asarray(sx, np.float64), spec.int_knots_x, spec.degree, N0)
        Vq = _bspline_basis_values(np.asarray(sy, np.float64), spec.int_knots_y, spec.degree, N1)
        return np.stack([Uq[:, i] * Vq[:, j] for (i, j) in exps], axis=0)
    raise ValueError(spec.kind)
