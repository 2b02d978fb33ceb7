"""Dense solve of the SFFT normal equations (counterpart of
sfft_tpu/core/solve.py).

Reference: stripe removal + LU (sfft/sfftcore/SFFTConfigure.py:690-732,
sfft/sfftcore/SFFTSubtract.py:732-757). The ConstPhotRatio "forbidden stripes"
are removed by a static gather and the solution re-extended by a static
scatter.

Ported solvers:
  'lu'       torch.linalg.solve (LAPACK on CPU, cuSOLVER on CUDA) in the
             system's dtype
  'cho'      Cholesky (the system is a Gram matrix)
  'refined'  equilibrated float32 LU + float64-residual refinement (the fast
             mode's solver)
The TPU-precision solvers ('exact', 'transformed', 'blocked_cho', 'host')
raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from sfft_tpu_torch.config import SFFTConfig
from sfft_tpu_torch.core.indices import kernel_sum_dof_index, stripe_indices


def _refined_solve(A: torch.Tensor, b: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Equilibrated float32 LU + float64-residual iterative refinement.

    Jacobi equilibration tames the wildly different column scales of the SFFT
    system (polynomial coordinate powers); each refinement step then recovers
    digits until the f64 residual floor, when cond(D A D) * eps32 << 1."""
    d = 1.0 / torch.sqrt(torch.abs(torch.diagonal(A)) + torch.finfo(A.dtype).tiny)
    As = A * d[:, None] * d[None, :]
    bs = b * d
    A32 = As.to(torch.float32)
    if A.dtype == torch.float32:
        As = A32  # f32-assembled system: residuals can't beat f32 anyway
    if A.shape[0] >= 8192:
        # large systems: Cholesky of the (regularized) Gram matrix
        L32 = torch.linalg.cholesky(A32)

        def f32_solve(r):
            y = torch.linalg.solve_triangular(L32, r.to(torch.float32)[:, None], upper=False)
            return torch.linalg.solve_triangular(L32.T, y, upper=True)[:, 0].to(b.dtype)
    else:
        LU, piv = torch.linalg.lu_factor(A32)

        def f32_solve(r):
            return torch.linalg.lu_solve(LU, piv, r.to(torch.float32)[:, None])[:, 0].to(b.dtype)

    x = f32_solve(bs)
    for _ in range(iters):
        r = bs - As @ x
        x = x + f32_solve(r)
    return x * d


def _contig_segments(idx: np.ndarray):
    """Split a sorted index array into contiguous [start, stop) segments."""
    segs = []
    start = prev = int(idx[0])
    for v in idx[1:]:
        v = int(v)
        if v == prev + 1:
            prev = v
            continue
        segs.append((start, prev + 1))
        start = prev = v
    segs.append((start, prev + 1))
    return segs


def _select_rows_cols(M: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """M[ix_(idx, idx)] via contiguous slice concatenation (the tweak removes
    only a handful of dofs, so idx is a few contiguous runs)."""
    segs = _contig_segments(np.asarray(idx))
    rows = torch.cat([M[a:b, :] for a, b in segs], dim=0)
    return torch.cat([rows[:, a:b] for a, b in segs], dim=1)


def _tweak_plan(cfg: SFFTConfig):
    """Static tweak indices per scaling mode (reference TweakLS/Restore_Solution,
    sfft/BSplineSFFT.py:2170-2338).

    Returns (pres_idx, aggregate, ij00):
      pres_idx: LS indices kept in the tweaked system (None = no tweak)
      aggregate: True for the B-spline SEPARATE-CONSTANT case, where the key
        center dof becomes the SUM over all Fij center dofs.
    """
    ij00 = kernel_sum_dof_index(cfg)
    mode = cfg.scaling_mode
    if mode == "ENTANGLED":
        if not cfg.const_phot_ratio:
            return None, False, ij00
        pres = stripe_indices(cfg)
        return (None if len(pres) == cfg.NEQ else pres), False, ij00
    if mode == "SEPARATE-CONSTANT":
        pres = np.setdiff1d(np.arange(cfg.NEQ), ij00[1:]).astype(np.int32)
        return pres, cfg.kernel_basis.kind == "bspline", ij00
    # SEPARATE-VARYING
    if cfg.ScaFij == cfg.Fij:
        return None, False, ij00
    pres = np.setdiff1d(np.arange(cfg.NEQ), ij00[cfg.ScaFij :]).astype(np.int32)
    return pres, False, ij00


def solve_system(cfg: SFFTConfig, lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve, honoring the scaling-mode system tweak. Returns the NEQ-length
    solution with removed dofs re-inserted (zeros, or the shared constant for
    aggregated B-spline scaling)."""
    if cfg.solver not in ("lu", "cho", "refined"):
        raise NotImplementedError(
            f"solver {cfg.solver!r} is not ported to sfft_tpu_torch yet "
            "(ROADMAP queue 1, TPU-precision engines); use 'lu', 'cho' or 'refined'")
    dev = lhs.device
    pres, aggregate, ij00 = _tweak_plan(cfg)
    reduced = pres is not None
    if reduced:
        A = _select_rows_cols(lhs, pres)
        b = rhs[torch.as_tensor(pres, dtype=torch.long, device=dev)]
        if aggregate:
            key = int(ij00[0])  # pres_idx[key] == key (indices below unchanged)
            ij = torch.as_tensor(ij00, dtype=torch.long, device=dev)
            pr = torch.as_tensor(pres, dtype=torch.long, device=dev)
            A[key, :] = lhs[ij][:, pr].sum(dim=0)
            A[:, key] = lhs[pr][:, ij].sum(dim=1)
            A[key, key] = lhs[ij][:, ij].sum()
            b[key] = rhs[ij].sum()
    else:
        A, b = lhs, rhs

    if cfg.solver == "lu":
        x = torch.linalg.solve(A, b)
    elif cfg.solver == "cho":
        L = torch.linalg.cholesky(A)
        x = torch.cholesky_solve(b[:, None], L)[:, 0]
    else:
        x = _refined_solve(A, b)

    if not reduced:
        return x
    sol = torch.zeros((cfg.NEQ,), dtype=x.dtype, device=dev)
    sol[torch.as_tensor(pres, dtype=torch.long, device=dev)] = x
    if aggregate:
        sol[torch.as_tensor(ij00[1:], dtype=torch.long, device=dev)] = x[int(ij00[0])]
    return sol
