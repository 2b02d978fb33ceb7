"""Dense solve of the SFFT normal equations (counterpart of
sfft_tpu/core/solve.py).

Reference: stripe removal + LU (sfft/sfftcore/SFFTConfigure.py:690-732,
sfft/sfftcore/SFFTSubtract.py:732-757). The ConstPhotRatio "forbidden stripes"
are removed by a static gather and the solution re-extended by a static
scatter.

Ported solvers:
  'lu'           torch.linalg.solve (LAPACK on CPU, cuSOLVER on CUDA) in the
                 system's dtype
  'cho'          Cholesky (the system is a Gram matrix)
  'refined'      equilibrated float32 LU + float64-residual refinement (the
                 fast mode's solver)
  'transformed'  the contract mode's solve on the TPU: static Legendre
                 congruence, f32 Cholesky + f64-residual refinement, and a
                 certified fallback to 'exact'
  'exact'        equilibrated f64 Cholesky + exact-residual refinement,
                 as sfft_tpu runs it on a CPU or GPU; a Tikhonov-regularized
                 system of NEQ >= 8192 (the 13k-dof B-spline configs) takes
                 _refined_solve_f64 instead: an f32 Cholesky factor refined
                 with exact-grade residuals from the int8-sliced system
                 (the K5 slicer, core/slicing.py)
  'host'         an f64 LAPACK LU on the host (numpy's, as sfft_tpu's
                 _host_solve calls it): the system goes to the CPU and the
                 solution comes back to the system's device
  'blocked_cho'  sfft_tpu's blocked Cholesky builds an f64 factor from
                 matmuls, the one f64 primitive that is fast on a TPU;
                 here it is the f64 Cholesky factor-and-solve of 'cho'
                 (cuSOLVER on the card, LAPACK on the CPU)
"""

from __future__ import annotations

import numpy as np
import torch

from sfft_tpu_torch.config import SFFTConfig
from sfft_tpu_torch.core.indices import kernel_sum_dof_index, stripe_indices
from sfft_tpu_torch.core.slicing import (slice_rows_f64, slice_rows_f64_plain, slice_vec_f64,
                                          slice_vec_f64_plain)
from sfft_tpu_torch.core.slicing import split3 as _split3
from sfft_tpu_torch.core.statics import Static, index, table

# solver 'exact' sends regularized f64 systems of at least this size to
# _refined_solve_f64 (sfft_tpu's gate)
LARGE_NEQ = 8192


def _host_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """solver='host' (sfft_tpu/core/solve.py:30): numpy's LAPACK LU on
    the host, in the system's dtype; the solution goes back to A's
    device."""
    a = A.cpu().numpy()
    x = np.linalg.solve(a, b.cpu().numpy()).astype(a.dtype)
    return torch.as_tensor(x, device=A.device)


def _refined_solve(A: torch.Tensor, b: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Equilibrated float32 LU + float64-residual iterative refinement.

    Jacobi equilibration tames the wildly different column scales of the SFFT
    system (polynomial coordinate powers); each refinement step then recovers
    digits until the f64 residual floor, when cond(D A D) * eps32 << 1."""
    d = _equilibrate(A)
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


def _equilibrate(A: torch.Tensor):
    """Jacobi scaling d = 1/sqrt|diag A| (tiny-guarded)."""
    return 1.0 / torch.sqrt(torch.abs(torch.diagonal(A)) + torch.finfo(A.dtype).tiny)


def _refine(matvec, bs: torch.Tensor, solve, iters: int):
    """x = solve(bs) and up to `iters` residual corrections with
    r = bs - matvec(x), stopping once the residual is below 1e-15 of |bs| (a
    host check, as sfft_tpu's while_loop condition). Returns
    (x, |bs|, steps taken, last residual norm)."""
    x = solve(bs)
    bnorm = float(torch.linalg.norm(bs))
    rn = bnorm
    steps = 0
    for _ in range(iters):
        if not rn > 1e-15 * bnorm:
            break
        r = bs - matvec(x)
        x = x + solve(r)
        rn = float(torch.linalg.norm(r))
        steps += 1
    return x, bnorm, steps, rn


def _exact_solve(A: torch.Tensor, b: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """f64-contract solve: Jacobi equilibration, f64 Cholesky (LAPACK on the
    CPU, cuSOLVER on CUDA) and exact-residual refinement. The iteration
    matrix has spectral radius ~cond * eps64, so two refinements reach the
    f64 floor. sfft_tpu factorises in blocks of its own (its TPU has no f64
    library Cholesky); one library call reaches the same f64 floor here."""
    d = _equilibrate(A)
    As = A * d[:, None] * d[None, :]
    bs = b * d
    L = torch.linalg.cholesky(As)

    def solve_cho(r):
        return torch.cholesky_solve(r[:, None], L)[:, 0]

    x = _refine(As.matmul, bs, solve_cho, iters)[0]
    return x * d


_RESID_NSL = 12   # 72-bit capture: below eps64 against the row scale
_RESID_KMAX = 11


def _sliced_residual_setup(A: torch.Tensor, d: torch.Tensor, nsl: int = _RESID_NSL,
                           plain: bool = False):
    """One-time int8 slicing of the equilibrated system d A d for
    exact-grade refinement residuals. Returns (Ah, Asl_flat, sa): Ah is the
    f32 hi part (it IS the f32 rounding of the equilibrated matrix, and goes
    straight to the f32 Cholesky), and Asl_flat (nsl * n, np) int8 with the
    per-row power-of-two scales sa (n, 1) represents the matrix to ~2^-72 of
    each row's scale (exact three-way f32 split, 12 slices; an (hi, lo) pair
    would floor at 2^-48). Rows are slice-major, and the columns are
    zero-padded from n to np, a multiple of 8: the depth the int8 product of
    _sliced_matvec wants. On CUDA tensors the whole setup is one launch of K5
    (core/slicing.py slice_rows_f64: equilibration, split, row scales and
    slices in one pass over each row; no f64 copy of the equilibrated
    matrix), with plain=True or on CPU tensors its plain twin."""
    n = A.shape[0]
    fn = slice_rows_f64_plain if plain else slice_rows_f64
    Ah, Asl, sa = fn(A, d, nsl, n + (-n) % 8)
    return Ah, Asl.reshape(nsl * n, -1), sa


def _sliced_matvec(Asl_flat: torch.Tensor, sa: torch.Tensor, x: torch.Tensor,
                   nsl: int = _RESID_NSL, kmax: int = _RESID_KMAX,
                   plain: bool = False, X8: torch.Tensor = None) -> torch.Tensor:
    """Exact-grade f64 product of the sliced equilibrated matrix with a
    runtime f64 vector: the refinement residual's workhorse.

    The vector is split and sliced per call (K5's vector stage, one global
    scale) straight into rows 0..nsl-1 of the (64, np) int8 operand X8,
    whose other rows stay zero (a caller that passes X8 zeroes it once; by
    default a zeroed one is made here), and ONE int8 product (nsl * n, np) @
    (np, 64) computes every slice-pair product with exact int32
    accumulation (|prod| <= 2^12, depth n < 2^14, group sums < 2^30); the
    <= kmax + 1 weight groups recombine in f64 directly (the sums are exact
    integers and the output is only an (n,) vector, so an f64 weighted sum
    keeps eps64 grade where a compensated f32 pair would cap the result near
    2^-48). Representation floor ~2^-54 relative, the slicing grade of the
    contract's tables. torch._int_mm is the library's int8 product, as
    sfft_tpu leaves this one to XLA's dot_general."""
    n = x.shape[0]
    Kp = Asl_flat.shape[1]
    if X8 is None:
        X8 = torch.zeros((64, Kp), dtype=torch.int8, device=x.device)
    sx = (slice_vec_f64_plain if plain else slice_vec_f64)(x, nsl, X8)
    prod = torch._int_mm(Asl_flat, X8.t()).reshape(nsl, n, 64)     # slice-major rows
    out = torch.zeros((n,), dtype=x.dtype, device=x.device)
    for s in range(min(kmax, 2 * nsl - 2) + 1):
        g = None
        for i in range(max(0, s - nsl + 1), min(nsl - 1, s) + 1):
            t = prod[i, :, s - i]
            g = t if g is None else g + t
        out = out + g.to(x.dtype) * (2.0 ** (-6 * (s + 2)))
    return out * sa[:, 0].to(x.dtype) * sx.to(x.dtype)


def _refined_solve_f64(A: torch.Tensor, b: torch.Tensor, iters: int = 12,
                       plain: bool = False, _f64_matvec: bool = False,
                       info: dict = None) -> torch.Tensor:
    """f64-contract solve for LARGE (NEQ >= 8k) systems: f32 Cholesky factor
    + exact-grade-residual refinement to the f64 floor.

    Valid because the Tikhonov-regularized big B-spline systems are far
    better conditioned than the raw polynomial ones: cond(equilibrated)
    ~1e7 on sfft_tpu's NIRCam 13,226-dof system, so cond * eps32 < 1 and
    each refinement step contracts the error; the n^3 factorization stays
    f32 and only the ~n^2 residuals are exact. The loop takes at most
    `iters` steps and stops at |r| <= 1e-15 |b|.

    The equilibrated system rides as int8 slices plus its f32 hi part
    (_sliced_residual_setup, K5 on CUDA tensors, its plain twin on CPU
    tensors or with plain=True); every residual is one _sliced_matvec; the
    f32 factor is applied with the library's triangular solves
    (cholesky_solve). _f64_matvec=True is the independent cross-check that
    the tests and chip_smoke.py hold this route against: the f64
    equilibrated matrix is kept and every residual is an f64 matvec
    (sfft_tpu's route off the TPU). solve_system never sets it.

    Validity domain: the equilibrated system must be numerically positive
    definite IN f32; cond_eq alone does not decide this, the spectrum shape
    does. When the f32 factorization breaks down, the factor is poisoned
    with NaN and the returned solution is all-NaN: loudly visible, never a
    silent switch of solver. The gate in solve_system (NEQ >= 8192 needs
    Tikhonov regularization ON) keeps user systems in the valid class;
    raising regularize_lambda is the documented recovery.

    info: an optional dict that receives 'steps' (refinement steps taken),
    'rel_residual' (last |r| / |b|) and 'factor_ok'."""
    d = _equilibrate(A)
    bs = b * d
    if _f64_matvec:
        As = A * d[:, None] * d[None, :]
        Ah = As.to(torch.float32)
        matvec = As.matmul
    else:
        Ah, Asl_flat, sa = _sliced_residual_setup(A, d, plain=plain)
        # the residuals' int8 operand, zeroed once: each residual writes its
        # slice rows, the rest stay zero
        X8 = torch.zeros((64, Asl_flat.shape[1]), dtype=torch.int8, device=A.device)

        def matvec(x):
            return _sliced_matvec(Asl_flat, sa, x, plain=plain, X8=X8)

    L32, bad = torch.linalg.cholesky_ex(Ah)
    del Ah
    # a factor that broke down poisons the solution (no host check here)
    L32 = torch.where(bad == 0, L32, torch.full_like(L32[:1, :1], float("nan")))

    def f32_solve(r):
        return torch.cholesky_solve(r.to(torch.float32)[:, None], L32)[:, 0].to(b.dtype)

    x, bnorm, steps, rn = _refine(matvec, bs, f32_solve, iters)
    if info is not None:
        info.update(steps=steps, rel_residual=rn / bnorm, factor_ok=int(bad) == 0)
    return x * d


def _legendre_congruence(degree: int) -> np.ndarray:
    """Static change of basis C for the triangular 2-D monomial terms
    {x^i y^j : i+j <= degree} (the enumeration of indices.ref_basis_exponents)
    into tensor products of SHIFTED Legendre polynomials on [0, 1]. Column
    ij holds the monomial coefficients of the Legendre term; the coefficients
    are integers, so the congruence T' A T is backward-stable in f64. The
    Legendre basis takes a factor ~600 off cond(equilibrated) of the normal
    system (sfft_tpu's measurement on its 512^2 bench system)."""
    P1 = {
        0: [1],
        1: [-1, 2],
        2: [1, -6, 6],
        3: [-1, 12, -30, 20],
    }
    terms = [(i, j) for i in range(degree + 1) for j in range(degree + 1 - i)]
    F = len(terms)
    C = np.zeros((F, F))
    for col, (p, q) in enumerate(terms):
        cp, cq = P1[p], P1[q]
        for row, (r, s) in enumerate(terms):
            if r < len(cp) and s < len(cq):
                C[row, col] = cp[r] * cq[s]
    return C


def _transformed_solve(cfg: SFFTConfig, lhs: torch.Tensor, rhs: torch.Tensor,
                       iters: int = 10) -> torch.Tensor:
    """Contract-grade solve of the FULL (untweaked) polynomial ENTANGLED
    system: a static Legendre congruence x = S z (the ConstPhotRatio
    constraint kept exactly: removed dofs are diagonal-pinned), Jacobi
    equilibration, f32 Cholesky with an explicit f32 inverse factor, and
    f64-residual refinement. Certificate: if the final residual exceeds
    1e-12 of the right-hand side (or is NaN, or the f32 factorisation
    fails), the SAME transformed system goes to the unconditional
    _exact_solve. sfft_tpu takes the branch with lax.cond; here it is a host
    check. Returns the NEQ solution in the original basis."""
    Fij, Fab, Fijab, Fpq = cfg.Fij, cfg.Fab, cfg.Fijab, cfg.Fpq
    c = cfg.center_ab
    dev, dt = lhs.device, lhs.dtype
    if Fpq > 1 and cfg.bg_basis.kind == "polynomial":
        Cb = Static(_legendre_congruence, (cfg.bg_basis.degree,))
    else:
        Cb = Static(np.eye, (max(Fpq, 1),))
    removed = (kernel_sum_dof_index(cfg)[1:].astype(np.int64)
               if cfg.const_phot_ratio else np.zeros((0,), np.int64))
    Cj = table(Static(_legendre_congruence, (cfg.kernel_basis.degree,)), dev, dt)
    Cbj = table(Cb, dev, dt)

    def S_cols(M):
        # M (r, NEQ) -> M @ S
        r = M.shape[0]
        K = M[:, :Fijab].reshape(r, Fij, Fab)
        K2 = torch.einsum("ria,ij->rja", K, Cj)
        if removed.size:
            K2[:, 1:, c] = 0.0
            K2[:, 0, c] = K[:, 0, c]
        parts = [K2.reshape(r, Fijab)]
        if Fpq:
            parts.append(M[:, Fijab:] @ Cbj)
        return torch.cat(parts, dim=1)

    def S_vec(z):
        # x = S z (back to the original basis)
        Zk = z[:Fijab].reshape(Fij, Fab)
        X = torch.einsum("ja,ij->ia", Zk, Cj)
        if removed.size:
            X[1:, c] = 0.0
            X[0, c] = Zk[0, c]
        parts = [X.reshape(Fijab)]
        if Fpq:
            parts.append(Cbj @ z[Fijab:])
        return torch.cat(parts)

    At = S_cols(S_cols(lhs).T.contiguous())
    bt = S_cols(rhs[None, :])[0]
    if removed.size:
        rm = index(removed, dev)
        At[rm, rm] = 1.0
        bt[rm] = 0.0

    d = _equilibrate(At)
    As = At * d[:, None] * d[None, :]
    bs = bt * d
    L32, info = torch.linalg.cholesky_ex(As.to(torch.float32))
    if int(info) != 0:
        return S_vec(_exact_solve(At, bt))
    eye = torch.eye(L32.shape[0], dtype=torch.float32, device=dev)
    Li32 = torch.linalg.solve_triangular(L32, eye, upper=False)

    def f32_solve(r):
        return (Li32.T @ (Li32 @ r.to(torch.float32))).to(dt)

    x, bnorm = _refine(As.matmul, bs, f32_solve, iters)[:2]
    rn = float(torch.linalg.norm(bs - As @ x))
    ok = rn <= 1e-12 * bnorm                       # False on NaN
    return S_vec(x * d if ok else _exact_solve(At, bt))


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


def solve_system(cfg: SFFTConfig, lhs: torch.Tensor, rhs: torch.Tensor,
                 plain: bool = False) -> torch.Tensor:
    """Solve, honoring the scaling-mode system tweak. Returns the NEQ-length
    solution with removed dofs re-inserted (zeros, or the shared constant for
    aggregated B-spline scaling). plain=True keeps the large-system route of
    'exact' on the plain twin of the K5 slicer."""
    if cfg.solver == "transformed":
        # polynomial ENTANGLED f64 contract: the stripe removal is carried
        # exactly inside the transform (sfft_tpu forces this path on any
        # backend for solver='transformed', and takes it for 'exact' on the
        # TPU only)
        if (lhs.dtype == torch.float64 and cfg.scaling_mode == "ENTANGLED"
                and cfg.kernel_basis.kind == "polynomial"):
            return _transformed_solve(cfg, lhs, rhs)
        raise ValueError("solver='transformed' requires an f64 polynomial ENTANGLED config")
    if cfg.solver not in ("lu", "cho", "blocked_cho", "host", "refined", "exact"):
        raise ValueError(f"unknown solver {cfg.solver!r}")
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
    elif cfg.solver in ("cho", "blocked_cho"):
        L = torch.linalg.cholesky(A)
        x = torch.cholesky_solve(b[:, None], L)[:, 0]
    elif cfg.solver == "host":
        x = _host_solve(A, b)
    elif cfg.solver == "refined" or A.dtype == torch.float32:
        # an f32-assembled system cannot beat f32 residuals anyway
        x = _refined_solve(A, b)
    elif A.shape[0] >= LARGE_NEQ and cfg.regularize_lambda > 0 and cfg.reg_xy:
        # large f64 systems (the 13k-dof B-spline configs): f32 factor +
        # exact-grade-residual refinement. Gated on Tikhonov regularization
        # being ON: that keeps cond(equilibrated) where the f32-factor
        # iteration converges; an unregularized giant system takes the
        # unconditional f64 route below
        x = _refined_solve_f64(A, b, plain=plain)
    else:
        x = _exact_solve(A, b)

    if not reduced:
        return x
    sol = torch.zeros((cfg.NEQ,), dtype=x.dtype, device=dev)
    sol[torch.as_tensor(pres, dtype=torch.long, device=dev)] = x
    if aggregate:
        sol[torch.as_tensor(ij00[1:], dtype=torch.long, device=dev)] = x[int(ij00[0])]
    return sol
