"""BSpline packet: the v2 engine's user-facing API (counterpart of
sfft_tpu/api/bspline.py).

Reference: BSpline_Packet.BSP (sfft/BSplineSFFT.py:3967-4356) — the customized
packet generalized with B-spline/polynomial spatial bases for kernel, scaling
and background, SEPARATE scaling modes, and Tikhonov kernel regularization —
plus BSpline_MatchingKernel (:4555-4723) for kernel realization from the
solution with the generalized bases. The solve runs on the CUDA card unless
the caller passes device="cpu"; the solution FITS is the one sfft_tpu writes
and reads.
"""

from __future__ import annotations

import os.path as pa
from typing import Optional, Sequence

import numpy as np
import torch

from sfft_tpu_torch.config import BasisSpec, SFFTConfig
from sfft_tpu_torch.core.basis import basis_at_points
from sfft_tpu_torch.core.engine import GeneralSFFT, _as_tensor
from sfft_tpu_torch.io import fits
from sfft_tpu_torch.post.solution import sfft2standard


def _basis_spec(kind: str, degree: int, knots_x, knots_y) -> BasisSpec:
    if kind == "Polynomial":
        return BasisSpec("polynomial", int(degree))
    if kind == "B-Spline":
        return BasisSpec(
            "bspline", int(degree),
            tuple(float(k) for k in knots_x), tuple(float(k) for k in knots_y),
        )
    raise ValueError(f"unknown spatial type {kind!r}")


def make_bspline_config(
    N0: int, N1: int, GKerHW: int = 8,
    KerSpType: str = "Polynomial", KerSpDegree: int = 2,
    KerIntKnotX: Sequence[float] = (), KerIntKnotY: Sequence[float] = (),
    SEPARATE_SCALING: bool = True, ScaSpType: str = "Polynomial",
    ScaSpDegree: int = 0, ScaIntKnotX: Sequence[float] = (),
    ScaIntKnotY: Sequence[float] = (),
    BkgSpType: str = "Polynomial", BkgSpDegree: int = 2,
    BkgIntKnotX: Sequence[float] = (), BkgIntKnotY: Sequence[float] = (),
    REGULARIZE_KERNEL: bool = False, IGNORE_LAPLACIAN_KERCENT: bool = True,
    XY_REGULARIZE: Optional[np.ndarray] = None,
    WEIGHT_REGULARIZE: Optional[np.ndarray] = None,
    LAMBDA_REGULARIZE: float = 1e-6,
    **engine_kwargs,
) -> SFFTConfig:
    """Reference-parameter-compatible v2 config constructor. engine_kwargs
    are SFFTConfig fields (greek_backend, fdiff_backend, solver, dtype, ...)."""
    kernel_basis = _basis_spec(KerSpType, KerSpDegree, KerIntKnotX, KerIntKnotY)
    bg_basis = _basis_spec(BkgSpType, BkgSpDegree, BkgIntKnotX, BkgIntKnotY)
    scaling_basis = None
    if SEPARATE_SCALING:
        scaling_basis = _basis_spec(ScaSpType, ScaSpDegree, ScaIntKnotX, ScaIntKnotY)
        if scaling_basis.num_funcs() > kernel_basis.num_funcs():
            raise ValueError(
                "scaling dof must not exceed kernel spatial dof "
                "(reference constraint, sfft/BSplineSFFT.py:214-220)"
            )
    reg_xy = ()
    reg_w = None
    lam = 0.0
    if REGULARIZE_KERNEL:
        if XY_REGULARIZE is None:
            raise ValueError("REGULARIZE_KERNEL needs XY_REGULARIZE sample points")
        reg_xy = tuple((float(x), float(y)) for x, y in np.asarray(XY_REGULARIZE))
        if WEIGHT_REGULARIZE is not None:
            reg_w = tuple(float(w) for w in np.asarray(WEIGHT_REGULARIZE))
        lam = float(LAMBDA_REGULARIZE)

    # unset backends resolve as sfft_tpu resolves them on a CPU or GPU: the
    # native f64 FFTs and LU. The contract trio of its TPU runs
    # (greek_backend="exact", fdiff_backend="exact", solver="exact": the
    # sliced-integer pair-FFT engine, which holds the f64 contract for every
    # spatial basis, and at NEQ >= 8192 with Tikhonov on the f32-factor
    # solve refined with exact-grade residuals) is passed explicitly
    defaults = dict(greek_backend="fft", fdiff_backend="fft", solver="lu")
    defaults.update(engine_kwargs)
    cfg = SFFTConfig(
        N0=int(N0), N1=int(N1), w0=int(GKerHW), w1=int(GKerHW),
        kernel_basis=kernel_basis, bg_basis=bg_basis,
        scaling_basis=scaling_basis, const_phot_ratio=False,
        regularize_lambda=lam, reg_xy=reg_xy, reg_weights=reg_w,
        ignore_laplacian_kercent=bool(IGNORE_LAPLACIAN_KERCENT),
        **defaults,
    )
    if (cfg.solver == "exact" and cfg.NEQ >= 8192
            and not (cfg.regularize_lambda > 0 and cfg.reg_xy)):
        import warnings

        warnings.warn(
            "MeLOn WARNING: solver='exact' on an UNREGULARIZED system with "
            f"NEQ={cfg.NEQ} >= 8192 takes the unconditional exact-f64 "
            "Cholesky route (slow at this size). Enable REGULARIZE_KERNEL "
            "(Tikhonov keeps the equilibrated system well-conditioned) to "
            "use the fast f32-factor + exact-f64-residual refinement.")
    return cfg


class BSplinePacket:
    @staticmethod
    def BSP(
        FITS_REF: str, FITS_SCI: str, FITS_mREF: str, FITS_mSCI: str,
        FITS_DIFF: Optional[str] = None, FITS_Solution: Optional[str] = None,
        ForceConv: str = "REF", GKerHW: int = 8,
        VERBOSE_LEVEL: int = 1, cfg: Optional[SFFTConfig] = None,
        device=None, plain: bool = False,
        **config_kwargs,
    ):
        """Returns (solution, difference) as numpy arrays; the solve runs on
        `device` ('cuda' when None, or 'cpu'). plain=True runs the plain
        twins of the hand kernels."""
        PixA_REF = fits.getdata(FITS_REF).T.astype(np.float64)
        PixA_SCI = fits.getdata(FITS_SCI).T.astype(np.float64)
        PixA_mREF = fits.getdata(FITS_mREF).T.astype(np.float64)
        PixA_mSCI = fits.getdata(FITS_mSCI).T.astype(np.float64)
        if ForceConv not in ("REF", "SCI"):
            raise ValueError(f"ForceConv must be 'REF' or 'SCI', got {ForceConv!r}")
        if np.isnan(PixA_mREF).any() or np.isnan(PixA_mSCI).any():
            raise ValueError("the masked images must hold no NaN")

        if cfg is None:
            cfg = make_bspline_config(
                PixA_REF.shape[0], PixA_REF.shape[1], GKerHW, **config_kwargs
            )

        nan_u = np.isnan(PixA_REF) | np.isnan(PixA_SCI)
        if ForceConv == "REF":
            mI, mJ = PixA_mREF, PixA_mSCI
            I = np.where(nan_u, mI, PixA_REF)
            J = np.where(nan_u, mJ, PixA_SCI)
        else:
            mI, mJ = PixA_mSCI, PixA_mREF
            I = np.where(nan_u, mI, PixA_SCI)
            J = np.where(nan_u, mJ, PixA_REF)

        I = _as_tensor(I, device)
        J = _as_tensor(J, I.device)
        if np.array_equal(PixA_mREF, PixA_REF) and np.array_equal(PixA_mSCI, PixA_SCI):
            # masked == unmasked: the solve and the difference take the same
            # tensors, so the exact backends share one pass of plane spectra
            mI, mJ = I, J
        else:
            mI, mJ = _as_tensor(mI, I.device), _as_tensor(mJ, I.device)
        solution, diff, _ = GeneralSFFT.GSS(I, J, mI, mJ, cfg, plain=plain)
        solution = solution.cpu().numpy()
        PixA_DIFF = diff.cpu().numpy()
        if nan_u.any():
            PixA_DIFF = np.where(nan_u, np.nan, PixA_DIFF)
        if ForceConv == "SCI":
            PixA_DIFF = -PixA_DIFF

        if FITS_DIFF is not None:
            _, sci_hdr = fits.read(FITS_SCI)
            hdr = fits.Header()
            for key, value, comment in sci_hdr.cards:
                hdr.add(key, value, comment)
            hdr.add("NAME_REF", pa.basename(FITS_REF), "MeLOn: SFFT")
            hdr.add("NAME_SCI", pa.basename(FITS_SCI), "MeLOn: SFFT")
            hdr.add("KERHW", cfg.w0, "MeLOn: SFFT")
            hdr.add("CONVD", ForceConv, "MeLOn: SFFT")
            fits.write(FITS_DIFF, PixA_DIFF.T, hdr)
        if FITS_Solution is not None:
            write_bspline_solution_fits(FITS_Solution, solution, cfg)
        return solution, PixA_DIFF


def write_bspline_solution_fits(path: str, solution, cfg: SFFTConfig):
    """Solution FITS with the v2 header set (basis specs + knots), so readers
    can reconstruct kernels anywhere (reference header writing implied by
    sfft/BSplineSFFT.py:4525-4551)."""
    if isinstance(solution, torch.Tensor):
        solution = solution.cpu().numpy()
    hdr = fits.Header()
    hdr.add("N0", cfg.N0, "MeLOn: SFFT")
    hdr.add("N1", cfg.N1, "MeLOn: SFFT")
    hdr.add("L0", cfg.L0, "MeLOn: SFFT")
    hdr.add("L1", cfg.L1, "MeLOn: SFFT")
    hdr.add("FIJ", cfg.Fij, "MeLOn: SFFT")
    hdr.add("FPQ", cfg.Fpq, "MeLOn: SFFT")
    hdr.add("KSPTYPE", cfg.kernel_basis.kind, "MeLOn: SFFT")
    hdr.add("KSPDEG", cfg.kernel_basis.degree, "MeLOn: SFFT")
    hdr.add("NKIKX", len(cfg.kernel_basis.int_knots_x), "MeLOn: SFFT")
    hdr.add("NKIKY", len(cfg.kernel_basis.int_knots_y), "MeLOn: SFFT")
    for n, k in enumerate(cfg.kernel_basis.int_knots_x):
        hdr.add(f"KIKX{n}", k, "MeLOn: SFFT")
    for n, k in enumerate(cfg.kernel_basis.int_knots_y):
        hdr.add(f"KIKY{n}", k, "MeLOn: SFFT")
    hdr.add("BSPTYPE", cfg.bg_basis.kind, "MeLOn: SFFT")
    hdr.add("BSPDEG", cfg.bg_basis.degree, "MeLOn: SFFT")
    hdr.add("NBIKX", len(cfg.bg_basis.int_knots_x), "MeLOn: SFFT")
    hdr.add("NBIKY", len(cfg.bg_basis.int_knots_y), "MeLOn: SFFT")
    for n, k in enumerate(cfg.bg_basis.int_knots_x):
        hdr.add(f"BIKX{n}", k, "MeLOn: SFFT")
    for n, k in enumerate(cfg.bg_basis.int_knots_y):
        hdr.add(f"BIKY{n}", k, "MeLOn: SFFT")
    hdr.add("CPHOTR", cfg.const_phot_ratio, "MeLOn: SFFT")
    hdr.add("SEPSCA", cfg.scaling_basis is not None, "MeLOn: SFFT")
    if cfg.scaling_basis is not None:
        hdr.add("SSPTYPE", cfg.scaling_basis.kind, "MeLOn: SFFT")
        hdr.add("SSPDEG", cfg.scaling_basis.degree, "MeLOn: SFFT")
        hdr.add("NSIKX", len(cfg.scaling_basis.int_knots_x), "MeLOn: SFFT")
        hdr.add("NSIKY", len(cfg.scaling_basis.int_knots_y), "MeLOn: SFFT")
        for n, k in enumerate(cfg.scaling_basis.int_knots_x):
            hdr.add(f"SIKX{n}", k, "MeLOn: SFFT")
        for n, k in enumerate(cfg.scaling_basis.int_knots_y):
            hdr.add(f"SIKY{n}", k, "MeLOn: SFFT")
    fits.write(path, np.asarray(solution, np.float64).reshape(1, -1), hdr)


def _basis_from_headers(hdr, prefix: str) -> BasisSpec:
    """Rebuild a BasisSpec from the v2 header keys written above.
    prefix: 'K' (kernel) | 'B' (background) | 'S' (scaling)."""
    kind = str(hdr[f"{prefix}SPTYPE"]).strip()
    degree = int(hdr[f"{prefix}SPDEG"])
    kx = tuple(float(hdr[f"{prefix}IKX{n}"])
               for n in range(int(hdr.get(f"N{prefix}IKX", 0) or 0)))
    ky = tuple(float(hdr[f"{prefix}IKY{n}"])
               for n in range(int(hdr.get(f"N{prefix}IKY", 0) or 0)))
    return BasisSpec(kind, degree, kx, ky)


def read_bspline_solution_fits(path: str):
    """Inverse of write_bspline_solution_fits: (solution, SFFTConfig) with the
    full v2 basis set (kernel/background/scaling specs incl. internal knots)
    reconstructed from headers — the skip-solve / checkpoint-resume reader for
    generalized configs (reference Read_SFFTSolution + the
    BSpline_MatchingKernel.FromFITS header path,
    sfft/BSplineSFFT.py:4358-4555)."""
    data, hdr = fits.read(path)
    solution = np.asarray(data, np.float64).reshape(-1)
    cfg = SFFTConfig(
        N0=int(hdr["N0"]), N1=int(hdr["N1"]),
        w0=(int(hdr["L0"]) - 1) // 2, w1=(int(hdr["L1"]) - 1) // 2,
        kernel_basis=_basis_from_headers(hdr, "K"),
        bg_basis=_basis_from_headers(hdr, "B"),
        const_phot_ratio=bool(hdr.get("CPHOTR", True)),
        scaling_basis=(_basis_from_headers(hdr, "S")
                       if hdr.get("SEPSCA") else None),
    )
    if cfg.Fij != int(hdr["FIJ"]) or cfg.Fpq != int(hdr["FPQ"]):
        raise ValueError("solution FITS headers inconsistent with reconstructed config")
    if solution.size != cfg.NEQ:
        raise ValueError(f"solution length {solution.size} != NEQ {cfg.NEQ}")
    return solution, cfg


class BSplineMatchingKernel:
    """Realize matching kernels at query coords for the generalized bases
    (reference BSpline_MatchingKernel, sfft/BSplineSFFT.py:4555-4723)."""

    def __init__(self, XY_q: np.ndarray):
        self.XY_q = np.asarray(XY_q, dtype=np.float64)

    def from_fits(self, path: str) -> np.ndarray:
        """Realize matching kernels at XY_q straight from a solution FITS
        written by write_bspline_solution_fits (reference
        BSpline_MatchingKernel.FromFITS, sfft/BSplineSFFT.py:4557-4650)."""
        solution, cfg = read_bspline_solution_fits(path)
        return self.from_solution(solution, cfg)

    def from_solution(self, solution: np.ndarray, cfg: SFFTConfig) -> np.ndarray:
        sx = self.XY_q[:, 0] / cfg.N0
        sy = self.XY_q[:, 1] / cfg.N1
        ac = np.asarray(solution)[: cfg.Fijab].reshape(cfg.Fij, cfg.L0, cfg.L1)
        ac = ac / (cfg.N0 * cfg.N1)
        Bk = basis_at_points(cfg.kernel_basis, cfg.N0, cfg.N1, sx, sy)  # (Fij, Nq)

        if cfg.scaling_mode == "ENTANGLED":
            std = sfft2standard(ac, cfg.w0, cfg.w1)
            return np.tensordot(Bk, std, (0, 0))

        # separate scaling: center dofs live on the scaling basis
        a_nc = ac.copy()
        a_nc[:, cfg.w0, cfg.w1] = 0.0
        s_nc = ac.sum(axis=(1, 2)) - ac[:, cfg.w0, cfg.w1]
        ker = np.tensordot(Bk, a_nc, (0, 0))  # (Nq, L0, L1)
        ker[:, cfg.w0, cfg.w1] -= np.tensordot(Bk.T, s_nc, (1, 0))
        if cfg.scaling_mode == "SEPARATE-CONSTANT":
            # center dofs ride the KERNEL basis (aggregated equal coefficients;
            # partition of unity makes this a constant for B-spline bases)
            sca = np.tensordot(Bk.T, ac[:, cfg.w0, cfg.w1], (1, 0))
        else:
            Bs = basis_at_points(cfg.scaling_basis, cfg.N0, cfg.N1, sx, sy)
            a00 = ac[: Bs.shape[0], cfg.w0, cfg.w1]
            sca = np.tensordot(Bs.T, a00, (1, 0))
        ker[:, cfg.w0, cfg.w1] += sca
        return ker
