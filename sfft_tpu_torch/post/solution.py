"""Solution readers and kernel/flux-scaling realization (counterpart of
sfft_tpu/post/solution.py; numpy only).

Reference: sfft/utils/SFFTSolutionReader.py. The solved coefficient vector is
the checkpoint format of the whole framework: these utilities reconstruct the
spatially-varying matching kernel and flux scaling anywhere in the field.

Representation notes (reference docstring, SFFTSolutionReader.py:14-39):
  SFFT dict:     SVK_xy = sum_ab Ac_xyab K_ab   (modified delta basis),
                 Ac_xyab = sum_ij ac_ijab x^i y^j, ac = a / (N0*N1)
  Standard dict: SVK_xy = sum_ab B_xyab D_ab    (Cartesian delta basis)
  conversion: center pixel B(0,0) = 2*Ac(0,0) - sum_ab Ac(a,b)
  (x, y) are ScaledFortranCoor of the query point.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from sfft_tpu_torch.config import BasisSpec, SFFTConfig
from sfft_tpu_torch.core.basis import basis_at_points
from sfft_tpu_torch.core.indices import ref_basis_exponents
from sfft_tpu_torch.io import fits


def solution_to_kernel_coeffs(
    solution: np.ndarray, cfg: SFFTConfig
) -> np.ndarray:
    """ac_ijab as an (Fij, L0, L1) array (SFFT delta-basis representation,
    scaled by 1/(N0*N1) as in Read_SFFTSolution)."""
    a = np.asarray(solution)[: cfg.Fijab].reshape(cfg.Fij, cfg.L0, cfg.L1)
    return a / (cfg.N0 * cfg.N1)


def sfft_dict_from_solution(solution: np.ndarray, cfg: SFFTConfig) -> Dict:
    """Reference Read_SFFTSolution.FromArray: {(i, j): (L0, L1) coeff map}."""
    ac = solution_to_kernel_coeffs(solution, cfg)
    exps = ref_basis_exponents(cfg.kernel_basis)
    return {tuple(map(int, ij)): ac[k].copy() for k, ij in enumerate(exps)}


def sfft2standard(coeffs: np.ndarray, w0: int, w1: int) -> np.ndarray:
    """delta-basis -> standard basis: center = 2*c00 - sum(c)
    (reference SVKDict_SFFT2ST.convert)."""
    out = np.array(coeffs, copy=True)
    s = out.sum(axis=(-2, -1))
    out[..., w0, w1] = 2.0 * coeffs[..., w0, w1] - s
    return out


def standard2sfft(coeffs: np.ndarray, w0: int, w1: int) -> np.ndarray:
    """standard basis -> delta-basis: center = sum(c)
    (reference SVKDict_ST2SFFT.convert)."""
    out = np.array(coeffs, copy=True)
    out[..., w0, w1] = coeffs.sum(axis=(-2, -1))
    return out


class RealizeMatchingKernel:
    """Matching-kernel stacks at query coordinates
    (reference Realize_MatchingKernel, SFFTSolutionReader.py:116-151)."""

    def __init__(self, XY_q: np.ndarray):
        # FortranCoor queries (1-based pixel coords)
        self.XY_q = np.asarray(XY_q, dtype=np.float64)

    def from_solution(self, solution: np.ndarray, cfg: SFFTConfig) -> np.ndarray:
        sx = self.XY_q[:, 0] / cfg.N0
        sy = self.XY_q[:, 1] / cfg.N1
        ac = solution_to_kernel_coeffs(solution, cfg)
        std = sfft2standard(ac, cfg.w0, cfg.w1)
        B = basis_at_points(cfg.kernel_basis, cfg.N0, cfg.N1, sx, sy)  # (Fij, Nq)
        return np.tensordot(B, std, (0, 0))  # (Nq, L0, L1)

    def from_fits(self, path: str) -> np.ndarray:
        solution, cfg = read_solution_fits(path)
        return self.from_solution(solution, cfg)


class RealizeFluxScaling:
    """Flux scaling (kernel sum) at query coordinates
    (reference Realize_FluxScaling, SFFTSolutionReader.py:153-196).
    The delta-basis center coefficient IS the kernel-sum dof."""

    def __init__(self, XY_q: np.ndarray):
        self.XY_q = np.asarray(XY_q, dtype=np.float64)

    def from_solution(self, solution: np.ndarray, cfg: SFFTConfig) -> np.ndarray:
        sx = self.XY_q[:, 0] / cfg.N0
        sy = self.XY_q[:, 1] / cfg.N1
        ac = solution_to_kernel_coeffs(solution, cfg)
        B = basis_at_points(cfg.kernel_basis, cfg.N0, cfg.N1, sx, sy)
        return np.einsum("f,fq->q", ac[:, cfg.w0, cfg.w1], B)

    def from_fits(self, path: str) -> np.ndarray:
        solution, cfg = read_solution_fits(path)
        return self.from_solution(solution, cfg)


def read_solution_fits(path: str) -> Tuple[np.ndarray, SFFTConfig]:
    """Read a solution FITS written by write_solution_fits and reconstruct the
    static config from headers (polynomial engine header keys match the
    reference: N0/N1/DK/DB/L0/L1/FIJ/FAB/FPQ/FIJAB)."""
    data, hdr = fits.read(path)
    solution = np.asarray(data).reshape(-1)
    N0, N1 = int(hdr["N0"]), int(hdr["N1"])
    L0 = int(hdr["L0"])
    w = (L0 - 1) // 2
    cfg = SFFTConfig(
        N0=N0, N1=N1, w0=w, w1=(int(hdr["L1"]) - 1) // 2,
        kernel_basis=BasisSpec("polynomial", int(hdr["DK"])),
        bg_basis=BasisSpec("polynomial", int(hdr["DB"])),
    )
    assert cfg.Fij == int(hdr["FIJ"]) and cfg.Fpq == int(hdr["FPQ"])
    return solution, cfg
