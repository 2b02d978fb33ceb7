"""Static configuration for an SFFT solve (PyTorch port of sfft_tpu.config).

A frozen, hashable dataclass holds everything shape-like, so per-config
static tables (gather plans, phase matrices, moment sums) are cached by
config exactly as in the JAX package. The fields, their defaults and every
derived property are those of ``sfft_tpu.config.SFFTConfig``, so a config
crosses between the two packages through ``dataclasses.asdict`` and
``config_from_fields``.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BasisSpec:
    """Spatial-variation basis for kernel / background / scaling.

    kind='polynomial': standard 2D polynomial with triangular multi-index
        {x^i y^j : i+j <= degree} in ScaledFortranCoor (cx=(row+1)/N0,
        cy=(col+1)/N1).
    kind='bspline': tensor-product clamped B-spline basis with `degree` and
        internal knots.
    """

    kind: str = "polynomial"  # 'polynomial' | 'bspline'
    degree: int = 2
    int_knots_x: Tuple[float, ...] = ()
    int_knots_y: Tuple[float, ...] = ()

    def num_funcs(self) -> int:
        if self.kind == "polynomial":
            return (self.degree + 1) * (self.degree + 2) // 2
        if self.kind == "bspline":
            fi = len(self.int_knots_x) + self.degree + 1
            fj = len(self.int_knots_y) + self.degree + 1
            return fi * fj
        raise ValueError(f"unknown basis kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class SFFTConfig:
    """All static parameters of one SFFT problem instance.

    Backend fields name the same algorithms as in sfft_tpu; the port
    implements every one of them: greek 'fft', 'fft32', 'exact', 'peeled'
    (polynomial and B-spline bases), 'pexact' and 'corr' (the FFT-free f64
    route, K8), fdiff 'fft', 'fft32', 'exact', 'pexact' and 'conv' (the
    real-space f64 difference, K9), and every solver ('lu', 'cho', 'host',
    'blocked_cho', 'refined', 'exact', 'transformed').
    """

    N0: int
    N1: int
    w0: int
    w1: int
    kernel_basis: BasisSpec = BasisSpec()
    bg_basis: BasisSpec = BasisSpec()
    const_phot_ratio: bool = True
    scaling_basis: Optional[BasisSpec] = None
    regularize_lambda: float = 0.0
    reg_xy: Tuple[Tuple[float, float], ...] = ()
    reg_weights: Optional[Tuple[float, ...]] = None
    ignore_laplacian_kercent: bool = True
    dtype: str = "float64"
    greek_backend: str = "fft"
    fdiff_backend: str = "fft"
    solver: str = "lu"
    greek_chunk: int = 0
    peel_degree: int = 3
    fluct_dtype: str = "float32"
    pexact_prof: Tuple[int, int, int] = (8, 7, 6)

    # ---- derived static quantities -------------------------------------
    @property
    def L0(self) -> int:
        return 2 * self.w0 + 1

    @property
    def L1(self) -> int:
        return 2 * self.w1 + 1

    @property
    def Fab(self) -> int:
        return self.L0 * self.L1

    @property
    def Fij(self) -> int:
        return self.kernel_basis.num_funcs()

    @property
    def Fpq(self) -> int:
        return self.bg_basis.num_funcs()

    @property
    def Fijab(self) -> int:
        return self.Fij * self.Fab

    @property
    def NEQ(self) -> int:
        return self.Fij * self.Fab + self.Fpq

    @property
    def SCALE(self) -> float:
        return 1.0 / (self.N0 * self.N1)

    @property
    def center_ab(self) -> int:
        return self.w0 * self.L1 + self.w1

    @property
    def scaling_mode(self) -> str:
        if self.scaling_basis is None:
            return "ENTANGLED"
        if self.scaling_basis.degree == 0 and self.scaling_basis.kind == "polynomial":
            return "SEPARATE-CONSTANT"
        if (
            self.scaling_basis.kind == "bspline"
            and self.scaling_basis.degree == 0
            and not self.scaling_basis.int_knots_x
            and not self.scaling_basis.int_knots_y
        ):
            return "SEPARATE-CONSTANT"
        return "SEPARATE-VARYING"

    @property
    def ScaFij(self) -> int:
        if self.scaling_basis is None:
            return self.Fij
        return self.scaling_basis.num_funcs()

    @property
    def NEQt(self) -> int:
        mode = self.scaling_mode
        if mode == "ENTANGLED":
            return self.NEQ - (self.Fij - 1) if self.const_phot_ratio else self.NEQ
        if mode == "SEPARATE-CONSTANT":
            return self.NEQ - self.Fij + 1
        return self.NEQ - (self.Fij - self.ScaFij)

    @property
    def NEQ_FSfree(self) -> int:
        if not self.const_phot_ratio:
            return self.NEQ
        return self.NEQ - (self.Fij - 1)

    def validate(self) -> None:
        if self.kernel_basis.kind == "polynomial" and self.kernel_basis.degree not in (0, 1, 2, 3):
            raise ValueError("kernel polynomial degree must be 0/1/2/3")
        if self.bg_basis.kind == "polynomial" and self.bg_basis.degree not in (0, 1, 2, 3):
            raise ValueError("background polynomial degree must be 0/1/2/3")
        if min(self.N0, self.N1) <= 4 * max(self.w0, self.w1):
            raise ValueError("image too small for the requested kernel half-width")


# Named backend triples of sfft_tpu (kept as data so configs name the same
# modes; make_config does not apply them, see below).
TPU_MODES = {
    "contract": dict(greek_backend="pexact", fdiff_backend="pexact",
                     solver="exact"),
    "balanced": dict(greek_backend="pexact", fdiff_backend="pexact",
                     solver="exact", pexact_prof=(6, 6, 5)),
    "fast": dict(greek_backend="peeled", fdiff_backend="fft32",
                 solver="refined"),
}


@lru_cache(maxsize=128)
def make_config(
    NX: int,
    NY: int,
    KerHW: int,
    KerPolyOrder: int = 2,
    BGPolyOrder: int = 2,
    ConstPhotRatio: bool = True,
    dtype: str = "float64",
    greek_backend: Optional[str] = None,
    fdiff_backend: Optional[str] = None,
    solver: Optional[str] = None,
    greek_chunk: int = 0,
    mode: Optional[str] = None,
    pexact_prof: Optional[Tuple[int, int, int]] = None,
) -> SFFTConfig:
    """Reference-parameter-compatible constructor (SingleSFFTConfigure.SSC).

    Unset backends resolve as sfft_tpu resolves them on a CPU or GPU: greek
    'fft', fdiff 'fft', solver 'lu' (native f64 FFTs and LU). `mode` names a
    TPU_MODES entry; like sfft_tpu off the TPU it does not change the
    backends, but an unknown name still raises.
    """
    if mode is not None and mode not in TPU_MODES:
        raise ValueError(f"unknown mode {mode!r}; pick from {sorted(TPU_MODES)}")
    extra = {}
    if pexact_prof is not None:
        extra["pexact_prof"] = tuple(int(x) for x in pexact_prof)
    cfg = SFFTConfig(
        N0=int(NX),
        N1=int(NY),
        w0=int(KerHW),
        w1=int(KerHW),
        kernel_basis=BasisSpec(kind="polynomial", degree=int(KerPolyOrder)),
        bg_basis=BasisSpec(kind="polynomial", degree=int(BGPolyOrder)),
        const_phot_ratio=bool(ConstPhotRatio),
        dtype=dtype,
        greek_backend=greek_backend or "fft",
        fdiff_backend=fdiff_backend or "fft",
        solver=solver or "lu",
        greek_chunk=int(greek_chunk),
        **extra,
    )
    cfg.validate()
    return cfg


def _tuplify(x):
    if isinstance(x, (list, tuple)):
        return tuple(_tuplify(v) for v in x)
    return x


def config_from_fields(d: dict) -> SFFTConfig:
    """SFFTConfig from the field dict of an sfft_tpu config
    (``dataclasses.asdict(cfg)``) or of one of this package. Nested basis
    dicts become BasisSpec; lists (e.g. after a JSON round trip) become
    tuples so the config stays hashable."""
    names = {f.name for f in dataclasses.fields(SFFTConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown SFFTConfig fields {sorted(unknown)}")
    kw = {}
    for k, v in d.items():
        if k in ("kernel_basis", "bg_basis", "scaling_basis") and v is not None:
            v = v if isinstance(v, BasisSpec) else BasisSpec(**{
                kk: _tuplify(vv) for kk, vv in dict(v).items()})
        else:
            v = _tuplify(v)
        kw[k] = v
    return SFFTConfig(**kw)


def np_dtype(cfg: SFFTConfig) -> np.dtype:
    return np.dtype(cfg.dtype)


def complex_dtype(cfg: SFFTConfig) -> np.dtype:
    return np.dtype("complex128" if cfg.dtype == "float64" else "complex64")


_TORCH_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "complex128": torch.complex128,
    "complex64": torch.complex64,
}


def torch_dtype(name) -> torch.dtype:
    """torch dtype for a dtype name ('float64', np.float32, torch.float64, ...)."""
    if isinstance(name, torch.dtype):
        return name
    return _TORCH_DTYPES[np.dtype(name).name]
