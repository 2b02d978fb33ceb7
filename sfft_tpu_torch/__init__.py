"""sfft_tpu_torch — the PyTorch / CUDA port of sfft_tpu.

Fourier-space astronomical image subtraction (SFFT; Hu et al. 2022, ApJ 936,
157): solve a spatially-varying PSF-matching kernel K_xy plus a spatially-
varying differential background B_xy such that J ~= I (*) K_xy + B_xy, and
emit the difference D = J - (I (*) K_xy + B_xy).

The package keeps sfft_tpu's module paths and public names so each piece
has a visible counterpart. It imports torch and numpy, never jax or
sfft_tpu. Plain tensor code is PyTorch; the stages that sfft_tpu ran as TPU
kernels are hand-written CUDA kernels for Hopper (sm_90a) under csrc/,
built with nvcc at their first use on a CUDA tensor (see _kernels.py). On
CPU tensors every kernel wrapper runs its plain PyTorch twin.

Ported so far: every greek backend ('fft', 'fft32', 'exact', 'peeled' for
polynomial and B-spline bases, 'pexact', and 'corr', the FFT-free f64 route
on the K8 kernel), every difference backend ('fft', 'fft32', 'exact',
'pexact', and 'conv' on the K9 kernel), the 'lu', 'cho', 'host',
'blocked_cho', 'refined', 'exact' (with its large-system route) and
'transformed' solvers, Tikhonov regularization,
polynomial and B-spline bases in the ENTANGLED / SEPARATE scaling modes, the
customized packets and the B-spline packet with its solution FITS, the
automatic packets EasySparsePacket.ESP and EasyCrowdedPacket.ECP with their
host preprocessing (prep/, utils/, and native/, a C++ host extension built
with g++ at first use) and RICE_1 tile-compressed FITS, the
post-processing (matching-kernel realization, decorrelation kernels, grid
convolution), the survey layer: the two-stage scheduler behind
MultiEasySparsePacket.MESP / MultiEasyCrowdedPacket.MECP with batched
dispatch over the cards (parallel/), and the resident engine server
(serve.py), and the multi-device layer: one pair's step row-sharded over a
list of devices (parallel/sharded_fft.py) and the multi-host survey over
gloo (parallel/multihost.py), the int16 upload of the fast survey path
(utils/pack.py, parallel/batch.batched_subtract_packed), and the host
utilities: convolve2d on K9 (utils/convolve.py), the sky estimator, WCS,
stamps and resampling (utils/sky.py, wcs.py, stamp.py, prep/resample.py)
and the phase timer (utils/profiling.py). sfft_tpu exports none of these
from its package, so neither does the port: import them from their
modules. Numpy input runs on the CUDA card unless the caller passes
device="cpu".
"""

from sfft_tpu_torch.config import SFFTConfig, make_config
from sfft_tpu_torch.core.engine import (
    ElementalSFFT,
    GeneralSFFT,
    elemental_subtract,
    general_subtract,
)
from sfft_tpu_torch.api.customized import CustomizedPacket, PureTorchCustomizedPacket
from sfft_tpu_torch.api.easy_crowded import EasyCrowdedPacket
from sfft_tpu_torch.api.easy_sparse import EasySparsePacket
from sfft_tpu_torch.api.bspline import (
    BSplineMatchingKernel,
    BSplinePacket,
    make_bspline_config,
    read_bspline_solution_fits,
    write_bspline_solution_fits,
)
from sfft_tpu_torch.post.decorrelation import BSplineDeCorrelation, DeCorrelationCalculator
from sfft_tpu_torch.post.grid_convolve import BSplineGridConvolve

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: importing the package starts no thread and opens no socket
    if name == "MultiEasySparsePacket":
        from sfft_tpu_torch.parallel.scheduler import MultiEasySparsePacket

        return MultiEasySparsePacket
    if name == "MultiEasyCrowdedPacket":
        from sfft_tpu_torch.parallel.scheduler import MultiEasyCrowdedPacket

        return MultiEasyCrowdedPacket
    if name in ("EngineClient", "EngineServer", "ensure_server"):
        import sfft_tpu_torch.serve as _serve

        return getattr(_serve, name)
    raise AttributeError(name)


__all__ = [
    "SFFTConfig",
    "make_config",
    "ElementalSFFT",
    "GeneralSFFT",
    "elemental_subtract",
    "general_subtract",
    "CustomizedPacket",
    "PureTorchCustomizedPacket",
    "EasySparsePacket",
    "EasyCrowdedPacket",
    "BSplinePacket",
    "BSplineMatchingKernel",
    "make_bspline_config",
    "read_bspline_solution_fits",
    "write_bspline_solution_fits",
    "DeCorrelationCalculator",
    "BSplineDeCorrelation",
    "BSplineGridConvolve",
    "MultiEasySparsePacket",
    "MultiEasyCrowdedPacket",
    "EngineClient",
    "EngineServer",
    "ensure_server",
]
