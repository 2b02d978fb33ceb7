"""The SFFT engine: solve & subtract (counterpart of sfft_tpu/core/engine.py).

Maps to the reference call stack ElementalSFFTSubtract.ESS /
GeneralSFFTSubtract.GSS (sfft/sfftcore/SFFTSubtract.py:8-475, 823-923).
PyTorch runs eagerly, so the JAX package's per-config jit cache has no
counterpart: the functions below run directly on tensors. Tensors run on the
device they lie on; numpy input goes to `device`, which defaults to the CUDA
card (a machine without one raises: there is no silent CPU fallback, so CPU
callers pass device="cpu" or CPU tensors). Every entry point takes ``plain``
(default False): True keeps the hand kernels (K1, K3, K4, K5) out and runs
their plain twins, which the tests and chip_smoke.py use as an independent
cross-check.
"""

from __future__ import annotations

import numpy as np
import torch

from sfft_tpu_torch.config import SFFTConfig, torch_dtype
from sfft_tpu_torch.core.assemble import GreekTables, assemble_system, entangled_tables
from sfft_tpu_torch.core.basis import basis_planes
from sfft_tpu_torch.core.fdiff import fdiff
from sfft_tpu_torch.core.greek import greek_tables, greek_tables_separate
from sfft_tpu_torch.core.regularize import regularization_terms_on
from sfft_tpu_torch.core.solve import solve_system


def _plane_stacks(cfg: SFFTConfig, I: torch.Tensor, dtype=None, rows=None):
    """SI = I * kernel-basis planes (reference SPixA_Iij); ST = background basis
    planes (reference SPixA_Tpq); SSc = I * scaling-basis planes, zero-padded to
    Fij, for SEPARATE-VARYING (reference ScaSPixA_Iij). rows = (r0, r1): I
    is the row block [r0, r1) of the image, and so are the planes; an
    integer array: I holds the image rows it lists (``basis_planes``). I
    (B, N0, N1), a batch of pairs: SI and SSc gain the pair axis, ST (the
    same for every pair) does not."""
    dt = torch_dtype(cfg.dtype if dtype is None else dtype)
    dev = I.device
    Bk = basis_planes(cfg.kernel_basis, cfg.N0, cfg.N1, dtype=dt, device=dev, rows=rows)
    ST = basis_planes(cfg.bg_basis, cfg.N0, cfg.N1, dtype=dt, device=dev, rows=rows)
    SI = I[..., None, :, :].to(dt) * Bk
    SSc = None
    if cfg.scaling_mode == "SEPARATE-VARYING":
        Bs = basis_planes(cfg.scaling_basis, cfg.N0, cfg.N1, dtype=dt, device=dev, rows=rows)
        SSc = I[..., None, :, :].to(dt) * Bs
        if SSc.shape[-3] < cfg.Fij:
            shape = tuple(I.shape[:-2]) + (cfg.Fij - SSc.shape[-3],) + tuple(I.shape[-2:])
            pad = torch.zeros(shape, dtype=dt, device=dev)
            SSc = torch.cat([SSc, pad], dim=-3)
    return SI, ST, SSc


def _normal_equations_impl(cfg: SFFTConfig, mI: torch.Tensor, mJ: torch.Tensor,
                           plain: bool = False, shared=None):
    """Assemble the (NEQ, NEQ) normal-equation matrix and RHS vector for a
    masked pair — everything `_solve_impl` does short of the solve (reference
    LHMAT/RHb, sfft/sfftcore/SFFTSubtract.py:224-383). `shared`: the exact or
    pexact plane spectra of (mI, mJ), when the caller has them. The peeled
    and pexact backends with polynomial bases and the fft / fft32 and exact
    backends with any bases also take a batch of pairs, mI and mJ (B, N0,
    N1), and give (B, NEQ, NEQ) and (B, NEQ), each pair's bits those of its
    single call (the Tikhonov terms, one set for the config, add to every
    pair's system)."""
    dt = torch_dtype(cfg.dtype)
    mI = mI.to(dt)
    mJ = mJ.to(dt)
    separate_varying = cfg.scaling_mode == "SEPARATE-VARYING"

    if cfg.greek_backend == "peeled":
        from sfft_tpu_torch.core.peel import peeled_greek_tables

        out = peeled_greek_tables(mI, mJ, cfg, plain=plain)
        extra = out[5] if separate_varying else None
    elif cfg.greek_backend == "pexact":
        from sfft_tpu_torch.core.pexact import pexact_greek_tables

        out = pexact_greek_tables(mI, mJ, cfg, shared=shared, plain=plain)
        extra = out[5] if separate_varying else None
    elif cfg.greek_backend == "exact":
        from sfft_tpu_torch.core.greek import greek_tables_exact

        out = greek_tables_exact(mI, mJ, cfg, shared=shared, plain=plain)
        extra = out[5] if separate_varying else None
    elif cfg.greek_backend in ("fft", "fft32", "corr"):
        # fft32: the tables come out f32, so the assembly below runs in f32
        # and the solve receives the f32 system, as sfft_tpu's does; corr:
        # the FFT-free f64 windows (K8)
        SI, ST, SSc = _plane_stacks(cfg, mI)
        out = greek_tables(SI, ST, mJ, cfg.w0, cfg.w1, backend=cfg.greek_backend,
                           chunk=cfg.greek_chunk, plain=plain)
        extra = None
        if separate_varying:
            extra = greek_tables_separate(
                SI, SSc, ST, mJ, cfg.w0, cfg.w1, backend=cfg.greek_backend,
                chunk=cfg.greek_chunk, n_active=cfg.scaling_basis.num_funcs(), plain=plain)
    else:
        raise ValueError(f"unknown greek backend {cfg.greek_backend!r}")
    return system_from_tables(cfg, out[:5], extra, mI.device)


def system_from_tables(cfg: SFFTConfig, out, extra, device):
    """The normal system (lhs, rhs) from the unscaled correlation tables
    (Comg, Cgam, Cthe, Cphi, Cdel) and, for SEPARATE-VARYING, the extra
    tables (Pbs, Pss, Pgs, Pts) (else None): the SCALE powers, the
    entangled tables, the Tikhonov terms and the assembly on `device`."""
    s = cfg.SCALE
    Comg, Cgam, Cthe, Cphi, Cdel = out
    tables = entangled_tables(
        cfg, (s**3) * Comg, (s**2) * Cgam, (s**2) * Cthe, s * Cphi, s * Cdel
    )
    if extra is not None:
        Pbs, Pss, Pgs, Pts = extra
        tables = GreekTables(
            Pbb=tables.Pbb, Pbs=(s**3) * Pbs, Pss=(s**3) * Pss,
            Pgb=tables.Pgb, Pgs=(s**2) * Pgs,
            Ptb=tables.Ptb, Pts=(s**2) * Pts,
            Pphi=tables.Pphi, Pdel=tables.Pdel,
        )
    # Tikhonov terms ride the streamed OMG row chunks of the assembly. The
    # system comes out in the tables' dtype: f64 tables assemble in f64 at
    # any NEQ, as sfft_tpu does on a CPU or GPU (its f32 output for f64
    # tables at NEQ >= 8192 with a solver other than 'exact' is a TPU rule;
    # the card holds the 1.4 GB f64 system of 13k dofs easily)
    return assemble_system(cfg, tables,
                           reg_terms=regularization_terms_on(cfg, device, tables.Pbb.dtype))


# the (greek, fdiff) backend pairs whose batch of pairs runs as one batched
# step (``solve_and_subtract_batched_fn``), with any solver (the solve runs
# pair by pair): the fast mode, the default and v2 fast pairs, the contract
# pair (sfft_tpu's TPU default) and the any-basis exact pair (the v2
# contract), as sfft_tpu's jax.vmap runs any config
BATCHED_BACKENDS = (("peeled", "fft32"), ("fft", "fft"), ("fft32", "fft32"),
                    ("pexact", "pexact"), ("exact", "exact"))


def batched_step_supported(cfg: SFFTConfig) -> bool:
    """Whether a batch of pairs of this config runs as one batched step: the
    fast mode's backends (peeled / fft32) and the contract's (pexact /
    pexact) with polynomial bases; the default (fft / fft), the v2 fast
    (fft32 / fft32) and the exact (exact / exact: the v2 contract) backends
    with any bases; any solver. Every other config (corr / conv, the
    piecewise peel, pexact with B-spline bases) takes the per-pair loop of
    parallel/batch.py."""
    from sfft_tpu_torch.core.peel import polynomial_bases

    return ((cfg.greek_backend, cfg.fdiff_backend) in BATCHED_BACKENDS
            and (cfg.greek_backend not in ("peeled", "pexact") or polynomial_bases(cfg)))


def normal_equations_fn(cfg: SFFTConfig):
    """(mI, mJ) -> (lhs, rhs), for residual certificates of candidate
    solutions."""

    def tables(mI, mJ, plain: bool = False):
        return _normal_equations_impl(cfg, mI, mJ, plain=plain)

    return tables


def _solve_impl(cfg: SFFTConfig, mI: torch.Tensor, mJ: torch.Tensor,
                plain: bool = False) -> torch.Tensor:
    dt = torch_dtype(cfg.dtype)
    lhs, rhs = _normal_equations_impl(cfg, mI, mJ, plain=plain)
    return solve_system(cfg, lhs, rhs, plain=plain).to(dt)


def _subtract_impl(cfg: SFFTConfig, I: torch.Tensor, J: torch.Tensor,
                   solution: torch.Tensor, plain: bool = False, shared=None) -> torch.Tensor:
    if cfg.fdiff_backend in ("exact", "pexact"):
        # the pair-arithmetic paths build their own basis-weighted planes
        return fdiff(cfg, solution, None, None, J, None, I=I, shared=shared, plain=plain)
    # fft32: the difference is computed in f32/c64 anyway — build the basis
    # plane stacks directly in f32
    dt = torch_dtype("float32" if cfg.fdiff_backend == "fft32" else cfg.dtype)
    I = I.to(dt)
    J = J.to(dt)
    SI, ST, SSc = _plane_stacks(cfg, I, dtype=dt)
    if SSc is not None:
        # the planes past the active scaling functions are zero padding:
        # they add nothing to the model spectrum
        SSc = SSc[..., : cfg.scaling_basis.num_funcs(), :, :]
    return fdiff(cfg, solution.to(dt), SI, ST, J, SSc, plain=plain)


def solve_and_subtract_fn(cfg: SFFTConfig):
    """One solve+subtract step: solve on the masked pair (mI, mJ), apply to
    the unmasked pair (I, J). Returns (solution, difference). A
    ``batched_step_supported`` config runs the batched step on the batch of
    one pair (with the exact or the pexact backends for both tables and
    difference, one set of plane spectra when the masked and unmasked
    images are the same tensors); the others solve, then subtract."""
    if batched_step_supported(cfg):
        def one(I, J, mI, mJ, plain: bool = False):
            sol, diff = _batched_step(cfg, I[None], J[None], mI[None], mJ[None], plain,
                                      same=I is mI and J is mJ)
            return sol[0], diff[0]

        return one

    def step(I, J, mI, mJ, plain: bool = False):
        sol = _solve_impl(cfg, mI, mJ, plain=plain)
        return sol, _subtract_impl(cfg, I, J, sol, plain=plain)

    return step


def _batched_step(cfg: SFFTConfig, I, J, mI, mJ, plain: bool, same: bool = False):
    """The batched step's work on (B, N0, N1) tensors: the tables, the
    assembly and the difference for the batch, the solve pair by pair (a
    batched factorization changes a pair's bits, and each pair keeps its
    own fallback decision and refinement stop). exact and pexact: one set
    of plane spectra of the masked stacks for the batch (pexact's
    PexactShared, greek.exact_plane_spectra), which the difference reuses
    when they are the unmasked ones (`same`). The systems are let go
    before the difference."""
    dt = torch_dtype(cfg.dtype)
    shared = None
    if cfg.greek_backend == "pexact" and cfg.fdiff_backend == "pexact":
        from sfft_tpu_torch.core import pexact

        shared = pexact.pexact_plane_spectra(mI, mJ, cfg, plain=plain)
    elif cfg.greek_backend == "exact" and cfg.fdiff_backend == "exact":
        from sfft_tpu_torch.core.greek import exact_plane_spectra

        shared = exact_plane_spectra(mI.to(dt), mJ.to(dt), cfg, plain=plain)
    lhs, rhs = _normal_equations_impl(cfg, mI, mJ, plain=plain, shared=shared)
    sol = _aligned_rows([solve_system(cfg, a, b, plain=plain).to(dt) for a, b in zip(lhs, rhs)])
    del lhs, rhs
    return sol, _subtract_impl(cfg, I, J, sol, plain=plain, shared=shared if same else None)


def _aligned_rows(rows):
    """The 1-D tensors `rows` as a (B, n) view whose rows each start on a
    512-byte boundary, as a single call's own solution does (the caching
    allocator's alignment): PyTorch's reductions pick their vector loads,
    and with them the order of a sum, by a pointer's alignment, so a pair's
    kernel sums over a view of its solution (the exact difference's,
    pexact's smooth terms) keep their single call's bits only there. The
    NIRCam system's 13226 f64 dofs would put every odd pair 16 bytes off a
    32-byte boundary."""
    n = rows[0].shape[-1]
    per = 512 // rows[0].element_size()
    return torch.nn.functional.pad(torch.stack(rows), (0, (-n) % per))[:, :n]


def solve_and_subtract_batched_fn(cfg: SFFTConfig):
    """The step for a batch of pairs on one device, the counterpart of
    sfft_tpu's jax.vmap of ``solve_and_subtract_fn``: step(I, J, mI, mJ)
    with (B, N0, N1) tensors returns (solutions (B, NEQ), differences (B,
    N0, N1)), each pair's bits those of its single call. One set of the
    config's kernel launches (K3, K1 and K2; the contract backends' K3, K4,
    K7, K6a, K6m and K6p; the exact backends' K4, K7, K6a and K6m) and one pass of
    the table algebra and the assembly for the batch; the library calls
    whose bits would change with the batch's size (the solve, with K5 in
    the large systems' refinement, the rfft2 and irfft2, the products with
    long contractions, the small einsums of pexact's smooth model and the
    exact difference's background) run pair by pair. Only for
    ``batched_step_supported`` configs (it raises for the others): the
    fast, default, v2 fast, contract and exact backends with any solver
    (the v2 NIRCam configuration's contract and fast steps among them); the
    single step of those configs is this step on one pair."""
    if not batched_step_supported(cfg):
        raise ValueError(f"no batched step for greek {cfg.greek_backend!r}, fdiff "
                         f"{cfg.fdiff_backend!r} with these bases: "
                         f"run its pairs one by one")

    def step(I, J, mI, mJ, plain: bool = False):
        solve_and_subtract_batched_fn.steps += 1
        return _batched_step(cfg, I, J, mI, mJ, plain, same=I is mI and J is mJ)

    return step


solve_and_subtract_batched_fn.steps = 0   # batched steps run (any config)


def solve_and_subtract_same_fn(cfg: SFFTConfig):
    """The step for the masked == unmasked special case (2 array inputs):
    passing the same tensors through `step` lets the exact and pexact
    backends share one plane-spectra pass between solve and difference."""
    step = solve_and_subtract_fn(cfg)

    def step_same(I, J, plain: bool = False):
        return step(I, J, I, J, plain=plain)

    return step_same


def default_device() -> torch.device:
    """Where numpy input runs when the caller names no device: the CUDA card.
    Without one this raises; CPU callers pass device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "sfft_tpu_torch runs numpy input on the CUDA card unless a device is "
            "given, and no CUDA device is available; pass device='cpu' (or CPU "
            "tensors) to run on the CPU")
    return torch.device("cuda")


def _as_tensor(x, device=None) -> torch.Tensor:
    """Tensor view of an image: tensors stay where they are (moved only when
    `device` names another device); numpy arrays go to `device`, or to the
    card (``default_device``) when it is None."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    a = np.asarray(x)
    if not a.flags.writeable:  # torch tensors cannot view read-only memory
        a = a.copy()
    return torch.as_tensor(a, device=default_device() if device is None else device)


def _check_device(t: torch.Tensor):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sfft_tpu_torch runs on cpu or cuda tensors, not {t.device}")


class ElementalSFFT:
    """Reference ElementalSFFTSubtract.ESS equivalent (array-in/array-out)."""

    @staticmethod
    def ESS(
        PixA_I,
        PixA_J,
        cfg: SFFTConfig,
        SFFTSolution=None,
        Subtract: bool = False,
        plain: bool = False,
        device=None,
    ):
        """Solve (unless SFFTSolution is given) and optionally subtract.
        Runs on the device of PixA_I, or on `device` when it is given (numpy
        input without a device runs on the card); returns tensors there."""
        if tuple(PixA_I.shape) != (cfg.N0, cfg.N1) or tuple(PixA_J.shape) != (cfg.N0, cfg.N1):
            raise ValueError(
                f"input images must have shape ({cfg.N0}, {cfg.N1}); "
                f"got {tuple(PixA_I.shape)} / {tuple(PixA_J.shape)}"
            )
        I = _as_tensor(PixA_I, device)
        _check_device(I)
        J = _as_tensor(PixA_J, I.device)
        solution = SFFTSolution
        if solution is None:
            solution = _solve_impl(cfg, I, J, plain=plain)
        else:
            solution = _as_tensor(solution, I.device)
        diff = None
        if Subtract:
            diff = _subtract_impl(cfg, I, J, solution, plain=plain)
        return solution, diff


def elemental_subtract(PixA_I, PixA_J, cfg, solution=None, subtract=False, plain=False,
                       device=None):
    return ElementalSFFT.ESS(PixA_I, PixA_J, cfg, solution, subtract, plain=plain,
                             device=device)


class GeneralSFFT:
    """Reference GeneralSFFTSubtract.GSS equivalent: solve on the masked pair,
    apply to the unmasked pair, optionally propagate a contamination mask by
    convolving it with the fitted kernel (threshold -0.001;
    sfft/sfftcore/SFFTSubtract.py:906-921)."""

    @staticmethod
    def GSS(PixA_I, PixA_J, PixA_mI, PixA_mJ, cfg: SFFTConfig, ContamMask_I=None,
            plain: bool = False, device=None):
        """Runs on the device of PixA_I, or on `device` when it is given
        (numpy input without a device runs on the card)."""
        shapes = {
            tuple(PixA_I.shape),
            tuple(PixA_J.shape),
            tuple(PixA_mI.shape),
            tuple(PixA_mJ.shape),
        }
        if len(shapes) > 1:
            raise ValueError("input images must share one shape")

        if PixA_I is PixA_mI and PixA_J is PixA_mJ and ContamMask_I is None:
            # masked == unmasked (the same arrays): the two-input step
            I = _as_tensor(PixA_I, device)
            _check_device(I)
            solution, diff = solve_and_subtract_same_fn(cfg)(
                I, _as_tensor(PixA_J, I.device), plain=plain)
            return solution, diff, None

        if device is not None:
            dev = torch.device(device)
        elif isinstance(PixA_I, torch.Tensor):
            dev = PixA_I.device
        else:
            dev = default_device()
        solution, _ = ElementalSFFT.ESS(PixA_mI, PixA_mJ, cfg, None, Subtract=False,
                                        plain=plain, device=dev)
        _, diff = ElementalSFFT.ESS(PixA_I, PixA_J, cfg, solution, Subtract=True,
                                    plain=plain, device=dev)

        contam_out = None
        if ContamMask_I is not None:
            tsol = solution.clone()
            tsol[-cfg.Fpq :] = 0.0
            tI = _as_tensor(ContamMask_I, diff.device).to(torch_dtype(cfg.dtype))
            tJ = torch.zeros_like(tI)
            _, tD = ElementalSFFT.ESS(tI, tJ, cfg, tsol, Subtract=True, plain=plain)
            contam_out = tD < -0.001
        return solution, diff, contam_out


def general_subtract(PixA_I, PixA_J, PixA_mI, PixA_mJ, cfg, contam_mask_I=None,
                     plain=False, device=None):
    return GeneralSFFT.GSS(PixA_I, PixA_J, PixA_mI, PixA_mJ, cfg, contam_mask_I,
                           plain=plain, device=device)
