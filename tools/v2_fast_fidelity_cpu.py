#!/usr/bin/env python3
"""The v2 fft32 mode's fidelity in sfft_tpu and in sfft_tpu_torch, on the CPU.

    JAX_PLATFORMS=cpu python tools/v2_fast_fidelity_cpu.py [N] [GKERHW]
    python tools/v2_fast_fidelity_cpu.py --k1 [N] [GKERHW]

Runs the NIRCam configuration's shape (degree-2 B-spline kernel with 2 x 2
internal knots at N/3 and 2N/3, SEPARATE-VARYING degree-2 polynomial
scaling, degree-0 background, Tikhonov lambda = 3e-5 on 512 points from seed
10086) at a reduced size (default 480^2, GKerHW 6: NEQ 4226; the full
configuration is 900^2, GKerHW 11, NEQ 13226) on chip_smoke.py's pair
generator, through both packages' shared-spectra step: the fft32 / fft32 /
refined trio against each package's own f64 fft / fft / lu difference.
The two distances are the algorithm's own error (sfft_tpu's) and the
port's; prints one line with both, and the two packages' f64 paths against
each other.

With --k1 (no JAX) it runs the port's fft32 mode with the windowed
correlations computed in K1's c64 arithmetic, emulated here (f32 values, an
FMA as one rounding of the exact f64 result; the product h = a * conj(b) in
f32): stage 1 on the conjugate-pair route, T1 stored in c64, stage 2 over
u; with f32 sums in both stages (stage 1 in registers, stage 2 over 32
ranges of u, then their sum: the kernel's earlier order), with f32 stage-1
and f64 stage-2 sums, and with f64 sums in both (the kernel's order now);
and with the irfft twin. One line each, RMS from the port's f64
difference. It predicts what a change to K1's summation order does to the
mode before a run on the card (~20 s per f32-stage-1 line at 480^2, ~18
GiB and ~10 min at 900^2).
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sfft_tpu_torch import make_bspline_config as tmake  # noqa: E402
from sfft_tpu_torch.core import engine as tengine  # noqa: E402
from sfft_tpu_torch.core import greek  # noqa: E402

FAST = dict(greek_backend="fft32", fdiff_backend="fft32", solver="refined")
F64 = torch.float64


def _r32(x):
    return x.to(torch.float32).to(F64)


def _fma(a, b, c):
    return _r32(a * b + c)


def k1_emulated(specA, specB, ia, ib, E0, E1, stage1, stage2):
    """K1's c64 arithmetic on the conjugate-pair route (csrc/corr_window.cuh),
    one pair list: h = a * conj(b) by FMAs; per row u and lag slot d the four
    register sums of hx ex, hy ey, hx ey, hy ex over v (E1's columns from the
    middle one on), in f32 (stage1 "f32") or f64 ("f64"), combined into T1's
    lags w + d and w - d and stored in c64; then stage 2 over u with E0, in
    f32 over 32 ranges and their sum in range order (stage2 "f32"), or in
    f64 ("f64")."""
    ia, ib = torch.as_tensor(np.asarray(ia)), torch.as_tensor(np.asarray(ib))
    A, B = specA[ia], specB[ib]
    ax, ay, bx, by = A.real.to(F64), A.imag.to(F64), B.real.to(F64), B.imag.to(F64)
    hx = _fma(ax, bx, _r32(ay * by))
    hy = _fma(ay, bx, _r32(-ax * by))
    del ax, ay, bx, by
    npairs, N0, N1h = A.shape
    R0, R1 = E0.shape[0], E1.shape[1]
    w = R1 // 2
    ex, ey = E1.real.to(F64)[:, w:], E1.imag.to(F64)[:, w:]
    if stage1 == "f64":
        p1, p2, p3, p4 = (torch.einsum("cuv,ve->cue", h, e)
                          for h, e in ((hx, ex), (hy, ey), (hx, ey), (hy, ex)))
    else:
        acc = [torch.zeros((npairs, N0, w + 1), dtype=F64) for _ in range(4)]
        for v in range(N1h):
            x, y = hx[:, :, v, None], hy[:, :, v, None]
            for q, (h, e) in enumerate(((x, ex[v]), (y, ey[v]), (x, ey[v]), (y, ex[v]))):
                acc[q] = _fma(h, e, acc[q])
        p1, p2, p3, p4 = acc
    Tx = torch.cat([torch.flip(_r32(p1 + p2), dims=(2,))[:, :, :w], _r32(p1 - p2)], dim=2)
    Ty = torch.cat([torch.flip(_r32(p4 - p3), dims=(2,))[:, :, :w], _r32(p3 + p4)], dim=2)
    e0x, e0y = E0.real.to(F64), E0.imag.to(F64)
    if stage2 == "f64":
        out = torch.einsum("ru,cue->cre", e0x, Tx) - torch.einsum("ru,cue->cre", e0y, Ty)
        return out.to(torch.float32)
    chunk = -(-N0 // 32)
    out = torch.zeros((npairs, R0, R1), dtype=F64)
    for s in range(32):
        part = torch.zeros_like(out)
        for u in range(s * chunk, min(N0, (s + 1) * chunk)):
            part = _fma(e0x[:, u, None], Tx[:, u, None, :],
                        _fma(-e0y[:, u, None], Ty[:, u, None, :], part))
        out = _r32(out + part)
    return out.to(torch.float32)


def setup(n):
    I, J = chip_smoke.make_pair(n)
    rng = np.random.default_rng(10086)
    xy = np.stack([rng.uniform(10.0, n - 10.0, 512), rng.uniform(10.0, n - 10.0, 512)], axis=1)
    kw = dict(KerSpType="B-Spline", KerSpDegree=2,
              KerIntKnotX=[0.5 + n / 3, 0.5 + n * 2 / 3],
              KerIntKnotY=[0.5 + n / 3, 0.5 + n * 2 / 3],
              SEPARATE_SCALING=True, ScaSpType="Polynomial", ScaSpDegree=2,
              BkgSpType="Polynomial", BkgSpDegree=0,
              REGULARIZE_KERNEL=True, XY_REGULARIZE=xy, LAMBDA_REGULARIZE=3e-5)
    return I, J, kw


def rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def trun(cfg, I, J):
    return tengine.solve_and_subtract_same_fn(cfg)(torch.as_tensor(I), torch.as_tensor(J))[1].numpy()


def main_k1(n, hw):
    I, J, kw = setup(n)
    cfg = tmake(n, n, hw, **kw, **FAST)
    d64 = trun(tmake(n, n, hw, **kw), I, J)
    real_cwf, real_cw = greek.corr_window_fft, greek._corr_window
    routes = {"irfft twin": None, "f32 sums": ("f32", "f32"),
              "f32 stage-1 and f64 stage-2 sums": ("f32", "f64"), "f64 sums": ("f64", "f64")}
    for route, sums in routes.items():
        t0 = time.perf_counter()
        if sums:
            greek.corr_window_fft = lambda *a, **k: real_cwf(*a, **{**k, "method": "kernel"})
            greek._corr_window = (lambda A, B, ia, ib, E0, E1, sym, s=sums:
                                  k1_emulated(A, B, ia, ib, E0, E1, *s))
        try:
            d = trun(cfg, I, J)
        finally:
            greek.corr_window_fft, greek._corr_window = real_cwf, real_cw
        print(f"{n}^2 GKerHW {hw} NEQ {cfg.NEQ}: sfft_tpu_torch fft32, K1 {route}: RMS from "
              f"its f64 difference {rms(d, d64):.4e} ({time.perf_counter() - t0:.0f} s)",
              flush=True)


def main(n, hw):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import sfft_tpu  # noqa: F401  (x64)
    from sfft_tpu.api.bspline import make_bspline_config as jmake
    from sfft_tpu.core import engine as jengine

    I, J, kw = setup(n)

    def jrun(cfg):
        s, d = jax.jit(jengine.solve_and_subtract_same_fn(cfg))(jnp.asarray(I), jnp.asarray(J))
        return np.asarray(d)

    t0 = time.perf_counter()
    dj64, dj32 = jrun(jmake(n, n, hw, **kw)), jrun(jmake(n, n, hw, **kw, **FAST))
    cfg = tmake(n, n, hw, **kw, **FAST)
    dt64, dt32 = trun(tmake(n, n, hw, **kw), I, J), trun(cfg, I, J)
    print(f"{n}^2 GKerHW {hw} NEQ {cfg.NEQ} ({time.perf_counter() - t0:.0f} s): RMS of the "
          f"fft32 difference from the same package's f64 difference: sfft_tpu "
          f"{rms(dj32, dj64):.4e}, sfft_tpu_torch {rms(dt32, dt64):.4e}; f64 paths against each "
          f"other {rms(dt64, dj64):.3e}; fft32 differences against each other "
          f"{rms(dt32, dj32):.4e}", flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    k1 = args[:1] == ["--k1"]
    args = args[1:] if k1 else args
    size = int(args[0]) if args else 480
    width = int(args[1]) if len(args) > 1 else 6
    (main_k1 if k1 else main)(size, width)
