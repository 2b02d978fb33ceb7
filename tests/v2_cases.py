"""The v2-engine configurations shared by the tests/test_torch_v2_*.py files:
the five of tests/test_v2_engine.py (B-spline / polynomial bases in the three
scaling modes) and a Tikhonov-regularized B-spline case shaped like the
NIRCam configuration (degree-2 B-spline kernel, SEPARATE-VARYING degree-2
polynomial scaling, degree-0 background, lambda = 3e-5 on seeded points)."""

import dataclasses

import numpy as np

from sfft_tpu.config import BasisSpec as JB, SFFTConfig as JC

from sfft_tpu_torch.config import config_from_fields

import test_v2_engine

N0, N1 = 40, 36


def reg_points(seed=10086, n=24):
    rng = np.random.default_rng(seed)
    return tuple((float(x), float(y)) for x, y in
                 np.stack([rng.uniform(4.0, N0 - 4.0, n), rng.uniform(4.0, N1 - 4.0, n)], axis=1))


CASES = {
    "separate_constant_poly": dict(scaling_basis=JB("polynomial", 0)),
    "separate_varying_poly": dict(kernel_basis=JB("polynomial", 2),
                                  scaling_basis=JB("polynomial", 1)),
    "bspline_entangled": dict(kernel_basis=JB("bspline", 2, (20.0,), (18.0,)),
                              bg_basis=JB("polynomial", 1), const_phot_ratio=False),
    "bspline_separate_constant": dict(kernel_basis=JB("bspline", 2, (20.0,), (18.0,)),
                                      bg_basis=JB("polynomial", 1),
                                      scaling_basis=JB("polynomial", 0)),
    "bspline_separate_varying": dict(kernel_basis=JB("bspline", 2, (20.0,), (18.0,)),
                                     bg_basis=JB("bspline", 1, (20.0,), ()),
                                     scaling_basis=JB("bspline", 1, (), ())),
    "bspline_tikhonov": dict(w0=2, w1=2, kernel_basis=JB("bspline", 2, (20.0,), (18.0,)),
                             bg_basis=JB("polynomial", 0), scaling_basis=JB("polynomial", 2),
                             regularize_lambda=3e-5, reg_xy=reg_points()),
}


def configs(name, **backends):
    """(sfft_tpu config, sfft_tpu_torch config) of one case from the same
    fields."""
    kw = dict(N0=N0, N1=N1, w0=1, w1=1)
    kw.update(CASES[name])
    jc = JC(**kw, **backends)
    return jc, config_from_fields(dataclasses.asdict(jc))


def make_pair(seed=1):
    """tests/test_v2_engine.py's pair from its own seed."""
    return test_v2_engine.make_pair(np.random.default_rng(seed), N0, N1)
