"""Tikhonov kernel regularization (counterpart of sfft_tpu/core/regularize.py).

Only the unregularized case (lambda = 0, the default of every polynomial
config) is ported: it adds nothing to the system. Regularized configs belong
to the v2 engine, which is not ported yet.
"""

from __future__ import annotations

from sfft_tpu_torch.config import SFFTConfig


def regularization_terms(cfg: SFFTConfig):
    """lambda * REGMAT as Kronecker factors [(M, R)], or None when
    regularization is off."""
    if cfg.regularize_lambda == 0.0 or not cfg.reg_xy:
        return None
    raise NotImplementedError(
        "Tikhonov regularization (regularize_lambda > 0) belongs to the v2 "
        "engine, which is not ported to sfft_tpu_torch yet (ROADMAP queue 1, v2 engine)")
