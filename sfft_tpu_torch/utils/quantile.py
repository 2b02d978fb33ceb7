"""Weighted quantiles with optional top-weight flattening.

Reference: sfft/utils/WeightedQuantile.py (Weighted_Quantile.WQ and
TopFlatten_Weighted_Quantile.TFWQ). The top-flatten variant clips weights at
the NUM_TOP_END-th largest so a few very bright sources cannot dominate
flux-weighted medians.

A copy of sfft_tpu/utils/quantile.py (numpy, on the host).
"""

from __future__ import annotations

import warnings

import numpy as np


class WeightedQuantile:
    @staticmethod
    def WQ(values, weights, quantiles, values_sorted=False, old_style=False):
        values = np.asarray(values, dtype=np.float64)
        quantiles = np.asarray(quantiles, dtype=np.float64)
        if weights is None:
            weights = np.ones(len(values))
        weights = np.asarray(weights, dtype=np.float64)
        assert np.all(quantiles >= 0) and np.all(quantiles <= 1)

        if not values_sorted:
            sorter = np.argsort(values)
            values = values[sorter]
            weights = weights[sorter]

        wq = np.cumsum(weights) - 0.5 * weights
        if old_style:
            wq -= wq[0]
            wq /= wq[-1]
        else:
            wq /= np.sum(weights)
        return np.interp(quantiles, wq, values)


class TopFlattenWeightedQuantile:
    @staticmethod
    def TFWQ(values, weights, quantiles, NUM_TOP_END=30):
        assert len(values) > 0
        if len(values) <= NUM_TOP_END:
            warnings.warn(
                "MeLOn WARNING: CALCULATING WEIGHTED QUANTILES --- "
                f"USE UNIFORM-WEIGHTED MEDIAN OVER [{len(values)}] SAMPLES!"
            )
            return np.percentile(values, np.asarray(quantiles))
        w = np.asarray(weights, dtype=np.float64)
        flat = np.clip(w / np.sort(w)[-NUM_TOP_END], 0.0, 1.0)
        return WeightedQuantile.WQ(values=values, weights=flat,
                                   quantiles=quantiles)
