"""DAOPHOT MMM sky-level/sigma estimator.

Fresh implementation of the classical DAOPHOT "MMM" (mean/median/mode)
algorithm (Stetson 1987; IDL astrolib `mmm.pro`), the estimator the reference
exposes as SkyLevel_Estimator.SLE (sfft/utils/SkyLevelEstimator.py). Two-phase
method: (1) iteratively shrink/grow a symmetric acceptance window around the
current mode using the Chauvenet criterion, maintaining running sums for the
mean/sigma; (2) estimate the mode as 3*median - 2*mean when the distribution is
positively skewed by stellar contamination.

A copy of sfft_tpu/utils/sky.py (numpy, on the host).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def mmm(
    sky_vector: np.ndarray,
    minsky: int = 20,
    maxiter: int = 50,
) -> Tuple[float, float, float]:
    """Returns (skymod, sigma, skew); sigma = -1.0 on failure."""
    sky = np.asarray(sky_vector, dtype=np.float64).ravel()
    sky = sky[np.isfinite(sky)]
    nsky = sky.size
    if nsky < minsky:
        return np.nan, -1.0, 0.0
    sky = np.sort(sky)
    nlast = nsky - 1

    skymid = 0.5 * sky[(nsky - 1) // 2] + 0.5 * sky[nsky // 2]
    cut = min(skymid - sky[0], sky[-1] - skymid)
    cut1, cut2 = skymid - cut, skymid + cut

    good = np.where((sky >= cut1) & (sky <= cut2))[0]
    if good.size == 0:
        return 0.0, -1.0, 0.0
    delta = sky[good] - skymid
    ssum = float(np.sum(delta))
    ssumsq = float(np.sum(delta**2))
    maximm = int(good.max())
    minimm = int(good.min()) - 1

    skymed = 0.5 * sky[(minimm + maximm + 1) // 2] + 0.5 * sky[(minimm + maximm) // 2 + 1]
    skymn = ssum / (maximm - minimm)
    sigma = np.sqrt(max(ssumsq / (maximm - minimm) - skymn**2, 0.0))
    skymn = skymn + skymid
    skymod = 3.0 * skymed - 2.0 * skymn if skymed < skymn else skymn

    clamp, old = 1.0, 0.0
    for niter in range(maxiter):
        if maximm - minimm < minsky:
            return skymod, -1.0, 0.0

        # Chauvenet rejection radius
        r = np.log10(float(maximm - minimm))
        r = max(2.0, (-0.1042 * r + 1.1695) * r + 0.8895)
        cut = r * sigma + 0.5 * abs(skymn - skymod)
        cut1, cut2 = skymod - cut, skymod + cut

        redo = False
        # ---- adjust lower boundary -----------------------------------
        newmin = minimm
        tst_min = sky[newmin + 1] >= cut1
        done = (newmin == -1) and tst_min
        if not done:
            skyind = max(newmin, 0)
            if (sky[skyind] < cut1) and tst_min:
                done = True
        if not done:
            istep = 1 - 2 * int(tst_min)
            while not done:
                newmin += istep
                if newmin in (-1, nlast):
                    done = True
                elif (sky[newmin] <= cut1) and (sky[newmin + 1] >= cut1):
                    done = True
            if tst_min:
                delta = sky[newmin + 1 : minimm + 1] - skymid
            else:
                delta = sky[minimm + 1 : newmin + 1] - skymid
            ssum -= istep * float(np.sum(delta))
            ssumsq -= istep * float(np.sum(delta**2))
            redo = True
            minimm = newmin

        # ---- adjust upper boundary -----------------------------------
        newmax = maximm
        tst_max = sky[maximm] <= cut2
        done = (maximm == nlast) and tst_max
        if not done:
            skyind = min(maximm + 1, nlast)
            if tst_max and (sky[skyind] > cut2):
                done = True
        if not done:
            istep = -1 + 2 * int(tst_max)
            while not done:
                newmax += istep
                if newmax in (nlast, -1):
                    done = True
                elif (sky[newmax] <= cut2) and (sky[newmax + 1] >= cut2):
                    done = True
            if tst_max:
                delta = sky[maximm + 1 : newmax + 1] - skymid
            else:
                delta = sky[newmax + 1 : maximm + 1] - skymid
            ssum += istep * float(np.sum(delta))
            ssumsq += istep * float(np.sum(delta**2))
            redo = True
            maximm = newmax

        nsky_w = maximm - minimm
        if nsky_w < minsky:
            return skymod, -1.0, 0.0
        skymn = ssum / nsky_w
        sigma = float(np.sqrt(max(ssumsq / nsky_w - skymn**2, 0.0)))
        skymn = skymn + skymid

        # robust median: mean of the central ~20% of accepted pixels
        center = (minimm + 1 + maximm) / 2.0
        side = round(0.2 * (maximm - minimm)) / 2.0 + 0.25
        j = int(round(center - side))
        k = int(round(center + side))
        skymed = float(np.sum(sky[j : k + 1])) / (k - j + 1)

        dmod = (3.0 * skymed - 2.0 * skymn - skymod) if skymed < skymn else (skymn - skymod)
        if dmod * old < 0:
            clamp *= 0.5
        skymod = skymod + clamp * dmod
        old = dmod
        if not redo:
            break
    else:
        return skymod, -1.0, 0.0

    skew = float((skymn - skymod) / max(1.0, sigma))
    return skymod, sigma, skew


class SkyLevelEstimator:
    """Reference SkyLevel_Estimator.SLE equivalent."""

    @staticmethod
    def SLE(PixA_obj: np.ndarray) -> Tuple[float, float]:
        mode, sig, _ = mmm(PixA_obj)
        return mode, sig
