"""Mutual-nearest-neighbor matching (reference Symmetric_Match /
Sky_Symmetric_Match, sfft/utils/SymmetricMatch.py).

A copy of sfft_tpu/utils/match.py (numpy, on the host).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial import cKDTree


class SymmetricMatch:
    @staticmethod
    def SM(XY_A: np.ndarray, XY_B: np.ndarray, tol: float,
           return_distance: bool = False):
        """Pairs <a, b> that are mutually nearest within tol.
        Returns (N, 2) index pairs [idx_A, idx_B] (+ distances)."""
        NUM_A, NUM_B = XY_A.shape[0], XY_B.shape[0]
        dist_a, idx_a = cKDTree(XY_B).query(XY_A, k=1, distance_upper_bound=tol)
        dist_b, idx_b = cKDTree(XY_A).query(XY_B, k=1, distance_upper_bound=tol)

        A, B, D = [], [], []
        if NUM_A < NUM_B:
            for i in np.where(idx_a < NUM_B)[0]:
                j = idx_a[i]
                if idx_b[j] == i:
                    A.append(i)
                    B.append(j)
                    D.append(dist_a[i])
        else:
            for v in np.where(idx_b < NUM_A)[0]:
                u = idx_b[v]
                if idx_a[u] == v:
                    A.append(u)
                    B.append(v)
                    D.append(dist_b[v])
        symm = np.array([A, B]).T if A else np.empty((0, 2), int)
        if return_distance:
            return symm, np.array(D)
        return symm


class SkySymmetricMatch:
    @staticmethod
    def SSM(RD_A: np.ndarray, RD_B: np.ndarray, tol: float,
            return_distance: bool = False):
        """Mutual match on sky coordinates (deg); tol in arcsec. Implemented
        on the unit sphere so it is exact at poles/RA wrap (the reference uses
        astropy match_coordinates_sky)."""

        def unit(rd):
            ra = np.radians(rd[:, 0])
            dec = np.radians(rd[:, 1])
            return np.stack(
                [np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra), np.sin(dec)],
                axis=1,
            )

        chord = 2.0 * np.sin(np.radians(tol / 3600.0) / 2.0)
        out = SymmetricMatch.SM(unit(RD_A), unit(RD_B), chord,
                                return_distance=return_distance)
        if return_distance:
            symm, chords = out
            ang = 2.0 * np.arcsin(np.clip(chords / 2.0, 0, 1))
            return symm, np.degrees(ang) * 3600.0
        return out
