"""Primordial curvature perturbation spectrum.

Reference parity: src/linear.py:3329 (get_primordial_curvature_perturbation):
  P_ζ(k) = 2π²/k³ · A_s (k/k_pivot)^(n_s-1+½α_s ln(k/k_pivot))
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PrimordialSpectrum:
    A_s: float = 2.1e-9
    n_s: float = 0.96
    alpha_s: float = 0.0
    pivot: float = 0.05  # in units of 1/Mpc by convention; store in internal units

    def zeta_power(self, k):
        """P_ζ(k); k in the same (internal) units as self.pivot."""
        k = np.asarray(k)
        lnkp = np.log(k / self.pivot)
        exponent = self.n_s - 1.0 + 0.5 * self.alpha_s * lnkp
        return (2 * math.pi**2) / k**3 * self.A_s * np.exp(exponent * lnkp)

    def zeta_amplitude(self, k):
        """√P_ζ(k)."""
        return np.sqrt(self.zeta_power(k))
