"""Linear perturbation theory layer in NumPy float64: δ transfer
functions, the linear power spectrum and σ_R, on the analytic
Eisenstein-Hu path.

Port of concept_tpu/cosmology/linear.py (reference src/linear.py).
Normalisation (Newtonian/N-body conventions):
    δ(k, a) = (2/5) · k²c²/(Ωm H0²) · T(k) · D_md(a) · ζ(k)
with T(k→0)=1, D_md(a)=a deep in matter domination, and ζ the primordial
curvature.  Tabulated Boltzmann backends, massive neutrinos and the
non-matter species are not ported yet (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import math

import numpy as np

from concept_tpu_torch.cosmology.background import Background
from concept_tpu_torch.cosmology.primordial import PrimordialSpectrum
from concept_tpu_torch.cosmology.transfer import make_transfer

SPECIES_ITEM = "ROADMAP Queue 1 item 5: species-resolved linear layer"


class LinearCosmology:
    def __init__(
        self,
        bg: Background,
        primordial: PrimordialSpectrum,
        Omega_b: float,
        Omega_cdm: float,
        light_speed: float,
        Mpc: float = 1.0,
        transfer_kind: str = "eisenstein_hu",
    ):
        self.bg = bg
        self.primordial = primordial
        self.Omega_b = float(Omega_b)
        self.Omega_cdm = float(Omega_cdm)
        self.light_speed = float(light_speed)
        self.Mpc = float(Mpc)
        self.transfer_kind = transfer_kind
        self._transfer = make_transfer(
            transfer_kind, self.Omega_m, self.Omega_b,
            h=self._infer_h(), Mpc=self.Mpc,
        )

    def _infer_h(self) -> float:
        """h = H0 / (100 km/s/Mpc), with km/s = c_internal/299792.458."""
        km_per_s = self.light_speed / 299792.458
        H100 = 100 * km_per_s / self.Mpc
        return self.bg.H0 / H100

    @property
    def Omega_m(self) -> float:
        return self.Omega_b + self.Omega_cdm

    def transfer_T(self, k):
        """Shape transfer function T(k) → 1 at low k."""
        return self._transfer(k)

    def transfer_delta(self, k, a, species: str = "matter"):
        """δ(k, a) per unit primordial curvature ζ (total matter)."""
        if species not in ("matter", "m", "cbnu"):
            raise NotImplementedError(f"species {species!r} ({SPECIES_ITEM})")
        k = np.asarray(k, dtype=np.float64)
        c = self.light_speed
        D_md = self.bg.growth_np("D1", a) * self.bg.D_md_today
        return (
            (2.0 / 5.0)
            * (k * k * c * c / (self.Omega_m * self.bg.H0**2))
            * self.transfer_T(k)
            * D_md
        )

    def power_delta(self, k, a, species: str = "matter"):
        """Linear power spectrum P(k, a) (internal units³)."""
        T = self.transfer_delta(k, a, species)
        return T * T * self.primordial.zeta_power(k)

    def delta_amplitude(self, k, a, species: str = "matter"):
        """√P_δ — the realization amplitude (reference ic.py:542)."""
        return (np.abs(self.transfer_delta(k, a, species))
                * self.primordial.zeta_amplitude(k))

    def sigma_R(self, R, a=1.0, nk: int = 1024):
        """σ(R): rms of the density field smoothed with a tophat of radius
        R (reference analysis.py:856), by quadrature in log k."""
        kmin = 1e-5 / self.Mpc
        kmax = 1e3 / self.Mpc
        lnk = np.linspace(math.log(kmin), math.log(kmax), nk)
        k = np.exp(lnk)
        x = k * R
        W = 3 * (np.sin(x) - x * np.cos(x)) / x**3
        P = self.power_delta(k, a)
        integrand = k**3 * P * W * W / (2 * math.pi**2)
        return math.sqrt(np.trapezoid(integrand, lnk))

    def sigma8(self, a=1.0):
        return self.sigma_R(8 / self.h_value * self.Mpc, a)

    @property
    def h_value(self) -> float:
        return self._infer_h()
