"""Linear perturbation theory layer: δ/θ/σ transfer functions per
species, linear power spectra, σ_R — everything the realizer and the
analysis need from a Boltzmann source.

Port of concept_tpu/cosmology/linear.py (reference src/linear.py:
CosmoResults at :56, TransferFunction at :1481, get_linear_powerspec at
:3074).  It combines the background's growth factors with an analytic
transfer function (Eisenstein-Hu; EH99 with massive neutrinos), in
NumPy float64, or, where Boltzmann tables are installed
(cosmology/boltzmann.py), interpolates them: in torch on the device of a
tensor k (the realization's), else on the host.

Normalisation (Newtonian/N-body conventions):
    δ(k, a) = (2/5) · k²c²/(Ωm H0²) · T(k) · D_md(a) · ζ(k)
with T(k→0)=1, D_md(a)=a deep in matter domination, and ζ the primordial
curvature.  Velocity divergence via linear growth:
    θ(k, a) = -a H(a) f1(a) δ(k, a).
"""

from __future__ import annotations

import math

import numpy as np

from concept_tpu_torch.cosmology.background import Background
from concept_tpu_torch.cosmology.primordial import PrimordialSpectrum
from concept_tpu_torch.cosmology.transfer import EisensteinHuNuTransfer, make_transfer


def _species_key(species: str) -> str:
    """Canonical species name for table lookup (reference species registry
    linear.py:3517-3595 canonical names, reduced to what the tables use)."""
    return {
        "m": "matter", "cbnu": "matter", "matter": "matter",
        "cb": "cb", "cdm+baryon": "cb",
        "neutrino": "nu", "massive neutrino": "nu", "nu": "nu",
        "b": "b", "baryon": "b", "cdm": "cdm",
        "photon": "photon", "g": "photon", "ur": "ur",
    }.get(species, species)


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
        Omega_nu: float = 0.0,
        N_nu: int = 3,
        tables=None,
    ):
        self.bg = bg
        self.primordial = primordial
        self.Omega_b = float(Omega_b)
        self.Omega_cdm = float(Omega_cdm)
        self.Omega_nu = float(Omega_nu)
        self.N_nu = int(N_nu)
        self.light_speed = float(light_speed)
        self.Mpc = float(Mpc)
        self.transfer_kind = transfer_kind
        # Boltzmann tables (cosmology/boltzmann.py): where they hold a
        # species, δ/θ/σ interpolate them instead of the analytic
        # formulas — the reference's TransferFunction role (linear.py:1481)
        self.tables = tables
        if self.Omega_nu > 0:
            self._transfer_nu = EisensteinHuNuTransfer(
                self.Omega_m, self.Omega_b, self.Omega_nu,
                h=self._infer_h(), N_nu=N_nu, Mpc=self.Mpc,
            )
            self._transfer = self._transfer_nu.master
        else:
            self._transfer_nu = None
            self._transfer = make_transfer(
                transfer_kind, self.Omega_b + self.Omega_cdm, self.Omega_b,
                h=self._infer_h(), Mpc=self.Mpc,
            )

    def _infer_h(self) -> float:
        """h = H0 / (100 km/s/Mpc), with km/s = c_internal/299792.458."""
        km_per_s = self.light_speed / 299792.458
        H100 = 100 * km_per_s / self.Mpc
        return self.bg.H0 / H100

    @property
    def Omega_m(self) -> float:
        return self.Omega_b + self.Omega_cdm + self.Omega_nu

    def _table(self, species: str, var: str, k, a):
        """The installed table of (species, var) at (k, a), or None."""
        if self.tables is not None:
            key = _species_key(species)
            if self.tables.has(key, var):
                return self.tables.interp(key, var, k, a)
        return None

    def transfer_T(self, k):
        """Shape transfer function T(k) → 1 at low k."""
        return self._transfer(k)

    def transfer_delta(self, k, a, species: str = "matter"):
        """δ_species(k,a) per unit primordial curvature ζ (the 'transfer
        function' in the reference's sense, linear.py:1481).

        species: 'matter' (total, = cb+ν), 'cb' (CDM+baryons — what
        particles represent in a ν simulation), 'nu' (massive neutrinos),
        'radiation'/'photon'/'ur'.  Massive-ν scale-dependent growth via
        EH99 (transfer.EisensteinHuNuTransfer).
        """
        tab = self._table(species, "delta", k, a)
        if tab is not None:
            return tab
        k = np.asarray(k, dtype=np.float64)
        c = self.light_speed
        D_md = self.bg.growth_np("D1", a) * self.bg.D_md_today
        base = (
            (2.0 / 5.0)
            * (k * k * c * c / (self.Omega_m * self.bg.H0**2))
            * self.transfer_T(k)
            * D_md
        )
        if species in ("radiation", "photon", "ur"):
            return self._transfer_radiation(k, a, base)
        if self._transfer_nu is None or species == "matter" and self.Omega_nu == 0:
            return base
        tnu = self._transfer_nu
        if species in ("matter", "m", "cbnu"):
            return base * tnu.growth_ratio(k, D_md, "cbnu")
        if species == "cb":
            return base * tnu.growth_ratio(k, D_md, "cb")
        if species in ("nu", "neutrino", "massive neutrino"):
            f_nu, f_cb = tnu.f_nu, tnu.f_cb
            d_m = base * tnu.growth_ratio(k, D_md, "cbnu")
            d_cb = base * tnu.growth_ratio(k, D_md, "cb")
            return (d_m - f_cb * d_cb) / f_nu
        raise ValueError(f"unknown species {species!r}")

    def _transfer_radiation(self, k, a, delta_m):
        """Radiation δ in the matter era: (4/3)δ_m on super-horizon scales,
        suppressed inside the horizon (free-streaming/oscillation damping).

        APPROXIMATION: a Lorentzian² horizon cut at k_H = aH/c stands in
        for the Boltzmann-hierarchy result; Boltzmann tables replace it
        (the reference always gets δ_γ from CLASS, linear.py:3517-3595 —
        there is no analytic fit in the reference either).  Adequate for
        the GR-correction role of the linear radiation component
        (corrections are O((k_H/k)²) themselves)."""
        k_H = a * self.bg.hubble_np(a) / self.light_speed
        x2 = (k / k_H) ** 2
        return (4.0 / 3.0) * delta_m / (1.0 + x2) ** 2

    def transfer_theta(self, k, a, species: str = "matter"):
        """θ(k,a) per unit ζ.  Tabulated when tables are installed;
        otherwise the linear continuity closure θ = -a H f1 δ."""
        tab = self._table(species, "theta", k, a)
        if tab is not None:
            return tab
        aHf = a * self.bg.hubble_np(a) * self.bg.growth_np("f1", a)
        return -aHf * self.transfer_delta(k, a, species)

    def transfer_sigma(self, k, a, species: str = "nu"):
        """Anisotropic-stress (shear) transfer σ(k, a) per unit ζ, from
        the installed Boltzmann tables (CLASS/EB velocity-potential
        convention); None without species-resolved tables (the analytic
        EH layer carries no σ — the reference always sources σ from
        CLASS, linear.py:2877)."""
        return self._table(species, "sigma", k, a)

    def power_delta(self, k, a, species: str = "matter"):
        """Linear power spectrum P(k, a) (internal units³)."""
        T = self.transfer_delta(k, a, species)
        return T * T * self.primordial.zeta_power(k)

    def delta_amplitude(self, k, a, species: str = "matter"):
        """√P_δ — the realization amplitude (reference ic.py:542)."""
        return abs(self.transfer_delta(k, a, species)) * self.primordial.zeta_amplitude(k)

    def sigma_R(self, R, a=1.0, nk: int = 1024):
        """σ(R): rms of the density field smoothed with a tophat of radius
        R (reference analysis.py:856), by quadrature in log k over the
        matter power (the installed tables' where there are tables)."""
        kmin = 1e-5 / self.Mpc
        kmax = 1e3 / self.Mpc
        lnk = np.linspace(math.log(kmin), math.log(kmax), nk)
        k = np.exp(lnk)
        x = k * R
        W = 3 * (np.sin(x) - x * np.cos(x)) / x**3
        P = np.asarray(self.power_delta(k, a), np.float64)
        integrand = k**3 * P * W * W / (2 * math.pi**2)
        return math.sqrt(np.trapezoid(integrand, lnk))

    def sigma8(self, a=1.0):
        return self.sigma_R(8 / self.h_value * self.Mpc, a)

    @property
    def h_value(self) -> float:
        return self._infer_h()
