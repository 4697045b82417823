"""Massive-neutrino background thermodynamics from Fermi-Dirac integrals
(port of concept_tpu/cosmology/neutrino.py).

The reference obtains ρ_ν(a), P_ν(a) and hence w_ν(a) from CLASS
(species 'massive neutrino(s)', linear.py:3517-3595; w/w_eff splines
species.py:2940-3526).  Here they are computed directly from the
relativistic Fermi-Dirac distribution — exact background physics with no
Boltzmann code required:

  ρ(a) ∝ T_ν(a)⁴ · F(y),  P(a) ∝ T_ν(a)⁴ · G(y)/3,
  F(y) = ∫ x²√(x²+y²) /(eˣ+1) dx,   G(y) = ∫ x⁴/√(x²+y²) /(eˣ+1) dx,
  y = m c²/(k_B T_ν(a)),  T_ν(a) = (4/11)^{1/3} T_CMB / a.

w(a) = P/ρ = G/(3F): 1/3 deep in the relativistic era, → 0 when
non-relativistic.
"""

from __future__ import annotations


import numpy as np

from concept_tpu_torch.cosmology.spline import Spline

K_B_EV = 8.617333262e-5  # eV/K
T_CMB = 2.7255  # K
T_NU0 = (4.0 / 11.0) ** (1.0 / 3.0) * T_CMB  # K today

_X = None
_W = None


def _quad_nodes(n=256, xmax=50.0):
    global _X, _W
    if _X is None:
        # composite Simpson on [0, xmax] is plenty for these smooth kernels
        x = np.linspace(1e-8, xmax, n)
        w = np.full(n, x[1] - x[0])
        w[0] = w[-1] = w[0] / 2
        _X, _W = x, w
    return _X, _W


def fermi_dirac_F(y):
    """F(y) = ∫ x²√(x²+y²)/(eˣ+1) dx (energy integral)."""
    x, w = _quad_nodes()
    y = np.atleast_1d(np.asarray(y, dtype=np.float64))
    vals = x[None, :] ** 2 * np.sqrt(x[None, :] ** 2 + y[:, None] ** 2) / (
        np.exp(x[None, :]) + 1
    )
    return np.squeeze(vals @ w)


def fermi_dirac_G(y):
    """G(y) = ∫ x⁴/√(x²+y²)/(eˣ+1) dx (pressure integral ×3)."""
    x, w = _quad_nodes()
    y = np.atleast_1d(np.asarray(y, dtype=np.float64))
    vals = x[None, :] ** 4 / np.sqrt(x[None, :] ** 2 + y[:, None] ** 2) / (
        np.exp(x[None, :]) + 1
    )
    return np.squeeze(vals @ w)


class NeutrinoBackground:
    """Background thermodynamics of one massive-neutrino species.

    Provides w(a), w_eff(a) = (1/ln a)∫₀^lna w d ln a' (the reference's
    effective EoS for the comoving density, species.py:2940-3526),
    and Ω_ν today.
    """

    def __init__(self, m_nu_eV: float, N_nu: int = 1):
        self.m_nu_eV = float(m_nu_eV)
        self.N_nu = int(N_nu)
        a_tab = np.logspace(-8, 0.1, 600)
        y = self.m_nu_eV * a_tab / (K_B_EV * T_NU0)
        F = fermi_dirac_F(y)
        G = fermi_dirac_G(y)
        w = G / (3 * F)
        self._w_spline = Spline(a_tab, np.maximum(w, 1e-12), logx=True, logy=True)
        # w_eff(a): ϱ = a^{3(1+w_eff)}ρ constant requires
        # 3(1+w_eff)ln a = ∫ 3(1+w)dln a  ⇒  w_eff = (∫w dln a)/ln a
        lna = np.log(a_tab)
        integ = np.concatenate([[0], np.cumsum(0.5 * (w[1:] + w[:-1]) * np.diff(lna))])
        # anchor the integral at a=1 (ln a = 0): w_eff = ∫_lna^0 w dlna' / (-lna)
        integ_at_1 = np.interp(0.0, lna, integ)
        with np.errstate(divide="ignore", invalid="ignore"):
            w_eff = (integ_at_1 - integ) / (-lna)
        w_eff[lna == 0] = w[lna == 0]
        w_eff = np.clip(w_eff, 1e-12, 1 / 3)
        self._weff_spline = Spline(a_tab, w_eff, logx=True, logy=False)

    def w(self, a):
        return self._w_spline.eval_np(a)

    def w_eff(self, a):
        return self._weff_spline.eval_np(a)

    def rho_ratio_np(self, a):
        """ρ_ν(a)/ρ_ν(a=1) from the comoving-density identity
        ρ(a)·a^{3(1+w_eff(a))} = const (w_eff anchored at a = 1):
        exact ∝ a⁻⁴ relativistic → ∝ a⁻³ non-relativistic crossover."""
        a = np.asarray(a, dtype=np.float64)
        return a ** (-3.0 * (1.0 + self.w_eff(a)))

    def rho_ratio(self, a):
        """:meth:`rho_ratio_np` on a tensor, in its dtype and on its
        device."""
        return a ** (-3.0 * (1.0 + self._weff_spline.eval_torch(a)))

    def omega_nu_h2(self) -> float:
        """Ω_ν h² today.  Non-relativistic limit: Σm/93.14 eV
        (standard result); the exact FD integral reproduces it for
        m ≫ k_B T_ν0 and adds the relativistic correction for small m."""
        # ρ_ν(a=1) = (g/(2π²)) T_ν⁴ F(y)/F_massless · ρ_massless with
        # ρ_massless = (7/8)(4/11)^{4/3} ρ_γ per species;
        # Ω_γ h² = 2.469e-5 (T_CMB = 2.7255)
        y1 = self.m_nu_eV / (K_B_EV * T_NU0)
        F1 = float(fermi_dirac_F(y1))
        F0 = float(fermi_dirac_F(0.0))  # = 7π⁴/120
        omega_gamma_h2 = 2.469e-5
        omega_massless = (7.0 / 8.0) * (4.0 / 11.0) ** (4.0 / 3.0) * omega_gamma_h2
        return self.N_nu * omega_massless * F1 / F0
