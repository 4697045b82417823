"""Recombination history x_e(a): Saha + Peebles effective three-level atom.

A copy of concept_tpu/cosmology/recombination.py (host numpy/scipy, no
JAX in it), kept so that the port imports nothing of the JAX package.

The internal Einstein-Boltzmann solver (cosmology/ebsolver.py) needs the
free-electron fraction for the Thomson opacity κ̇ = a nₑ σ_T and the
baryon sound speed.  The reference delegates this to CLASS's embedded
HyRec/RECFAST (commons.py:4647 call_class); here the standard
Peebles (1968) effective three-level atom with the RECFAST case-B fudge
gives x_e to ~1% — more than enough for the few-% transfer-function
accuracy this backend targets (the reference's own ν tests allow
0.04–0.11 relative, test/neutrino/analyze.py:165).

Everything runs in SI-free "Mpc units": lengths in Mpc, times in Mpc/c,
temperatures in K.  The module is pure host-side numpy/scipy.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.integrate import solve_ivp

# ---- constants (SI, converted below) -------------------------------- #
_C = 2.99792458e8            # m/s
_MPC = 3.0856775814913673e22  # m
_K_B = 1.380649e-23           # J/K
_HBAR = 1.054571817e-34       # J s
_M_E = 9.1093837015e-31       # kg
_M_H = 1.6735575e-27          # kg
_SIGMA_T = 6.6524587321e-29   # m^2
_EV = 1.602176634e-19         # J

E_ION_H = 13.605693122994 * _EV   # H ionisation energy, J
E_2S = E_ION_H / 4.0              # n=2 level
E_ALPHA = E_ION_H - E_2S          # Lyman-alpha energy
LAMBDA_2S_1S = 8.227              # s^-1, 2s->1s two-photon rate
E_ION_HE1 = 24.587387 * _EV       # He I first ionisation
E_ION_HE2 = 54.417760 * _EV       # He II


def alpha_B(T):
    """Case-B recombination coefficient, m^3/s (RECFAST fit, Peebles
    fudge 1.14 included)."""
    T4 = T / 1e4
    return 1.14 * 4.309e-19 * T4**-0.6166 / (1 + 0.6703 * T4**0.5300)


def beta_ion(T):
    """Photo-ionisation rate from n=2, s^-1 (detailed balance with
    alpha_B)."""
    lam_th3 = (2 * math.pi * _M_E * _K_B * T / _HBAR**2 / (2 * math.pi) ** 2)
    # (m_e k T / (2 pi hbar^2))^{3/2}
    pref = (_M_E * _K_B * T / (2 * math.pi * _HBAR**2)) ** 1.5
    return alpha_B(T) * pref * np.exp(-E_2S / (_K_B * T))


class Recombination:
    """x_e(a) and derived opacity for a flat ΛCDM-like background.

    Parameters: h, Omega_b, T_cmb [K], Y_p (He mass fraction), and a
    callable H_of_a returning H in 1/ (Mpc/c) units (i.e. aH in c=1 Mpc
    units)."""

    def __init__(self, h, Omega_b, H_of_a, T_cmb=2.7255, Y_p=0.245):
        self.h = float(h)
        self.Omega_b = float(Omega_b)
        self.T_cmb = float(T_cmb)
        self.Y_p = float(Y_p)
        self.H_of_a = H_of_a
        # critical density today, kg/m^3
        H0_SI = 100.0 * self.h * 1e3 / _MPC
        rho_crit = 3 * H0_SI**2 / (8 * math.pi * 6.67430e-11)
        self.n_H0 = (1 - self.Y_p) * self.Omega_b * rho_crit / _M_H  # m^-3
        self.f_He = self.Y_p / (4 * (1 - self.Y_p))  # n_He/n_H
        self._tabulate()

    # ---------------------------------------------------------------- #
    def _saha_xe(self, a):
        """Equilibrium x_e (relative to n_H) from coupled H/He Saha."""
        T = self.T_cmb / a
        n_H = self.n_H0 / a**3
        kT = _K_B * T
        pref = (_M_E * kT / (2 * math.pi * _HBAR**2)) ** 1.5

        def saha_R(E):  # n_e n_+ / n_0 = R
            arg = -E / kT
            return pref * np.exp(max(arg, -500.0))

        R_H = saha_R(E_ION_H)
        R_He1 = 4 * saha_R(E_ION_HE1)
        R_He2 = saha_R(E_ION_HE2)
        # iterate n_e
        x_e = 1.0 + 2 * self.f_He
        for _ in range(60):
            n_e = x_e * n_H
            xH = R_H / (R_H + n_e)
            xHe2 = 1.0 / (1 + n_e / R_He2 + n_e**2 / (R_He2 * R_He1))
            xHe1 = (n_e / R_He2) * xHe2
            x_new = xH + self.f_He * (xHe1 + 2 * xHe2)
            if abs(x_new - x_e) < 1e-12:
                break
            x_e = 0.5 * (x_e + x_new)
        return x_e

    def _tabulate(self):
        """Saha down to x_e(H) = 0.985, then the Peebles ODE."""
        a_grid = np.logspace(-8, 0, 4000)
        xe = np.empty_like(a_grid)
        i_switch = None
        for i, a in enumerate(a_grid):
            xe[i] = self._saha_xe(a)
            if xe[i] < 1.0 + 2 * self.f_He - 0.02 and xe[i] < 1.02:
                # He done, H starting to recombine: Saha still fine until
                # departure; switch just before
                if xe[i] < 0.985:
                    i_switch = i
                    break
        if i_switch is None:
            i_switch = len(a_grid) - 1

        def rhs(lna, y):
            a = math.exp(lna)
            x = y[0]
            T = self.T_cmb / a  # T_b ~ T_gamma (tight Compton coupling)
            n_H = self.n_H0 / a**3
            H_SI = self.H_of_a(a) * _C / _MPC  # 1/s
            aB = alpha_B(T)
            bI = beta_ion(T)
            # Peebles C factor
            n_1s = (1 - x) * n_H
            lam_alpha = 2 * math.pi * _HBAR * _C / E_ALPHA  # m
            K = lam_alpha**3 / (8 * math.pi * H_SI)
            C = (1 + K * LAMBDA_2S_1S * n_1s) / (
                1 + K * (LAMBDA_2S_1S + bI) * n_1s
            )
            kT = _K_B * T
            x_sq = np.clip(x, 0.0, 2.0)
            dxdt = -C * (
                aB * x_sq * x_sq * n_H
                - bI * (1 - x_sq) * np.exp(-E_ALPHA / kT)
            )
            return [dxdt / H_SI]

        a0 = a_grid[i_switch]
        # start from Saha H value + frozen He contribution
        xH0 = xe[i_switch] - 0.0
        sol = solve_ivp(
            rhs, (math.log(a0), 0.0), [xH0],
            method="LSODA", rtol=1e-8, atol=1e-10, dense_output=True,
        )
        lna_tab = np.linspace(math.log(a0), 0.0, 2000)
        xe_tab = sol.sol(lna_tab)[0]
        self._lna = np.concatenate([np.log(a_grid[: i_switch + 1]), lna_tab[1:]])
        self._xe = np.concatenate([xe[: i_switch + 1], xe_tab[1:]])
        # guard monotone sanity
        self._xe = np.clip(self._xe, 1e-5, 1.0 + 2 * self.f_He)

    # ---------------------------------------------------------------- #
    def x_e(self, a):
        return np.interp(np.log(np.asarray(a, float)), self._lna, self._xe)

    def kappa_dot(self, a):
        """dκ/dτ = a nₑ σ_T in 1/Mpc (conformal Thomson opacity)."""
        a = np.asarray(a, float)
        n_e = self.x_e(a) * self.n_H0 / a**3  # m^-3
        return a * n_e * _SIGMA_T * _MPC

    def cs2_baryon(self, a):
        """Baryon sound speed squared, units of c² (T_b = T_γ approx,
        adiabatic index 5/3: c_s² = kT/(μ m_H)·(1 − 1/3 dlnT/dlna))."""
        a = np.asarray(a, float)
        T = self.T_cmb / a
        mu_inv = (1 - self.Y_p) * (1 + self.x_e(a)) + self.Y_p / 4
        # dlnT/dlna = -1 while Compton-coupled
        return _K_B * T * mu_inv / (_M_H * _C**2) * (4.0 / 3.0)
