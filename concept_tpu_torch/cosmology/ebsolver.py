"""Internal linear Einstein-Boltzmann solver (synchronous gauge).

A copy of concept_tpu/cosmology/ebsolver.py (host numpy/scipy, no JAX in
it): the port keeps its own so that it imports nothing of the JAX
package.  The table key (:func:`table_key`) is the JAX module's, so a
table solved by either package serves the other from a shared cache
directory.

The reference embeds CLASS for its linear layer (commons.py:4647
call_class; linear.py:56-1480 CosmoResults).  Without classy this
module is the Boltzmann backend: it integrates
the full linear Einstein-Boltzmann system — photons (with polarization),
baryons (Saha+Peebles recombination, cosmology/recombination.py),
cold dark matter, massless neutrinos, and momentum-resolved massive
neutrinos — per Fourier mode in synchronous gauge, following
Ma & Bertschinger (1995; MB95) conventions, and tabulates δ/θ/δP/σ per
species per unit comoving curvature ζ into a
cosmology.boltzmann.TransferTables (the same container the CLASS bridge
fills, so everything downstream — realization, gauge transforms, metric/
lapse species, linear power — is backend-agnostic).

Gauge bookkeeping for the GR species (reference linear.py:824-985):
the N-body-gauge H_T is three times the comoving curvature perturbation,

    H_T^{Nb} = 3ℛ,   ℛ = η + ℋ θ_tot / k²   (synchronous quantities)

(ℛ is exactly conserved in a pure-matter universe — θ_cdm ≡ 0 and
η' ∝ θ_tot — so H_Tʹ and with it the GR correction γ vanish there, which
is the defining property of the N-body gauge).  φ and ψ follow from the
standard synchronous→longitudinal transformation with
α = (h' + 6η')/(2k²) (MB95 eq 18).

Everything here is host-side numpy/scipy: the solver runs once per
cosmology (minutes), is disk-cached like the reference's .reusable/class
HDF5 (commons.py:5593), and feeds static tables to the realizer.

Internal units: lengths in Mpc, c = 1 (times in Mpc), densities in units
of the critical density today.  The TransferTables boundary converts to
framework units.
"""

from __future__ import annotations

import hashlib
import math
import os
from dataclasses import dataclass, field

import numpy as np
from scipy.integrate import solve_ivp

from concept_tpu_torch.cosmology.recombination import Recombination

_H0_UNIT = 1.0 / 2997.92458  # H0 = h * this, in 1/Mpc (c=1)
K_B_EV = 8.617333262e-5
T_NU_FAC = (4.0 / 11.0) ** (1.0 / 3.0)


# --------------------------------------------------------------------- #
# Fermi-Dirac momentum quadrature (Stieltjes on the FD weight q²/(e^q+1))
# --------------------------------------------------------------------- #
def fd_quadrature(n_q: int = 8, q_max: float = 40.0):
    """Gauss quadrature nodes/weights for ∫₀^∞ g(q) q²/(e^q+1) dq ≈
    Σ wᵢ g(qᵢ), built by the (stable) discretized Stieltjes procedure.
    CLASS uses the same idea with ~5 optimized points
    (quadrature_strategy); n_q = 8 is accurate to ~1e-10 for the smooth
    ε-kernels involved."""
    m = 4000
    x = np.linspace(1e-6, q_max, m)
    w = np.gradient(x) * x**2 / (np.exp(x) + 1.0)
    # Lanczos/Stieltjes: build Jacobi recurrence wrt discrete measure
    alpha = np.zeros(n_q)
    beta = np.zeros(n_q)
    p_prev = np.zeros(m)
    p = np.ones(m)
    norm = np.sum(w * p * p)
    for j in range(n_q):
        alpha[j] = np.sum(w * x * p * p) / norm
        if j == n_q - 1:
            break
        p_next = (x - alpha[j]) * p - (beta[j] if j > 0 else 0.0) * p_prev
        norm_next = np.sum(w * p_next * p_next)
        beta[j + 1] = norm_next / norm
        p_prev, p, norm = p, p_next, norm_next
    J = np.diag(alpha) + np.diag(np.sqrt(beta[1:]), 1) + np.diag(
        np.sqrt(beta[1:]), -1
    )
    nodes, vecs = np.linalg.eigh(J)
    mu0 = np.sum(np.gradient(x) * x**2 / (np.exp(x) + 1.0))
    weights = mu0 * vecs[0] ** 2
    return nodes, weights


# --------------------------------------------------------------------- #
@dataclass
class EBParams:
    h: float = 0.67
    Omega_b: float = 0.049
    Omega_cdm: float = 0.27
    T_cmb: float = 2.7255
    N_ur: float = 3.046          # massless neutrino species
    m_ncdm: float = 0.0          # eV, per massive species (degenerate)
    N_ncdm: int = 0              # number of massive species
    Y_p: float = 0.245
    # exotic sectors (reference gets these via class_params →  CLASS,
    # linear.py:3517-3595): curvature enters H(a) only (perturbations
    # stay flat — O(K/k²) corrections neglected, valid for |Ωk| ≲ 0.05
    # at sub-horizon k); CPL fluid w(a) = w0 + wa(1−a) with rest-frame
    # c_s² = 1; decaying cold dark matter → dark radiation with Γ in
    # 1/Mpc (c = 1)
    Omega_k: float = 0.0
    Omega_fld: float = 0.0
    w0_fld: float = -1.0
    wa_fld: float = 0.0
    Omega_dcdm: float = 0.0
    Gamma_dcdm: float = 0.0
    # hierarchy truncations
    l_max_g: int = 12
    l_max_pol: int = 10
    l_max_ur: int = 14
    l_max_ncdm: int = 8
    l_max_dr: int = 14
    n_q: int = 8

    def key(self) -> str:
        s = "|".join(
            f"{v:.10g}" if isinstance(v, float) else str(v)
            for v in (
                self.h, self.Omega_b, self.Omega_cdm, self.T_cmb,
                self.N_ur, self.m_ncdm, self.N_ncdm, self.Y_p,
                self.l_max_g, self.l_max_pol, self.l_max_ur,
                self.l_max_ncdm, self.n_q,
                self.Omega_k, self.Omega_fld, self.w0_fld, self.wa_fld,
                self.Omega_dcdm, self.Gamma_dcdm, self.l_max_dr,
            )
        )
        return hashlib.sha256(s.encode()).hexdigest()[:16]


class EBBackground:
    """Flat FLRW background in Mpc units (c=1), densities / ρ_crit,0."""

    def __init__(self, p: EBParams):
        self.p = p
        h = p.h
        self.H0 = h * _H0_UNIT
        self.Omega_g = 2.4729e-5 / h**2 * (p.T_cmb / 2.7255) ** 4
        self.Omega_ur = p.N_ur * (7.0 / 8.0) * T_NU_FAC**4 * self.Omega_g
        self.q, self.wq = fd_quadrature(p.n_q)
        self.dlnf0 = -self.q / (1.0 + np.exp(-self.q))  # dln f0/dln q
        # T_nu0 in eV
        self.T_nu0_eV = K_B_EV * T_NU_FAC * p.T_cmb
        if p.N_ncdm > 0 and p.m_ncdm > 0:
            self.y0 = p.m_ncdm / self.T_nu0_eV  # = a m/T at a=1
            # rho_ncdm(a)/rho_crit = C * a^-4 * Irho(y(a)); fix C from
            # standard relativistic normalization: one relativistic
            # ncdm species carries (7/8)(4/11)^{4/3} Omega_g
            self._I0 = self._I_rho(0.0)
            self.C_ncdm = (
                p.N_ncdm * (7.0 / 8.0) * T_NU_FAC**4 * self.Omega_g / self._I0
            )
            self.Omega_ncdm = self.C_ncdm * self._I_rho(self.y0)
        else:
            self.y0 = 0.0
            self.C_ncdm = 0.0
            self.Omega_ncdm = 0.0
        self.Omega_m = p.Omega_b + p.Omega_cdm
        self.has_fld = bool(p.Omega_fld)
        # w = −1 exactly is Λ: no fld perturbations (PPF crossing of
        # w = −1 not supported — CLASS has the same fld restriction)
        self.has_fld_pert = self.has_fld and not (
            p.w0_fld == -1.0 and p.wa_fld == 0.0
        )
        self.has_dcdm = bool(p.Omega_dcdm)
        self.Omega_dr = 0.0
        self._lna_dcdm = None
        if self.has_dcdm:
            self._solve_dcdm()  # fills Omega_dr, Omega_dcdm-consistent u,v
            self.Omega_L = 1.0 - (
                self.Omega_m + self.Omega_g + self.Omega_ur
                + self.Omega_ncdm + p.Omega_k + p.Omega_fld
                + p.Omega_dcdm + self.Omega_dr
            )
        else:
            self.Omega_L = 1.0 - (
                self.Omega_m + self.Omega_g + self.Omega_ur
                + self.Omega_ncdm + p.Omega_k + p.Omega_fld
            )
        self.rec = Recombination(
            h, p.Omega_b, lambda a: self.H(a), T_cmb=p.T_cmb, Y_p=p.Y_p
        )

    # ------------------------------------------------------------ #
    def rho_fld(self, a):
        """ρ̄_fld(a)/ρ_crit,0 for the CPL fluid (closed form)."""
        p = self.p
        return p.Omega_fld * a ** (-3 * (1 + p.w0_fld + p.wa_fld)) * math.exp(
            -3 * p.wa_fld * (1 - a)
        )

    def w_fld(self, a):
        return self.p.w0_fld + self.p.wa_fld * (1 - a)

    def _solve_dcdm(self):
        """dcdm → dr background in Mpc units: u ≡ (ρ_dcdm/ρ_cr0)a³,
        v ≡ (ρ_dr/ρ_cr0)a⁴; du/dlna = −(Γ/H)u, dv/dlna = +(Γ/H)ua, with
        H built self-consistently and the initial amplitude shot so
        u(1) = Ω_dcdm (same scheme as cosmology/background.py)."""
        from scipy.integrate import solve_ivp as _ivp

        p = self.p
        gamma = p.Gamma_dcdm
        x_ini = math.log(1e-12)
        u0 = max(p.Omega_dcdm, 1e-30)
        base = (
            self.Omega_m + self.Omega_g + self.Omega_ur + self.Omega_ncdm
            + p.Omega_k + p.Omega_fld
        )
        Ol = 1.0 - base - u0
        xs = np.linspace(x_ini, 0.0, 2048)
        sol_y = None
        for _ in range(80):
            def rhs(x, y, Ol=Ol):
                u, v = y
                a = math.exp(x)
                E2 = (
                    (self.Omega_g + self.Omega_ur) / a**4
                    + self.Omega_m / a**3
                    + p.Omega_k / a**2
                    + self.rho_ncdm(a)
                    + (self.rho_fld(a) if self.has_fld else 0.0)
                    + Ol + u / a**3 + v / a**4
                )
                H = self.H0 * math.sqrt(max(E2, 1e-300))
                rate = gamma / H if gamma else 0.0
                return [-rate * u, rate * u * a]

            sol = _ivp(rhs, (x_ini, 0.0), [u0, 0.0], t_eval=xs,
                       method="DOP853", rtol=1e-11, atol=u0 * 1e-16)
            u1, v1 = float(sol.y[0, -1]), float(sol.y[1, -1])
            err = 0.0
            # DAMPED updates: at Γ ≫ H0 the plain fixed point oscillates
            # (Ω_dr feedback on H has near-unit gain); half-steps converge
            if u1 > 0:
                fac = p.Omega_dcdm / u1
                err = max(err, abs(fac - 1))
                u0 *= math.sqrt(fac)
            Ol_new = 1.0 - base - u1 - v1
            err = max(err, abs(Ol_new - Ol))
            Ol = 0.5 * (Ol + Ol_new)
            sol_y = sol.y
            if err < 1e-12:
                break
        self.Omega_dr = float(sol_y[1, -1])
        self._lna_dcdm = xs
        self._u_tab = np.maximum(sol_y[0], 0.0)
        self._v_tab = np.maximum(sol_y[1], 0.0)

    def u_dcdm(self, a):
        """(ρ_dcdm/ρ_cr0)·a³ at a (scalar, fast path for the per-step
        RHS: linear interp on the solved ln-a grid)."""
        if self._lna_dcdm is None:
            return 0.0
        return float(np.interp(math.log(max(a, 1e-12)),
                               self._lna_dcdm, self._u_tab))

    def v_dr(self, a):
        """(ρ_dr/ρ_cr0)·a⁴ at a."""
        if self._lna_dcdm is None:
            return 0.0
        return float(np.interp(math.log(max(a, 1e-12)),
                               self._lna_dcdm, self._v_tab))

    # FD integrals with this quadrature
    def _eps(self, y):
        return np.sqrt(self.q**2 + y**2)

    def _I_rho(self, y):
        return np.sum(self.wq * self._eps(y))

    def _I_P(self, y):
        return np.sum(self.wq * self.q**2 / self._eps(y))

    def rho_ncdm(self, a):
        """ρ̄_ncdm(a)/ρ_crit,0 (all N_ncdm species)."""
        if self.C_ncdm == 0.0:
            return 0.0
        return self.C_ncdm * self._I_rho(self.y0 * a) / a**4

    def P_ncdm(self, a):
        if self.C_ncdm == 0.0:
            return 0.0
        return self.C_ncdm * self._I_P(self.y0 * a) / (3 * a**4)

    def H(self, a):
        """H(a) in 1/Mpc (c=1)."""
        E2 = (
            (self.Omega_g + self.Omega_ur) / a**4
            + self.Omega_m / a**3
            + self.rho_ncdm(a)
            + self.Omega_L
        )
        if self.p.Omega_k:
            E2 += self.p.Omega_k / a**2
        if self.has_fld:
            E2 += self.rho_fld(a)
        if self.has_dcdm:
            E2 += self.u_dcdm(a) / a**3 + self.v_dr(a) / a**4
        return self.H0 * math.sqrt(E2)

    def tau_of_a(self, a_grid):
        """Conformal time τ(a) in Mpc by quadrature of 1/(a²H)."""
        a_grid = np.asarray(a_grid)
        a_lo = 1e-10
        af = np.concatenate([[a_lo], a_grid])
        lna = np.log(af)
        integ = np.asarray([1.0 / (ai * self.H(ai)) for ai in af])
        # τ(a_lo) in RD: τ = a/(a²H)·... integrate analytically: τ≈1/(aH)
        tau0 = 1.0 / (a_lo * self.H(a_lo))
        taus = tau0 + np.concatenate(
            [[0.0], np.cumsum(0.5 * (integ[1:] + integ[:-1]) * np.diff(lna))]
        )
        return taus[1:]


# --------------------------------------------------------------------- #
class EBSolver:
    """Per-k synchronous-gauge Einstein-Boltzmann integration."""

    def __init__(self, params: EBParams):
        self.p = params
        self.bg = EBBackground(params)
        p = params
        self.has_ncdm = p.N_ncdm > 0 and p.m_ncdm > 0
        self.has_fld = self.bg.has_fld_pert
        # dr needs its hierarchy only when there is actual decay
        self.has_dr = self.bg.has_dcdm and p.Gamma_dcdm > 0
        # state layout offsets
        self.i_eta = 0
        self.i_tau = 1
        self.i_dc = 2
        self.i_db = 3
        self.i_tb = 4
        self.i_g = 5
        self.i_pol = self.i_g + (p.l_max_g + 1)
        self.i_ur = self.i_pol + (p.l_max_pol + 1)
        self.i_nc = self.i_ur + (p.l_max_ur + 1)
        n_nc = p.n_q * (p.l_max_ncdm + 1) if self.has_ncdm else 0
        # CPL dark-energy fluid: (δ_fld, θ_fld); dcdm itself needs NO new
        # state (synchronous gauge: δ_dcdm' = −h'/2 = δ_cdm', θ_dcdm ≡ 0,
        # the Γ·ψ term vanishes with ψ — CLASS perturbations agree), only
        # its background weight ρ_dcdm(a) in the metric sources differs.
        # Decay radiation: density-WEIGHTED multipoles G_l ≡ v·F_l with
        # v = (ρ_dr/ρ_cr0)a⁴, which absorb the 1/ρ_dr decay sources into
        # the regular injection term Γ·u·a²·δ_dcdm (only l = 0; the
        # injection is isotropic in the dcdm frame and θ_dcdm = 0).
        self.i_fld = self.i_nc + n_nc
        self.i_dr = self.i_fld + (2 if self.has_fld else 0)
        self.n_eq = self.i_dr + (p.l_max_dr + 1 if self.has_dr else 0)

    # ------------------------------------------------------------ #
    def _rhs(self, lna, y, k):
        p, bg = self.p, self.bg
        a = math.exp(lna)
        H = bg.H(a)
        aH = a * H          # conformal Hubble ℋ, 1/Mpc
        k2 = k * k

        eta = y[self.i_eta]
        tau = y[self.i_tau]
        d_c = y[self.i_dc]
        d_b = y[self.i_db]
        t_b = y[self.i_tb]
        Fg = y[self.i_g:self.i_pol]
        Gg = y[self.i_pol:self.i_ur]
        Fur = y[self.i_ur:self.i_nc]

        rho_g = bg.Omega_g / a**4
        rho_ur = bg.Omega_ur / a**4
        rho_b = p.Omega_b / a**3
        rho_c = p.Omega_cdm / a**3

        d_g = Fg[0]
        t_g = 0.75 * k * Fg[1]
        d_ur = Fur[0]
        t_ur = 0.75 * k * Fur[1]

        # ncdm integrals
        if self.has_ncdm:
            Psi = y[self.i_nc:self.i_fld].reshape(p.n_q, p.l_max_ncdm + 1)
            yv = bg.y0 * a
            eps = np.sqrt(bg.q**2 + yv**2)
            A = bg.C_ncdm / a**4
            drho_nc = A * np.sum(bg.wq * eps * Psi[:, 0])
            rho_nc = A * bg._I_rho(yv)
            P_nc = A * bg._I_P(yv) / 3.0
            rpt_nc = A * k * np.sum(bg.wq * bg.q * Psi[:, 1])  # (ρ+P)θ
            dP_nc = (A / 3.0) * np.sum(
                bg.wq * bg.q**2 / eps * Psi[:, 0]
            )
        else:
            drho_nc = rho_nc = P_nc = rpt_nc = dP_nc = 0.0

        # exotic sectors entering the metric sources
        rho_dcdm = bg.u_dcdm(a) / a**3 if bg.has_dcdm else 0.0
        if self.has_fld:
            d_f = y[self.i_fld]
            t_f = y[self.i_fld + 1]
            rho_f = bg.rho_fld(a)
            w_f = bg.w_fld(a)
        else:
            d_f = t_f = rho_f = 0.0
            w_f = -1.0
        if self.has_dr:
            Gdr = y[self.i_dr:self.i_dr + p.l_max_dr + 1]
            v_dr = bg.v_dr(a)
            drho_dr = Gdr[0] / a**4        # = ρ_dr·δ_dr, regular at v→0
            rpt_dr = k * Gdr[1] / a**4     # = (4/3)ρ_dr·θ_dr
        else:
            Gdr = None
            v_dr = drho_dr = rpt_dr = 0.0

        # Einstein constraint: h' (conformal) — MB95 eq 21a
        # 4πG a² ρ_crit = (3/2) H0² a²
        fourpiGa2 = 1.5 * bg.H0**2 * a**2
        drho = (
            rho_g * d_g + rho_ur * d_ur + rho_b * d_b + rho_c * d_c + drho_nc
            + rho_dcdm * d_c  # δ_dcdm ≡ δ_cdm in synchronous gauge
            + rho_f * d_f + drho_dr
        )
        h_p = 2.0 * (k2 * eta + fourpiGa2 * drho) / aH  # d h/dτ

        # η' — MB95 eq 21b
        rpt = (
            (4.0 / 3.0) * rho_g * t_g
            + (4.0 / 3.0) * rho_ur * t_ur
            + rho_b * t_b
            + rpt_nc
            + (1.0 + w_f) * rho_f * t_f + rpt_dr
        )
        eta_p = fourpiGa2 * rpt / k2

        kap = bg.rec.kappa_dot(a)  # dκ/dτ, 1/Mpc
        cs2 = bg.rec.cs2_baryon(a)

        dy = np.empty_like(y)
        dy[self.i_eta] = eta_p
        dy[self.i_tau] = 1.0 / aH
        dy[self.i_dc] = -0.5 * h_p
        dy[self.i_db] = -t_b - 0.5 * h_p
        R = (4.0 / 3.0) * rho_g / rho_b
        dy[self.i_tb] = (
            -aH * t_b + cs2 * k2 * d_b + R * kap * (t_g - t_b)
        )

        # photons — MB95 eq 63-64
        lg = p.l_max_g
        dFg = np.empty(lg + 1)
        dFg[0] = -k * Fg[1] - (2.0 / 3.0) * h_p
        dFg[1] = (k / 3.0) * (Fg[0] - 2.0 * Fg[2]) + (
            (4.0 / (3.0 * k)) * kap * t_b - kap * Fg[1]
        )
        dFg[2] = (
            (k / 5.0) * (2.0 * Fg[1] - 3.0 * Fg[3])
            + (4.0 / 15.0) * h_p + (8.0 / 5.0) * eta_p
            - kap * (0.9 * Fg[2] - 0.1 * (Gg[0] + Gg[2]))
        )
        for l in range(3, lg):
            dFg[l] = (k / (2 * l + 1)) * (
                l * Fg[l - 1] - (l + 1) * Fg[l + 1]
            ) - kap * Fg[l]
        dFg[lg] = k * Fg[lg - 1] - ((lg + 1) / tau) * Fg[lg] - kap * Fg[lg]

        lp = p.l_max_pol
        dGg = np.empty(lp + 1)
        S_pol = Fg[2] + Gg[0] + Gg[2]
        for l in range(lp):
            lo = Gg[l - 1] if l > 0 else 0.0
            dGg[l] = (k / (2 * l + 1)) * (
                l * lo - (l + 1) * Gg[l + 1]
            ) + kap * (
                -Gg[l] + 0.5 * S_pol * (
                    (1.0 if l == 0 else 0.0) + (0.2 if l == 2 else 0.0)
                )
            )
        dGg[lp] = k * Gg[lp - 1] - ((lp + 1) / tau) * Gg[lp] - kap * Gg[lp]

        # massless neutrinos
        lu = p.l_max_ur
        dFur = np.empty(lu + 1)
        dFur[0] = -k * Fur[1] - (2.0 / 3.0) * h_p
        dFur[1] = (k / 3.0) * (Fur[0] - 2.0 * Fur[2])
        dFur[2] = (
            (k / 5.0) * (2.0 * Fur[1] - 3.0 * Fur[3])
            + (4.0 / 15.0) * h_p + (8.0 / 5.0) * eta_p
        )
        for l in range(3, lu):
            dFur[l] = (k / (2 * l + 1)) * (
                l * Fur[l - 1] - (l + 1) * Fur[l + 1]
            )
        dFur[lu] = k * Fur[lu - 1] - ((lu + 1) / tau) * Fur[lu]

        dy[self.i_g:self.i_pol] = dFg
        dy[self.i_pol:self.i_ur] = dGg
        dy[self.i_ur:self.i_nc] = dFur

        # massive neutrinos — MB95 eq 56-58
        if self.has_ncdm:
            lnc = p.l_max_ncdm
            qk_eps = (bg.q / eps) * k  # (n_q,)
            dPsi = np.empty_like(Psi)
            dPsi[:, 0] = -qk_eps * Psi[:, 1] + (h_p / 6.0) * bg.dlnf0
            dPsi[:, 1] = (qk_eps / 3.0) * (Psi[:, 0] - 2.0 * Psi[:, 2])
            dPsi[:, 2] = (qk_eps / 5.0) * (
                2.0 * Psi[:, 1] - 3.0 * Psi[:, 3]
            ) - ((1.0 / 15.0) * h_p + (2.0 / 5.0) * eta_p) * bg.dlnf0
            for l in range(3, lnc):
                dPsi[:, l] = (qk_eps / (2 * l + 1)) * (
                    l * Psi[:, l - 1] - (l + 1) * Psi[:, l + 1]
                )
            dPsi[:, lnc] = qk_eps * Psi[:, lnc - 1] - (
                (lnc + 1) / tau
            ) * Psi[:, lnc]
            dy[self.i_nc:self.i_fld] = dPsi.reshape(-1)

        # CPL dark-energy fluid (c_s² = 1 rest frame; CLASS fld eqs):
        #   δ' = −(1+w)(θ + h'/2) − 3ℋ(c_s²−w)δ − 9ℋ²(1+w)(c_s²−c_a²)θ/k²
        #   θ' = −(1−3c_s²)ℋθ + c_s²k²δ/(1+w)
        # with c_a² = w − w'/(3(1+w)ℋ) = w + wa·a/(3(1+w)) for CPL.
        if self.has_fld:
            cs2_f = 1.0
            opw = w_f + 1.0
            opw_safe = math.copysign(max(abs(opw), 1e-5), opw if opw else 1.0)
            ca2 = w_f + p.wa_fld * a / (3.0 * opw_safe)
            dy[self.i_fld] = (
                -opw * (t_f + 0.5 * h_p)
                - 3.0 * aH * (cs2_f - w_f) * d_f
                - 9.0 * aH**2 * opw * (cs2_f - ca2) * t_f / k2
            )
            dy[self.i_fld + 1] = (
                -(1.0 - 3.0 * cs2_f) * aH * t_f + cs2_f * k2 * d_f / opw_safe
            )

        # decay radiation: density-weighted multipoles G_l = v·F_l — the
        # Γ-damping in F_l' cancels against v' = Γ·u·a² (injection
        # isotropic in the dcdm frame, θ_dcdm = 0), leaving only the l=0
        # source Γ·u·a²·δ_dcdm (arXiv:1407.2418 eq 2.12-2.14 recast)
        if self.has_dr:
            ldr = p.l_max_dr
            inj = p.Gamma_dcdm * bg.u_dcdm(a) * a**2
            dG = np.empty(ldr + 1)
            dG[0] = -k * Gdr[1] - (2.0 / 3.0) * h_p * v_dr + inj * d_c
            dG[1] = (k / 3.0) * (Gdr[0] - 2.0 * Gdr[2])
            dG[2] = (k / 5.0) * (2.0 * Gdr[1] - 3.0 * Gdr[3]) + (
                (4.0 / 15.0) * h_p + (8.0 / 5.0) * eta_p
            ) * v_dr
            for l in range(3, ldr):
                dG[l] = (k / (2 * l + 1)) * (
                    l * Gdr[l - 1] - (l + 1) * Gdr[l + 1]
                )
            dG[ldr] = k * Gdr[ldr - 1] - ((ldr + 1) / tau) * Gdr[ldr]
            dy[self.i_dr:self.i_dr + ldr + 1] = dG

        # all derivatives are d/dτ; convert to d/dln a
        dy /= aH
        dy[self.i_tau] = 1.0 / aH  # already d τ/d ln a
        return dy

    # ------------------------------------------------------------ #
    def _jac_sparsity(self):
        """Sparsity superset of ∂(rhs)/∂y — lets BDF build its
        finite-difference Jacobian with ~10 grouped rhs calls instead of
        n_eq (the hierarchy is tridiagonal in l; the metric constraint
        h'(δ's) and η'(θ's) add a few dense columns)."""
        import scipy.sparse as sp

        p = self.p
        n = self.n_eq
        S = sp.lil_matrix((n, n), dtype=bool)
        # columns entering h' and η'
        hcols = [self.i_eta, self.i_dc, self.i_db, self.i_g, self.i_ur]
        etacols = [self.i_tb, self.i_g + 1, self.i_ur + 1]
        if self.has_ncdm:
            for iq in range(p.n_q):
                base = self.i_nc + iq * (p.l_max_ncdm + 1)
                hcols.append(base)
                etacols.append(base + 1)
        if self.has_fld:
            hcols.append(self.i_fld)
            etacols.append(self.i_fld + 1)
        if self.has_dr:
            hcols.append(self.i_dr)
            etacols.append(self.i_dr + 1)

        def add(row, cols):
            for c in cols:
                S[row, c] = True

        add(self.i_eta, etacols)
        add(self.i_dc, hcols)
        add(self.i_db, [self.i_tb] + hcols)
        add(self.i_tb, [self.i_tb, self.i_db, self.i_g + 1])
        lg, lp, lu = p.l_max_g, p.l_max_pol, p.l_max_ur
        g, pol, ur = self.i_g, self.i_pol, self.i_ur
        add(g + 0, [g + 1] + hcols)
        add(g + 1, [g + 0, g + 1, g + 2, self.i_tb])
        add(g + 2, [g + 1, g + 2, g + 3, pol, pol + 2] + hcols + etacols)
        for l in range(3, lg):
            add(g + l, [g + l - 1, g + l, g + l + 1])
        add(g + lg, [g + lg - 1, g + lg, self.i_tau])
        add(pol + 0, [pol, pol + 1, pol + 2, g + 2])
        for l in range(1, lp):
            cols = [pol + l - 1, pol + l, pol + l + 1]
            if l == 2:
                cols += [g + 2, pol]
            add(pol + l, cols)
        add(pol + lp, [pol + lp - 1, pol + lp, self.i_tau])
        add(ur + 0, [ur + 1] + hcols)
        add(ur + 1, [ur, ur + 2])
        add(ur + 2, [ur + 1, ur + 3] + hcols + etacols)
        for l in range(3, lu):
            add(ur + l, [ur + l - 1, ur + l + 1])
        add(ur + lu, [ur + lu - 1, ur + lu, self.i_tau])
        if self.has_ncdm:
            lnc = p.l_max_ncdm
            for iq in range(p.n_q):
                b = self.i_nc + iq * (lnc + 1)
                add(b + 0, [b + 1] + hcols)
                add(b + 1, [b, b + 2])
                add(b + 2, [b + 1, b + 3] + hcols + etacols)
                for l in range(3, lnc):
                    add(b + l, [b + l - 1, b + l + 1])
                add(b + lnc, [b + lnc - 1, b + lnc, self.i_tau])
        if self.has_fld:
            add(self.i_fld, [self.i_fld, self.i_fld + 1] + hcols)
            add(self.i_fld + 1, [self.i_fld, self.i_fld + 1])
        if self.has_dr:
            b = self.i_dr
            ldr = p.l_max_dr
            add(b + 0, [b + 1, self.i_dc] + hcols)
            add(b + 1, [b, b + 2])
            add(b + 2, [b + 1, b + 3] + hcols + etacols)
            for l in range(3, ldr):
                add(b + l, [b + l - 1, b + l + 1])
            add(b + ldr, [b + ldr - 1, b + ldr, self.i_tau])
        return S.tocsr()

    # ------------------------------------------------------------ #
    def _initial_conditions(self, k, a_init, tau_init):
        """Adiabatic superhorizon ICs, MB95 eq 96 (C = 1)."""
        p, bg = self.p, self.bg
        kt = k * tau_init
        rho_rad = bg.Omega_g + bg.Omega_ur + (
            bg.C_ncdm * bg._I0 if self.has_ncdm else 0.0
        )
        R_nu = (bg.Omega_ur + (bg.C_ncdm * bg._I0 if self.has_ncdm else 0.0)
                ) / rho_rad
        C = 1.0
        y = np.zeros(self.n_eq)
        h0 = C * kt**2
        y[self.i_eta] = 2 * C - C * (5 + 4 * R_nu) / (
            6 * (15 + 4 * R_nu)
        ) * kt**2
        y[self.i_tau] = tau_init
        d_g = -(2.0 / 3.0) * h0
        y[self.i_dc] = 0.75 * d_g
        y[self.i_db] = 0.75 * d_g
        t_g = -(C / 18.0) * k**4 * tau_init**3
        y[self.i_tb] = t_g
        t_nu = t_g * (23 + 4 * R_nu) / (15 + 4 * R_nu)
        s_nu = 2.0 * C * kt**2 / (3 * (15 + 4 * R_nu))
        y[self.i_g + 0] = d_g
        y[self.i_g + 1] = (4.0 / (3.0 * k)) * t_g
        y[self.i_ur + 0] = d_g
        y[self.i_ur + 1] = (4.0 / (3.0 * k)) * t_nu
        y[self.i_ur + 2] = 2.0 * s_nu
        if self.has_ncdm:
            Psi = np.zeros((p.n_q, p.l_max_ncdm + 1))
            yv = bg.y0 * a_init
            eps = np.sqrt(bg.q**2 + yv**2)
            Psi[:, 0] = -0.25 * d_g * bg.dlnf0
            Psi[:, 1] = -(eps / (3.0 * bg.q * k)) * t_nu * bg.dlnf0
            Psi[:, 2] = -0.5 * s_nu * bg.dlnf0
            y[self.i_nc:self.i_fld] = Psi.reshape(-1)
        if self.has_fld:
            # adiabatic: δ_i/(1+w_i) equal across species ⇒
            # δ_fld = (1+w)·(3/4)·δ_γ; θ_fld starts with the photons
            w_i = bg.w_fld(a_init)
            y[self.i_fld] = (1.0 + w_i) * 0.75 * d_g
            y[self.i_fld + 1] = t_g
        # decay radiation starts empty: G_l(a_init) = 0 (ρ_dr → 0)
        return y

    # ------------------------------------------------------------ #
    def _rhs_rsa(self, lna, y, k):
        """Reduced system after the radiation-streaming switch: photon,
        polarization and massless-ν hierarchies dropped (free-streaming
        radiation contributes negligibly to the metric sources by then —
        CLASS's RSA plays the same role); massive ν keep their full
        momentum hierarchy."""
        p, bg = self.p, self.bg
        a = math.exp(lna)
        H = bg.H(a)
        aH = a * H
        k2 = k * k
        eta = y[0]
        tau = y[1]
        d_c = y[2]
        d_b = y[3]
        t_b = y[4]
        n_nc = p.n_q * (p.l_max_ncdm + 1) if self.has_ncdm else 0
        j_fld = 5 + n_nc
        j_dr = j_fld + (2 if self.has_fld else 0)
        rho_b = p.Omega_b / a**3
        rho_c = p.Omega_cdm / a**3
        if self.has_ncdm:
            Psi = y[5:j_fld].reshape(p.n_q, p.l_max_ncdm + 1)
            yv = bg.y0 * a
            eps = np.sqrt(bg.q**2 + yv**2)
            A = bg.C_ncdm / a**4
            drho_nc = A * np.sum(bg.wq * eps * Psi[:, 0])
            rpt_nc = A * k * np.sum(bg.wq * bg.q * Psi[:, 1])
        else:
            drho_nc = rpt_nc = 0.0
        rho_dcdm = bg.u_dcdm(a) / a**3 if bg.has_dcdm else 0.0
        if self.has_fld:
            d_f = y[j_fld]
            t_f = y[j_fld + 1]
            rho_f = bg.rho_fld(a)
            w_f = bg.w_fld(a)
        else:
            d_f = t_f = rho_f = 0.0
            w_f = -1.0
        if self.has_dr:
            Gdr = y[j_dr:j_dr + p.l_max_dr + 1]
            v_dr = bg.v_dr(a)
            drho_dr = Gdr[0] / a**4
            rpt_dr = k * Gdr[1] / a**4
        else:
            Gdr = None
            v_dr = drho_dr = rpt_dr = 0.0
        fourpiGa2 = 1.5 * bg.H0**2 * a**2
        drho = (rho_b * d_b + rho_c * d_c + drho_nc
                + rho_dcdm * d_c + rho_f * d_f + drho_dr)
        h_p = 2.0 * (k2 * eta + fourpiGa2 * drho) / aH
        # quasi-static free-streaming closure: the slow part of the
        # radiation velocity is θ_rad = −h'/2 (from 0 ≈ −4θ/3 − 2h'/3);
        # it still drives η' at the switch epoch and cannot be dropped
        rho_r = (bg.Omega_g + bg.Omega_ur) / a**4
        th_rad = -0.5 * h_p
        rpt = (rho_b * t_b + rpt_nc + (4.0 / 3.0) * rho_r * th_rad
               + (1.0 + w_f) * rho_f * t_f + rpt_dr)
        eta_p = fourpiGa2 * rpt / k2
        cs2 = bg.rec.cs2_baryon(a)
        kap = bg.rec.kappa_dot(a)
        R = (4.0 / 3.0) * (bg.Omega_g / a**4) / rho_b
        dy = np.empty_like(y)
        dy[0] = eta_p
        dy[1] = 1.0
        dy[2] = -0.5 * h_p
        dy[3] = -t_b - 0.5 * h_p
        dy[4] = (
            -aH * t_b + cs2 * k2 * d_b + R * kap * (th_rad - t_b)
        )
        if self.has_ncdm:
            lnc = p.l_max_ncdm
            qk_eps = (bg.q / eps) * k
            dPsi = np.empty_like(Psi)
            dPsi[:, 0] = -qk_eps * Psi[:, 1] + (h_p / 6.0) * bg.dlnf0
            dPsi[:, 1] = (qk_eps / 3.0) * (Psi[:, 0] - 2.0 * Psi[:, 2])
            dPsi[:, 2] = (qk_eps / 5.0) * (
                2.0 * Psi[:, 1] - 3.0 * Psi[:, 3]
            ) - ((1.0 / 15.0) * h_p + (2.0 / 5.0) * eta_p) * bg.dlnf0
            for l in range(3, lnc):
                dPsi[:, l] = (qk_eps / (2 * l + 1)) * (
                    l * Psi[:, l - 1] - (l + 1) * Psi[:, l + 1]
                )
            dPsi[:, lnc] = qk_eps * Psi[:, lnc - 1] - (
                (lnc + 1) / tau
            ) * Psi[:, lnc]
            dy[5:j_fld] = dPsi.reshape(-1)
        if self.has_fld:
            cs2_f = 1.0
            opw = w_f + 1.0
            opw_safe = math.copysign(max(abs(opw), 1e-5), opw if opw else 1.0)
            ca2 = w_f + p.wa_fld * a / (3.0 * opw_safe)
            dy[j_fld] = (
                -opw * (t_f + 0.5 * h_p)
                - 3.0 * aH * (cs2_f - w_f) * d_f
                - 9.0 * aH**2 * opw * (cs2_f - ca2) * t_f / k2
            )
            dy[j_fld + 1] = (
                -(1.0 - 3.0 * cs2_f) * aH * t_f + cs2_f * k2 * d_f / opw_safe
            )
        if self.has_dr:
            ldr = p.l_max_dr
            inj = p.Gamma_dcdm * bg.u_dcdm(a) * a**2
            dG = np.empty(ldr + 1)
            dG[0] = -k * Gdr[1] - (2.0 / 3.0) * h_p * v_dr + inj * d_c
            dG[1] = (k / 3.0) * (Gdr[0] - 2.0 * Gdr[2])
            dG[2] = (k / 5.0) * (2.0 * Gdr[1] - 3.0 * Gdr[3]) + (
                (4.0 / 15.0) * h_p + (8.0 / 5.0) * eta_p
            ) * v_dr
            for l in range(3, ldr):
                dG[l] = (k / (2 * l + 1)) * (
                    l * Gdr[l - 1] - (l + 1) * Gdr[l + 1]
                )
            dG[ldr] = k * Gdr[ldr - 1] - ((ldr + 1) / tau) * Gdr[ldr]
            dy[j_dr:j_dr + ldr + 1] = dG
        dy /= aH
        dy[1] = 1.0 / aH
        return dy

    def _rsa_switch_a(self, k):
        """First a where radiation free-streams (κ̇/ℋ < 0.03) and the
        mode is deep inside the horizon (kτ > 45); None if never."""
        bg = self.bg
        a_grid = np.logspace(-3.2, 0, 200)
        taus = bg.tau_of_a(a_grid)
        for a, tau in zip(a_grid, taus):
            if k * tau > 45.0 and bg.rec.kappa_dot(a) / (a * bg.H(a)) < 0.03:
                return a
        return None

    def solve_mode(self, k, a_out, rtol=1e-6, atol=1e-12):
        """Integrate mode k (1/Mpc); return dict of series on a_out."""
        bg = self.bg
        p = self.p
        a_out = np.asarray(a_out, float)
        # start deep in RD with kτ small
        a_try = np.logspace(-9, -3.2, 300)
        taus = bg.tau_of_a(a_try)
        i0 = np.searchsorted(taus, 5e-2 / k)
        i0 = min(max(i0, 1), len(a_try) - 1)
        a_init = min(a_try[i0], 1e-4)
        tau_init = float(np.interp(a_init, a_try, taus))
        y0 = self._initial_conditions(k, a_init, tau_init)
        R_init = self._R_com_point(k, a_init, y0)
        if not hasattr(self, "_sparsity"):
            self._sparsity = self._jac_sparsity()
        a_sw = self._rsa_switch_a(k)
        if a_sw is not None and a_sw >= a_out[-1]:
            a_sw = None
        lna_end1 = math.log(a_sw) if a_sw is not None else 0.0
        te1 = np.log(a_out[a_out <= (a_sw if a_sw is not None else 1.0)])
        te1_solve = te1 if a_sw is None else np.append(te1, lna_end1)
        sol = solve_ivp(
            self._rhs, (math.log(a_init), lna_end1), y0, args=(k,),
            method="BDF", rtol=rtol, atol=atol,
            t_eval=te1_solve, dense_output=False,
            jac_sparsity=self._sparsity,
        )
        if not sol.success:
            raise RuntimeError(f"EB mode k={k} failed: {sol.message}")
        if a_sw is None:
            out = self._extract(k, a_out, sol.y)
            out["R_init"] = np.full_like(a_out, R_init)
            out["a_rsa"] = np.full_like(a_out, np.nan)
            return out
        # phase 2: RSA — seed from the exact end state of phase 1
        y_end = sol.y[:, -1]
        n_nc = p.n_q * (p.l_max_ncdm + 1) if self.has_ncdm else 0
        n_fld = 2 if self.has_fld else 0
        n_dr = p.l_max_dr + 1 if self.has_dr else 0
        j_fld = 5 + n_nc
        j_dr = j_fld + n_fld
        n2 = 5 + n_nc + n_fld + n_dr
        y2 = np.empty(n2)
        y2[0] = y_end[self.i_eta]
        y2[1] = y_end[self.i_tau]
        y2[2] = y_end[self.i_dc]
        y2[3] = y_end[self.i_db]
        y2[4] = y_end[self.i_tb]
        if self.has_ncdm:
            y2[5:j_fld] = y_end[self.i_nc:self.i_fld]
        if self.has_fld:
            y2[j_fld:j_dr] = y_end[self.i_fld:self.i_fld + 2]
        if self.has_dr:
            y2[j_dr:] = y_end[self.i_dr:self.i_dr + n_dr]
        te2 = np.log(a_out[a_out > a_sw])
        sol2 = solve_ivp(
            self._rhs_rsa, (lna_end1, 0.0), y2, args=(k,),
            method="BDF", rtol=rtol, atol=atol,
            t_eval=te2, dense_output=False,
        )
        if not sol2.success:
            raise RuntimeError(f"EB RSA mode k={k} failed: {sol2.message}")
        # stitch into a full-width Y for extraction: radiation columns
        # beyond the switch carry the (negligible) RSA placeholder 0
        n_lo = te1.size
        Y = np.zeros((self.n_eq, a_out.size))
        Y[:, :n_lo] = sol.y[:, :n_lo]
        Y[self.i_eta, n_lo:] = sol2.y[0]
        Y[self.i_tau, n_lo:] = sol2.y[1]
        Y[self.i_dc, n_lo:] = sol2.y[2]
        Y[self.i_db, n_lo:] = sol2.y[3]
        Y[self.i_tb, n_lo:] = sol2.y[4]
        if self.has_ncdm:
            Y[self.i_nc:self.i_fld, n_lo:] = sol2.y[5:j_fld]
        if self.has_fld:
            Y[self.i_fld:self.i_fld + 2, n_lo:] = sol2.y[j_fld:j_dr]
        if self.has_dr:
            Y[self.i_dr:self.i_dr + n_dr, n_lo:] = sol2.y[j_dr:]
        out = self._extract(k, a_out, Y)
        out["R_init"] = np.full_like(a_out, R_init)
        out["a_rsa"] = np.full_like(a_out, a_sw)
        return out

    def _R_com_point(self, k, a, y):
        """Comoving curvature ℛ = η + ℋ·[Σ(ρ̄+P̄)θ]/[Σ(ρ̄+P̄)]/k² at one
        state vector (used for the per-unit-ζ normalization at τ_init,
        where ℛ is the conserved primordial amplitude)."""
        p, bg = self.p, self.bg
        aH = a * bg.H(a)
        rho_g = bg.Omega_g / a**4
        rho_ur = bg.Omega_ur / a**4
        rho_b = p.Omega_b / a**3
        rho_c = p.Omega_cdm / a**3
        t_g = 0.75 * k * y[self.i_g + 1]
        t_ur = 0.75 * k * y[self.i_ur + 1]
        t_b = y[self.i_tb]
        if self.has_ncdm:
            Psi = y[self.i_nc:self.i_fld].reshape(p.n_q, p.l_max_ncdm + 1)
            yv = bg.y0 * a
            eps = np.sqrt(bg.q**2 + yv**2)
            A = bg.C_ncdm / a**4
            rho_nc = A * np.sum(bg.wq * eps)
            P_nc = A * bg._I_P(yv) / 3.0
            rpt_nc = A * k * np.sum(bg.wq * bg.q * Psi[:, 1])
        else:
            rho_nc = P_nc = rpt_nc = 0.0
        rho_dcdm = bg.u_dcdm(a) / a**3 if bg.has_dcdm else 0.0
        if self.has_fld:
            rho_f = bg.rho_fld(a)
            w_f = bg.w_fld(a)
            rpt_f = (1.0 + w_f) * rho_f * y[self.i_fld + 1]
            rhoP_f = (1.0 + w_f) * rho_f
        else:
            rpt_f = rhoP_f = 0.0
        if self.has_dr:
            rpt_dr = k * y[self.i_dr + 1] / a**4
            rhoP_dr = (4.0 / 3.0) * bg.v_dr(a) / a**4
        else:
            rpt_dr = rhoP_dr = 0.0
        rpt = (
            (4.0 / 3.0) * rho_g * t_g + (4.0 / 3.0) * rho_ur * t_ur
            + rho_b * t_b + rpt_nc + rpt_f + rpt_dr
        )
        rho_plus_P = (
            (4.0 / 3.0) * (rho_g + rho_ur) + rho_b + rho_c + rho_nc + P_nc
            + rho_dcdm + rhoP_f + rhoP_dr
        )
        return y[self.i_eta] + aH * rpt / (rho_plus_P * k * k)

    def _extract(self, k, a_out, Y):
        p, bg = self.p, self.bg
        out = {}
        a = np.asarray(a_out)
        aH = np.asarray([ai * bg.H(ai) for ai in a])
        k2 = k * k
        eta = Y[self.i_eta]
        tau = Y[self.i_tau]
        d_c = Y[self.i_dc]
        d_b = Y[self.i_db]
        t_b = Y[self.i_tb]
        Fg = Y[self.i_g:self.i_pol]
        Fur = Y[self.i_ur:self.i_nc]
        d_g = Fg[0]
        t_g = 0.75 * k * Fg[1]
        s_g = 0.5 * Fg[2]
        d_ur = Fur[0]
        t_ur = 0.75 * k * Fur[1]
        s_ur = 0.5 * Fur[2]

        rho_g = bg.Omega_g / a**4
        rho_ur = bg.Omega_ur / a**4
        rho_b = p.Omega_b / a**3
        rho_c = p.Omega_cdm / a**3

        if self.has_ncdm:
            nq, lnc = p.n_q, p.l_max_ncdm
            Psi = Y[self.i_nc:self.i_fld].reshape(nq, lnc + 1, -1)
            yv = bg.y0 * a
            eps = np.sqrt(bg.q[:, None] ** 2 + yv[None, :] ** 2)  # (nq, Na)
            A = bg.C_ncdm / a**4
            rho_nc = A * np.sum(bg.wq[:, None] * eps, axis=0)
            P_nc = A * np.sum(
                bg.wq[:, None] * bg.q[:, None] ** 2 / eps, axis=0
            ) / 3.0
            drho_nc = A * np.sum(bg.wq[:, None] * eps * Psi[:, 0, :], axis=0)
            dP_nc = A * np.sum(
                bg.wq[:, None] * bg.q[:, None] ** 2 / eps * Psi[:, 0, :],
                axis=0,
            ) / 3.0
            rpt_nc = A * k * np.sum(
                bg.wq[:, None] * bg.q[:, None] * Psi[:, 1, :], axis=0
            )
            rps_nc = (2.0 / 3.0) * A * np.sum(
                bg.wq[:, None] * bg.q[:, None] ** 2 / eps * Psi[:, 2, :],
                axis=0,
            )
            d_nc = drho_nc / rho_nc
            t_nc = rpt_nc / (rho_nc + P_nc)
            s_nc = rps_nc / (rho_nc + P_nc)
        else:
            rho_nc = P_nc = np.zeros_like(a)
            d_nc = t_nc = s_nc = dP_nc = np.zeros_like(a)

        # exotic sectors
        rho_dcdm = (
            np.asarray([bg.u_dcdm(ai) for ai in a]) / a**3
            if bg.has_dcdm else np.zeros_like(a)
        )
        if self.has_fld:
            d_f = Y[self.i_fld]
            t_f = Y[self.i_fld + 1]
            rho_f = np.asarray([bg.rho_fld(ai) for ai in a])
            w_f = np.asarray([bg.w_fld(ai) for ai in a])
        else:
            d_f = t_f = rho_f = np.zeros_like(a)
            w_f = np.full_like(a, -1.0)
        if self.has_dr:
            Gdr = Y[self.i_dr:self.i_dr + p.l_max_dr + 1]
            v_dr = np.asarray([bg.v_dr(ai) for ai in a])
            rho_dr = v_dr / a**4
            tiny = np.maximum(v_dr, 1e-300)
            d_dr = Gdr[0] / tiny
            t_dr = 0.75 * k * Gdr[1] / tiny
            s_dr = 0.5 * Gdr[2] / tiny
            drho_dr = Gdr[0] / a**4
            rpt_dr = k * Gdr[1] / a**4
        else:
            rho_dr = d_dr = t_dr = s_dr = np.zeros_like(a)
            drho_dr = rpt_dr = np.zeros_like(a)

        # totals
        rpt = (
            (4.0 / 3.0) * rho_g * t_g
            + (4.0 / 3.0) * rho_ur * t_ur
            + rho_b * t_b
            + (rho_nc + P_nc) * t_nc
            + (1.0 + w_f) * rho_f * t_f + rpt_dr
        )
        rho_plus_P = (
            (4.0 / 3.0) * (rho_g + rho_ur) + rho_b + rho_c + rho_nc + P_nc
            + rho_dcdm + (1.0 + w_f) * rho_f + (4.0 / 3.0) * rho_dr
        )
        theta_tot = rpt / rho_plus_P
        drho = (
            rho_g * d_g + rho_ur * d_ur + rho_b * d_b + rho_c * d_c
            + (drho_nc if self.has_ncdm else 0.0)
            + rho_dcdm * d_c + rho_f * d_f + drho_dr
        )
        fourpiGa2 = 1.5 * bg.H0**2 * a**2
        h_p = 2.0 * (k2 * eta + fourpiGa2 * drho) / aH
        eta_p = fourpiGa2 * rpt / k2

        # comoving curvature & longitudinal potentials
        R_com = eta + aH * rpt / (rho_plus_P * k2)
        alpha = (h_p + 6.0 * eta_p) / (2.0 * k2)
        phi = eta - aH * alpha
        # ψ via MB95: h'' from eq 21c: h″ + 2ℋh′ − 2k²η = −24πGa²δP_tot
        # δP_fld = c_s²δρ + 3ℋ(c_s²−c_a²)(1+w)ρθ/k² (rest-frame c_s²=1)
        if self.has_fld:
            opw = np.where(np.abs(1.0 + w_f) < 1e-5,
                           np.copysign(1e-5, 1.0 + w_f + 1e-30), 1.0 + w_f)
            ca2 = w_f + p.wa_fld * a / (3.0 * opw)
            dP_fld = rho_f * d_f + 3.0 * aH * (1.0 - ca2) * (
                (1.0 + w_f) * rho_f * t_f
            ) / k2
        else:
            dP_fld = 0.0
        dP_tot = (
            (1.0 / 3.0) * (rho_g * d_g + rho_ur * d_ur + drho_dr)
            + (dP_nc if self.has_ncdm else 0.0)
            + dP_fld
        )
        h_pp = -2.0 * aH * h_p + 2.0 * k2 * eta - 3.0 * fourpiGa2 * 2.0 * dP_tot
        # η'' by finite differences of η' on the (dense) a grid
        lna = np.log(a)
        eta_pp = np.gradient(eta_p, lna) * aH  # d/dτ = aH d/dlna
        alpha_p = (h_pp + 6.0 * eta_pp) / (2.0 * k2)
        psi = alpha_p + aH * alpha

        dm = rho_c * d_c + rho_b * d_b
        rho_m = rho_c + rho_b
        out.update(
            eta=eta, tau=tau, h_prime=h_p, theta_tot=theta_tot,
            R_com=R_com, phi=phi, psi=psi, alpha=alpha,
            d_cdm=d_c, d_b=d_b, t_b=t_b,
            d_g=d_g, t_g=t_g, s_g=s_g,
            d_ur=d_ur, t_ur=t_ur, s_ur=s_ur,
            d_nc=d_nc, t_nc=t_nc, s_nc=s_nc,
            dP_nc=dP_nc, rho_nc=rho_nc, P_nc=P_nc,
            d_cb=dm / rho_m,
            t_cb=rho_b * t_b / rho_m,  # θ_cdm = 0 in synchronous gauge
            d_m=(dm + (drho_nc if self.has_ncdm else 0.0))
            / (rho_m + rho_nc),
            t_m=(rho_b * t_b + (rho_nc + P_nc) * t_nc) / (rho_m + rho_nc),
        )
        if bg.has_dcdm:
            # δ_dcdm ≡ δ_cdm in synchronous gauge (see layout comment)
            out.update(d_dcdm=d_c.copy(), t_dcdm=np.zeros_like(d_c),
                       rho_dcdm=rho_dcdm)
        if self.has_dr:
            out.update(d_dr=d_dr, t_dr=t_dr, s_dr=s_dr, rho_dr=rho_dr)
        if self.has_fld:
            out.update(d_fld=d_f, t_fld=t_f, rho_fld=rho_f)
        return out


# --------------------------------------------------------------------- #
def _solve_mode_chunk(params: "EBParams", ks, a_out, rtol):
    """Worker: solve a chunk of k modes (module-level for pickling)."""
    solver = EBSolver(params)
    return [solver.solve_mode(k, a_out, rtol=rtol) for k in ks]


def table_key(params: EBParams, k_mpc, a_out, rtol) -> str:
    """The cache file's key: ``<cache_dir>/eb_<key>.npz`` holds the
    tables of these parameters, modes (1/Mpc), scale factors and rtol."""
    return hashlib.sha256(
        (params.key() + np.asarray(k_mpc, np.float64).tobytes().hex()
         + np.asarray(a_out, np.float64).tobytes().hex() + f"{rtol}").encode()
    ).hexdigest()[:16]


def solve_tables(params: EBParams, k_mpc, a_out=None, rtol=1e-6,
                 cache_dir=None, verbose=False):
    """Solve all modes; return raw per-mode dict-of-(Na, Nk) arrays,
    normalized per unit comoving curvature (ℛ_init = 1) with the sign
    fixed so late-time δ_cdm > 0.  Disk-cached (npz) keyed on params+k."""
    k_mpc = np.asarray(k_mpc, np.float64)
    if a_out is None:
        a_out = np.logspace(-3, 0, 120)
    a_out = np.asarray(a_out, np.float64)
    key = table_key(params, k_mpc, a_out, rtol)
    if cache_dir:
        path = os.path.join(cache_dir, f"eb_{key}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                return {name: z[name] for name in z.files}
    # modes are independent: fan them out over host CPUs (the
    # reference's node-distributed CLASS computation, commons.py:4705 —
    # k modes dealt round-robin across workers).  Serial on 1-CPU hosts.
    n_workers = min(
        int(os.environ.get("CONCEPT_TPU_EB_WORKERS",
                           os.cpu_count() or 1)),
        len(k_mpc),
    )
    results = [None] * len(k_mpc)
    if n_workers > 1:
        import concurrent.futures as _cf

        chunks = [list(range(j, len(k_mpc), n_workers))
                  for j in range(n_workers)]
        with _cf.ProcessPoolExecutor(max_workers=n_workers) as ex:
            futs = {
                ex.submit(_solve_mode_chunk, params,
                          [float(k_mpc[j]) for j in chunk], a_out, rtol):
                chunk
                for chunk in chunks if chunk
            }
            for fut in _cf.as_completed(futs):
                for j, res in zip(futs[fut], fut.result()):
                    results[j] = res
                if verbose:
                    done = sum(r is not None for r in results)
                    print(f"  EB modes {done}/{len(k_mpc)}", flush=True)
    else:
        solver = EBSolver(params)
        for j, k in enumerate(k_mpc):
            results[j] = solver.solve_mode(float(k), a_out, rtol=rtol)
            if verbose:
                print(f"  EB mode {j + 1}/{len(k_mpc)} k={k:.4g}/Mpc",
                      flush=True)
    rows = None
    for j, res in enumerate(results):
        # normalize per unit comoving curvature at the initial time,
        # global sign flipped so δ_cdm(a=1) > 0
        norm = -res["R_init"][0]
        if rows is None:
            rows = {name: np.empty((len(a_out), len(k_mpc)))
                    for name in res}
        for name, series in res.items():
            # bookkeeping columns stay physical
            div = 1.0 if name in ("R_init", "a_rsa", "tau") else norm
            rows[name][:, j] = series / div
    rows["k_mpc"] = k_mpc
    rows["a"] = a_out
    # R_com was normalized too: un-normalize bookkeeping columns that
    # should stay physical? (all tables are per unit ζ — keep as is)
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(path, **rows)
    return rows


def tabulate_eb(params: EBParams, k_internal, Mpc: float, light_speed: float,
                a_out=None, rtol=1e-6, cache_dir=None, verbose=False):
    """Build a TransferTables (framework units) from the internal solver.

    k_internal: wavenumbers in internal inverse-length units; Mpc /
    light_speed convert the solver's Mpc-c=1 outputs:
    δ dimensionless; θ [1/Mpc·c] → ×light_speed/Mpc; δP stored as
    δP/ρ̄ (dimensionless); σ dimensionless (velocity-potential
    convention, matching CLASS).  aux: theta_tot, h_prime (same 1/time
    conversion), phi/psi (dimensionless), H_T_prime = 3ℛ' (1/time).
    """
    from concept_tpu_torch.cosmology.boltzmann import TransferTables

    k_internal = np.asarray(k_internal)
    k_mpc = k_internal * Mpc
    rows = solve_tables(params, k_mpc, a_out=a_out, rtol=rtol,
                        cache_dir=cache_dir, verbose=verbose)
    a = rows["a"]
    inv_t = light_speed / Mpc  # 1/Mpc·c → internal 1/time
    tables = {
        ("cdm", "delta"): rows["d_cdm"],
        ("b", "delta"): rows["d_b"],
        ("cb", "delta"): rows["d_cb"],
        ("matter", "delta"): rows["d_m"],
        ("photon", "delta"): rows["d_g"],
        ("ur", "delta"): rows["d_ur"],
        ("cdm", "theta"): np.zeros_like(rows["d_cdm"]),
        ("b", "theta"): rows["t_b"] * inv_t,
        ("cb", "theta"): rows["t_cb"] * inv_t,
        ("matter", "theta"): rows["t_m"] * inv_t,
        ("photon", "theta"): rows["t_g"] * inv_t,
        ("ur", "theta"): rows["t_ur"] * inv_t,
        ("photon", "sigma"): rows["s_g"],
        ("ur", "sigma"): rows["s_ur"],
    }
    if params.N_ncdm > 0 and params.m_ncdm > 0:
        tables[("nu", "delta")] = rows["d_nc"]
        tables[("nu", "theta")] = rows["t_nc"] * inv_t
        tables[("nu", "sigma")] = rows["s_nc"]
        tables[("nu", "deltaP")] = rows["dP_nc"] / rows["rho_nc"]
    if params.Omega_dcdm:
        # δ_dcdm ≡ δ_cdm in synchronous gauge; its own table entry so the
        # realizer can select species='dcdm' (reference linear.py species
        # registry exposes dcdm transfer functions from CLASS the same way)
        tables[("dcdm", "delta")] = rows["d_dcdm"]
        tables[("dcdm", "theta")] = rows["t_dcdm"] * inv_t
    if params.Omega_dcdm and params.Gamma_dcdm > 0:
        tables[("dr", "delta")] = rows["d_dr"]
        tables[("dr", "theta")] = rows["t_dr"] * inv_t
        tables[("dr", "sigma")] = rows["s_dr"]
    if params.Omega_fld and not (
        params.w0_fld == -1.0 and params.wa_fld == 0.0
    ):
        tables[("fld", "delta")] = rows["d_fld"]
        tables[("fld", "theta")] = rows["t_fld"] * inv_t
    # combined 'radiation' = photon + massless ν (reference species
    # registry linear.py:3517-3595: ρ-weighted δ, (ρ+P)-weighted θ;
    # both have w = 1/3, so the weights coincide)
    bg = EBBackground(params)
    w_g = bg.Omega_g / (bg.Omega_g + bg.Omega_ur) if bg.Omega_ur else 1.0
    tables[("radiation", "delta")] = (
        w_g * rows["d_g"] + (1 - w_g) * rows["d_ur"]
    )
    tables[("radiation", "theta")] = (
        w_g * rows["t_g"] + (1 - w_g) * rows["t_ur"]
    ) * inv_t
    tables[("radiation", "sigma")] = (
        w_g * rows["s_g"] + (1 - w_g) * rows["s_ur"]
    )
    # H_T' = 3 dℛ/dτ = 3 aH dℛ/dlna
    aH = np.asarray([ai * bg.H(ai) for ai in a])
    lna = np.log(a)
    HT_prime = 3.0 * np.gradient(rows["R_com"], lna, axis=0) * aH[:, None]
    aux = {
        "theta_tot": rows["theta_tot"] * inv_t,
        "h_prime": rows["h_prime"] * inv_t,
        "phi": rows["phi"],
        "psi": rows["psi"],
        "H_T_prime": HT_prime * inv_t,
    }
    if "alpha" in rows:
        # α = (h' + 6η')/(2k²), conformal-time units → unit-system time
        # (used by the synchronous → Newtonian gauge transform; absent
        # from disk caches written before it was exported — those still
        # serve every other gauge)
        aux["alpha"] = rows["alpha"] / inv_t
    return TransferTables(k=np.asarray(k_internal), a=a, tables=tables,
                          aux=aux, gauge="synchronous")
