"""FLRW background: a(t), t(a), H(a), growth factors and exact time-step
integrals ∫dt of a-dependent integrands, in NumPy float64.

Port of concept_tpu/cosmology/background.py (reference:
src/integration.py).  Matter + Λ (+ radiation), and the sectors the
reference reaches through class_params: massive neutrinos with their
exact Fermi-Dirac ρ_ν(a) (cosmology/neutrino.py), curvature Ω_k, a CPL
dark-energy fluid and decaying cold dark matter → dark radiation.  The
growth ODEs are the reference's (integration.py:1043-1263), solved with
scipy DOP853 at rtol 1e-12; a(t)/t(a) and the growth factors are log-log
cubic splines.  The tables take a fraction of a second to build, so
nothing is cached on disk.
"""

from __future__ import annotations

import math

import numpy as np

from concept_tpu_torch.cosmology.spline import Spline

_GL_ORDER = 24
_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(_GL_ORDER)


class Background:
    """Homogeneous FLRW background (matter + Λ, optional radiation and
    the exotic sectors below).

    Parameters
    ----------
    H0 : float
        Hubble constant in internal units (e.g. ``67*units.km/units.s/units.Mpc``).
    Omega_m : float
        Total matter density parameter today (Ωb + Ωcdm).
    Omega_lambda : float, optional
        Defaults to 1 - Omega_m - Omega_r (flat universe).
    Omega_r : float
        Radiation density today (0 to mirror the reference's internal
        matter+Λ background, reference integration.py:1243-1247).
    enable_Hubble : bool
        If False, the universe is static (a ≡ 1); mirrors the reference's
        ``enable_Hubble`` debugging parameter.
    cache_dir : str, optional
        Kept for the JAX package's signature; the port's tables take a
        fraction of a second and are not cached.
    """

    def __init__(
        self,
        H0: float,
        Omega_m: float,
        Omega_lambda: float | None = None,
        Omega_r: float = 0.0,
        enable_Hubble: bool = True,
        a_today: float = 1.0,
        cache_dir: str | None = None,
        Omega_nu: float = 0.0,
        nu_background=None,
        Omega_k: float = 0.0,
        Omega_fld: float = 0.0,
        w0_fld: float = -1.0,
        wa_fld: float = 0.0,
        Omega_dcdm: float = 0.0,
        Gamma_dcdm: float = 0.0,
        Omega_ini_dcdm: float | None = None,
    ):
        self.H0 = float(H0)
        self.Omega_m = float(Omega_m)
        self.Omega_r = float(Omega_r)
        # Massive neutrinos with their EXACT Fermi-Dirac ρ_ν(a) in the
        # Friedmann equation (∝ a⁻⁴ while relativistic, ∝ a⁻³ after the
        # non-relativistic transition) — lumping Ω_ν into Ω_m would bias
        # H(a) and every ᔑdt integral at IC-realization times a ~ 1e-3
        # (ADVICE r2; reference gets this via the CLASS background).
        self.Omega_nu = float(Omega_nu)
        self.nu_background = nu_background
        if self.Omega_nu and nu_background is None:
            raise ValueError("Omega_nu != 0 requires nu_background")
        # Exotic sectors (reference reaches these through class_params,
        # linear.py:3517-3595 + the CLASS background):
        #   * spatial curvature Ω_k (∝ a⁻² in the Friedmann equation)
        #   * CPL dark-energy fluid w(a) = w0 + wa(1−a) with the analytic
        #     density ρ_fld ∝ a^{−3(1+w0+wa)} e^{−3wa(1−a)}
        #   * decaying cold dark matter → dark radiation with decay rate Γ
        #     (proper-time rate; reference integration.py:712-863 threads
        #     the a^(−3w_eff)·Γ/H integral family for it)
        self.Omega_k = float(Omega_k)
        self.Omega_fld = float(Omega_fld)
        self.w0_fld = float(w0_fld)
        self.wa_fld = float(wa_fld)
        self.Omega_dcdm = float(Omega_dcdm)
        self.Gamma_dcdm = float(Gamma_dcdm)
        self.Omega_ini_dcdm = (
            None if Omega_ini_dcdm is None else float(Omega_ini_dcdm)
        )
        self._has_dcdm = bool(self.Omega_dcdm or self.Omega_ini_dcdm)
        self.Omega_dr = 0.0  # decay radiation today; filled by _solve_dcdm
        self._u_dcdm = None  # spline of u(a) = (ρ_dcdm/ρ_cr0)·a³ over ln a
        self._v_dr = None    # spline of v(a) = (ρ_dr/ρ_cr0)·a⁴ over ln a
        self._Omega_lambda_given = Omega_lambda
        if self._has_dcdm:
            self._solve_dcdm()  # also fixes Omega_lambda via flatness
        elif Omega_lambda is None:
            Omega_lambda = (
                1.0 - self.Omega_m - self.Omega_r - self.Omega_nu
                - self.Omega_k - self.Omega_fld
            )
            self.Omega_lambda = float(Omega_lambda)
        else:
            self.Omega_lambda = float(Omega_lambda)
        self.enable_Hubble = bool(enable_Hubble)
        self.a_today = float(a_today)
        self.cache_dir = cache_dir
        if self.enable_Hubble:
            self._install_tables(self._tabulate())

    # ------------------------------------------------------------------ #
    # Exotic sectors
    # ------------------------------------------------------------------ #
    def fld_rho_ratio_np(self, a):
        """ρ_fld(a)/ρ_fld(a=1) for the CPL fluid w(a) = w0 + wa(1−a):
        the closed form a^{−3(1+w0+wa)} e^{−3wa(1−a)} (the exact solution
        of ρ' = −3(1+w)ρ/a; reference gets it from the CLASS fld
        background, linear.py:3561-3570)."""
        a = np.asarray(a, dtype=np.float64)
        return a ** (-3 * (1 + self.w0_fld + self.wa_fld)) * np.exp(
            -3 * self.wa_fld * (1 - a)
        )

    def w_fld(self, a):
        """CPL equation of state w(a) = w0 + wa·(1−a) (NumPy/JAX agnostic)."""
        return self.w0_fld + self.wa_fld * (1 - a)

    def _solve_dcdm(self):
        """Self-consistent dcdm → dr background: in x = ln a,

            du/dx = −(Γ/H)·u          u ≡ (ρ_dcdm/ρ_cr0)·a³
            dv/dx = +(Γ/H)·u·a        v ≡ (ρ_dr  /ρ_cr0)·a⁴

        with H built from ALL sectors including u, v themselves.  The
        total ρ_dcdm a³ + (energy flowed to dr) is conserved by
        construction; equivalently u(a) = u_ini·e^{−Γ·(t(a)−t_ini)}
        exactly, which tests/test_background_exotic.py asserts.
        Closure: Ω_Λ from flatness including Ω_dr(today); if Ω_dcdm
        (today) is given, the initial amplitude is shot so u(1) hits it
        (reference/CLASS shoots Omega_ini_dcdm the same way); both are
        resolved by a short fixed-point iteration.
        """
        import scipy.integrate

        H0 = self.H0
        gamma = self.Gamma_dcdm
        a_ini = 1e-14
        x_ini = math.log(a_ini)
        target = self.Omega_dcdm if self.Omega_ini_dcdm is None else None
        u0 = (
            self.Omega_ini_dcdm
            if self.Omega_ini_dcdm is not None
            else max(self.Omega_dcdm, 1e-30)
        )
        base_flat = (
            1.0 - self.Omega_m - self.Omega_r - self.Omega_nu
            - self.Omega_k - self.Omega_fld
        )
        Ol = (
            self._Omega_lambda_given
            if self._Omega_lambda_given is not None
            else base_flat - u0
        )
        xs = np.linspace(x_ini, 0.0, 2048)
        sol_y = None
        for _ in range(80):
            def rhs(x, y, Ol=Ol):
                u, v = y
                a = math.exp(x)
                E2 = (
                    self.Omega_r / a**4 + self.Omega_m / a**3
                    + self.Omega_k / a**2
                    + self.Omega_fld * float(self.fld_rho_ratio_np(a))
                    + Ol + u / a**3 + v / a**4
                )
                if self.Omega_nu:
                    E2 += self.Omega_nu * float(
                        self.nu_background.rho_ratio_np(a)
                    )
                H = H0 * math.sqrt(max(E2, 1e-300))
                rate = gamma / H if gamma else 0.0
                return [-rate * u, rate * u * a]

            sol = scipy.integrate.solve_ivp(
                rhs, (x_ini, 0.0), [u0, 0.0], t_eval=xs,
                method="DOP853", rtol=1e-11, atol=u0 * 1e-16,
            )
            u1, v1 = float(sol.y[0, -1]), float(sol.y[1, -1])
            err = 0.0
            # DAMPED updates: at Γ ≫ H0 the plain fixed point oscillates
            # (Ω_dr feedback on H has near-unit gain); half-steps converge
            if target is not None and u1 > 0:
                fac = target / u1
                err = max(err, abs(fac - 1))
                u0 *= math.sqrt(fac)
            if self._Omega_lambda_given is None:
                Ol_new = base_flat - u1 - v1
                err = max(err, abs(Ol_new - Ol))
                Ol = 0.5 * (Ol + Ol_new)
            sol_y = sol.y
            if err < 1e-12:
                break
        self.Omega_lambda = float(Ol)
        self.Omega_dcdm = float(sol_y[0, -1])
        self.Omega_dr = float(sol_y[1, -1])
        self.Omega_ini_dcdm = float(u0)
        a_tab = np.exp(xs)
        self._u_dcdm = Spline(a_tab, np.maximum(sol_y[0], 1e-300),
                              logx=True, logy=True)
        # v starts at exactly 0: spline v linearly (not log) over ln a
        self._v_dr = Spline(a_tab, sol_y[1], logx=True, logy=False)

    def rho_ratio_dcdm_np(self, a):
        """ρ_dcdm(a)/ρ_cr0 (NumPy)."""
        if self._u_dcdm is None:
            return np.zeros_like(np.asarray(a, dtype=np.float64))
        a = np.asarray(a, dtype=np.float64)
        return self._u_dcdm.eval_np(a) / a**3

    def rho_ratio_dr_np(self, a):
        """ρ_dr(a)/ρ_cr0 (NumPy)."""
        if self._v_dr is None:
            return np.zeros_like(np.asarray(a, dtype=np.float64))
        a = np.asarray(a, dtype=np.float64)
        return np.maximum(self._v_dr.eval_np(a), 0.0) / a**4

    def w_eff_dcdm_np(self, a):
        """Effective EoS of dcdm: ρ(a) = ρ₀·a^{−3(1+w_eff)} ⇒
        w_eff(a) = −ln(u(a)/u(1)) / (3 ln a) (reference species w_eff
        machinery feeding the ᔑdt a^(−3w_eff) keys)."""
        a = np.asarray(a, dtype=np.float64)
        u = self._u_dcdm.eval_np(a)
        u1 = self._u_dcdm.eval_np(1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            w = -np.log(u / u1) / (3 * np.log(a))
        return np.where(np.abs(np.log(a)) < 1e-12, 0.0, w)

    # ------------------------------------------------------------------ #
    def _E2_np(self, a):
        """H²/H0²."""
        E2 = self.Omega_r / a**4 + self.Omega_m / a**3 + self.Omega_lambda
        if self.Omega_nu:
            E2 = E2 + self.Omega_nu * self.nu_background.rho_ratio_np(a)
        if self.Omega_k:
            E2 = E2 + self.Omega_k / a**2
        if self.Omega_fld:
            E2 = E2 + self.Omega_fld * self.fld_rho_ratio_np(a)
        if self._has_dcdm:
            E2 = E2 + self.rho_ratio_dcdm_np(a) + self.rho_ratio_dr_np(a)
        return E2

    def hubble_np(self, a):
        """H(a) (float64). Reference: src/integration.py:570-600."""
        if not self.enable_Hubble:
            return np.zeros_like(np.asarray(a, dtype=np.float64)) + 0.0
        a = np.asarray(a, dtype=np.float64)
        return self.H0 * np.sqrt(self._E2_np(a))

    def adot_np(self, a):
        """ȧ = a·H(a)."""
        a = np.asarray(a, dtype=np.float64)
        return a * self.hubble_np(a)

    def addot_np(self, a):
        """ä = a·H0²·[E² + (a/2)·dE²/da] (Friedmann acceleration,
        reference integration.py ä; used by the N-body gauge θ transform,
        reference linear.py:2826-2834).  For matter+Λ(+radiation) this is
        the familiar Ω_Λ − Ω_m/(2a³) − Ω_r/a⁴; the ν term is differenced
        numerically on its smooth w_eff spline."""
        if not self.enable_Hubble:
            return np.zeros_like(np.asarray(a, dtype=np.float64))
        a = np.asarray(a, dtype=np.float64)
        if self._exotic:
            # general sectors: difference the full E²(a) numerically
            eps = 1e-5
            dE2_da = (self._E2_np(a * (1 + eps)) - self._E2_np(a * (1 - eps))) / (
                2 * eps * a
            )
            return a * self.H0**2 * (self._E2_np(a) + 0.5 * a * dE2_da)
        base = (
            self.Omega_lambda - 0.5 * self.Omega_m / a**3 - self.Omega_r / a**4
        )
        if self.Omega_nu:
            eps = 1e-4
            rho = self.nu_background.rho_ratio_np
            dE2_da = self.Omega_nu * (
                rho(a * (1 + eps)) - rho(a * (1 - eps))
            ) / (2 * eps * a)
            base = base + self.Omega_nu * rho(a) + 0.5 * a * dE2_da
        return a * self.H0**2 * base

    hubble = hubble_np

    @property
    def _exotic(self) -> bool:
        return bool(self.Omega_k or self.Omega_fld or self._has_dcdm)

    # ------------------------------------------------------------------ #
    def _install_tables(self, tables: dict):
        a_values = tables["a"]
        t_values = tables["t"]
        self.t_begin_bg, self.t_today = float(t_values[0]), float(t_values[-1])
        self._a_of_t = Spline(t_values, a_values, logx=True, logy=True)
        self._t_of_a = Spline(a_values, t_values, logx=True, logy=True)
        self._growth = {}
        for name in ("D1", "f1", "D2", "f2", "D3a", "f3a", "D3b", "f3b", "D3c", "f3c"):
            vals = tables[name]
            self._growth[name] = Spline(a_values, np.abs(vals), logx=True, logy=True)
            self._growth[name + "_sign"] = float(np.sign(vals[-1]))
        # D_md(a) = D1(a) * D_md_today: growth normalised to D = a deep in
        # matter domination (used in the transfer-function normalisation).
        self.D_md_today = float(tables.get("D_md_today", 1.0))

    def _tabulate(self) -> dict:
        import scipy.integrate

        a_begin = 1e-14
        t_begin = 2 / (3 * self.hubble_np(a_begin))
        kwargs = dict(method="DOP853", rtol=1e-12, atol=0.0)

        def dloga_dlogt(logt, loga):
            return [math.exp(logt) * float(self.hubble_np(math.exp(loga[0])))]

        def event(logt, loga):
            return loga[0] - math.log(self.a_today)

        event.terminal = True
        sol = scipy.integrate.solve_ivp(
            dloga_dlogt, (math.log(t_begin), math.inf), [math.log(a_begin)],
            events=event, **kwargs,
        )
        t_today = math.exp(sol.t_events[0][0])
        n_bg = int(math.log(self.a_today / a_begin) / 7e-3)
        logt_values = np.linspace(math.log(t_begin), math.log(t_today), n_bg)
        t_values = np.exp(logt_values)
        a_values = np.exp(
            scipy.integrate.solve_ivp(
                dloga_dlogt, (logt_values[0], logt_values[-1]), [math.log(a_begin)],
                t_eval=logt_values, **kwargs,
            ).y[0]
        )
        t_values[0], t_values[-1] = t_begin, t_today
        a_values[0], a_values[-1] = a_begin, self.a_today

        # Growth factors (ODE system identical to reference
        # integration.py:1215-1263).  For exotic backgrounds (Ωk, fld,
        # dcdm) the friction term uses the full numerically-differenced
        # E²(a) and the source uses the CLUSTERING matter Ωm + ρ_dcdm a³
        # (dcdm falls like CDM); the matter+Λ closed form is kept when no
        # exotic sector is present (bit-identical to previous rounds).
        Om, H0 = self.Omega_m, self.H0
        exotic = self._exotic

        def hub(a):
            return H0 * math.sqrt(Om / a**3 + self.Omega_lambda)

        def dgrowth_da(a, y):
            D, dD, D2, dD2, D3a, dD3a, D3b, dD3b, D3c, dD3c = y
            if exotic:
                eps = 1e-5
                E2 = float(self._E2_np(a))
                dE2_da = float(
                    self._E2_np(a * (1 + eps)) - self._E2_np(a * (1 - eps))
                ) / (2 * eps * a)
                dH_da_over_H = dE2_da / (2 * E2)
                Om_cl = Om + (
                    float(self._u_dcdm.eval_np(a)) if self._has_dcdm else 0.0
                )
                g = -(3 / a + dH_da_over_H)
                s = 1.5 * Om_cl / (E2 * a**5)
                return [
                    dD, g * dD + s * D,
                    dD2, g * dD2 + s * (D2 + D**2),
                    dD3a, g * dD3a + s * (D3a + 2 * D**3),
                    dD3b, g * dD3b + s * (D3b + 2 * D * D2 + 2 * D**3),
                    dD3c, g * dD3c + s * D**3,
                ]
            dH_da_over_H = -1.5 * Om * (H0 / hub(a)) ** 2 / a**4
            g = -(3 / a + dH_da_over_H)
            s = -dH_da_over_H / a
            return [
                dD, g * dD + s * D,
                dD2, g * dD2 + s * (D2 + D**2),
                dD3a, g * dD3a + s * (D3a + 2 * D**3),
                dD3b, g * dD3b + s * (D3b + 2 * D * D2 + 2 * D**3),
                dD3c, g * dD3c + s * D**3,
            ]

        ab = a_begin
        y0 = [
            ab, 1.0,
            3 / 7 * ab**2, 6 / 7 * ab,
            1 / 3 * ab**3, ab**2,
            10 / 21 * ab**3, 10 / 7 * ab**2,
            1 / 7 * ab**3, 3 / 7 * ab**2,
        ]
        gsol = scipy.integrate.solve_ivp(
            dgrowth_da, (a_begin, self.a_today), y0, t_eval=a_values, **kwargs
        )
        D, dD, D2, dD2, D3a, dD3a, D3b, dD3b, D3c, dD3c = gsol.y
        f = dD * a_values / D
        f2 = dD2 * a_values / D2
        f3a = dD3a * a_values / D3a
        f3b = dD3b * a_values / D3b
        f3c = dD3c * a_values / D3c
        norm = 1 / D[-1]
        D = D * norm
        D[-1] = 1.0
        D2 = D2 * norm**2
        D3a, D3b, D3c = D3a * norm**3, D3b * norm**3, D3c * norm**3
        return {
            "a": a_values, "t": t_values,
            "D1": D, "f1": f, "D2": D2, "f2": f2,
            "D3a": D3a, "f3a": f3a, "D3b": D3b, "f3b": f3b,
            "D3c": D3c, "f3c": f3c,
            # the unnormalised solution has D(a) = a deep in matter
            # domination, so D_md(a) = D1(a)/norm
            "D_md_today": np.array(1 / norm),
        }

    # ------------------------------------------------------------------ #
    def a_of_t_np(self, t):
        if not self.enable_Hubble:
            return np.ones_like(np.asarray(t, dtype=np.float64))
        return self._a_of_t.eval_np(t)

    def t_of_a_np(self, a):
        return self._t_of_a.eval_np(a)

    def growth_np(self, name: str, a):
        """Growth factor/rate lookup. name ∈ {D1,f1,D2,f2,D3a,...}."""
        return self._growth[name].eval_np(a) * self._growth[name + "_sign"]

    growth = growth_np

    # ------------------------------------------------------------------ #
    @staticmethod
    def integrand(key: str, a, adot_over_a):
        """Named integrand at scale factor a (reference main.py:1002-1025)."""
        if key == "1":
            return a * 0 + 1.0
        if key == "a**2":
            return a**2
        if key == "a**(-1)":
            return 1 / a
        if key == "a**(-2)":
            return 1 / a**2
        if key in ("ȧ/a", "adot/a"):
            return adot_over_a
        raise KeyError(f"unknown integrand key {key!r}")

    def integral_power_np(self, t1, t2, p: float) -> float:
        """∫ a(t)^p dt — the per-component integrand keys
        'a**(3*w_eff-2)', 'a**(-3*w_eff)', ... of constant-w species
        (reference main.py:1002-1025)."""
        half = (t2 - t1) / 2
        mid = (t2 + t1) / 2
        tq = mid + half * _GL_NODES
        aq = self.a_of_t_np(tq)
        return float(half * np.sum(_GL_WEIGHTS * aq**p))

    def integral_custom_np(self, t1, t2, fn) -> float:
        """∫ fn(a(t)) dt for arbitrary integrands — the reference's
        w_eff(a)-dependent keys ('a**(3*w_eff-2)', 'a**(-3*w_eff)',
        'a**(-3*w_eff)*Γ/H', main.py:1002-1025)."""
        half = (t2 - t1) / 2
        mid = (t2 + t1) / 2
        tq = mid + half * _GL_NODES
        aq = self.a_of_t_np(tq) if self.enable_Hubble else np.ones_like(tq)
        return float(half * np.sum(_GL_WEIGHTS * np.asarray(fn(aq), np.float64)))

    def integrals_np(self, t1, t2, keys=("1", "a**2", "a**(-1)", "a**(-2)", "ȧ/a")):
        """∫_{t1}^{t2} integrand(a(t)) dt for each key: fixed-order
        Gauss-Legendre quadrature on the a(t) spline (replaces the
        reference's GSL spline integration, integration.py:712-863)."""
        half = (t2 - t1) / 2
        mid = (t2 + t1) / 2
        tq = mid + half * _GL_NODES
        aq = self.a_of_t_np(tq)
        adot_over_a = self.hubble_np(aq)
        out = {}
        for key in keys:
            vals = self.integrand(key, aq, adot_over_a)
            out[key] = float(half * np.sum(_GL_WEIGHTS * vals))
        return out

    def rho_crit_of(self, G_Newton: float) -> float:
        """ρ_crit = 3H0²/(8πG) (reference commons.py:4435)."""
        return 3 * self.H0**2 / (8 * math.pi * G_Newton)
