"""FLRW background: a(t), t(a), H(a), growth factors and exact time-step
integrals ∫dt of a-dependent integrands, in NumPy float64.

Port of concept_tpu/cosmology/background.py for the matter + Λ
(+ radiation) background of the default run (reference:
src/integration.py).  The growth ODEs are the reference's
(integration.py:1043-1263), solved with scipy DOP853 at rtol 1e-12;
a(t)/t(a) and the growth factors are log-log cubic splines.  The tables
take a fraction of a second to build, so nothing is cached on disk.

Massive neutrinos, curvature, dark-energy fluids and decaying dark
matter are not ported yet (ROADMAP Queue 1 item 5); run.build_cosmology
refuses them.
"""

from __future__ import annotations

import math

import numpy as np

from concept_tpu_torch.cosmology.spline import Spline

_GL_ORDER = 24
_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(_GL_ORDER)


class Background:
    """Homogeneous FLRW background (matter + Λ, optional radiation).

    H0 in internal units; Omega_m = Ωb + Ωcdm today; Omega_lambda
    defaults to flatness.  enable_Hubble=False gives a static universe
    (a ≡ 1), the reference's debugging switch.
    """

    def __init__(
        self,
        H0: float,
        Omega_m: float,
        Omega_lambda: float | None = None,
        Omega_r: float = 0.0,
        enable_Hubble: bool = True,
        a_today: float = 1.0,
    ):
        self.H0 = float(H0)
        self.Omega_m = float(Omega_m)
        self.Omega_r = float(Omega_r)
        if Omega_lambda is None:
            Omega_lambda = 1.0 - self.Omega_m - self.Omega_r
        self.Omega_lambda = float(Omega_lambda)
        self.enable_Hubble = bool(enable_Hubble)
        self.a_today = float(a_today)
        if self.enable_Hubble:
            self._install_tables(self._tabulate())

    # ------------------------------------------------------------------ #
    def _E2_np(self, a):
        """H²/H0²."""
        return self.Omega_r / a**4 + self.Omega_m / a**3 + self.Omega_lambda

    def hubble_np(self, a):
        """H(a) (float64). Reference: src/integration.py:570-600."""
        if not self.enable_Hubble:
            return np.zeros_like(np.asarray(a, dtype=np.float64)) + 0.0
        a = np.asarray(a, dtype=np.float64)
        return self.H0 * np.sqrt(self._E2_np(a))

    hubble = hubble_np

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

        # growth factors: ODE system of reference integration.py:1215-1263.
        # The 2LPT/3LPT factors ride along although only 1LPT is ported:
        # with the same system the adaptive steps equal the JAX package's,
        # and D1 agrees with it to the last digit
        Om, H0 = self.Omega_m, self.H0

        def hub(a):
            return H0 * math.sqrt(Om / a**3 + self.Omega_lambda)

        def dgrowth_da(a, y):
            D, dD, D2, dD2, D3a, dD3a, D3b, dD3b, D3c, dD3c = y
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
