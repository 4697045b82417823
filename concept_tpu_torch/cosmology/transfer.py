"""Matter transfer functions.

The reference embeds the CLASS Boltzmann code in-process
(reference: src/commons.py:4647-4867 call_class; src/linear.py CosmoResults/
TransferFunction).  Here the default source is the Eisenstein & Hu (1998,
ApJ 496, 605) analytic transfer function — accurate to ~a few % for ΛCDM —
with the same downstream interface, so a CLASS-backed source (classy, when
installed) can be slotted in without touching the realization/analysis code.

All formulas below are the published EH98 fitting functions; k is taken in
internal units and converted to Mpc⁻¹ internally.  NumPy float64
(port of concept_tpu/cosmology/transfer.py): the full EH98 function, its
no-wiggle shape and the EH99 massive-neutrino functions.
"""

from __future__ import annotations

import math

import numpy as np

T_CMB = 2.7255  # K


class EisensteinHuTransfer:
    """Full EH98 transfer function (with baryon acoustic features).

    Normalised to T(k→0) = 1.
    """

    def __init__(self, Omega_m: float, Omega_b: float, h: float, Mpc: float = 1.0):
        """Mpc: the value of one Mpc in internal length units (so that k
        given in internal units can be converted to Mpc⁻¹)."""
        self.Omega_m, self.Omega_b, self.h = Omega_m, Omega_b, h
        self.Mpc = Mpc
        om = Omega_m * h * h
        ob = Omega_b * h * h
        oc = om - ob
        fb = Omega_b / Omega_m
        fc = 1.0 - fb
        theta = T_CMB / 2.7
        self.theta = theta

        # Matter-radiation equality and the sound horizon (EH98 eqs. 2-6)
        z_eq = 2.50e4 * om / theta**4
        k_eq = 7.46e-2 * om / theta**2  # Mpc^-1
        b1 = 0.313 * om**-0.419 * (1 + 0.607 * om**0.674)
        b2 = 0.238 * om**0.223
        z_d = 1291 * om**0.251 / (1 + 0.659 * om**0.828) * (1 + b1 * ob**b2)
        R_d = 31.5 * ob / theta**4 * (1e3 / z_d)
        R_eq = 31.5 * ob / theta**4 * (1e3 / z_eq)
        s = (
            2
            / (3 * k_eq)
            * math.sqrt(6 / R_eq)
            * math.log(
                (math.sqrt(1 + R_d) + math.sqrt(R_d + R_eq)) / (1 + math.sqrt(R_eq))
            )
        )
        k_silk = 1.6 * ob**0.52 * om**0.73 * (1 + (10.4 * om) ** -0.95)  # Mpc^-1

        # CDM coefficients (eqs. 11-12)
        a1 = (46.9 * om) ** 0.670 * (1 + (32.1 * om) ** -0.532)
        a2 = (12.0 * om) ** 0.424 * (1 + (45.0 * om) ** -0.582)
        alpha_c = a1**-fb * a2 ** (-(fb**3))
        bb1 = 0.944 / (1 + (458 * om) ** -0.708)
        bb2 = (0.395 * om) ** -0.0266
        beta_c = 1 / (1 + bb1 * (fc**bb2 - 1))

        # Baryon coefficients (eqs. 14-24)
        y = (1 + z_eq) / (1 + z_d)
        sq = math.sqrt(1 + y)
        G = y * (-6 * sq + (2 + 3 * y) * math.log((sq + 1) / (sq - 1)))
        alpha_b = 2.07 * k_eq * s * (1 + R_d) ** -0.75 * G
        beta_b = 0.5 + fb + (3 - 2 * fb) * math.sqrt((17.2 * om) ** 2 + 1)
        beta_node = 8.41 * om**0.435

        self.k_eq, self.s, self.k_silk = k_eq, s, k_silk
        self.alpha_c, self.beta_c = alpha_c, beta_c
        self.alpha_b, self.beta_b, self.beta_node = alpha_b, beta_b, beta_node
        self.fb, self.fc = fb, fc

    @staticmethod
    def _T0(q, alpha_c, beta_c):
        e = math.e
        C = 14.2 / alpha_c + 386.0 / (1 + 69.9 * q**1.08)
        L = np.log(e + 1.8 * beta_c * q)
        return L / (L + C * q * q)

    def __call__(self, k):
        """T(k), k in internal units."""
        k = np.asarray(k, dtype=np.float64)
        kmpc = k * self.Mpc  # → Mpc^-1
        kmpc = np.maximum(kmpc, 1e-12)
        q = kmpc / (13.41 * self.k_eq)
        ks = kmpc * self.s
        # CDM part (eq. 17-18)
        f = 1 / (1 + (ks / 5.4) ** 4)
        Tc = f * self._T0(q, 1.0, self.beta_c) + (1 - f) * self._T0(
            q, self.alpha_c, self.beta_c
        )
        # Baryon part (eq. 21)
        s_tilde = self.s / (1 + (self.beta_node / ks) ** 3) ** (1 / 3)
        x = kmpc * s_tilde
        j0 = np.sinc(x / math.pi)  # sin(x)/x
        Tb = (
            self._T0(q, 1.0, 1.0) / (1 + (ks / 5.2) ** 2)
            + self.alpha_b / (1 + (self.beta_b / ks) ** 3) * np.exp(-((kmpc / self.k_silk) ** 1.4))
        ) * j0
        return self.fb * Tb + self.fc * Tc


class EisensteinHuNoWiggle:
    """EH98 'no-wiggle' shape (eq. 29-31) — smooth BAO-free variant."""

    def __init__(self, Omega_m: float, Omega_b: float, h: float, Mpc: float = 1.0):
        om = Omega_m * h * h
        ob = Omega_b * h * h
        fb = Omega_b / Omega_m
        theta = T_CMB / 2.7
        s = 44.5 * math.log(9.83 / om) / math.sqrt(1 + 10 * ob**0.75)  # Mpc
        alpha = (
            1
            - 0.328 * math.log(431 * om) * fb
            + 0.38 * math.log(22.3 * om) * fb**2
        )
        self.om, self.theta, self.s, self.alpha = om, theta, s, alpha
        self.Mpc = Mpc

    def __call__(self, k):
        kmpc = np.maximum(np.asarray(k, dtype=np.float64) * self.Mpc, 1e-12)
        gamma_eff = self.om * (
            self.alpha + (1 - self.alpha) / (1 + (0.43 * kmpc * self.s) ** 4)
        )
        q = kmpc * self.theta**2 / gamma_eff
        L = np.log(2 * math.e + 1.8 * q)
        C = 14.2 + 731.0 / (1 + 62.5 * q)
        return L / (L + C * q * q)


class EisensteinHuNuTransfer:
    """Eisenstein & Hu (1999, ApJ 511, 5) transfer functions with massive
    neutrinos: master shape T(k), scale-dependent growth suppression for
    CDM+baryon (cb) and total matter (cbν).

    Replaces the CLASS massive-neutrino transfer path of the reference
    (linear.py species 'neutrino'/'matter', linear.py:3517-3595) when
    classy is unavailable.  Published fitting formulas; ~few-% accuracy
    for f_ν ≲ 0.3.
    """

    def __init__(self, Omega_m, Omega_b, Omega_nu, h, N_nu=3, Mpc=1.0):
        self.Mpc = Mpc
        om = Omega_m * h * h
        ob = Omega_b * h * h
        f_nu = Omega_nu / Omega_m
        f_b = Omega_b / Omega_m
        f_c = 1.0 - f_nu - f_b
        f_cb = f_c + f_b
        f_nub = f_nu + f_b
        theta = T_CMB / 2.7
        z_eq = 2.50e4 * om / theta**4
        b1 = 0.313 * om**-0.419 * (1 + 0.607 * om**0.674)
        b2 = 0.238 * om**0.223
        z_d = 1291 * om**0.251 / (1 + 0.659 * om**0.828) * (1 + b1 * ob**b2)
        y_d = (1 + z_eq) / (1 + z_d)
        s = 44.5 * math.log(9.83 / om) / math.sqrt(1 + 10 * ob**0.75)  # Mpc
        p_c = 0.25 * (5 - math.sqrt(1 + 24 * f_c))
        p_cb = 0.25 * (5 - math.sqrt(1 + 24 * f_cb))
        alpha_nu = (
            (f_c / f_cb)
            * (5 - 2 * (p_c + p_cb)) / (5 - 4 * p_cb)
            * (1 - 0.553 * f_nub + 0.126 * f_nub**3)
            / (1 - 0.193 * math.sqrt(f_nu * N_nu) + 0.169 * f_nu * N_nu**0.2)
            * (1 + y_d) ** (p_cb - p_c)
            * (1 + (p_c - p_cb) / 2 * (1 + 1 / ((3 - 4 * p_c) * (7 - 4 * p_cb))) / (1 + y_d))
        )
        self.om, self.theta, self.s = om, theta, s
        self.f_nu, self.f_b, self.f_c, self.f_cb = f_nu, f_b, f_c, f_cb
        self.p_c, self.p_cb, self.alpha_nu, self.N_nu = p_c, p_cb, alpha_nu, N_nu
        self.beta_c = 1 / (1 - 0.949 * f_nub)
        self.z_eq = z_eq

    def _q(self, kmpc):
        return kmpc * self.theta**2 / self.om

    def master(self, k):
        """Shape T(k) (EH99 eqs. 15-24), normalised to 1 at k→0."""
        kmpc = np.maximum(np.asarray(k, dtype=np.float64) * self.Mpc, 1e-12)
        q = self._q(kmpc)
        ks = kmpc * self.s
        gamma_eff = self.om * (
            math.sqrt(self.alpha_nu)
            + (1 - math.sqrt(self.alpha_nu)) / (1 + (0.43 * ks) ** 4)
        )
        q_eff = kmpc * self.theta**2 / gamma_eff
        L = np.log(math.e + 1.84 * self.beta_c * math.sqrt(self.alpha_nu) * q_eff)
        C = 14.4 + 325.0 / (1 + 60.5 * q_eff**1.11)
        T_sup = L / (L + C * q_eff**2)
        if self.f_nu > 0:
            q_nu = 3.92 * q * math.sqrt(self.N_nu / self.f_nu)
            B = 1 + (1.24 * self.f_nu**0.64 * self.N_nu ** (0.3 + 0.6 * self.f_nu)) / (
                q_nu**-1.6 + q_nu**0.8
            )
        else:
            B = 1.0
        return T_sup * B

    def growth_ratio(self, k, D_md, species: str = "cb"):
        """Scale-dependent growth D_species(k,a)/D1(a) (EH99 eqs. 10-12).

        D_md: EdS-normalised growth (D = a in matter domination) at the
        target epoch — supplied by Background.growth('D1')·D_md_today.
        species: 'cb' (CDM+baryons) or 'cbnu' (total matter).
        """
        if self.f_nu == 0:
            return np.ones_like(np.asarray(k, dtype=np.float64))
        kmpc = np.maximum(np.asarray(k, dtype=np.float64) * self.Mpc, 1e-12)
        q = self._q(kmpc)
        y_fs = 17.2 * self.f_nu * (1 + 0.488 * self.f_nu ** (-7 / 6)) * (
            self.N_nu * q / self.f_nu
        ) ** 2
        # EH99 use D1 normalised to (1+z_eq)a in their convention; the
        # growth-ratio combination below is invariant under the overall
        # normalisation except through D/(1+y_fs); use D_eq = D_md(1+z_eq)
        D = D_md * (1 + self.z_eq)
        if species == "cb":
            p = self.p_cb
            out = (1 + (D / (1 + y_fs)) ** 0.7) ** (p / 0.7) * D ** (-p)
        elif species in ("cbnu", "m", "matter"):
            p = self.p_cb
            out = (
                (self.f_cb ** (0.7 / p) + (D / (1 + y_fs)) ** 0.7) ** (p / 0.7)
                * D ** (-p)
            )
        else:
            raise ValueError(species)
        return out


def k_is_f64(k):
    """True where k is float64 (a NumPy array, a tensor or a float)."""
    dtype = getattr(k, "dtype", None)
    if dtype is None:
        return isinstance(k, float)
    return str(dtype) in ("float64", "torch.float64")


def make_transfer(kind: str, Omega_m, Omega_b, h, Mpc=1.0):
    if kind in ("eisenstein_hu", "eh", "eisenstein-hu"):
        return EisensteinHuTransfer(Omega_m, Omega_b, h, Mpc)
    if kind in ("eisenstein_hu_nowiggle", "nowiggle"):
        return EisensteinHuNoWiggle(Omega_m, Omega_b, h, Mpc)
    if kind == "class":
        raise ModuleNotFoundError(
            "CLASS (classy) is not installed in this environment; "
            "use transfer='eisenstein_hu' or install classy"
        )
    raise ValueError(f"unknown transfer kind {kind!r}")
