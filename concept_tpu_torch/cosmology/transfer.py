"""Matter transfer functions.

The reference embeds the CLASS Boltzmann code in-process
(reference: src/commons.py:4647-4867 call_class; src/linear.py CosmoResults/
TransferFunction).  Here the default source is the Eisenstein & Hu (1998,
ApJ 496, 605) analytic transfer function — accurate to ~a few % for ΛCDM —
with the same downstream interface, so a CLASS-backed source (classy, when
installed) can be slotted in without touching the realization/analysis code.

All formulas below are the published EH98 fitting functions; k is taken in
internal units and converted to Mpc⁻¹ internally.  NumPy float64; the
other transfer kinds of concept_tpu/cosmology/transfer.py are not ported
yet (ROADMAP Queue 1 item 5).
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


def make_transfer(kind: str, Omega_m, Omega_b, h, Mpc=1.0):
    if kind in ("eisenstein_hu", "eh", "eisenstein-hu"):
        return EisensteinHuTransfer(Omega_m, Omega_b, h, Mpc)
    raise NotImplementedError(
        f"transfer kind {kind!r} (ROADMAP Queue 1 item 5)")
