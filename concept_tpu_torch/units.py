"""Dynamic physical unit system.

The user picks the fundamental length, time and mass units (defaults:
Mpc, Gyr, 10^10 m_sun); every other unit and physical constant is derived
from them, so that all numbers in the program are expressed in the chosen
system.  Behavioral parity with reference: src/commons.py:1826-1905 (unit
relations), 2046-2134 (unit struct + constants).

All unit values here are plain Python floats (host side); they are baked
into jitted computations as trace-time constants.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

TAU = 2 * math.pi

# Unicode aliases accepted in unit strings
_UNICODE_ALIASES = {
    "m☉": "m_sun",
    "km☉": "km_sun",
    "Mm☉": "Mm_sun",
    "Gm☉": "Gm_sun",
    "¹⁰": "**10",
    "×": "*",
    "⁻": "**-",
}


def _base_unit_relations() -> dict:
    """Relations of all implemented units to the basis (pc, yr, m_sun).

    Values follow reference: src/commons.py:1834-1888 (exact definitions:
    Julian year, IAU AU/parsec, CGPM light year, PDG 2019 solar mass and
    G_Newton, 2019 exact h-bar).
    """
    rel = {"yr": 1.0, "pc": 1.0, "m_sun": 1.0}
    # Time units
    rel["kyr"] = 1e3 * rel["yr"]
    rel["Myr"] = 1e6 * rel["yr"]
    rel["Gyr"] = 1e9 * rel["yr"]
    rel["day"] = 1 / 365.25 * rel["yr"]  # exact Julian year
    rel["hr"] = 1 / 24 * rel["day"]
    rel["minutes"] = 1 / 60 * rel["hr"]
    rel["s"] = 1 / 60 * rel["minutes"]
    # Length units
    rel["kpc"] = 1e3 * rel["pc"]
    rel["Mpc"] = 1e6 * rel["pc"]
    rel["Gpc"] = 1e9 * rel["pc"]
    rel["AU"] = TAU / (60 * 60 * 360) * rel["pc"]  # IAU 2015
    rel["m"] = 1 / 149597870700 * rel["AU"]  # IAU 2012
    rel["mm"] = 1e-3 * rel["m"]
    rel["cm"] = 1e-2 * rel["m"]
    rel["km"] = 1e3 * rel["m"]
    rel["ly"] = (299792458 * rel["m"] / rel["s"]) * rel["yr"]  # CGPM 1983
    rel["kly"] = 1e3 * rel["ly"]
    rel["Mly"] = 1e6 * rel["ly"]
    rel["Gly"] = 1e9 * rel["ly"]
    # Mass units
    rel["km_sun"] = 1e3 * rel["m_sun"]
    rel["Mm_sun"] = 1e6 * rel["m_sun"]
    rel["Gm_sun"] = 1e9 * rel["m_sun"]
    rel["kg"] = 1 / 1.98841e30 * rel["m_sun"]  # PDG 2019
    rel["g"] = 1e-3 * rel["kg"]
    # Energy units
    rel["J"] = rel["kg"] * rel["m"] ** 2 * rel["s"] ** (-2)
    rel["eV"] = 1.602176634e-19 * rel["J"]  # exact, 2019
    rel["meV"] = 1e-3 * rel["eV"]
    rel["keV"] = 1e3 * rel["eV"]
    rel["MeV"] = 1e6 * rel["eV"]
    rel["GeV"] = 1e9 * rel["eV"]
    rel["TeV"] = 1e12 * rel["eV"]
    # Constants as units
    rel["light_speed"] = rel["c"] = rel["ly"] / rel["yr"]
    rel["h_bar"] = rel["hbar"] = 6.62607015e-34 / TAU * rel["kg"] * rel["m"] ** 2 / rel["s"]
    rel["G_Newton"] = rel["G"] = 6.67430e-11 * rel["m"] ** 3 / (rel["kg"] * rel["s"] ** 2)
    return rel


def unformat_unit(unit_str: str) -> str:
    """Normalise a unit string: unicode → ASCII python expression."""
    s = unit_str
    for uni, ascii_ in _UNICODE_ALIASES.items():
        s = s.replace(uni, ascii_)
    # Superscript digits → **N
    superscripts = "⁰¹²³⁴⁵⁶⁷⁸⁹"
    out = []
    i = 0
    while i < len(s):
        ch = s[i]
        if ch in superscripts:
            num = ""
            while i < len(s) and s[i] in superscripts:
                num += str(superscripts.index(s[i]))
                i += 1
            out.append(f"**{num}")
        else:
            out.append(ch)
            i += 1
    s = "".join(out)
    # '10**10 m_sun' → '10**10*m_sun'
    s = s.strip()
    import re

    s = re.sub(r"(\d)\s+([A-Za-z])", r"\1*\2", s)
    s = re.sub(r"([A-Za-z_0-9])\s+([A-Za-z])", r"\1*\2", s)
    return s


def eval_unit(unit_str: str, namespace: dict) -> float:
    """Evaluate a unit expression like 'Mpc', '10**10*m_sun', 'km/s'."""
    expr = unformat_unit(unit_str)
    return float(eval(expr, {"__builtins__": {}}, dict(namespace)))


class UnitSystem:
    """A concrete unit system fixed by the user's choice of fundamental units.

    Attributes are unit values (floats): ``units.Mpc``, ``units.Gyr``,
    ``units.km``, ... and the namespace also contains physical constants via
    :meth:`constants`.
    """

    def __init__(
        self,
        unit_length: str = "Mpc",
        unit_time: str = "Gyr",
        unit_mass: str = "10**10 m_sun",
    ):
        rel = _base_unit_relations()
        self.unit_length = unformat_unit(unit_length)
        self.unit_time = unformat_unit(unit_time)
        self.unit_mass = unformat_unit(unit_mass)
        # Basic units in the new system (reference: src/commons.py:2058-2062)
        yr = 1 / eval_unit(unit_time, rel)
        pc = 1 / eval_unit(unit_length, rel)
        m_sun = 1 / eval_unit(unit_mass, rel)
        ns = self._build(yr, pc, m_sun)
        self._ns = ns
        for k, v in ns.items():
            if k.isidentifier():
                setattr(self, k, v)

    @staticmethod
    def _build(yr: float, pc: float, m_sun: float) -> dict:
        ns = {"yr": yr, "pc": pc, "m_sun": m_sun}
        ns["kyr"] = 1e3 * yr
        ns["Myr"] = 1e6 * yr
        ns["Gyr"] = 1e9 * yr
        ns["day"] = 1 / 365.25 * yr
        ns["hr"] = 1 / 24 * ns["day"]
        ns["minutes"] = 1 / 60 * ns["hr"]
        ns["s"] = 1 / 60 * ns["minutes"]
        ns["kpc"] = 1e3 * pc
        ns["Mpc"] = 1e6 * pc
        ns["Gpc"] = 1e9 * pc
        ns["AU"] = TAU / (60 * 60 * 360) * pc
        ns["m"] = 1 / 149597870700 * ns["AU"]
        ns["mm"] = 1e-3 * ns["m"]
        ns["cm"] = 1e-2 * ns["m"]
        ns["km"] = 1e3 * ns["m"]
        ns["ly"] = (299792458 * ns["m"] / ns["s"]) * yr
        ns["kly"] = 1e3 * ns["ly"]
        ns["Mly"] = 1e6 * ns["ly"]
        ns["Gly"] = 1e9 * ns["ly"]
        ns["km_sun"] = 1e3 * m_sun
        ns["Mm_sun"] = 1e6 * m_sun
        ns["Gm_sun"] = 1e9 * m_sun
        ns["kg"] = 1 / 1.98841e30 * m_sun
        ns["g"] = 1e-3 * ns["kg"]
        ns["J"] = ns["kg"] * ns["m"] ** 2 / ns["s"] ** 2
        ns["eV"] = 1.602176634e-19 * ns["J"]
        ns["meV"] = 1e-3 * ns["eV"]
        ns["keV"] = 1e3 * ns["eV"]
        ns["MeV"] = 1e6 * ns["eV"]
        ns["GeV"] = 1e9 * ns["eV"]
        ns["TeV"] = 1e12 * ns["eV"]
        return ns

    def constants(self) -> SimpleNamespace:
        """Physical constants in this unit system.

        Parity: reference src/commons.py:2113-2134.
        """
        light_speed = self.ly / self.yr
        h_bar = 6.62607015e-34 / TAU * self.kg * self.m**2 / self.s
        G_Newton = 6.67430e-11 * self.m**3 / (self.kg * self.s**2)
        return SimpleNamespace(
            light_speed=light_speed, c=light_speed, h_bar=h_bar, G_Newton=G_Newton
        )

    def namespace(self) -> dict:
        """Full evaluation namespace: units + constants (for param files)."""
        ns = dict(self._ns)
        c = self.constants()
        ns.update(light_speed=c.light_speed, c=c.c, h_bar=c.h_bar, G_Newton=c.G_Newton, G=c.G_Newton)
        return ns


# Module-level default unit system (Mpc, Gyr, 10^10 m_sun) — the same default
# as the reference (src/commons.py:2051-2053).
units = UnitSystem()
constants = units.constants()
