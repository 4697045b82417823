"""Tabulated (k, a) transfer-function layer — the Boltzmann backend
(port of concept_tpu/cosmology/boltzmann.py).

Counterpart of reference src/linear.py's CosmoResults +
TransferFunction (linear.py:56-1480, 1481-2521): transfer functions are
dense (Na, Nk) tables per (species, variable), built either from CLASS
(classy, via cosmology/class_bridge.py), from the internal
Einstein-Boltzmann solver (cosmology/ebsolver.py) or from the internal
Eisenstein-Hu layer, then evaluated by bilinear interpolation in
(log a, log k).  The reference despikes/detrends CLASS perturbations and
splines them per k (linear.py:1481+); here a dense table and a
vectorised interpolation in torch, on the device of the wavenumbers it
is given (the realization's |k| values on the run's device).  The
interpolation reads the tables in float32, as the JAX package does, in
float64 runs too.

Gauge machinery (reference compute_transfer, linear.py:2730-2870):
tables are stored in synchronous gauge (CLASS's native gauge) and
transformed to N-body gauge on demand using the reference's exact
transformations:

    δᴺᵇ  = δˢ  + c⁻²(3aH(1+w) − a·source/ρ̄)·θˢ_tot/k²      (:2791)
    θᴺᵇ  = θˢ  + hʹ/2 − 3c⁻²(aHθˢ_tot)ʹ/k²                  (:2817)
    δPᴺᵇ = δPˢ + aρ̄(3Hw(1+w) − ẇ)·θˢ_tot/k²                (:2860)

with ʹ = d/dτ = a·d/dt conformal-time derivatives, evaluated on the
table's a grid by finite differences (the reference differentiates its
splines the same way).  The transforms are host NumPy float64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class TransferTables:
    """Dense transfer tables δ(k,a), θ(k,a), … per species, per unit
    primordial curvature ζ, in internal units.

    tables[(species, var)] is a float64 (Na, Nk) array; var ∈
    {'delta', 'theta', 'deltaP', 'sigma'}.  aux holds gauge-transform
    ingredients: 'theta_tot' (Na, Nk) and optionally 'h_prime' (Na, Nk).
    """

    k: np.ndarray
    a: np.ndarray
    tables: dict
    aux: dict = field(default_factory=dict)
    gauge: str = "synchronous"
    # the float32 tensors the interpolation reads, per table and device
    _on_device: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        self.k = np.asarray(self.k, np.float64)
        self.a = np.asarray(self.a, np.float64)
        self._logk = np.log(self.k)
        self._loga = np.log(self.a)

    # ------------------------------------------------------------------ #
    def species(self):
        return sorted({s for (s, _) in self.tables})

    def has(self, species: str, var: str = "delta") -> bool:
        return (species, var) in self.tables

    def interp(self, species: str, var, k, a):
        """Bilinear interpolation in (log a, log k) of the float32 table.

        k may be any shape: a tensor (the result is a tensor on its
        device) or array-like (the result is a NumPy array); a is a
        scalar.  Out-of-range k/a clamp to the table edge (the reference
        splines behave the same way inside the k range it tabulates;
        callers choose k grids inside the table)."""
        return self._interp(("tab", species, var), self.tables[(species, var)], k, a)

    def interp_aux(self, name: str, k, a):
        return self._interp(("aux", name), self.aux[name], k, a)

    def _interp(self, name, tab, k, a):
        import torch

        if isinstance(k, torch.Tensor):
            return _bilinear(self._float32(name, tab, k.device), self._loga, self._logk, k, a)
        k = torch.as_tensor(np.asarray(k))
        return _bilinear(self._float32(name, tab, k.device), self._loga, self._logk,
                         k, a).numpy()

    def _float32(self, name, tab, device):
        """The table as a float32 tensor on ``device``, made once."""
        import torch

        key = (name, str(device))
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(np.asarray(tab), device=device).to(
                torch.float32)
        return self._on_device[key]

    # ------------------------------------------------------------------ #
    def to_gauge(self, gauge: str, bg, light_speed: float,
                 w_of_a=None, source_of_a=None, rho_bar_of_a=None,
                 species_sel=None):
        """Return a new TransferTables in the requested gauge.

        gauge: 'synchronous' (no-op) or 'nbody'.  bg supplies H(a), ä, ȧ
        (host numpy).  w_of_a / source_of_a / rho_bar_of_a: per-species
        dicts of callables a → value (defaults: w=0, source=0 — correct
        for matter species; pass proper ones for ν/dark-energy fluids).
        Reference: linear.py:2780-2870.
        """
        if gauge in (self.gauge, None):
            return self
        if gauge == "newtonian" and self.gauge == "synchronous":
            return self._to_newtonian(bg, light_speed, w_of_a)
        if gauge != "nbody" or self.gauge != "synchronous":
            raise ValueError(
                f"unsupported gauge transform {self.gauge} → {gauge}"
            )
        if "theta_tot" not in self.aux:
            raise ValueError("N-body gauge transform needs aux['theta_tot']")
        a = self.a
        k = self.k
        c2 = light_speed**2
        H = np.asarray([float(bg.hubble_np(ai)) for ai in a])
        theta_tot = np.asarray(self.aux["theta_tot"], np.float64)  # (Na, Nk)
        inv_k2 = 1.0 / k[None, :] ** 2

        # (aHθ_tot)ʹ = a(ä θ_tot + ȧ² dθ_tot/da)   [conformal-time deriv]
        addot = np.asarray([float(bg.addot_np(ai)) for ai in a])
        adot = a * H
        dtheta_da = np.gradient(theta_tot, a, axis=0)
        aH_theta_prime = a[:, None] * (
            addot[:, None] * theta_tot + (adot**2)[:, None] * dtheta_da
        )

        new_tables = {}
        for (species, var), tab in self.tables.items():
            if species_sel is not None and species not in species_sel:
                new_tables[(species, var)] = tab.copy()
                continue
            w = np.zeros_like(a)
            if w_of_a and species in w_of_a:
                w = np.asarray([w_of_a[species](ai) for ai in a])
            if var == "delta":
                src = np.zeros_like(a)
                if (source_of_a and species in source_of_a
                        and rho_bar_of_a and species in rho_bar_of_a):
                    src = np.asarray([
                        source_of_a[species](ai) / rho_bar_of_a[species](ai)
                        for ai in a
                    ])
                coef = (3 * a * H * (1 + w) - a * src) / c2
                new_tables[(species, var)] = tab + coef[:, None] * theta_tot * inv_k2
            elif var == "theta":
                if "h_prime" not in self.aux:
                    raise ValueError("θ N-body transform needs aux['h_prime']")
                h_prime = np.asarray(self.aux["h_prime"], np.float64)
                new_tables[(species, var)] = (
                    tab + 0.5 * h_prime - (3.0 / c2) * aH_theta_prime * inv_k2
                )
            elif var == "deltaP":
                if not (w_of_a and species in w_of_a
                        and rho_bar_of_a and species in rho_bar_of_a):
                    new_tables[(species, var)] = tab.copy()
                    continue
                rho = np.asarray([rho_bar_of_a[species](ai) for ai in a])
                dw_da = np.gradient(w, a)
                wdot = dw_da * adot  # ẇ = da/dt · dw/da
                coef = a * rho * (3 * H * w * (1 + w) - wdot)
                new_tables[(species, var)] = tab + coef[:, None] * theta_tot * inv_k2
            else:  # σ is gauge-invariant at this order (reference keeps it)
                new_tables[(species, var)] = tab.copy()
        return TransferTables(k=self.k, a=self.a, tables=new_tables,
                              aux=dict(self.aux), gauge="nbody")

    def _to_newtonian(self, bg, light_speed: float, w_of_a=None):
        """Synchronous → conformal-Newtonian gauge (Ma & Bertschinger
        1995 eq. 27, with α = (h′+6η′)/(2k²) from aux['alpha']):

          δ_N  = δ_s + 3ℋ(1+w)·α
          θ_N  = θ_s + c²k²·α
          δP_N/ρ̄ = δP_s/ρ̄ − α·(ẇ − 3ℋw(1+w))
          σ unchanged.
        """
        if "alpha" not in self.aux:
            raise ValueError(
                "Newtonian gauge transform needs aux['alpha'] "
                "(provided by the internal EB solver; classy-sourced "
                "tables lack it — request gauge 'nbody' or "
                "'synchronous' instead)"
            )
        a = self.a
        k = self.k
        c2 = light_speed**2
        H = np.asarray([float(bg.hubble_np(ai)) for ai in a])
        aH = a * H  # conformal ℋ in unit-system 1/time
        alpha = np.asarray(self.aux["alpha"], np.float64)  # (Na, Nk), time
        new_tables = {}
        for (species, var), tab in self.tables.items():
            w = np.zeros_like(a)
            if w_of_a and species in w_of_a:
                w = np.asarray([w_of_a[species](ai) for ai in a])
            if var == "delta":
                coef = 3.0 * aH * (1.0 + w)
                new_tables[(species, var)] = tab + coef[:, None] * alpha
            elif var == "theta":
                new_tables[(species, var)] = (
                    tab + c2 * (k[None, :] ** 2) * alpha
                )
            elif var == "deltaP":
                dw_da = np.gradient(w, a)
                wdot = dw_da * aH  # conformal ẇ
                coef = -(wdot - 3.0 * aH * w * (1.0 + w))
                new_tables[(species, var)] = tab + coef[:, None] * alpha
            else:  # σ gauge-invariant at this order
                new_tables[(species, var)] = tab.copy()
        return TransferTables(k=self.k, a=self.a, tables=new_tables,
                              aux=dict(self.aux), gauge="newtonian")


def _bilinear(tab, loga_grid, logk_grid, k, a):
    """Bilinear interpolation of tab (Na, Nk), a float32 tensor, at
    (a, k) in log-log axes: the grids and log a in float32, log k in k's
    dtype (the JAX package's arithmetic)."""
    import torch

    f32 = torch.float32
    dev = tab.device
    k = k.to(dev)
    logk = torch.log(torch.clamp(k, min=float(np.exp(logk_grid[0]))))
    loga = torch.log(torch.tensor(float(a), dtype=f32, device=dev))
    lk = torch.as_tensor(logk_grid, device=dev).to(f32)
    la = torch.as_tensor(loga_grid, device=dev).to(f32)
    ia = (torch.searchsorted(la, loga.reshape(1)) - 1).clamp(0, la.shape[0] - 2)[0]
    fa = ((loga - la[ia]) / (la[ia + 1] - la[ia])).clamp(0.0, 1.0)
    ik = (torch.searchsorted(lk.to(logk.dtype), logk.reshape(-1)) - 1).clamp(
        0, lk.shape[0] - 2).reshape(logk.shape)
    fk = ((logk - lk[ik]) / (lk[ik + 1] - lk[ik])).clamp(0.0, 1.0)
    t00 = tab[ia, ik]
    t01 = tab[ia, ik + 1]
    t10 = tab[ia + 1, ik]
    t11 = tab[ia + 1, ik + 1]
    return (
        (1 - fa) * ((1 - fk) * t00 + fk * t01)
        + fa * ((1 - fk) * t10 + fk * t11)
    )


# ---------------------------------------------------------------------- #
# Builders
# ---------------------------------------------------------------------- #


def k_grid_log(k_min, k_max, modes_per_decade: int = 30):
    """Log-distributed k grid (reference get_k_magnitudes, linear.py:2920,
    param class_modes_per_decade)."""
    n = max(2, int(math.ceil(math.log10(k_max / k_min) * modes_per_decade)))
    return np.logspace(math.log10(k_min), math.log10(k_max), n)


def tabulate_eh(lin, k=None, a=None, species=("matter", "cb", "nu")):
    """TransferTables from the internal Eisenstein-Hu layer.

    Makes the tabulated path fully testable without classy: interp(...)
    must reproduce lin.transfer_delta/theta to interpolation accuracy.
    θ_tot for gauge work is approximated by the matter θ (exact in
    matter domination; CLASS supplies the real one when available).
    """
    if k is None:
        k = k_grid_log(1e-4 / lin.Mpc, 50.0 / lin.Mpc, 40)
    if a is None:
        a = np.logspace(-3, 0, 120)
    kj = np.asarray(k, np.float64)
    tables = {}
    specs = [s for s in species if s != "nu" or lin.Omega_nu > 0]
    rows_d = {s: [] for s in specs}
    rows_t = []
    for ai in a:
        for s in specs:
            rows_d[s].append(np.asarray(lin.transfer_delta(kj, float(ai), s),
                                        np.float64))
        rows_t.append(np.asarray(lin.transfer_theta(kj, float(ai)), np.float64))
    for s in specs:
        tables[(s, "delta")] = np.stack(rows_d[s])
    theta = np.stack(rows_t)
    for s in specs:
        tables[(s, "theta")] = theta.copy()
    aux = {"theta_tot": theta.copy()}
    return TransferTables(k=np.asarray(k), a=np.asarray(a), tables=tables,
                          aux=aux, gauge="synchronous")


def construct_metric_delta(tables: TransferTables, bg, G_Newton: float,
                           light_speed: float, rho_metric: float):
    """Add the 'metric' fictitious species δ (synchronous gauge) to the
    tables — the N-body gauge GR correction as an effective density
    (reference construct_delta_metric, linear.py:845-906):

        k²γ  = −aH(a·∂ₐH_Tʹ + H_Tʹ) + k²(φ − ψ)
        δᴺᵇ  = k²γ / (4πG a² ρ̄_metric)
        δˢ   = δᴺᵇ − 3aH/c²·θ_tot/k²            (w_metric = 0)

    Requires aux tables 'H_T_prime', 'phi', 'psi', 'theta_tot' (the
    reference gets H_Tʹ from its patched CLASS; stock classy lacks it, so
    this path activates only when the table source provides them).
    rho_metric: the arbitrary constant comoving mean density ϱ̄ assigned
    to the species (δ scales inversely; ϱ̄δ is what gravitates).
    """
    for key in ("H_T_prime", "phi", "psi", "theta_tot"):
        if key not in tables.aux:
            raise ValueError(f"metric species needs aux[{key!r}]")
    a = tables.a
    k = tables.k
    H = np.asarray([float(bg.hubble_np(ai)) for ai in a])
    aH = a * H
    HT = np.asarray(tables.aux["H_T_prime"], np.float64)
    dHT_da = np.gradient(HT, a, axis=0)
    phi = np.asarray(tables.aux["phi"], np.float64)
    psi = np.asarray(tables.aux["psi"], np.float64)
    theta_tot = np.asarray(tables.aux["theta_tot"], np.float64)
    k2 = k[None, :] ** 2
    k2_gamma = -(aH)[:, None] * (a[:, None] * dHT_da + HT) + k2 * (phi - psi)
    rho_bar = rho_metric / a**3  # matter-like background convention
    delta_nb = k2_gamma / (4 * math.pi * G_Newton * (a**2 * rho_bar)[:, None])
    delta_s = delta_nb - (3 * aH / light_speed**2)[:, None] * theta_tot / k2
    tables.tables[("metric", "delta")] = delta_s
    return tables


def construct_lapse_delta(tables: TransferTables, bg, G_Newton: float,
                          light_speed: float, rho_lapse: float):
    """Add the 'lapse' fictitious species δ (synchronous gauge) — the GR
    correction potential for decaying species (reference
    construct_delta_lapse, linear.py:908-985):

        k²γ_lapse = −⅓a(aH·∂ₐH_Tʹ + (H − Ḣ/H)·H_Tʹ)
        δᴺᵇ = k²γ_lapse/(4πG a² ρ̄_lapse);  δˢ likewise gauge-shifted.
    """
    for key in ("H_T_prime", "theta_tot"):
        if key not in tables.aux:
            raise ValueError(f"lapse species needs aux[{key!r}]")
    a = tables.a
    k = tables.k
    H = np.asarray([float(bg.hubble_np(ai)) for ai in a])
    # Ḣ = ä/a − H²
    addot = np.asarray([float(bg.addot_np(ai)) for ai in a])
    Hdot = addot / a - H**2
    aH = a * H
    HT = np.asarray(tables.aux["H_T_prime"], np.float64)
    dHT_da = np.gradient(HT, a, axis=0)
    theta_tot = np.asarray(tables.aux["theta_tot"], np.float64)
    k2 = k[None, :] ** 2
    k2_gamma = -(a / 3.0)[:, None] * (
        (aH)[:, None] * dHT_da + (H - Hdot / H)[:, None] * HT
    )
    rho_bar = rho_lapse / a**3
    delta_nb = k2_gamma / (4 * math.pi * G_Newton * (a**2 * rho_bar)[:, None])
    delta_s = delta_nb - (3 * aH / light_speed**2)[:, None] * theta_tot / k2
    tables.tables[("lapse", "delta")] = delta_s
    return tables


def tabulate_class(bridge, lin_norm, k=None, a=None,
                   species_map=None):
    """TransferTables from a ClassBridge (classy).

    bridge: cosmology.class_bridge.ClassBridge.  lin_norm supplies unit
    conversion (Mpc in internal units) — CLASS works in 1/Mpc and
    conformal-gauge conventions.  species_map: CLASS key → our species
    name, default {'d_cdm': 'cdm', 'd_b': 'b', 'd_tot': 'matter', ...}.
    Tables are δ per unit ζ in synchronous gauge with aux θ_tot and hʹ
    (reference call_class, commons.py:4647-4867).
    """
    if species_map is None:
        species_map = {
            "d_tot": "matter", "d_cdm": "cdm", "d_b": "b",
            "d_ncdm[0]": "nu", "d_g": "photon", "d_ur": "ur",
        }
    Mpc = lin_norm.Mpc
    if a is None:
        a = np.logspace(-3, 0, 120)
    tabs = {}
    aux_rows = {"theta_tot": [], "h_prime": [], "phi": [], "psi": [],
                "H_T_prime": []}
    aux_keys = {"theta_tot": ("t_tot", 1), "h_prime": ("h_prime", 1),
                "phi": ("phi", 0), "psi": ("psi", 0),
                "H_T_prime": ("H_T_prime", 1)}
    k_int = None
    rows = {name: [] for name in set(species_map.values())}
    rows_t = {name: [] for name in set(species_map.values())}
    for ai in a:
        tr = bridge.transfer(z=1.0 / ai - 1.0)
        k_mpc = np.asarray(tr["k (h/Mpc)"]) * bridge.h()
        if k_int is None:
            k_int = k_mpc / Mpc
        for ckey, name in species_map.items():
            if ckey in tr:
                rows[name].append(np.asarray(tr[ckey], np.float64))
                tkey = "t" + ckey[1:]
                if tkey in tr:
                    rows_t[name].append(np.asarray(tr[tkey], np.float64) / Mpc)
        for name, (ckey, per_mpc) in aux_keys.items():
            if ckey in tr:
                val = np.asarray(tr[ckey], np.float64)
                aux_rows[name].append(val / Mpc if per_mpc else val)
            elif name == "theta_tot":
                aux_rows[name].append(np.zeros_like(k_mpc))
    for name, lst in rows.items():
        if lst:
            tabs[(name, "delta")] = np.stack(lst)
    for name, lst in rows_t.items():
        if lst:
            tabs[(name, "theta")] = np.stack(lst)
    aux = {name: np.stack(lst) for name, lst in aux_rows.items() if lst}
    return TransferTables(k=k_int, a=np.asarray(a), tables=tabs, aux=aux,
                          gauge="synchronous")
