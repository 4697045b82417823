"""Linear Boltzmann backend selection (port of
concept_tpu/cosmology/backend.py, selection only).

The port has the analytic Eisenstein-Hu layer alone.  'auto' resolves to
'eh' for runs that need no species-resolved transfer functions — the
default run does not — and the internal Einstein-Boltzmann solver
('eb') and CLASS ('class') are not ported yet.
"""

from __future__ import annotations

BACKEND_ITEM = "ROADMAP Queue 1 item 5: EB/CLASS linear backends"


def _ic_entries(cfg):
    ics = cfg.initial_conditions
    if ics is None:
        return []
    entries = ics if isinstance(ics, (list, tuple)) else [ics]
    return [e for e in entries if isinstance(e, dict)]


def needs_species_tables(cfg) -> bool:
    """True when the run involves physics the analytic EH layer cannot
    represent faithfully: massive ν, linear photon/ur fluids, GR
    metric/lapse corrections, or Boltzmann-order ≥ 1 fluids."""
    if (cfg.class_params or {}).get("N_ncdm"):
        return True
    for e in _ic_entries(cfg):
        sp = str(e.get("species", ""))
        if any(t in sp for t in ("neutrino", "photon", "metric", "lapse")):
            return True
        border = e.get("boltzmann order", e.get("boltzmann_order"))
        if border is not None and int(border) >= 1:
            return True
    for v in (cfg.select_boltzmann_order or {}).values():
        try:
            if int(v) >= 1:
                return True
        except (TypeError, ValueError):
            pass
    return False


def select_backend(cfg) -> str:
    """Resolve boltzmann_backend to 'eh', or raise for the backends the
    port does not have yet."""
    b = cfg.boltzmann_backend
    if b == "auto":
        b = "eb" if needs_species_tables(cfg) else "eh"
    if b != "eh":
        raise NotImplementedError(f"boltzmann backend {b!r} ({BACKEND_ITEM})")
    return b
