"""Component measurements for the info output and sanity checks (port of
concept_tpu/analysis/measure.py; reference analysis.py:3860-4231)."""

from __future__ import annotations

import torch


def measure_particles(pos, mom, mass: float, a: float) -> dict:
    """Scalars of a particle component: v_max and v_rms of the peculiar
    velocity mom/(a·m), the total momentum (3,) and the total mass.
    Tensors stay on their device."""
    v = mom / (a * mass)
    v2 = (v * v).sum(dim=1)
    return {"v_max": torch.sqrt(v2.max()), "v_rms": torch.sqrt(v2.mean()),
            "mom_total": mom.sum(dim=0), "mass_total": mass * pos.shape[0]}


def measure_fluid(varrho, J) -> dict:
    """ϱ statistics and the largest |u| = |J|/ϱ of a fluid (varrho
    (n, n, n), J (3, n, n, n)): the reference's Courant and vacuum
    checks read these."""
    rho_min = varrho.min()
    u_max = (torch.sqrt((J * J).sum(dim=0)) / torch.clamp(varrho, min=1e-30)).max()
    return {"rho_min": rho_min, "rho_max": varrho.max(), "rho_sum": varrho.sum(),
            "u_max": u_max, "vacuum_imminent": rho_min <= 0}
