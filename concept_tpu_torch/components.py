"""Component data model (port of concept_tpu/components.py; reference
src/species.py).

``ParticleState`` holds (N, 3) tensors and ``FluidState`` a fluid's
grids; ``ComponentSpec`` is the static per-component metadata,
``EquationOfState`` a fluid's w(a) and w_eff(a), and ``SPECIES`` the
species taxonomy (reference linear.py:3517-3595).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch


class ParticleState(NamedTuple):
    """Dynamic particle data.  mom is the canonical momentum a²·m·ẋ
    (comoving x), the reference convention (species.py:2179-2199)."""

    pos: torch.Tensor  # (N, 3) in [0, boxsize)
    mom: torch.Tensor  # (N, 3)
    ids: torch.Tensor | None = None  # (N,) int, optional
    rungs: torch.Tensor | None = None  # (N,) int8, optional


class FluidState(NamedTuple):
    """Dynamic fluid data: the Boltzmann-hierarchy grids (reference
    species.py:880-928 for boltzmann_order semantics).

    varrho : (n, n, n)     comoving density ϱ = a^{3(1+w_eff)} ρ
    J      : (3, n, n, n)  momentum density J = a⁴(ρ + c⁻²P)u
    P      : (n, n, n)     pressure 𝒫 (order ≥ 2 or the 'class' closure)
    sigma  : (6, n, n, n)  shear ς packed (xx, xy, xz, yy, yz, zz)
    """

    varrho: torch.Tensor
    J: torch.Tensor | None = None
    P: torch.Tensor | None = None
    sigma: torch.Tensor | None = None


@dataclass(frozen=True)
class ComponentSpec:
    """Static per-component metadata."""

    name: str
    species: str
    representation: str = "particles"
    N: int | None = None
    gridsize: int | None = None
    mass: float = 0.0
    w: float = 0.0
    boltzmann_order: int = 1
    boltzmann_closure: str = "truncate"
    softening: float = 0.0
    forces: tuple = ()  # (('gravity', 'p3m'),) etc.
    life: tuple = (0.0, float("inf"))
    decay_rate: float = 0.0
    decay_to: str | None = None

    @property
    def w_eff(self) -> float:
        """The effective EoS; w for a species that does not decay."""
        return self.w

    def force_method(self, force: str) -> str | None:
        for f, m in self.forces:
            if f == force:
                return m
        return None


class EquationOfState:
    """w(a) and w_eff(a) of one component, constant or splined (the
    reference's per-component splines, species.py:2940-3526): host
    evaluation for the step integrals and the in-step factors."""

    def __init__(self, w=0.0, w_spline=None, weff_spline=None):
        self._w_const = float(w)
        self._w_spline = w_spline
        self._weff_spline = weff_spline

    @classmethod
    def constant(cls, w: float) -> "EquationOfState":
        return cls(w=w)

    @classmethod
    def from_neutrino(cls, nubg) -> "EquationOfState":
        """From a cosmology.neutrino.NeutrinoBackground (exact
        Fermi-Dirac w(a) and w_eff(a))."""
        return cls(w_spline=nubg._w_spline, weff_spline=nubg._weff_spline)

    @property
    def is_constant(self) -> bool:
        return self._w_spline is None

    def w_np(self, a) -> float:
        if self._w_spline is None:
            return self._w_const
        return float(self._w_spline.eval_np(a))

    def w_eff_np(self, a) -> float:
        spl = self._weff_spline or self._w_spline
        if spl is None:
            return self._w_const
        return float(spl.eval_np(a))


# species → class of species (reference linear.py:3517-3595)
SPECIES = {
    "matter": dict(cls="matter"),
    "baryon": dict(cls="matter"),
    "cold dark matter": dict(cls="matter"),
    "cdm": dict(cls="matter"),
    "neutrino": dict(cls="neutrino"),
    "massive neutrino": dict(cls="neutrino"),
    "photon": dict(cls="radiation"),
    "radiation": dict(cls="radiation"),
    "dark energy": dict(cls="dark energy"),
    "decaying cold dark matter": dict(cls="dcdm"),
    "dcdm": dict(cls="dcdm"),
    "metric": dict(cls="fictitious"),
    "lapse": dict(cls="fictitious"),
}


def particle_mass(Omega: float, rho_crit: float, boxsize: float, N: int) -> float:
    """mass = Ω·ρ_crit·V/N (reference species.py populate/realize path)."""
    return Omega * rho_crit * boxsize**3 / N


def periodic_wrap(x: torch.Tensor, boxsize: float) -> torch.Tensor:
    """x mod boxsize into [0, boxsize) as jnp.mod forms it: fmod, then
    + boxsize where the remainder is negative."""
    r = torch.fmod(x, boxsize)
    return torch.where(r < 0, r + boxsize, r)


def lattice_positions(n_per_dim: int, boxsize: float, kind: str = "sc",
                      dtype=torch.float32, device="cpu", rows=None):
    """Pre-IC particle lattice (reference ic.py:1199-1446): sc gives n³
    particles at cell centers, bcc and fcc add 1 and 3 shifted copies.
    Returns (N, 3) positions, built on ``device`` in float64 as the JAX
    package builds them with numpy; with ``rows`` = (x0, count) only
    those of the planes x ∈ [x0, x0 + count) of each copy, in the same
    order (a rank's planes of the realization over ranks)."""
    n = n_per_dim
    h = boxsize / n
    shifts = {"sc": [[0, 0, 0]], "bcc": [[0, 0, 0], [0.5, 0.5, 0.5]],
              "fcc": [[0, 0, 0], [0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]]}
    if kind not in shifts:
        raise ValueError(f"unknown lattice kind {kind!r}")
    i = torch.arange(n, dtype=torch.float64, device=device)
    ix = i if rows is None else torch.arange(rows[0], rows[0] + rows[1], dtype=torch.float64,
                                             device=device)
    base = (torch.stack(torch.meshgrid(ix, i, i, indexing="ij"), -1).reshape(-1, 3)
            + 0.5) * h
    pos = torch.cat([base + torch.as_tensor(s, dtype=torch.float64, device=device) * h
                     for s in shifts[kind]])
    # every coordinate is ≥ 0: fmod is numpy's mod exactly
    return torch.fmod(pos, boxsize).to(dtype)
