"""Component data model (port of concept_tpu/components.py, particles
only; reference src/species.py).

``ParticleState`` holds (N, 3) tensors; ``ComponentSpec`` is the static
per-component metadata.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch


class ParticleState(NamedTuple):
    """Dynamic particle data.  mom is the canonical momentum a²·m·ẋ
    (comoving x), the reference convention (species.py:2179-2199)."""

    pos: torch.Tensor  # (N, 3) in [0, boxsize)
    mom: torch.Tensor  # (N, 3)
    ids: torch.Tensor | None = None  # (N,) int, optional
    rungs: torch.Tensor | None = None  # (N,) int8, optional


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

    def force_method(self, force: str) -> str | None:
        for f, m in self.forces:
            if f == force:
                return m
        return None


def particle_mass(Omega: float, rho_crit: float, boxsize: float, N: int) -> float:
    """mass = Ω·ρ_crit·V/N (reference species.py populate/realize path)."""
    return Omega * rho_crit * boxsize**3 / N


def periodic_wrap(x: torch.Tensor, boxsize: float) -> torch.Tensor:
    """x mod boxsize into [0, boxsize) as jnp.mod forms it: fmod, then
    + boxsize where the remainder is negative."""
    r = torch.fmod(x, boxsize)
    return torch.where(r < 0, r + boxsize, r)


def lattice_positions(n_per_dim: int, boxsize: float, kind: str = "sc",
                      dtype=torch.float32, device="cpu"):
    """Pre-IC particle lattice (reference ic.py:1199-1446): sc gives n³
    particles at cell centers, bcc and fcc add 1 and 3 shifted copies.
    Returns (N, 3) positions."""
    n = n_per_dim
    h = boxsize / n
    idx = np.indices((n, n, n)).reshape(3, -1).T  # (n³, 3)
    base = (idx + 0.5) * h
    if kind == "sc":
        pos = base
    elif kind == "bcc":
        pos = np.concatenate([base, base + 0.5 * h])
    elif kind == "fcc":
        shifts = np.array(
            [[0, 0, 0], [0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]]
        ) * h
        pos = np.concatenate([base + s for s in shifts])
    else:
        raise ValueError(f"unknown lattice kind {kind!r}")
    pos = np.mod(pos, boxsize)
    return torch.as_tensor(pos, dtype=dtype, device=device)
