"""Run configuration and the time-step limiter constants (port of
``SimConfig`` and the ``FAC_*`` / ``DELTA_A_MAX_*`` constants of
concept_tpu/sim.py; reference main.py:2345-2433)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

# Reference numeric defaults (main.py:2345-2433)
FAC_DYNAMICAL = 0.056
FAC_HUBBLE = 0.031
FAC_PM = 0.13
FAC_P3M = 0.14
DELTA_A_MAX_EARLY = 0.00153
DELTA_A_MAX_LATE = 0.022


@dataclass(frozen=True)
class SimConfig:
    """Static configuration of a single-component run."""

    boxsize: float
    potential_gridsize: int
    device: torch.device
    dtype: torch.dtype = torch.float32
    G: float = 1.0
    method: str = "p3m"
    softening: float = 0.0
    # 'plummer' | 'spline' (GADGET-2 cubic spline, the reference default)
    # | 'none' (reference softening_kernel, example_explanatory:372)
    softening_kernel: str = "spline"
