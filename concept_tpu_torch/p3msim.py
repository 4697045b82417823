"""PM long range on the unified P³M cell layout (port of
``pm_gradient_cells`` and ``margin_cell_count`` of concept_tpu/p3msim.py).

The short-range (K, C) slot layout IS the deposit layout: cells are
exactly ``cb`` mesh cells wide, so the CIC deposit and the force gather
run on the sweep's slot arrays (grid/cuda_cells.py), with no per-step
layout translation.  Reference: interactions.py:1985-2415 (mesh part).
"""

from __future__ import annotations

import torch

from concept_tpu_torch.forces.pm import gravity_potential_slab
from concept_tpu_torch.grid import fourier
from concept_tpu_torch.grid.cuda_cells import deposit_cells, gather_cells
from concept_tpu_torch.grid.fft import irfft3, rfft3


def margin_cell_count(boxsize: float, cutoff: float, margin_frac: float,
                      max_cells: int = 512) -> int:
    """Cells per dimension with width ≥ cutoff·(1+margin_frac)."""
    n = int(boxsize / (cutoff * (1.0 + margin_frac)))
    return max(1, min(n, max_cells))


def pm_gradient_cells(pos3, valid, mass: float, G: float, scale: float,
                      boxsize: float, mesh: int, cb: int = 8):
    """∂φ/∂x at every slot of the (K, C) cell layout: deposit w =
    mass·valid, FFT, φ(k) with the long-range split and CIC deconvolution
    (order 4 = deposit + gather), Fourier gradient, gather.

    Returns (fd (3, K, C), mass_sum).  Every valid slot deposits; one that
    drifted out of its cell's ±1-mesh-cell halo since the last rebucket
    is left out, and mass_sum (the deposited mass, a 0-dim tensor) then
    falls short of N·mass — the host checks it."""
    K, C = valid.shape
    n = mesh
    wv = valid.to(pos3.dtype)
    grid = deposit_cells(pos3, wv * mass, n, boxsize, cb)
    # summed in float64: a float32 total of 2²⁴ = 256³ particle masses
    # cannot resolve one particle's mass
    mass_sum = grid.sum(dtype=torch.float64)
    slab = rfft3(grid / (boxsize / n) ** 3)
    del grid
    phi = gravity_potential_slab(slab, n, boxsize, G, deconv_order=4,
                                 longrange_scale=scale)
    del slab
    grads = torch.stack([irfft3(fourier.fourier_diff(phi, n, boxsize, d), n)
                         for d in range(3)])
    return gather_cells(pos3, wv, grads, n, boxsize, cb), mass_sum
