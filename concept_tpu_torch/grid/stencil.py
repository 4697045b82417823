"""Real-space finite differencing of periodic grids (port of
concept_tpu/grid/stencil.py; reference src/mesh.py:4874
diff_domaingrid): symmetric central stencils of order 2/4/6/8."""

from __future__ import annotations

import torch

# Central-difference coefficients for f'(x): weight of f(x ± i·h)
_COEFFS = {
    2: (1 / 2,),
    4: (2 / 3, -1 / 12),
    6: (3 / 4, -3 / 20, 1 / 60),
    8: (4 / 5, -1 / 5, 4 / 105, -1 / 280),
}


def diff_grid(grid, boxsize: float, dim: int, order: int = 4):
    """∂grid/∂x_dim with an order-``order`` central stencil (periodic)."""
    h = boxsize / grid.shape[dim]
    out = torch.zeros_like(grid)
    for i, c in enumerate(_COEFFS[order], start=1):
        out += c * (torch.roll(grid, -i, dims=dim) - torch.roll(grid, i, dims=dim))
    return out / h
