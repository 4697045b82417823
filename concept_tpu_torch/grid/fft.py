"""Single-device 3D real FFTs on ``torch.fft`` (cuFFT on the card).

Port of the single-device path of concept_tpu/grid/fft.py.  Layouts
match ``jnp.fft.rfftn``: a real (n, n, n) grid ↔ a complex
(n, n, n//2+1) slab with the last axis halved.  The sharded slab and
pencil FFTs wait for the multi-GPU slice (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import torch


def rfft3(grid: torch.Tensor) -> torch.Tensor:
    """Forward real 3D FFT: (n, n, n) → (n, n, n//2+1), unnormalised."""
    return torch.fft.rfftn(grid, dim=(-3, -2, -1))


def irfft3(slab: torch.Tensor, gridsize: int) -> torch.Tensor:
    """Inverse of :func:`rfft3` (normalised like jnp.fft.irfftn).  A
    leading batch axis is transformed slab by slab."""
    n = gridsize
    return torch.fft.irfftn(slab, s=(n, n, n), dim=(-3, -2, -1))
