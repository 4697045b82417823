"""Fourier-space factors on the rfft layout (port of the parts of
concept_tpu/grid/fourier.py the default run uses; reference
src/mesh.py:3327-3696).

Conventions: a real grid (n, n, n) of cell width boxsize/n; its rfft
slab (n, n, n//2+1) holds mode (ki, kj, kk) with ki, kj ∈ {0..n/2−1,
−n/2..−1} and kk ∈ {0..n/2}; physical k = (2π/boxsize)·(ki, kj, kk).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def k_int_vectors(gridsize: int, device="cpu"):
    """Broadcastable integer mode vectors (ki, kj, kk), int64."""
    n = gridsize
    k1 = torch.as_tensor((np.fft.fftfreq(n) * n).astype(np.int64),
                         device=device)
    kk = torch.arange(n // 2 + 1, device=device)
    return k1.reshape(n, 1, 1), k1.reshape(1, n, 1), kk.reshape(1, 1, n // 2 + 1)


def k2_int_grid(gridsize: int, device="cpu"):
    """Integer |k|² = ki² + kj² + kk² over the rfft layout."""
    ki, kj, kk = k_int_vectors(gridsize, device)
    return ki * ki + kj * kj + kk * kk


def hermitian_multiplicity(gridsize: int, dtype=torch.float32, device="cpu"):
    """Modes on the kk = 0 and kk = n/2 planes count once, the others
    twice (they stand for a conjugate pair)."""
    n = gridsize
    kk = torch.arange(n // 2 + 1, device=device)
    w = torch.where((kk == 0) | (kk == n // 2), 1.0, 2.0).to(dtype)
    return w.reshape(1, 1, n // 2 + 1)


def deconvolution_factor(gridsize: int, order: int, dtype=torch.float32,
                         device="cpu"):
    """Π_dims sinc(π k_i/n)^(−order) (reference mesh.py:3327-3421)."""
    n = gridsize
    d = None
    for k in k_int_vectors(n, device):
        x = (math.pi / n) * k.to(dtype)
        s = torch.sinc(x / math.pi)  # sinc(y) = sin(πy)/(πy)
        d = s if d is None else d * s
    return d ** (-order)


def fourier_diff(slab, gridsize: int, boxsize: float, dim: int):
    """Multiply by i·k_dim, with the Nyquist plane along dim zeroed
    (reference mesh.py:3466-3544)."""
    n = gridsize
    kvec = k_int_vectors(n, slab.device)[dim]
    k_phys = (2 * math.pi / boxsize) * kvec.to(slab.real.dtype)
    out = slab * (1j * k_phys)
    nyq = (kvec == -(n // 2)) if dim < 2 else (kvec == n // 2)
    return torch.where(nyq, torch.zeros((), dtype=out.dtype,
                                        device=out.device), out)


def interlace_phase(gridsize: int, shift_cells, dtype=torch.float32,
                    device="cpu"):
    """exp(−i k·Δx) for a grid shifted by ``shift_cells`` cell widths
    (reference Lattice, mesh.py:77-183)."""
    n = gridsize
    ki, kj, kk = k_int_vectors(n, device)
    phase = (2 * math.pi / n) * (
        ki * shift_cells[0] + kj * shift_cells[1] + kk * shift_cells[2]
    )
    return torch.exp(-1j * phase.to(dtype))
