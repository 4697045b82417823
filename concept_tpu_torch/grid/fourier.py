"""Fourier-space factors on the rfft layout (port of
concept_tpu/grid/fourier.py; reference src/mesh.py:1018-1327,
3327-3696, 4182).

Conventions: a real grid (n, n, n) of cell width boxsize/n; its rfft
slab (n, n, n//2+1) holds mode (ki, kj, kk) with ki, kj ∈ {0..n/2−1,
−n/2..−1} and kk ∈ {0..n/2}; physical k = (2π/boxsize)·(ki, kj, kk).
``y_rows`` = (first row, rows) restricts a factor to the kj rows of a
rank's y-slab (grid/fft.py); None means all n.  ``z_cols`` = (first
column, columns) restricts it to the kk columns of a rank's Fourier
pencil (grid/fft.GridDistribution2D), whose columns past n/2 are padding
(kk > n/2): None means all n//2+1.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from concept_tpu_torch.grid.fft import exchange, row_starts


def k_int_vectors(gridsize: int, device="cpu", y_rows=None, z_cols=None):
    """Broadcastable integer mode vectors (ki, kj, kk), int64."""
    n = gridsize
    k1 = torch.as_tensor((np.fft.fftfreq(n) * n).astype(np.int64),
                         device=device)
    kj = k1 if y_rows is None else k1[y_rows[0]:y_rows[0] + y_rows[1]]
    z0, nz = (0, n // 2 + 1) if z_cols is None else z_cols
    kk = torch.arange(z0, z0 + nz, device=device)
    return k1.reshape(n, 1, 1), kj.reshape(1, -1, 1), kk.reshape(1, 1, -1)


def k2_int_grid(gridsize: int, device="cpu", y_rows=None):
    """Integer |k|² = ki² + kj² + kk² over the rfft layout."""
    ki, kj, kk = k_int_vectors(gridsize, device, y_rows)
    return ki * ki + kj * kj + kk * kk


def hermitian_multiplicity(gridsize: int, dtype=torch.float32, device="cpu"):
    """Modes on the kk = 0 and kk = n/2 planes count once, the others
    twice (they stand for a conjugate pair)."""
    n = gridsize
    kk = torch.arange(n // 2 + 1, device=device)
    w = torch.where((kk == 0) | (kk == n // 2), 1.0, 2.0).to(dtype)
    return w.reshape(1, 1, n // 2 + 1)


def deconvolution_factor(gridsize: int, order: int, dtype=torch.float32,
                         device="cpu", y_rows=None, z_cols=None):
    """Π_dims sinc(π k_i/n)^(−order) (reference mesh.py:3327-3421)."""
    n = gridsize
    d = None
    for k in k_int_vectors(n, device, y_rows, z_cols):
        x = (math.pi / n) * k.to(dtype)
        s = torch.sinc(x / math.pi)  # sinc(y) = sin(πy)/(πy)
        d = s if d is None else d * s
    return d ** (-order)


def fourier_diff(slab, gridsize: int, boxsize: float, dim: int, y_rows=None, z_cols=None):
    """Multiply by i·k_dim, with the Nyquist plane along dim zeroed
    (reference mesh.py:3466-3544); a pencil's padded columns stay zero."""
    n = gridsize
    kvec = k_int_vectors(n, slab.device, y_rows, z_cols)[dim]
    k_phys = (2 * math.pi / boxsize) * kvec.to(slab.real.dtype)
    out = slab * (1j * k_phys)
    nyq = (kvec == -(n // 2)) if dim < 2 else (kvec == n // 2)
    return torch.where(nyq, torch.zeros((), dtype=out.dtype,
                                        device=out.device), out)


def interlace_phase(gridsize: int, shift_cells, dtype=torch.float32,
                    device="cpu", y_rows=None):
    """exp(−i k·Δx) for a grid shifted by ``shift_cells`` cell widths
    (reference Lattice, mesh.py:77-183)."""
    n = gridsize
    ki, kj, kk = k_int_vectors(n, device, y_rows)
    phase = (2 * math.pi / n) * (
        ki * shift_cells[0] + kj * shift_cells[1] + kk * shift_cells[2]
    )
    return torch.exp(-1j * phase.to(dtype))


def k_int_1d(n: int, device="cpu"):
    """Integer wavenumbers along a full FFT axis: [0, 1, ..., n/2−1,
    −n/2, ..., −1], int64."""
    return torch.as_tensor((np.fft.fftfreq(n) * n).astype(np.int64),
                           device=device)


def laplacian_inverse_factor(gridsize: int, boxsize: float,
                             dtype=torch.float32, device="cpu"):
    """1/|k|² with |k| physical, 0 at the origin (reference
    mesh.py:3422-3465)."""
    k2 = k2_int_grid(gridsize, device).to(dtype)
    kfac = (2 * math.pi / boxsize) ** 2
    return torch.where(k2 > 0, 1.0 / (kfac * k2), 0.0)


def k_physical(gridsize: int, boxsize: float, dim: int, dtype=torch.float32,
               device="cpu"):
    """The physical wavenumber component along dim, broadcastable."""
    return (2 * math.pi / boxsize) * k_int_vectors(gridsize, device)[dim].to(dtype)


def nullify_origin(slab):
    """A copy of slab with the k = 0 mode zeroed (reference nullify_modes
    'origin', mesh.py:3545)."""
    out = slab.clone()
    out[0, 0, 0] = 0
    return out


def nullify_nyquist(slab, gridsize: int):
    """Zero every Nyquist plane (reference nullify_modes 'nyquist')."""
    n = gridsize
    ki, kj, kk = k_int_vectors(n, slab.device)
    nyq = (ki == -(n // 2)) | (kj == -(n // 2)) | (kk == n // 2)
    return torch.where(nyq, torch.zeros((), dtype=slab.dtype, device=slab.device), slab)


def nullify_beyond_sphere(slab, gridsize: int, k2_max_int: int):
    """Zero the modes with integer |k|² > k2_max_int."""
    k2 = k2_int_grid(gridsize, slab.device)
    return torch.where(k2 > k2_max_int,
                       torch.zeros((), dtype=slab.dtype, device=slab.device), slab)


def copy_modes(slab_src, gridsize_src: int, gridsize_dst: int,
               norm: bool = True, cell_centered: bool = True, dist=None):
    """Copy the integer modes two rfft layouts share (reference
    mesh.py:1018-1327 copy_modes / resize_grid).  Modes at or beyond the
    smaller grid's Nyquist are dropped (zero on the destination).
    ``norm`` rescales by (n_dst/n_src)³, so that the inverse transform
    keeps the physical amplitude; ``cell_centered`` re-centres the
    samples, which sit at (i+½)h, by the phase exp(iπk(1/n_dst −
    1/n_src)) per axis.  With ``dist`` (grid/fft.GridDistribution) the
    slabs are the rank's y-slabs of the two grids (``rows`` of each n):
    each kept kj row goes to the rank that holds it on the destination."""
    n1, n2 = gridsize_src, gridsize_dst
    if n1 == n2:
        return slab_src
    h = min(n1, n2) // 2  # modes |k| < h are kept
    pos, neg = h, h - 1  # rows 0..h−1 and the last h−1 rows
    src = slab_src
    y_rows = None
    if dist is None:
        out = torch.zeros((n2, n2, n2 // 2 + 1), dtype=src.dtype, device=src.device)
        out[:pos, :pos, :h + 1] = src[:pos, :pos, :h + 1]
        out[:pos, -neg:, :h + 1] = src[:pos, -neg:, :h + 1]
        out[-neg:, :pos, :h + 1] = src[-neg:, :pos, :h + 1]
        out[-neg:, -neg:, :h + 1] = src[-neg:, -neg:, :h + 1]
    else:
        out, y_rows = _copy_rows(src, n1, n2, h, dist)
    if norm:
        out = out * (n2 / n1) ** 3
    if cell_centered:
        ki, kj, kk = k_int_vectors(n2, src.device, y_rows)
        phase = (math.pi * (1.0 / n2 - 1.0 / n1)) * (ki + kj + kk).to(out.real.dtype)
        out = out * torch.exp(1j * phase)
    return out


def _copy_rows(src, n1: int, n2: int, h: int, dist):
    """:func:`copy_modes`' copy over the ranks: this rank's kept kj rows of
    the n1-grid's y-slab src, each as a whole kj row of the n2-grid (x
    and kk copied as on one device), sent to the rank that holds the row
    of the n2-grid, which places what it receives.  Returns (this rank's
    y-slab of the n2-grid, its rows)."""
    y0, _ = dist.rows(n1)
    j = y0 + torch.arange(src.shape[1], device=src.device)
    keep = (j < h) | (j >= n1 - (h - 1))
    j_dst = torch.where(j < h, j, j - n1 + n2)[keep]
    part = src.transpose(0, 1)[keep]  # (kept, n1, nk1): kj first
    rows = part.new_zeros((part.shape[0], n2, n2 // 2 + 1))
    pos, neg = h, h - 1
    rows[:, :pos, :h + 1] = part[:, :pos, :h + 1]
    rows[:, -neg:, :h + 1] = part[:, -neg:, :h + 1]
    del part
    starts = torch.tensor(row_starts(n2, dist.n_devices)[1:-1], dtype=torch.int64,
                          device=src.device)
    dest = torch.bucketize(j_dst, starts, right=True)
    got, got_j = exchange([rows, j_dst], dest, dist)
    del rows
    z0, cols = dist.rows(n2)
    out = src.new_zeros((cols, n2, n2 // 2 + 1))
    out[got_j - z0] = got
    return out.transpose(0, 1), (z0, cols)


def check_hermitian(slab, gridsize: int) -> float:
    """The largest violation of R(−k) = conj R(k) on the self-conjugate
    kk ∈ {0, n/2} planes (reference slabs_check_symmetry, mesh.py:4182)."""
    worst = 0.0
    for kk in (0, gridsize // 2):
        plane = slab[:, :, kk]
        mirrored = torch.roll(torch.conj(plane.flip(0, 1)), (1, 1), (0, 1))
        worst = max(worst, float((plane - mirrored).abs().max()))
    return worst
