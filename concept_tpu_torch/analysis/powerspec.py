"""Power spectrum measurement (port of what ``run.dump`` uses of
concept_tpu/analysis/powerspec.py; reference src/analysis.py:70-928).

Deposit (PCS by default) → δ = ρ/ρ̄ − 1 → rfft, with bcc interlacing and
the sinc deconvolution, then |δ(k)|² binned over the Hermitian half
space with mode multiplicities: integer-|k| bins up to 16·k_f, 40 bins
per decade above.  Shot noise V/N is subtracted into 'power_corrected'.
The running bins-per-decade dict form is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from concept_tpu_torch.components import periodic_wrap
from concept_tpu_torch.grid import fourier
from concept_tpu_torch.grid.fft import rfft3
from concept_tpu_torch.grid.interp import deposit, interpolation_order

_K_LINEAR_MAX = 16


def delta_power_grid(pos, gridsize: int, boxsize: float, order: int = 4,
                     deconvolve: bool = True, interlace: bool = True):
    """|δ(k)|² over the rfft layout, interlaced (bcc) and deconvolved."""
    n = gridsize
    dtype = pos.dtype
    grid = deposit(pos, 1.0, n, boxsize, order)
    mean = grid.mean()
    slab = rfft3(grid / mean - 1.0)
    if interlace:
        shift = 0.5 * boxsize / n
        grid2 = deposit(periodic_wrap(pos + shift, boxsize), 1.0, n, boxsize, order)
        phase = fourier.interlace_phase(n, (-0.5, -0.5, -0.5), dtype, pos.device)
        slab = (slab + rfft3(grid2 / mean - 1.0) * phase) / 2
    if deconvolve:
        slab = slab * fourier.deconvolution_factor(n, order, dtype, pos.device)
    return slab.abs() ** 2


def bin_indices_and_k(gridsize: int, boxsize: float, bins_per_decade: int = 40,
                      device="cpu"):
    """Per-mode bin index and physical |k|: integer-|k| bins up to
    16·k_f, ``bins_per_decade`` logarithmic bins above.  Returns (bins,
    k_phys, n_bins)."""
    n = gridsize
    kmag_int = torch.sqrt(fourier.k2_int_grid(n, device).to(torch.float32))
    lin_bins = torch.round(kmag_int).to(torch.int64)
    safe = torch.clamp(kmag_int, min=1e-3)
    log_bins = (_K_LINEAR_MAX + torch.floor(
        bins_per_decade * (torch.log10(safe) - math.log10(_K_LINEAR_MAX))
    ).to(torch.int64) + 1)
    bins = torch.where(lin_bins <= _K_LINEAR_MAX, lin_bins,
                       torch.clamp(log_bins, min=_K_LINEAR_MAX + 1))
    k_max_int = math.sqrt(3) * (n // 2)
    n_log = int(bins_per_decade * (math.log10(max(k_max_int, _K_LINEAR_MAX + 1))
                                   - math.log10(_K_LINEAR_MAX))) + 2
    return bins, (2 * math.pi / boxsize) * kmag_int, _K_LINEAR_MAX + 1 + n_log


def powerspec_sigma(k, power, tophat_R: float) -> float:
    """σ(R) from a MEASURED binned spectrum (reference
    compute_powerspec_σ, analysis.py:856): trapezoidal
    σ² = (1/2π²)∫dk k²W²(kR)P plus the [0, k_min] triangle."""
    k = np.asarray(k, np.float64)
    power = np.asarray(power, np.float64)
    good = np.isfinite(power) & np.isfinite(k)
    k, power = k[good], power[good]
    if k.size < 2:
        return float("nan")
    kR = k * tophat_R
    W3 = np.where(kR < 1e-3, 1.0 / 3.0 - kR**2 / 30.0,
                  (np.sin(kR) - kR * np.cos(kR)) / np.maximum(kR, 1e-12) ** 3)
    integrand = (k * W3) ** 2 * power
    s2 = np.trapezoid(integrand, k) + 0.5 * k[0] * integrand[0]
    s2 *= 9.0 / (2.0 * math.pi**2)
    return math.sqrt(max(s2, 0.0))


def powerspec(pos, gridsize: int, boxsize: float, n_particles: int,
              order=4, deconvolve: bool = True, interlace: bool = True,
              bins_per_decade: int = 40, k_max: float | None = None):
    """Measure P(k) of one particle component.  Returns a dict of numpy
    arrays k, modes, power, power_corrected.  Estimator:
    P̂(bin) = (V/N_cells²)·Σ_bin w_herm|δ_dft|² / Σ_bin w_herm."""
    if isinstance(bins_per_decade, dict):
        raise NotImplementedError("running bins-per-decade (ROADMAP Queue 1 "
                                  "item 13: analysis)")
    n = gridsize
    V = boxsize**3
    p2 = delta_power_grid(pos, n, boxsize, interpolation_order(order), deconvolve,
                          bool(interlace)).to(torch.float64)
    bins, k_phys, nbins = bin_indices_and_k(n, boxsize, bins_per_decade,
                                            pos.device)
    mult = fourier.hermitian_multiplicity(n, torch.float64, pos.device).expand_as(p2)
    bflat = torch.clamp(bins, 0, nbins).reshape(-1)

    def binsum(vals):
        return torch.bincount(bflat, weights=vals.reshape(-1),
                              minlength=nbins + 1)[:nbins].cpu().numpy()

    wsum = binsum(mult * p2)
    counts = binsum(mult)
    ksum = binsum(mult * k_phys.to(torch.float64))
    power = (V / n**6) * wsum / np.maximum(counts, 1)
    k_mean = ksum / np.maximum(counts, 1)
    sel = counts > 0
    sel[0] = False  # the k = 0 bin
    if k_max is not None:
        sel &= k_mean <= float(k_max)
    return {"k": k_mean[sel], "modes": counts[sel], "power": power[sel],
            "power_corrected": power[sel] - V / n_particles}
