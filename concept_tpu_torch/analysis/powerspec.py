"""Power spectrum measurement (port of concept_tpu/analysis/powerspec.py;
reference src/analysis.py:70-928).

Deposit (PCS by default) → δ = ρ/ρ̄ − 1 → rfft, interlaced (bcc by
default) and deconvolved, then |δ(k)|² binned over the Hermitian half
space with mode multiplicities.  Bins: integer |k| up to 16·k_f and
``bins_per_decade`` logarithmic bins above, or the reference's running
bins-per-decade dict (the log-nearest running bin centre).  Shot noise
is subtracted into 'power_corrected'.  Combined spectra of several
particle groups and fluid grids, and spectra of a real-space δ grid,
use the same estimator.

Over the slab decomposition (``dist``, grid/fft.GridDistribution) a
component's spectrum is measured where its particles are: each rank
deposits its shard (``parallel.step.deposit_distributed``), the FFT is
the slab FFT, each rank bins the modes of its y-slab, and one
``all_reduce`` sums the bins, so that every rank holds the whole
spectrum.  Combined spectra take each rank's shards and fluid rows the
same way, and so does the spectrum of a δ grid given by its x-rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from concept_tpu_torch.components import periodic_wrap
from concept_tpu_torch.grid import fourier
from concept_tpu_torch.grid.fft import rfft3
from concept_tpu_torch.grid.interp import deposit, interpolation_order
from concept_tpu_torch.parallel.step import deposit_distributed

_K_LINEAR_MAX = 16


def _eval_bin_expr(s, names: dict) -> float:
    """Evaluate a bins-per-decade / k_max expression in the reference's
    vocabulary ('4*k_min', 'nyquist', ...; analysis.py eval_bin_str)."""
    env = dict(names)
    for key in list(names):
        base = key.removeprefix("k_")
        for alias in (base, base.lower(), base.capitalize(), f"k_{base}", f"k{base}"):
            env[alias] = names[key]
    env["min"], env["max"], env["sqrt"] = min, max, math.sqrt
    return float(eval(s, {"__builtins__": {}}, env))  # noqa: S307


def running_bin_centers(k_min: float, k_max: float, bins_per_decade: dict,
                        gridsize: int, boxsize: float) -> np.ndarray:
    """Bin centres under a running bins-per-decade specification: a dict
    from k (a number or an expression such as '4*k_min') to the local
    number of bins per decade, interpolated in log10 k (reference
    construct_powerspec_k_bin_centers, analysis.py:343-412, with its
    minimum bin size and its stretch of the centres onto the ends)."""
    k_f = 2 * math.pi / boxsize
    nyq = gridsize // 2
    binsize_min = (0.5 * (1 - 1e-2) * k_f
                   * (math.sqrt(3 * nyq**2 + 1) - math.sqrt(3 * nyq**2)))
    names = {"nyquist": k_f * nyq, "gridsize": gridsize, "k_min": k_min,
             "k_max": k_max, "k_fundamental": k_min, "k_f": k_min}
    bpd = {}
    for k, v in bins_per_decade.items():
        if isinstance(k, str):
            k = _eval_bin_expr(k, names)
        if isinstance(v, str):
            v = _eval_bin_expr(v, names)
        bpd[float(k)] = float(v)
    if len(bpd) == 1:
        bpd.update({k + 1: v for k, v in bpd.items()})
    xs = np.log10(np.asarray(sorted(bpd)))
    ys = np.asarray([bpd[k] for k in sorted(bpd)])

    def bins_at(logk):
        return float(np.interp(logk, xs, ys))

    logk_min, logk_max = math.log10(k_min), math.log10(k_max)
    centers = []
    logk_right = logk_min - 0.5 / bins_at(logk_min)
    while logk_right <= logk_max:
        logk_left = logk_right
        logk_right = logk_left + 1.0 / bins_at(logk_left)
        logk_right = max(logk_right, math.log10(10**logk_left + binsize_min))
        centers.append(10 ** (0.5 * (logk_left + logk_right)))
    if not centers:
        centers.append(math.sqrt(k_min * k_max))
    centers = np.asarray(centers, np.float64)
    if len(centers) > 1:
        left = k_min
        right = 10 ** (logk_max - 0.5 / bins_at(logk_max))
        lc = np.log10(centers)
        centers = 10 ** (math.log10(left) + (lc - lc[0]) * (
            (math.log10(right) - math.log10(left)) / (lc[-1] - lc[0])))
    return centers


def bin_indices_and_k(gridsize: int, boxsize: float, bins_per_decade=40,
                      device="cpu", y_rows=None):
    """Per-mode bin index and physical |k| (``y_rows``: of a rank's
    y-slab).  ``bins_per_decade`` an int: integer-|k| bins up to 16·k_f,
    that many logarithmic bins per decade above.  A dict: the running
    bins-per-decade centres, each mode in the log-nearest one (k = 0 in
    the dropped bin 0).  Returns (bins, k_phys, n_bins)."""
    n = gridsize
    k2 = fourier.k2_int_grid(n, device, y_rows)
    if isinstance(bins_per_decade, dict):
        k_f = 2 * math.pi / boxsize
        centers = running_bin_centers(k_f, k_f * math.sqrt(3) * (n // 2),
                                      bins_per_decade, n, boxsize)
        kmag = torch.sqrt(k2.to(torch.float32)) * k_f
        logc = torch.as_tensor(np.log10(centers), dtype=torch.float32, device=device)
        logk = torch.log10(torch.clamp(kmag, min=1e-30))
        idx = torch.clamp(torch.searchsorted(logc, logk.contiguous()), 1, len(centers) - 1)
        left_closer = (logk - logc[idx - 1]) <= (logc[idx] - logk)
        bins = torch.where(left_closer, idx - 1, idx) + 1
        return torch.where(k2 == 0, 0, bins), kmag, len(centers) + 1
    kmag_int = torch.sqrt(k2.to(torch.float32))
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


def _binned(p2, n: int, boxsize: float, bins_per_decade=40, k_max=None,
            dist=None) -> dict:
    """Bin |δ_dft|² (the rfft layout; with ``dist`` this rank's y-slab)
    into {k, modes, power}: P̂(bin) = (V/N_cells²)·Σ_bin w_herm|δ_dft|² /
    Σ_bin w_herm, the k = 0 bin and the empty bins dropped, and those
    above ``k_max``."""
    p2 = p2.to(torch.float64)
    bins, k_phys, nbins = bin_indices_and_k(n, boxsize, bins_per_decade, p2.device,
                                            None if dist is None else dist.rows(n))
    mult = fourier.hermitian_multiplicity(n, torch.float64, p2.device).expand_as(p2)
    bflat = torch.clamp(bins, 0, nbins).reshape(-1)
    sums = torch.stack([
        torch.bincount(bflat, weights=v.reshape(-1), minlength=nbins + 1)[:nbins]
        for v in (mult * p2, mult, mult * k_phys.to(torch.float64))])
    if dist is not None:
        torch.distributed.all_reduce(sums, group=dist.group)
    wsum, counts, ksum = sums.cpu().numpy()
    power = (boxsize**3 / n**6) * wsum / np.maximum(counts, 1)
    k_mean = ksum / np.maximum(counts, 1)
    sel = counts > 0
    sel[0] = False  # the k = 0 bin
    if k_max is not None:
        sel &= k_mean <= float(k_max)
    return {"k": k_mean[sel], "modes": counts[sel], "power": power[sel]}


def _interlaced_slab(dep, n: int, boxsize: float, order: int, deconvolve: bool,
                     interlace, dtype, device, dist=None):
    """rfft of ``dep(offset)`` (the grid deposited with the particles
    shifted by ``offset``, None for none), averaged over the interlacing
    lattice's shifts with their phases and deconvolved."""
    from concept_tpu_torch.forces.pm import INTERLACE_SHIFTS, interlace_lattice

    y_rows = None if dist is None else dist.slab(n)
    shifts = INTERLACE_SHIFTS[interlace_lattice(interlace)]
    slab = rfft3(dep(None), dist)
    h = boxsize / n
    for shift in shifts[1:]:
        off = torch.as_tensor(shift, dtype=dtype, device=device) * h
        slab = slab + rfft3(dep(off), dist) * fourier.interlace_phase(
            n, tuple(-c for c in shift), dtype, device, y_rows)
    if len(shifts) > 1:
        slab = slab / len(shifts)
    if deconvolve:
        slab = slab * fourier.deconvolution_factor(n, order, dtype, device, y_rows)
    return slab


def delta_power_grid(pos, gridsize: int, boxsize: float, order: int = 4,
                     deconvolve: bool = True, interlace=True, dist=None):
    """|δ(k)|² over the rfft layout (with ``dist`` this rank's y-slab,
    from its particle shard), interlaced and deconvolved."""
    n = gridsize
    mean = None

    def dep(off):
        nonlocal mean
        p = pos if off is None else periodic_wrap(pos + off, boxsize)
        if dist is None:
            grid = deposit(p, 1.0, n, boxsize, order)
            if mean is None:
                mean = grid.mean()
        else:
            grid = deposit_distributed(p, 1.0, n, boxsize, order, dist)
            if mean is None:
                mean = grid.sum()
                torch.distributed.all_reduce(mean, group=dist.group)
                mean = mean / n**3
        return grid / mean - 1.0

    return _interlaced_slab(dep, n, boxsize, order, deconvolve, interlace,
                            pos.dtype, pos.device, dist).abs() ** 2


def particle_mass_slab(pos_list, weight_list, gridsize: int, boxsize: float,
                       order: int = 4, deconvolve: bool = True, interlace=True, dist=None):
    """rfft slab of the unnormalised mass field of particle groups, at
    the conventions of :func:`powerspec` (interpolation, deconvolution,
    interlacing).  Kept in Fourier space: an irfft round trip would
    drop the interlaced slab's non-Hermitian Nyquist components.  With
    ``dist`` each rank passes its shards and gets its y-slab."""
    n = gridsize
    order = interpolation_order(order)

    def dep(off):
        grid = None
        for p, w in zip(pos_list, weight_list):
            pp = p if off is None else periodic_wrap(p + off, boxsize)
            g = (deposit(pp, w, n, boxsize, order) if dist is None
                 else deposit_distributed(pp, w, n, boxsize, order, dist))
            grid = g if grid is None else grid + g
        return grid

    p0 = pos_list[0]
    return _interlaced_slab(dep, n, boxsize, order, deconvolve, interlace,
                            p0.dtype, p0.device, dist)


def combined_powerspec(pos_list, weight_list, fluid_grids, gridsize: int,
                       boxsize: float, order: int = 4, deconvolve: bool = True,
                       interlace=True, bins_per_decade=40, k_max=None,
                       shotnoise: float | None = None, dist=None):
    """P(k) of a combined mass-weighted field: particle groups (through
    :func:`particle_mass_slab`) plus fluid ϱ grids (their modes copied
    onto ``gridsize`` where they live on another mesh), δ normalised by
    the combined mean.  ``shotnoise`` is subtracted into
    'power_corrected' when given (see :func:`combined_shotnoise`).  With
    ``dist`` each rank passes its particle shards and its x-rows of the
    fluid grids, and gets the whole spectrum."""
    n = gridsize
    slab = None
    if pos_list:
        # the fluid grids are densities: the deposit by the cell volume
        slab = particle_mass_slab(pos_list, weight_list, n, boxsize, order=order,
                                  deconvolve=deconvolve, interlace=interlace, dist=dist)
        slab = slab / ((boxsize / n) ** 3)
    for g in fluid_grids:
        gs = rfft3(g, dist)
        if g.shape[-1] != n:
            gs = fourier.copy_modes(gs, g.shape[-1], n, dist=dist)
        slab = gs if slab is None else slab + gs
    if dist is None:
        mean = slab[0, 0, 0].real / n**3
    else:
        # the k = 0 mode lies on the rank whose y-slab holds kj = 0
        mean = slab.real.new_zeros(())
        if dist.rows(n)[0] == 0 and slab.shape[1]:
            mean = mean + slab[0, 0, 0].real / n**3
        torch.distributed.all_reduce(mean, group=dist.group)
    out = _binned((slab / mean).abs() ** 2, n, boxsize, bins_per_decade, k_max, dist)
    if shotnoise is not None:
        out["power_corrected"] = out["power"] - shotnoise
    return out


def combined_shotnoise(weights, counts, boxsize: float) -> float:
    """Shot noise of a mass-weighted particle field of several groups:
    V·Σ w_j²N_j / (Σ w_jN_j)² (V/N for equal weights)."""
    num = sum(float(w) ** 2 * int(c) for w, c in zip(weights, counts))
    den = sum(float(w) * int(c) for w, c in zip(weights, counts)) ** 2
    return boxsize**3 * num / den if den else 0.0


def grid_powerspec(delta, boxsize: float, n_particles: int | None = None, dist=None):
    """P(k) of a real-space δ grid, with the binning of
    :func:`powerspec`; V/n_particles is subtracted into
    'power_corrected' when given.  With ``dist`` each rank passes its
    x-rows of the grid and gets the whole spectrum."""
    n = delta.shape[-1]
    out = _binned(rfft3(delta, dist).abs() ** 2, n, boxsize, dist=dist)
    if n_particles:
        out["power_corrected"] = out["power"] - boxsize**3 / n_particles
    return out


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
              order=4, deconvolve: bool = True, interlace=True,
              bins_per_decade=40, k_max: float | None = None, dist=None):
    """Measure P(k) of one particle component.  Returns a dict of numpy
    arrays k, modes, power, power_corrected (shot noise V/N
    subtracted).  ``bins_per_decade``: an int or the running dict.  With
    ``dist`` each rank passes its particle shard and gets the whole
    spectrum."""
    n = gridsize
    p2 = delta_power_grid(pos, n, boxsize, interpolation_order(order), deconvolve,
                          interlace, dist)
    out = _binned(p2, n, boxsize, bins_per_decade, k_max, dist)
    out["power_corrected"] = out["power"] - boxsize**3 / n_particles
    return out
