"""Particle-mesh (PM) gravity (port of concept_tpu/forces/pm.py; reference src/interactions.py:1985-2415 particle_mesh and
apply_particle_mesh_force, the potential factor −4πG/|k|² at
interactions.py:2092-2113, the long-range cutoff exp(−rₛ²k²) for P³M).

Pipeline: deposit ϱ (the comoving density) → rfft3 → φ(k) = −4πG
ϱ(k)/k² · deconv^(2·order) [· exp(−rₛ²k²)] → ∂φ by i·k (Fourier) or a
real-space stencil → gather at the particles → Δmom = −m ∇φ · ᔑa⁻¹dt.

The deposit and the gather are one of two pairs: the generic one
(grid/interp.py, any order, with interlacing) or, for CIC without
interlacing, the block kernels of PERF.md rows 10-11 over particles
sorted by 2³-mesh-cell block (:func:`_block_density_slab`): every
particle goes through them, and the gather reads the three gradient
components in one launch.
``deposit_method`` chooses (grid/interp.resolve_deposit_method); the
potential and its gradients do not depend on the choice.

Over the slab decomposition (``dist``, grid/fft.GridDistribution) the
generic pair runs as in the JAX package: each rank deposits its particles
(``parallel.step.deposit_distributed``), the potential lives on its
y-slab, and each gradient grid is replicated for the gather.  The halo
form that replicates nothing is ``parallel.step.
pm_momentum_updates_distributed_halo``.
"""

from __future__ import annotations

import math

import torch

from concept_tpu_torch.components import periodic_wrap
from concept_tpu_torch.grid import fourier
from concept_tpu_torch.grid.bucketed import deposit_bucketed, gather_bucketed, sort_blocks
from concept_tpu_torch.grid.fft import irfft3, rfft3
from concept_tpu_torch.grid.interp import (
    deposit, gather, interpolation_order, resolve_deposit_method,
)
from concept_tpu_torch.grid.stencil import diff_grid
from concept_tpu_torch.parallel.step import deposit_distributed, replicate

# Interlacing lattices (reference mesh.py:78-183 Lattice): shifts in cell
# units applied to the particles; each shifted deposit is phase-rotated
# back in k-space and the primitives averaged, cancelling the leading
# image aliases ('bcc': the odd images; 'fcc': the odd and half the even).
INTERLACE_SHIFTS = {
    "sc": [(0.0, 0.0, 0.0)],
    "bcc": [(0.0, 0.0, 0.0), (0.5, 0.5, 0.5)],
    "fcc": [(0.0, 0.0, 0.0), (0.0, 0.5, 0.5), (0.5, 0.0, 0.5), (0.5, 0.5, 0.0)],
}


def interlace_lattice(interlace) -> str:
    """An interlace option (bool or lattice name) as a lattice kind ('sc'
    = no interlacing; True = 'bcc', the reference's default)."""
    if interlace is True:
        return "bcc"
    if interlace in (False, None):
        return "sc"
    kind = str(interlace).lower()
    if "body" in kind:
        kind = "bcc"
    elif "face" in kind:
        kind = "fcc"
    elif "simple" in kind or kind == "":
        kind = "sc"
    if kind not in INTERLACE_SHIFTS:
        raise ValueError(f"unknown interlacing lattice {interlace!r}")
    return kind


def interlace_pair(interlace) -> tuple[str, str]:
    """(upstream, downstream) lattice kinds of a bool, name or pair
    option (reference potential_options['interlace'],
    interactions.py:1930-2191: upstream interlaces the deposit,
    downstream the force interpolation)."""
    if isinstance(interlace, (tuple, list)):
        up, down = interlace
        return interlace_lattice(up), interlace_lattice(down)
    return interlace_lattice(interlace), "sc"


def _shifted(p, shift, h: float, boxsize: float, sign: float = 1.0):
    """Positions p (N, 3) moved by sign·shift cells, wrapped into the box."""
    if not any(shift):
        return p
    off = torch.tensor(shift, dtype=p.dtype, device=p.device) * h
    return periodic_wrap(p + sign * off, boxsize)


def _phase(slab, n: int, shift, y_rows=None):
    """The slab of a grid sampled at the +shift-cell points: F̂·e^{+ik·sh}."""
    if not any(shift):
        return slab
    return slab * fourier.interlace_phase(n, tuple(-c for c in shift),
                                          slab.real.dtype, slab.device, y_rows)


def _y_rows(dist, n: int):
    return None if dist is None else dist.slab(n)


def density_slab(pos, masses, gridsize: int, boxsize: float, order: int = 2,
                 interlace=False, info: dict | None = None, dist=None):
    """Deposit particles → the comoving density ϱ(k) (rfft layout; with
    ``dist`` this rank's y-slab of it, from its particle shard).

    pos: (N, 3) or a list of them; masses: a scalar or a list.
    ``interlace``: False/'sc', True/'bcc' or 'fcc' — shifted deposits
    combined in k-space (reference Lattice interlacing, mesh.py:77-183).
    ``info`` receives the unshifted deposit's mass ('mass_sum', float64,
    over every rank)."""
    n = gridsize
    h = boxsize / n
    pos_list = pos if isinstance(pos, (list, tuple)) else [pos]
    mass_list = masses if isinstance(masses, (list, tuple)) else [masses]
    shifts = INTERLACE_SHIFTS[interlace_lattice(interlace)]
    slab = None
    for shift in shifts:
        grid = None
        for p, m in zip(pos_list, mass_list):
            p = _shifted(p, shift, h, boxsize)
            g = (deposit(p, m, n, boxsize, order=order) if dist is None
                 else deposit_distributed(p, m, n, boxsize, order, dist))
            grid = g if grid is None else grid + g
        if info is not None and not any(shift):
            info["mass_sum"] = grid.sum(dtype=torch.float64)
            if dist is not None:
                torch.distributed.all_reduce(info["mass_sum"], group=dist.group)
        # undo the particle shift
        s = _phase(rfft3(grid / h**3, dist), n, shift, _y_rows(dist, n))
        slab = s if slab is None else slab + s
    return slab / len(shifts)


def gravity_potential_slab(rho_slab, gridsize: int, boxsize: float, G: float,
                           deconv_order: int = 0,
                           longrange_scale: float | None = None, y_rows=None,
                           z_cols=None):
    """φ(k) = −4πG ϱ(k)/|k|² (·exp(−rₛ²|k|²) for the P³M long-range
    part), times the sinc deconvolution of total power ``deconv_order``
    (upstream + downstream, promoted to one global factor as in reference
    interactions.py:2060-2080).  The k = 0 mode is zeroed.  ``y_rows``:
    the kj rows of a rank's y-slab, ``z_cols`` its kk columns of a
    Fourier pencil (grid/fourier.py), whose padded columns (kk > n/2) are
    set to zero."""
    n = gridsize
    dtype = rho_slab.real.dtype
    dev = rho_slab.device
    ki, kj, kk = fourier.k_int_vectors(n, dev, y_rows, z_cols)
    k2 = (2 * math.pi / boxsize) ** 2 * (ki * ki + kj * kj + kk * kk).to(dtype)
    factor = torch.where(k2 > 0, -4 * math.pi * G / torch.where(k2 > 0, k2, 1.0),
                         0.0)
    if longrange_scale is not None:
        factor = factor * torch.exp(-(longrange_scale**2) * k2)
    if deconv_order:
        factor = factor * fourier.deconvolution_factor(n, deconv_order, dtype,
                                                       dev, y_rows, z_cols)
    phi = rho_slab * factor
    if z_cols is not None:
        phi[..., max(0, n // 2 + 1 - z_cols[0]):] = 0
    if (y_rows is None or y_rows[0] == 0) and (z_cols is None or z_cols[0] == 0):
        phi[0, 0, 0] = 0
    return phi


def potential_gradient_grids(phi_slab, gridsize: int, boxsize: float,
                             differentiation="fourier", dist=None):
    """∂φ/∂x_d real grids (3, n, n, n): 'fourier' (order 0 in the
    reference's parlance, mesh.py:3466) or a real-space stencil of order
    2/4/6/8 (reference diff_domaingrid, mesh.py:4874).  With ``dist``
    (φ on this rank's y-slab) each rank gets the whole grids: the Fourier
    gradients are replicated, and for a stencil the potential is."""
    n = gridsize
    y_rows = _y_rows(dist, n)

    def whole(real):
        return real if dist is None else replicate(real, dist)

    if differentiation in ("fourier", 0):
        return torch.stack([
            whole(irfft3(fourier.fourier_diff(phi_slab, n, boxsize, d, y_rows), n, dist))
            for d in range(3)])
    phi = whole(irfft3(phi_slab, n, dist))
    return torch.stack([diff_grid(phi, boxsize, d, int(differentiation))
                        for d in range(3)])


def _block_density_slab(pos_list, mass_list, gridsize: int, boxsize: float,
                        info: dict | None = None):
    """ϱ(k) through the row-10 kernel (CIC, one device), and the
    block-sorted particles of each component, which the row-11 gather
    reads again.  Every particle goes through the kernel: the sorted
    layout has no capacity, so nothing overflows.  (The JAX package's
    buckets hold at most max(16, 4·8N/n³) a block; it takes at most
    max(256, N/16) particles beyond that and silently drops the rest
    from deposit and force; ROADMAP Queue 3.)"""
    n = gridsize
    sbs, grid = [], None
    for p, m in zip(pos_list, mass_list):
        sb = sort_blocks(p, n, boxsize)
        g = deposit_bucketed(sb, m, n)
        sbs.append(sb)
        grid = g if grid is None else grid + g
    if info is not None:
        info["n_overflow"] = 0
        # summed in float64: a float32 total of 2²⁴ particle masses cannot
        # resolve one particle's mass
        info["mass_sum"] = grid.sum(dtype=torch.float64)
    return rfft3(grid / (boxsize / n) ** 3), sbs


def pm_gravity_momentum_updates(pos_list, mass_list, gridsize: int, boxsize: float,
                                G: float, kick_integral, order=2,
                                deconvolve: tuple = (True, True),
                                differentiation="fourier",
                                deposit_method: str = "scatter",
                                longrange_scale: float | None = None,
                                interlace=False, info: dict | None = None, dist=None):
    """The PM momentum updates Δmom, a list of (N_i, 3) aligned with
    pos_list (positions (N_i, 3), masses scalars; with ``dist`` this
    rank's shards, and each gradient grid replicated for the gather).

    kick_integral: ᔑa⁻¹dt (matter), the exact time integral of the
    potential's a-dependence over the kick.  deconvolve: (upstream,
    downstream) — compensate the deposit and/or the interpolation window
    (reference potential_options['deconvolve'], interactions.py:2060-2080).
    ``deposit_method`` 'pallas' (or 'auto' on the card) takes the block
    kernels of rows 10-11 for the deposit and the gather where their
    preconditions hold (CIC, no interlacing); the potential and its
    gradients are the same either way.  ``info``, a dict, receives
    'n_overflow' (0: no path drops or defers a particle) and 'mass_sum'
    (the deposited mass, 0-dim float64)."""
    order = interpolation_order(order)
    il_up, il_down = interlace_pair(interlace)
    n = gridsize
    h = boxsize / n
    kernels = order == 2 and (il_up, il_down) == ("sc", "sc") and dist is None
    y_rows = _y_rows(dist, n)
    sbs = None
    if resolve_deposit_method(deposit_method, pos_list[0].device, kernels) == "pallas":
        rho, sbs = _block_density_slab(pos_list, mass_list, n, boxsize, info)
    else:
        if info is not None:
            info["n_overflow"] = 0
        rho = density_slab(pos_list, mass_list, n, boxsize, order, il_up, info, dist)
    phi = gravity_potential_slab(
        rho, n, boxsize, G, deconv_order=order * (int(deconvolve[0]) + int(deconvolve[1])),
        longrange_scale=longrange_scale, y_rows=y_rows)
    del rho
    if sbs is not None:
        # the three gradient grids first, then one row-11 launch gathers
        # them all at each component's particles
        grads = potential_gradient_grids(phi, n, boxsize, differentiation)
        del phi
        return [(-m * kick_integral) * gather_bucketed(sb, grads, n)
                for sb, m in zip(sbs, mass_list)]
    down_shifts = INTERLACE_SHIFTS[il_down]

    def interpolated(grid_for, p):
        """Downstream-interlaced interpolation (reference
        interactions.py:2188-2191 lattice_downstream): for each primitive
        shift s, the grid sampled at the +s-shifted points, read with the
        particle coordinate in that frame, p − s·h; summed over s."""
        acc = None
        for shift in down_shifts:
            v = gather(grid_for(shift), _shifted(p, shift, h, boxsize, -1.0), boxsize,
                       order=order)
            acc = v if acc is None else acc + v
        return acc

    updates = [torch.zeros_like(p) for p in pos_list]
    if differentiation in ("fourier", 0):
        # one gradient dimension at a time: a single real grid per shift
        # lives beside φ(k), holding the peak to about two grids
        for d in range(3):
            grads = {}

            def grad_for(shift, d=d):
                if shift not in grads:
                    g = irfft3(fourier.fourier_diff(_phase(phi, n, shift, y_rows), n, boxsize,
                                                    d, y_rows), n, dist)
                    grads[shift] = g if dist is None else replicate(g, dist)
                return grads[shift]

            for i, (p, m) in enumerate(zip(pos_list, mass_list)):
                updates[i][:, d] = (-m * kick_integral) * (
                    interpolated(grad_for, p) / len(down_shifts))
        return updates
    # stencil differentiation: one gradient set per downstream shift (φ
    # phase-rotated in Fourier space, then differentiated)
    grad_sets = {}

    def grads_for(shift):
        if shift not in grad_sets:
            grad_sets[shift] = potential_gradient_grids(_phase(phi, n, shift, y_rows), n,
                                                        boxsize, differentiation, dist)
        return grad_sets[shift]

    for i, (p, m) in enumerate(zip(pos_list, mass_list)):
        for d in range(3):
            updates[i][:, d] = (-m * kick_integral / len(down_shifts)) * interpolated(
                lambda shift, d=d: grads_for(shift)[d], p)
    return updates
