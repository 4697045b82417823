"""The global stepper's P³M kick: the short-range sweep plus the
Gaussian-split long-range PM on 2³-mesh-cell blocks (port of
``pm_block_capacity``, ``pm_longrange_components`` and
``p3m_kick_components``, concept_tpu/forces/p3m.py; the block PM,
:func:`pm_gradient_blocks`, also serves the rung stepper's tight layout
through ``p3msim.pm_gradient_layout``).

The PM part sorts the particles once by z-major block key, scatters them
into slot-major (K, C) block slots (validity from the block counts),
deposits through the block kernel (grid/cuda_blocks.py), adds the
particles beyond the block capacity K through the plain CIC deposit
(grid/interp.py, exact while there are at most ``max_overflow`` of them),
solves for the potential (rfft3, Gaussian split, deconvolution of order
4), takes one Fourier gradient per dimension, gathers them at the slots
(and the overflow particles through the plain gather) and unsorts
(:func:`block_pm`, which the persistent P³M stepper's PM binding shares).
Reference semantics: interactions.py:1353-1984 (short range) and
interactions.py:1985-2415 with the exp(−rₛ²k²) factor of
gravity.py:160-180 (mesh part).
"""

from __future__ import annotations

import torch

from concept_tpu_torch.forces.pm import gravity_potential_slab
from concept_tpu_torch.forces.shortrange import (
    grid_key, scatter_slots, shortrange_momentum_updates, slot_layout,
)
from concept_tpu_torch.grid import fourier
from concept_tpu_torch.grid.bucketed import B, _block_count
from concept_tpu_torch.grid.cuda_blocks import deposit_blocks, gather_blocks
from concept_tpu_torch.grid.fft import irfft3, rfft3
from concept_tpu_torch.grid.interp import deposit, gather


def pm_block_capacity(N: int, mesh: int, headroom: float = 8.0) -> int:
    """Deposit-block capacity from the mean occupancy (blocks are B³ = 8
    mesh cells; the overflow beyond the capacity is exact through the
    plain path, so moderate headroom suffices)."""
    mean = N * B**3 / mesh**3
    return max(8, int((headroom * mean + 7) // 8) * 8)


def block_layout(px0, py0, pz0, mesh: int, boxsize: float, k_pm: int) -> dict:
    """The PM block slots: one stable sort by z-major block key (the block
    kernels' column convention), then a slot scatter, validity from the
    block counts.  Returns the dict of :func:`slot_layout` with slots
    (3, K, C) positions (0 in empty slots), the sorted positions pos_s
    (3, N) and the blocks' row extents ext (C,) int32 (their counts clamped
    to K: the block kernels skip the rows past them) added."""
    nb = _block_count(mesh)
    C = nb**3
    lay = slot_layout(grid_key((pz0, py0, px0), boxsize / mesh, mesh, B), C, k_pm)
    order = lay["order"]
    lay["pos_s"] = torch.stack([px0[order], py0[order], pz0[order]])
    lay["slots"] = scatter_slots(lay["pos_s"], lay["slot"], k_pm, C)
    lay["ext"] = torch.clamp(lay["counts"], max=k_pm).to(torch.int32)
    return lay


def block_pm(slots, w1, ext, s_pos, mass: float, G: float, scale: float,
             boxsize: float, mesh: int):
    """The Gaussian-split long-range potential gradient on 2³-mesh-cell
    block slots (3, K, C) (validity weights w1, row extents ext) and at
    the particles s_pos (S, 3) beyond them: the block deposit (row 8) plus
    the plain CIC of s_pos, the FFT, the split potential with
    deconvolution of order 4, the Fourier gradient, the block gather (row
    9) and the plain gather at s_pos.  Returns (fds (3, K, C), s_fd
    (3, S), mass_sum (the deposited mass, a 0-dim float64 tensor))."""
    n = mesh
    bx, by, bz = slots
    grid = deposit_blocks(bx, by, bz, w1 * mass, n, boxsize, ext)
    if s_pos.shape[0]:
        grid += deposit(s_pos, mass, n, boxsize, order=2)
    # summed in float64: a float32 total of 2²⁴ particle masses cannot
    # resolve one particle's mass
    mass_sum = grid.sum(dtype=torch.float64)
    slab = rfft3(grid / (boxsize / n) ** 3)
    del grid
    phi = gravity_potential_slab(slab, n, boxsize, G, deconv_order=4,
                                 longrange_scale=scale)
    del slab
    grads = torch.stack([irfft3(fourier.fourier_diff(phi, n, boxsize, d), n)
                         for d in range(3)])
    del phi
    fds = gather_blocks(bx, by, bz, w1, grads, n, boxsize, ext)
    if not s_pos.shape[0]:
        return fds, s_pos.T, mass_sum
    s_fd = torch.stack([gather(grads[d], s_pos, boxsize, order=2) for d in range(3)])
    return fds, s_fd, mass_sum


def pm_gradient_blocks(px0, py0, pz0, mass: float, G: float, scale: float,
                       boxsize: float, mesh: int, k_pm: int = 8,
                       max_overflow: int = 65536):
    """The Gaussian-split long-range potential gradient ∂φ at N particles
    given component-wise, through the 2³-mesh-cell PM blocks: the block
    slots of :func:`block_layout`, :func:`block_pm` with the particles
    beyond the block capacity k_pm through the plain CIC (exact while
    there are at most max_overflow of them; the rest deposit and receive
    nothing, as in the JAX package), and the unsort.  The shared PM of
    the global stepper (:func:`pm_longrange_components`) and of the rung
    stepper's tight layout (``p3msim.pm_gradient_layout``).

    Returns (fd (3, N) in input order, n_overflow (an int), mass_sum (the
    deposited mass, a 0-dim float64 tensor))."""
    N = px0.shape[0]
    lay = block_layout(px0, py0, pz0, mesh, boxsize, k_pm)
    slot, order = lay["slot"], lay["order"]
    n_overflow = N - int(lay["valid"].sum())
    sidx = None
    s_pos = px0.new_empty((0, 3))
    if n_overflow > 0:
        sidx = torch.nonzero(lay["rank"] >= k_pm).reshape(-1)[:max_overflow]
        s_pos = lay["pos_s"][:, sidx].T.contiguous()
    fds, s_fd, mass_sum = block_pm(lay["slots"], lay["valid"].to(px0.dtype), lay["ext"],
                                   s_pos, mass, G, scale, boxsize, mesh)
    del lay
    # in sorted order: the slots' gradients, 0 past the capacity, then the
    # overflow particles' plain gather
    fds = fds.view(3, -1)
    KC = fds.shape[1]
    val = fds[:, torch.clamp(slot, max=KC - 1)].masked_fill_((slot == KC)[None], 0.0)
    del fds
    if sidx is not None:
        val[:, sidx] = s_fd
    fd = torch.empty_like(val)
    fd[:, order] = val
    return fd, n_overflow, mass_sum


def pm_longrange_components(px0, py0, pz0, mass: float, boxsize: float,
                            G: float, kick_integral: float, mesh: int,
                            longrange_scale: float, k_pm: int = 8,
                            max_overflow: int = 65536):
    """Long-range (Gaussian-split) PM momentum updates, component-wise:
    −mass·kick_integral·∂φ from :func:`pm_gradient_blocks`.

    Returns ((dmx, dmy, dmz), n_overflow, mass_sum): per-particle Δmom,
    the number of particles beyond the block capacity (an int) and the
    deposited mass (a 0-dim float64 tensor)."""
    fd, n_overflow, mass_sum = pm_gradient_blocks(
        px0, py0, pz0, mass, G, longrange_scale, boxsize, mesh, k_pm=k_pm,
        max_overflow=max_overflow)
    return tuple(fd.mul_(-mass * kick_integral)), n_overflow, mass_sum


def p3m_kick_components(px, py, pz, mass: float, boxsize: float, scale: float,
                        cutoff: float, kick_integral: float, mesh: int,
                        n_cells: int, capacity: int, k_pm: int = 8,
                        softening: float = 0.0, G: float = 1.0,
                        max_overflow: int = 2048, pm_max_overflow: int = 65536,
                        softening_kernel: str = "plummer"):
    """Full P³M momentum update: the short-range pair sweep plus the
    Gaussian-split long-range PM, component-wise.

    Returns ((dmx, dmy, dmz), n_sr_overflow, n_pm_overflow, mass_sum),
    the last the PM deposit's mass (0-dim float64)."""
    (dsx, dsy, dsz), n_sr = shortrange_momentum_updates(
        (px, py, pz), mass, boxsize, scale, cutoff, kick_integral,
        n_cells=n_cells, capacity=capacity, softening=softening, G=G,
        max_overflow=max_overflow, softening_kernel=softening_kernel,
    )
    (dlx, dly, dlz), n_pm, mass_sum = pm_longrange_components(
        px, py, pz, mass, boxsize, G, kick_integral, mesh, scale,
        k_pm=k_pm, max_overflow=pm_max_overflow,
    )
    return (dsx + dlx, dsy + dly, dsz + dlz), n_sr, n_pm, mass_sum
