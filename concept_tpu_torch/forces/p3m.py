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
Over ranks (``dist``, the tight rung layout's PM) each particle goes to
the rank of its block's x-plane (parallel/step.rank_planes of the n/2
planes of blocks), which deposits its planes of blocks onto their rows
and a halo row a side; those rows are added onto the ranks' FFT slabs
(parallel/step.add_span_rows), transformed as slabs, and each gradient's
rows come back (step.span_rows) for the gather on the same planes; the
gradients then return to the particles' ranks.
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


def block_layout(px0, py0, pz0, mesh: int, boxsize: float, k_pm: int,
                 planes=None) -> dict:
    """The PM block slots: one stable sort by z-major block key (the block
    kernels' column convention), then a slot scatter, validity from the
    block counts.  Returns the dict of :func:`slot_layout` with slots
    (3, K, C) positions (0 in empty slots), the sorted positions pos_s
    (3, N) and the blocks' row extents ext (C,) int32 (their counts clamped
    to K: the block kernels skip the rows past them) added.  ``planes``
    (bx0, nbx): the particles lie in those planes of blocks, keyed
    (bz·nb + by)·nbx + bx − bx0 (grid/cuda_blocks.py)."""
    nb = _block_count(mesh)
    h = boxsize / mesh
    if planes is None:
        C = nb**3
        key = grid_key((pz0, py0, px0), h, mesh, B)
    else:
        bx0, nbx = planes
        C = nbx * nb * nb
        key = (grid_key((pz0, py0), h, mesh, B) * nbx
               + grid_key((px0,), h, mesh, B) - bx0)
    lay = slot_layout(key, C, k_pm)
    order = lay["order"]
    lay["pos_s"] = torch.stack([px0[order], py0[order], pz0[order]])
    lay["slots"] = scatter_slots(lay["pos_s"], lay["slot"], k_pm, C)
    lay["ext"] = torch.clamp(lay["counts"], max=k_pm).to(torch.int32)
    return lay


def block_pm(slots, w1, ext, s_pos, mass: float, G: float, scale: float,
             boxsize: float, mesh: int, dist=None):
    """The Gaussian-split long-range potential gradient on 2³-mesh-cell
    block slots (3, K, C) (validity weights w1, row extents ext) and at
    the particles s_pos (S, 3) beyond them: the block deposit (row 8) plus
    the plain CIC of s_pos, the FFT, the split potential with
    deconvolution of order 4, the Fourier gradient, the block gather (row
    9) and the plain gather at s_pos.  ``dist``: the slots are this rank's
    planes of blocks (step.rank_planes of the n/2 planes), and mass_sum the
    ranks'.
    Returns (fds (3, K, C), s_fd (3, S), mass_sum (the deposited mass, a
    0-dim float64 tensor))."""
    from concept_tpu_torch.parallel import step

    n = mesh
    bx, by, bz = slots
    planes = spans = y_rows = None
    if dist is not None:
        nb = _block_count(n)
        planes = step.rank_planes(nb, dist)
        spans = [step.plane_rows(nb, B, dist, r) for r in range(dist.n_devices)]
        y_rows = dist.slab(n)
    grid = deposit_blocks(bx, by, bz, w1 * mass, n, boxsize, ext, planes=planes)
    if s_pos.shape[0]:
        grid += (deposit(s_pos, mass, n, boxsize, order=2) if dist is None
                 else step.span_deposit(s_pos, mass, n, boxsize, 2, spans[dist.rank]))
    if dist is not None:
        grid = step.add_span_rows(grid, spans, dist)
    # summed in float64: a float32 total of 2²⁴ particle masses cannot
    # resolve one particle's mass
    mass_sum = grid.sum(dtype=torch.float64)
    if dist is not None:
        torch.distributed.all_reduce(mass_sum, group=dist.group)
    slab = rfft3(grid / (boxsize / n) ** 3, dist)
    del grid
    phi = gravity_potential_slab(slab, n, boxsize, G, deconv_order=4,
                                 longrange_scale=scale, y_rows=y_rows)
    del slab
    grads = torch.stack([irfft3(fourier.fourier_diff(phi, n, boxsize, d, y_rows), n, dist)
                         for d in range(3)])
    del phi
    if dist is not None:
        grads = step.span_rows(grads, spans, dist).contiguous()
    fds = gather_blocks(bx, by, bz, w1, grads, n, boxsize, ext, planes=planes)
    if not s_pos.shape[0]:
        return fds, s_pos.T, mass_sum
    if dist is None:
        s_fd = torch.stack([gather(grads[d], s_pos, boxsize, order=2) for d in range(3)])
    else:
        s_fd = step.span_gather(grads, s_pos, boxsize, 2, spans[dist.rank])
    return fds, s_fd, mass_sum


def pm_gradient_blocks(px0, py0, pz0, mass: float, G: float, scale: float,
                       boxsize: float, mesh: int, k_pm: int = 8,
                       max_overflow: int = 65536, dist=None):
    """The Gaussian-split long-range potential gradient ∂φ at N particles
    given component-wise, through the 2³-mesh-cell PM blocks: the block
    slots of :func:`block_layout`, :func:`block_pm` with the particles
    beyond the block capacity k_pm through the plain CIC (exact while
    there are at most max_overflow of them; the rest deposit and receive
    nothing, as in the JAX package), and the unsort.  The shared PM of
    the global stepper (:func:`pm_longrange_components`) and of the rung
    stepper's tight layout (``p3msim.pm_gradient_layout``).  ``dist``:
    the particles are this rank's; each goes to the rank of its block's
    plane and its gradient comes back (the module docstring), and
    n_overflow and mass_sum are the ranks' (max_overflow a rank).

    Returns (fd (3, N) in input order, n_overflow (an int), mass_sum (the
    deposited mass, a 0-dim float64 tensor))."""
    if dist is not None:
        return _pm_gradient_blocks_ranks(px0, py0, pz0, mass, G, scale, boxsize, mesh,
                                         k_pm, max_overflow, dist)
    N = px0.shape[0]
    lay = block_layout(px0, py0, pz0, mesh, boxsize, k_pm)
    fd, n_overflow, mass_sum = _blocks_unsorted(lay, N, mass, G, scale, boxsize, mesh, k_pm,
                                                max_overflow, None)
    return fd, n_overflow, mass_sum


def _blocks_unsorted(lay, N: int, mass: float, G: float, scale: float, boxsize: float,
                     mesh: int, k_pm: int, max_overflow: int, dist):
    """:func:`block_pm` on the block layout ``lay`` of N particles, the
    gradients (3, N) in the particles' order."""
    slot, order = lay["slot"], lay["order"]
    n_overflow = N - int(lay["valid"].sum())
    sidx = None
    s_pos = lay["pos_s"].new_empty((0, 3))
    if n_overflow > 0:
        sidx = torch.nonzero(lay["rank"] >= k_pm).reshape(-1)[:max_overflow]
        s_pos = lay["pos_s"][:, sidx].T.contiguous()
    fds, s_fd, mass_sum = block_pm(lay["slots"], lay["valid"].to(s_pos.dtype), lay["ext"],
                                   s_pos, mass, G, scale, boxsize, mesh, dist=dist)
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


def _pm_gradient_blocks_ranks(px0, py0, pz0, mass: float, G: float, scale: float,
                              boxsize: float, mesh: int, k_pm: int, max_overflow: int,
                              dist):
    """:func:`pm_gradient_blocks` over the ranks."""
    from concept_tpu_torch.parallel import step

    nb = _block_count(mesh)
    planes = step.rank_planes(nb, dist)
    bx = grid_key((px0,), boxsize / mesh, mesh, B)
    back = torch.stack([torch.full_like(bx, dist.rank),
                        torch.arange(bx.shape[0], device=bx.device)], dim=1)
    pos, back = step.exchange([torch.stack([px0, py0, pz0], dim=1), back],
                              step.plane_owner(nb, dist, bx.device)[bx], dist)
    N = pos.shape[0]
    lay = block_layout(*pos.T, mesh, boxsize, k_pm, planes=planes)
    fd, n_over, mass_sum = _blocks_unsorted(lay, N, mass, G, scale, boxsize, mesh, k_pm,
                                            max_overflow, dist)
    fd, idx = step.exchange([fd.T.contiguous(), back[:, 1]], back[:, 0], dist)
    out = torch.empty((3, px0.shape[0]), dtype=fd.dtype, device=fd.device)
    out[:, idx] = fd.T
    n_over = torch.tensor(n_over, device=bx.device)
    torch.distributed.all_reduce(n_over, group=dist.group)
    return out, int(n_over), mass_sum


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
