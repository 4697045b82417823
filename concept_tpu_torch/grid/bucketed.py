"""Particles sorted by 2³-mesh-cell block, and the CIC deposit and gather
over them (port of ``bucketize_blocks``, ``deposit_bucketed`` and
``gather_bucketed``, concept_tpu/grid/bucketed.py; the blocks' geometry
``B`` and ``_block_count`` also serve the global stepper's position-based
PM blocks, grid/cuda_blocks.py).

A particle is bucketed by its own cell, so its CIC anchor lies within one
mesh cell of its block: the anchor's index in the block's 4³ halo
mini-grid has each coordinate in [0, 2].  Block ids are x-major,
c = (bx·nb + by)·nb + bz, nb = n/2.

:func:`sort_blocks` is the layout the kernels of PERF.md rows 10-11 read
(grid/cuda_pm.py): the N particles in block order, with per-block starts
and counts, no capacity and no padding.  :func:`bucketize_blocks` is the
JAX package's padded slot-major (K, C) layout, the same sort scattered
into slots; the PM kick does not build it.  The TPU's mini-grid
relayouts (``_assemble_global(_T)``, ``_extract_local(_T)``,
``_halo_selection``, the z-band helpers) have no counterpart: the kernels
add to and read the mesh through shared-memory tiles.
"""

from __future__ import annotations

import torch

from concept_tpu_torch.forces.shortrange import run_slots, scatter_slots, sorted_runs

B = 2  # mesh cells per block per dimension
LDIM = B + 2  # extent of a block's halo mini-grid (CIC corners reach ±1)


def _block_count(n: int) -> int:
    if n % B:
        raise ValueError(f"gridsize {n} must be divisible by block size {B}")
    return n // B


def sort_blocks(pos, gridsize: int, boxsize: float) -> dict:
    """Sort the particles pos (N, 3) by block, by one stable sort of the
    block key (``lax.sort`` is stable too, so the order is the JAX
    package's).

    Returns a dict: per particle, in block-sorted order, ``lidx`` (int32;
    the anchor in the block's halo mini-grid, (lx·4 + ly)·4 + lz),
    ``fx``, ``fy``, ``fz`` (the CIC fractions), ``key`` (the block id) and
    ``order`` (int64; the original index of each sorted particle); per
    block, ``starts`` and ``counts`` (C,) int32, unclamped: block c's
    particles are sorted positions [starts[c], starts[c] + counts[c]).
    Computed one dimension at a time, so that no (N, 3) temporary lives
    beside the sort."""
    n = gridsize
    nb = _block_count(n)
    if nb**3 >= 2**31:
        raise ValueError(f"gridsize {n}: {nb}³ blocks do not fit int32 block ids")
    h = boxsize / n
    key = None
    for d in range(3):
        b = torch.clamp((pos[:, d] / h).to(torch.int32), 0, n - 1) // B
        key = b if key is None else key * nb + b
    runs = sorted_runs(key, nb**3)
    del key
    order = runs["order"]
    out = dict(order=order, key=runs["key"], starts=runs["starts"].to(torch.int32),
               counts=runs["counts"].to(torch.int32))
    lidx = None
    for d, name in enumerate(("fx", "fy", "fz")):
        s = pos[:, d][order] / h
        u = s - 0.5
        anchor = torch.floor(u)
        out[name] = u - anchor
        block = torch.clamp(s.to(torch.int32), 0, n - 1) // B
        lo = anchor.to(torch.int32) - block * B + 1
        lidx = lo if lidx is None else lidx * LDIM + lo
    out["lidx"] = lidx
    return out


def bucketize_blocks(pos, q, gridsize: int, boxsize: float, capacity: int,
                     uniform_q: bool = False) -> dict:
    """The particles pos (N, 3) in slot-major (K, C) block buckets: the
    block sort of :func:`sort_blocks`, scattered into K = ``capacity``
    slots per block.

    Returns a dict of slot arrays (K, C): ``lidx`` (int32; (lx·4 + ly)·4 +
    lz), ``fx``, ``fy``, ``fz``, ``q`` (0 in empty slots) and ``valid``;
    and per particle: ``order`` (N,) the original index of each sorted
    particle; ``rank``, ``slot`` (rank·C + key, or K·C beyond the
    capacity) and ``overflow`` (rank ≥ K), in sorted order;
    ``key_sorted``; ``over_idx``, the original indices of the overflowing
    particles.  The JAX package's (C, K) arrays are these transposed, its
    slot key·K + rank."""
    nb = _block_count(gridsize)
    C, K = nb**3, capacity
    lay = run_slots(sort_blocks(pos, gridsize, boxsize), K)
    order, slot = lay["order"], lay["slot"]
    out = {name: scatter_slots(lay[name], slot, K, C) for name in ("lidx", "fx", "fy", "fz")}
    valid = lay["valid"]
    if uniform_q:
        out["q"] = torch.as_tensor(q, dtype=pos.dtype, device=pos.device) * valid
    else:
        qv = torch.broadcast_to(torch.as_tensor(q, dtype=pos.dtype,
                                                device=pos.device), order.shape)
        out["q"] = scatter_slots(qv[order], slot, K, C)
    overflow = lay["rank"] >= K
    out.update(valid=valid, order=order, rank=lay["rank"], slot=slot,
               overflow=overflow, key_sorted=lay["key"], over_idx=order[overflow])
    return out


def deposit_bucketed(sb, q, gridsize: int):
    """CIC deposit of the block-sorted particles ``sb`` (:func:`sort_blocks`)
    with quantity ``q`` (a scalar, or (N,) in the original order) through
    the row-10 kernel (grid/cuda_pm.py): every particle, so the deposit is
    exact at any clustering.  Returns (n, n, n)."""
    from concept_tpu_torch.grid.cuda_pm import deposit_pm  # imports this module

    order = sb["order"]
    dtype = sb["fx"].dtype
    if torch.as_tensor(q).dim() == 0:
        qs = torch.full(order.shape, float(q), dtype=dtype, device=order.device)
    else:
        qs = q.to(dtype)[order]
    return deposit_pm(sb["lidx"], sb["fx"], sb["fy"], sb["fz"], qs, sb["starts"],
                      sb["counts"], gridsize)


def gather_bucketed(sb, grids, gridsize: int):
    """CIC interpolation of the D fields ``grids`` (D, n, n, n) at the
    block-sorted particles ``sb`` through the row-11 kernel (one launch
    for all D), routed back to the original order once: (N, D)."""
    from concept_tpu_torch.grid.cuda_pm import gather_pm  # imports this module

    vals = gather_pm(sb["lidx"], sb["fx"], sb["fy"], sb["fz"], sb["starts"], sb["counts"],
                     grids, gridsize)
    out = torch.empty((vals.shape[1], vals.shape[0]), dtype=vals.dtype, device=vals.device)
    out[sb["order"]] = vals.T
    return out
