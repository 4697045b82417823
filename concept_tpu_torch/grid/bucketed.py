"""Particles bucketed by 2³-mesh-cell block, and the CIC deposit and
gather over those buckets (port of ``bucketize_blocks``,
``deposit_bucketed`` and ``gather_bucketed``, concept_tpu/grid/bucketed.py;
the blocks' geometry ``B`` and ``_block_count`` also serve the global
stepper's position-based PM blocks, grid/cuda_blocks.py).

A particle is bucketed by its own cell, so its CIC anchor lies within one
mesh cell of its block: the anchor's index in the block's 4³ halo
mini-grid has each coordinate in [0, 2].  The buckets are slot-major
(K, C), C = (n/2)³ blocks with x-major ids (bx·nb + by)·nb + bz, the
layout the kernels of PERF.md rows 10-11 read (grid/cuda_pm.py).  The
TPU's mini-grid relayouts (``_assemble_global(_T)``, ``_extract_local(_T)``,
``_halo_selection``, the z-band helpers) have no counterpart: the kernels
add to and read the mesh directly.
"""

from __future__ import annotations

import torch

from concept_tpu_torch.forces.shortrange import scatter_slots, slot_layout
from concept_tpu_torch.grid.interp import deposit, gather

B = 2  # mesh cells per block per dimension
LDIM = B + 2  # extent of a block's halo mini-grid (CIC corners reach ±1)


def _block_count(n: int) -> int:
    if n % B:
        raise ValueError(f"gridsize {n} must be divisible by block size {B}")
    return n // B


def bucketize_blocks(pos, q, gridsize: int, boxsize: float, capacity: int,
                     uniform_q: bool = False) -> dict:
    """Sort the particles pos (N, 3) into slot-major (K, C) block buckets
    by one stable sort of the block key (``lax.sort`` is stable too, so
    the slots are the JAX package's).

    Returns a dict of slot arrays (K, C): ``lidx`` (int32; (lx·4 + ly)·4 +
    lz), ``fx``, ``fy``, ``fz``, ``q`` (0 in empty slots) and ``valid``;
    and per particle: ``order`` (N,) the original index of each sorted
    particle; ``rank``, ``slot`` (rank·C + key, or K·C beyond the
    capacity) and ``overflow`` (rank ≥ K), in sorted order;
    ``key_sorted``; ``over_idx``, the original indices of the overflowing
    particles (its size costs one host sync).  The JAX package's (C, K)
    arrays are these transposed, its slot key·K + rank."""
    n = gridsize
    nb = _block_count(n)
    C, K = nb**3, capacity
    h = boxsize / n
    s = pos / h
    u = s - 0.5
    anchor = torch.floor(u)
    f = u - anchor
    anchor = anchor.to(torch.int64)
    block = torch.clamp(s.to(torch.int32), 0, n - 1).to(torch.int64) // B
    key = (block[:, 0] * nb + block[:, 1]) * nb + block[:, 2]
    lo = anchor - block * B + 1
    lidx = ((lo[:, 0] * LDIM + lo[:, 1]) * LDIM + lo[:, 2]).to(torch.int32)
    lay = slot_layout(key, C, K)
    order, slot = lay["order"], lay["slot"]
    out = {name: scatter_slots(v[order], slot, K, C)
           for name, v in (("lidx", lidx), ("fx", f[:, 0]), ("fy", f[:, 1]),
                           ("fz", f[:, 2]))}
    valid = lay["valid"]
    if uniform_q:
        out["q"] = torch.as_tensor(q, dtype=pos.dtype, device=pos.device) * valid
    else:
        qv = torch.broadcast_to(torch.as_tensor(q, dtype=pos.dtype,
                                                device=pos.device), key.shape)
        out["q"] = scatter_slots(qv[order], slot, K, C)
    overflow = lay["rank"] >= K
    out.update(valid=valid, order=order, rank=lay["rank"], slot=slot,
               overflow=overflow, key_sorted=lay["key"], over_idx=order[overflow])
    return out


def deposit_bucketed(bk, gridsize: int, pos=None, boxsize: float = 1.0, q=None):
    """CIC deposit from the block buckets through the row-10 kernel
    (grid/cuda_pm.py), plus the overflowing particles through the plain
    CIC when ``pos`` (N, 3) and their quantity ``q`` (scalar or (N,)) are
    given: exact at any clustering.  Returns (n, n, n)."""
    from concept_tpu_torch.grid.cuda_pm import deposit_pm  # imports this module

    grid = deposit_pm(bk["lidx"], bk["fx"], bk["fy"], bk["fz"], bk["q"], gridsize)
    idx = bk["over_idx"]
    if pos is not None and idx.numel():
        qo = q if torch.as_tensor(q).dim() == 0 else q[idx]
        grid += deposit(pos[idx], qo, gridsize, boxsize, order=2)
    return grid


def gather_bucketed(bk, grids, gridsize: int, pos=None, boxsize: float = 1.0):
    """CIC interpolation of the D fields ``grids`` (D, n, n, n) at the
    bucketed particles through the row-11 kernel, routed back to the
    original order: (N, D).  The overflowing particles read the plain CIC
    when ``pos`` is given, else 0."""
    from concept_tpu_torch.grid.cuda_pm import gather_pm  # imports this module

    vals = gather_pm(bk["lidx"], bk["fx"], bk["fy"], bk["fz"],
                     bk["valid"].to(grids.dtype), grids, gridsize)
    D = grids.shape[0]
    KC = bk["valid"].numel()
    slot, order, idx = bk["slot"], bk["order"], bk["over_idx"]
    in_bucket = slot < KC
    slot = torch.clamp(slot, max=KC - 1)
    out = torch.empty((order.shape[0], D), dtype=grids.dtype, device=grids.device)
    for d in range(D):
        out[order, d] = torch.where(in_bucket, vals[d].reshape(-1)[slot], 0.0)
        if pos is not None and idx.numel():
            out[idx, d] = gather(grids[d], pos[idx], boxsize, order=2)
    return out
