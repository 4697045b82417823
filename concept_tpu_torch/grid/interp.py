"""Plain CIC particle ↔ mesh interpolation (port of the order-2 path of
``deposit`` / ``gather``, concept_tpu/grid/interp.py; reference
src/mesh.py:5052-5413, 376, 1512).

Grid convention: cell-centred (grid point (i, j, k) at ((i+½)h, (j+½)h,
(k+½)h), h = boxsize/gridsize), periodic.  The global stepper's PM uses
these for the particles that overflow the block capacity of the kernel
layout.  NGP, TSC and PCS wait for ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

import torch

ORDER_ITEM = "ROADMAP Queue 1 item 4: NGP/TSC/PCS interpolation"


def _check_order(order):
    if order not in (2, "CIC", "cic"):
        raise NotImplementedError(f"interpolation order {order!r} ({ORDER_ITEM})")


def cic_corners(anchors, fracs, n: int):
    """The 8 CIC corners of per-dimension anchors (int64) and fractions:
    (flat periodic mesh index, weight) pairs, in the JAX package's corner
    order (the CUDA kernels' too)."""
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                idx = ((torch.remainder(anchors[0] + a, n) * n
                        + torch.remainder(anchors[1] + b, n)) * n
                       + torch.remainder(anchors[2] + c, n))
                wt = ((fracs[0] if a else 1.0 - fracs[0])
                      * (fracs[1] if b else 1.0 - fracs[1])
                      * (fracs[2] if c else 1.0 - fracs[2]))
                yield idx, wt


def _corners(pos, gridsize: int, boxsize: float):
    """The 8 CIC corners of positions (N, 3) on the cell-centred mesh."""
    u = pos / (boxsize / gridsize) - 0.5
    i0 = torch.floor(u)
    return cic_corners(i0.to(torch.int64).unbind(1), (u - i0).unbind(1), gridsize)


def deposit(pos, quantity, gridsize: int, boxsize: float, order=2):
    """Deposit per-particle ``quantity`` (scalar or (N,)) at pos (N, 3)
    onto an (n, n, n) grid; the grid sums to sum(quantity)."""
    _check_order(order)
    n = gridsize
    q = torch.broadcast_to(torch.as_tensor(quantity, dtype=pos.dtype,
                                           device=pos.device), pos.shape[:1])
    grid = torch.zeros(n**3, dtype=pos.dtype, device=pos.device)
    for idx, w in _corners(pos, n, boxsize):
        grid.index_add_(0, idx, w * q)
    return grid.reshape(n, n, n)


def gather(grid, pos, boxsize: float, order=2):
    """Interpolate the (n, n, n) grid at pos (N, 3): (N,) values."""
    _check_order(order)
    n = grid.shape[0]
    flat = grid.reshape(-1)
    out = torch.zeros(pos.shape[0], dtype=grid.dtype, device=grid.device)
    for idx, w in _corners(pos, n, boxsize):
        out += flat[idx] * w
    return out
