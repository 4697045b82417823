"""Particle ↔ mesh interpolation at orders 1-4 (NGP/CIC/TSC/PCS; port of
concept_tpu/grid/interp.py; reference src/mesh.py:5052-5413, 376, 1512).

Grid convention: cell-centred (grid point (i, j, k) at ((i+½)h, (j+½)h,
(k+½)h), h = boxsize/gridsize), periodic.  B-spline weights of the
signed distance x (cell units) between particle and grid point:

  NGP (1): top-hat      CIC (2): 1-|x|
  TSC (3): ¾-x² / ½(3/2-|x|)²      PCS (4): (4-6x²+3|x|³)/6 / (2-|x|)³/6

Deposit methods: the JAX package's names are all accepted.  'scatter',
'sort' and 'sorted' compute one and the same ``index_add_`` here: 'sort'
and 'sorted' are XLA formulations of the same sum that exist only because
XLA's scatter serialises on the TPU (concept_tpu/grid/interp.py:32-35).
'pallas' names the block kernels of PERF.md rows 10-11 (CUDA on the card,
their plain versions on the CPU), which forces/pm.py takes where their
preconditions hold; 'auto' picks them on a CUDA tensor there and
'scatter' everywhere else (:func:`resolve_deposit_method`).
"""

from __future__ import annotations

import torch

ORDER_NAMES = {"NGP": 1, "CIC": 2, "TSC": 3, "PCS": 4}
DEPOSIT_METHODS = ("auto", "scatter", "sort", "sorted", "pallas")


def interpolation_order(order) -> int:
    if isinstance(order, str):
        return ORDER_NAMES[order.upper()]
    order = int(order)
    if order not in (1, 2, 3, 4):
        raise ValueError(f"interpolation order {order} not in 1-4")
    return order


def resolve_deposit_method(method: str, device, kernel_path: bool) -> str:
    """'pallas' (the block kernels) or 'scatter'.  ``kernel_path``: the
    kernels' preconditions hold (CIC, no interlacing, one device).
    'auto' takes the kernels on a CUDA device only: on the TPU the JAX
    package resolves 'auto' to 'sorted', elsewhere to 'scatter'; the
    port's departure keeps the card on its hand kernels (ROADMAP Queue 3)."""
    if method not in DEPOSIT_METHODS:
        raise ValueError(f"deposit_method {method!r} not in {DEPOSIT_METHODS}")
    if method == "auto":
        method = "pallas" if torch.device(device).type == "cuda" else "scatter"
    return "pallas" if method == "pallas" and kernel_path else "scatter"


def spline_weights(u, order: int):
    """Per-dimension lowest corner index (int64) and the ``order``
    B-spline weights at u = pos/h − ½ (cell units, so that an integer u
    sits on a grid point)."""
    if order in (1, 3):  # NGP/TSC anchor at round(u), f ∈ [−½, ½]
        i0 = torch.round(u)
        f = u - i0
        if order == 1:
            return i0.to(torch.int64), [torch.ones_like(u)]
        return i0.to(torch.int64) - 1, [0.5 * (0.5 - f) ** 2, 0.75 - f**2,
                                         0.5 * (0.5 + f) ** 2]
    i0 = torch.floor(u)  # CIC/PCS anchor at floor(u), f ∈ [0, 1)
    f = u - i0
    if order == 2:
        return i0.to(torch.int64), [1.0 - f, f]
    return i0.to(torch.int64) - 1, [
        (1 - f) ** 3 / 6, (4 - 6 * f**2 + 3 * f**3) / 6,
        (4 - 6 * (1 - f) ** 2 + 3 * (1 - f) ** 3) / 6, f**3 / 6]


def corners(lows, weights, n: int):
    """The order³ corners of per-dimension lowest indices ``lows``
    (int64) and weight lists: (flat periodic mesh index, weight) pairs,
    x slowest, in the JAX package's corner order (the CUDA kernels'
    too), the weight formed as (wx·wy)·wz."""
    for a, wx in enumerate(weights[0]):
        ia = torch.remainder(lows[0] + a, n) * n
        for b, wy in enumerate(weights[1]):
            ib = (ia + torch.remainder(lows[1] + b, n)) * n
            wxy = wx * wy
            for c, wz in enumerate(weights[2]):
                yield ib + torch.remainder(lows[2] + c, n), wxy * wz


def cic_corners(anchors, fracs, n: int):
    """The 8 CIC corners of per-dimension anchors (int64) and fractions."""
    return corners(anchors, [(1.0 - f, f) for f in fracs], n)


def _corners(pos, gridsize: int, boxsize: float, order: int):
    """The order³ corners of positions (N, 3) on the cell-centred mesh."""
    u = pos / (boxsize / gridsize) - 0.5
    lows, weights = zip(*(spline_weights(u[:, d], order) for d in range(3)))
    return corners(lows, weights, gridsize)


def deposit(pos, quantity, gridsize: int, boxsize: float, order=2):
    """Deposit per-particle ``quantity`` (scalar or (N,)) at pos (N, 3)
    onto an (n, n, n) grid by ``index_add_`` (every deposit method but
    'pallas'); the grid sums to sum(quantity)."""
    n = gridsize
    q = torch.broadcast_to(torch.as_tensor(quantity, dtype=pos.dtype,
                                           device=pos.device), pos.shape[:1])
    grid = torch.zeros(n**3, dtype=pos.dtype, device=pos.device)
    for idx, w in _corners(pos, n, boxsize, interpolation_order(order)):
        grid.index_add_(0, idx, w * q)
    return grid.reshape(n, n, n)


def gather(grid, pos, boxsize: float, order=2):
    """Interpolate the (n, n, n) grid at pos (N, 3): (N,) values."""
    n = grid.shape[0]
    flat = grid.reshape(-1)
    out = torch.zeros(pos.shape[0], dtype=grid.dtype, device=grid.device)
    for idx, w in _corners(pos, n, boxsize, interpolation_order(order)):
        out += flat[idx] * w
    return out


def gather_vector(grids, pos, boxsize: float, order=2):
    """Gather a 3-vector field given as (3, n, n, n) → (N, 3)."""
    return torch.stack([gather(grids[d], pos, boxsize, order) for d in range(3)],
                       dim=1)
