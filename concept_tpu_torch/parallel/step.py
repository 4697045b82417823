"""The 1D slab decomposition's collectives over ``torch.distributed``
(port of concept_tpu/parallel/step.py:38-279; reference
communication.py:135 exchange, :563 communicate_ghosts).

Each rank holds N/d particles by index (grid/fft.GridDistribution), an
x-slab of every real grid and a y-slab of every Fourier grid.  The JAX
package writes these steps for GSPMD (``shard_map``, ``psum_scatter``,
``ppermute``); here each collective is explicit:

  * :func:`deposit_distributed`: a full local deposit, then
    ``reduce_scatter`` along x;
  * :func:`replicate`: ``all_gather`` of slabs or shards;
  * :func:`sort_to_slabs`: the particle exchange, counts by
    ``all_to_all_single``, then positions and indices with those splits.
    It drops nothing: the JAX package keeps at most ``capacity`` (2N/d)
    particles a slab and drops the rest from the deposit, which its
    ``Simulation`` never reports (ROADMAP Queue 3);
  * :func:`deposit_distributed_halo` / :func:`gather_distributed_halo`:
    a deposit into (and a gather from) the rank's slab extended by
    ``halo`` planes a side, the boundary planes sent to the ring
    neighbours with ``batch_isend_irecv`` (:func:`add_halo_rows`,
    :func:`with_halo_rows`).  At world size 1 the neighbour is the rank
    itself and the planes wrap periodically (the JAX halo deposit counts
    them twice there, a layout its ``make_distribution`` never builds).

The rung stepper over ranks (p3mrungs.py) splits its (K, C) cell layout
by x-planes of columns: rank r owns the planes :func:`rank_planes` gives
it, whose mesh rows are its x-slab.  Its sweep receives the two
neighbour planes' supplier slots (:func:`neighbour_planes`), its PM
deposits into its slab plus a halo row a side (:func:`add_halo_rows`)
and gathers from there (:func:`with_halo_rows`), and its rebucket sends
each particle to the rank of its new plane (:func:`exchange`).  The JAX
package shards the same layout along its cell axis and lets GSPMD insert
these collectives.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from concept_tpu_torch.grid.fft import GridDistribution, irfft3, rfft3
from concept_tpu_torch.grid.interp import deposit, interpolation_order, spline_weights

# torch 2.13 renamed these two (the old names warn there; older torch has
# only the old ones)
_all_gather = getattr(tdist, "all_gather_single", None) or tdist.all_gather_into_tensor
_reduce_scatter = getattr(tdist, "reduce_scatter_single", None) or tdist.reduce_scatter_tensor


def deposit_distributed(pos, quantity, gridsize: int, boxsize: float, order,
                        dist: GridDistribution):
    """Particles (this rank's shard) → this rank's x-slab of the global
    deposit: each rank deposits onto a full local grid, and one
    ``reduce_scatter`` sums the ranks' grids and leaves each its
    slab."""
    n = gridsize
    _, rows = dist.slab(n)
    g = deposit(pos, quantity, n, boxsize, order=order)
    out = torch.empty((rows, n, n), dtype=g.dtype, device=g.device)
    _reduce_scatter(out, g, group=dist.group)
    return out


def replicate(arr, dist: GridDistribution):
    """The whole array from each rank's equal block along dim 0 (an x-slab
    or a particle shard): ``all_gather``."""
    arr = arr.contiguous()
    out = torch.empty((dist.n_devices * arr.shape[0], *arr.shape[1:]), dtype=arr.dtype,
                      device=arr.device)
    _all_gather(out, arr, group=dist.group)
    return out


def exchange(rows: list, dest, dist: GridDistribution) -> list:
    """Send row i of each tensor in ``rows`` to rank ``dest[i]``: the
    rows received, stacked by source rank, each source's rows in its own
    order (a stable sort by destination)."""
    d = dist.n_devices
    order = torch.argsort(dest, stable=True)
    send = torch.bincount(dest, minlength=d)
    recv = torch.empty_like(send)
    tdist.all_to_all_single(recv, send, group=dist.group)
    send_l, recv_l = send.tolist(), recv.tolist()
    out = []
    for x in rows:
        x = x[order].contiguous()
        y = torch.empty((sum(recv_l), *x.shape[1:]), dtype=x.dtype, device=x.device)
        tdist.all_to_all_single(y, x, output_split_sizes=recv_l, input_split_sizes=send_l,
                                group=dist.group)
        out.append(y)
    return out


def sort_to_slabs(pos, dist: GridDistribution, boxsize: float):
    """This rank's particles (its index shard, (N/d, 3)) → the particles
    of its x-slab: (positions (M, 3), weight (M,) of ones, original
    indices (M,) int64, n_overflow = 0).  The rows come by source rank,
    and within a source in index order: the global index order, which is
    also the order of the JAX package's valid rows in a slab.  The JAX
    package's ``capacity`` and padding rows have no counterpart: nothing
    is dropped."""
    d = dist.n_devices
    lo, _ = dist.shard(pos.shape[0] * d)
    owner = torch.clamp((pos[:, 0] / (boxsize / d)).to(torch.int64), 0, d - 1)
    idx = lo + torch.arange(pos.shape[0], device=pos.device)
    slabbed, orig_idx = exchange([pos, idx], owner, dist)
    return slabbed, torch.ones_like(slabbed[:, 0]), orig_idx, 0


def _halo(order) -> int:
    return max(1, (interpolation_order(order) + 1) // 2)


def _ring(to_next, to_prev, dist: GridDistribution):
    """Send ``to_next`` to rank r+1 and ``to_prev`` to rank r−1 (on the
    ring); returns (what r−1 sent forward, what r+1 sent back).  At world
    size 1 both neighbours are the rank itself."""
    d = dist.n_devices
    if d == 1:
        return to_next, to_prev
    r = dist.rank
    nxt = tdist.get_global_rank(dist.group, (r + 1) % d) if dist.group else (r + 1) % d
    prv = tdist.get_global_rank(dist.group, (r - 1) % d) if dist.group else (r - 1) % d
    from_prev = torch.empty_like(to_next)
    from_next = torch.empty_like(to_prev)
    ops = [tdist.P2POp(tdist.isend, to_next.contiguous(), nxt, dist.group, tag=0),
           tdist.P2POp(tdist.irecv, from_prev, prv, dist.group, tag=0),
           tdist.P2POp(tdist.isend, to_prev.contiguous(), prv, dist.group, tag=1),
           tdist.P2POp(tdist.irecv, from_next, nxt, dist.group, tag=1)]
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


def _slab_corners(pos, n: int, boxsize: float, order: int, x0: int, m: int):
    """The order³ corners of slab-resident positions on a slab of m
    x-planes starting at global plane x0: (flat index into (m, n, n),
    weight) pairs in the corner order of grid/interp.corners.  x is not
    wrapped (the halo planes hold the periodic neighbours) and is clipped
    to the slab, as the JAX package's ``_gather_slab_local``; y and z
    are periodic."""
    u = pos / (boxsize / n) - 0.5
    lows, weights = zip(*(spline_weights(u[:, k], order) for k in range(3)))
    for a, wx in enumerate(weights[0]):
        ia = torch.clamp(lows[0] + a - x0, 0, m - 1) * n
        for b, wy in enumerate(weights[1]):
            ib = (ia + torch.remainder(lows[1] + b, n)) * n
            wxy = wx * wy
            for c, wz in enumerate(weights[2]):
                yield ib + torch.remainder(lows[2] + c, n), wxy * wz


def deposit_distributed_halo(pos, weight, quantity, gridsize: int, boxsize: float,
                             order, dist: GridDistribution):
    """Slab-resident particles (:func:`sort_to_slabs`) → this rank's
    x-slab of the deposit of quantity·weight: a deposit onto the slab
    extended by ``halo`` planes a side, whose outer planes go to the ring
    neighbours and are added to their boundary rows (2·halo·n² values a
    rank instead of the n³ of :func:`deposit_distributed`)."""
    n = gridsize
    order = interpolation_order(order)
    start, rows = dist.slab(n)
    halo = _halo(order)
    if halo > rows:
        raise ValueError(f"{rows} rows a rank hold no halo of {halo} planes")
    m = rows + 2 * halo
    q = torch.as_tensor(quantity, dtype=pos.dtype, device=pos.device) * weight
    ext = torch.zeros(m * n * n, dtype=pos.dtype, device=pos.device)
    for idx, w in _slab_corners(pos, n, boxsize, order, start - halo, m):
        ext.index_add_(0, idx, w * q)
    return add_halo_rows(ext.reshape(m, n, n), halo, dist)


def add_halo_rows(ext, halo: int, dist: GridDistribution):
    """A deposit on this rank's slab extended by ``halo`` rows a side
    (rows + 2·halo, n, n) → the slab (rows, n, n) with every rank's halo
    rows added: the rows below the slab belong to rank r−1's last rows,
    those above to rank r+1's first rows."""
    rows = ext.shape[0] - 2 * halo
    if halo > rows:
        raise ValueError(f"{rows} rows a rank hold no halo of {halo} planes")
    from_prev, from_next = _ring(ext[halo + rows:], ext[:halo], dist)
    own = ext[halo:halo + rows].clone()
    own[:halo] += from_prev
    own[rows - halo:] += from_next
    return own


def with_halo_rows(grid, halo: int, dist: GridDistribution):
    """This rank's slab of grids (..., rows, n, n) → (..., rows + 2·halo,
    n, n), extended by ``halo`` rows of each ring neighbour's slab."""
    rows = grid.shape[-3]
    if halo > rows:
        raise ValueError(f"{rows} rows a rank hold no halo of {halo} planes")
    # rank r+1 needs my last rows below its slab, rank r−1 my first above
    from_prev, from_next = _ring(grid[..., rows - halo:, :, :], grid[..., :halo, :, :], dist)
    return torch.cat([from_prev, grid, from_next], dim=-3)


def gather_distributed_halo(grad, pos, weight, boxsize: float, order,
                            dist: GridDistribution):
    """This rank's x-slab of a grid (rows, n, n), extended by ``halo``
    planes from each ring neighbour, interpolated at its slab-resident
    particles: (M,) values times ``weight``."""
    order = interpolation_order(order)
    rows, n = grad.shape[0], grad.shape[1]
    start, _ = dist.slab(n)
    halo = _halo(order)
    ext = with_halo_rows(grad, halo, dist).reshape(-1)
    out = torch.zeros(pos.shape[0], dtype=grad.dtype, device=grad.device)
    for idx, w in _slab_corners(pos, n, boxsize, order, start - halo, rows + 2 * halo):
        out += ext[idx] * w
    return out * weight


def pm_momentum_updates_distributed_halo(pos, mass, gridsize: int, boxsize: float, G,
                                         kick_integral, dist: GridDistribution, order=2,
                                         deconvolve=(True, True), longrange_scale=None,
                                         info: dict | None = None):
    """One PM kick's momentum updates over the slab decomposition, no
    grid ever replicated: the exchange to slab residency, the halo
    deposit, the slab FFT, the potential and each Fourier gradient on the
    rank's y-slab, the halo gather, and the exchange back.  Returns
    (Δmom (N/d, 3) of this rank's particles in their order, n_overflow =
    0).  ``info`` receives 'mass_sum' (the whole deposit's mass, float64,
    summed over the ranks) and 'n_overflow'."""
    from concept_tpu_torch.forces.pm import gravity_potential_slab
    from concept_tpu_torch.grid.fourier import fourier_diff

    n = gridsize
    order = interpolation_order(order)
    slabbed, w, orig_idx, n_over = sort_to_slabs(pos, dist, boxsize)
    grid = deposit_distributed_halo(slabbed, w, mass, n, boxsize, order, dist)
    if info is not None:
        total = grid.sum(dtype=torch.float64)
        tdist.all_reduce(total, group=dist.group)
        info.update(mass_sum=total, n_overflow=n_over)
    y_rows = dist.slab(n)
    phi = gravity_potential_slab(
        rfft3(grid / (boxsize / n) ** 3, dist), n, boxsize, G,
        deconv_order=order * (int(deconvolve[0]) + int(deconvolve[1])),
        longrange_scale=longrange_scale, y_rows=y_rows)
    del grid
    vals = torch.stack([
        gather_distributed_halo(irfft3(fourier_diff(phi, n, boxsize, d, y_rows), n, dist),
                                slabbed, w, boxsize, order, dist) for d in range(3)], dim=1)
    lo, hi = dist.shard(pos.shape[0] * dist.n_devices)
    back, idx = exchange([(-mass * kick_integral) * vals, orig_idx],
                         torch.div(orig_idx, hi - lo, rounding_mode="floor"), dist)
    dmom = torch.empty_like(pos)
    dmom[idx - lo] = back
    return dmom, n_over


def rank_planes(nc: int, dist: GridDistribution) -> tuple[int, int]:
    """(first plane, planes) of this rank's x-planes of an nc-plane
    column grid: nc/d each, in rank order (the mesh rows of its planes
    are its x-slab, ``dist.slab``)."""
    d = dist.n_devices
    if nc % d:
        raise ValueError(f"{nc} planes of columns do not split over the {d} ranks")
    return dist.rank * (nc // d), nc // d


def neighbour_planes(cols, plane: int, dist: GridDistribution):
    """(the last ``plane`` columns of rank r−1, the first of rank r+1) of
    the per-column arrays ``cols`` (..., C_r): the planes of columns
    either side of this rank's (``plane`` = nc² columns a plane)."""
    return _ring(cols[..., -plane:], cols[..., :plane], dist)


def halo_planes(sup, nc: int, boxsize: float, dist: GridDistribution):
    """This rank's supplier slots (3, K_s, C_r) → (3, K_s, (C_r/nc² + 2)·
    nc²): the neighbour planes before and after its own.  A neighbour
    plane across a face of the box (rank 0's first, the last rank's
    second; both at world size 1) is shifted by ∓boxsize along x, as the
    one-device sweep shifts a neighbour column across that face, so that
    the sweep over these planes sees every pair as the whole box's sweep
    does."""
    prev, nxt = neighbour_planes(sup, nc * nc, dist)
    shift = torch.zeros((3, 1, 1), dtype=sup.dtype, device=sup.device)
    shift[0] = boxsize
    if dist.rank == 0:
        prev = prev - shift
    if dist.rank == dist.n_devices - 1:
        nxt = nxt + shift
    return torch.cat([prev, sup, nxt], dim=-1)


def gather_rows(rows: list, dist: GridDistribution) -> list:
    """Every rank's rows of each tensor in ``rows`` (equal in their first
    dimension on a rank, which may differ between ranks), stacked by rank
    on every rank: an ``all_gather`` of the rows padded to the longest."""
    dev = rows[0].device
    n = torch.tensor([rows[0].shape[0]], dtype=torch.int64, device=dev)
    counts = replicate(n, dist).tolist()
    m = max(counts)
    out = []
    for x in rows:
        pad = torch.zeros((m, *x.shape[1:]), dtype=x.dtype, device=dev)
        pad[:x.shape[0]] = x
        g = replicate(pad, dist)
        out.append(torch.cat([g[r * m:r * m + c] for r, c in enumerate(counts)]))
    return out
