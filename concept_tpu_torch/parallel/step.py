"""The 1D slab decomposition's collectives over ``torch.distributed``
(port of concept_tpu/parallel/step.py:38-279; reference
communication.py:135 exchange, :563 communicate_ghosts), and the PM kick
on the 2D pencils of ``-n AxB`` (port of :282-340).

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
    neighbours with ``batch_isend_irecv`` (:func:`add_span_rows`,
    :func:`span_rows` over :func:`slab_spans`).  At world size 1 the
    neighbour is the rank itself and the planes wrap periodically (the
    JAX halo deposit counts them twice there, a layout its
    ``make_distribution`` never builds).

The rung stepper over ranks (p3mrungs.py) splits its (K, C) cell layout
by x-planes of columns: rank r owns the planes :func:`rank_planes` gives
it, ⌊r·nc/d + ½⌋ on, which need not split evenly, so that their mesh rows
may differ from its x-slab by up to half a column at each end.  Its sweep
receives one or two neighbour planes a side of supplier slots
(:func:`halo_planes`), its PM deposits onto its planes' rows and a halo
row a side and moves them onto the FFT slabs (:func:`add_span_rows`),
and gathers from each gradient's rows brought back (:func:`span_rows`);
its rebucket sends each particle to the rank of its new plane
(grid/fft.exchange).

:func:`realize_shard` realizes a rank's lattice planes (ic.py) and hands
them to the ranks whose index shards hold their ids (:func:`hand_off`,
:func:`to_index_shard`), which is also how the rung adapter's flat state
leaves its layout; :func:`rows_to_root` gives one rank the whole state
to write, where ``replicate`` and :func:`gather_rows` give it to every
rank.  The JAX package shards the same layout along its cell axis where
d divides the cell count, and lets GSPMD insert these collectives;
elsewhere it steps the whole layout on every device.

On the pencils (grid/fft.GridDistribution2D) the particles keep their
index shards over the A·B ranks; :func:`deposit_distributed_2d` deposits
a rank's shard onto a whole local grid and leaves its z-pencil by two
``reduce_scatter``s (along x among the A ranks that share its b, along y
among the B that share its a), and :func:`pm_momentum_updates_distributed_2d`
transforms on the pencils and makes each gradient whole on every rank
(:func:`whole_from_pencil`, two ``all_gather``s) for the gather, as the
JAX package does: whole grids on every rank, no halo.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from concept_tpu_torch.components import ParticleState
from concept_tpu_torch.grid.fft import (  # noqa: F401  (exchange: this layer's callers)
    GridDistribution, exchange, irfft3, rfft3, row_starts,
)
from concept_tpu_torch.grid.interp import deposit, interpolation_order, spline_weights
from concept_tpu_torch import ic

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


def reduce(x, dist, op=tdist.ReduceOp.SUM):
    """x reduced in place over the ranks of ``dist`` (x itself where
    ``dist`` is None): what each stepper's ``reduce`` does."""
    if dist is not None:
        tdist.all_reduce(x, op=op, group=dist.group)
    return x


def replicate(arr, dist: GridDistribution):
    """The whole array from each rank's equal block along dim 0 (an x-slab
    or a particle shard): ``all_gather``."""
    arr = arr.contiguous()
    out = torch.empty((dist.n_devices * arr.shape[0], *arr.shape[1:]), dtype=arr.dtype,
                      device=arr.device)
    _all_gather(out, arr, group=dist.group)
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


def _ring(to_next, to_prev, dist: GridDistribution, shapes=None):
    """Send ``to_next`` to rank r+1 and ``to_prev`` to rank r−1 (on the
    ring); returns (what r−1 sent forward, what r+1 sent back).  At world
    size 1 both neighbours are the rank itself.  ``shapes`` (the shapes
    of what r−1 and r+1 send) is needed where they differ from what this
    rank sends; an empty piece is not sent (both ends know its shape)."""
    d = dist.n_devices
    if d == 1:
        return to_next, to_prev
    r = dist.rank
    nxt = tdist.get_global_rank(dist.group, (r + 1) % d) if dist.group else (r + 1) % d
    prv = tdist.get_global_rank(dist.group, (r - 1) % d) if dist.group else (r - 1) % d
    sp, sn = shapes or (to_next.shape, to_prev.shape)
    from_prev = to_next.new_empty(sp)
    from_next = to_prev.new_empty(sn)
    ops = []
    for op, t, peer, tag in ((tdist.isend, to_next, nxt, 0), (tdist.irecv, from_prev, prv, 0),
                             (tdist.isend, to_prev, prv, 1), (tdist.irecv, from_next, nxt, 1)):
        if t.numel():
            ops.append(tdist.P2POp(op, t.contiguous() if op is tdist.isend else t, peer,
                                   dist.group, tag=tag))
    for req in tdist.batch_isend_irecv(ops) if ops else ():
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


def span_deposit(pos, quantity, n: int, boxsize: float, order, span):
    """The deposit of quantity (a scalar or (M,)) at particles (M, 3) whose
    clouds lie in the global mesh rows [lo, hi) of ``span``, onto those
    rows: (hi − lo, n, n), x not wrapped (:func:`_slab_corners`)."""
    lo, hi = span
    q = torch.as_tensor(quantity, dtype=pos.dtype, device=pos.device)
    out = torch.zeros((hi - lo) * n * n, dtype=pos.dtype, device=pos.device)
    for idx, w in _slab_corners(pos, n, boxsize, order, lo, hi - lo):
        out.index_add_(0, idx, w * q)
    return out.reshape(hi - lo, n, n)


def span_gather(grids, pos, boxsize: float, order, span):
    """Fields (D, hi − lo, n, n) on the global mesh rows [lo, hi) of
    ``span`` interpolated at particles (M, 3) whose clouds lie there:
    (D, M)."""
    lo, hi = span
    n = grids.shape[-1]
    flat = grids.reshape(grids.shape[0], -1)
    out = torch.zeros((grids.shape[0], pos.shape[0]), dtype=grids.dtype, device=grids.device)
    for idx, w in _slab_corners(pos, n, boxsize, order, lo, hi - lo):
        out += flat[:, idx] * w
    return out


def deposit_distributed_halo(pos, weight, quantity, gridsize: int, boxsize: float,
                             order, dist: GridDistribution):
    """Slab-resident particles (:func:`sort_to_slabs`) → this rank's
    x-slab of the deposit of quantity·weight: a deposit onto the slab
    extended by ``halo`` planes a side, whose outer planes go to the ring
    neighbours and are added to their boundary rows (2·halo·n² values a
    rank instead of the n³ of :func:`deposit_distributed`)."""
    n = gridsize
    order = interpolation_order(order)
    spans = slab_spans(n, _halo(order), dist)
    q = torch.as_tensor(quantity, dtype=pos.dtype, device=pos.device) * weight
    return add_span_rows(span_deposit(pos, q, n, boxsize, order, spans[dist.rank]), spans,
                         dist)


def gather_distributed_halo(grad, pos, weight, boxsize: float, order,
                            dist: GridDistribution):
    """This rank's x-slab of a grid (rows, n, n), extended by ``halo``
    planes from each ring neighbour, interpolated at its slab-resident
    particles: (M,) values times ``weight``."""
    order = interpolation_order(order)
    spans = slab_spans(grad.shape[1], _halo(order), dist)
    ext = span_rows(grad, spans, dist)
    return span_gather(ext[None], pos, boxsize, order, spans[dist.rank])[0] * weight


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

    n = gridsize
    order = interpolation_order(order)
    slabbed, w, orig_idx, n_over = sort_to_slabs(pos, dist, boxsize)
    grid = deposit_distributed_halo(slabbed, w, mass, n, boxsize, order, dist)
    if info is not None:
        total = grid.sum(dtype=torch.float64)
        tdist.all_reduce(total, group=dist.group)
        info.update(mass_sum=total, n_overflow=n_over)
    phi = gravity_potential_slab(
        rfft3(grid / (boxsize / n) ** 3, dist), n, boxsize, G,
        deconv_order=order * (int(deconvolve[0]) + int(deconvolve[1])),
        longrange_scale=longrange_scale, y_rows=dist.slab(n))
    del grid
    vals = torch.stack([
        gather_distributed_halo(slab_gradient(phi, n, boxsize, d, dist), slabbed, w, boxsize,
                                order, dist) for d in range(3)], dim=1)
    return to_shard_order((-mass * kick_integral) * vals, orig_idx, pos.shape[0], dist), n_over


def deposit_distributed_2d(pos, mass, gridsize: int, boxsize: float, order, dist2d,
                           deposit_method: str = "auto"):
    """This rank's particle shard → its z-pencil (n/A, n/B, n) of the
    whole deposit of ``mass`` a particle (grid/fft.GridDistribution2D;
    port of concept_tpu/parallel/step.py:282-306): a deposit onto a whole
    local grid (through the row-10 kernel over the block-sorted particles
    where ``deposit_method`` resolves to it: CIC on the card, as
    forces/pm.py's one-device PM; else ``grid/interp.deposit``), then one
    ``reduce_scatter`` along x within the A ranks that share b and one
    along y within the B ranks that share a.  Returns (the pencil, the
    deposited mass of all ranks in float64, the block-sorted particles
    that the row-11 gather reads again, or None where row 10 did not
    deposit)."""
    from concept_tpu_torch.grid.bucketed import deposit_bucketed, sort_blocks
    from concept_tpu_torch.grid.interp import resolve_deposit_method

    n = gridsize
    dist2d.check(n)
    order = interpolation_order(order)
    sb = None
    if resolve_deposit_method(deposit_method, pos.device, order == 2) == "pallas":
        sb = sort_blocks(pos, n, boxsize)
        g = deposit_bucketed(sb, mass, n)
    else:
        g = deposit(pos, mass, n, boxsize, order=order)
    total = g.sum(dtype=torch.float64)
    tdist.all_reduce(total, group=dist2d.flat.group)
    # x split over the A ranks sharing b, then y (made the leading dim)
    # over the B ranks sharing a
    rx, ry = n // dist2d.na, n // dist2d.nb
    gx = g.new_empty((rx, n, n))
    _reduce_scatter(gx, g, group=dist2d.group_a)
    del g
    gy = gx.new_empty((ry, rx, n))
    _reduce_scatter(gy, gx.transpose(0, 1).contiguous(), group=dist2d.group_b)
    return gy.transpose(0, 1).contiguous(), total, sb


def whole_from_pencil(pencil, dist2d, out=None):
    """A real z-pencil (n/A, n/B, n) → the whole grid (n, n, n) on every
    rank (into ``out`` where given): an ``all_gather`` along y within the
    B ranks that share a, then along x within the A ranks that share b."""
    rx, ry, n = pencil.shape
    gy = pencil.new_empty((n, rx, n))
    _all_gather(gy, pencil.transpose(0, 1).contiguous(), group=dist2d.group_b)
    out = pencil.new_empty((n, n, n)) if out is None else out
    _all_gather(out, gy.transpose(0, 1).contiguous(), group=dist2d.group_a)
    return out


def pm_momentum_updates_distributed_2d(pos, mass, gridsize: int, boxsize: float, G,
                                       kick_integral, dist2d, order=2,
                                       deconvolve=(True, True), longrange_scale=None,
                                       deposit_method: str = "auto",
                                       info: dict | None = None):
    """One PM kick's momentum updates over the 2D pencils (port of
    concept_tpu/parallel/step.py:309-340): :func:`deposit_distributed_2d`,
    the pencil ``rfft3``, the potential on the Fourier pencil
    (``longrange_scale`` for P³M), its three Fourier gradients back to
    z-pencils, each made whole on every rank (:func:`whole_from_pencil`)
    and gathered at the rank's particles (through the row-11 kernel on
    the deposit's block sort where the row-10 kernel deposited, else
    ``grid/interp.gather``).  Returns Δmom (N/(A·B), 3) of this rank's
    shard.  ``info`` receives 'mass_sum' (float64, all ranks) and
    'n_overflow' (0).  The JAX package deconvolves by 2·order whatever
    ``deconvolve`` says; this honours it (the same at its default)."""
    from concept_tpu_torch.forces.pm import gravity_potential_slab
    from concept_tpu_torch.grid.bucketed import gather_bucketed
    from concept_tpu_torch.grid.fourier import fourier_diff
    from concept_tpu_torch.grid.interp import gather

    n = gridsize
    order = interpolation_order(order)
    grid, total, sb = deposit_distributed_2d(pos, mass, n, boxsize, order, dist2d,
                                             deposit_method)
    if info is not None:
        info.update(mass_sum=total, n_overflow=0)
    rows, cols = dist2d.x_rows(n), dist2d.z_cols(n)
    phi = gravity_potential_slab(
        rfft3(grid / (boxsize / n) ** 3, dist2d), n, boxsize, G,
        deconv_order=order * (int(deconvolve[0]) + int(deconvolve[1])),
        longrange_scale=longrange_scale, y_rows=rows, z_cols=cols)
    grads = grid.new_empty((3, n, n, n))
    del grid
    for d in range(3):
        whole_from_pencil(irfft3(fourier_diff(phi, n, boxsize, d, rows, cols), n, dist2d),
                          dist2d, out=grads[d])
    del phi
    coef = -mass * kick_integral
    if sb is not None:
        return coef * gather_bucketed(sb, grads, n)
    return coef * torch.stack([gather(grads[d], pos, boxsize, order=order)
                               for d in range(3)], dim=1)


def slab_gradient(phi, n: int, boxsize: float, d: int, dist: GridDistribution):
    """∂_d of the potential φ (this rank's y-slab of an n-grid) as this
    rank's x-slab of the real grid: the Fourier derivative on the y-slab
    and the slab FFT back."""
    from concept_tpu_torch.grid.fourier import fourier_diff

    return irfft3(fourier_diff(phi, n, boxsize, d, dist.rows(n)), n, dist)


def to_shard_order(vals, orig_idx, n_own: int, dist: GridDistribution):
    """Rows computed at the slab-resident particles of :func:`sort_to_slabs`
    (``orig_idx`` their indices) → this rank's index shard of n_own
    particles, in index order: each row sent back to the rank whose shard
    holds its index."""
    lo, hi = dist.shard(n_own * dist.n_devices)
    back, idx = exchange([vals, orig_idx], torch.div(orig_idx, hi - lo, rounding_mode="floor"),
                         dist)
    out = vals.new_empty((n_own, *vals.shape[1:]))
    out[idx - lo] = back
    return out


def halo_rows(grid, h: int, dist: GridDistribution):
    """This rank's x-rows of a grid (..., R, n, n) padded along x with the
    h rows before and after them, taken periodically from the ranks that
    hold them (the ring of :func:`_ring`): (..., R + 2h, n, n).  At world
    size 1 the halo is the rank's own rows wrapped, so that a stencil of
    reach ≤ h on the padded rows, cropped, is the whole grid's.  A rank
    must hold at least h rows (the rows split ⌊r·n/d + ½⌋ on,
    grid/fft.row_starts): fewer raise ValueError, which run.run's layout
    check raises before anything is realized."""
    R = grid.shape[-3]
    if R < h:
        raise ValueError(f"rank {dist.rank} holds {R} rows of a grid whose stencil "
                         f"reaches {h}")
    got_prev, got_next = _ring(grid[..., R - h:, :, :], grid[..., :h, :, :], dist)
    return torch.cat([got_prev, grid, got_next], dim=-3)


def plane_starts(nc: int, d: int) -> list:
    """The first plane of each of d ranks' x-planes of an nc-plane column
    grid, and nc: rank r takes planes [⌊r·nc/d + ½⌋, ⌊(r+1)·nc/d + ½⌋),
    so that its mesh rows lie within half a column of its FFT slab at
    each end (grid/fft.row_starts, the rule of the realization's uneven
    slabs)."""
    return row_starts(nc, d)


def rank_planes(nc: int, dist: GridDistribution, rank: int | None = None) -> tuple[int, int]:
    """(first plane, planes) of a rank's x-planes of an nc-plane column
    grid (:func:`plane_starts`; nc/d each where d divides nc), in rank
    order."""
    d = dist.n_devices
    r = dist.rank if rank is None else rank
    if nc < d:
        raise ValueError(f"{nc} planes of columns leave a rank of the {d} without one")
    starts = plane_starts(nc, d)
    return starts[r], starts[r + 1] - starts[r]


def plane_owner(nc: int, dist: GridDistribution, device=None):
    """(nc,) int64: the rank of each plane (:func:`rank_planes`)."""
    starts = plane_starts(nc, dist.n_devices)
    return torch.tensor([r for r in range(dist.n_devices)
                         for _ in range(starts[r + 1] - starts[r])], dtype=torch.int64,
                        device=device)


def plane_rows(nc: int, cb: int, dist: GridDistribution, rank: int | None = None):
    """[lo, hi) of the global mesh rows of a rank's planes of columns cb
    mesh cells wide with a halo row a side: the rows of its slab mesh
    (grid/cuda_cells.py ``planes``; lo = −1 and hi = n + 1 wrap)."""
    x0, nx = rank_planes(nc, dist, rank)
    return x0 * cb - 1, (x0 + nx) * cb + 1


def slab_spans(n: int, halo: int, dist: GridDistribution) -> list:
    """Every rank's FFT slab of an n-row axis with ``halo`` rows a side,
    as the spans of :func:`add_span_rows` and :func:`span_rows`."""
    return [(s - halo, s + R + halo)
            for s, R in (dist.slab(n, r) for r in range(dist.n_devices))]


def _span_pieces(spans, n: int, dist: GridDistribution):
    """Where the spans of rows meet the FFT slabs of n rows: (lo, hi) of
    this rank's span, (s0, R) of its slab, and four counts of rows: its
    span's below its slab and above it, rank r+1's span's below rank
    r+1's slab (the last rows of this slab) and rank r−1's span's above
    rank r−1's slab (the first rows of this slab)."""
    d, r = dist.n_devices, dist.rank
    s0, R = dist.slab(n)
    lo, hi = spans[r]

    def below(q):
        return max(0, dist.slab(n, q % d)[0] - spans[q % d][0])

    def above(q):
        return max(0, spans[q % d][1] - dist.slab(n, q % d)[0] - R)

    if not (lo < s0 + R and hi > s0 and below(r) <= R and above(r) <= R):
        raise ValueError(f"rows [{lo}, {hi}) reach past the slabs either side of "
                         f"[{s0}, {s0 + R})")
    return (lo, hi), (s0, R), below(r), above(r), below(r + 1), above(r - 1)


def add_span_rows(ext, spans, dist: GridDistribution):
    """A deposit on the global mesh rows [lo, hi) of this rank's span
    (``spans``: every rank's (lo, hi); lo may be −1 and hi n + 1, which
    wrap) → this rank's FFT slab (R, n, n) with every rank's rows in it
    added: a span's rows below its slab go to rank r−1's last rows, those
    above to rank r+1's first rows, over the ring.  The spans are the
    slabs with halo rows (:func:`slab_spans`), or the rung stepper's
    planes of columns with a halo row, which need not split evenly and
    then differ from the slabs (:func:`plane_rows`)."""
    n = ext.shape[-1]
    (lo, hi), (s0, R), below, above, from_next, from_prev = _span_pieces(spans, n, dist)
    got_prev, got_next = _ring(ext[hi - lo - above:], ext[:below], dist,
                               shapes=((from_prev, n, n), (from_next, n, n)))
    a, b = max(lo, s0), min(hi, s0 + R)
    own = ext.new_zeros((R, n, n))
    own[a - s0:b - s0] += ext[a - lo:b - lo]
    own[:from_prev] += got_prev
    own[R - from_next:] += got_next
    return own


def span_rows(grid, spans, dist: GridDistribution):
    """This rank's FFT slab of grids (..., R, n, n) → (..., hi − lo, n, n),
    the rows of its span [lo, hi) (``spans`` as in :func:`add_span_rows`):
    those below its slab from rank r−1's last rows, those above from rank
    r+1's first."""
    n = grid.shape[-1]
    (lo, hi), (s0, R), below, above, to_next, to_prev = _span_pieces(spans, n, dist)
    lead = tuple(grid.shape[:-3])
    got_prev, got_next = _ring(grid[..., R - to_next:, :, :], grid[..., :to_prev, :, :], dist,
                               shapes=((*lead, below, n, n), (*lead, above, n, n)))
    a, b = max(lo, s0), min(hi, s0 + R)
    return torch.cat([got_prev, grid[..., a - s0:b - s0, :, :], got_next], dim=-3)


def neighbour_planes(cols, plane: int, dist: GridDistribution):
    """(the last ``plane`` columns of rank r−1, the first of rank r+1) of
    the per-column arrays ``cols`` (..., C_r): the planes of columns
    either side of this rank's (``plane`` = w·nc² columns for w planes a
    side; every rank holds at least w planes)."""
    return _ring(cols[..., -plane:], cols[..., :plane], dist)


def halo_planes(sup, nc: int, boxsize: float, dist: GridDistribution, width: int = 1):
    """This rank's supplier slots (3, K_s, C_r) → (3, K_s, (C_r/nc² +
    2·width)·nc²): the ``width`` neighbour planes before and after its
    own (1 for the ±1 sweep, 2 for the reach-2 sweep).  A neighbour plane
    across a face of the box (rank 0's first, the last rank's second;
    both at world size 1) is shifted by ∓boxsize along x, as the
    one-device sweep shifts a neighbour column across that face, so that
    the sweep over these planes sees every pair as the whole box's sweep
    does."""
    prev, nxt = neighbour_planes(sup, width * nc * nc, dist)
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


def split_owner(ids, N: int, dist: GridDistribution):
    """The rank that holds each of ``ids`` (int, (M,)) in the index shards
    of N particles (:meth:`GridDistribution.split`, which are
    :meth:`GridDistribution.shard`'s wherever d divides N)."""
    bounds = torch.tensor([dist.split(N, r)[0] for r in range(1, dist.n_devices)],
                          dtype=torch.int64, device=ids.device)
    return torch.bucketize(ids.to(torch.int64), bounds, right=True)


def to_index_shard(rows: list, ids, N: int, dist: GridDistribution):
    """Rows held anywhere (each tensor's row i the particle ``ids[i]``; every
    id of [0, N) on one rank) → this rank's index shard of them in id
    order: each row sent to the rank that holds its id
    (:func:`split_owner`) and placed at id − lo.  Returns (the rows, the
    shard's ids)."""
    lo, hi = dist.split(N)
    ids = ids.to(torch.int64)
    *got, got_ids = exchange([*rows, ids], split_owner(ids, N, dist), dist)
    if got_ids.shape[0] != hi - lo:
        raise RuntimeError(f"rank {dist.rank} received {got_ids.shape[0]} particles for "
                           f"its {hi - lo} ids")
    at = got_ids - lo
    out = []
    for x in got:
        y = torch.empty_like(x)
        y[at] = x
        out.append(y)
    return out, torch.arange(lo, hi, dtype=torch.int64, device=ids.device)


def rows_to_root(state: ParticleState, dist: GridDistribution, root: int = 0) -> ParticleState:
    """Every rank's rows of each tensor of ``state`` stacked by rank on rank
    ``root`` alone (the other ranks get no rows): an :func:`exchange` that
    sends every row there, where :func:`gather_rows` and ``replicate``
    send them to every rank."""
    present = [x for x in state if x is not None]
    dest = torch.full((present[0].shape[0],), root, dtype=torch.int64, device=present[0].device)
    got = iter(exchange(present, dest, dist))
    return ParticleState(*(None if x is None else next(got) for x in state))


def hand_off(state: ParticleState, N: int, dist: GridDistribution, in_order: bool = False,
             with_ids: bool = True) -> ParticleState:
    """A realization's particles on this rank (ic.realize_particles(dist=):
    its lattice planes, with their ids) → this rank's index shard of the N
    particles in id order (:func:`to_index_shard`).  ``in_order``: the
    rank's planes are already its shard in id order (sc on a lattice the
    ranks divide), and nothing is sent."""
    if in_order:
        lo, hi = dist.split(N)
        if state.ids.shape[0] != hi - lo:
            raise RuntimeError(f"rank {dist.rank} realized {state.ids.shape[0]} particles "
                               f"for its {hi - lo} ids")
        pos, mom, ids = state.pos, state.mom, state.ids
    else:
        (pos, mom), ids = to_index_shard([state.pos, state.mom], state.ids, N, dist)
    return ParticleState(pos=pos, mom=mom, ids=ids.to(torch.int32) if with_ids else None)


def realize_shard(lin, spec, boxsize: float, a: float, dist=None, with_ids: bool = False,
                  **kw) -> ParticleState:
    """ic.realize_particles (``kw`` its options), over the ranks of
    ``dist`` handed to this rank's index shard of the particles in id
    order (:func:`hand_off`; ids kept only ``with_ids``): what
    ``sim.Simulation`` and ``p3mrungs.RungSimulationAdapter`` start from.
    No rank realizes or holds the whole state."""
    st = ic.realize_particles(lin, spec, boxsize, a, with_ids=with_ids, dist=dist, **kw)
    if dist is None:
        return st
    # each rank's planes are already its shard in id order on one rank,
    # and for sc on n planes that the ranks divide: nothing to send
    lattice = kw.get("lattice") or ic.preic_lattice_of(spec.N)
    d = dist.n_devices
    in_order = d == 1 or (lattice == "sc" and round(spec.N ** (1 / 3)) % d == 0)
    return hand_off(st, spec.N, dist, in_order=in_order, with_ids=with_ids)
