"""Adaptive per-particle rungs on the persistent P³M cell layout — the
production rung stepper (port of concept_tpu/p3mrungs.py).

The particle state lives in slot-major (K, C) arrays over the cells of
one of three layouts (C = nc³, ids x-major, z-fastest), chosen from the
mesh and the device as the JAX package chooses from the mesh and the
backend (``P3MRungSimulation``):

- unified, ``ucb = 8``: cells 8 mesh cells wide, wider than the cutoff:
  the ±1 sweep, and the PM deposit and gather straight on the slot
  arrays (p3msim.pm_gradient_cells, cb = 8);
- unified, ``ucb = 4``: cells 4 mesh cells wide, narrower than the
  cutoff: the one-sided reach-2 sweep over the kept offsets
  (forces/shortrange.reach_offsets) and the cell PM at cb = 4;
- tight (``ucb = 0``): cells at least cutoff·(1 + margin_frac) wide,
  no multiple of the mesh: the ±1 sweep (folded, with minimum image,
  below 3 cells a side: forces/shortrange.sweep_fold), and the block PM
  on the flattened valid slots (p3msim.pm_gradient_layout).

Every sweep takes per-column row bounds (the JAX package's reach sweep
takes none): receivers up to the column's occupancy, or its rung-≥kmin
extent on interior substeps, suppliers up to each neighbour column's
occupancy.

Within every column the slots are kept RUNG-MAJOR: the bucketize key is
cell·NR + (NR−1−rung), so the slots with rung ≥ k form a prefix of each
column.  A substep that kicks rungs ≥ kmin sweeps only the leading
K_act[kmin] rows as receivers against all slots as suppliers, so its
cost follows the active population (the reference's rung economics,
interactions.py:1353-1984).  The PM long range kicks at the base
cadence, deposited and gathered straight on the slot arrays
(p3msim.pm_gradient_cells; at mesh ≥ 768 on the card the memory-lean
p3msim.pm_kick_cells_lean, as the JAX package on the TPU, unless
``pm_diff`` says otherwise).

Kick staggering: rung k (span s_k substeps) kicks at every boundary i
with i mod s_k == 0 over the STRADDLING integral
[edge_i − s_k·δ/2, edge_i + s_k·δ/2] clamped to the base step: the
centred leapfrog per rung, all momenta synchronised at every base-step
boundary (reference main.py:1347-1443).  The end-of-step full sweep
reassigns the rungs and is reused as the next step's boundary-0
acceleration.

Every integer result (slot order, valid, rungs, K_act, tight, _K_occ)
equals the JAX package's: its sorts are stable ``torch.sort`` on the same
composite keys.

Over ranks (``dist``, ``-n N``) the stepper takes the layout one device
takes, and each rank holds the columns of its x-planes
(parallel/step.rank_planes: ⌊r·nc/d + ½⌋ on, so nc need not divide by
d), a (K, C_r) layout of C_r = nc²·planes columns.  Its sweep takes its
neighbours' supplier slots from the ring, one plane a side for the ±1
sweep (the kernel's nx = planes + 2 column grid) and two for the reach-2
sweep (nx = planes + 4), with no receivers on those planes.  The unified
layouts' PM deposits and gathers on the planes' mesh rows with a halo
row a side, moved onto and back from the FFT slabs
(p3msim.pm_gradient_cells, parallel/step.add_span_rows); the tight
layout's block PM sends each valid slot to the rank of its block's plane
and its gradient back (forces/p3m.pm_gradient_blocks).  A rebucket sends
every particle to the rank of its new plane.  The capacity K, the
occupancy row extent K_occ, the highest rung, v_max and the kept count
are agreed over the ranks (all-reduced) before anything depends on them;
the receiver rows K_r and the per-column extents stay each rank's own
(the rows past them hold no active slot).  A rebucket orders the slots
of a column as the one-device stepper does (by key, then by the old
slot's place in the whole layout), so that the ranks' layouts are the
one-device layout's planes until a resort within columns, which each
rank decides alone.  A mesh that d does not divide (the slab FFT), fewer
planes a rank than the sweep's reach (2 at the 4-mesh-cell layout, else
1) and a tight layout of fewer than 3 cells a side (the folded sweep)
raise ValueError (:func:`check_rank_layout`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from concept_tpu_torch.components import periodic_wrap
from concept_tpu_torch.forces.cuda_shortrange import pair_sweep_reach
from concept_tpu_torch.forces.shortrange import (
    SENTINEL, dtype_square, reach_offsets, sweep_slots,
)
from concept_tpu_torch.grid.fft import check_distribution
from concept_tpu_torch.p3msim import (
    margin_cell_count, pm_gradient_cells, pm_gradient_layout, pm_kick_cells_lean,
)
from concept_tpu_torch.utils.terminal import warn

FAC_SOFTENING = 0.025  # reference main.py:2433 Δt_rung_factor base
# The 4-mesh-cell layout's sweep margin in mesh cells, which prunes the
# reach-2 offsets; its one-sided drift tolerance is min(0.5 mesh cells
# [the deposit halo], this).
UNIFIED_SWEEP_MARGIN = 0.55


class RungState(NamedTuple):
    pos: torch.Tensor    # (3, K, C) slot-major positions (rung-major in-column)
    mom: torch.Tensor    # (3, K, C)
    valid: torch.Tensor  # (K, C) bool
    rungs: torch.Tensor  # (K, C) int8 (0 in empty slots)
    ids: torch.Tensor    # (K, C) int32 original particle index (-1 empty)


def _cell_index(comp, nc: int, boxsize: float, mesh_cells: int):
    """Per-dimension cell coordinate.  mesh_cells > 0 (the unified
    layouts): from the MESH index floor(p·mesh/boxsize)//mesh_cells, the
    arithmetic of the deposit geometry, so a particle provably lands
    inside its column's deposit halo; else (the tight layout)
    trunc(p/cell_width)."""
    if mesh_cells > 0:
        inv_h = (nc * mesh_cells) / boxsize
        m = torch.floor(comp * inv_h).to(torch.int64)
        return torch.clamp(torch.div(m, mesh_cells, rounding_mode="floor"), 0, nc - 1)
    return torch.clamp((comp / (boxsize / nc)).to(torch.int64), 0, nc - 1)


def _cell_of(pos, nc: int, boxsize: float, mesh_cells: int):
    cell = torch.zeros_like(pos[0], dtype=torch.int64)
    for comp in pos:
        cell = cell * nc + _cell_index(comp, nc, boxsize, mesh_cells)
    return cell


def _scatter_slots(slot, vals, K: int, C: int, fill=0):
    """(K, C) array holding vals at the flat slot indices (slot = K·C
    drops the entry)."""
    out = torch.full((K * C + 1,), fill, dtype=vals.dtype, device=vals.device)
    out[slot] = vals
    return out[:K * C].reshape(K, C)


def _slots(cell_s, key_ok, C: int, K: int):
    """Flat slot index rank·C + cell of sorted entries (K·C where the
    entry is dropped) and the per-cell counts."""
    N = cell_s.shape[0]
    cell_c = torch.clamp(cell_s, max=C - 1)
    counts = torch.bincount(cell_c[key_ok], minlength=C)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N, device=cell_s.device) - starts[cell_c]
    in_b = (rank < K) & key_ok
    return torch.where(in_b, rank * C + cell_c, K * C), counts


def _column_layout(key, arrays, NR: int, C: int, K: int, n_keep: int):
    """Shared tail of bucketize/rebucketize: stable sort by the composite
    key cell·NR + (NR−1−rung) (invalid entries keyed C·NR), keep the
    leading n_keep, scatter into (K, C) slots.  Returns (RungState,
    n_kept)."""
    key_s, perm = torch.sort(key, stable=True)
    key_s, perm = key_s[:n_keep], perm[:n_keep]
    ok = key_s < C * NR
    cell_s = torch.div(key_s, NR, rounding_mode="floor")
    rung_s = (NR - 1 - key_s % NR).to(torch.int8)
    slot, counts = _slots(cell_s, ok, C, K)
    px, py, pz, mx, my, mz, idl = (_scatter_slots(slot, a[perm], K, C)
                                   for a in arrays)
    occ = torch.clamp(counts, max=K)
    valid = torch.arange(K, device=key.device)[:, None] < occ[None, :]
    state = RungState(
        pos=torch.stack([px, py, pz]), mom=torch.stack([mx, my, mz]),
        valid=valid,
        rungs=torch.where(valid, _scatter_slots(slot, rung_s, K, C), 0).to(torch.int8),
        ids=torch.where(valid, idl, -1).to(torch.int32),
    )
    return state, int(torch.minimum(ok.sum(), occ.sum()))


def bucketize_rungs(pos, mom, rungs0, ids0, boxsize: float, nc: int,
                    capacity: int, NR: int, mesh_cells: int = 0):
    """Flat component arrays (3-tuples of (N,)) → (RungState, n_kept);
    mesh_cells as in :func:`_cell_index`."""
    C = nc**3
    cell = _cell_of(pos, nc, boxsize, mesh_cells)
    key = cell * NR + (NR - 1 - rungs0.to(torch.int64))
    return _column_layout(key, [*pos, *mom, ids0], NR, C, capacity, key.shape[0])


def rebucketize_rungs(state: RungState, boxsize: float, nc: int,
                      capacity: int, n_total: int, NR: int, mesh_cells: int = 0):
    """Re-bucketize the slot arrays at the current positions, carrying
    rungs and ids.  Returns (RungState, n_kept)."""
    M = state.valid.numel()
    C = nc**3
    validf = state.valid.reshape(M)
    flat = state.pos.reshape(3, M)
    mflat = state.mom.reshape(3, M)
    cell = _cell_of(flat, nc, boxsize, mesh_cells)
    rungM = state.rungs.reshape(M).to(torch.int64)
    key = torch.where(validf, cell * NR + (NR - 1 - rungM), C * NR)
    return _column_layout(key, [*flat, *mflat, state.ids.reshape(M)],
                          NR, C, capacity, n_total)


def occupancy_and_activity(state: RungState, boxsize: float, nc: int, NR: int,
                           mesh_cells: int = 0):
    """(max per-cell occupancy at the CURRENT positions, K_act (NR,)):
    the sizing probe before a rebucketize, and the active-prefix row
    counts the re-sorted layout will have."""
    M = state.valid.numel()
    C = nc**3
    validf = state.valid.reshape(M)
    cell = _cell_of(state.pos.reshape(3, M), nc, boxsize, mesh_cells)[validf]
    max_occ = int(torch.bincount(cell, minlength=C).max())
    rungM = state.rungs.reshape(M)[validf].to(torch.int64)
    cnt = torch.bincount(cell * NR + rungM, minlength=C * NR).reshape(C, NR)
    suffix = torch.flip(torch.cumsum(torch.flip(cnt, (1,)), 1), (1,))
    return max_occ, suffix.max(dim=0).values


def _k_act_layout(rungs, valid, NR: int):
    """K_act[k] = 1 + the highest row holding a valid slot with rung ≥ k,
    from the LAYOUT (a stale rung order costs rows, never correctness)."""
    K = valid.shape[0]
    row_max = torch.where(valid, rungs, -1).max(dim=1).values
    rows1 = torch.arange(1, K + 1, device=valid.device)
    ks = torch.arange(NR, device=valid.device)[:, None]
    return ((row_max[None, :] >= ks) * rows1[None, :]).max(dim=1).values


def _rung_tight(rungs, valid, NR: int):
    """tight[k] = max over cells of the number of valid slots with
    rung ≥ k: the K_act a rung-major re-sort would give."""
    return torch.stack([((rungs >= k) & valid).sum(dim=0).max()
                        for k in range(NR)])


def _column_occ_ext(valid):
    """Per-column occupancy extents (C,) int32: 1 + the highest row
    holding a valid slot (LAYOUT extents, correct whether or not the
    valid slots are a column prefix)."""
    K = valid.shape[0]
    rows1 = torch.arange(1, K + 1, dtype=torch.int32, device=valid.device)[:, None]
    return torch.where(valid, rows1, 0).max(dim=0).values.contiguous()


def _column_rung_ext(rungs, valid, NR: int):
    """(NR, C) int32: per column, 1 + the highest row holding a valid
    slot with rung ≥ k (LAYOUT extents)."""
    return torch.stack([_column_occ_ext(valid & (rungs >= k))
                        for k in range(NR)]).contiguous()


def rung_substep(state: RungState, mass: float, G: float, int_drift: float,
                 kick_ints, boxsize: float, nc: int, scale: float,
                 cutoff: float, softening: float, K_r: int,
                 softening_kernel: str = "plummer", NR: int = 8,
                 assign: bool = False, dt_base: float = 1.0,
                 eps_rung: float = 1.0, fac_rung: float = FAC_SOFTENING,
                 acc_cache=None, return_acc: bool = False,
                 sentinel_out: bool = False, K_s: int | None = None,
                 skip_drift: bool = False, rext=None, sext=None,
                 offsets=None, dist=None, sext_halo=None):
    """One rung boundary: drift all slots by int_drift (ᔑa⁻² over the
    sub-interval ending here), then kick each fired rung by its
    straddling integral kick_ints[rung] ((NR,) tensor).

    The short-range acceleration covers the leading K_r rows; with
    acc_cache (positions unchanged since it was computed) no sweep runs.
    assign=True (the last boundary) reassigns rungs from the fresh
    acceleration.  K_s bounds the supplier rows.  sentinel_out=True
    (interior substeps) fills invalid slots with the sweep sentinel
    instead of 0.  ``offsets`` (the 4-mesh-cell layout's reach-2 table)
    selects the reach sweep, else the ±1 sweep (folded below 3 cells a
    side); either takes the row bounds rext/sext (per column, or per
    pencil).  ``dist``: the state is this rank's planes of columns, swept
    between its neighbours' planes (:func:`_sweep_planes`; ``sext_halo``
    their supplier bounds).  Returns (state, (K_act, tight,
    vmax2)[, acc]), each rank's own; the momenta are updated in place
    (the JAX package donates them)."""
    K, C = state.valid.shape
    K_s = K if K_s is None else K_s
    if not K_r <= K_s <= K:
        raise ValueError(f"need K_r ≤ K_s ≤ K, got {K_r}, {K_s}, {K}")
    big = SENTINEL * boxsize
    fill = big if sentinel_out else 0.0
    if skip_drift:
        pos = state.pos
    else:
        pos = torch.where(state.valid[None],
                          periodic_wrap(state.pos + state.mom * (int_drift / mass), boxsize),
                          fill)
    if acc_cache is not None:
        acc = acc_cache[:, :K_r, :]
    else:
        # one shared sentinel array: suppliers (and the ±1 sweep's
        # receivers) are row slices
        pos_s = pos if sentinel_out else torch.where(state.valid[None], pos, big)
        sweep_args = (nc, boxsize, scale, dtype_square(cutoff, pos.dtype),
                      dtype_square(softening, pos.dtype))
        if dist is not None:
            acc = _sweep_planes(pos_s, state.valid, K_r, K_s, sweep_args, softening_kernel,
                                rext, sext, sext_halo, dist, offsets)
        elif offsets is None:
            acc = sweep_slots(pos_s[:, :K_r], pos_s[:, :K_s], *sweep_args,
                              kernel=softening_kernel, rext=rext, sext=sext)
        else:
            # the reach sweep's receivers sit at the opposite sentinel
            recv = torch.where(state.valid[:K_r][None], pos[:, :K_r], -big)
            acc = pair_sweep_reach(recv, pos_s[:, :K_s], *sweep_args, offsets,
                                   kernel=softening_kernel, rext=rext, sext=sext)
    valid_r = state.valid[:K_r]
    per_slot_int = kick_ints[state.rungs[:K_r].to(torch.int64)]
    active = valid_r & (per_slot_int > 0)
    dmom = ((G * mass * mass) * per_slot_int)[None] * acc * active[None]
    mom = state.mom
    mom[:, :K_r].add_(dmom)  # in place: the JAX package donates the state
    zeros = torch.zeros((NR,), dtype=torch.int64, device=pos.device)
    if not assign:
        out = (RungState(pos, mom, state.valid, state.rungs, state.ids),
               (zeros, zeros, torch.zeros((), dtype=pos.dtype, device=pos.device)))
        return out + (acc,) if return_acc else out
    mom.masked_fill_(~state.valid[None], 0.0)  # protective re-mask
    vmax2 = (mom * mom).sum(dim=0).max()
    # rung criterion Δt_i = fac·√(ε/|ẍ_i|) (reference main.py:2433)
    amag = G * mass * torch.sqrt((acc * acc).sum(dim=0))
    dt_i = fac_rung * torch.sqrt(eps_rung / torch.clamp(amag, min=1e-30))
    new_rungs = torch.ceil(torch.log2(torch.clamp(dt_base / dt_i, min=1e-30)))
    new_rungs = torch.clamp(new_rungs, 0, NR - 1).to(torch.int8)
    if K_r < K:
        # rows ≥ K_r are invalid in every column: rung 0
        new_rungs = torch.cat([new_rungs, torch.zeros((K - K_r, C), dtype=torch.int8,
                                                      device=pos.device)])
    new_rungs = torch.where(state.valid, new_rungs, 0).to(torch.int8)
    out = (RungState(pos, mom, state.valid, new_rungs, state.ids),
           (_k_act_layout(new_rungs, state.valid, NR),
            _rung_tight(new_rungs, state.valid, NR), vmax2))
    return out + (acc,) if return_acc else out


def _sweep_planes(pos_s, valid, K_r: int, K_s: int, sweep_args, kernel: str, rext, sext,
                  sext_halo, dist, offsets=None):
    """The sweep of this rank's planes of columns (3, K_r, C_r) over its
    own and its neighbours' supplier slots (parallel/step.halo_planes):
    one plane a side for the ±1 sweep (nx = planes + 2), two for the
    reach-2 sweep over ``offsets`` (nx = planes + 4), whose receivers sit
    at the opposite sentinel.  Row bounds are 0 on the neighbour planes,
    whose bounds as suppliers are ``sext_halo`` (their owners' occupancy
    extents)."""
    from concept_tpu_torch.parallel import step

    nc, boxsize = sweep_args[0], sweep_args[1]
    width = 1 if offsets is None else 2
    W = width * nc * nc
    C_r = pos_s.shape[-1]
    nx = C_r // (nc * nc) + 2 * width
    sup = step.halo_planes(pos_s[:, :K_s], nc, boxsize, dist, width=width)
    zeros = torch.zeros((W,), dtype=torch.int32, device=pos_s.device)
    if rext is None:
        rext = torch.full((C_r,), K_r, dtype=torch.int32, device=pos_s.device)
    rb = torch.cat([zeros, rext, zeros])
    sb = None if sext is None else torch.cat([sext_halo[0], sext, sext_halo[1]])
    if offsets is None:
        acc = sweep_slots(sup[:, :K_r], sup, *sweep_args, kernel=kernel, rext=rb, sext=sb,
                          nx=nx)
    else:
        big = SENTINEL * boxsize
        recv = torch.full((3, K_r, nx * nc * nc), -big, dtype=pos_s.dtype,
                          device=pos_s.device)
        recv[:, :, W:W + C_r] = torch.where(valid[:K_r][None], pos_s[:, :K_r], -big)
        acc = pair_sweep_reach(recv, sup, *sweep_args, offsets, kernel=kernel, rext=rb,
                               sext=sb, nx=nx)
    return acc[:, :, W:W + C_r].contiguous()


def resort_rungs_within_columns(state: RungState, acc, NR: int = 8):
    """Re-establish rung-major row order WITHIN each cell column (a stable
    sort along the row axis; cell membership is untouched).  Only the
    occupancy prefix the acc cache covers is sorted; the acc cache rides
    along so it stays row-aligned."""
    K = state.valid.shape[0]
    Kp = acc.shape[1]
    key = torch.where(state.valid[:Kp], (NR - 1 - state.rungs[:Kp]).to(torch.int64), NR)
    key_s, idx = torch.sort(key, dim=0, stable=True)

    def take(a):  # a: (..., Kp, C)
        return torch.gather(a, -2, idx.expand_as(a))

    valid = key_s < NR
    head = RungState(
        pos=take(state.pos[:, :Kp]), mom=take(state.mom[:, :Kp]), valid=valid,
        rungs=torch.where(valid, (NR - 1 - key_s), 0).to(torch.int8),
        ids=torch.where(valid, take(state.ids[:Kp]), -1).to(torch.int32),
    )
    if Kp < K:
        head = RungState(
            pos=torch.cat([head.pos, state.pos[:, Kp:]], 1),
            mom=torch.cat([head.mom, state.mom[:, Kp:]], 1),
            valid=torch.cat([head.valid, state.valid[Kp:]], 0),
            rungs=torch.cat([head.rungs, state.rungs[Kp:]], 0),
            ids=torch.cat([head.ids, state.ids[Kp:]], 0),
        )
    return head, take(acc)


def pm_kick_rungs(state: RungState, mass: float, G: float, int_pm: float,
                  boxsize: float, mesh: int, scale: float, k_pm: int = 8,
                  pm_max_overflow: int = 262144, cells_cb: int = 0,
                  k_rows: int | None = None, lean: bool | None = None, ext=None,
                  dist=None):
    """Base-cadence PM long-range kick over the leading k_rows slot rows
    (rows beyond the max occupancy are invalid in every column).
    cells_cb > 0 (the unified layouts, cells cells_cb mesh cells wide):
    the slot layout is the deposit layout, with Fourier gradients
    (pm_gradient_cells) or, with ``lean``, the memory-lean kick of
    order-4 stencil gradients one at a time (pm_kick_cells_lean); lean =
    None takes it at mesh ≥ 768 on the card, as the JAX package does on
    the TPU.  cells_cb = 0: the block PM of pm_gradient_layout (block
    capacity k_pm, exact overflow up to pm_max_overflow particles).
    ``ext`` (C,) int32, the layout's per-column occupancy extents, cuts
    the cells' gather to each column's occupied rows.  ``dist``: the
    cells of this rank's planes, mass_sum and n_pm_overflow the
    ranks'.
    Updates the momenta in place (the JAX package donates them).  Returns
    (state, n_pm_overflow (an int, 0 on the unified layouts), mass_sum)."""
    K = state.valid.shape[0]
    kr = K if k_rows is None else min(k_rows, K)
    pos, valid = state.pos[:, :kr], state.valid[:kr]
    if lean is None:
        lean = mesh >= 768 and pos.device.type == "cuda"
    if cells_cb > 0 and lean:
        _, mass_sum = pm_kick_cells_lean(pos, state.mom[:, :kr], valid, mass, G,
                                         int_pm, scale, boxsize, mesh, cb=cells_cb,
                                         ext=ext, dist=dist)
        return state, 0, mass_sum
    if cells_cb > 0:
        fd3, mass_sum = pm_gradient_cells(pos, valid, mass, G, scale, boxsize,
                                          mesh, cb=cells_cb, ext=ext, dist=dist)
        n_over = 0
    else:
        fd3, n_over, mass_sum = pm_gradient_layout(
            pos, valid, mass, G, scale, boxsize, mesh, k_pm=k_pm,
            pm_max_overflow=pm_max_overflow, dist=dist)
    state.mom[:, :kr].add_(fd3, alpha=-mass * int_pm)
    state.mom.masked_fill_(~state.valid[None], 0.0)
    return state, n_over, mass_sum


def _layout_cells(mesh: int, unified, unified_cb, device_type: str) -> int:
    """The layout's cell width in mesh cells, 0 for the tight layout: the
    JAX package's rule (concept_tpu/p3mrungs.py P3MRungSimulation) with
    ``cuda`` in place of its TPU backend."""
    if unified is None:
        unified = mesh % 4 == 0 and mesh // 4 >= 3 and device_type == "cuda"
    if not unified:
        return 0
    if unified_cb is not None:
        need = {8: 3, 4: 5}.get(unified_cb)  # the ±1 / reach-2 sweep
        if need is None or mesh % unified_cb or mesh // unified_cb < need:
            raise ValueError(f"mesh {mesh} cannot take the unified layout with "
                             f"unified_cb = {unified_cb} (cb ∈ {{4, 8}}, mesh % cb"
                             f" == 0, mesh ≥ 24 for 8 and ≥ 20 for 4)")
        return unified_cb
    if mesh % 8 == 0 and mesh // 8 >= 3:
        return 8
    if mesh % 4 == 0 and mesh // 4 >= 5:
        return 4
    raise ValueError(f"mesh {mesh}: the unified layout needs mesh % 8 == 0 "
                     f"(mesh ≥ 24) or mesh % 4 == 0 (mesh ≥ 20)")


def layout_planes(mesh: int, boxsize: float, device_type: str, unified=None,
                  unified_cb=None, margin_frac: float = 0.12) -> tuple[int, int]:
    """(the layout's cell width in mesh cells (0: tight), its cells a
    side nc) as :class:`P3MRungSimulation` chooses them."""
    ucb = _layout_cells(mesh, unified, unified_cb, device_type)
    if ucb:
        return ucb, mesh // ucb
    cutoff = 4.5 * (1.25 * boxsize / mesh)
    return 0, margin_cell_count(boxsize, cutoff, margin_frac)


def check_rank_layout(mesh: int, n_ranks: int, device_type: str = "cuda", unified=None,
                      unified_cb=None, boxsize: float = 1.0, margin_frac: float = 0.12):
    """The rung stepper over ``n_ranks`` ranks takes the layout of one
    device (:func:`layout_planes`), its nc planes of cells split as
    parallel/step.rank_planes splits them.  ValueError where it cannot:
    a mesh the ranks do not divide (the slab FFT), a rank with fewer
    planes than the sweep reaches (2 on the 4-mesh-cell layout, else 1),
    or a tight layout of fewer than 3 cells a side (the folded sweep has
    no planes form).  Returns (ucb, nc)."""
    ucb, nc = layout_planes(mesh, boxsize, device_type, unified, unified_cb, margin_frac)
    if mesh % n_ranks:
        raise ValueError(f"grid {mesh} does not split over {n_ranks} ranks: the slab FFT "
                         f"needs gridsize % ranks == 0")
    from concept_tpu_torch.parallel.step import plane_starts

    need = 2 if ucb == 4 else 1
    starts = plane_starts(nc, n_ranks)
    fewest = min(b - a for a, b in zip(starts[:-1], starts[1:]))
    if fewest < need:
        raise ValueError(f"{nc} planes of cells over {n_ranks} ranks leave a rank "
                         f"{fewest}; the sweep reaches {need} a side")
    if ucb == 0 and nc < 3:
        raise ValueError(f"the tight layout's {nc} cells a side take the folded sweep, "
                         f"which does not run over ranks (3 cells a side or more)")
    return ucb, nc


def _quantize_K(k_act: int, K: int) -> int:
    """Smallest receiver-row count of the ladder {8, 16, 32, ..., K}
    covering k_act (the JAX package bounds its compile variants with it;
    the port keeps it so that both sweep the same rows)."""
    q = 8
    while q < k_act:
        q *= 2
    return min(q, K)


def _pad8(x: int, cap: int) -> int:
    return min(cap, max(8, ((x + 7) // 8) * 8))


def _pad16(x: int, cap: int) -> int:
    """Occupancy-extent quantization for the sweep row bounds."""
    return min(cap, max(8, ((x + 15) // 16) * 16))


class P3MRungSimulation:
    """Production P³M with adaptive rungs on the persistent cell layout.

    Host protocol per base step (one device sync, at the end):
      1. PM kick over the straddling interval (base cadence).
      2. 2^max_rung substeps: drift all + rung kicks on the active
         prefix rows; the last substep (kmin = 0) also reassigns rungs
         and reports (K_act, vmax²).
      3. margin-budget / occupancy bookkeeping → rebucketize.

    The layout (see the module docstring) follows the JAX package's rule
    with the run's device in place of its backend: ``unified=None`` takes
    a unified layout on ``cuda`` when mesh % 4 == 0 and mesh ≥ 12 (cells
    8 mesh cells wide when mesh % 8 == 0 and mesh ≥ 24, else 4 wide when
    mesh ≥ 20, else ValueError), and the tight layout otherwise and on the
    CPU.  ``unified``/``unified_cb`` choose explicitly; a choice the mesh
    cannot take raises.  There is no fall-back to another layout.
    ``pm_diff`` picks the unified layouts' PM gradients: 'spectral'
    (Fourier), 'lean' (order-4 stencil, one component at a time) or
    'auto' (lean at mesh ≥ 768 on the card).  ``dist`` steps this rank's
    planes of columns of the same layout (see the module docstring;
    :func:`check_rank_layout` says what it refuses).
    """

    def __init__(self, n_part: int, boxsize: float, mass: float, G: float,
                 mesh: int | None = None, bg=None, N_rungs: int = 8,
                 margin_frac: float = 0.12, capacity: int | None = None,
                 k_pm: int = 8, softening: float = 0.0,
                 softening_kernel: str = "plummer", fac_rung: float = 1.0,
                 rebucket_every_max: int = 64, unified: bool | None = None,
                 unified_cb: int | None = None, n_total: int | None = None,
                 pm_max_overflow: int = 262144, device=None,
                 pm_diff: str = "auto", dist=None):
        if n_total is not None:
            self.N = int(n_total)
            if mesh is None:
                raise ValueError("non-cubic N requires an explicit mesh")
        else:
            self.N = n_part**3
        self.boxsize = boxsize
        self.mass = mass
        self.G = G
        self.bg = bg
        self.NR = int(N_rungs)
        self.mesh = mesh or 2 * n_part
        self.scale = 1.25 * boxsize / self.mesh
        self.cutoff = 4.5 * self.scale
        self.margin_frac = margin_frac
        mesh_h = boxsize / self.mesh
        self.dist = check_distribution(dist)
        device_type = torch.device(device or "cuda").type
        if self.dist is not None:
            check_rank_layout(self.mesh, self.dist.n_devices, device_type, unified,
                              unified_cb, boxsize, margin_frac)
        self.ucb = _layout_cells(self.mesh, unified, unified_cb, device_type)
        self.unified = self.ucb > 0
        self.offsets = None  # the ±1 sweep
        if self.ucb:
            self.nc = self.mesh // self.ucb
            self.cell_width = self.ucb * mesh_h
            if self.ucb == 8:
                # plain ±1 sweep: pair margin = cell − cutoff; the
                # deposit halo allows ±0.5 mesh cells
                self.margin = 2.0 * min(0.5 * mesh_h,
                                        0.5 * (self.cell_width - self.cutoff))
            else:
                # reach-2 sweep: one-sided tolerance min(the deposit halo
                # 0.5·mesh_h, the offset pruning's margin)
                self.margin = 2.0 * min(0.5, UNIFIED_SWEEP_MARGIN) * mesh_h
                cw = boxsize / self.nc  # as _sr_pair_accel forms it
                self.offsets = reach_offsets(cw, UNIFIED_SWEEP_MARGIN * cw / 4.0)
        else:
            self.nc = margin_cell_count(boxsize, self.cutoff, margin_frac)
            self.cell_width = boxsize / self.nc
            self.margin = self.cell_width - self.cutoff
        self.k_pm = k_pm
        self.pm_max_overflow = pm_max_overflow
        # the unified layouts' PM differentiation: 'spectral' (Fourier),
        # 'lean' (pm_kick_cells_lean) or 'auto' (lean at mesh ≥ 768 on
        # the card)
        if pm_diff not in ("auto", "spectral", "lean"):
            raise ValueError(f"pm_diff {pm_diff!r} not in auto, spectral, lean")
        self.pm_lean = {"auto": None, "spectral": False, "lean": True}[pm_diff]
        self.softening = softening
        self.softening_kernel = softening_kernel
        # rung-criterion ε: the softening length when set, else the PM cell
        self.eps_rung = softening if softening > 0 else mesh_h
        self.fac_rung = FAC_SOFTENING * fac_rung
        self.rebucket_every_max = rebucket_every_max
        if capacity is None:
            mean = self.N / self.nc**3
            capacity = max(8, int(math.ceil(1.3 * mean / 8)) * 8)
        self.capacity = capacity
        self._drift_used = 0.0
        self._K_act = None  # host copy, refreshed per base step
        self._K_occ = None  # occupancy row extent (≤ capacity), per rebucket
        # per-column layout extents for the bounded sweep: _ext_occ (C,)
        # per rebucket, _ext_rung (NR, C) per assign
        self._ext_occ = None
        self._ext_rung = None
        self._acc_cache = None  # (3, K_occ, C) SR acc at current positions
        # over ranks: this rank's planes and its neighbour planes' supplier
        # bounds (their _ext_occ), refreshed with every layout
        self._planes = None
        self._sext_halo = None
        if self.dist is not None:
            from concept_tpu_torch.parallel.step import rank_planes

            self._planes = rank_planes(self.nc, self.dist)
        # pm_mass_deficit_max: the largest |deposited − N·m| of the run,
        # in particle masses; budget_warnings: PM block-overflow budgets
        # exceeded (the tight layout)
        self.stats = {"substeps": 0, "receiver_rows": 0, "full_rows": 0,
                      "max_rung": 0, "base_steps": 0, "pm_mass_deficit_max": 0.0,
                      "budget_warnings": 0}
        self.hysteresis = {}  # step count, Δt, kick sync point (evolve)

    # -------------------------------------------------------------- #
    def _agree(self, x, op=torch.distributed.ReduceOp.MAX):
        """An int, or an integer array element by element, reduced over the
        ranks (x itself on one device)."""
        if self.dist is None:
            return x
        t = torch.as_tensor(np.asarray(x, np.int64), device=self._device)
        torch.distributed.all_reduce(t, op=op, group=self.dist.group)
        return t.cpu().numpy() if t.dim() else int(t)

    def init_state(self, pos, mom, ids=None, rungs=None):
        """pos/mom: 3-tuples of (N,) tensors.  Sizes the capacity from the
        measured max cell occupancy and bucketizes with rung 0 (or the
        given rungs (N,)).  Over ranks each rank passes its index shard
        (ids default to the shard's global indices) and receives the
        particles of its planes."""
        N = pos[0].shape[0]
        dev = pos[0].device
        self._device = dev
        if ids is None:
            lo = 0 if self.dist is None else self.dist.split(self.N)[0]
            ids = torch.arange(lo, lo + N, dtype=torch.int32, device=dev)
        if rungs is None:
            rungs = torch.zeros((N,), dtype=torch.int8, device=dev)
        if self.dist is not None:
            return self._init_state_ranks(pos, mom, ids, rungs)
        counts = torch.bincount(_cell_of(pos, self.nc, self.boxsize, self.ucb),
                                minlength=self.nc**3)
        max_count = int(counts.max())
        self.capacity = max(self.capacity, _pad8(max_count, 1 << 30))
        # rows ≥ K_occ are invalid in every column until the next
        # rebucket; 12 % headroom and a ratchet (see rebucket)
        self._K_occ = _pad16(int(max_count * 1.12), self.capacity)
        state, kept = bucketize_rungs(pos, mom, rungs.to(torch.int8), ids, self.boxsize,
                                      self.nc, self.capacity, self.NR, self.ucb)
        if kept != N:
            raise RuntimeError(f"bucketize kept {kept} of {N} particles")
        self._drift_used = 0.0
        self._set_extents(state)
        return state

    def _set_extents(self, state: RungState):
        """The per-column extents of a new layout (over ranks also the
        neighbour planes' occupancy extents, the sweep's supplier bounds
        there)."""
        self._ext_occ = _column_occ_ext(state.valid)
        self._ext_rung = _column_rung_ext(state.rungs, state.valid, self.NR)
        if self.dist is not None:
            from concept_tpu_torch.parallel.step import neighbour_planes

            width = 1 if self.offsets is None else 2  # the sweep's reach in planes
            self._sext_halo = neighbour_planes(self._ext_occ, width * self.nc**2, self.dist)

    # -------------------------------------------------------------- #
    # over ranks: the layout of this rank's planes
    def _to_planes(self, floats, ints, order):
        """Send each particle to the rank of its x-plane: floats (n, 6)
        positions and momenta, ints (n, 2) ids and rungs, order (n,) int64
        its place in the one-device order.  Returns (floats, ints, order,
        local column (m,)) of this rank's particles, and the largest
        column count of all ranks."""
        from concept_tpu_torch.parallel.step import exchange, plane_owner

        nc, (x0, npl) = self.nc, self._planes
        cell = _cell_of(floats[:, :3].T, nc, self.boxsize, self.ucb)
        dest = plane_owner(nc, self.dist, cell.device)[torch.div(cell, nc * nc,
                                                                  rounding_mode="floor")]
        floats, ints, order = exchange([floats, ints, order], dest, self.dist)
        col = _cell_of(floats[:, :3].T, nc, self.boxsize, self.ucb) - x0 * nc * nc
        counts = torch.bincount(col, minlength=npl * nc * nc)
        return floats, ints, order, col, self._agree(int(counts.max()) if col.numel() else 0)

    def _layout_planes(self, floats, ints, order, col):
        """This rank's (K, C_r) layout of its particles, in the one-device
        order within each column (key, then ``order``); checks that the
        ranks kept every particle."""
        NR, C_r = self.NR, self._planes[1] * self.nc**2
        perm = torch.argsort(order)
        floats, ints, col = floats[perm], ints[perm], col[perm]
        key = col * NR + (NR - 1 - ints[:, 1].to(torch.int64))
        state, kept = _column_layout(key, [*floats.T, ints[:, 0]], NR, C_r,
                                     self.capacity, key.shape[0])
        kept = self._agree(kept, torch.distributed.ReduceOp.SUM)
        if kept != self.N:
            raise RuntimeError(f"the ranks' layouts kept {kept} of {self.N} particles")
        return state

    def _init_state_ranks(self, pos, mom, ids, rungs):
        lo = self.dist.split(self.N)[0]
        order = torch.arange(lo, lo + pos[0].shape[0], dtype=torch.int64,
                             device=pos[0].device)
        floats = torch.stack([*pos, *mom], dim=1)
        ints = torch.stack([ids.to(torch.int32), rungs.to(torch.int32)], dim=1)
        floats, ints, order, col, max_count = self._to_planes(floats, ints, order)
        self.capacity = max(self.capacity, _pad8(max_count, 1 << 30))
        self._K_occ = _pad16(int(max_count * 1.12), self.capacity)
        state = self._layout_planes(floats, ints, order, col)
        self._drift_used = 0.0
        self._set_extents(state)
        return state

    def _substep(self, state, int_drift, kick, K_r, **kw):
        dtype = state.pos.dtype
        return rung_substep(
            state, self.mass, self.G, int_drift,
            torch.as_tensor(kick, dtype=dtype, device=state.pos.device),
            self.boxsize, self.nc, self.scale, self.cutoff, self.softening,
            K_r=K_r, softening_kernel=self.softening_kernel, NR=self.NR,
            eps_rung=self.eps_rung, fac_rung=self.fac_rung,
            offsets=self.offsets, dist=self.dist, sext_halo=self._sext_halo, **kw)

    def assign_initial_rungs(self, state: RungState, dt_base: float):
        """Probe sweep (no drift, no kick) → initial rungs + K_act."""
        K_occ = self._K_occ if self._K_occ is not None else state.valid.shape[0]
        state, (K_act, _tight, _) = self._substep(
            state, 0.0, np.zeros(self.NR), K_occ, K_s=K_occ, assign=True,
            dt_base=dt_base, rext=self._ext_occ, sext=self._ext_occ)
        # the layout order is stale w.r.t. the new rungs: re-sort now
        state = self.rebucket(state)
        self._K_act = K_act.cpu().numpy()
        return state

    # -------------------------------------------------------------- #
    def base_step(self, state: RungState, t: float, dt: float, t_mom: float):
        """One base step [t, t+dt]; t_mom = the momenta's sync point for
        the straddling PM kick.  Returns (state, vmax)."""
        bg = self.bg
        K = state.valid.shape[0]
        K_act = self._K_act
        K_occ = self._K_occ if self._K_occ is not None else K
        # the substep schedule is every rank's: the highest rung of all
        K_all = self._agree(K_act)
        max_rung = int(np.max(np.nonzero(K_all)[0])) if np.any(K_all) else 0
        self.stats["max_rung"] = max(self.stats["max_rung"], max_rung)
        self.stats["base_steps"] += 1
        n_sub = 1 << max_rung
        edges = np.linspace(t, t + dt, n_sub + 1)
        delta = dt / n_sub
        vmax2 = 0.0
        for i in range(n_sub + 1):
            fired = [k for k in range(max_rung + 1)
                     if i % (1 << (max_rung - k)) == 0]
            kmin = min(fired)
            kick = np.zeros((self.NR,), np.float64)
            for k in fired:
                half = 0.5 * (1 << (max_rung - k)) * delta
                lo = max(t, edges[i] - half)
                hi = min(t + dt, edges[i] + half)
                kick[k] = bg.integrals_np(lo, hi, keys=("a**(-1)",))["a**(-1)"]
            int_drift = 0.0 if i == 0 else bg.integrals_np(
                edges[i - 1], edges[i], keys=("a**(-2)",))["a**(-2)"]
            last = i == n_sub
            first = i == 0
            use_cache = first and self._acc_cache is not None
            K_r = (K_occ if (last or first)
                   else _quantize_K(int(K_act[kmin]), K_occ))
            self.stats["substeps"] += 1
            self.stats["receiver_rows"] += 0 if use_cache else K_r
            self.stats["full_rows"] += K_occ
            out = self._substep(
                state, int_drift, kick, K_r, assign=last, dt_base=dt,
                acc_cache=self._acc_cache if use_cache else None,
                return_acc=last, sentinel_out=not (first or last),
                K_s=K_occ, skip_drift=first,
                # boundaries sweep to the local occupancy extent,
                # interiors to the local rung-≥kmin extent
                rext=(self._ext_occ if (last or first)
                      else None if self._ext_rung is None
                      else self._ext_rung[kmin]),
                sext=self._ext_occ)
            if last:
                state, (K_act_new, tight_new, v2), acc = out
                K_act_np = K_act_new.cpu().numpy()
                tight_np = tight_new.cpu().numpy()
                if self._rung_waste(K_act_np, tight_np) > 0.25 * K:
                    # fresh rungs left the row bounds stale: restore the
                    # rung-major order within columns
                    state, acc = resort_rungs_within_columns(state, acc, NR=self.NR)
                    self._K_act = tight_np
                else:
                    self._K_act = K_act_np
                # reused at the next base step's boundary 0
                self._acc_cache = acc
                if self.dist is not None:
                    torch.distributed.all_reduce(v2, op=torch.distributed.ReduceOp.MAX,
                                                 group=self.dist.group)
                vmax2 = float(v2)
            else:
                state = out[0]
            if first:
                # cache consumed (or absent): free it, then the PM kick
                self._acc_cache = None
                int_pm = bg.integrals_np(t_mom, t + 0.5 * dt,
                                         keys=("a**(-1)",))["a**(-1)"]
                state, n_over, mass_sum = self._pm_kick(state, int_pm, K_occ)
                self._record_pm_mass(float(mass_sum), state.pos.dtype)
                if self.unified:
                    self._check_pm_mass(float(mass_sum))
                else:
                    self._check_pm_overflow(n_over)
        vmax = math.sqrt(vmax2)
        # fresh rungs (and a possible resort) moved the per-column extents
        self._ext_rung = _column_rung_ext(state.rungs, state.valid, self.NR)
        # margin budget over the whole base step
        int_a2 = bg.integrals_np(t, t + dt, keys=("a**(-2)",))["a**(-2)"]
        self._drift_used += vmax / self.mass * float(int_a2)
        return state, vmax

    def _pm_kick(self, state: RungState, int_pm: float, k_rows=None):
        # the cells' gather takes per-column extents (the sweep's bounds
        # may also be per pencil)
        ext = self._ext_occ
        if ext is not None and ext.shape[-1] != state.valid.shape[1]:
            ext = None
        return pm_kick_rungs(state, self.mass, self.G, int_pm, self.boxsize,
                             self.mesh, self.scale, k_pm=self.k_pm,
                             pm_max_overflow=self.pm_max_overflow,
                             cells_cb=self.ucb, k_rows=k_rows, lean=self.pm_lean,
                             ext=ext, dist=self.dist)

    def _record_pm_mass(self, mass_sum: float, dtype: torch.dtype):
        """Records the deposit's deficit in masses of a particle as the
        deposit holds it (rounded to ``dtype``: in float32 the rounding
        alone can shift the total of 256³ particles by up to one
        particle's mass)."""
        m = float(torch.tensor(self.mass, dtype=dtype))
        self.stats["pm_mass_deficit_max"] = max(
            self.stats["pm_mass_deficit_max"], abs(mass_sum / m - self.N))

    def _check_pm_mass(self, mass_sum: float):
        """The unified layouts: every valid slot must deposit; a deficit
        means a particle drifted outside its column's deposit halo (the
        margin budget should prevent it): warn and force a rebucket."""
        expect = self.N * self.mass
        if not abs(mass_sum - expect) <= 1e-3 * abs(expect):
            warn(f"PM deposit mass {mass_sum:.6e} != expected {expect:.6e}"
                 f" — particles drifted outside the deposit halo; "
                 f"forcing rebucketize")
            self.stats["pm_mass_warnings"] = self.stats.get("pm_mass_warnings", 0) + 1
            self._drift_used = float("inf")

    def _check_pm_overflow(self, n_pm_over: int):
        """The tight layout: the particles beyond the PM block capacity
        are exact up to the budget; past it the deposit was truncated:
        warn, count it, and grow the budget (also when more than half of
        it was used)."""
        if n_pm_over > self.pm_max_overflow:
            warn(f"PM deposit-block overflow {n_pm_over} exceeded the budget "
                 f"{self.pm_max_overflow}: deposit mass truncated; growing the "
                 f"budget")
            self.stats["budget_warnings"] += 1
            self.pm_max_overflow = 2 * n_pm_over + 1024
        elif n_pm_over > self.pm_max_overflow // 2:
            self.pm_max_overflow = 2 * n_pm_over + 1024

    @staticmethod
    def _rung_waste(K_act: np.ndarray, tight: np.ndarray) -> float:
        """Next base step's EXTRA substep receiver rows under the stale
        layout row bounds vs the tight (post-sort) bounds: rung k is the
        lowest fired rung at 2^(k−1) interior boundaries."""
        K = int(K_act.max()) if K_act is not None else 0
        nz = np.nonzero(tight)[0]
        m = int(nz.max()) if nz.size else 0
        if m == 0 or K == 0:
            return 0.0
        w_bound = w_tight = 0.0
        for k in range(1, m + 1):
            n_fired = 1 << (k - 1)
            w_bound += n_fired * _quantize_K(int(K_act[k]), K)
            w_tight += n_fired * _quantize_K(int(tight[k]), K)
        return w_bound - w_tight

    @property
    def needs_rebucket(self) -> bool:
        return self._drift_used > 0.45 * self.margin

    def rebucket(self, state: RungState) -> RungState:
        if self.dist is not None:
            return self._rebucket_ranks(state)
        max_count, K_act = occupancy_and_activity(state, self.boxsize, self.nc,
                                                  self.NR, self.ucb)
        need = max(8, ((max_count + 7) // 8) * 8)
        if need > 0.87 * self.capacity:
            self.capacity = max(8, int(math.ceil(1.3 * need / 8)) * 8)
        new_state, kept = rebucketize_rungs(state, self.boxsize, self.nc,
                                            self.capacity, self.N, self.NR,
                                            self.ucb)
        if kept != self.N:
            raise RuntimeError(f"rebucketize kept {kept} of {self.N} particles")
        self._K_act = K_act.cpu().numpy()
        # ratchet with 12 % headroom, never shrinking (as the JAX package,
        # so both sweep the same rows)
        if self._K_occ is None or max_count > self._K_occ:
            self._K_occ = _pad16(int(max_count * 1.12), self.capacity)
        self._K_occ = min(self._K_occ, self.capacity)
        self._set_extents(new_state)
        self._acc_cache = None  # layout permuted
        self._drift_used = 0.0
        return new_state

    def _rebucket_ranks(self, state: RungState) -> RungState:
        """The rebucket over ranks: every valid slot goes to the rank of
        its new plane with its place in the whole layout (row·C + global
        column, the one-device stepper's sort order for equal keys); the
        capacity and K_occ follow the largest column count of all ranks,
        K_act is this rank's."""
        K, C_r = state.valid.shape
        nc = self.nc
        src = torch.nonzero(state.valid.reshape(-1)).reshape(-1)
        order = (torch.div(src, C_r, rounding_mode="floor") * nc**3
                 + self._planes[0] * nc * nc + src % C_r)
        floats = torch.cat([state.pos.reshape(3, -1)[:, src],
                            state.mom.reshape(3, -1)[:, src]]).T
        ints = torch.stack([state.ids.reshape(-1)[src].to(torch.int32),
                            state.rungs.reshape(-1)[src].to(torch.int32)], dim=1)
        floats, ints, order, col, max_count = self._to_planes(floats, ints, order)
        need = max(8, ((max_count + 7) // 8) * 8)
        if need > 0.87 * self.capacity:
            self.capacity = max(8, int(math.ceil(1.3 * need / 8)) * 8)
        new_state = self._layout_planes(floats, ints, order, col)
        # the rung-major layout's K_act: the deepest column's count of rung ≥ k
        self._K_act = _rung_tight(new_state.rungs, new_state.valid, self.NR).cpu().numpy()
        if self._K_occ is None or max_count > self._K_occ:
            self._K_occ = _pad16(int(max_count * 1.12), self.capacity)
        self._K_occ = min(self._K_occ, self.capacity)
        self._set_extents(new_state)
        self._acc_cache = None
        self._drift_used = 0.0
        return new_state

    # -------------------------------------------------------------- #
    def _timestep(self, a: float, vmax: float) -> float:
        from concept_tpu_torch.sim import (
            DELTA_A_MAX_EARLY, DELTA_A_MAX_LATE, FAC_DYNAMICAL, FAC_HUBBLE,
            FAC_P3M,
        )

        H = float(self.bg.hubble_np(a))
        rho = self.mass * self.N / self.boxsize**3 / a**3
        limits = [FAC_DYNAMICAL / math.sqrt(self.G * rho)]
        if H > 0:
            limits.append(FAC_HUBBLE / H)
            da = DELTA_A_MAX_EARLY if a < 0.1 else DELTA_A_MAX_LATE
            limits.append(da / (a * H))
        if vmax > 0:
            # rung-0 particles kick at the base cadence: the split-scale
            # displacement bound applies to the base Δt
            limits.append(FAC_P3M * self.scale / (vmax / a))
        return min(limits)

    def close_pm_kick(self, state: RungState, t_mom: float, t1: float):
        """The trailing PM half kick from t_mom to t1 (short-range momenta
        are synchronised at t1 by the final full substep)."""
        if t_mom < t1 - 1e-12 * abs(t1):
            int_pm = self.bg.integrals_np(t_mom, t1, keys=("a**(-1)",))["a**(-1)"]
            state = self._pm_kick(state, int_pm)[0]
        return state

    def evolve(self, state: RungState, t0: float, t1: float,
               max_steps: int = 100000, static_dt=None, steps: int = 0,
               t_mom: float | None = None, v_max: float | None = None,
               callback=None):
        """Base steps from t0 to t1, then the trailing PM half kick that
        synchronises the momenta at t1.  ``static_dt``
        (timestep.prepare_static_timestepping) caps Δt; ``steps`` carries
        the step count of earlier calls.  A state saved after a base step
        resumes with that step's ``t_mom`` (its PM sync point; the
        short-range momenta sit at t0) and ``v_max`` (the peculiar speed
        that bounds the next Δt); by default the momenta are synchronised
        at t0 and the first Δt takes no speed bound.  ``callback(layout,
        t, a, steps)`` runs after every base step.  Records the step
        count, Δt, the kick sync point and v_max in ``self.hysteresis``;
        after the closing kick t_mom is t1 and v_max None, as a segment
        that starts there expects."""
        bg = self.bg
        t = t0
        t_mom = t0 if t_mom is None else t_mom
        v = 0.0 if v_max is None else v_max
        if self._K_act is None:
            state = self.assign_initial_rungs(
                state, self._timestep(float(bg.a_of_t_np(t0)), v))
        while t < t1 - 1e-12 * abs(t1):
            a = float(bg.a_of_t_np(t))
            dt = min(self._timestep(a, v), t1 - t)
            if static_dt is not None and static_dt.applies:
                da = static_dt.delta_a(a)
                if a + da <= 1.0:
                    dt = min(float(bg.t_of_a_np(a + da)) - t, t1 - t)
            state, mom_max = self.base_step(state, t, dt, t_mom)
            steps += 1
            if self.needs_rebucket or steps % self.rebucket_every_max == 0:
                state = self.rebucket(state)
            t_mom = min(t + 0.5 * dt, t1)
            t += dt
            a = float(bg.a_of_t_np(t))
            v = mom_max / (a * self.mass)
            self.hysteresis = {"dt": dt, "dt_min": 0.0, "step_count": steps,
                               "step_last_sync": steps, "t_mom": t_mom, "v_max": v}
            if callback is not None:
                callback(state, t, a, steps)
            if steps >= max_steps:
                raise RuntimeError("max_steps exceeded")
        state = self.close_pm_kick(state, t_mom, t1)
        self.hysteresis.update(t_mom=t1, v_max=None)
        return state


def extract_flat(state: RungState, n_total: int):
    """RungState → flat (pos (N, 3), mom (N, 3), ids (N,)) in slot order."""
    M = state.valid.numel()
    src = torch.nonzero(state.valid.reshape(M)).reshape(-1)[:n_total]
    pos = state.pos.reshape(3, M)[:, src].T
    mom = state.mom.reshape(3, M)[:, src].T
    return pos, mom, state.ids.reshape(M)[src]


class RungSimulationAdapter:
    """Simulation-style facade over P3MRungSimulation for run() and the
    CLI: .spec, .config, .bg, .lin, initial_state(), evolve(state, a0,
    a1) over flat ParticleStates.  The (K, C) layout is cached between
    evolve() calls (keyed on the ParticleState this adapter returned),
    so consecutive dump segments skip the flat → layout bucketize.

    ``dist`` (``-n N``, as the JAX package's ``dist``) steps over the
    ranks (see the module docstring).  The flat states are then each
    rank's index shard, as ``sim.Simulation``'s over ranks: the shard of
    the state in id order (``shard``, ``whole`` and ``reduce`` as there),
    split by ``GridDistribution.split`` where N does not divide by d."""

    def __init__(self, spec, config, bg, lin=None, N_rungs: int = 8,
                 fac_rung: float = 1.0, dist=None):
        self.spec = spec
        self.config = config
        self.bg = bg
        self.lin = lin
        self.dist = check_distribution(dist)
        n_part = round(spec.N ** (1 / 3))
        self.inner = P3MRungSimulation(
            n_part, config.boxsize, spec.mass, config.G,
            mesh=config.potential_gridsize, bg=bg, N_rungs=N_rungs,
            softening=config.softening,
            softening_kernel=config.softening_kernel, fac_rung=fac_rung,
            n_total=spec.N if n_part**3 != spec.N else None,
            device=config.device, dist=dist,
        )
        self._cached_flat = None
        self._cached_layout = None

    def initial_state(self, a_begin: float, seed: int = 0, lpt_order: int = 1,
                      with_ids: bool = True, **kw):
        """The realized state (parallel/step.realize_shard): over the
        ranks each realizes its slab of the lattice and hands its
        particles to the ranks whose shards (``GridDistribution.split``)
        hold their ids."""
        from concept_tpu_torch.parallel.step import realize_shard

        return realize_shard(self.lin, self.spec, self.config.boxsize, a_begin, self.dist,
                             with_ids=with_ids, seed=seed, lpt_order=lpt_order,
                             dtype=self.config.dtype, device=self.config.device, **kw)

    def shard(self, state):
        """This rank's index shard of a whole flat state (the state itself
        on one device): a snapshot's or an autosave's, which every rank
        reads whole."""
        from concept_tpu_torch.components import ParticleState

        if self.dist is None:
            return state
        lo, hi = self.dist.split(state.pos.shape[0])
        return ParticleState(*(None if x is None else x[lo:hi].contiguous() for x in state))

    def whole(self, state, root: int | None = None):
        """The whole flat state from the ranks' shards, on every rank, or
        with ``root`` on that rank alone (the others get no rows)."""
        from concept_tpu_torch.components import ParticleState
        from concept_tpu_torch.parallel.step import gather_rows, rows_to_root

        if self.dist is None:
            return state
        if root is not None:
            return rows_to_root(state, self.dist, root)
        present = [x for x in state if x is not None]
        got = iter(gather_rows(present, self.dist))
        return ParticleState(*(None if x is None else next(got) for x in state))

    def reduce(self, x: torch.Tensor, op=torch.distributed.ReduceOp.SUM) -> torch.Tensor:
        """x reduced over the ranks (x itself on one device)."""
        from concept_tpu_torch.parallel.step import reduce

        return reduce(x, self.dist, op)

    def _to_layout(self, state) -> RungState:
        """The layout of a flat state (over ranks, of the ranks' shards):
        bucketized with its carried rungs, if any, and then re-sorted
        rung-major by a rebucket."""
        if state is self._cached_flat and self._cached_layout is not None:
            return self._cached_layout
        ids = None if state.ids is None else state.ids.to(torch.int32)
        if ids is None and self.dist is None:
            ids = torch.arange(state.pos.shape[0], dtype=torch.int32,
                               device=state.pos.device)
        st = self.inner.init_state(tuple(state.pos[:, d] for d in range(3)),
                                   tuple(state.mom[:, d] for d in range(3)),
                                   ids=ids, rungs=state.rungs)
        if state.rungs is not None:
            st = self.inner.rebucket(st)
        return st

    def _to_flat(self, layout: RungState):
        """The flat state of a layout in id order, with its rungs; over
        ranks each live slot goes to the rank whose index shard holds its
        id (parallel/step.to_index_shard), which places it by id."""
        from concept_tpu_torch.components import ParticleState
        from concept_tpu_torch.parallel.step import to_index_shard

        M = layout.valid.numel()
        src = torch.nonzero(layout.valid.reshape(M)).reshape(-1)[:self.spec.N]
        pos, mom = layout.pos.reshape(3, M)[:, src].T, layout.mom.reshape(3, M)[:, src].T
        ids, rungs = layout.ids.reshape(M)[src], layout.rungs.reshape(M)[src]
        if self.dist is not None:
            (pos, mom, rungs), own = to_index_shard([pos, mom, rungs], ids, self.spec.N,
                                                    self.dist)
            return ParticleState(pos=pos, mom=mom, ids=own.to(ids.dtype), rungs=rungs)
        order = torch.argsort(ids)
        return ParticleState(pos=pos[order], mom=mom[order], ids=ids[order],
                             rungs=rungs[order])

    @property
    def hysteresis(self) -> dict:
        return self.inner.hysteresis

    def evolve(self, state, a_begin: float, a_end: float,
               max_steps: int = 100000, static_dt=None, resume=None,
               callback=None):
        """Evolve the flat state from a_begin to a_end.  ``resume`` (the
        ``hysteresis`` of the previous segment, or of an autosave)
        carries the step count, the state's kick sync point t_mom and,
        from a mid-segment autosave, v_max.  A finished segment's
        hysteresis holds t_mom = a_end's t, where its closing kick left
        the momenta (the JAX package's adapter keeps the last step's
        t_mom there and so kicks [t_mom, t1] twice across a dump; ROADMAP
        Queue 3).  ``callback(flat_state, t, a, steps)`` runs after every
        base step; ``flat_state()`` extracts the flat ParticleState (a
        compaction pass), so a callback calls it only when it needs the
        state."""
        bg = self.bg
        resume = resume or {}
        t1 = float(bg.t_of_a_np(a_end))
        inner_cb = None
        if callback is not None:
            def inner_cb(layout, t, a, steps):
                callback(lambda: self._to_flat(layout), t, a, steps)
        layout = self.inner.evolve(
            self._to_layout(state), float(bg.t_of_a_np(a_begin)), t1,
            max_steps=max_steps, static_dt=static_dt,
            steps=int(resume.get("step_count", 0)), t_mom=resume.get("t_mom"),
            v_max=resume.get("v_max"), callback=inner_cb)
        flat = self._to_flat(layout)
        self._cached_flat = flat
        self._cached_layout = layout
        return flat, float(bg.a_of_t_np(t1))
