"""Adaptive per-particle rungs on the persistent P³M cell layout — the
production rung stepper (port of concept_tpu/p3mrungs.py, the unified
layout with cells 8 mesh cells wide).

The particle state lives in slot-major (K, C) arrays over cells exactly
8 mesh cells wide (C = (mesh/8)³, ids x-major, z-fastest), kept
RUNG-MAJOR within every cell column: the bucketize key is
cell·NR + (NR−1−rung), so the slots with rung ≥ k form a prefix of each
column.  A substep that kicks rungs ≥ kmin sweeps only the leading
K_act[kmin] rows as receivers against all slots as suppliers, so its
cost follows the active population (the reference's rung economics,
interactions.py:1353-1984).  The PM long range kicks at the base
cadence, deposited and gathered straight on the slot arrays
(p3msim.pm_gradient_cells).

Kick staggering: rung k (span s_k substeps) kicks at every boundary i
with i mod s_k == 0 over the STRADDLING integral
[edge_i − s_k·δ/2, edge_i + s_k·δ/2] clamped to the base step: the
centred leapfrog per rung, all momenta synchronised at every base-step
boundary (reference main.py:1347-1443).  The end-of-step full sweep
reassigns the rungs and is reused as the next step's boundary-0
acceleration.

Every integer result (slot order, valid, rungs, K_act, tight, _K_occ)
equals the JAX package's: its sorts are stable ``torch.sort`` on the same
composite keys.  The tight layout and the 4-mesh-cell (reach-2) layout
wait for later slices.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from concept_tpu_torch.components import periodic_wrap
from concept_tpu_torch.forces.cuda_shortrange import pair_sweep
from concept_tpu_torch.forces.shortrange import SENTINEL, f32_square
from concept_tpu_torch.p3msim import pm_gradient_cells
from concept_tpu_torch.utils.terminal import warn

FAC_SOFTENING = 0.025  # reference main.py:2433 Δt_rung_factor base
UCB = 8  # cell width in mesh cells
LAYOUT_ITEM = "ROADMAP Queue 1 item 2: tight and 4-mesh-cell rung layouts"


class RungState(NamedTuple):
    pos: torch.Tensor    # (3, K, C) slot-major positions (rung-major in-column)
    mom: torch.Tensor    # (3, K, C)
    valid: torch.Tensor  # (K, C) bool
    rungs: torch.Tensor  # (K, C) int8 (0 in empty slots)
    ids: torch.Tensor    # (K, C) int32 original particle index (-1 empty)


def _cell_index(comp, nc: int, boxsize: float):
    """Per-dimension cell coordinate from the MESH index
    floor(p·mesh/boxsize)//8, the arithmetic of the deposit geometry, so a
    particle provably lands inside its column's deposit halo."""
    inv_h = (nc * UCB) / boxsize
    m = torch.floor(comp * inv_h).to(torch.int64)
    return torch.clamp(torch.div(m, UCB, rounding_mode="floor"), 0, nc - 1)


def _cell_of(pos, nc: int, boxsize: float):
    cell = torch.zeros_like(pos[0], dtype=torch.int64)
    for comp in pos:
        cell = cell * nc + _cell_index(comp, nc, boxsize)
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
                    capacity: int, NR: int):
    """Flat component arrays (3-tuples of (N,)) → (RungState, n_kept)."""
    C = nc**3
    cell = _cell_of(pos, nc, boxsize)
    key = cell * NR + (NR - 1 - rungs0.to(torch.int64))
    return _column_layout(key, [*pos, *mom, ids0], NR, C, capacity, key.shape[0])


def rebucketize_rungs(state: RungState, boxsize: float, nc: int,
                      capacity: int, n_total: int, NR: int):
    """Re-bucketize the slot arrays at the current positions, carrying
    rungs and ids.  Returns (RungState, n_kept)."""
    M = state.valid.numel()
    C = nc**3
    validf = state.valid.reshape(M)
    flat = state.pos.reshape(3, M)
    mflat = state.mom.reshape(3, M)
    cell = _cell_of(flat, nc, boxsize)
    rungM = state.rungs.reshape(M).to(torch.int64)
    key = torch.where(validf, cell * NR + (NR - 1 - rungM), C * NR)
    return _column_layout(key, [*flat, *mflat, state.ids.reshape(M)],
                          NR, C, capacity, n_total)


def occupancy_and_activity(state: RungState, boxsize: float, nc: int, NR: int):
    """(max per-cell occupancy at the CURRENT positions, K_act (NR,)):
    the sizing probe before a rebucketize, and the active-prefix row
    counts the re-sorted layout will have."""
    M = state.valid.numel()
    C = nc**3
    validf = state.valid.reshape(M)
    cell = _cell_of(state.pos.reshape(3, M), nc, boxsize)[validf]
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


def _pencil_occ_ext(valid, nc: int):
    """Per-pencil occupancy extents (nc²,) int32 (valid slots are a
    column prefix between rebuckets)."""
    counts = valid.sum(dim=0, dtype=torch.int32)
    return counts.reshape(nc * nc, nc).max(dim=1).values.contiguous()


def _pencil_rung_ext(rungs, valid, nc: int, NR: int):
    """(NR, nc²) int32: per pencil, 1 + the highest row holding a valid
    slot with rung ≥ k (LAYOUT extents)."""
    K = valid.shape[0]
    rows1 = torch.arange(1, K + 1, dtype=torch.int32, device=valid.device)[:, None]
    outs = []
    for k in range(NR):
        ext = torch.where((rungs >= k) & valid, rows1, 0).max(dim=0).values
        outs.append(ext.reshape(nc * nc, nc).max(dim=1).values)
    return torch.stack(outs).contiguous()


def rung_substep(state: RungState, mass: float, G: float, int_drift: float,
                 kick_ints, boxsize: float, nc: int, scale: float,
                 cutoff: float, softening: float, K_r: int,
                 softening_kernel: str = "plummer", NR: int = 8,
                 assign: bool = False, dt_base: float = 1.0,
                 eps_rung: float = 1.0, fac_rung: float = FAC_SOFTENING,
                 acc_cache=None, return_acc: bool = False,
                 sentinel_out: bool = False, K_s: int | None = None,
                 skip_drift: bool = False, rext=None, sext=None):
    """One rung boundary: drift all slots by int_drift (ᔑa⁻² over the
    sub-interval ending here), then kick each fired rung by its
    straddling integral kick_ints[rung] ((NR,) tensor).

    The short-range acceleration covers the leading K_r rows; with
    acc_cache (positions unchanged since it was computed) no sweep runs.
    assign=True (the last boundary) reassigns rungs from the fresh
    acceleration.  K_s bounds the supplier rows.  sentinel_out=True
    (interior substeps) fills invalid slots with the sweep sentinel
    instead of 0.  Returns (state, (K_act, tight, vmax2)[, acc]); the
    momenta are updated in place (the JAX package donates them)."""
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
        # one shared sentinel array: receivers and suppliers are row slices
        pos_s = pos if sentinel_out else torch.where(state.valid[None], pos, big)
        acc = pair_sweep(pos_s[:, :K_r], pos_s[:, :K_s], nc, boxsize, scale,
                         f32_square(cutoff), f32_square(softening),
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
                  boxsize: float, mesh: int, scale: float,
                  k_rows: int | None = None):
    """Base-cadence PM long-range kick on the cell layout, over the
    leading k_rows rows (rows beyond the max occupancy are invalid in
    every column).  Updates the momenta in place (the JAX package donates
    them).  Returns (state, mass_sum)."""
    K = state.valid.shape[0]
    kr = K if k_rows is None else min(k_rows, K)
    fd3, mass_sum = pm_gradient_cells(state.pos[:, :kr], state.valid[:kr],
                                      mass, G, scale, boxsize, mesh, cb=UCB)
    state.mom[:, :kr].add_(fd3, alpha=-mass * int_pm)
    state.mom.masked_fill_(~state.valid[None], 0.0)
    return state, mass_sum


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
    """

    def __init__(self, n_part: int, boxsize: float, mass: float, G: float,
                 mesh: int | None = None, bg=None, N_rungs: int = 8,
                 capacity: int | None = None, softening: float = 0.0,
                 softening_kernel: str = "plummer", fac_rung: float = 1.0,
                 rebucket_every_max: int = 64, n_total: int | None = None):
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
        if self.mesh % UCB or self.mesh // UCB < 3:
            raise ValueError(
                f"mesh {self.mesh}: the 8-mesh-cell layout needs mesh % 8 == 0"
                f" and mesh ≥ 24 ({LAYOUT_ITEM})")
        mesh_h = boxsize / self.mesh
        self.nc = self.mesh // UCB
        self.cell_width = UCB * mesh_h
        # plain ±1 sweep: pair margin = cell − cutoff; the deposit halo
        # allows ±0.5 mesh cells
        self.margin = 2.0 * min(0.5 * mesh_h, 0.5 * (self.cell_width - self.cutoff))
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
        # per-pencil layout extents for the bounded sweep: _ext_occ (nc²,)
        # per rebucket, _ext_rung (NR, nc²) per assign
        self._ext_occ = None
        self._ext_rung = None
        self._acc_cache = None  # (3, K_occ, C) SR acc at current positions
        # pm_mass_deficit_max: the largest |deposited − N·m| of the run,
        # in particle masses
        self.stats = {"substeps": 0, "receiver_rows": 0, "full_rows": 0,
                      "max_rung": 0, "base_steps": 0, "pm_mass_deficit_max": 0.0}
        self.hysteresis = {}  # step count, Δt, kick sync point (evolve)

    # -------------------------------------------------------------- #
    def init_state(self, pos, mom, ids=None):
        """pos/mom: 3-tuples of (N,) tensors.  Sizes the capacity from the
        measured max cell occupancy and bucketizes with rung 0."""
        N = pos[0].shape[0]
        dev = pos[0].device
        if ids is None:
            ids = torch.arange(N, dtype=torch.int32, device=dev)
        rungs = torch.zeros((N,), dtype=torch.int8, device=dev)
        counts = torch.bincount(_cell_of(pos, self.nc, self.boxsize),
                                minlength=self.nc**3)
        max_count = int(counts.max())
        self.capacity = max(self.capacity, _pad8(max_count, 1 << 30))
        # rows ≥ K_occ are invalid in every column until the next
        # rebucket; 12 % headroom and a ratchet (see rebucket)
        self._K_occ = _pad16(int(max_count * 1.12), self.capacity)
        state, kept = bucketize_rungs(pos, mom, rungs, ids, self.boxsize,
                                      self.nc, self.capacity, self.NR)
        if kept != N:
            raise RuntimeError(f"bucketize kept {kept} of {N} particles")
        self._drift_used = 0.0
        self._ext_occ = _pencil_occ_ext(state.valid, self.nc)
        self._ext_rung = _pencil_rung_ext(state.rungs, state.valid, self.nc, self.NR)
        return state

    def _substep(self, state, int_drift, kick, K_r, **kw):
        dtype = state.pos.dtype
        return rung_substep(
            state, self.mass, self.G, int_drift,
            torch.as_tensor(kick, dtype=dtype, device=state.pos.device),
            self.boxsize, self.nc, self.scale, self.cutoff, self.softening,
            K_r=K_r, softening_kernel=self.softening_kernel, NR=self.NR,
            eps_rung=self.eps_rung, fac_rung=self.fac_rung, **kw)

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
        max_rung = int(np.max(np.nonzero(K_act)[0])) if np.any(K_act) else 0
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
                vmax2 = float(v2)
            else:
                state = out[0]
            if first:
                # cache consumed (or absent): free it, then the PM kick
                self._acc_cache = None
                int_pm = bg.integrals_np(t_mom, t + 0.5 * dt,
                                         keys=("a**(-1)",))["a**(-1)"]
                state, mass_sum = pm_kick_rungs(
                    state, self.mass, self.G, int_pm, self.boxsize, self.mesh,
                    self.scale, k_rows=K_occ)
                self._check_pm_mass(float(mass_sum), state.pos.dtype)
        vmax = math.sqrt(vmax2)
        # fresh rungs (and a possible resort) moved the per-pencil extents
        self._ext_rung = _pencil_rung_ext(state.rungs, state.valid, self.nc, self.NR)
        # margin budget over the whole base step
        int_a2 = bg.integrals_np(t, t + dt, keys=("a**(-2)",))["a**(-2)"]
        self._drift_used += vmax / self.mass * float(int_a2)
        return state, vmax

    def _check_pm_mass(self, mass_sum: float, dtype: torch.dtype):
        """Every valid slot must deposit; a deficit means a particle
        drifted outside its column's deposit halo (the margin budget
        should prevent it): warn and force a rebucket.  Records the
        deficit in masses of a particle as the deposit holds it (rounded
        to ``dtype``: in float32 the rounding alone can shift the total of
        256³ particles by up to one particle's mass)."""
        expect = self.N * self.mass
        m = float(torch.tensor(self.mass, dtype=dtype))
        self.stats["pm_mass_deficit_max"] = max(
            self.stats["pm_mass_deficit_max"], abs(mass_sum / m - self.N))
        if not abs(mass_sum - expect) <= 1e-3 * abs(expect):
            warn(f"PM deposit mass {mass_sum:.6e} != expected {expect:.6e}"
                 f" — particles drifted outside the deposit halo; "
                 f"forcing rebucketize")
            self.stats["pm_mass_warnings"] = self.stats.get("pm_mass_warnings", 0) + 1
            self._drift_used = float("inf")

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
        max_count, K_act = occupancy_and_activity(state, self.boxsize, self.nc,
                                                  self.NR)
        need = max(8, ((max_count + 7) // 8) * 8)
        if need > 0.87 * self.capacity:
            self.capacity = max(8, int(math.ceil(1.3 * need / 8)) * 8)
        new_state, kept = rebucketize_rungs(state, self.boxsize, self.nc,
                                            self.capacity, self.N, self.NR)
        if kept != self.N:
            raise RuntimeError(f"rebucketize kept {kept} of {self.N} particles")
        self._K_act = K_act.cpu().numpy()
        # ratchet with 12 % headroom, never shrinking (as the JAX package,
        # so both sweep the same rows)
        if self._K_occ is None or max_count > self._K_occ:
            self._K_occ = _pad16(int(max_count * 1.12), self.capacity)
        self._K_occ = min(self._K_occ, self.capacity)
        self._ext_occ = _pencil_occ_ext(new_state.valid, self.nc)
        self._ext_rung = _pencil_rung_ext(new_state.rungs, new_state.valid,
                                          self.nc, self.NR)
        self._acc_cache = None  # layout permuted
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
            state, _ = pm_kick_rungs(state, self.mass, self.G, int_pm,
                                     self.boxsize, self.mesh, self.scale)
        return state

    def evolve(self, state: RungState, t0: float, t1: float,
               max_steps: int = 100000, static_dt=None, steps: int = 0):
        """Base steps from t0 to t1 (momenta synchronised at t0), then the
        trailing PM half kick that synchronises them at t1.  ``static_dt``
        (timestep.prepare_static_timestepping) caps Δt; ``steps`` carries
        the step count of earlier calls.  Records the step count, Δt and
        kick sync point in ``self.hysteresis``."""
        bg = self.bg
        t = t_mom = t0
        vmax = 0.0
        if self._K_act is None:
            state = self.assign_initial_rungs(
                state, self._timestep(float(bg.a_of_t_np(t0)), 0.0))
        while t < t1 - 1e-12 * abs(t1):
            a = float(bg.a_of_t_np(t))
            dt = min(self._timestep(a, vmax / (a * self.mass)), t1 - t)
            if static_dt is not None and static_dt.applies:
                da = static_dt.delta_a(a)
                if a + da <= 1.0:
                    dt = min(float(bg.t_of_a_np(a + da)) - t, t1 - t)
            state, vmax = self.base_step(state, t, dt, t_mom)
            steps += 1
            if self.needs_rebucket or steps % self.rebucket_every_max == 0:
                state = self.rebucket(state)
            t_mom = min(t + 0.5 * dt, t1)
            t += dt
            self.hysteresis = {"dt": dt, "dt_min": 0.0, "step_count": steps,
                               "step_last_sync": steps, "t_mom": t_mom}
            if steps >= max_steps:
                raise RuntimeError("max_steps exceeded")
        return self.close_pm_kick(state, t_mom, t1)


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
    so consecutive dump segments skip the flat → layout bucketize."""

    def __init__(self, spec, config, bg, lin=None, N_rungs: int = 8,
                 fac_rung: float = 1.0):
        self.spec = spec
        self.config = config
        self.bg = bg
        self.lin = lin
        n_part = round(spec.N ** (1 / 3))
        self.inner = P3MRungSimulation(
            n_part, config.boxsize, spec.mass, config.G,
            mesh=config.potential_gridsize, bg=bg, N_rungs=N_rungs,
            softening=config.softening,
            softening_kernel=config.softening_kernel, fac_rung=fac_rung,
            n_total=spec.N if n_part**3 != spec.N else None,
        )
        self._cached_flat = None
        self._cached_layout = None

    def initial_state(self, a_begin: float, seed: int = 0, lpt_order: int = 1,
                      with_ids: bool = True, **kw):
        from concept_tpu_torch.ic import realize_particles

        return realize_particles(
            self.lin, self.spec, self.config.boxsize, a_begin, seed=seed,
            lpt_order=lpt_order, dtype=self.config.dtype,
            device=self.config.device, with_ids=with_ids, **kw)

    def _to_layout(self, state) -> RungState:
        if state is self._cached_flat and self._cached_layout is not None:
            return self._cached_layout
        N = state.pos.shape[0]
        dev = state.pos.device
        ids = state.ids
        if ids is None:
            ids = torch.arange(N, dtype=torch.int32, device=dev)
        st = self.inner.init_state(tuple(state.pos[:, d] for d in range(3)),
                                   tuple(state.mom[:, d] for d in range(3)),
                                   ids=ids.to(torch.int32))
        if state.rungs is not None:
            # install the carried rung populations (in id order), then
            # re-sort rung-major
            rungs_by_id = state.rungs.to(torch.int8)
            safe_ids = torch.clamp(st.ids, min=0).to(torch.int64)
            st = st._replace(rungs=torch.where(st.valid, rungs_by_id[safe_ids], 0)
                             .to(torch.int8))
            st = self.inner.rebucket(st)
        return st

    def _to_flat(self, layout: RungState):
        from concept_tpu_torch.components import ParticleState

        pos, mom, ids = extract_flat(layout, self.spec.N)
        order = torch.argsort(ids)
        M = layout.valid.numel()
        src = torch.nonzero(layout.valid.reshape(M)).reshape(-1)[:self.spec.N]
        rungs = layout.rungs.reshape(M)[src][order]
        return ParticleState(pos=pos[order], mom=mom[order], ids=ids[order],
                             rungs=rungs)

    @property
    def hysteresis(self) -> dict:
        return self.inner.hysteresis

    def evolve(self, state, a_begin: float, a_end: float,
               max_steps: int = 100000, static_dt=None, resume=None):
        """Evolve the flat state from a_begin to a_end.  ``resume`` (the
        ``hysteresis`` of the previous segment) carries the step count.
        Its kick sync point is not taken over: each segment ends with the
        momenta synchronised at its end (the JAX package's adapter takes
        it over and so kicks [t_mom, t1] twice across a dump; ROADMAP
        Queue 3)."""
        bg = self.bg
        t1 = float(bg.t_of_a_np(a_end))
        layout = self.inner.evolve(
            self._to_layout(state), float(bg.t_of_a_np(a_begin)), t1,
            max_steps=max_steps, static_dt=static_dt,
            steps=int((resume or {}).get("step_count", 0)))
        flat = self._to_flat(layout)
        self._cached_flat = flat
        self._cached_layout = layout
        return flat, float(bg.a_of_t_np(t1))
