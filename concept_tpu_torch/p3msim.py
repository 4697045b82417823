"""The persistent-layout P³M stepper and the PM long range on slot
layouts (port of concept_tpu/p3msim.py; reference interactions.py:
1353-1984 short range, 1985-2415 mesh, species.py:438-850 tiling).

``P3MSimulation`` keeps the particle state in the short-range slot-major
(3, K, C) layout over cells at least cutoff·(1 + margin) wide, across
steps: the sweep runs on the stored layout (``pair_sweep_global`` with
receivers = suppliers and the layout's occupancy extents, PERF.md row 6;
folded below 3 cells a side), the kick and
the drift apply in layout, and the host re-bucketizes before the drift
since the last rebucket can exceed the margin.  Its PM goes through the
2³-mesh-cell blocks (rows 8-9): a persistent slot → block binding
(``build_pm_binding``) serves every step until the drift nears a mesh
cell, with the particles beyond the block capacity through the plain
CIC, all of them.

The rung stepper's PM on its slot layouts is here too.  On the unified
layouts the short-range (K, C) slot layout IS the deposit layout: cells
are exactly ``cb`` mesh cells wide (8 or 4), so the CIC deposit and the
force gather run on the sweep's slot arrays (grid/cuda_cells.py, rows
3-4): ``pm_gradient_cells`` with Fourier gradients, or the memory-lean
``pm_kick_cells_lean`` with stencil gradients one at a time.  The tight
layout's cells are no multiple of the mesh: its valid slots go through
the block PM of the global stepper (forces/p3m.pm_gradient_blocks).
Over ranks (``dist``) the cells' PM deposits each rank's planes of
columns onto their mesh rows plus a halo row a side, moves those rows
onto the ranks' FFT slabs (parallel/step.add_span_rows: the planes need
not split evenly, and then differ from the slabs by up to half a cell
at each end), transforms as slabs (grid/fft.py), and gathers from each
gradient's rows brought back (step.span_rows).  The tight layout's block
PM over ranks is forces/p3m.pm_gradient_blocks(dist=...).

Invalid slots hold zeros at the module boundary, as in the JAX package;
the sweep's far sentinel is put in for the sweep call only.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import torch

from concept_tpu_torch.bucketsim import spill_slots
from concept_tpu_torch.components import periodic_wrap
from concept_tpu_torch.forces.p3m import block_layout, block_pm, pm_gradient_blocks
from concept_tpu_torch.forces.pm import gravity_potential_slab
from concept_tpu_torch.forces.shortrange import (
    SENTINEL, dtype_square, grid_key, scatter_slots, slot_layout, sweep_fold,
)
from concept_tpu_torch.grid import fourier
from concept_tpu_torch.grid.cuda_cells import deposit_cells, gather_cells
from concept_tpu_torch.grid.fft import irfft3, rfft3
from concept_tpu_torch.grid.stencil import _COEFFS, diff_grid
from concept_tpu_torch.utils.terminal import warn


class P3MState(NamedTuple):
    pos: torch.Tensor  # (3, K, C) slot-major positions (0 in empty slots)
    mom: torch.Tensor  # (3, K, C)
    valid: torch.Tensor  # (K, C) bool


def margin_cell_count(boxsize: float, cutoff: float, margin_frac: float,
                      max_cells: int = 512) -> int:
    """Cells per dimension with width ≥ cutoff·(1+margin_frac)."""
    n = int(boxsize / (cutoff * (1.0 + margin_frac)))
    return max(1, min(n, max_cells))


def _deposit_cells_mass(pos3, wv, mass: float, boxsize: float, mesh: int, cb: int,
                        dist):
    """The cells' deposit of mass·wv and its total (0-dim float64): the
    whole mesh, or over ranks this rank's slab and the ranks' total."""
    from concept_tpu_torch.parallel import step

    if dist is None:
        grid = deposit_cells(pos3, wv * mass, mesh, boxsize, cb)
        # summed in float64: a float32 total of 2²⁴ = 256³ particle masses
        # cannot resolve one particle's mass
        return grid, grid.sum(dtype=torch.float64), None, None
    nc = mesh // cb
    planes = step.rank_planes(nc, dist)
    spans = [step.plane_rows(nc, cb, dist, r) for r in range(dist.n_devices)]
    grid = step.add_span_rows(
        deposit_cells(pos3, wv * mass, mesh, boxsize, cb, planes=planes), spans, dist)
    mass_sum = grid.sum(dtype=torch.float64)
    torch.distributed.all_reduce(mass_sum, group=dist.group)
    return grid, mass_sum, planes, spans


def pm_gradient_cells(pos3, valid, mass: float, G: float, scale: float,
                      boxsize: float, mesh: int, cb: int = 8, ext=None, dist=None):
    """∂φ/∂x at every slot of the (K, C) cell layout: deposit w =
    mass·valid, FFT, φ(k) with the long-range split and CIC deconvolution
    (order 4 = deposit + gather), Fourier gradient, gather.

    Returns (fd (3, K, C), mass_sum).  Every valid slot deposits; one that
    drifted out of its cell's ±1-mesh-cell halo since the last rebucket
    is left out, and mass_sum (the deposited mass, a 0-dim tensor) then
    falls short of N·mass — the host checks it.  ``ext`` (C,) int32, the
    layout's per-column extents (1 + the highest valid row), spares the
    gather the rows past them.  ``dist``: the slots are this rank's
    planes of columns (step.rank_planes), mass_sum is the ranks'."""
    from concept_tpu_torch.parallel import step

    n = mesh
    wv = valid.to(pos3.dtype)
    grid, mass_sum, planes, spans = _deposit_cells_mass(pos3, wv, mass, boxsize, n, cb, dist)
    slab = rfft3(grid / (boxsize / n) ** 3, dist)
    del grid
    y_rows = None if dist is None else dist.slab(n)
    phi = gravity_potential_slab(slab, n, boxsize, G, deconv_order=4,
                                 longrange_scale=scale, y_rows=y_rows)
    del slab
    grads = torch.stack([irfft3(fourier.fourier_diff(phi, n, boxsize, d, y_rows), n, dist)
                         for d in range(3)])
    if dist is not None:
        grads = step.span_rows(grads, spans, dist).contiguous()
    return gather_cells(pos3, wv, grads, n, boxsize, cb, ext=ext, planes=planes), mass_sum


def _diff_x_slab(phi_ext, boxsize: float, n: int, halo: int, order: int):
    """diff_grid along x of a slab given with ``halo`` rows of its
    neighbours a side: the slab's rows, in diff_grid's arithmetic."""
    rows = phi_ext.shape[0] - 2 * halo
    out = torch.zeros_like(phi_ext[halo:halo + rows])
    for i, c in enumerate(_COEFFS[order], start=1):
        out += c * (phi_ext[halo + i:halo + i + rows] - phi_ext[halo - i:halo - i + rows])
    return out / (boxsize / n)


def pm_kick_cells_lean(pos3, mom3, valid, mass: float, G: float,
                       int_pm: float, scale: float, boxsize: float, mesh: int,
                       cb: int = 8, diff_order: int = 4, ext=None, dist=None):
    """The memory-lean PM kick on the (K, C) cell layout, for meshes of
    768 and more: deposit, FFT, φ(k) as in :func:`pm_gradient_cells`, the
    real-space φ, then one component at a time its order-``diff_order``
    stencil gradient (grid/stencil.py), the gather of that one grid
    (D = 1) and the momentum update.  It never holds the (3, K, C) force
    or more than one gradient grid: state + φ + one gradient, against
    state + three gradients + the slabs of the spectral path.  The
    order-4 stencil is the reference's own P³M differentiation default
    (param/example_explanatory:163-208; mesh.py:4874).

    Updates mom3 in place (invalid slots 0) and returns (mom3, mass_sum),
    mass_sum the deposited mass (0-dim float64).  ``ext`` and ``dist`` as
    in :func:`pm_gradient_cells`; over ranks the x stencil reads
    diff_order/2 rows of each neighbour's slab of φ, and each gradient's
    rows of the rank's planes come from the slabs for the gather: the
    arithmetic of one device."""
    from concept_tpu_torch.parallel import step

    n = mesh
    wv = valid.to(pos3.dtype)
    grid, mass_sum, planes, spans = _deposit_cells_mass(pos3, wv, mass, boxsize, n, cb, dist)
    slab = rfft3(grid / (boxsize / n) ** 3, dist)
    del grid
    y_rows = None if dist is None else dist.slab(n)
    phi_k = gravity_potential_slab(slab, n, boxsize, G, deconv_order=4,
                                   longrange_scale=scale, y_rows=y_rows)
    del slab
    phi = irfft3(phi_k, n, dist)
    del phi_k
    reach = len(_COEFFS[diff_order])
    phi_ext = (None if dist is None
               else step.span_rows(phi, step.slab_spans(n, reach, dist), dist))
    for d in range(3):
        if dist is None:
            grad = diff_grid(phi, boxsize, d, order=diff_order)
        else:
            grad = step.span_rows(
                _diff_x_slab(phi_ext, boxsize, n, reach, diff_order) if d == 0
                else diff_grid(phi, boxsize, d, order=diff_order), spans, dist).contiguous()
        fd = gather_cells(pos3, wv, grad[None], n, boxsize, cb, ext=ext, planes=planes)[0]
        del grad
        mom3[d].add_(fd, alpha=-mass * int_pm)
    mom3.masked_fill_(~valid[None], 0.0)
    return mom3, mass_sum


def pm_gradient_layout(pos3, valid, mass: float, G: float, scale: float,
                       boxsize: float, mesh: int, k_pm: int = 8,
                       pm_max_overflow: int = 262144, binding=None, dist=None):
    """∂φ/∂x at every slot of a (3, K, C) layout whose cells are no
    multiple of the mesh (the tight rung layout, the persistent P³M
    stepper): the valid slots, flattened in slot order, go through the
    block PM (deposit blocks of capacity k_pm, the overflow beyond it
    exact through the plain CIC up to pm_max_overflow particles, FFT,
    split potential with deconvolution of order 4, Fourier gradient,
    block gather) and back to their slots; invalid slots get 0.  With a
    ``binding`` (:func:`build_pm_binding`) the positions flow through it
    instead, with no sort (:func:`_pm_gradient_layout_mapped`).  ``dist``:
    the layout is this rank's planes of columns (the tight rung layout
    over ranks), its valid slots go through the block PM over the ranks
    (forces/p3m.pm_gradient_blocks), and n_overflow and mass_sum are the
    ranks'; a binding is one device's only.

    Returns (fd (3, K, C), n_overflow (an int), mass_sum (0-dim
    float64))."""
    if binding is not None and dist is not None:
        raise ValueError("the persistent PM binding is one device's")
    if binding is not None:
        return _pm_gradient_layout_mapped(pos3, valid, mass, G, scale, boxsize,
                                          mesh, binding)
    K, C = valid.shape
    src = torch.nonzero(valid.reshape(K * C)).reshape(-1)
    flat = pos3.reshape(3, K * C)[:, src]
    fd_v, n_over, mass_sum = pm_gradient_blocks(
        *flat, mass, G, scale, boxsize, mesh, k_pm=k_pm,
        max_overflow=pm_max_overflow, dist=dist)
    fd = torch.zeros((3, K * C), dtype=pos3.dtype, device=pos3.device)
    fd[:, src] = fd_v
    return fd.reshape(3, K, C), n_over, mass_sum


def build_pm_binding(pos3, valid, boxsize: float, mesh: int, k_pm: int) -> dict:
    """The persistent slot → PM block binding of a (3, K, C) layout (port
    of ``build_pm_binding``): the valid slots sorted into the z-major
    2³-mesh-cell blocks of capacity k_pm once, to serve every step until
    the drift since nears a mesh cell (the block kernels keep a slot
    whose CIC anchor stays within its block ±1 mesh cell).  One device's
    only: the rung stepper over ranks sorts its slots at every kick
    (:func:`pm_gradient_layout` with ``dist``).  Returns a dict:

      src    : (B,) int64 the flat ids of the slots bound in a block
      dst    : (B,) int64 their block slots, rank·C_pm + block
      w1     : (k_pm, C_pm) the block slots' validity weights
      ext    : (C_pm,) int32 the block counts clamped to k_pm (the
               kernels skip the rows past them)
      s_idx  : (S,) int64 the slots beyond their block's capacity, all
               of them (the JAX binding keeps at most a budget of them)
      n_over : S, an int
    """
    K, C = valid.shape
    src = torch.nonzero(valid.reshape(K * C)).reshape(-1)
    lay = block_layout(*pos3.reshape(3, K * C)[:, src], mesh, boxsize, k_pm)
    orig = src[lay["order"]]  # the slot of each sorted particle
    bound = lay["rank"] < k_pm
    s_idx = orig[~bound]
    return dict(src=orig[bound], dst=lay["slot"][bound], w1=lay["valid"].to(pos3.dtype),
                ext=lay["ext"], s_idx=s_idx, n_over=int(s_idx.numel()))


def _pm_gradient_layout_mapped(pos3, valid, mass: float, G: float, scale: float,
                               boxsize: float, mesh: int, binding: dict):
    """The PM gradient of :func:`pm_gradient_layout` through a persistent
    binding: the positions scattered into the bound block slots (no
    sort), ``forces/p3m.block_pm`` with the bound extents and the
    binding's stragglers.  A slot that drifted out of its block's halo
    since the binding was built is left out, and the returned mass_sum
    (0-dim float64) falls short: the host checks it."""
    K, C = valid.shape
    src, dst, w1, ext, s_idx = (binding[k] for k in ("src", "dst", "w1", "ext", "s_idx"))
    flat = pos3.reshape(3, K * C)
    slots = torch.zeros((3,) + tuple(w1.shape), dtype=pos3.dtype, device=pos3.device)
    slots.view(3, -1)[:, dst] = flat[:, src]
    fds, s_fd, mass_sum = block_pm(slots, w1, ext, flat[:, s_idx].T.contiguous(), mass,
                                   G, scale, boxsize, mesh)
    del slots
    fd = torch.zeros_like(flat)
    fd[:, src] = fds.view(3, -1)[:, dst]
    del fds
    if binding["n_over"]:
        fd[:, s_idx] = s_fd
    return fd.view(3, K, C), binding["n_over"], mass_sum


def _cell_key(comps, boxsize: float, nc: int):
    """The x-major short-range cell id of positions given per component."""
    return grid_key(comps, boxsize / nc, nc)


def _bucketize_p3m(pos, mom, boxsize: float, nc: int, capacity: int):
    """Component triples of (N,) tensors → (P3MState, the number of
    particles within the capacity) by one stable sort of the cell key
    and slot scatters; particles beyond the capacity are left out."""
    C = nc**3
    lay = slot_layout(_cell_key(pos, boxsize, nc), C, capacity)
    order, slot = lay["order"], lay["slot"]
    state = P3MState(pos=scatter_slots(torch.stack(pos)[:, order], slot, capacity, C),
                     mom=scatter_slots(torch.stack(mom)[:, order], slot, capacity, C),
                     valid=lay["valid"])
    return state, int(torch.clamp(lay["counts"], max=capacity).sum())


def _rebucketize_state(state: P3MState, boxsize: float, nc: int, capacity: int,
                       n_total: int):
    """The state re-bucketized at ``capacity`` from its current
    positions: the n_total valid slots compacted first (in slot order),
    then the old state's tensors are emptied, as the JAX function donates
    its input, so that the peak is the old state and the compact copies,
    or the copies and the new state; then one stable sort by cell and the
    slot scatters.  Particles beyond the capacity of their cell spill
    into free slots of other cells (``bucketsim.spill_slots``), where the
    sweep misses their pairs: the caller treats a nonzero spill as a
    fault.  Returns (state, valid slots, spilled), the counts ints."""
    C = nc**3
    src = torch.nonzero(state.valid.reshape(-1)).reshape(-1)[:n_total]
    pos = state.pos.reshape(3, -1)[:, src]
    mom = state.mom.reshape(3, -1)[:, src]
    del src
    for t in state:
        t.set_()
    key_s, perm = torch.sort(_cell_key(pos.unbind(0), boxsize, nc), stable=True)
    pos, mom = pos[:, perm], mom[:, perm]
    del perm
    slot, valid, n_spill = spill_slots(key_s, C, capacity)
    new = P3MState(pos=scatter_slots(pos, slot, capacity, C),
                   mom=scatter_slots(mom, slot, capacity, C), valid=valid)
    return new, int(valid.sum()), n_spill


def _occupancy_probe_sr(state: P3MState, boxsize: float, nc: int) -> int:
    """The largest cell occupancy of the state's current positions."""
    C = nc**3
    key = _cell_key(state.pos.reshape(3, -1).unbind(0), boxsize, nc)
    key = torch.where(state.valid.reshape(-1), key, C)
    return int(torch.bincount(key, minlength=C + 1)[:C].max())


def p3m_bucket_step(state: P3MState, mass: float, G: float, int_a1: float,
                    int_a2: float, boxsize: float, mesh: int, nc: int,
                    scale: float, cutoff: float, softening: float,
                    k_pm: int = 8, pm_max_overflow: int = 262144,
                    softening_kernel: str = "plummer", binding=None, ext=None):
    """One KDK step in the persistent layout, in place: the short-range
    sweep on the stored slots (receivers = suppliers within the per-column
    occupancy extents ``ext``, ``p3mrungs._column_occ_ext(state.valid)``
    when not given; the sentinel in the invalid slots for the sweep
    only), the PM of
    :func:`pm_gradient_layout` (through ``binding`` when given), the kick
    ᔑa⁻¹dt = int_a1 and the drift ᔑa⁻²dt = int_a2.

    Returns (state, (n_pm_overflow, vmax2, mass_sum)): vmax2 = the
    largest |mom|² (0-dim), mass_sum the deposited mass (0-dim
    float64)."""
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep_global
    from concept_tpu_torch.p3mrungs import _column_occ_ext

    dtype = state.pos.dtype
    if ext is None:
        ext = _column_occ_ext(state.valid)
    slots = torch.where(state.valid[None], state.pos, SENTINEL * boxsize)
    sweep = pair_sweep_global if nc >= 3 else sweep_fold
    acc = sweep(slots, slots, nc, boxsize, scale, dtype_square(cutoff, dtype),
                dtype_square(softening, dtype), kernel=softening_kernel, rext=ext, sext=ext)
    del slots
    fd, n_over, mass_sum = pm_gradient_layout(
        state.pos, state.valid, mass, G, scale, boxsize, mesh, k_pm=k_pm,
        pm_max_overflow=pm_max_overflow, binding=binding)
    inv = ~state.valid
    state.mom.add_(acc, alpha=G * mass * mass * int_a1)
    state.mom.add_(fd, alpha=-mass * int_a1)
    del acc, fd
    state.mom.masked_fill_(inv[None], 0.0)
    state.pos.copy_(periodic_wrap(state.pos + state.mom * (int_a2 / mass), boxsize))
    state.pos.masked_fill_(inv[None], 0.0)
    vmax2 = (state.mom * state.mom).sum(dim=0).max()
    return state, (n_over, vmax2, mass_sum)


class P3MSimulation:
    """The P³M stepper over the persistent short-range layout (see the
    module docstring).  ``stats`` counts steps, rebuckets, binding
    refreshes, the largest PM block overflow, overflow budgets exceeded
    and deposit mass warnings."""

    def __init__(self, n_part: int, boxsize: float, mass: float, G: float,
                 mesh: int | None = None, bg=None, margin_frac: float = 0.12,
                 capacity: int | None = None, k_pm: int = 8,
                 softening: float = 0.0, softening_kernel: str = "plummer",
                 rebucket_every_max: int = 64):
        self.N = n_part**3
        self.boxsize = boxsize
        self.mass = mass
        self.G = G
        self.bg = bg
        self.mesh = mesh or 2 * n_part
        # reference split defaults (param/example_explanatory:211-218)
        self.scale = 1.25 * boxsize / self.mesh
        self.cutoff = 4.5 * self.scale
        self.softening = softening
        self.softening_kernel = softening_kernel
        self.k_pm = k_pm
        self.pm_max_overflow = 262144
        self.rebucket_every_max = rebucket_every_max
        self._set_margin(margin_frac)
        if capacity is not None:
            self.capacity = capacity
        # the persistent PM binding: valid until the drift since it was
        # built nears a mesh cell, or the layout changes
        self._pm_binding = None
        self._pm_drift_used = 0.0
        self._pm_budget = 0.9 * boxsize / self.mesh
        # the per-particle displacement bound since the last rebucket
        self._drift_used = 0.0
        # the layout's valid mask and its sweep extents (_extents)
        self._ext_of = self._ext = None
        self.stats = {"steps": 0, "rebuckets": 0, "binding_refreshes": 0,
                      "pm_overflow_max": 0, "budget_warnings": 0,
                      "pm_mass_warnings": 0}

    def _set_margin(self, margin_frac: float):
        """The cells for a margin fraction, and the capacity from their
        mean occupancy."""
        self.margin_frac = margin_frac
        self.nc = margin_cell_count(self.boxsize, self.cutoff, margin_frac)
        self.cell_width = self.boxsize / self.nc
        self.margin = self.cell_width - self.cutoff
        self.capacity = max(8, int(math.ceil(1.3 * self.N / self.nc**3 / 8)) * 8)

    def init_state(self, pos, mom) -> P3MState:
        """pos/mom: 3-tuples of (N,) tensors.  Doubles the capacity until
        every particle fits."""
        while True:
            state, kept = _bucketize_p3m(pos, mom, self.boxsize, self.nc, self.capacity)
            if kept == self.N:
                self._drift_used = 0.0
                return state
            self.capacity = max(8, self.capacity * 2)

    def refresh_pm_binding(self, state: P3MState):
        """(Re)build the persistent PM binding and check its overflow."""
        self._pm_binding = build_pm_binding(state.pos, state.valid, self.boxsize,
                                            self.mesh, self.k_pm)
        self._pm_drift_used = 0.0
        self.stats["binding_refreshes"] += 1
        self._check_pm_overflow(self._pm_binding["n_over"])

    def step(self, state: P3MState, int_a1: float, int_a2: float):
        """One KDK step (in place).  Returns (state, (n_pm_over, vmax))."""
        if self._pm_binding is None or self._pm_drift_used > self._pm_budget:
            self.refresh_pm_binding(state)
        state, (n_pm_over, vmax2, mass_sum) = p3m_bucket_step(
            state, self.mass, self.G, int_a1, int_a2, self.boxsize, self.mesh,
            self.nc, self.scale, self.cutoff, self.softening, k_pm=self.k_pm,
            pm_max_overflow=self.pm_max_overflow,
            softening_kernel=self.softening_kernel, binding=self._pm_binding,
            ext=self._extents(state))
        self.stats["steps"] += 1
        # margin budget: each particle moved ≤ vmax/mass·ᔑa⁻²dt comoving
        vmax = math.sqrt(float(vmax2))
        drift = vmax / self.mass * float(int_a2)
        self._drift_used += drift
        self._pm_drift_used += drift
        # the deposit must carry every particle
        expected = self.N * self.mass
        if abs(float(mass_sum) - expected) > 1e-3 * expected:
            warn(f"PM deposit mass {float(mass_sum):.6g} != {expected:.6g}"
                 f" — binding drift budget violated; rebuilding")
            self.stats["pm_mass_warnings"] += 1
            self._pm_binding = None
        return state, (n_pm_over, vmax)

    def _extents(self, state: P3MState):
        """The sweep's per-column occupancy extents of the state's layout,
        computed once a layout: ``valid`` changes only at a rebucket,
        which makes a new tensor."""
        from concept_tpu_torch.p3mrungs import _column_occ_ext

        if self._ext_of is not state.valid:
            self._ext_of, self._ext = state.valid, _column_occ_ext(state.valid)
        return self._ext

    def _check_pm_overflow(self, n_pm_over: int):
        """The PM block overflow: past the budget the layout path without
        a binding truncates, so warn and grow the budget (also when it is
        more than half full); routine overflow raises k_pm instead (the
        plain path is the slow one)."""
        self.stats["pm_overflow_max"] = max(self.stats["pm_overflow_max"], n_pm_over)
        if n_pm_over > self.pm_max_overflow:
            warn(f"PM deposit-block overflow {n_pm_over} exceeded the budget "
                 f"{self.pm_max_overflow}: growing the budget")
            self.stats["budget_warnings"] += 1
            self.pm_max_overflow = 2 * n_pm_over + 1024
        elif n_pm_over > self.pm_max_overflow // 2:
            self.pm_max_overflow = 2 * n_pm_over + 1024
        if n_pm_over > max(1024, self.N // 256):
            self.k_pm = int(math.ceil(self.k_pm * 1.5 / 8)) * 8
            self._pm_binding = None

    @property
    def needs_rebucket(self) -> bool:
        # a pair is safe while the combined drift of both partners stays
        # below the margin: rebucket at 45 % per particle
        return self._drift_used > 0.45 * self.margin

    def rebucket(self, state: P3MState) -> P3MState:
        """The state re-bucketized from its positions; it consumes its
        input (see :func:`_rebucketize_state`).  The capacity is probed
        first and grown ahead of clustering (≥ 15 % headroom), so that no
        particle spills."""
        need = max(8, ((_occupancy_probe_sr(state, self.boxsize, self.nc) + 7) // 8) * 8)
        if need > 0.87 * self.capacity:
            self.capacity = max(8, int(math.ceil(1.3 * need / 8)) * 8)
        new, kept, n_spill = _rebucketize_state(state, self.boxsize, self.nc,
                                                self.capacity, self.N)
        if kept != self.N or n_spill:
            raise RuntimeError(f"rebucket kept {kept} of {self.N} particles, "
                               f"{n_spill} spilled out of their cells")
        self._drift_used = 0.0
        self._pm_binding = None  # the layout was permuted
        self.stats["rebuckets"] += 1
        return new

    def _timestep(self, a: float, vmax: float) -> float:
        from concept_tpu_torch.sim import (
            DELTA_A_MAX_EARLY, DELTA_A_MAX_LATE, FAC_DYNAMICAL, FAC_HUBBLE, FAC_P3M,
        )

        H = float(self.bg.hubble_np(a))
        rho = self.mass * self.N / self.boxsize**3 / a**3
        limits = [FAC_DYNAMICAL / math.sqrt(self.G * rho)]
        if H > 0:
            limits.append(FAC_HUBBLE / H)
            da = DELTA_A_MAX_EARLY if a < 0.1 else DELTA_A_MAX_LATE
            limits.append(da / (a * H))
        if vmax > 0:
            limits.append(FAC_P3M * self.scale / (vmax / a))
        return min(limits)

    def evolve(self, state: P3MState, t0: float, t1: float,
               max_steps: int = 100000) -> P3MState:
        """Leapfrog from t0 to t1 with a rebucket when the margin budget
        is spent, or every ``rebucket_every_max`` steps."""
        bg = self.bg
        t = t_mom = t0
        steps = 0
        vmax = 0.0
        while t < t1 - 1e-12 * abs(t1):
            a = float(bg.a_of_t_np(t))
            dt = min(self._timestep(a, vmax / (a * self.mass)), t1 - t)
            t_mid = min(t + 0.5 * dt, t1)
            int_a1 = bg.integrals_np(t_mom, t_mid, keys=("a**(-1)",))["a**(-1)"]
            int_a2 = bg.integrals_np(t, t + dt, keys=("a**(-2)",))["a**(-2)"]
            state, (_, vmax) = self.step(state, int_a1, int_a2)
            steps += 1
            if self.needs_rebucket or steps % self.rebucket_every_max == 0:
                state = self.rebucket(state)
            t_mom = t_mid
            t += dt
            if steps > max_steps:
                raise RuntimeError("max_steps exceeded")
        if t_mom < t1 - 1e-12 * abs(t1):
            int_a1 = bg.integrals_np(t_mom, t1, keys=("a**(-1)",))["a**(-1)"]
            state, _ = self.step(state, int_a1, 0.0)
        return state


def autotune_margin(sim: P3MSimulation, state: P3MState,
                    candidates=(0.05, 0.12, 0.20), n_time: int = 2):
    """Pick the short-range cell margin by timing (the reference's
    automatic subtiling refinement, interactions.py:154-329: try a
    decomposition, measure, keep or revert).  Wider margins rebucket less
    often but sweep more pairs.  Each candidate's layout is timed over
    ``n_time`` steps of zero integrals (the forces are computed, the
    state does not change) after one warm-up step, between device
    synchronisations; the fastest is kept.  A candidate with the same
    cell count as one timed already is skipped.  Returns (state,
    {margin_frac: seconds a step})."""
    dev = state.pos.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    results = {}
    for margin in candidates:
        if results and margin_cell_count(sim.boxsize, sim.cutoff, margin) == sim.nc:
            continue  # the same decomposition
        sim._set_margin(margin)
        state = sim.rebucket(state)
        state, _ = sim.step(state, 0.0, 0.0)
        sync()
        t0 = time.perf_counter()
        for _ in range(n_time):
            state, _ = sim.step(state, 0.0, 0.0)
        sync()
        results[margin] = (time.perf_counter() - t0) / n_time
    best = min(results, key=results.get)
    if sim.margin_frac != best:
        sim._set_margin(best)
        state = sim.rebucket(state)
    return state, results
