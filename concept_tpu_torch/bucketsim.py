"""Persistent-bucket PM stepper (port of concept_tpu/bucketsim.py, the
JAX package's flagship PM benchmark stepper).

The particle state stays in the 2³-mesh-cell block layout across steps:
pos and mom are slot-major (3, K, C) tensors, C = (n/2)³ blocks with
z-major ids c = (bz·nb + by)·nb + bx, the layout the block kernels of
PERF.md rows 8-9 read (grid/cuda_blocks.py).  A step derives the CIC
geometry from the stored positions inside the kernels, with no sort and
no scatter:

  * particles whose CIC anchor has left their block's ±1-mesh-cell halo
    ("stragglers") go through the plain deposit and gather, all of them
    (their count is one host sync per step), so a step is exact whatever
    the age of the layout.  The halo test is periodic, as the kernels'
    (grid/cuda_cells.py): a particle that crossed a box face stays with
    the kernels, where the JAX package routes it through its straggler
    path; both give the same CIC sums;
  * every ``rebucket_every`` steps, or when the stragglers pass half the
    JAX package's straggler budget, the layout is rebuilt on the device
    (``maybe_rebucket``), with capacity overflow beyond ``capacity_max``
    spilled into free slots of other blocks, where it rides the
    straggler path.

Departures from the JAX stepper (ROADMAP rule (d)): no padding of C to a
multiple of 128 lanes, and no z-chunking of the kernels' mini-grids (the
CUDA kernels have none).  The state is updated in place.  Single device,
CIC, Fourier gradients, deconvolution of order 4.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from concept_tpu_torch.components import periodic_wrap
from concept_tpu_torch.device import resolve_device
from concept_tpu_torch.forces.pm import gravity_potential_slab, potential_gradient_grids
from concept_tpu_torch.forces.shortrange import grid_key, scatter_slots, slot_layout
from concept_tpu_torch.grid.bucketed import B, _block_count
from concept_tpu_torch.grid.cuda_blocks import deposit_blocks, gather_blocks
from concept_tpu_torch.grid.cuda_cells import cell_geometry
from concept_tpu_torch.grid.fft import rfft3
from concept_tpu_torch.grid.interp import deposit, gather


class BucketState(NamedTuple):
    pos: torch.Tensor  # (3, K, C)
    mom: torch.Tensor  # (3, K, C)
    valid: torch.Tensor  # (K, C) bool


def _components(x, device=None):
    """(N, 3) or a 3-tuple of (N,) → three contiguous (N,) tensors."""
    comps = x if isinstance(x, (tuple, list)) else torch.as_tensor(x).unbind(1)
    return [torch.as_tensor(c, device=device).contiguous() for c in comps]


def _block_key(px, py, pz, gridsize: int, boxsize: float):
    """z-major block key of positions (the rows 8-9 column ids)."""
    return grid_key((pz, py, px), boxsize / gridsize, gridsize, B)


def bucketize_state(pos, mom, gridsize: int, boxsize: float, capacity: int
                    ) -> BucketState:
    """(N, 3) tensors, or 3-tuples of (N,) components, → BucketState by
    one stable sort of the block key and slot scatters.  Particles beyond
    the capacity are left out: callers size the capacity first."""
    px, py, pz = _components(pos)
    mx, my, mz = _components(mom, px.device)
    C = _block_count(gridsize) ** 3
    lay = slot_layout(_block_key(px, py, pz, gridsize, boxsize), C, capacity)
    order, slot = lay["order"], lay["slot"]
    return BucketState(
        pos=scatter_slots(torch.stack([px, py, pz])[:, order], slot, capacity, C),
        mom=scatter_slots(torch.stack([mx, my, mz])[:, order], slot, capacity, C),
        valid=lay["valid"])


def flatten_state(state: BucketState):
    """(3, K, C) → (N, 3) positions and momenta of the valid slots, in
    slot order."""
    v = state.valid.reshape(-1)
    return (state.pos.reshape(3, -1).T[v], state.mom.reshape(3, -1).T[v])


def bucket_pm_step(state: BucketState, mass: float, boxsize: float, G: float,
                   int_a1: float, int_a2: float, gridsize: int):
    """One KDK step in the block layout, in place: the kick ᔑa⁻¹dt
    (int_a1), then the drift ᔑa⁻²dt (int_a2).  Returns (state, the
    number of stragglers)."""
    n = gridsize
    nb = _block_count(n)
    K, C = state.valid.shape
    h = boxsize / n
    px, py, pz = state.pos
    # one per-slot weight, mass·validity: the gathered forces come back
    # mass-scaled, as the kick wants them, and empty slots stay at rest
    w = state.valid.to(state.pos.dtype) * mass
    grid = deposit_blocks(px, py, pz, w, n, boxsize)
    _, _, in_halo = cell_geometry(state.pos, slice(0, C), nb, B, float(n / boxsize),
                                  zmajor=True)
    sidx = torch.nonzero((state.valid & ~in_halo).reshape(-1)).reshape(-1)
    del in_halo
    n_straggler = int(sidx.numel())
    if n_straggler:
        s_pos = state.pos.reshape(3, -1)[:, sidx].T
        grid += deposit(s_pos, mass, n, boxsize, order=2)
    phi = gravity_potential_slab(rfft3(grid / h**3), n, boxsize, G, deconv_order=4)
    del grid
    grads = potential_gradient_grids(phi, n, boxsize)
    del phi
    fds = gather_blocks(px, py, pz, w, grads, n, boxsize)
    del w
    for d in range(3):
        fd = fds[d]
        if n_straggler:
            fd.view(-1)[sidx] = gather(grads[d], s_pos, boxsize, order=2) * mass
        state.mom[d] += (-int_a1) * fd
        state.pos[d] = periodic_wrap(state.pos[d] + state.mom[d] * (int_a2 / mass),
                                     boxsize)
    return state, n_straggler


class BucketSimulation:
    """The PM stepper over the persistent block layout."""

    def __init__(self, gridsize: int, boxsize: float, mass: float, G: float,
                 bg=None, capacity: int | None = None, rebucket_every: int = 16,
                 capacity_max: int = 16, device=None):
        self.n = gridsize
        self.boxsize = boxsize
        self.mass = mass
        self.G = G
        self.bg = bg
        self.capacity = capacity or 32
        self.rebucket_every = rebucket_every
        # the capacity cap: beyond it, deep blocks spill into free slots
        # of other blocks and ride the straggler path (a K padded to the
        # largest occupancy of a clustered state is ~15× the particles'
        # memory); 16 = 2× the mean occupancy, the JAX package's choice
        self.capacity_max = capacity_max
        self._n_spilled = 0
        self.device = resolve_device(device)
        # steps, rebuckets and the largest straggler count of a step
        self.stats = {"steps": 0, "rebuckets": 0, "stragglers_max": 0}

    def init_state(self, pos, mom) -> BucketState:
        """Bucketize (N, 3) tensors or component triples on the device,
        doubling the capacity until no particle is left out (as the JAX
        package does)."""
        pos = _components(pos, self.device)
        mom = _components(mom, self.device)
        self._N = pos[0].shape[0]
        key = _block_key(*pos, self.n, self.boxsize)
        need = int(torch.bincount(key, minlength=_block_count(self.n) ** 3).max())
        while self.capacity < need:
            self.capacity = max(self.capacity * 2, 8)
        return bucketize_state(pos, mom, self.n, self.boxsize, self.capacity)

    def step(self, state: BucketState, int_a1: float, int_a2: float):
        state, ns = bucket_pm_step(state, self.mass, self.boxsize, self.G, int_a1,
                                   int_a2, self.n)
        self.stats["steps"] += 1
        self.stats["stragglers_max"] = max(self.stats["stragglers_max"], ns)
        return state, ns

    def _straggler_budget(self) -> int:
        """The JAX package's fixed straggler buffer (drift crossers plus
        the spilled population, a power of two).  The port's straggler
        path is exact at any count; the budget only triggers a rebucket
        when passed by half, as there."""
        need = max(1024, self._N // 256) + self._n_spilled + self._n_spilled // 4
        p = 1024
        while p < need:
            p *= 2
        return p

    def evolve(self, state: BucketState, t0: float, t1: float,
               max_steps: int = 100000) -> BucketState:
        """Leapfrog from t0 to t1, rebucketing every ``rebucket_every``
        steps or when the stragglers pass half the budget."""
        bg = self.bg
        t = t_mom = t0
        steps = 0
        while t < t1 - 1e-12 * abs(t1):
            a = float(bg.a_of_t_np(t))
            dt = min(self._timestep(a), t1 - t)
            t_mid = min(t + 0.5 * dt, t1)
            int_a1 = bg.integrals_np(t_mom, t_mid, keys=("a**(-1)",))["a**(-1)"]
            int_a2 = bg.integrals_np(t, t + dt, keys=("a**(-2)",))["a**(-2)"]
            state, ns = self.step(state, int_a1, int_a2)
            steps += 1
            if steps % self.rebucket_every == 0 or ns > self._straggler_budget() // 2:
                state = self.maybe_rebucket(state)
            t_mom = t_mid
            t += dt
            if steps > max_steps:
                raise RuntimeError("max_steps exceeded")
        if t_mom < t1 - 1e-12 * abs(t1):
            int_a1 = bg.integrals_np(t_mom, t1, keys=("a**(-1)",))["a**(-1)"]
            state, _ = self.step(state, int_a1, 0.0)
        return state

    def _timestep(self, a: float) -> float:
        from concept_tpu_torch.sim import (
            DELTA_A_MAX_EARLY, DELTA_A_MAX_LATE, FAC_DYNAMICAL, FAC_HUBBLE,
        )

        H = float(self.bg.hubble_np(a))
        rho = self.mass * self._N / self.boxsize**3 / a**3
        limits = [FAC_DYNAMICAL / math.sqrt(self.G * rho)]
        if H > 0:
            limits.append(FAC_HUBBLE / H)
            da = DELTA_A_MAX_EARLY if a < 0.1 else DELTA_A_MAX_LATE
            limits.append(da / (a * H))
        return min(limits)

    def maybe_rebucket(self, state: BucketState) -> BucketState:
        """Rebuild the layout from the current positions at a capacity
        sized by the largest block occupancy (30 % headroom, at most
        ``capacity_max``; the probe is skipped once the capacity sits at
        the cap).  Fails loudly if a particle went missing."""
        cap = max(8, self.capacity_max)
        if self.capacity != cap:
            need = max(8, ((_occupancy_probe(state, self.boxsize, self.n) + 7) // 8) * 8)
            self.capacity = (min(max(8, int(math.ceil(1.3 * need / 8)) * 8), cap)
                             if need <= cap else cap)
        new_state, kept, n_spill, n_valid = _rebucketize_bucketstate(
            state, self.boxsize, self.n, self.capacity, self._N)
        self._n_spilled = n_spill
        self.stats["rebuckets"] += 1
        if kept != self._N or n_valid != self._N:
            raise RuntimeError(f"rebucket kept {kept} of {self._N} particles "
                               f"({n_valid} valid slots before)")
        return new_state


def _flat_keys(state: BucketState, boxsize: float, gridsize: int):
    """The z-major block key of every slot, C for the empty ones."""
    C = _block_count(gridsize) ** 3
    flat = state.pos.reshape(3, -1)
    key = _block_key(flat[0], flat[1], flat[2], gridsize, boxsize)
    return torch.where(state.valid.reshape(-1), key, C)


def _occupancy_probe(state: BucketState, boxsize: float, gridsize: int) -> int:
    """The largest block occupancy of the current positions."""
    C = _block_count(gridsize) ** 3
    return int(torch.bincount(_flat_keys(state, boxsize, gridsize),
                              minlength=C + 1)[:C].max())


def _rebucketize_bucketstate(state: BucketState, boxsize: float, gridsize: int,
                             capacity: int, n_total: int):
    """The slots sorted by block key (empty slots last, one stable sort),
    the leading N taken and laid out at ``capacity``; particles beyond
    the capacity of their block are placed in the free slots of others,
    the j-th overflowing particle in the j-th free slot in layout order
    (the JAX package's spill).  Returns (state, kept, spilled, valid slots
    before), the counts ints."""
    C = _block_count(gridsize) ** 3
    K, N = capacity, n_total
    key = _flat_keys(state, boxsize, gridsize)
    n_valid = int(state.valid.sum())
    key_s, perm = torch.sort(key, stable=True)
    key_s, perm = torch.clamp(key_s[:N], max=C - 1), perm[:N]
    pos = state.pos.reshape(3, -1)[:, perm]
    mom = state.mom.reshape(3, -1)[:, perm]
    slot, valid, n_spill = spill_slots(key_s, C, K)
    new = BucketState(pos=scatter_slots(pos, slot, K, C),
                      mom=scatter_slots(mom, slot, K, C), valid=valid)
    return new, int(valid.sum()), n_spill, n_valid


def spill_slots(key_s, C: int, K: int):
    """The slots of N particles sorted by key (key_s (N,), values in
    [0, C)) in a (K, C) layout: rank·C + key within the capacity; the
    particles beyond the capacity of their column go to the free slots of
    others, the j-th of them to the j-th free slot in layout order (the
    JAX package's spill).  Returns (slot (N,), valid (K, C), the number
    spilled)."""
    dev = key_s.device
    N = key_s.shape[0]
    counts = torch.bincount(key_s, minlength=C)
    rank = torch.arange(N, device=dev) - (torch.cumsum(counts, 0) - counts)[key_s]
    in_b = rank < K
    counts_k = torch.clamp(counts, max=K)
    n_spill = N - int(counts_k.sum())
    slot = torch.where(in_b, rank * C + key_s, K * C)
    if n_spill:
        free = torch.nonzero((torch.arange(K, device=dev)[:, None]
                              >= counts_k[None, :]).reshape(-1)).reshape(-1)
        slot[~in_b] = free[:n_spill]
    valid = torch.zeros(K * C + 1, dtype=torch.bool, device=dev)
    valid[slot] = True
    return slot, valid[:K * C].view(K, C), n_spill
