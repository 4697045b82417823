"""P³M short-range pair force law and its host-side helpers (port of the
plain parts of concept_tpu/forces/shortrange.py and the host half of
concept_tpu/forces/pallas_shortrange.py).

The pair force is

    F(r) = −G·m²·r⃗ · S(r/rₛ) · r⁻³_soft,   S(x) = erfc(x/2) + x/√π·e^(−x²/4)

(reference gravity.py:373 get_shortrange_table).  In float32 the
screening is evaluated as S = 1 + x·g(x²) with a degree-10 polynomial fit
of g in u = r²/rₛ² (``_G_COEF``, ~8.5e-7 absolute) — the same polynomial
the float CUDA sweep kernel evaluates (csrc/pair_sweep.cu), so the plain
sweep here and the kernel compute one function.  In float64 it is
evaluated exactly through erfc and exp, as the JAX package's CPU paths
and the double sweep kernel evaluate it.  ``_sweep_pair`` is the one-sided sweep with the
valid-mask contract of the JAX ``_sweep_pair``; it sentinels the invalid
slots and hands them to ``cuda_shortrange.pair_sweep``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from concept_tpu_torch import _build

# Fit range of the screening polynomial: x = r/rₛ ∈ [0, 4.6] (the cutoff
# is 4.5·rₛ; beyond the fit the argument is clamped and the cutoff mask
# removes the pair anyway).
_X_MAX = 4.6
_U_MAX = _X_MAX * _X_MAX
_G_DEG = 10

SENTINEL = 1e4  # invalid slots sit at SENTINEL·boxsize (p3mrungs.py:470)


def _fit_screening_g(deg: int = _G_DEG) -> np.ndarray:
    """Monomial (Horner) coefficients of g(t), t = 2u/u_max − 1, highest
    degree first, float32.  Fitted in float64 in a Chebyshev basis and
    converted to monomials in t (|t| ≤ 1 keeps Horner stable in f32)."""
    x = np.linspace(1e-9, _X_MAX, 8001)
    S = np.asarray([math.erfc(0.5 * xi) for xi in x])
    S = S + x / math.sqrt(math.pi) * np.exp(-0.25 * x * x)
    g = (S - 1.0) / x
    t = 2 * (x * x) / _U_MAX - 1
    coef = np.polynomial.chebyshev.chebfit(t, g, deg)
    mono = np.polynomial.chebyshev.cheb2poly(coef)
    Sv = 1.0 + x * np.polynomial.polynomial.polyval(t, mono)
    err = np.abs(Sv - S).max()
    if err >= 1e-6:
        raise RuntimeError(f"screening fit error {err:.3g} ≥ 1e-6")
    return mono[::-1].astype(np.float32)


_G_COEF = _fit_screening_g()


def screening_g(u: torch.Tensor) -> torch.Tensor:
    """g(u) = (S(√u) − 1)/√u by the Horner fit.  u is clamped into the
    fitted range, which keeps far sentinels finite."""
    t = torch.clamp(2.0 * u / _U_MAX - 1.0, max=1.0)
    g = torch.full_like(t, float(_G_COEF[0]))
    for c in _G_COEF[1:]:
        g = g * t + float(c)
    return g


def softened_r3inv(r2: torch.Tensor, softening: float, kernel: str):
    """Softened r⁻³ per ``softening_kernel`` (reference get_softened_r3inv,
    interactions.py:1846-1910): 'plummer' 1/(r²+ε²)^{3/2}; 'spline' the
    GADGET-2 cubic spline with h = 2.8ε; 'none' plain 1/r³."""
    if kernel == "plummer":
        r2s = r2 + softening * softening
        return torch.rsqrt(r2s) / r2s
    inv_r = torch.rsqrt(torch.clamp(r2, min=1e-30))
    far = inv_r * inv_r * inv_r
    if kernel == "none":
        return far
    if kernel == "spline":
        h = 2.8 * softening
        inv_h = 1.0 / h if h > 0 else 1e30
        r = r2 * inv_r
        u = r * inv_h
        near = 32.0 * inv_h**3 * (1.0 / 3.0 + u * u * (-6.0 / 5.0 + u))
        mid = (32.0 / 3.0) * far * (
            u**3 * (2.0 + u * (-4.5 + u * (3.6 - u))) - 3.0 / 480.0
        )
        return torch.where(u >= 1.0, far, torch.where(u < 0.5, near, mid))
    raise ValueError(f"unknown softening kernel {kernel!r}")


def shortrange_force_factor(r2: torch.Tensor, scale: float, softening2: float,
                            kernel: str = "plummer") -> torch.Tensor:
    """−S(r/rₛ)·r⁻³_softened, in the form the sweep kernels evaluate it.
    float32 (pallas_shortrange ``_make_accum``, the fitted screening):
    'plummer' evaluates S at the softened r; the other kernels take the
    unsoftened far field S·r⁻³ and, for 'spline', add the near-field
    correction −S·(r⁻³_spline − r⁻³) where r < h = 2.8ε.  float64 (the
    JAX package's ``shortrange_force_factor``, exact screening): S at the
    softened r for 'plummer', else S·``softened_r3inv``."""
    if r2.dtype == torch.float64:
        return _force_factor_exact(r2, scale, softening2, kernel)
    inv_scale = 1.0 / scale
    inv_scale2 = inv_scale * inv_scale
    if kernel == "plummer":
        r2s = r2 + softening2
        inv_r = torch.rsqrt(r2s)
        g = screening_g(r2s * inv_scale2)
        return -(inv_r * inv_r * (inv_r + inv_scale * g))
    inv_r = torch.rsqrt(torch.clamp(r2, min=1e-30))
    inv_r2 = inv_r * inv_r
    g = screening_g(r2 * inv_scale2)
    f = -(inv_r2 * (inv_r + inv_scale * g))
    if kernel == "none":
        return f
    if kernel != "spline":
        raise ValueError(f"unknown softening kernel {kernel!r}")
    S = 1.0 + (r2 * inv_r * inv_scale) * g
    near = softened_r3inv(r2, math.sqrt(softening2), kernel) - inv_r2 * inv_r
    return f - torch.where(r2 < 7.84 * softening2, S * near, 0.0)


def _screening(x: torch.Tensor) -> torch.Tensor:
    """S(x) = erfc(x/2) + x/√π·e^(−x²/4), exactly."""
    return torch.special.erfc(0.5 * x) + x * (1 / math.sqrt(math.pi)) * torch.exp(-0.25 * x * x)


def _force_factor_exact(r2, scale: float, softening2: float, kernel: str):
    """The float64 factor, in the JAX package's form
    (concept_tpu/forces/shortrange.py ``shortrange_force_factor``)."""
    if kernel == "plummer":
        r2s = r2 + softening2
        r = torch.sqrt(r2s)
        return -_screening(r / scale) / (r2s * r)
    if kernel not in ("spline", "none"):
        raise ValueError(f"unknown softening kernel {kernel!r}")
    r = torch.sqrt(torch.clamp(r2, min=1e-30))
    return -_screening(r / scale) * softened_r3inv(r2, math.sqrt(softening2), kernel)


def kept_offsets(cell_width: float, cutoff: float, margin: float,
                 reach: int = 2):
    """The neighbour offsets (di, dj, dk) ∈ [−reach, reach]³ whose
    smallest box-to-box gap cell_width·√Σ max(|d|−1, 0)² lies below
    cutoff + 2·margin: pairs in the other cells cannot interact even after
    both particles drift by the rebucket margin (port of
    ``kept_offsets``, concept_tpu/forces/pallas_shortrange.py)."""
    keep = []
    thresh = cutoff + 2.0 * margin
    for di in range(-reach, reach + 1):
        for dj in range(-reach, reach + 1):
            for dk in range(-reach, reach + 1):
                gap = cell_width * math.sqrt(
                    max(abs(di) - 1, 0) ** 2 + max(abs(dj) - 1, 0) ** 2
                    + max(abs(dk) - 1, 0) ** 2)
                if gap < thresh:
                    keep.append((di, dj, dk))
    return tuple(keep)


def reach_offsets(cell_width: float, margin: float):
    """The reach-2 offsets of the 4-mesh-cell rung layout, pruned with the
    layout's static cutoff (4.5·1.25/4)·cell_width, as the JAX package's
    ``_sr_pair_accel`` and ``sweep_pallas_pair_reach`` prune them (117 of
    the 125 at the rung stepper's margin)."""
    cutoff = (4.5 * 1.25 / 4.0) * cell_width
    if 2 * cell_width < cutoff:
        raise ValueError("reach 2 does not cover the cutoff")
    return kept_offsets(cell_width, cutoff, margin, reach=2)


def _min_image(d, boxsize: float):
    return d - boxsize * torch.round(d / boxsize)


def sweep_fold(recv, sup, n_cells: int, boxsize: float, scale: float,
               cutoff2: float, soft2: float, kernel: str = "plummer",
               rext=None, sext=None):
    """The sweep for fewer than 3 cells a side, with the contract of
    ``cuda_shortrange.pair_sweep`` (slots at ±SENTINEL·boxsize are
    invalid; row bounds per column or per pencil): port of the XLA
    sweeps' folded offsets (``_sweep(halve=False)``, ``_sweep_pair`` at
    n_cells < 3, concept_tpu/forces/shortrange.py).  There the ±1
    offsets alias and the folded list {0} or {0, 1} per dimension reaches
    every cell once, so each receiver meets every supplier once, at the
    minimum image.  Plain PyTorch on every device: the JAX package runs
    no Pallas kernel at n_cells < 3 either.  Returns (3, K_r, C)."""
    from concept_tpu_torch.forces.cuda_shortrange import column_bounds

    if n_cells >= 3:
        raise ValueError(f"the folded sweep is for n_cells < 3, got {n_cells}")
    _, K_r, C = recv.shape
    K_s = sup.shape[1]
    dev = recv.device
    far = 0.5 * SENTINEL * boxsize

    def live(slots, K, ext):
        m = slots[0].abs() < far
        if ext is not None:
            m &= torch.arange(K, device=dev)[:, None] < column_bounds(ext, n_cells)[None]
        return torch.nonzero(m.reshape(-1)).reshape(-1)

    r_idx = live(recv, K_r, rext)
    s_pos = sup.reshape(3, -1)[:, live(sup, K_s, sext)]
    r_pos = recv.reshape(3, -1)[:, r_idx]
    out = torch.zeros((3, K_r * C), dtype=recv.dtype, device=dev)
    rows = max(1, (1 << (24 if dev.type == "cuda" else 21)) // max(1, s_pos.shape[1]))
    for i0 in range(0, r_idx.numel(), rows):
        d = _min_image(r_pos[:, i0:i0 + rows, None] - s_pos[:, None, :], boxsize)
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        f = torch.where((r2 < cutoff2) & (r2 > 0),
                        shortrange_force_factor(r2, scale, soft2, kernel), 0.0)
        out[:, r_idx[i0:i0 + rows]] = (f[None] * d).sum(-1)
    return out.reshape(3, K_r, C)


def sweep_slots(recv, sup, n_cells: int, boxsize: float, scale: float,
                cutoff2: float, soft2: float, kernel: str = "plummer",
                rext=None, sext=None, nx: int | None = None):
    """The ±1 sweep of ``cuda_shortrange.pair_sweep`` (the CUDA kernel on
    the card) where there are at least 3 cells a side, else the folded
    plain sweep (:func:`sweep_fold`), chosen by n_cells as the JAX
    package chooses its engine.  ``nx`` (a rank's planes with their two
    neighbour planes) takes the kernel's nx × n × n column grid; the
    folded sweep has no such form (below 3 cells a side the ±1 offsets of
    a plane alias, and a rank's planes cannot stand for the box's), so
    planes of fewer than 3 cells a side raise ValueError."""
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep

    if nx is not None:
        if n_cells < 3:
            raise ValueError(f"{n_cells} cells a side: the folded sweep takes no planes")
        return pair_sweep(recv, sup, n_cells, boxsize, scale, cutoff2, soft2,
                          kernel=kernel, rext=rext, sext=sext, nx=nx)
    sweep = pair_sweep if n_cells >= 3 else sweep_fold
    return sweep(recv, sup, n_cells, boxsize, scale, cutoff2, soft2,
                 kernel=kernel, rext=rext, sext=sext)


def _sweep_pair(bx, by, bz, bvalid, hx, hy, hz, valid, n_cells: int,
                boxsize: float, scale: float, cutoff2: float, soft2: float,
                kernel: str = "plummer", offsets_ext=None):
    """One-sided sweep with the valid-mask contract of the JAX
    ``_sweep_pair``: accelerations (3, K_r, C) ON the receiver slots
    (bx, by, bz, bvalid) FROM the supplier slots (hx, hy, hz, valid) of
    the 27 periodic neighbour cells (folded below 3 cells a side), or of
    the cells at ``offsets_ext`` (the reach-2 table); the caller applies
    G·m."""
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep_reach

    big = SENTINEL * boxsize
    sup = torch.where(valid[None], torch.stack([hx, hy, hz]), big)
    if offsets_ext is None:
        recv = torch.where(bvalid[None], torch.stack([bx, by, bz]), big)
        return sweep_slots(recv, sup, n_cells, boxsize, scale, cutoff2, soft2,
                           kernel=kernel)
    # receivers at the opposite sentinel, as sweep_pallas_pair_reach
    recv = torch.where(bvalid[None], torch.stack([bx, by, bz]), -big)
    return pair_sweep_reach(recv, sup, n_cells, boxsize, scale, cutoff2, soft2,
                            offsets_ext, kernel=kernel)


def f32_square(x: float) -> float:
    """x² rounded as the float32 kernels form it (f32(x)·f32(x))."""
    x = np.float32(x)
    return float(x * x)


def dtype_square(x: float, dtype) -> float:
    """x² as a sweep in ``dtype`` takes it: :func:`f32_square` in
    float32, x·x in float64 (the JAX package squares in the state's
    dtype)."""
    return f32_square(x) if dtype == torch.float32 else x * x


# ---------------------------------------------------------------------- #
# The global stepper's short range: bucketize, the two-sided sweep on the
# slot layout and the exact straggler path (port of cell_grid_shape,
# auto_capacity, cell_counts, bucketize and shortrange_momentum_updates of
# concept_tpu/forces/shortrange.py).

_FULL_OFFSETS_27 = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                    for k in (-1, 0, 1)]
STRAGGLER_ROWS = 1024  # straggler↔straggler pairs per chunk: rows × S


def cell_grid_shape(boxsize: float, cutoff: float, max_cells: int = 512) -> int:
    """Cells per dimension: width ≥ cutoff (27-neighbour completeness)."""
    n = int(boxsize / cutoff)
    return max(1, min(n, max_cells))


def auto_capacity(N: int, n_cells: int, headroom: float = 1.3) -> int:
    """Bucket capacity from the mean occupancy, rounded up to 8.  Sized
    for near-uniform states; clustered states overflow into the exact
    straggler path until the host grows the capacity."""
    mean = N / n_cells**3
    return max(8, int(math.ceil(headroom * mean / 8)) * 8)


def grid_key(comps, width: float, n: int, div: int = 1):
    """Flat int64 key of every particle: per component
    clamp(trunc(p/width), 0, n−1) // div, the first component of
    ``comps`` most significant, as the JAX package forms its cell and
    block ids (x-major cells: (px, py, pz); z-major blocks: (pz, py, px))."""
    m = (n - 1) // div + 1
    key = torch.zeros_like(comps[0], dtype=torch.int64)
    for comp in comps:
        idx = torch.clamp((comp / width).to(torch.int32), 0, n - 1) // div
        key = key * m + idx.to(torch.int64)
    return key


def sorted_runs(key, n_keys: int) -> dict:
    """One stable sort by ``key`` (values in [0, n_keys)).  Returns a
    dict: order (N,) original index per sorted particle, key (N,) sorted,
    and per key counts (C,) and starts (C,) (int64), so that key c's
    particles are sorted positions [starts[c], starts[c] + counts[c])."""
    key_s, order = torch.sort(key, stable=True)
    counts = torch.bincount(key_s, minlength=n_keys)
    starts = torch.cumsum(counts, 0) - counts
    return dict(order=order, key=key_s, counts=counts, starts=starts)


def run_slots(runs: dict, capacity: int) -> dict:
    """The sorted runs of :func:`sorted_runs` as slot-major (K, C)
    buckets, K = capacity: adds rank and slot (N,) in sorted order (slot
    = rank·C + key, or K·C where rank ≥ K: in no bucket) and valid
    (K, C)."""
    key_s, counts = runs["key"], runs["counts"]
    C, K = counts.shape[0], capacity
    rank = torch.arange(key_s.shape[0], device=key_s.device) - runs["starts"][key_s]
    slot = torch.where(rank < K, rank * C + key_s, K * C)
    valid = torch.arange(K, device=key_s.device)[:, None] < counts[None, :]
    return dict(runs, rank=rank, slot=slot, valid=valid)


def slot_layout(key, n_keys: int, capacity: int) -> dict:
    """One stable sort by ``key`` into slot-major (K, C) buckets, C =
    n_keys, K = capacity.  Returns a dict: order (N,) original index per
    sorted particle; key, rank and slot (N,) in sorted order (slot =
    rank·C + key, or K·C where rank ≥ K: in no bucket); counts (C,)
    unclamped, starts (C,); valid (K, C)."""
    return run_slots(sorted_runs(key, n_keys), capacity)


def scatter_slots(vals, slot, K: int, C: int):
    """Sorted per-particle values (D, N) → slot arrays (D, K, C), 0 in
    empty slots; particles with slot = K·C are left out."""
    out = torch.zeros(vals.shape[:-1] + (K * C + 1,), dtype=vals.dtype,
                      device=vals.device)
    out[..., slot] = vals
    return out[..., :K * C].reshape(vals.shape[:-1] + (K, C))


def cell_counts(pos, boxsize: float, n_cells: int):
    """Per-cell occupancy (C,) int64 of positions (N, 3): the
    capacity-sizing probe."""
    cell = grid_key(pos.unbind(1), boxsize / n_cells, n_cells)
    return torch.bincount(cell, minlength=n_cells**3)


def bucketize(pos, boxsize: float, n_cells: int, capacity: int):
    """Sort the particles of the component triple ``pos`` into slot-major
    (K, C) cell buckets (x-major, z-fastest cell ids).

    Returns a dict: hx, hy, hz (K, C) positions (0 in empty slots), valid
    (K, C), order (N,) original index per sorted particle, cell, rank and
    slot (N,) in sorted order (rank ≥ capacity: a straggler, not in the
    buckets), counts (C,) unclamped, starts (C,), and the sorted
    positions px, py, pz.  No particle is dropped: callers route
    rank ≥ capacity through the straggler path."""
    C = n_cells**3
    lay = slot_layout(grid_key(pos, boxsize / n_cells, n_cells), C, capacity)
    order = lay["order"]
    px, py, pz = (p[order] for p in pos)
    hx, hy, hz = scatter_slots(torch.stack([px, py, pz]), lay["slot"], capacity, C)
    return dict(hx=hx, hy=hy, hz=hz, valid=lay["valid"], order=order,
                cell=lay["key"], rank=lay["rank"], slot=lay["slot"],
                counts=lay["counts"], starts=lay["starts"], px=px, py=py, pz=pz)


def occupancy_bounds(counts, capacity: int):
    """The sweep's row bounds (C,) int32 of a bucketize layout, whose
    valid slots are a column prefix: min(counts, capacity)."""
    return torch.clamp(counts, max=capacity).to(torch.int32)


def _straggler_forces(b, acc, sidx, n: int, boxsize: float, scale: float,
                      cutoff2: float, soft2: float, kernel: str):
    """The exact straggler path: accelerations (S, 3) on the stragglers
    sidx (sorted indices, rank ≥ K) from the bucketed slots of their 27
    neighbour cells and from each other (all pairs, minimum image), with
    the reactions added into the slot accelerations ``acc`` (3, K, C) in
    place."""
    valid = b["valid"]
    K, C = valid.shape
    dev = acc.device
    sx, sy, sz = b["px"][sidx], b["py"][sidx], b["pz"][sidx]
    scell = b["cell"][sidx]
    sc = (scell // (n * n), (scell // n) % n, scell % n)
    offs = torch.as_tensor(_FULL_OFFSETS_27, device=dev)  # (27, 3)
    nbc = [sc[d][:, None] + offs[None, :, d] for d in range(3)]  # (S, 27)
    ncell = ((nbc[0] % n) * n + nbc[1] % n) * n + nbc[2] % n
    # a neighbour across a box face is seen at ±boxsize
    d = []
    for s_d, h_d, c_d in zip((sx, sy, sz), (b["hx"], b["hy"], b["hz"]), nbc):
        shift = torch.div(c_d, n, rounding_mode="floor").to(s_d.dtype) * boxsize
        d.append(s_d[None, :, None] - (h_d[:, ncell] + shift[None]))  # (K, S, 27)
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    m = valid[:, ncell] & (r2 < cutoff2) & (r2 > 0)
    f = torch.where(m, shortrange_force_factor(r2, scale, soft2, kernel), 0.0)
    fd = [f * dd for dd in d]
    s_acc = torch.stack([x.sum(dim=(0, 2)) for x in fd], 1)  # (S, 3)
    # reactions onto the bucketed side
    rows = torch.arange(K, device=dev)[:, None, None]
    tgt = (rows * C + ncell[None])[m]
    accf = acc.reshape(3, K * C)
    for k in range(3):
        accf[k].index_add_(0, tgt, -fd[k][m])
    # straggler ↔ straggler all pairs, in row chunks
    S = sidx.shape[0]
    for r0 in range(0, S, STRAGGLER_ROWS):
        rs = slice(r0, min(S, r0 + STRAGGLER_ROWS))
        ds = [_min_image(s_d[rs, None] - s_d[None, :], boxsize)
              for s_d in (sx, sy, sz)]
        r2s = ds[0] * ds[0] + ds[1] * ds[1] + ds[2] * ds[2]
        fs = torch.where((r2s < cutoff2) & (r2s > 0),
                         shortrange_force_factor(r2s, scale, soft2, kernel), 0.0)
        s_acc[rs] += torch.stack([(fs * dd).sum(1) for dd in ds], 1)
    return s_acc


def shortrange_momentum_updates(pos, mass: float, boxsize: float, scale: float,
                                cutoff: float, kick_integral: float,
                                n_cells: int, capacity: int,
                                softening: float = 0.0, G: float = 1.0,
                                max_overflow: int = 2048,
                                softening_kernel: str = "plummer"):
    """Δmom from the P³M short-range force of one self-interacting
    particle group: the two-sided sweep of every slot against its 27
    neighbour cells (``pair_sweep_global`` with receivers = suppliers and
    the occupancy bounds min(counts, K), PERF.md row 6: the CUDA kernel on
    the card), the exact straggler path for particles beyond
    the capacity K of their cell, and the unsort.

    pos: a 3-tuple of (N,) components.  Returns ((dmx, dmy, dmz),
    n_overflow), the number of stragglers an int.  Overflow is exact
    while the number of stragglers is ≤ max_overflow; beyond it the
    stragglers past the first max_overflow (in cell order) get no
    short-range force and exert none, as in the JAX package's fixed-size
    path, and the caller must grow the budget.  Below 3 cells a side the
    sweep is folded (:func:`sweep_fold`): the slots and the stragglers in
    the budget meet all at once, each pair at its minimum image, which
    sums the JAX package's folded sweep and straggler path."""
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep_global

    N = pos[0].shape[0]
    dtype = pos[0].dtype
    n = n_cells
    C = n**3
    K = capacity
    b = bucketize(pos, boxsize, n, K)
    cutoff2 = dtype_square(cutoff, dtype)
    soft2 = dtype_square(softening, dtype)
    valid = b["valid"]
    big = SENTINEL * boxsize
    n_overflow = N - int(valid.sum())
    sidx = None
    if n_overflow > 0:
        sidx = torch.nonzero(b["rank"] >= K).reshape(-1)[:max_overflow]
    coef = G * mass * mass * kick_integral
    if n < 3:
        # the bucketed particles and the stragglers in the budget, in
        # sorted order, as one (3, N, 1) slot column
        acts = b["rank"] < K
        if sidx is not None:
            acts[sidx] = True
        sl = torch.where(acts, torch.stack([b["px"], b["py"], b["pz"]]), big)[:, :, None]
        dm_s = sweep_fold(sl, sl, n, boxsize, scale, cutoff2, soft2,
                          kernel=softening_kernel)[:, :, 0]
        dmom = torch.empty_like(dm_s)
        dmom[:, b["order"]] = coef * dm_s
        return tuple(dmom), n_overflow
    slots = torch.where(valid[None], torch.stack([b["hx"], b["hy"], b["hz"]]), big)
    ext = occupancy_bounds(b["counts"], K)
    acc = pair_sweep_global(slots, slots, n, boxsize, scale, cutoff2, soft2,
                            kernel=softening_kernel, rext=ext, sext=ext)
    del slots
    if sidx is not None:
        s_acc = _straggler_forces(b, acc, sidx, n, boxsize, scale, cutoff2,
                                  soft2, softening_kernel)
    # unsort: each sorted particle reads its slot (stragglers read 0, then
    # take their straggler sum), then scatter back to the original order
    accf = torch.cat([acc.reshape(3, K * C),
                      torch.zeros((3, 1), dtype=dtype, device=acc.device)], 1)
    del acc
    dm_s = accf[:, b["slot"]]
    if sidx is not None:
        dm_s[:, sidx] = s_acc.T
    dmom = torch.empty_like(dm_s)
    dmom[:, b["order"]] = coef * dm_s
    return tuple(dmom), n_overflow


def shortrange_momentum_updates_on_subset(recv_pos, sup_pos, mass: float,
                                          boxsize: float, scale: float,
                                          cutoff: float, n_cells: int,
                                          capacity_recv: int, capacity_sup: int,
                                          softening: float = 0.0, G: float = 1.0,
                                          softening_kernel: str = "plummer",
                                          mass_sup: float | None = None):
    """Per-unit-kick-integral Δmom (M, 3) ON the receivers recv_pos (M, 3)
    FROM the suppliers sup_pos (N, 3) (port of the function of that name,
    concept_tpu/forces/shortrange.py): both sets are bucketized into the
    same cells, at their own capacities, and the one-sided sweep
    (``cuda_shortrange.pair_sweep_subset``, the CUDA kernel of PERF.md
    row 2 on the card; :func:`sweep_fold` below 3 cells a side)
    runs receivers against the suppliers of their 27 neighbour cells,
    within each set's occupancy bounds min(counts, capacity).
    Two uses: the global rungs' substep force (receivers the active
    rungs, suppliers everyone, one mass) and a pair of components
    (``mass_sup`` the supplier's particle mass).  The capacities must
    cover each set's largest cell occupancy: a receiver beyond its
    capacity gets 0 and a supplier beyond it acts on nobody, as in the
    JAX package.  Returns G·m_recv·m_sup·acc (multiply by ᔑa⁻¹dt at
    use)."""
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep_subset

    M = recv_pos.shape[0]
    dtype = recv_pos.dtype
    n = n_cells
    C = n**3
    K_r = capacity_recv
    b_sup = bucketize(sup_pos.unbind(1), boxsize, n, capacity_sup)
    b_rec = bucketize(recv_pos.unbind(1), boxsize, n, K_r)
    big = SENTINEL * boxsize
    sup = torch.where(b_sup["valid"][None],
                      torch.stack([b_sup["hx"], b_sup["hy"], b_sup["hz"]]), big)
    sext = occupancy_bounds(b_sup["counts"], capacity_sup)
    del b_sup
    recv = torch.where(b_rec["valid"][None],
                       torch.stack([b_rec["hx"], b_rec["hy"], b_rec["hz"]]), big)
    sweep = pair_sweep_subset if n >= 3 else sweep_fold
    acc = sweep(recv, sup, n, boxsize, scale, dtype_square(cutoff, dtype),
                dtype_square(softening, dtype), kernel=softening_kernel,
                rext=occupancy_bounds(b_rec["counts"], K_r), sext=sext)
    del recv, sup
    accf = torch.cat([acc.reshape(3, K_r * C),
                      torch.zeros((3, 1), dtype=dtype, device=acc.device)], 1)
    coef = G * mass * (mass if mass_sup is None else mass_sup)
    out = torch.empty((M, 3), dtype=dtype, device=acc.device)
    out[b_rec["order"]] = coef * accf[:, b_rec["slot"]].T
    return out


def sweep_reach(hx, hy, hz, valid, n_cells: int, boxsize: float,
                scale: float, cutoff: float, softening: float,
                cell_width: float, margin: float, kernel: str = "plummer"):
    """The two-sided reach-2 sweep (port of ``sweep_pallas_reach``,
    concept_tpu/forces/pallas_shortrange.py): accelerations (3, K, C) of
    every slot from every slot of the kept reach-2 offset columns
    (:func:`reach_offsets`), receivers = suppliers = the sentinel-filled
    slots, no row bounds.  A launch of the one-sided reach kernel; like
    the TPU kernel, nothing in the package calls it yet."""
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep_reach

    slots = torch.where(valid[None], torch.stack([hx, hy, hz]),
                        SENTINEL * boxsize).contiguous()
    acc = pair_sweep_reach(slots, slots, n_cells, boxsize, scale,
                           dtype_square(cutoff, slots.dtype),
                           dtype_square(softening, slots.dtype),
                           reach_offsets(cell_width, margin), kernel=kernel)
    if slots.device.type == "cuda":
        _build.count_launch(sweep_reach, slots.dtype)
    return acc


sweep_reach.launches = 0
sweep_reach.launches_f64 = 0
