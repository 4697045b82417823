"""The port's one-sided short-range sweep (concept_tpu_torch.forces) vs
the JAX package's XLA sweep (_sweep_pair) and its Pallas kernels in
interpret mode (sweep_pallas_pair, flat and row-bounded).

Tolerance: max|Δ|/max|ref| < 1e-5, the Pallas-vs-XLA sweep metric of
tests/test_pallas_shortrange.py:41 (it absorbs the screening fit, ≤ 1e-6
on S, and float32 summation order).  Rows beyond a receiver bound must
be exactly 0."""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax.numpy as jnp  # noqa: E402

from concept_tpu.forces.pallas_shortrange import (  # noqa: E402
    _G_COEF as JAX_G_COEF, _lane_valid_packs, screening_g as jax_screening_g,
    sweep_pallas_pair,
)
from concept_tpu.forces.shortrange import (  # noqa: E402
    _sweep_pair as jax_sweep_pair, bucketize,
)
from concept_tpu_torch.forces.cuda_shortrange import (  # noqa: E402
    OFFSETS_27, column_bounds, pair_sweep, pair_sweep_reach,
)
from concept_tpu_torch.forces.shortrange import (  # noqa: E402
    _G_COEF, SENTINEL, _sweep_pair, screening_g,
)

TOL = 1e-5
DATA = os.path.join(os.path.dirname(__file__), "data")


def _maxrel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _port_sweep(b, n, box, scale, cutoff, soft, kernel):
    t = [torch.as_tensor(np.array(b[k])) for k in ("hx", "hy", "hz", "valid")]
    c2 = float(np.float32(cutoff) ** 2)
    s2 = float(np.float32(soft) ** 2)
    return _sweep_pair(*t, *t, n, box, scale, c2, s2, kernel=kernel).numpy()


def _jax_sweeps(b, n, box, scale, cutoff, soft, kernel):
    args = (b["hx"], b["hy"], b["hz"], b["valid"]) * 2
    xla = jax_sweep_pair(*args, n, jnp.float32(box), jnp.float32(scale),
                         jnp.float32(cutoff) ** 2, jnp.float32(soft) ** 2,
                         kernel=kernel)
    pallas = sweep_pallas_pair(*args, n, box, scale, cutoff, soft,
                               interpret=True, kernel=kernel)
    return np.asarray(xla), np.asarray(pallas)


def test_screening_fit_matches_jax():
    np.testing.assert_array_equal(_G_COEF, JAX_G_COEF)
    u = np.linspace(0, 25.0, 4001, dtype=np.float32)
    np.testing.assert_allclose(screening_g(torch.as_tensor(u)).numpy(),
                               np.asarray(jax_screening_g(jnp.asarray(u))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kernel", ["plummer", "spline", "none"])
def test_flat_sweep_matches_jax(kernel):
    """Clustered blobs + uniform background near the wrap (the inputs of
    tests/test_pallas_shortrange.py), all three softening kernels."""
    rng = np.random.default_rng(9)
    box, nc = 100.0, 5
    blob = rng.normal(50, 4.0, (150, 3))
    edge = rng.uniform(0, 10, (100, 3))
    pos = np.mod(np.concatenate([blob, edge]), box).astype(np.float32)
    counts = np.asarray(bucketize(jnp.asarray(pos), box, nc, 8)["counts"])
    K = -(-int(counts.max()) // 8) * 8
    b = bucketize(jnp.asarray(pos), box, nc, K)
    scale, cutoff, soft = 4.0, 18.0, 0.5
    got = _port_sweep(b, nc, box, scale, cutoff, soft, kernel)
    xla, pallas = _jax_sweeps(b, nc, box, scale, cutoff, soft, kernel)
    v = np.asarray(b["valid"])
    assert _maxrel(got[:, v], xla[:, v]) < TOL
    assert _maxrel(got[:, v], pallas[:, v]) < TOL
    assert np.all(got[:, ~v] == 0)


def test_oracle_8cube_sweep_matches_jax():
    """The 8³ PP oracle's initial positions, spline softening, mesh-32
    split (tests/data/oracle_pp_8cube.npz)."""
    d = np.load(os.path.join(DATA, "oracle_pp_8cube.npz"))
    box = float(d["boxsize"])
    pos = np.mod(d["ic_pos"], box).astype(np.float32)
    scale = 1.25 * box / 32
    cutoff = 4.5 * scale
    nc = int(box / cutoff)
    K = 32
    b = bucketize(jnp.asarray(pos), box, nc, K)
    assert nc >= 3 and int(np.asarray(b["counts"]).max()) <= K
    soft = float(d["softening"])
    got = _port_sweep(b, nc, box, scale, cutoff, soft, "spline")
    xla, pallas = _jax_sweeps(b, nc, box, scale, cutoff, soft, "spline")
    v = np.asarray(b["valid"])
    assert _maxrel(got[:, v], xla[:, v]) < TOL
    assert _maxrel(got[:, v], pallas[:, v]) < TOL


def _layout(rng, n, K, box):
    """Random prefix-valid sentinel layout + per-pencil extents (the
    construction of tests/test_bounded_sweep.py)."""
    C = n**3
    counts = rng.integers(0, K + 1, size=C)
    valid = np.arange(K)[:, None] < counts[None, :]
    ci, cj, ck = np.arange(C) // (n * n), (np.arange(C) // n) % n, np.arange(C) % n
    cw = box / n
    base = np.stack([ci * cw, cj * cw, ck * cw])
    pos = base[:, None, :] + rng.random((3, K, C)) * cw
    s = np.where(valid[None], pos, SENTINEL * box).astype(np.float32)
    ext = counts.reshape(n * n, n).max(axis=1).astype(np.int32)
    return s, valid, ext


@functools.lru_cache(maxsize=None)
def _bounded_xla(kernel):
    """The XLA ``_sweep_pair`` of test_bounded_sweep_matches_jax's layout,
    which takes no bounds: computed once a kernel for its three bounds
    cases (each call traces and compiles anew)."""
    s, valid, _ = _layout(np.random.default_rng(3), 16, 16, 1.0)
    sj = [jnp.asarray(a) for a in s]
    vj = jnp.asarray(valid)
    return np.asarray(jax_sweep_pair(
        *sj, vj, *sj, vj, 16, jnp.float32(1.0), jnp.float32(0.012),
        jnp.float32(0.054) ** 2, jnp.float32(0.004) ** 2, kernel=kernel))


@pytest.mark.parametrize("kernel", ["plummer", "spline"])
@pytest.mark.parametrize("bounds", ["full_K", "occupancy", "restricted"])
def test_bounded_sweep_matches_jax(kernel, bounds):
    """Row-bounded sweep on a dense random layout.  Rows beyond a bound
    are exactly 0; rows inside it match the XLA ``_sweep_pair`` and the
    Pallas bounded kernel."""
    rng = np.random.default_rng(3)
    n, K, box = 16, 16, 1.0
    s, valid, ext = _layout(rng, n, K, box)
    assert _lane_valid_packs(n, n**3)  # the Pallas bounded kernel applies
    scale, cutoff, soft = 0.012, 0.054, 0.004
    sext = ext
    if bounds == "full_K":
        rext = sext = np.full(n * n, K, np.int32)
    elif bounds == "occupancy":
        rext = ext
    else:
        rc = rng.integers(0, K // 2, size=n**3) * (rng.random(n**3) < 0.3)
        rext = rc.reshape(n * n, n).max(axis=1).astype(np.int32)
    sj = [jnp.asarray(a) for a in s]
    vj = jnp.asarray(valid)
    pallas = np.asarray(sweep_pallas_pair(
        *sj, vj, *sj, vj, n, box, scale, cutoff, soft, interpret=True,
        kernel=kernel, sentineled=True, rext=jnp.asarray(rext),
        sext=jnp.asarray(sext)))
    xla = _bounded_xla(kernel)
    st = torch.as_tensor(s)
    got = pair_sweep(st, st, n, box, scale, float(np.float32(cutoff) ** 2),
                     float(np.float32(soft) ** 2), kernel=kernel,
                     rext=torch.as_tensor(rext), sext=torch.as_tensor(sext)).numpy()
    rb = np.minimum(rext, K)[np.arange(n**3) // n]
    inside = (np.arange(K)[:, None] < rb[None, :]) & valid
    beyond = np.arange(K)[:, None] >= rb[None, :]
    assert inside.any()
    assert _maxrel(got[:, inside], xla[:, inside]) < TOL
    assert _maxrel(got[:, inside], pallas[:, inside]) < TOL
    assert np.all(got[:, beyond] == 0)
    if bounds != "restricted":
        # true extents: the Pallas kernel's window bounds (a max over
        # packed pencils) cover the same valid rows
        assert np.all(pallas[:, beyond] == 0)


def test_window_bounds_match_jax_at_pack_1():
    """The port's per-column bounds against the Pallas kernel's per-window
    bounds at pack factor 1: a column's receiver bound is its pencil's
    window bound, and the largest supplier bound over its 27 neighbour
    columns is its pencil's supplier window bound (the 9 pencils around
    it), so both kernels read the same valid rows."""
    from concept_tpu.forces.pallas_shortrange import _window_bounds

    rng = np.random.default_rng(1)
    n = 6
    ext = rng.integers(0, 20, size=n * n).astype(np.int32)
    col = column_bounds(torch.as_tensor(ext), n).numpy().reshape(n, n, n)
    recv, sup = (np.asarray(_window_bounds(jnp.asarray(ext), n, 1, nb)).reshape(n, n, 1)
                 for nb in (False, True))
    np.testing.assert_array_equal(col, np.broadcast_to(recv, col.shape))
    # neighbour (di, dj, dk) of column (i, j, k) is ((i+di) % n, ...)
    nb_max = np.max([np.roll(col, (-di, -dj, -dk), (0, 1, 2))
                     for di, dj, dk in OFFSETS_27], axis=0)
    np.testing.assert_array_equal(nb_max, np.broadcast_to(sup, col.shape))


def _fold_positions(rng, box, N):
    """Uniform particles with a quarter of them within 2 % of a box face,
    where the minimum image decides which image a pair meets at."""
    pos = rng.uniform(0, box, (N, 3))
    pos[: N // 4, 0] = rng.uniform(-0.02, 0.02, N // 4) * box
    return np.mod(pos, box).astype(np.float32)


@pytest.mark.parametrize("nc", [1, 2])
@pytest.mark.parametrize("kernel", ["plummer", "spline"])
def test_fold_sweep_matches_jax(nc, kernel):
    """Below 3 cells a side the port's sweep is the folded one with
    minimum image: one-sided (``_sweep_pair``) against the JAX package's
    ``_sweep_pair`` and two-sided (``sweep_fold`` with receivers =
    suppliers) against its ``_sweep(halve=False)``."""
    from concept_tpu.forces.shortrange import _sweep as jax_sweep
    from concept_tpu_torch.forces.shortrange import sweep_fold

    rng = np.random.default_rng(21 + nc)
    box, N = 64.0, 300
    cutoff = 0.97 * box / nc if nc == 2 else 0.6 * box
    scale, soft = cutoff / 4.5, 0.5
    pos = _fold_positions(rng, box, N)
    b = bucketize(jnp.asarray(pos), box, nc, N)
    assert int(box / cutoff) == nc
    got = _port_sweep(b, nc, box, scale, cutoff, soft, kernel)
    xla = np.asarray(jax_sweep_pair(
        *(b["hx"], b["hy"], b["hz"], b["valid"]) * 2, nc, jnp.float32(box),
        jnp.float32(scale), jnp.float32(cutoff) ** 2, jnp.float32(soft) ** 2,
        kernel=kernel))
    v = np.asarray(b["valid"])
    assert _maxrel(got[:, v], xla[:, v]) < TOL
    assert np.all(got[:, ~v] == 0)
    two = np.asarray(jax_sweep(b["hx"], b["hy"], b["hz"], b["valid"], nc,
                               jnp.float32(box), jnp.float32(scale),
                               jnp.float32(cutoff) ** 2, jnp.float32(soft) ** 2,
                               halve=False, kernel=kernel))
    s = torch.as_tensor(np.where(v[None], np.stack([np.asarray(b[k]) for k in
                                                    ("hx", "hy", "hz")]),
                                 SENTINEL * box).astype(np.float32))
    got2 = sweep_fold(s, s, nc, box, scale, float(np.float32(cutoff) ** 2),
                      float(np.float32(soft) ** 2), kernel=kernel).numpy()
    assert _maxrel(got2[:, v], two[:, v]) < TOL


@pytest.mark.parametrize("capacity", [8, 400])
def test_global_fold_with_stragglers_matches_jax(capacity):
    """The global stepper's short range at 2 cells a side, with and
    without particles beyond the capacity (the JAX package's folded sweep
    plus its straggler path), against shortrange_momentum_updates of the
    JAX package; the straggler count is equal."""
    from concept_tpu.forces.shortrange import (
        shortrange_momentum_updates as jax_updates,
    )
    from concept_tpu_torch.forces.shortrange import shortrange_momentum_updates

    rng = np.random.default_rng(5)
    box, N, nc = 64.0, 300, 2
    cutoff = 0.97 * box / nc
    scale, soft = cutoff / 4.5, 0.5
    pos = _fold_positions(rng, box, N)
    args = (2.0, box, scale, cutoff, 1e-3)
    ref, n_ref = jax_updates(jnp.asarray(pos), *args, n_cells=nc, capacity=capacity,
                             softening=soft, return_overflow=True,
                             softening_kernel="spline")
    got, n_got = shortrange_momentum_updates(
        tuple(torch.as_tensor(pos[:, d]) for d in range(3)), *args, n_cells=nc,
        capacity=capacity, softening=soft, softening_kernel="spline")
    assert n_got == int(n_ref) == (N - 8 * capacity if capacity == 8 else 0)
    got = torch.stack(got, 1).numpy()
    assert _maxrel(got, np.asarray(ref)) < TOL


@pytest.mark.parametrize("nc", [2, 5])
def test_on_subset_matches_jax(nc):
    """shortrange_momentum_updates_on_subset: receivers (a subset with
    their own capacity) against all suppliers, at 5 cells a side (the
    ±1 sweep) and at 2 (folded), and with a supplier mass of its own."""
    from concept_tpu.forces.shortrange import (
        cell_counts, shortrange_momentum_updates_on_subset as jax_on_subset,
    )
    from concept_tpu_torch.forces.shortrange import (
        shortrange_momentum_updates_on_subset,
    )

    rng = np.random.default_rng(11)
    box, N = 64.0, 400
    cutoff = 0.97 * box / nc
    scale, soft = cutoff / 4.5, 0.5
    sup = _fold_positions(rng, box, N)
    recv = sup[rng.choice(N, 120, replace=False)]
    caps = [int(-(-(np.asarray(cell_counts(jnp.asarray(p), box, nc)).max() + 1) // 8) * 8)
            for p in (recv, sup)]
    for mass_sup in (None, 3.0):
        kw = dict(n_cells=nc, capacity_recv=caps[0], capacity_sup=caps[1],
                  softening=soft, G=1.5, softening_kernel="plummer", mass_sup=mass_sup)
        ref = np.asarray(jax_on_subset(jnp.asarray(recv), jnp.asarray(sup), 2.0, box,
                                       scale, cutoff, **kw))
        got = shortrange_momentum_updates_on_subset(
            torch.as_tensor(recv), torch.as_tensor(sup), 2.0, box, scale, cutoff,
            **kw).numpy()
        assert _maxrel(got, ref) < TOL


def _rank_planes_slots(s, occ, n, d, r, width, box):
    """Rank r's planes of the column layout s (3, K, n³) over d ranks
    (parallel/step.plane_starts) between ``width`` neighbour planes a side,
    those across a box face shifted by ∓box, as halo_planes gives them:
    (slots, receiver bounds (0 on the neighbour planes), supplier bounds,
    first plane, planes)."""
    from concept_tpu_torch.parallel.step import plane_starts

    P = n * n
    starts = plane_starts(n, d)
    x0, npl = starts[r], starts[r + 1] - starts[r]
    planes = np.arange(x0 - width, x0 + npl + width)
    idx = ((planes % n)[:, None] * P + np.arange(P)[None]).reshape(-1)
    sup = s[:, :, idx].copy()
    sup[0] += np.repeat(np.where(planes < 0, -box, np.where(planes >= n, box, 0.0)),
                        P)[None].astype(sup.dtype)
    rext = occ[idx].copy()
    rext[:width * P] = rext[-width * P:] = 0
    return sup, rext, occ[idx].copy(), x0, npl


@pytest.mark.parametrize("d", [1, 2, 4, 3])
def test_planes_sweep_equals_the_whole(d):
    """The sweep's nx contract (the rung stepper over d ranks): rank r's
    planes of columns (nc/d, or split unevenly: 1 + 2 + 1 at d = 3)
    between its two neighbour planes (nx = planes + 2, each neighbour
    plane across the box face shifted by ∓box, receiver bounds 0 there,
    supplier bounds the owners') give its planes' rows of the whole nc³
    sweep.  Slots of the first and last planes sit across the faces
    (wrapped to the far side since their bucketing), as a drift leaves
    them."""
    rng = np.random.default_rng(7)
    n, K, box = 4, 8, 1.0
    scale, cutoff, soft = 0.06, 0.24, 0.02
    s, valid, _ = _layout(rng, n, K, box)
    P = n * n
    plane = np.arange(n**3) // P
    s[0][valid & (plane == 0)[None] & (rng.random((K, n**3)) < 0.3)] = box - 0.01
    s[0][valid & (plane == n - 1)[None] & (rng.random((K, n**3)) < 0.3)] = 0.01
    occ = valid.sum(0).astype(np.int32)
    st = torch.as_tensor(s)
    args = (box, scale, float(np.float32(cutoff) ** 2), float(np.float32(soft) ** 2))
    whole = pair_sweep(st, st, n, *args, kernel="spline", rext=torch.as_tensor(occ),
                       sext=torch.as_tensor(occ)).numpy()
    for r in range(d):
        sup, rext, sext, x0, npl = _rank_planes_slots(s, occ, n, d, r, 1, box)
        sup_t = torch.as_tensor(sup)
        got = pair_sweep(sup_t, sup_t, n, *args, kernel="spline", rext=torch.as_tensor(rext),
                         sext=torch.as_tensor(sext), nx=npl + 2).numpy()
        ref = whole[:, :, x0 * P:(x0 + npl) * P]
        np.testing.assert_allclose(got[:, :, P:-P], ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(whole).max())
        assert np.all(got[:, :, :P] == 0) and np.all(got[:, :, -P:] == 0)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_reach_planes_sweep_equals_the_whole(d):
    """Row 5's nx contract (the 4-mesh-cell layout over d ranks): rank r's
    planes of the nc = 7 columns a side (7; 4 + 3; 2 + 3 + 2) between two
    neighbour planes a side (nx = planes + 4), receivers at the opposite
    sentinel, give its planes' rows of the whole reach-2 sweep over the
    117 kept offsets; slots of the first and last planes sit across both
    faces."""
    from concept_tpu_torch.forces.shortrange import reach_offsets

    rng = np.random.default_rng(11)
    n, K, box = 7, 8, 1.0
    cw = box / n
    offsets = reach_offsets(cw, 0.55 * cw / 4.0)
    scale = 1.25 * cw / 4.0
    cutoff, soft = 4.5 * scale, 0.03 * cw
    s, valid, _ = _layout(rng, n, K, box)
    P = n * n
    plane = np.arange(n**3) // P
    s[0][valid & (plane == 0)[None] & (rng.random((K, n**3)) < 0.3)] = box - 0.1 * cw
    s[0][valid & (plane == n - 1)[None] & (rng.random((K, n**3)) < 0.3)] = 0.1 * cw
    occ = valid.sum(0).astype(np.int32)
    recv = np.where(valid[None], s, -SENTINEL * box).astype(np.float32)
    args = (box, scale, float(np.float32(cutoff) ** 2), float(np.float32(soft) ** 2), offsets)
    occ_t = torch.as_tensor(occ)
    whole = pair_sweep_reach(torch.as_tensor(recv), torch.as_tensor(s), n, *args,
                             kernel="spline", rext=occ_t, sext=occ_t).numpy()
    assert np.abs(whole).max() > 0
    for r in range(d):
        sup, rext, sext, x0, npl = _rank_planes_slots(s, occ, n, d, r, 2, box)
        rcv = np.where(np.abs(sup) < 0.5 * SENTINEL * box, sup, -SENTINEL * box)
        got = pair_sweep_reach(torch.as_tensor(rcv), torch.as_tensor(sup), n, *args,
                               kernel="spline", rext=torch.as_tensor(rext),
                               sext=torch.as_tensor(sext), nx=npl + 4).numpy()
        ref = whole[:, :, x0 * P:(x0 + npl) * P]
        np.testing.assert_allclose(got[:, :, 2 * P:-2 * P], ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(whole).max())
        assert np.all(got[:, :, :2 * P] == 0) and np.all(got[:, :, -2 * P:] == 0)
