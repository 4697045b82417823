"""The global stepper's force modules (concept_tpu_torch.forces.p3m,
forces.shortrange, grid.cuda_blocks) vs the JAX package on the CPU: the
short-range momentum updates against its Pallas sweep (interpret mode)
and its XLA sweep, the block deposit and gather against the Pallas
position kernels (interpret mode), and the long-range and full P³M kicks.

Tolerances: the sweep max|Δ|/max|ref| < 1e-5 (tests/test_pallas_shortrange.py:41:
the screening fit and float32 summation order); deposit and gather
rtol 2e-5, atol 1e-5·max|ref| (tests/test_pallas_cells.py:62: float32 sums
in another order); the PM and P³M kicks atol 5e-6 and 1e-5 of the JAX
package's own fused-vs-plain tests (tests/test_p3m_fused.py).  Overflow
counts are integers and must match exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax.numpy as jnp  # noqa: E402

from concept_tpu.forces.p3m import (  # noqa: E402
    p3m_kick_components as jax_p3m_kick, pm_block_capacity as jax_pm_block_capacity,
    pm_longrange_components as jax_pm_longrange,
)
from concept_tpu.forces.shortrange import (  # noqa: E402
    auto_capacity as jax_auto_capacity, bucketize as jax_bucketize,
    cell_counts as jax_cell_counts, cell_grid_shape as jax_cell_grid_shape,
    shortrange_momentum_updates as jax_sr_updates,
)
from concept_tpu.grid.interp import deposit as jax_deposit  # noqa: E402
from concept_tpu.grid.pallas_pm import (  # noqa: E402
    deposit_pallas_pos, gather_pallas_pos,
)
from concept_tpu_torch.forces.p3m import (  # noqa: E402
    p3m_kick_components, pm_block_capacity, pm_longrange_components,
)
from concept_tpu_torch.forces.shortrange import (  # noqa: E402
    auto_capacity, bucketize, cell_counts, cell_grid_shape,
    shortrange_momentum_updates,
)
from concept_tpu_torch.grid.cuda_blocks import deposit_blocks, gather_blocks  # noqa: E402
from concept_tpu_torch.grid.cuda_cells import cell_geometry  # noqa: E402

SWEEP_TOL = 1e-5
GRID_TOL = dict(rtol=2e-5)


def _maxrel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _clustered(seed=9, box=100.0):
    """A blob and a uniform patch across the wrap (the inputs of
    tests/test_pallas_shortrange.py): cells of the blob hold far more
    than the mean occupancy."""
    rng = np.random.default_rng(seed)
    blob = rng.normal(50, 4.0, (150, 3))
    edge = rng.uniform(0, 10, (100, 3))
    return np.mod(np.concatenate([blob, edge]), box).astype(np.float32), box


def _lattice(n=16, seed=7, box=64.0):
    """n³ perturbed lattice (tests/test_p3m_fused.py's setup at n = 16)."""
    rng = np.random.default_rng(seed)
    lin = (np.arange(n) + 0.5) * (box / n)
    pos = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    pos += rng.standard_normal(pos.shape) * (0.45 * box / n)
    return np.mod(pos, box).astype(np.float32), box


def _torch_comps(pos):
    return tuple(torch.as_tensor(np.ascontiguousarray(pos[:, d])) for d in range(3))


def _jax_comps(pos):
    return tuple(jnp.asarray(pos[:, d]) for d in range(3))


def test_cell_helpers_match_jax():
    pos, box = _clustered()
    cutoff = 18.0
    nc = cell_grid_shape(box, cutoff)
    assert nc == jax_cell_grid_shape(box, cutoff)
    assert auto_capacity(len(pos), nc) == jax_auto_capacity(len(pos), nc)
    np.testing.assert_array_equal(cell_counts(torch.as_tensor(pos), box, nc).numpy(),
                                  np.asarray(jax_cell_counts(jnp.asarray(pos), box, nc)))
    assert pm_block_capacity(4096, 32) == jax_pm_block_capacity(4096, 32)
    assert pm_block_capacity(256**3, 512) == jax_pm_block_capacity(256**3, 512)


def test_bucketize_matches_jax():
    """Slot layout, order, cell, rank and counts are integers: equal."""
    pos, box = _clustered()
    nc, K = 5, 16
    got = bucketize(_torch_comps(pos), box, nc, K)
    ref = jax_bucketize(_jax_comps(pos), box, nc, K)
    for k in ("valid", "order", "cell", "rank", "counts", "starts"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k in ("hx", "hy", "hz", "px", "py", "pz"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert int((got["rank"] >= K).sum()) > 0  # stragglers exist


@pytest.mark.parametrize("kernel,capacity,engines", [
    ("spline", "stragglers", ("pallas", "xla")),
    ("plummer", "stragglers", ("xla",)),
    ("none", "stragglers", ("xla",)),
    ("spline", "over_budget", ("xla",)),
])
def test_shortrange_updates_match_jax(kernel, capacity, engines):
    """Two-sided sweep + straggler path + unsort against the JAX engines
    (its Pallas sweep in interpret mode costs ~8 s a case here, so it
    runs for the default softening).  'stragglers': a capacity below the
    largest occupancy, so the exact straggler path runs; 'over_budget':
    also more stragglers than the fixed budget, which both packages
    truncate alike."""
    pos, box = _clustered()
    scale, cutoff, soft, mass, G, kick = 4.0, 18.0, 0.5, 1.3, 0.7, 0.01
    nc = cell_grid_shape(box, cutoff)
    K, budget = {"stragglers": (16, 2048), "over_budget": (16, 24)}[capacity]
    dm, n_over = shortrange_momentum_updates(
        _torch_comps(pos), mass, box, scale, cutoff, kick, n_cells=nc, capacity=K,
        softening=soft, G=G, max_overflow=budget, softening_kernel=kernel)
    got = torch.stack(dm, 1).numpy()
    expect_over = max(0, int(np.maximum(np.asarray(
        jax_cell_counts(jnp.asarray(pos), box, nc)) - K, 0).sum()))
    assert n_over == expect_over
    assert 0 < n_over and (n_over > budget) == (capacity == "over_budget")
    for engine in engines:
        ref, n_ref = jax_sr_updates(
            jnp.asarray(pos), mass, box, scale, cutoff, kick, n_cells=nc,
            capacity=K, softening=soft, G=G, max_overflow=budget,
            return_overflow=True, engine=engine, softening_kernel=kernel)
        assert int(n_ref) == n_over
        assert _maxrel(got, np.asarray(ref)) < SWEEP_TOL, engine


def _block_slots(pos, n, box, K):
    """The z-major block slots of forces/p3m.py, built in numpy: (3, K, C)
    positions (0 in empty slots), valid (K, C)."""
    nb = n // 2
    C = nb**3
    h = box / n
    blk = np.clip((pos / np.float32(h)).astype(np.int32), 0, n - 1) // 2
    key = (blk[:, 2] * nb + blk[:, 1]) * nb + blk[:, 0]
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=C)
    assert counts.max() <= K
    starts = np.cumsum(counts) - counts
    rank = np.arange(len(pos)) - starts[key[order]]
    slots = np.zeros((3, K, C), np.float32)
    slots[:, rank, key[order]] = pos[order].T
    valid = np.arange(K)[:, None] < counts[None, :]
    return slots, valid


def _block_inputs(seed=3, n=32, box=2.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, (1500, 3)).astype(np.float32)
    slots, valid = _block_slots(pos, n, box, K=8)
    return rng, pos, slots, valid


def _jax_slots(slots, w):
    return [jnp.asarray(a) for a in (*slots, w)]


def test_block_deposit_matches_jax():
    n, box, mass = 32, 2.0, 1.7
    _, pos, slots, valid = _block_inputs(n=n, box=box)
    w = valid.astype(np.float32) * mass
    got = deposit_blocks(*torch.as_tensor(slots), torch.as_tensor(w), n, box).numpy()
    pallas = np.asarray(deposit_pallas_pos(*_jax_slots(slots, w), n, box, interpret=True))
    exact = np.asarray(jax_deposit(jnp.asarray(pos), mass, n, box, order=2))
    np.testing.assert_allclose(got, pallas, atol=1e-5 * np.abs(pallas).max(), **GRID_TOL)
    np.testing.assert_allclose(got, exact, atol=1e-5 * np.abs(exact).max(), **GRID_TOL)


def test_block_gather_matches_jax():
    n, box = 32, 2.0
    rng, _, slots, valid = _block_inputs(seed=5, n=n, box=box)
    grids = rng.standard_normal((3, n, n, n)).astype(np.float32)
    w = valid.astype(np.float32)
    got = gather_blocks(*torch.as_tensor(slots), torch.as_tensor(w),
                        torch.as_tensor(grids), n, box)
    ref = gather_pallas_pos(*_jax_slots(slots, w), tuple(jnp.asarray(g) for g in grids),
                            n, box, interpret=True)
    for d in range(3):
        r = np.asarray(ref[d])
        np.testing.assert_allclose(got[d].numpy(), r, atol=1e-5 * np.abs(r).max(),
                                   **GRID_TOL)
    assert all(np.all(g.numpy()[~valid] == 0) for g in got)


def test_block_slot_across_box_face():
    """A slot of the last x block whose position was wrapped to the far
    side of the box since bucketing: the port's periodic halo test keeps
    it, as the exact CIC deposit does; the Pallas kernel's is not
    periodic and drops it (its deposit falls one weight short)."""
    n, box, mass = 32, 2.0, 0.5
    _, pos, slots, valid = _block_inputs(seed=12, n=n, box=box)
    nb = n // 2
    C = nb**3
    cols = np.flatnonzero(valid[0] & (np.arange(C) % nb == nb - 1))
    c = int(cols[0])
    i = int(np.flatnonzero(np.all(pos == slots[:, 0, c], axis=1))[0])
    pos[i, 0] = slots[0, 0, c] = np.float32(0.3 * box / n)
    w = valid.astype(np.float32) * mass
    got = deposit_blocks(*torch.as_tensor(slots), torch.as_tensor(w), n, box).numpy()
    exact = np.asarray(jax_deposit(jnp.asarray(pos), mass, n, box, order=2))
    np.testing.assert_allclose(got, exact, atol=1e-5 * np.abs(exact).max(), **GRID_TOL)
    pallas = np.asarray(deposit_pallas_pos(*_jax_slots(slots, w), n, box, interpret=True))
    np.testing.assert_allclose(pallas.sum(), (valid.sum() - 1) * mass, rtol=1e-5)
    grids = np.random.default_rng(0).standard_normal((1, n, n, n)).astype(np.float32)
    g = gather_blocks(*torch.as_tensor(slots), torch.as_tensor(valid.astype(np.float32)),
                      torch.as_tensor(grids), n, box).numpy()
    assert g[0, 0, c] != 0


def test_blocks_built_from_wrapped_positions_are_in_both_halos():
    """forces/p3m.py builds its blocks from wrapped positions at every
    kick, so every slot's CIC anchor lies in its block ±1 cell without
    the periodic wrap too: the port's periodic test and the TPU kernels'
    plain one keep the same slots.  Positions on and next to every block
    face, and at the box's edges, included."""
    n, box = 32, 2.0
    h = np.float32(box / n)
    faces = (np.arange(n + 1) * h).astype(np.float32)
    near = np.concatenate([faces, np.nextafter(faces, np.float32(0)),
                           np.nextafter(faces, np.float32(box)),
                           np.float32([0.0, box])])
    near = near[(near >= 0) & (near < np.float32(box))]
    rng = np.random.default_rng(4)
    pos = rng.choice(near, (4000, 3)).astype(np.float32)
    key = np.clip((pos / h).astype(np.int32), 0, n - 1) // 2
    _, counts = np.unique((key[:, 2] * 16 + key[:, 1]) * 16 + key[:, 0], return_counts=True)
    slots, valid = _block_slots(pos, n, box, K=int(-(-counts.max() // 8) * 8))
    st = torch.as_tensor(slots)
    nb = n // 2
    anchors, _, periodic = cell_geometry(st, slice(0, nb**3), nb, 2, n / box, zmajor=True)
    cells = torch.arange(nb**3)
    plain = torch.ones_like(periodic)
    for a, b in zip(anchors, (cells % nb, (cells // nb) % nb, cells // (nb * nb))):
        lrel = a - b * 2 + 1
        plain &= (lrel >= 0) & (lrel <= 2)
    v = torch.as_tensor(valid)
    assert bool(periodic[v].all()) and bool(plain[v].all())


@pytest.mark.parametrize("case", ["uniform", "overflow"])
def test_pm_longrange_matches_jax(case):
    """The long-range kick; 'overflow' puts a blob of 64 particles into
    one block at k_pm = 8, so the exact overflow path runs (the setup of
    tests/test_p3m_fused.py)."""
    pos, box = _lattice()
    mesh, mass, G, kick = 32, 2.0, 1.0, 1e-3
    scale = 1.25 * box / mesh
    k_pm = pm_block_capacity(len(pos), mesh)
    if case == "overflow":
        pos[:64] = np.float32(10.0) + np.random.default_rng(0).uniform(
            0, 0.5, (64, 3)).astype(np.float32)
        k_pm = 8
    dm, n_over, mass_sum = pm_longrange_components(
        *_torch_comps(pos), mass, box, G, kick, mesh, scale, k_pm=k_pm)
    ref, n_ref = jax_pm_longrange(*_jax_comps(pos), mass, box, G, kick, mesh, scale,
                                  k_pm=k_pm, interpret=True)
    assert n_over == int(n_ref)
    assert (n_over > 0) == (case == "overflow")
    got = torch.stack(dm, 1).numpy()
    np.testing.assert_allclose(got, np.stack([np.asarray(r) for r in ref], 1),
                               rtol=0, atol=5e-6)
    assert float(mass_sum) == pytest.approx(len(pos) * mass, rel=1e-6)


def test_p3m_kick_matches_jax():
    """Short range (against the XLA sweep; the Pallas one is held above)
    plus long range, with stragglers and PM overflow both present."""
    pos, box = _lattice(12)
    pos[:64] = np.float32(10.0) + np.random.default_rng(0).uniform(
        0, 0.5, (64, 3)).astype(np.float32)
    mesh, mass, G, kick = 32, 2.0, 1.0, 1e-3
    scale = 1.25 * box / mesh
    cutoff = 4.5 * scale
    nc = cell_grid_shape(box, cutoff)
    K = auto_capacity(len(pos), nc)
    dm, n_sr, n_pm, _ = p3m_kick_components(
        *_torch_comps(pos), mass, box, scale, cutoff, kick, mesh, nc, K,
        k_pm=8, softening=0.05, G=G, softening_kernel="spline")
    ref, n_sr_ref, n_pm_ref = jax_p3m_kick(
        *_jax_comps(pos), mass, box, scale, cutoff, kick, mesh, nc, K, k_pm=8,
        softening=0.05, G=G, engine="xla", interpret=True,
        softening_kernel="spline")
    assert (n_sr, n_pm) == (int(n_sr_ref), int(n_pm_ref))
    assert n_sr > 0 and n_pm > 0
    got = torch.stack(dm, 1).numpy()
    np.testing.assert_allclose(got, np.stack([np.asarray(r) for r in ref], 1),
                               rtol=0, atol=1e-5)
