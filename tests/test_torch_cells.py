"""The port's CIC deposit and gather on the (K, C) cell layout
(concept_tpu_torch.grid.cuda_cells, cells 8 mesh cells wide) vs the JAX
package's Pallas cell kernels in interpret mode (deposit_pallas_cells /
gather_pallas_cells, cb = 8) and its exact scatter/gather interpolation
(grid/interp.deposit / gather).

Tolerance: rtol 2e-5 / atol 1e-5, the kernel-vs-exact metric of
tests/test_pallas_cells.py:62 (float32 sums in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax.numpy as jnp  # noqa: E402

from concept_tpu.grid.interp import deposit, gather  # noqa: E402
from concept_tpu.grid.pallas_cells import (  # noqa: E402
    LANES, deposit_pallas_cells, gather_pallas_cells,
)
from concept_tpu_torch.grid.cuda_cells import (  # noqa: E402
    deposit_cells, gather_cells,
)

CB = 8
TOL = dict(rtol=2e-5, atol=1e-5)


def _layout(rng, n, box, per_cell):
    """Uniform particles bucketed into the (K, C) layout by the mesh-index
    cell rule of the rung stepper (floor(p·n/box)//8, x-major ids).
    Returns (pos (N, 3), slot positions (3, K, C), valid (K, C), slot of
    each particle (N,) as (row, col))."""
    nc = n // CB
    C = nc**3
    N = per_cell * C
    pos = rng.uniform(0, box, (N, 3)).astype(np.float32)
    ijk = np.clip(np.floor(pos * np.float32(n / box)).astype(np.int64) // CB,
                  0, nc - 1)
    cell = (ijk[:, 0] * nc + ijk[:, 1]) * nc + ijk[:, 2]
    order = np.argsort(cell, kind="stable")
    counts = np.bincount(cell, minlength=C)
    K = -(-int(counts.max()) // 8) * 8
    starts = np.cumsum(counts) - counts
    row = np.empty(N, np.int64)
    row[order] = np.arange(N) - starts[cell[order]]
    slots = np.zeros((3, K, C), np.float32)
    slots[:, row, cell] = pos.T
    valid = np.zeros((K, C), bool)
    valid[row, cell] = True
    return pos, slots, valid, (row, cell)


def _jax_cells(slots, w):
    """Pad the columns to the Pallas lane multiple."""
    C = w.shape[1]
    pad = ((0, 0), (0, -(-C // LANES) * LANES - C))
    return [jnp.asarray(np.pad(a, pad)) for a in (*slots, w)]


@pytest.mark.parametrize("n", [16, 32])
def test_deposit_matches_jax(n):
    box, mass = 2.0, 1.7
    rng = np.random.default_rng(3)
    pos, slots, valid, _ = _layout(rng, n, box, per_cell=12)
    w = valid.astype(np.float32) * mass
    got = deposit_cells(torch.as_tensor(slots), torch.as_tensor(w), n, box,
                        cb=CB).numpy()
    pallas = np.asarray(deposit_pallas_cells(*_jax_cells(slots, w), n, box,
                                             cb=CB, interpret=True))
    exact = np.asarray(deposit(jnp.asarray(pos), mass, n, box, order=2))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, exact, **TOL)


@pytest.mark.parametrize("n", [16, 32])
def test_gather_matches_jax(n):
    box = 3.0
    rng = np.random.default_rng(7)
    pos, slots, valid, (row, cell) = _layout(rng, n, box, per_cell=10)
    grids = rng.standard_normal((3, n, n, n)).astype(np.float32)
    w = valid.astype(np.float32)
    got = gather_cells(torch.as_tensor(slots), torch.as_tensor(w),
                       torch.as_tensor(grids), n, box, cb=CB).numpy()
    C = valid.shape[1]
    pallas = gather_pallas_cells(*_jax_cells(slots, w),
                                 tuple(jnp.asarray(g) for g in grids), n, box,
                                 cb=CB, interpret=True)
    for d in range(3):
        np.testing.assert_allclose(got[d], np.asarray(pallas[d])[:, :C], **TOL)
        exact = np.asarray(gather(jnp.asarray(grids[d]), jnp.asarray(pos), box,
                                  order=2))
        np.testing.assert_allclose(got[d][row, cell], exact, **TOL)
    assert np.all(got[:, ~valid] == 0)


def test_slot_outside_halo_is_dropped():
    """A slot moved 2 mesh cells past its cell's face leaves the ±1-cell
    halo: both packages drop it from the deposit (the mass falls short by
    its weight) and gather 0 for it."""
    n, box, mass = 32, 4.0, 0.5
    rng = np.random.default_rng(11)
    _, slots, valid, (row, cell) = _layout(rng, n, box, per_cell=8)
    r, c = int(row[0]), int(cell[0])
    nc = n // CB
    cx = c // (nc * nc)
    h = box / n
    slots[0, r, c] = ((cx + 1) * CB + 1.7) * h % box  # > 1 mesh cell out
    w = valid.astype(np.float32) * mass
    st, wt = torch.as_tensor(slots), torch.as_tensor(w)
    got = deposit_cells(st, wt, n, box, cb=CB).numpy()
    pallas = np.asarray(deposit_pallas_cells(*_jax_cells(slots, w), n, box,
                                             cb=CB, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    expect = (valid.sum() - 1) * mass
    np.testing.assert_allclose(got.sum(), expect, rtol=1e-5)
    np.testing.assert_allclose(pallas.sum(), expect, rtol=1e-5)
    grids = rng.standard_normal((3, n, n, n)).astype(np.float32)
    g = gather_cells(st, torch.as_tensor(valid.astype(np.float32)),
                     torch.as_tensor(grids), n, box, cb=CB).numpy()
    gp = gather_pallas_cells(*_jax_cells(slots, valid.astype(np.float32)),
                             tuple(jnp.asarray(x) for x in grids), n, box,
                             cb=CB, interpret=True)
    assert np.all(g[:, r, c] == 0)
    assert all(float(np.asarray(gp[d])[r, c]) == 0 for d in range(3))


def test_slot_across_box_face_is_kept():
    """A slot of the last x column that drifted across the box face sits
    near x = 0 after the periodic wrap.  Its cloud still lies in its
    column's halo modulo the mesh, and the port deposits and gathers it as
    the exact interpolation does.  The JAX cell kernels' halo test is not
    periodic and drop it: the deposit falls one weight short there."""
    n, box, mass = 32, 4.0, 0.5
    rng = np.random.default_rng(12)
    pos, slots, valid, (row, cell) = _layout(rng, n, box, per_cell=8)
    nc = n // CB
    i = int(np.flatnonzero(cell // (nc * nc) == nc - 1)[0])
    r, c = int(row[i]), int(cell[i])
    pos[i, 0] = slots[0, r, c] = np.float32(0.3 * box / n)
    w = valid.astype(np.float32) * mass
    st = torch.as_tensor(slots)
    got = deposit_cells(st, torch.as_tensor(w), n, box, cb=CB).numpy()
    exact = np.asarray(deposit(jnp.asarray(pos), mass, n, box, order=2))
    np.testing.assert_allclose(got, exact, **TOL)
    pallas = np.asarray(deposit_pallas_cells(*_jax_cells(slots, w), n, box,
                                             cb=CB, interpret=True))
    np.testing.assert_allclose(pallas.sum(), (valid.sum() - 1) * mass, rtol=1e-5)
    grids = rng.standard_normal((3, n, n, n)).astype(np.float32)
    g = gather_cells(st, torch.as_tensor(valid.astype(np.float32)),
                     torch.as_tensor(grids), n, box, cb=CB).numpy()
    ref = np.asarray(gather(jnp.asarray(grids[0]), jnp.asarray(pos[i:i + 1]),
                            box, order=2))
    np.testing.assert_allclose(g[0, r, c], ref[0], **TOL)
