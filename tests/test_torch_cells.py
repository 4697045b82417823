"""The port's CIC deposit and gather on the (K, C) cell layout
(concept_tpu_torch.grid.cuda_cells, cells 8 mesh cells wide, and 4 for
the gather) vs the JAX
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
    cut_rows, deposit_cells, gather_cells,
)

CB = 8
TOL = dict(rtol=2e-5, atol=1e-5)


def _layout(rng, n, box, per_cell, cb=CB, clump=0):
    """Uniform particles bucketed into the (K, C) layout by the mesh-index
    cell rule of the rung stepper (floor(p·n/box)//cb, x-major ids), with
    ``clump`` more particles in one cell.  Returns (pos (N, 3), slot
    positions (3, K, C), valid (K, C), slot of each particle (N,) as
    (row, col))."""
    nc = n // cb
    C = nc**3
    N = per_cell * C
    pos = rng.uniform(0, box, (N, 3)).astype(np.float32)
    if clump:  # the cell at (nc // 2, nc // 2, nc // 2): its columns run deep
        lo = (nc // 2) * cb * box / n
        more = lo + rng.uniform(0, cb * box / n, (clump, 3))
        pos = np.concatenate([pos, more.astype(np.float32)])
        N += clump
    ijk = np.clip(np.floor(pos * np.float32(n / box)).astype(np.int64) // cb,
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


@pytest.mark.parametrize("n, cb, D, clump", [
    pytest.param(16, 8, 3, 0, id="16"),
    pytest.param(32, 8, 3, 0, id="32"),
    # one column 70 particles deep: K = 80 rows, over five of the
    # kernel's 16-row chunks, at the lean kick's D = 1 and the spectral
    # kick's D = 3
    pytest.param(16, 8, 1, 70, id="cb8-D1-clump"),
    pytest.param(16, 8, 3, 70, id="cb8-D3-clump"),
    pytest.param(16, 4, 1, 70, id="cb4-D1-clump"),
    pytest.param(16, 4, 3, 70, id="cb4-D3-clump"),
])
def test_gather_matches_jax(n, cb, D, clump):
    box = 3.0
    rng = np.random.default_rng(7)
    pos, slots, valid, (row, cell) = _layout(rng, n, box, per_cell=10, cb=cb,
                                             clump=clump)
    grids = rng.standard_normal((D, n, n, n)).astype(np.float32)
    w = valid.astype(np.float32)
    got = gather_cells(torch.as_tensor(slots), torch.as_tensor(w),
                       torch.as_tensor(grids), n, box, cb=cb).numpy()
    C = valid.shape[1]
    if clump:
        assert valid.shape[0] > 64
    pallas = gather_pallas_cells(*_jax_cells(slots, w),
                                 tuple(jnp.asarray(g) for g in grids), n, box,
                                 cb=cb, interpret=True)
    for d in range(D):
        np.testing.assert_allclose(got[d], np.asarray(pallas[d])[:, :C], **TOL)
        exact = np.asarray(gather(jnp.asarray(grids[d]), jnp.asarray(pos), box,
                                  order=2))
        np.testing.assert_allclose(got[d][row, cell], exact, **TOL)
    assert np.all(got[:, ~valid] == 0)


@pytest.mark.parametrize("cb", [8, 4])
def test_gather_with_extents_matches_jax(cb):
    """Per-column row extents (rows r ≥ ext[c] count as w = 0): the
    gather with them equals the JAX gather on the weights cut to them,
    for extents at the occupancy (the rung stepper's) and below it."""
    n, box = 16, 3.0
    rng = np.random.default_rng(9)
    _, slots, valid, _ = _layout(rng, n, box, per_cell=10, cb=cb, clump=70)
    K, C = valid.shape
    rows1 = np.arange(1, K + 1)[:, None]
    occ = np.where(valid, rows1, 0).max(axis=0)
    cut = np.minimum(occ, rng.integers(0, K + 1, size=C))
    grids = rng.standard_normal((3, n, n, n)).astype(np.float32)
    w = valid.astype(np.float32)
    for e in (occ, cut):
        ext = torch.as_tensor(e.astype(np.int32))
        got = gather_cells(torch.as_tensor(slots), torch.as_tensor(w),
                           torch.as_tensor(grids), n, box, cb=cb, ext=ext).numpy()
        wc = cut_rows(torch.as_tensor(w), ext).numpy()
        pallas = gather_pallas_cells(*_jax_cells(slots, wc),
                                     tuple(jnp.asarray(g) for g in grids), n, box,
                                     cb=cb, interpret=True)
        for d in range(3):
            np.testing.assert_allclose(got[d], np.asarray(pallas[d])[:, :C], **TOL)
        assert np.all(got[:, np.arange(K)[:, None] >= e[None, :]] == 0)


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


def _planes_equal_the_whole(d, cb, n):
    """Rank r's planes of columns cb mesh cells wide (d ranks,
    parallel/step.plane_starts) deposit into their slab mesh with a halo
    row a side and gather from it; the slabs summed into the whole mesh
    (halo rows wrapped) are the whole layout's deposit, and each rank's
    gather is its planes' part of the whole gather.  The anchors and the
    halo test are exact; slots of the first and last planes sit across
    the box faces, so that the low and the high halo rows take mass."""
    from concept_tpu_torch.grid.cuda_cells import cell_geometry
    from concept_tpu_torch.parallel.step import plane_starts

    rng = np.random.default_rng(13)
    box, mass = 2.0, 1.3
    nc, h, P = n // cb, box / n, (n // cb) ** 2
    _, slots, valid, _ = _layout(rng, n, box, per_cell=12, cb=cb)
    K, C = valid.shape
    plane = np.arange(C) // P
    slots[0][valid & (plane == 0)[None] & (rng.random((K, C)) < 0.3)] = box - 0.3 * h
    slots[0][valid & (plane == nc - 1)[None] & (rng.random((K, C)) < 0.3)] = 0.2 * h
    s, wv = torch.as_tensor(slots), torch.as_tensor(valid.astype(np.float32))
    grids = torch.as_tensor(rng.standard_normal((3, n, n, n)).astype(np.float32))
    whole = deposit_cells(s, wv * mass, n, box, cb=cb)
    whole_g = gather_cells(s, wv, grids, n, box, cb=cb)
    anchors, _, in_halo = cell_geometry(s, slice(0, C), nc, cb, n / box)
    summed = torch.zeros_like(whole)
    starts = plane_starts(nc, d)
    for r in range(d):
        x0, npl = starts[r], starts[r + 1] - starts[r]
        cols = slice(x0 * P, (x0 + npl) * P)
        part, wp = s[:, :, cols].contiguous(), wv[:, cols].contiguous()
        rows = torch.remainder(torch.arange(npl * cb + 2) + x0 * cb - 1, n)
        summed.index_add_(0, rows, deposit_cells(part, wp * mass, n, box, cb=cb,
                                                 planes=(x0, npl)))
        got = gather_cells(part, wp, grids[:, rows].contiguous(), n, box, cb=cb,
                           planes=(x0, npl))
        np.testing.assert_allclose(got.numpy(), whole_g[:, :, cols].numpy(), rtol=1e-6,
                                   atol=1e-6 * float(whole_g.abs().max()))
        pa, _, ph = cell_geometry(part, slice(0, npl * P), nc, cb, n / box, x0=x0, nx=npl)
        assert torch.equal(ph, in_halo[:, cols])
        # the slab's row: the local plane·cb + the offset in the column's halo
        lp = torch.arange(npl * P) // P
        assert torch.equal(pa[0][ph], (lp * cb + torch.remainder(
            anchors[0][:, cols] - ((lp + x0) * cb - 1), n))[ph])
        assert all(torch.equal(pa[k], anchors[k][:, cols]) for k in (1, 2))
    # the faces' slots reached the halo rows
    assert float(summed.sum()) == pytest.approx(float(valid.sum()) * mass, rel=1e-6)
    np.testing.assert_allclose(summed.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6 * float(whole.abs().max()))


@pytest.mark.parametrize("d", [1, 2, 4, 3])
def test_planes_deposit_and_gather_equal_the_whole(d):
    """The cells' nx contract (the rung stepper over d ranks) at cb = 8,
    nc = 4: the planes nc/d, or 1 + 2 + 1 at d = 3
    (:func:`_planes_equal_the_whole`)."""
    _planes_equal_the_whole(d, CB, 32)


@pytest.mark.parametrize("d", [2, 3])
def test_cb4_planes_of_an_uneven_split_equal_the_whole(d):
    """The same at cb = 4 on nc = 7 planes (grid 28): 4 + 3 and 2 + 3 + 2
    planes, the 4-mesh-cell layout's PM over ranks."""
    _planes_equal_the_whole(d, 4, 28)


@pytest.mark.parametrize("d", [1, 3])
def test_block_planes_deposit_and_gather_equal_the_whole(d):
    """Rows 8 and 9 on planes of the 2-mesh-cell blocks (z-major ids over
    the planes, the tight rung layout's PM over ranks): each rank's
    particles of its block planes (n/2 = 16 planes: the whole at d = 1,
    5 + 6 + 5 at d = 3), laid out by forces/p3m.block_layout, deposit
    onto their slab mesh with a halo row a side; summed (halo rows
    wrapped) they are the whole mesh's block deposit, and each slab's
    gather gives every particle the whole gather's value.  Particles
    within a mesh cell of both box faces reach the halo rows."""
    from concept_tpu_torch.forces.p3m import block_layout
    from concept_tpu_torch.grid.cuda_blocks import deposit_blocks, gather_blocks
    from concept_tpu_torch.parallel.step import plane_starts

    rng = np.random.default_rng(17)
    n, box, mass, k_pm = 32, 2.0, 1.3, 24
    h, nb = box / n, n // 2
    pos = rng.uniform(0, box, (4000, 3)).astype(np.float32)
    pos[:200, 0] = rng.uniform(0, 0.5 * h, 200)
    pos[200:400, 0] = box - rng.uniform(0, 0.5 * h, 200)
    p = torch.as_tensor(pos)
    grids = torch.as_tensor(rng.standard_normal((3, n, n, n)).astype(np.float32))

    def by_particle(lay, vals):
        """(3, K, C) slot values → (3, N) in the layout's input order."""
        out = torch.zeros((3, lay["order"].shape[0]))
        out[:, lay["order"]] = vals.reshape(3, -1)[:, lay["slot"]]
        return out

    lay = block_layout(*p.T, n, box, k_pm)
    assert int(lay["valid"].sum()) == p.shape[0]  # no particle beyond the capacity
    w = lay["valid"].to(p.dtype)
    whole = deposit_blocks(*lay["slots"], w * mass, n, box, ext=lay["ext"])
    whole_g = by_particle(lay, gather_blocks(*lay["slots"], w, grids, n, box, ext=lay["ext"]))
    summed = torch.zeros_like(whole)
    starts = plane_starts(nb, d)
    bx = torch.clamp((p[:, 0] / h).to(torch.int64), 0, n - 1) // 2
    for r in range(d):
        x0, npl = starts[r], starts[r + 1] - starts[r]
        mine = torch.nonzero((bx >= x0) & (bx < x0 + npl)).reshape(-1)
        pl = block_layout(*p[mine].T, n, box, k_pm, planes=(x0, npl))
        wp = pl["valid"].to(p.dtype)
        rows = torch.remainder(torch.arange(2 * npl + 2) + 2 * x0 - 1, n)
        summed.index_add_(0, rows, deposit_blocks(*pl["slots"], wp * mass, n, box,
                                                  ext=pl["ext"], planes=(x0, npl)))
        got = gather_blocks(*pl["slots"], wp, grids[:, rows].contiguous(), n, box,
                            ext=pl["ext"], planes=(x0, npl))
        np.testing.assert_allclose(by_particle(pl, got).numpy(), whole_g[:, mine].numpy(),
                                   rtol=1e-6, atol=1e-6 * float(whole_g.abs().max()))
    assert float(summed.sum()) == pytest.approx(pos.shape[0] * mass, rel=1e-6)
    np.testing.assert_allclose(summed.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6 * float(whole.abs().max()))
