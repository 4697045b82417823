"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without a card they skip (the fixture decides).
On a machine with the card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the sweep max|Δ|/max|ref| < 1e-5 (summation order, FMA
contraction in the force); deposit and gather rtol 2e-5 / atol
1e-5·max|ref| (atomics add in no fixed order).  The double kernels
(float64 inputs) within 1e-10 of the largest plain value: the same
causes, in double."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (kernels built for sm_90a)")
    return torch.device("cuda")


def _layout(rng, n, K, box, dtype=np.float32):
    """Random prefix-valid sentinel layout over n³ cells and its
    per-pencil extents (as tests/test_torch_shortrange.py)."""
    C = n**3
    counts = rng.integers(0, K + 1, size=C)
    valid = np.arange(K)[:, None] < counts[None, :]
    cells = np.arange(C)
    cw = box / n
    base = np.stack([cells // (n * n), (cells // n) % n, cells % n]) * cw
    pos = base[:, None, :] + rng.random((3, K, C)) * cw
    s = np.where(valid[None], pos, 1e4 * box).astype(dtype)
    ext = counts.reshape(n * n, n).max(axis=1).astype(np.int32)
    return s, valid, ext


@pytest.mark.parametrize("kernel", ["plummer", "spline", "none"])
@pytest.mark.parametrize("bounds", ["none", "full_K", "occupancy", "restricted"])
def test_pair_sweep_matches_plain(dev, kernel, bounds):
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep, pair_sweep_plain

    rng = np.random.default_rng(5)
    n, K, box = 6, 24, 1.0
    s, valid, ext = _layout(rng, n, K, box)
    rext = sext = None
    if bounds == "full_K":
        rext = sext = np.full(n * n, K, np.int32)
    elif bounds == "occupancy":
        rext = sext = ext
    elif bounds == "restricted":
        sext = ext
        rext = rng.integers(0, K // 2, size=n * n).astype(np.int32)
    st = torch.as_tensor(s, device=dev)
    K_r = 16
    recv = st[:, :K_r]
    extr = None if rext is None else torch.as_tensor(rext, device=dev)
    exts = None if sext is None else torch.as_tensor(sext, device=dev)
    args = (n, box, 0.04, float(np.float32(0.16) ** 2), float(np.float32(0.01) ** 2), kernel)
    before = pair_sweep.launches
    got = pair_sweep(recv, st, *args, rext=extr, sext=exts)
    assert pair_sweep.launches == before + 1
    ref = pair_sweep_plain(recv, st, *args, rext=extr, sext=exts)
    torch.cuda.synchronize()
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    if rext is not None:
        rb = np.minimum(rext, K_r)[np.arange(n**3) // n]
        assert np.all(got[:, np.arange(K_r)[:, None] >= rb[None, :]] == 0)


@pytest.mark.parametrize("kernel", ["plummer", "spline", "none"])
@pytest.mark.parametrize("bounds", ["none", "occupancy"])
def test_pair_sweep_deep_columns_match_plain(dev, kernel, bounds):
    """Columns deeper than one pass of receiver rows (256) and than one
    shared-memory tile of supplier rows (512), as late-time clustering
    makes them: three columns hold a clump of 600 slots, so spline
    near-field pairs (r < 2.8ε) occur; the others hold a few slots."""
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep, pair_sweep_plain

    rng = np.random.default_rng(11)
    n, K, box = 4, 600, 1.0
    C = n**3
    cw = box / n
    counts = rng.integers(0, 9, size=C)
    deep = rng.choice(C, size=3, replace=False)
    counts[deep] = K
    valid = np.arange(K)[:, None] < counts[None, :]
    cells = np.arange(C)
    base = np.stack([cells // (n * n), (cells // n) % n, cells % n]) * cw
    frac = rng.random((3, K, C))
    frac[:, :, deep] = np.clip(rng.normal(0.5, 0.08, (3, K, 3)), 0.0, 0.999)
    pos = base[:, None, :] + frac * cw
    s = np.where(valid[None], pos, 1e4 * box).astype(np.float32)
    soft = 0.01
    clump = pos[:, :, deep[0]].T
    r2 = ((clump[:, None] - clump[None]) ** 2).sum(-1)
    assert ((r2 > 0) & (r2 < (2.8 * soft) ** 2)).sum() > 0  # near field reached
    ext = counts.reshape(n * n, n).max(axis=1).astype(np.int32)
    assert ext.max() == K
    st = torch.as_tensor(s, device=dev)
    e = torch.as_tensor(ext, device=dev) if bounds == "occupancy" else None
    args = (n, box, 0.04, float(np.float32(0.16) ** 2), float(np.float32(soft) ** 2), kernel)
    got = pair_sweep(st, st, *args, rext=e, sext=e)
    ref = pair_sweep_plain(st, st, *args, rext=e, sext=e)
    torch.cuda.synchronize()
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.abs(got[:, 512:, deep]).max() > 0  # the third receiver pass ran


def _check_cells(dev, cb):
    """deposit_cells / gather_cells on columns cb mesh cells wide, with one
    slot outside its column's halo (dropped) and one across the box face
    since bucketing (kept)."""
    from concept_tpu_torch.grid.cuda_cells import (
        deposit_cells, deposit_cells_plain, gather_cells, gather_cells_plain,
    )

    rng = np.random.default_rng(8)
    n, box = 32, 4.0
    nc = n // cb
    s, valid, _ = _layout(rng, nc, 16, box)
    C = nc**3
    valid[0, 0] = valid[0, C - 1] = True
    s = np.where(valid[None], s, 0.0).astype(np.float32)
    h = box / n
    s[:, 0, 0] = np.array([20.4, 1.3, 2.2]) * h               # out of its halo: dropped
    s[:, 0, C - 1] = np.array([0.3, n - 3.5, n - 2.5]) * h    # across the box face: kept
    pos = torch.as_tensor(s, device=dev)
    w = torch.as_tensor(valid.astype(np.float32) * 0.7, device=dev)
    before = (deposit_cells.launches, gather_cells.launches)
    got, ref = deposit_cells(pos, w, n, box, cb), deposit_cells_plain(pos, w, n, box, cb)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=1e-5 * float(ref.abs().max()))
    grids = torch.as_tensor(rng.standard_normal((3, n, n, n)).astype(np.float32), device=dev)
    wv = (w > 0).float()
    got = gather_cells(pos, wv, grids, n, box, cb)
    ref = gather_cells_plain(pos, wv, grids, n, box, cb)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=1e-5 * float(ref.abs().max()))
    assert (deposit_cells.launches, gather_cells.launches) == (before[0] + 1, before[1] + 1)
    assert float(got[:, 0, 0].abs().max()) == 0.0
    assert float(got[:, 0, C - 1].abs().max()) > 0.0


def test_deposit_and_gather_match_plain(dev):
    _check_cells(dev, 8)


def test_deposit_and_gather_cb4_match_plain(dev):
    """The 4-mesh-cell rung layout's PM: 8³ columns on mesh 32."""
    _check_cells(dev, 4)


def _reach_geometry(n, box=1.0):
    """(scale, cutoff², offsets) of the 4-mesh-cell layout with n³ cells."""
    from concept_tpu_torch.forces.shortrange import reach_offsets

    cw = box / n
    cutoff = (4.5 * 1.25 / 4.0) * cw
    return (1.25 * cw / 4.0, float(np.float32(cutoff) ** 2),
            reach_offsets(cw, 0.55 * cw / 4.0))


def _check_reach(dev, s, valid, n, K_r, kernel, soft, two_sided):
    """The reach sweep kernel against its plain version: one-sided on the
    leading K_r rows (receivers at −sentinel, suppliers at +sentinel), or
    two-sided through sweep_reach (receivers = suppliers, all rows)."""
    from concept_tpu_torch.forces.cuda_shortrange import (
        pair_sweep, pair_sweep_plain, pair_sweep_reach,
    )
    from concept_tpu_torch.forces.shortrange import sweep_reach

    box = 1.0
    scale, cutoff2, offs = _reach_geometry(n, box)
    assert len(offs) == 117
    st = torch.as_tensor(s, device=dev)
    before = (pair_sweep.launches, pair_sweep_reach.launches, sweep_reach.launches)
    soft2 = float(np.float32(soft) ** 2)
    if two_sided:
        v = torch.as_tensor(valid, device=dev)
        got = sweep_reach(*st, v, n, box, scale, float(np.sqrt(cutoff2)), soft,
                          box / n, 0.55 * box / n / 4.0, kernel=kernel)
        ref = pair_sweep_plain(st, st, n, box, scale, cutoff2, soft2, kernel,
                               offsets=offs)
        counts = (before[0], before[1] + 1, before[2] + 1)
    else:
        recv = torch.where(torch.as_tensor(valid[:K_r], device=dev)[None],
                           st[:, :K_r], -1e4 * box).contiguous()
        got = pair_sweep_reach(recv, st, n, box, scale, cutoff2, soft2, offs,
                               kernel=kernel)
        ref = pair_sweep_plain(recv, st, n, box, scale, cutoff2, soft2, kernel,
                               offsets=offs)
        counts = (before[0], before[1] + 1, before[2])
    assert (pair_sweep.launches, pair_sweep_reach.launches, sweep_reach.launches) == counts
    torch.cuda.synchronize()
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    return got


@pytest.mark.parametrize("two_sided", [False, True])
@pytest.mark.parametrize("kernel", ["plummer", "spline", "none"])
@pytest.mark.parametrize("K", [8, 16, 40])
def test_pair_sweep_reach_matches_plain(dev, K, kernel, two_sided):
    """The reach-2 sweep (117 kept offsets) at the 4-mesh-cell layout's
    column depths, 6³ cells."""
    rng = np.random.default_rng(31 + K)
    n = 6
    s, valid, _ = _layout(rng, n, K, 1.0)
    _check_reach(dev, s, valid, n, max(1, K // 2), kernel, 0.01, two_sided)


@pytest.mark.parametrize("two_sided", [False, True])
@pytest.mark.parametrize("kernel", ["plummer", "spline", "none"])
def test_pair_sweep_reach_wrapped_and_clumped(dev, kernel, two_sided):
    """n = 5, where the ±2 offsets of every column wrap onto distinct
    columns, with one clump of 600 slots: a second shared-memory tile of
    supplier rows, three receiver passes and spline near-field pairs."""
    rng = np.random.default_rng(41)
    n, K, box = 5, 600, 1.0
    C = n**3
    cw = box / n
    counts = rng.integers(0, 9, size=C)
    counts[C // 2] = K
    valid = np.arange(K)[:, None] < counts[None, :]
    cells = np.arange(C)
    base = np.stack([cells // (n * n), (cells // n) % n, cells % n]) * cw
    frac = rng.random((3, K, C))
    frac[:, :, C // 2] = np.clip(rng.normal(0.5, 0.05, (3, K)), 0.0, 0.999)
    pos = base[:, None, :] + frac * cw
    s = np.where(valid[None], pos, 1e4 * box).astype(np.float32)
    soft = 0.004
    clump = pos[:, :, C // 2].T
    r2 = ((clump[:, None] - clump[None]) ** 2).sum(-1)
    assert ((r2 > 0) & (r2 < (2.8 * soft) ** 2)).sum() > 0  # near field reached
    got = _check_reach(dev, s, valid, n, K, kernel, soft, two_sided)
    assert np.abs(got[:, 512:, C // 2]).max() > 0  # the third receiver pass ran


@pytest.mark.parametrize("kernel", ["plummer", "spline", "none"])
@pytest.mark.parametrize("K", [32, 40])
def test_pair_sweep_two_sided_matches_plain(dev, kernel, K):
    """The global stepper's sweep (row 6, ``pair_sweep_global``):
    receivers = suppliers = the whole sentinel-filled slot array, no row
    bounds, at its column depths (K = 32-40: items of 32 or 64 rows, one
    or two receivers a lane)."""
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep_global, pair_sweep_plain

    rng = np.random.default_rng(21 + K)
    n, box = 5, 1.0
    s, _, _ = _layout(rng, n, K, box)
    st = torch.as_tensor(s, device=dev)
    args = (n, box, 0.05, float(np.float32(0.2) ** 2), float(np.float32(0.01) ** 2), kernel)
    before = pair_sweep_global.launches
    got = pair_sweep_global(st, st, *args)
    assert pair_sweep_global.launches == before + 1
    ref = pair_sweep_plain(st, st, *args)
    torch.cuda.synchronize()
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_block_deposit_and_gather_match_plain(dev):
    """The PM block kernels (2-mesh-cell blocks, z-major ids) against
    their plain versions, with one slot wrapped across the box face since
    bucketing (kept) and one outside its block's halo (dropped)."""
    from concept_tpu_torch.grid.cuda_blocks import (
        deposit_blocks, deposit_blocks_plain, gather_blocks, gather_blocks_plain,
    )

    rng = np.random.default_rng(13)
    n, box, K = 32, 4.0, 8
    nb = n // 2
    C = nb**3
    h = box / n
    cells = np.arange(C)
    base = np.stack([cells % nb, (cells // nb) % nb, cells // (nb * nb)]) * 2 * h
    counts = rng.integers(0, K + 1, size=C)
    valid = np.arange(K)[:, None] < counts[None, :]
    pos = base[:, None, :] + rng.random((3, K, C)) * 2 * h
    valid[0, nb - 1] = valid[0, 0] = True
    pos[:, 0, nb - 1] = np.array([0.4, 0.6, 1.2]) * h  # block bx = nb-1, wrapped: kept
    pos[:, 0, 0] = np.array([5.5, 0.6, 1.2]) * h       # block 0, out of its halo
    s = np.where(valid[None], pos, 0.0).astype(np.float32)
    px, py, pz = (torch.as_tensor(a, device=dev) for a in s)
    w = torch.as_tensor(valid.astype(np.float32) * 0.7, device=dev)
    before = (deposit_blocks.launches, gather_blocks.launches)
    got = deposit_blocks(px, py, pz, w, n, box)
    ref = deposit_blocks_plain(px, py, pz, w, n, box)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=1e-5 * float(ref.abs().max()))
    np.testing.assert_allclose(float(got.sum()), 0.7 * (valid.sum() - 1), rtol=1e-5)
    grids = torch.as_tensor(rng.standard_normal((3, n, n, n)).astype(np.float32), device=dev)
    wv = (w > 0).float()
    got = gather_blocks(px, py, pz, wv, grids, n, box)
    ref = gather_blocks_plain(px, py, pz, wv, grids, n, box)
    assert (deposit_blocks.launches, gather_blocks.launches) == (before[0] + 1, before[1] + 1)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=2e-5, atol=1e-5 * float(r.abs().max()))
    assert float(got[0][0, nb - 1].abs()) > 0.0
    assert float(got[0][0, 0].abs()) == 0.0


def test_other_and_mixed_dtypes_on_the_card_raise(dev):
    """A launch takes float32 or float64 inputs of one dtype, else raises
    before any kernel runs (no fall-back to the plain version)."""
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep
    from concept_tpu_torch.grid.cuda_cells import deposit_cells

    s = torch.zeros((3, 8, 27), dtype=torch.float16, device=dev)
    with pytest.raises(TypeError, match="float32 or float64"):
        pair_sweep(s, s, 3, 1.0, 0.1, 0.2, 0.0)
    with pytest.raises(TypeError, match="mixed"):
        pair_sweep(s.double(), s.float(), 3, 1.0, 0.1, 0.2, 0.0)
    with pytest.raises(TypeError, match="mixed"):
        deposit_cells(torch.zeros((3, 2, 8), dtype=torch.float64, device=dev),
                      torch.zeros((2, 8), device=dev), 16, 1.0, 8)


def _clumped_blocks(dev, n, N, clump, box=4.0, seed=9, face=0):
    """N uniform particles plus ``clump`` in the block of mesh cells
    [2, 4)³ (deep beyond any block capacity), and the last ``face`` of
    them moved onto the box faces in z (0 or just below the box), sorted
    by block for the PM-only block kernels: (sort dict, positions)."""
    from concept_tpu_torch.grid.bucketed import sort_blocks

    rng = np.random.default_rng(seed)
    h = box / n
    pos = rng.uniform(0, box, (N + clump, 3))
    pos[:clump] = 2 * h + rng.uniform(0, 1.9 * h, (clump, 3))
    if face:
        pos[-face:, 2] = rng.choice([0.0, box * (1 - 1e-7)], face)
    pos = torch.as_tensor(pos.astype(np.float32), device=dev)
    return sort_blocks(pos, n, box), pos


@pytest.mark.parametrize("n, D, face, capacity", [
    (32, 3, 0, None), (32, 1, 0, None), (18, 3, 0, None), (16, 1, 0, None),
    (16, 3, 0, None), (32, 3, 300, None), (18, 3, 0, 32),
], ids=["n32-D3", "n32-D1", "odd-C-n18-D3", "nb-below-tile-n16-D1", "nb-below-tile-n16-D3",
        "box-face-n32-D3", "capacity-n18-D3"])
def test_pm_block_kernels_match_plain(dev, n, D, face, capacity):
    """Rows 10 and 11 (the PM-only block kernels) against their plain
    versions on block-sorted particles with a deep clump (600 particles
    in one block): at an even and an odd block count (18 → 9³ = 729
    blocks, no tile divides 9), at nb = 8, below the tile's 16 blocks
    along z (the halo wraps onto its own tile), with particles on the box
    faces, with the counts clamped to a capacity of 32 (the TPU kernels'
    truncation: the rest deposit nothing and gather 0), and D = 1 or 3
    fields.  The deposit's mass sum to 1e-6; one launch each."""
    from concept_tpu_torch.grid.cuda_pm import (
        deposit_pm, deposit_pm_plain, gather_pm, gather_pm_plain,
    )

    sb, _ = _clumped_blocks(dev, n, 3 * n**3 // 8, 600, face=face)
    counts = sb["counts"] if capacity is None else torch.clamp(sb["counts"], max=capacity)
    args = (sb["lidx"], sb["fx"], sb["fy"], sb["fz"])
    N = sb["lidx"].shape[0]
    q = torch.full((N,), 1.3, device=dev)
    before = (deposit_pm.launches, gather_pm.launches)
    got = deposit_pm(*args, q, sb["starts"], counts, n)
    ref = deposit_pm_plain(*args, q, sb["starts"], counts, n)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=1e-5 * float(ref.abs().max()))
    assert float(got.sum(dtype=torch.float64)) == pytest.approx(
        1.3 * float(counts.sum()), rel=1e-6)
    rng = np.random.default_rng(4)
    grids = torch.as_tensor(rng.standard_normal((D, n, n, n)).astype(np.float32), device=dev)
    got = gather_pm(*args, sb["starts"], counts, grids, n)
    ref = gather_pm_plain(*args, sb["starts"], counts, grids, n)
    assert got.shape == (D, N)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=1e-5 * float(ref.abs().max()))
    if capacity is not None:
        rank = torch.arange(N, device=dev) - sb["starts"][sb["key"]]
        assert int((rank >= capacity).sum()) >= 600 - capacity
        assert float(got[:, rank >= capacity].abs().max()) == 0.0
    assert (deposit_pm.launches, gather_pm.launches) == (before[0] + 1, before[1] + 1)


def test_pm_block_kernels_empty_set(dev):
    """Rows 10 and 11 on no particles: a zero mesh and a (D, 0) gather,
    one launch each."""
    from concept_tpu_torch.grid.cuda_pm import deposit_pm, gather_pm

    sb, _ = _clumped_blocks(dev, 16, 0, 0)
    args = (sb["lidx"], sb["fx"], sb["fy"], sb["fz"])
    before = (deposit_pm.launches, gather_pm.launches)
    grid = deposit_pm(*args, torch.zeros(0, device=dev), sb["starts"], sb["counts"], 16)
    assert grid.shape == (16, 16, 16) and float(grid.abs().max()) == 0.0
    out = gather_pm(*args, sb["starts"], sb["counts"],
                    torch.ones((3, 16, 16, 16), device=dev), 16)
    assert out.shape == (3, 0)
    torch.cuda.synchronize()
    assert (deposit_pm.launches, gather_pm.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("differentiation", ["fourier", 4])
def test_pm_kernel_path_equals_scatter_on_the_card(dev, differentiation):
    """The PM kick through rows 10-11 ('auto' on the card) with a deep
    clump equals the plain 'scatter' PM: every particle goes through the
    kernels (no capacity, no overflow), one row-10 and one row-11 launch
    (D = 3) a kick, and the gradients are the ones ``differentiation``
    asks for."""
    from concept_tpu_torch.forces.pm import pm_gravity_momentum_updates
    from concept_tpu_torch.grid.cuda_pm import deposit_pm, gather_pm

    n, box = 32, 4.0
    _, pos = _clumped_blocks(dev, n, 4096, 600, box=box)
    info = {}
    kw = dict(kick_integral=0.5, differentiation=differentiation)
    before = (deposit_pm.launches, gather_pm.launches)
    (auto,) = pm_gravity_momentum_updates([pos], [1.3], n, box, 1.0,
                                          deposit_method="auto", info=info, **kw)
    assert (deposit_pm.launches, gather_pm.launches) == (before[0] + 1, before[1] + 1)
    (plain,) = pm_gravity_momentum_updates([pos], [1.3], n, box, 1.0,
                                           deposit_method="scatter", **kw)
    assert info["n_overflow"] == 0
    assert float(info["mass_sum"]) == pytest.approx(1.3 * pos.shape[0], rel=1e-6)
    scale = float(plain.abs().max())
    torch.testing.assert_close(auto / scale, plain / scale, rtol=0, atol=1e-5)


def test_bucket_step_on_the_card_matches_the_cpu(dev):
    """One BucketSimulation step (rows 8-9 with stragglers) on the card
    against the same step on the CPU (the plain versions)."""
    from concept_tpu_torch.bucketsim import BucketSimulation

    rng = np.random.default_rng(2)
    pos = rng.uniform(0, 40.0, (3000, 3)).astype(np.float32)
    mom = (10 * rng.standard_normal((3000, 3))).astype(np.float32)
    out = []
    for device in ("cpu", dev):
        sim = BucketSimulation(16, 40.0, 2.0, 1.0, capacity=24, device=device)
        st = sim.init_state(torch.as_tensor(pos), torch.as_tensor(mom))
        for _ in range(2):
            st, ns = sim.step(st, 0.3, 0.25)
        out.append((st.pos.cpu(), st.valid.cpu(), ns))
    # the second step's stragglers: from positions that may differ in the
    # last bit (the deposits' atomics add in another order)
    assert out[1][2] > 0 and abs(out[0][2] - out[1][2]) <= 1
    assert torch.equal(out[0][1], out[1][1])
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=1e-3 * 40.0)


def _holey(rng, n, K, box):
    """Sentinel-filled slots over n³ cells whose valid slots are no column
    prefix (each slot valid with probability 0.6), and their per-column
    extents (1 + the highest valid row)."""
    valid = rng.random((K, n**3)) < 0.6
    cells = np.arange(n**3)
    cw = box / n
    base = np.stack([cells // (n * n), (cells // n) % n, cells % n]) * cw
    pos = base[:, None, :] + rng.random((3, K, n**3)) * cw
    # some slots on cell faces and on the half-cell planes
    face = rng.random((3, K, n**3)) < 0.1
    pos = np.where(face, base[:, None, :] + cw * rng.integers(0, 2, pos.shape) / 2, pos)
    s = np.where(valid[None], pos, 1e4 * box).astype(np.float32)
    ext = np.where(valid, np.arange(1, K + 1)[:, None], 0).max(axis=0).astype(np.int32)
    return s, valid, ext


def _table(name, n, box=1.0):
    """(sweep, offsets, scale, cutoff) of the ±1 table (cells a cutoff
    wide) or the 4-mesh-cell layout's reach-2 table."""
    from concept_tpu_torch.forces.cuda_shortrange import (
        OFFSETS_27, pair_sweep, pair_sweep_reach,
    )

    cw = box / n
    if name == "pm1":
        return pair_sweep, OFFSETS_27, 0.2 * cw, 0.9 * cw
    scale, cutoff2, offs = _reach_geometry(n, box)

    def sweep(recv, sup, n, box, scale, cutoff2, soft2, kernel, **kw):
        return pair_sweep_reach(recv, sup, n, box, scale, cutoff2, soft2, offs,
                                kernel=kernel, **kw)
    return sweep, offs, scale, float(np.sqrt(cutoff2))


def _check_bounded(dev, table, s, valid, n, rb, sb, kernel, soft):
    """A sweep of ``table`` with per-column bounds rb/sb (or None) against
    its plain version: max|Δ|/max|ref| ≤ 1e-5, rows at or beyond rb
    exactly 0, one launch counted.  Receivers are the suppliers (±1) or
    the valid slots at −sentinel (reach)."""
    from concept_tpu_torch.forces.cuda_shortrange import (
        pair_sweep, pair_sweep_plain, pair_sweep_reach,
    )

    box = 1.0
    sweep, offs, scale, cutoff = _table(table, n, box)
    st = torch.as_tensor(s, device=dev)
    recv = st if table == "pm1" else torch.where(
        torch.as_tensor(valid, device=dev)[None], st, -1e4 * box).contiguous()
    bounds = dict(rext=None if rb is None else torch.as_tensor(rb, device=dev),
                  sext=None if sb is None else torch.as_tensor(sb, device=dev))
    args = (n, box, scale, float(np.float32(cutoff) ** 2), float(np.float32(soft) ** 2),
            kernel)
    counter = pair_sweep if table == "pm1" else pair_sweep_reach
    before = counter.launches
    got = sweep(recv, st, *args, **bounds)
    assert counter.launches == before + 1
    ref = pair_sweep_plain(recv, st, *args, offsets=offs, **bounds)
    torch.cuda.synchronize()
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    if rb is not None:
        assert np.all(got[:, np.arange(s.shape[1])[:, None] >= rb[None, :]] == 0)
    return got


@pytest.mark.parametrize("kernel", ["plummer", "spline", "none"])
@pytest.mark.parametrize("bounds", ["column", "restricted", "none"])
@pytest.mark.parametrize("table, n", [("pm1", 3), ("reach", 5)])
def test_sweep_column_bounds_match_plain(dev, table, n, bounds, kernel):
    """Both tables at their smallest n (every column has neighbours across
    a box face), with holes below the column bounds, slots on cell faces
    and half-cell planes, per-column occupancy bounds, receiver bounds
    cut below them at random, and no bounds."""
    rng = np.random.default_rng(61 + n + len(bounds))
    K = 24
    s, valid, ext = _holey(rng, n, K, 1.0)
    rb = sb = None
    if bounds != "none":
        rb = sb = ext
    if bounds == "restricted":
        rb = np.minimum(ext, rng.integers(0, K, size=n**3)).astype(np.int32)
    _check_bounded(dev, table, s, valid, n, rb, sb, kernel, 0.01)


@pytest.mark.parametrize("kernel", ["plummer", "spline", "none"])
@pytest.mark.parametrize("table, n", [("pm1", 4), ("reach", 5)])
def test_sweep_column_bounds_deep_clump(dev, table, n, kernel):
    """A clump of 600 slots in one column, deeper than one staging of the
    kernel (512 rows) and than 32 receivers a pass, with per-column
    bounds; spline near-field pairs occur; its neighbours hold a few
    slots."""
    rng = np.random.default_rng(71 + n)
    K, box = 600, 1.0
    C = n**3
    cw = box / n
    counts = rng.integers(0, 9, size=C)
    deep = C // 2
    counts[deep] = K
    valid = np.arange(K)[:, None] < counts[None, :]
    cells = np.arange(C)
    base = np.stack([cells // (n * n), (cells // n) % n, cells % n]) * cw
    frac = rng.random((3, K, C))
    frac[:, :, deep] = np.clip(rng.normal(0.5, 0.05, (3, K)), 0.0, 0.999)
    pos = base[:, None, :] + frac * cw
    s = np.where(valid[None], pos, 1e4 * box).astype(np.float32)
    soft = 0.004
    clump = pos[:, :, deep].T
    r2 = ((clump[:, None] - clump[None]) ** 2).sum(-1)
    assert ((r2 > 0) & (r2 < (2.8 * soft) ** 2)).sum() > 0  # near field reached
    ext = counts.astype(np.int32)
    got = _check_bounded(dev, table, s, valid, n, ext, ext, kernel, soft)
    assert np.abs(got[:, 512:, deep]).max() > 0


@pytest.mark.parametrize("table, n", [("pm1", 6), ("reach", 8)])
def test_sweep_keeps_the_plain_pair_set_at_the_cutoff(dev, table, n):
    """Isolated pairs whose r², formed unfused in float32 as both versions
    form it, lies within a few ulps of cutoff² on either side: each slot
    feels its partner only, so a pair taken or dropped by one version
    alone would show as a zero against a nonzero force."""
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep_plain

    box = 1.0
    sweep, offs, scale, cutoff = _table(table, n, box)
    cutoff2 = np.float32(np.float32(cutoff) ** 2)
    cw = box / n
    K = 2
    C = n**3
    s = np.full((3, K, C), 1e4 * box, np.float32)
    valid = np.zeros((K, C), bool)
    half = n // 2  # columns half a box apart: no pair across columns
    cols = [(i * n + j) * n + k for i in (0, half) for j in (0, half) for k in (0, half)]
    for m, c in enumerate(cols):
        ci, cj, ck = c // (n * n), (c // n) % n, c % n
        xr = np.float32(np.float32(ci * cw) + np.float32(0.03 * cw))
        y, z = np.float32((cj + 0.5) * cw), np.float32((ck + 0.5) * cw)
        # partners at xr + cutoff nudged by ulps: the m-th pair takes the
        # (m mod 4)-th r² below cutoff² (m < 4) or at or above it
        cand = [np.float32(xr + np.float32(cutoff))]
        for _ in range(40):
            cand.append(np.nextafter(cand[-1], np.float32(2.0)))
            cand.insert(0, np.nextafter(cand[0], np.float32(0.0)))
        r2 = [np.float32(np.float32(xr - x) * np.float32(xr - x)) for x in cand]
        below = [x for x, q in zip(cand, r2) if q < cutoff2][::-1]
        above = [x for x, q in zip(cand, r2) if q >= cutoff2]
        s[:, 0, c] = (xr, y, z)
        s[:, 1, c] = ((below if m < 4 else above)[m % 4], y, z)
        valid[:, c] = True
    st = torch.as_tensor(s, device=dev)
    recv = st if table == "pm1" else torch.where(
        torch.as_tensor(valid, device=dev)[None], st, -1e4 * box).contiguous()
    args = (n, box, scale, float(cutoff2), float(np.float32(0.01 * cw) ** 2), "plummer")
    got = sweep(recv, st, *args).cpu().numpy()
    ref = pair_sweep_plain(recv, st, *args, offsets=offs).cpu().numpy()
    g, r = got[:, valid], ref[:, valid]
    assert np.array_equal(g[0] != 0, r[0] != 0)
    assert (r[0] != 0).sum() == 8  # the 4 pairs below cutoff², both members
    np.testing.assert_allclose(g, r, rtol=1e-5, atol=0)


def _slot_case(rng, n, cb, zmajor, K, box=4.0, clump=0, empty=False):
    """Random slots (3, K, C) of columns cb mesh cells wide (x-major or
    z-major ids) on mesh n: live slots within 0.45 mesh cells of their
    column (anchors in its halo), wrapped across the box faces; a few
    slots 1.6 mesh cells beyond their column (out of its halo: dropped);
    the empty slots at the far sentinel with w = 0; with ``clump``, one
    column holding that many slots (K = clump); with ``empty``, no live
    slot at all.  Returns (pos, w (K, C) float32, row counts (C,))."""
    nc = n // cb
    C = nc**3
    h = box / n
    cols = np.arange(C)
    fast, mid, slow = cols % nc, (cols // nc) % nc, cols // (nc * nc)
    base = np.stack([fast, mid, slow] if zmajor else [slow, mid, fast]) * cb * h
    counts = rng.integers(0, min(K, 8) + 1, size=C)
    if clump:
        counts[C // 2] = clump
    if empty:
        counts[:] = 0
    valid = np.arange(K)[:, None] < counts[None, :]
    pos = base[:, None, :] + rng.uniform(-0.45, cb + 0.45, (3, K, C)) * h
    out = rng.choice(C, size=min(8, C // 4), replace=False)
    if not empty:
        pos[0, 0, out] = base[0, out] + (cb + 1.6) * h
        valid[0, out] = True
    pos = np.where(valid[None], np.mod(pos, box), 1e4 * box).astype(np.float32)
    w = (valid * 0.7).astype(np.float32)
    return pos, w, counts


@pytest.mark.parametrize("case", ["D3", "D1", "K1", "empty", "clump", "extents"])
@pytest.mark.parametrize("n", [16, 24, 32])
@pytest.mark.parametrize("cb, zmajor", [(2, True), (8, False), (4, False)],
                         ids=["blocks", "cells8", "cells4"])
def test_slot_kernels_match_plain(dev, cb, zmajor, n, case):
    """The tiled deposit (rows 3 and 8) and the gathers (row 9 tiled on
    the blocks, row 4 in column slabs on the cells) against their plain
    versions: meshes of
    16, 24 and 32 (clipped tiles; at 16 the mesh is smaller than a tile and
    its halo wraps onto itself), slots across every box face and outside
    their halo (dropped, gather 0), sentinel slots of w = 0, D = 3 and 1,
    K = 1, no live slot, a clumped column of 600 rows over several row
    chunks, and per-column extents that cut rows (plain: w cut the same
    way).  The deposited mass, summed in float64, is Σ w over the slots
    that pass the halo test."""
    from concept_tpu_torch.grid.cuda_blocks import deposit_blocks, gather_blocks
    from concept_tpu_torch.grid.cuda_cells import (
        cell_geometry, deposit_cells, deposit_cells_plain, gather_cells,
        gather_cells_plain, launch_deposit, launch_gather,
    )

    rng = np.random.default_rng(n + cb)
    box = 4.0
    K = {"K1": 1, "clump": 600}.get(case, 12)
    s, w_np, _ = _slot_case(rng, n, cb, zmajor, K, box, clump=600 if case == "clump" else 0,
                            empty=case == "empty")
    pos = torch.as_tensor(s, device=dev)
    w = torch.as_tensor(w_np, device=dev)
    C = w.shape[1]
    ext = None
    if case == "extents":
        ext = torch.as_tensor(rng.integers(0, K + 1, size=C).astype(np.int32), device=dev)
        w_ref = w * (torch.arange(K, device=dev)[:, None] < ext[None, :])
    else:
        w_ref = w
    D = 1 if case == "D1" else 3
    grids = torch.as_tensor(rng.standard_normal((D, n, n, n)).astype(np.float32), device=dev)
    dep, gat = ((deposit_blocks, gather_blocks) if cb == 2 else (deposit_cells, gather_cells))
    before = (dep.launches, gat.launches)
    if ext is not None:
        got = launch_deposit(pos, w, n, box, cb, zmajor, ext=ext)
    elif cb == 2:
        got = deposit_blocks(*pos, w, n, box)
    else:
        got = deposit_cells(pos, w, n, box, cb)
    ref = deposit_cells_plain(pos, w_ref, n, box, cb, zmajor)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=1e-5 * float(ref.abs().max()))
    _, _, in_halo = cell_geometry(pos, slice(0, C), n // cb, cb, n / box, zmajor)
    kept = float((w_ref.double() * in_halo).sum())
    assert float(got.sum(dtype=torch.float64)) == pytest.approx(kept, rel=1e-6, abs=1e-30)
    if ext is not None and cb == 2:
        got = launch_gather(pos, w, grids, n, box, cb, zmajor, ext=ext)
    elif cb == 2:
        got = gather_blocks(*pos, w, grids, n, box)
    else:  # the cells' wrapper takes the extents
        got = gather_cells(pos, w, grids, n, box, cb, ext=ext)
    ref = gather_cells_plain(pos, w_ref, grids, n, box, cb, zmajor)
    assert got.shape == (D, K, C)
    torch.testing.assert_close(got, ref, rtol=2e-5,
                               atol=1e-5 * max(float(ref.abs().max()), 1e-30))
    assert float(got.masked_fill(in_halo & (w_ref != 0), 0.0).abs().max()) == 0.0
    if case != "empty":
        assert float(got.abs().max()) > 0.0 and kept > 0.0
    # the wrappers count their launches; launch_deposit / launch_gather do not
    counted = (1 if case != "extents" else 0) + (1 if ext is None or cb != 2 else 0)
    assert dep.launches + gat.launches - sum(before) == counted


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("D", [1, 3, 5])
@pytest.mark.parametrize("K", [15, 16, 17, 32, 33, 300])
@pytest.mark.parametrize("n, cb", [(16, 8), (40, 8), (24, 4), (36, 4)])
def test_cells_gather_slab_edges(dev, n, cb, K, D, dtype):
    """The cells' gather (row 4) in column slabs of 32 columns and 16 rows:
    one column K rows deep on each side of a chunk's edge, and past
    several chunks; column counts below one slab (mesh 16, cb 8: 8
    columns; the mesh smaller than a tile), not a multiple of it (40 / 8:
    125; 24 / 4: 216; 36 / 4: 729); empty columns; D = 5, two launches of
    the kernel's 3 fields but one count; extents at the occupancy and cut
    below it.  Against the plain version (float: rtol 2e-5, atol
    1e-5·max|ref|; double: 1e-10 of max|ref|)."""
    from concept_tpu_torch.grid.cuda_cells import cut_rows, gather_cells, gather_cells_plain

    rng = np.random.default_rng(n * 1000 + K + D)
    box = 4.0
    s, w_np, counts = _slot_case(rng, n, cb, False, K, box, clump=K)
    C = w_np.shape[1]
    counts[rng.choice(C, size=max(1, C // 5), replace=False)] = 0  # empty columns
    counts[C // 2] = K
    valid = np.arange(K)[:, None] < counts[None, :]
    w_np = np.where(valid, w_np, 0.0)
    t = getattr(torch, dtype)
    pos = torch.as_tensor(s, device=dev).to(t)
    w = torch.as_tensor(w_np, device=dev).to(t)
    grids = torch.as_tensor(rng.standard_normal((D, n, n, n)), device=dev).to(t)
    occ = torch.as_tensor(np.where(valid, np.arange(1, K + 1)[:, None], 0).max(axis=0)
                          .astype(np.int32), device=dev)
    cut = torch.minimum(occ, torch.as_tensor(rng.integers(0, K + 1, size=C).astype(np.int32),
                                             device=dev))
    for ext in (None, occ, cut):
        before = (gather_cells.launches, gather_cells.launches_f64)
        got = gather_cells(pos, w, grids, n, box, cb, ext=ext)
        ref = gather_cells_plain(pos, cut_rows(w, ext), grids, n, box, cb)
        torch.cuda.synchronize()
        assert got.shape == (D, K, C)
        after = (gather_cells.launches, gather_cells.launches_f64)
        assert after == ((before[0] + 1, before[1]) if dtype == "float32"
                         else (before[0], before[1] + 1))
        scale = float(ref.abs().max())
        assert scale > 0
        if dtype == "float64":
            _close_f64(got, ref)
        else:
            torch.testing.assert_close(got, ref, rtol=2e-5, atol=1e-5 * scale)
        assert not got[:, :, torch.as_tensor(counts == 0, device=dev)].any()


@pytest.mark.parametrize("nc", [2, 5])
def test_on_subset_on_the_card_matches_the_cpu(dev, nc):
    """shortrange_momentum_updates_on_subset on the card (row 2: the
    unbounded ±1 sweep of receivers against suppliers; at 2 cells a side
    the folded plain sweep, no launch) against the same call on the CPU
    (the plain version), within the sweep tolerance."""
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep, pair_sweep_subset
    from concept_tpu_torch.forces.shortrange import shortrange_momentum_updates_on_subset

    rng = np.random.default_rng(4)
    box, N = 64.0, 3000
    sup = rng.uniform(0, box, (N, 3)).astype(np.float32)
    sup[:300] = np.mod(20.0 + rng.normal(0, 1.0, (300, 3)), box)  # a clump
    recv = sup[rng.choice(N, 700, replace=False)]
    cutoff = 0.97 * box / nc
    kw = dict(n_cells=nc, capacity_recv=400, capacity_sup=800, softening=0.3,
              softening_kernel="spline")
    out = []
    before = (pair_sweep_subset.launches, pair_sweep.launches)
    for device in ("cpu", dev):
        out.append(shortrange_momentum_updates_on_subset(
            torch.as_tensor(recv, device=device), torch.as_tensor(sup, device=device),
            2.0, box, cutoff / 4.5, cutoff, **kw).cpu())
    assert (pair_sweep_subset.launches, pair_sweep.launches) == (
        before[0] + (nc >= 3), before[1])
    ref = out[0]
    assert float((out[1] - ref).abs().max() / ref.abs().max()) < 1e-5


def test_p3m_step_on_the_card_matches_the_cpu(dev):
    """A P3MSimulation step (row 6 on the stored layout, rows 8-9 through
    the PM binding, with block overflow from a clump) on the card against
    the same step on the CPU: equal layouts and overflow, positions within
    5e-5 of the box, momenta within 1e-5 of the largest."""
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep_global
    from concept_tpu_torch.grid.cuda_blocks import deposit_blocks, gather_blocks
    from concept_tpu_torch.p3msim import P3MSimulation

    rng = np.random.default_rng(7)
    n_part, box = 24, 96.0
    N = n_part**3
    pos = rng.uniform(0, box, (N, 3)).astype(np.float32)
    pos[:500] = np.mod(40.0 + rng.normal(0, 3.0, (500, 3)), box)
    mom = (0.2 * rng.standard_normal((N, 3))).astype(np.float32)
    out = []
    for device in ("cpu", dev):
        sim = P3MSimulation(n_part, box, 2.0, 1.0, softening=0.1,
                            softening_kernel="spline")
        st = sim.init_state(tuple(torch.as_tensor(pos[:, d], device=device) for d in range(3)),
                            tuple(torch.as_tensor(mom[:, d], device=device) for d in range(3)))
        before = (pair_sweep_global.launches, deposit_blocks.launches, gather_blocks.launches)
        st, (n_over, _) = sim.step(st, 2e-3, 0.5)
        after = (pair_sweep_global.launches, deposit_blocks.launches, gather_blocks.launches)
        out.append((st.pos.cpu(), st.mom.cpu(), st.valid.cpu(), n_over))
    assert after == tuple(b + 1 for b in before)
    assert out[1][3] == out[0][3] > 0
    assert torch.equal(out[0][2], out[1][2])
    dx = out[1][0] - out[0][0]
    dx -= box * torch.round(dx / box)
    assert float(dx.abs().max()) <= 5e-5 * box
    assert float((out[1][1] - out[0][1]).abs().max()) <= 1e-5 * float(out[0][1].abs().max())


def test_lean_kick_on_the_card_matches_the_cpu(dev):
    """The memory-lean PM kick (row 3's deposit, row 4's gather at D = 1
    once a component) on the card against its plain versions on the CPU,
    at the deposit/gather tolerance; the stepper's dispatch takes it at
    mesh ≥ 768 on the card only."""
    from concept_tpu_torch.grid.cuda_cells import deposit_cells, gather_cells
    from concept_tpu_torch.p3mrungs import P3MRungSimulation
    from concept_tpu_torch.p3msim import pm_kick_cells_lean

    rng = np.random.default_rng(8)
    mesh, cb, K, box = 32, 8, 40, 64.0
    nc = mesh // cb
    C = nc**3
    cw = box / nc
    cells = np.arange(C)
    base = np.stack([cells // (nc * nc), (cells // nc) % nc, cells % nc]) * cw
    pos = (base[:, None, :] + rng.uniform(0.05, 0.95, (3, K, C)) * cw).astype(np.float32)
    valid = np.arange(K)[:, None] < rng.integers(0, K + 1, C)[None, :]
    # momenta 0 in the valid slots, so that the result is the kick itself,
    # and nonzero in the invalid ones, which the kick must zero
    mom = np.where(valid[None], 0, rng.standard_normal((3, K, C))).astype(np.float32)
    out = []
    before = (deposit_cells.launches, gather_cells.launches)
    for device in ("cpu", dev):
        m, _ = pm_kick_cells_lean(torch.as_tensor(pos, device=device),
                                  torch.tensor(mom, device=device),  # a copy: updated in place
                                  torch.as_tensor(valid, device=device), 2.0, 1.0, 1e-2,
                                  1.25 * box / mesh, box, mesh, cb=cb)
        out.append(m.cpu())
    assert (deposit_cells.launches, gather_cells.launches) == (before[0] + 1, before[1] + 3)
    assert not out[1][:, torch.as_tensor(~valid)].any()
    torch.testing.assert_close(out[1], out[0], rtol=2e-5,
                               atol=1e-5 * float(out[0].abs().max()))
    sim = P3MRungSimulation(384, 1000.0, 1.0, 1.0, mesh=768, device="cuda")
    assert sim.ucb == 8 and sim.pm_lean is None
    assert P3MRungSimulation(384, 1000.0, 1.0, 1.0, mesh=768, device="cuda",
                             pm_diff="spectral").pm_lean is False


# ---------------------------------------------------------------------- #
# The double kernels (float64 inputs) against their float64 plain
# versions, within 1e-10 of the largest plain value; each launch counted
# in ``launches_f64`` and none in ``launches``.

F64_TOL = 1e-10


def _close_f64(got, ref):
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype == torch.float64
    assert float((got - ref).abs().max()) <= F64_TOL * max(float(ref.abs().max()), 1e-300)


def _counts(*fns):
    return tuple((f.launches, f.launches_f64) for f in fns)


@pytest.mark.parametrize("kernel", ["plummer", "spline", "none"])
@pytest.mark.parametrize("case", ["occupancy", "unbounded", "deep", "subset"])
def test_pair_sweep_f64_matches_plain(dev, kernel, case):
    """The ±1 sweep's double instantiation (rows 1, 2, 6): with occupancy
    row bounds, without (receivers = suppliers), over columns of 600 rows
    (a third receiver pass, a second supplier tile, spline near-field
    pairs) and through pair_sweep_subset; exact screening."""
    from concept_tpu_torch.forces.cuda_shortrange import (
        pair_sweep, pair_sweep_plain, pair_sweep_subset,
    )

    rng = np.random.default_rng(61)
    box, soft = 1.0, 0.01
    if case == "deep":
        n, K = 4, 600
        s, _, ext = _layout(rng, n, 8, box, np.float64)
        s = np.concatenate([s, np.full((3, K - 8, n**3), 1e4 * box)], axis=1)
        col = 21
        base = np.array([col // 16, (col // 4) % 4, col % 4]) * (box / n)
        s[:, :, col] = base[:, None] + np.clip(rng.normal(0.5, 0.08, (3, K)), 0, 0.999) * box / n
        ext = ext.copy()
        ext[col // 4] = K
    else:
        n, K = 6, 24
        s, _, ext = _layout(rng, n, K, box, np.float64)
    st = torch.as_tensor(s, device=dev)
    e = torch.as_tensor(ext, device=dev) if case in ("occupancy", "deep") else None
    args = (n, box, 0.04, 0.16**2, soft**2, kernel)
    fn = pair_sweep_subset if case == "subset" else pair_sweep
    before = _counts(fn)
    if case == "subset":
        got = pair_sweep_subset(st[:, :16].contiguous(), st, *args)
        ref = pair_sweep_plain(st[:, :16].contiguous(), st, *args)
    else:
        got = pair_sweep(st, st, *args, rext=e, sext=e)
        ref = pair_sweep_plain(st, st, *args, rext=e, sext=e)
    assert _counts(fn) == ((before[0][0], before[0][1] + 1),)
    _close_f64(got, ref)
    if case == "deep":
        assert float(got[:, 512:, col].abs().max()) > 0  # the third receiver pass ran


@pytest.mark.parametrize("two_sided", [False, True])
@pytest.mark.parametrize("kernel", ["plummer", "spline", "none"])
def test_pair_sweep_reach_f64_matches_plain(dev, kernel, two_sided):
    """The reach sweep's double instantiation (rows 5, 7) at n = 5 with a
    clump of 600 slots, one-sided through pair_sweep_reach and two-sided
    through sweep_reach."""
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep_plain, pair_sweep_reach
    from concept_tpu_torch.forces.shortrange import sweep_reach

    rng = np.random.default_rng(43)
    n, K, box, soft = 5, 600, 1.0, 0.004
    C = n**3
    cw = box / n
    counts = rng.integers(0, 9, size=C)
    counts[C // 2] = K
    valid = np.arange(K)[:, None] < counts[None, :]
    cells = np.arange(C)
    base = np.stack([cells // (n * n), (cells // n) % n, cells % n]) * cw
    frac = rng.random((3, K, C))
    frac[:, :, C // 2] = np.clip(rng.normal(0.5, 0.05, (3, K)), 0.0, 0.999)
    s = np.where(valid[None], base[:, None, :] + frac * cw, 1e4 * box)
    st = torch.as_tensor(s, device=dev)
    scale, _, offs = _reach_geometry(n, box)
    cutoff = (4.5 * 1.25 / 4.0) * cw
    before = _counts(pair_sweep_reach, sweep_reach)
    if two_sided:
        v = torch.as_tensor(valid, device=dev)
        got = sweep_reach(*st, v, n, box, scale, cutoff, soft, cw, 0.55 * cw / 4.0,
                          kernel=kernel)
        ref = pair_sweep_plain(st, st, n, box, scale, cutoff**2, soft**2, kernel, offsets=offs)
        want = ((before[0][0], before[0][1] + 1), (before[1][0], before[1][1] + 1))
    else:
        recv = torch.where(torch.as_tensor(valid, device=dev)[None], st, -1e4 * box)
        got = pair_sweep_reach(recv, st, n, box, scale, cutoff**2, soft**2, offs,
                               kernel=kernel)
        ref = pair_sweep_plain(recv, st, n, box, scale, cutoff**2, soft**2, kernel,
                               offsets=offs)
        want = ((before[0][0], before[0][1] + 1), before[1])
    assert _counts(pair_sweep_reach, sweep_reach) == want
    _close_f64(got, ref)
    assert float(got[:, 512:, C // 2].abs().max()) > 0


@pytest.mark.parametrize("case", ["D3", "D1", "clump", "extents"])
@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("cb, zmajor", [(2, True), (8, False), (4, False)],
                         ids=["blocks", "cells8", "cells4"])
def test_slot_kernels_f64_match_plain(dev, cb, zmajor, n, case):
    """The double deposit (rows 3, 8: shared double atomics, a scalar
    double atomic a halo cell) and gathers (row 9 with cp.async of
    doubles, row 4 in column slabs of doubles) on the cases of
    test_slot_kernels_match_plain."""
    from concept_tpu_torch.grid.cuda_blocks import deposit_blocks, gather_blocks
    from concept_tpu_torch.grid.cuda_cells import (
        deposit_cells, deposit_cells_plain, gather_cells, gather_cells_plain, launch_deposit,
        launch_gather,
    )

    rng = np.random.default_rng(n + cb + 100)
    box = 4.0
    K = 600 if case == "clump" else 12
    s, w_np, _ = _slot_case(rng, n, cb, zmajor, K, box, clump=600 if case == "clump" else 0)
    pos = torch.as_tensor(s.astype(np.float64), device=dev)
    w = torch.as_tensor(w_np.astype(np.float64), device=dev)
    C = w.shape[1]
    ext = w_ref = None
    if case == "extents":
        ext = torch.as_tensor(rng.integers(0, K + 1, size=C).astype(np.int32), device=dev)
        w_ref = w * (torch.arange(K, device=dev)[:, None] < ext[None, :])
    else:
        w_ref = w
    D = 1 if case == "D1" else 3
    grids = torch.as_tensor(rng.standard_normal((D, n, n, n)), device=dev)
    dep, gat = ((deposit_blocks, gather_blocks) if cb == 2 else (deposit_cells, gather_cells))
    before = _counts(dep, gat)
    if ext is not None:
        got = launch_deposit(pos, w, n, box, cb, zmajor, ext=ext)
    elif cb == 2:
        got = deposit_blocks(*pos, w, n, box)
    else:
        got = deposit_cells(pos, w, n, box, cb)
    if ext is not None and cb == 2:
        gat_got = launch_gather(pos, w, grids, n, box, cb, zmajor, ext=ext)
    elif cb == 2:
        gat_got = gather_blocks(*pos, w, grids, n, box)
    else:
        gat_got = gather_cells(pos, w, grids, n, box, cb, ext=ext)
    _close_f64(got, deposit_cells_plain(pos, w_ref, n, box, cb, zmajor))
    _close_f64(gat_got, gather_cells_plain(pos, w_ref, grids, n, box, cb, zmajor))
    counted = (0 if ext is not None else 1, 0 if ext is not None and cb == 2 else 1)
    assert _counts(dep, gat) == tuple((b[0], b[1] + k) for b, k in zip(before, counted))


@pytest.mark.parametrize("n, D, capacity", [(32, 3, None), (18, 1, None), (16, 3, 32)])
def test_pm_block_kernels_f64_match_plain(dev, n, D, capacity):
    """Rows 10 and 11 in double on block-sorted particles with a clump
    of 600 in one block (nb below the tile along z at n = 16, counts
    clamped to a capacity)."""
    from concept_tpu_torch.grid.bucketed import sort_blocks
    from concept_tpu_torch.grid.cuda_pm import (
        deposit_pm, deposit_pm_plain, gather_pm, gather_pm_plain,
    )

    _, pos32 = _clumped_blocks(dev, n, 3 * n**3 // 8, 600)
    sb = sort_blocks(pos32.double(), n, 4.0)
    counts = sb["counts"] if capacity is None else torch.clamp(sb["counts"], max=capacity)
    args = (sb["lidx"], sb["fx"], sb["fy"], sb["fz"])
    assert sb["fx"].dtype == torch.float64
    N = sb["lidx"].shape[0]
    q = torch.full((N,), 1.3, dtype=torch.float64, device=dev)
    grids = torch.as_tensor(np.random.default_rng(4).standard_normal((D, n, n, n)), device=dev)
    before = _counts(deposit_pm, gather_pm)
    got = deposit_pm(*args, q, sb["starts"], counts, n)
    _close_f64(got, deposit_pm_plain(*args, q, sb["starts"], counts, n))
    got = gather_pm(*args, sb["starts"], counts, grids, n)
    _close_f64(got, gather_pm_plain(*args, sb["starts"], counts, grids, n))
    assert _counts(deposit_pm, gather_pm) == tuple((b[0], b[1] + 1) for b in before)


def test_p3m_step_f64_on_the_card_matches_the_cpu(dev):
    """One global P³M step (the fused kick: rows 6, 8, 9) in float64 on the
    card against the same step on the CPU, within 1e-10."""
    from concept_tpu_torch.components import ComponentSpec, ParticleState
    from concept_tpu_torch.cosmology.background import Background
    from concept_tpu_torch.grid.cuda_blocks import deposit_blocks
    from concept_tpu_torch.sim import SimConfig, Simulation

    rng = np.random.default_rng(7)
    N, box = 12**3, 64.0
    pos = rng.uniform(0, box, (N, 3))
    mom = rng.normal(0, 1e-3, (N, 3))
    out = []
    before = _counts(deposit_blocks)
    for d in ("cuda", "cpu"):
        cfg = SimConfig(boxsize=box, potential_gridsize=24, device=torch.device(d),
                        dtype=torch.float64, G=1.0, softening=0.05, softening_kernel="spline")
        sim = Simulation(ComponentSpec(name="m", species="matter", N=N, mass=1.0), cfg,
                         Background(H0=0.07, Omega_m=0.3))
        # copies: the kick updates the momenta in place
        st = ParticleState(pos=torch.tensor(pos, device=d), mom=torch.tensor(mom, device=d))
        st = sim.step(st, 1e-2, 1e-2)
        out.append((st.pos.cpu(), st.mom.cpu()))
    assert _counts(deposit_blocks)[0] == (before[0][0], before[0][1] + 1)
    assert float((out[0][0] - out[1][0]).abs().max()) <= 1e-10 * box
    dm = float((out[0][1] - out[1][1]).abs().max())
    assert dm <= 1e-10 * float((out[1][1] - torch.as_tensor(mom)).abs().max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kernel", ["plummer", "spline", "none"])
@pytest.mark.parametrize("row", ["two_sided", "subset"])
def test_sweeps_at_zero_softening_match_plain(dev, row, kernel, dtype):
    """Rows 6 (receivers = suppliers, ``pair_sweep_global`` without
    bounds) and 2 (one component's slots against another's,
    ``pair_sweep_subset``) at soft2 = 0, as a
    run of several components sweeps (softening 0, the Plummer kernel):
    near pairs at 1e-4 of a cell feel the unsoftened force, and the
    pairs of coincident particles (one of each component on the same
    point, r = 0) none.  The near pairs' forces exceed the others' by
    ~1e8, so each receiver is judged on its own scale
    (_close_per_receiver), within 1e-5 in float32 and 1e-10 in float64."""
    from concept_tpu_torch.forces.cuda_shortrange import (
        pair_sweep_global, pair_sweep_plain, pair_sweep_subset,
    )

    np_dtype = np.float64 if dtype == "float64" else np.float32
    rng = np.random.default_rng(71)
    n, K, box = 5, 24, 1.0
    s, valid, _ = _layout(rng, n, K, box, np_dtype)
    # a near pair in every column that holds two slots
    two = valid[1]
    s[:, 1, two] = s[:, 0, two] + np_dtype(1e-4 * box / n)
    other = s.copy()
    other[:, :, ::2] = s[:, :, ::2] + rng.normal(0, 0.01, (3, K, 1)).astype(np_dtype) * valid[
        :, ::2][None]
    st, so = torch.as_tensor(s, device=dev), torch.as_tensor(other, device=dev)
    args = (n, box, 0.05, float(np_dtype(0.2) ** 2), 0.0, kernel)
    fn = pair_sweep_global if row == "two_sided" else pair_sweep_subset
    before = _counts(fn)
    if row == "two_sided":
        got, ref = pair_sweep_global(st, st, *args), pair_sweep_plain(st, st, *args)
    else:
        got, ref = pair_sweep_subset(st, so, *args), pair_sweep_plain(st, so, *args)
    f64 = dtype == "float64"
    assert _counts(fn) == ((before[0][0] + (not f64), before[0][1] + f64),)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _close_per_receiver(got, ref, F64_TOL if f64 else 1e-5)


def _close_per_receiver(got, ref, tol):
    """|Δ_i| ≤ tol·max(|ref_i|, median |ref|) for every receiver i, with
    |·| the norm of a receiver's force (the leading axis of (3, K, C))
    and the median over the receivers that feel one."""
    d = (got - ref).double().norm(dim=0)
    r = ref.double().norm(dim=0)
    med = float(r[r > 0].median())
    worst = float((d / r.clamp(min=med)).max())
    assert worst <= tol, worst


def _planes_case(dev, dtype, n=8, cb=8, K=24, seed=21):
    """A random (K, C) cell layout over nc = n planes of cells (n mesh
    cells·cb a side), a third of its first and last planes' slots across
    the box faces, as the rung stepper over ranks meets them."""
    rng = np.random.default_rng(seed)
    box, C, P = 4.0, n**3, n * n
    counts = rng.integers(0, K + 1, size=C)
    valid = np.arange(K)[:, None] < counts[None, :]
    cells = np.arange(C)
    cw = box / n
    base = np.stack([cells // P, (cells // n) % n, cells % n]) * cw
    pos = base[:, None, :] + rng.random((3, K, C)) * cw
    h = box / (n * cb)
    plane = cells // P
    pos[0][valid & (plane == 0)[None] & (rng.random((K, C)) < 0.3)] = box - 0.3 * h
    pos[0][valid & (plane == n - 1)[None] & (rng.random((K, C)) < 0.3)] = 0.2 * h
    t = torch.as_tensor(pos.astype(dtype), device=dev)
    return t, torch.as_tensor(valid, device=dev), counts.astype(np.int32), box


def _rank_planes_idx(n, d, r, width, dev):
    """(the columns of rank r's planes of an n³ column grid over d ranks,
    parallel/step.plane_starts, between ``width`` neighbour planes a side;
    each column's ∓box shift along x; first plane; planes)."""
    from concept_tpu_torch.parallel.step import plane_starts

    P = n * n
    starts = plane_starts(n, d)
    x0, npl = starts[r], starts[r + 1] - starts[r]
    planes = torch.arange(x0 - width, x0 + npl + width)
    idx = (torch.remainder(planes, n)[:, None] * P + torch.arange(P)[None]).reshape(-1)
    shift = torch.repeat_interleave((planes >= n).double() - (planes < 0).double(), P)
    return idx.to(dev), shift.to(dev), x0, npl


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [1, 2, 4, 3])
def test_pair_sweep_over_planes_matches_plain(dev, d, dtype):
    """Row 1 at nx = planes + 2 (a rank's planes between its neighbour
    planes, receiver bounds 0 there; 3 + 2 + 3 planes at d = 3) against
    its plain version, and at nx = n bit for bit the launch without nx."""
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep, pair_sweep_plain

    n, P = 8, 64
    pos, valid, occ, box = _planes_case(dev, np.dtype(dtype))
    s = torch.where(valid[None], pos, 1e4 * box)
    args = (n, box, 0.06, 0.24**2, 0.02**2, "spline")
    occ_t = torch.as_tensor(occ, device=dev)
    whole = pair_sweep(s, s, *args, rext=occ_t, sext=occ_t)
    assert torch.equal(pair_sweep(s, s, *args, rext=occ_t, sext=occ_t, nx=n), whole)
    for r in range(d):
        idx, shift, x0, npl = _rank_planes_idx(n, d, r, 1, dev)
        sup = s[:, :, idx].clone()
        sup[0] += (shift * box).to(sup.dtype)[None]
        rb = occ_t[idx].clone()
        rb[:P] = rb[-P:] = 0
        before = pair_sweep.launches + pair_sweep.launches_f64
        got = pair_sweep(sup[:, :16], sup, *args, rext=rb, sext=occ_t[idx], nx=npl + 2)
        assert pair_sweep.launches + pair_sweep.launches_f64 == before + 1
        ref = pair_sweep_plain(sup[:, :16], sup, *args, rext=rb, sext=occ_t[idx], nx=npl + 2)
        torch.cuda.synchronize()
        tol = 1e-10 if dtype == "float64" else 1e-5
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
        assert float((got[:, :, P:-P] - whole[:, :16, x0 * P:(x0 + npl) * P]).abs().max()) \
            <= tol * float(whole.abs().max())
        assert bool((got[:, :, :P] == 0).all()) and bool((got[:, :, -P:] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_reach_sweep_over_planes_matches_plain(dev, d, dtype):
    """Row 5 at nx = planes + 4 (a rank's planes between two neighbour
    planes a side, receivers at the opposite sentinel, receiver bounds 0
    on the neighbour planes; 3 + 2 + 3 planes at d = 3) against its plain
    version and against the whole launch's rows, and at nx = n bit for
    bit the launch without nx."""
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep_reach, pair_sweep_plain
    from concept_tpu_torch.forces.shortrange import reach_offsets

    n, P, K_r = 8, 64, 16
    pos, valid, occ, box = _planes_case(dev, np.dtype(dtype), cb=4)
    cw = box / n
    offsets = reach_offsets(cw, 0.55 * cw / 4.0)
    scale = 1.25 * cw / 4.0
    args = (n, box, scale, (4.5 * scale) ** 2, (0.03 * cw) ** 2)
    s = torch.where(valid[None], pos, 1e4 * box)
    recv = torch.where(valid[None], pos, -1e4 * box)[:, :K_r].contiguous()
    occ_t = torch.as_tensor(occ, device=dev)
    whole = pair_sweep_reach(recv, s, *args, offsets, kernel="spline", rext=occ_t,
                             sext=occ_t)
    assert torch.equal(pair_sweep_reach(recv, s, *args, offsets, kernel="spline",
                                        rext=occ_t, sext=occ_t, nx=n), whole)
    tol = 1e-10 if dtype == "float64" else 1e-5
    for r in range(d):
        idx, shift, x0, npl = _rank_planes_idx(n, d, r, 2, dev)
        sup = s[:, :, idx].clone()
        sup[0] += (shift * box).to(sup.dtype)[None]
        rcv = torch.where(sup.abs() < 5e3 * box, sup, -1e4 * box)[:, :K_r].contiguous()
        rb = occ_t[idx].clone()
        rb[:2 * P] = rb[-2 * P:] = 0
        kw = dict(kernel="spline", rext=rb, sext=occ_t[idx], nx=npl + 4)
        before = pair_sweep_reach.launches + pair_sweep_reach.launches_f64
        got = pair_sweep_reach(rcv, sup, *args, offsets, **kw)
        assert pair_sweep_reach.launches + pair_sweep_reach.launches_f64 == before + 1
        ref = pair_sweep_plain(rcv, sup, *args, offsets=offsets, **kw)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
        assert float((got[:, :, 2 * P:-2 * P] - whole[:, :, x0 * P:(x0 + npl) * P]).abs()
                     .max()) <= tol * float(whole.abs().max())
        assert bool((got[:, :, :2 * P] == 0).all()) and bool((got[:, :, -2 * P:] == 0).all())


def _cells_over_planes(dev, d, dtype, n, cb):
    """Rows 3 and 4 on each rank's planes (the slab mesh with a halo row a
    side) against their plain versions; summed over the ranks (halo rows
    wrapped) the deposits are the whole mesh's deposit and the gathers the
    parts of its gather."""
    from concept_tpu_torch.grid.cuda_cells import (
        deposit_cells, deposit_cells_plain, gather_cells, gather_cells_plain,
    )
    from concept_tpu_torch.parallel.step import plane_starts

    P = n * n
    m = n * cb
    pos, valid, occ, box = _planes_case(dev, np.dtype(dtype), n=n, cb=cb)
    w = valid.to(pos.dtype)
    occ_t = torch.as_tensor(occ, device=dev)
    grids = torch.randn((3, m, m, m), dtype=pos.dtype, device=dev,
                        generator=torch.Generator(dev).manual_seed(3))
    whole = deposit_cells(pos, w, m, box, cb)
    whole_g = gather_cells(pos, w, grids, m, box, cb, ext=occ_t)
    tol = dict(rtol=1e-10, atol=1e-10) if dtype == "float64" else dict(rtol=2e-5, atol=1e-5)

    def close(got, ref):
        ref = ref.cpu().numpy()
        np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=tol["rtol"],
                                   atol=tol["atol"] * np.abs(ref).max())

    close(whole, deposit_cells_plain(pos, w, m, box, cb))
    summed = torch.zeros_like(whole)
    starts = plane_starts(n, d)
    for r in range(d):
        x0, npl = starts[r], starts[r + 1] - starts[r]
        cols = slice(x0 * P, (x0 + npl) * P)
        part, wp = pos[:, :, cols].contiguous(), w[:, cols].contiguous()
        rows = torch.remainder(torch.arange(npl * cb + 2, device=dev) + x0 * cb - 1, m)
        before = deposit_cells.launches + deposit_cells.launches_f64
        slab = deposit_cells(part, wp, m, box, cb, planes=(x0, npl))
        assert deposit_cells.launches + deposit_cells.launches_f64 == before + 1
        close(slab, deposit_cells_plain(part, wp, m, box, cb, planes=(x0, npl)))
        summed.index_add_(0, rows, slab)
        g = grids[:, rows].contiguous()
        got = gather_cells(part, wp, g, m, box, cb, ext=occ_t[cols].contiguous(),
                           planes=(x0, npl))
        close(got, gather_cells_plain(part, wp * (torch.arange(wp.shape[0], device=dev)[:, None]
                                                  < occ_t[cols][None]), g, m, box, cb,
                                      planes=(x0, npl)))
        close(got, whole_g[:, :, cols])
    close(summed, whole)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_cells_over_planes_match_plain(dev, d, dtype):
    """Rows 3 and 4 at cb = 8 on n/d planes a rank (:func:`_cells_over_planes`).
    (At nx = nc the kernels' outputs against the parent commit's:
    scripts/nx_parity.py.)"""
    _cells_over_planes(dev, d, dtype, 8, 8)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [2, 3])
def test_cb4_cells_over_uneven_planes_match_plain(dev, d, dtype):
    """Rows 3 and 4 at cb = 4 on nc = 7 planes (4 + 3; 2 + 3 + 2), the
    4-mesh-cell layout's PM over ranks."""
    _cells_over_planes(dev, d, dtype, 7, 4)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [1, 3])
def test_blocks_over_planes_match_plain(dev, d, dtype):
    """Rows 8 and 9 on planes of the 2-mesh-cell blocks (the tight rung
    layout's PM over ranks; the whole at d = 1, 5 + 6 + 5 of the 16 block
    planes at d = 3) against their plain versions; summed over the ranks
    (halo rows wrapped) the deposits are the whole mesh's block deposit,
    and each particle's gathered value is the whole gather's."""
    from concept_tpu_torch.forces.p3m import block_layout
    from concept_tpu_torch.grid.cuda_blocks import (
        deposit_blocks, deposit_blocks_plain, gather_blocks, gather_blocks_plain,
    )
    from concept_tpu_torch.grid.cuda_cells import cut_rows
    from concept_tpu_torch.parallel.step import plane_starts

    t = getattr(torch, dtype)
    g = torch.Generator(dev).manual_seed(17)
    n, box, k_pm = 64, 2.0, 8
    h, nb = box / n, n // 2
    p = torch.rand((60000, 3), dtype=t, device=dev, generator=g) * box
    p[:2000, 0] *= 0.5 * h / box
    p[2000:4000, 0] = box - p[2000:4000, 0] * (0.5 * h / box)
    grids = torch.randn((3, n, n, n), dtype=t, device=dev, generator=g)
    tol = dict(rtol=1e-10, atol=1e-10) if dtype == "float64" else dict(rtol=2e-5, atol=1e-5)

    def close(got, ref):
        ref = ref.cpu().numpy()
        np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=tol["rtol"],
                                   atol=tol["atol"] * np.abs(ref).max())

    def by_particle(lay, vals):
        out = torch.zeros((3, lay["order"].shape[0]), dtype=t, device=dev)
        keep = lay["slot"] < vals[0].numel()
        out[:, lay["order"][keep]] = vals.reshape(3, -1)[:, lay["slot"][keep]]
        return out

    lay = block_layout(*p.T, n, box, k_pm)
    w = lay["valid"].to(t)
    whole = deposit_blocks(*lay["slots"], w, n, box, ext=lay["ext"])
    whole_g = by_particle(lay, gather_blocks(*lay["slots"], w, grids, n, box, ext=lay["ext"]))
    summed = torch.zeros_like(whole)
    bx = torch.clamp((p[:, 0] / h).to(torch.int64), 0, n - 1) // 2
    starts = plane_starts(nb, d)
    for r in range(d):
        x0, npl = starts[r], starts[r + 1] - starts[r]
        mine = torch.nonzero((bx >= x0) & (bx < x0 + npl)).reshape(-1)
        pl = block_layout(*p[mine].T, n, box, k_pm, planes=(x0, npl))
        wp, ext, planes = pl["valid"].to(t), pl["ext"], (x0, npl)
        rows = torch.remainder(torch.arange(2 * npl + 2, device=dev) + 2 * x0 - 1, n)
        before = deposit_blocks.launches + deposit_blocks.launches_f64
        slab = deposit_blocks(*pl["slots"], wp, n, box, ext=ext, planes=planes)
        assert deposit_blocks.launches + deposit_blocks.launches_f64 == before + 1
        close(slab, deposit_blocks_plain(*pl["slots"], cut_rows(wp, ext), n, box, planes))
        summed.index_add_(0, rows, slab)
        gs = grids[:, rows].contiguous()
        before = gather_blocks.launches + gather_blocks.launches_f64
        got = gather_blocks(*pl["slots"], wp, gs, n, box, ext=ext, planes=planes)
        assert gather_blocks.launches + gather_blocks.launches_f64 == before + 1
        close(got, gather_blocks_plain(*pl["slots"], cut_rows(wp, ext), gs, n, box, planes))
        # the slots within the capacity, as in the whole layout
        both = (by_particle(pl, got) != 0).any(0) & (whole_g[:, mine] != 0).any(0)
        close(by_particle(pl, got)[:, both], whole_g[:, mine][:, both])
    close(summed, whole)


# ---------------------------------------------------------------------- #
# The global kernel (rows 6 and 2) with the occupancy bounds its callers
# pass: against the plain version, and bit for bit against the unbounded
# launch of row 1's kernel (pair_sweep without bounds), which is what rows
# 6 and 2 launched before they had a kernel of their own.


def _global_case(rng, case, dtype):
    """(receivers (3, K_r, C), suppliers (3, K_s, C), rext, sext, n, box,
    soft, per-receiver judging) of one global-sweep case, on the CPU."""
    from concept_tpu_torch.forces.shortrange import SENTINEL, bucketize, occupancy_bounds
    from concept_tpu_torch.p3mrungs import _column_occ_ext

    box = 1.0

    def bucketized(pos, n, K):
        b = bucketize(tuple(torch.as_tensor(pos[:, d].astype(dtype)) for d in range(3)),
                      box, n, K)
        slots = torch.where(b["valid"][None], torch.stack([b["hx"], b["hy"], b["hz"]]),
                            SENTINEL * box)
        return slots.contiguous(), occupancy_bounds(b["counts"], K)

    if case == "deep":  # clumps of up to 600 rows: several items a column
        n = 5
        pos = rng.uniform(0, box, (3000, 3))
        for i, c in enumerate(([0.5, 0.5, 0.5], [0.05, 0.95, 0.5], [0.9, 0.1, 0.1])):
            pos[600 * i:600 * i + 500 + 50 * i] = np.mod(
                np.array(c) + rng.normal(0, 0.02, (500 + 50 * i, 3)), box)
        s, e = bucketized(pos, n, 600)
        return s, s, e, e, n, box, 0.005, False
    if case == "sparse":  # row 2: 99 % of the receiver columns empty, K_r > 256
        n = 10
        recv = np.concatenate([np.clip(0.45 + rng.normal(0, 0.02, (290, 3)), 0.401, 0.499),
                               rng.uniform(0, box, (8, 3))])
        r, re = bucketized(recv, n, 300)
        s, se = bucketized(rng.uniform(0, box, (8000, 3)), n, 32)
        return r, s, re, se, n, box, 0.01, False
    if case == "soft0":  # near pairs at softening 0, judged per receiver
        n = 6
        pos = rng.uniform(0, box, (4000, 3))
        pos[1::2] = pos[::2] + 1e-4 * box / n
        s, e = bucketized(np.mod(pos, box), n, 64)
        return s, s, e, e, n, box, 0.0, True
    # "counts" / "occ": an nx = n grid from a bucketize (bounds from its
    # counts) or a persistent layout with holes (bounds _column_occ_ext)
    n, K = 7, 40
    pos = rng.uniform(0, box, (6000, 3))
    pos[:1500] = np.mod(0.3 + rng.normal(0, 0.05, (1500, 3)), box)
    s, e = bucketized(pos, n, K)
    if case == "occ":
        valid = (s[0] < 0.5 * SENTINEL * box) & torch.as_tensor(rng.random(s.shape[1:]) < 0.7)
        s = torch.where(valid[None], s, SENTINEL * box).contiguous()
        e = _column_occ_ext(valid)
    return s, s, e, e, n, box, 0.01, False


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kernel", ["plummer", "spline"])
@pytest.mark.parametrize("case", ["deep", "sparse", "soft0", "counts", "occ"])
def test_global_sweep_matches_plain_and_unbounded(dev, case, kernel, dtype):
    """Rows 6 and 2 through the global kernel on clumped deep columns (K =
    600: several items a column), row 2 with 99 % of its receiver columns
    empty (K_r = 300), softening 0 (judged per receiver), and an n grid
    with bounds from counts and from ``_column_occ_ext`` (holes): within
    1e-5 (float) or 1e-10 (double) of the plain version, equal bit for
    bit to the unbounded launch, one launch counted, rows at or beyond a
    bound exactly 0."""
    from concept_tpu_torch.forces.cuda_shortrange import (
        pair_sweep, pair_sweep_global, pair_sweep_plain, pair_sweep_subset,
    )

    np_dtype = np.float64 if dtype == "float64" else np.float32
    rng = np.random.default_rng(["deep", "sparse", "soft0", "counts", "occ"].index(case))
    recv, sup, rext, sext, n, box, soft, per_recv = _global_case(rng, case, np_dtype)
    recv, sup, rext, sext = (t.to(dev) for t in (recv, sup, rext, sext))
    args = (n, box, 0.22 / n, float(np_dtype(0.95 / n) ** 2), float(np_dtype(soft) ** 2),
            kernel)
    fn = pair_sweep_subset if case == "sparse" else pair_sweep_global
    f64 = dtype == "float64"
    before = _counts(fn)
    got = fn(recv, sup, *args, rext=rext, sext=sext)
    assert _counts(fn) == ((before[0][0] + (not f64), before[0][1] + f64),)
    unbounded = pair_sweep(recv, sup, *args)
    ref = pair_sweep_plain(recv, sup, *args, rext=rext, sext=sext)
    torch.cuda.synchronize()
    assert torch.equal(got, unbounded)
    K_r = recv.shape[1]
    assert not got[:, torch.arange(K_r, device=dev)[:, None] >= rext[None, :].long()].any()
    tol = F64_TOL if f64 else 1e-5
    if per_recv:
        _close_per_receiver(got, ref, tol)
    else:
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
    if case == "deep":
        assert int(rext.max()) > 512 and float(got[:, 512:].abs().max()) > 0
