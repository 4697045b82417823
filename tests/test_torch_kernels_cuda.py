"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without a card they skip (the fixture decides).
On a machine with the card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the sweep max|Δ|/max|ref| < 1e-5 (summation order, FMA
contraction in the force); deposit and gather rtol 2e-5 / atol
1e-5·max|ref| (atomics add in no fixed order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (kernels built for sm_90a)")
    return torch.device("cuda")


def _layout(rng, n, K, box):
    """Random prefix-valid sentinel layout over n³ cells and its
    per-pencil extents (as tests/test_torch_shortrange.py)."""
    C = n**3
    counts = rng.integers(0, K + 1, size=C)
    valid = np.arange(K)[:, None] < counts[None, :]
    cells = np.arange(C)
    cw = box / n
    base = np.stack([cells // (n * n), (cells // n) % n, cells % n]) * cw
    pos = base[:, None, :] + rng.random((3, K, C)) * cw
    s = np.where(valid[None], pos, 1e4 * box).astype(np.float32)
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


def test_deposit_and_gather_match_plain(dev):
    from concept_tpu_torch.grid.cuda_cells import (
        deposit_cells, deposit_cells_plain, gather_cells, gather_cells_plain,
    )

    rng = np.random.default_rng(8)
    n, box = 32, 4.0
    nc = n // 8
    s, valid, _ = _layout(rng, nc, 16, box)
    C = nc**3
    valid[0, 0] = valid[0, C - 1] = True
    s = np.where(valid[None], s, 0.0).astype(np.float32)
    h = box / n
    s[:, 0, 0] = np.array([20.4, 1.3, 2.2]) * h               # out of its halo: dropped
    s[:, 0, C - 1] = np.array([0.3, n - 3.5, n - 2.5]) * h    # across the box face: kept
    pos = torch.as_tensor(s, device=dev)
    w = torch.as_tensor(valid.astype(np.float32) * 0.7, device=dev)
    got, ref = deposit_cells(pos, w, n, box), deposit_cells_plain(pos, w, n, box)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=1e-5 * float(ref.abs().max()))
    grids = torch.as_tensor(rng.standard_normal((3, n, n, n)).astype(np.float32), device=dev)
    wv = (w > 0).float()
    got = gather_cells(pos, wv, grids, n, box)
    ref = gather_cells_plain(pos, wv, grids, n, box)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=1e-5 * float(ref.abs().max()))
    assert float(got[:, 0, 0].abs().max()) == 0.0
    assert float(got[:, 0, C - 1].abs().max()) > 0.0


def test_float64_on_the_card_raises(dev):
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep

    s = torch.zeros((3, 8, 27), dtype=torch.float64, device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pair_sweep(s, s, 3, 1.0, 0.1, 0.2, 0.0)
