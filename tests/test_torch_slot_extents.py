"""The host side of the slot-layout CIC kernels (concept_tpu_torch.grid.
cuda_cells, grid/cuda_blocks, forces/p3m.block_layout), on the CPU: the
per-block row extents the P³M block path passes to the kernels, against
a direct numpy count; the rows they cut (the plain path's cut_rows);
that the cut changes nothing where the extents come from the layout; and
the wrappers' checks of the layouts and extents the kernels take, which
raise before any kernel is built."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

from concept_tpu_torch.forces.p3m import block_layout  # noqa: E402
from concept_tpu_torch.grid.cuda_blocks import (  # noqa: E402
    deposit_blocks, deposit_blocks_plain, gather_blocks, gather_blocks_plain,
)
from concept_tpu_torch.grid.cuda_cells import (  # noqa: E402
    cut_rows, launch_deposit, launch_gather,
)

BOX = 4.0


def _particles(seed, N, clump=0, mesh=16):
    """N uniform particles and ``clump`` more in the first block."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, BOX, (N + clump, 3))
    pos[:clump] = rng.uniform(0, 2 * BOX / mesh, (clump, 3))
    return pos.astype(np.float32)


@pytest.mark.parametrize("N, clump, k_pm", [(3000, 0, 8), (3000, 40, 8), (600, 0, 1)])
def test_block_extents_count_the_rows(N, clump, k_pm):
    """block_layout's ext: each block's particle count clamped to K, as a
    direct numpy count of the z-major block ids gives it, int32; and 1 +
    the block's last valid row."""
    mesh = 16
    pos = _particles(1, N, clump, mesh)
    lay = block_layout(*torch.as_tensor(pos.T.copy()), mesh, BOX, k_pm)
    b = np.minimum((pos * np.float32(mesh / BOX)).astype(np.int64), mesh - 1) // 2
    nb = mesh // 2
    counts = np.bincount((b[:, 2] * nb + b[:, 1]) * nb + b[:, 0], minlength=nb**3)
    ext = lay["ext"]
    assert ext.dtype == torch.int32 and ext.is_contiguous()
    np.testing.assert_array_equal(ext.numpy(), np.minimum(counts, k_pm))
    valid = lay["valid"].numpy()
    last = np.where(valid, np.arange(1, k_pm + 1)[:, None], 0).max(axis=0)
    np.testing.assert_array_equal(ext.numpy(), last)


def test_cut_rows_against_numpy():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((7, 30)).astype(np.float32)
    ext = rng.integers(0, 9, size=30).astype(np.int32)
    wt = torch.as_tensor(w)
    got = cut_rows(wt, torch.as_tensor(ext)).numpy()
    np.testing.assert_array_equal(got, np.where(np.arange(7)[:, None] < ext, w, 0.0))
    assert cut_rows(wt, None) is wt


def test_layout_extents_cut_nothing():
    """The CPU path with the layout's extents deposits and gathers what it
    does without them (every valid slot lies below its block's extent);
    extents that cut rows drop those rows' particles."""
    mesh = 16
    pos = _particles(3, 2500, 30, mesh)
    lay = block_layout(*torch.as_tensor(pos.T.copy()), mesh, BOX, 8)
    w = lay["valid"].float() * 1.3
    grid = deposit_blocks(*lay["slots"], w, mesh, BOX, lay["ext"])
    torch.testing.assert_close(grid, deposit_blocks_plain(*lay["slots"], w, mesh, BOX),
                               rtol=0, atol=0)
    grids = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (3, mesh, mesh, mesh)).astype(np.float32))
    out = gather_blocks(*lay["slots"], w, grids, mesh, BOX, lay["ext"])
    torch.testing.assert_close(out, gather_blocks_plain(*lay["slots"], w, grids, mesh, BOX),
                               rtol=0, atol=0)
    cut = torch.clamp(lay["ext"] - 1, min=0)
    lost = float(deposit_blocks(*lay["slots"], w, mesh, BOX, cut).sum(dtype=torch.float64))
    dropped = int(lay["valid"].sum()) - int(cut.sum())
    assert dropped > 0
    assert lost == pytest.approx(1.3 * (int(lay["valid"].sum()) - dropped), rel=1e-5)
    out = gather_blocks(*lay["slots"], w, grids, mesh, BOX, cut)
    rows = torch.arange(8)[:, None]
    assert float(out[:, rows >= cut[None, :]].abs().max()) == 0.0


@pytest.mark.parametrize("cb, zmajor", [(8, True), (4, True), (2, False), (16, False)])
def test_deposit_kernel_refuses_other_layouts(cb, zmajor):
    """The deposit kernel takes the rung cells (cb 8 or 4, x-major) and the
    PM blocks (cb 2, z-major) only; the wrapper says so before building."""
    n = 32
    C = (n // cb) ** 3
    pos, w = torch.zeros((3, 2, C)), torch.ones((2, C))
    with pytest.raises(ValueError, match="cb 8 or 4"):
        launch_deposit(pos, w, n, BOX, cb, zmajor)


@pytest.mark.parametrize("ext, match", [
    (torch.zeros(512, dtype=torch.int64), "int32"),
    (torch.zeros(511, dtype=torch.int32), "int32"),
    (torch.zeros((512, 2), dtype=torch.int32)[:, 0], "int32"),
])
def test_wrappers_check_the_extents(ext, match):
    """Extents are contiguous int32 (C,): anything else raises before a
    kernel is built, on the blocks and on the cells (512 columns of cb 8
    on mesh 64), whose gather takes them too."""
    pos, w = torch.zeros((3, 2, 512)), torch.ones((2, 512))
    with pytest.raises(ValueError, match=match):
        launch_deposit(pos, w, 16, BOX, 2, True, ext=ext)
    with pytest.raises(ValueError, match=match):
        launch_gather(pos, w, torch.zeros((1, 16, 16, 16)), 16, BOX, 2, True, ext=ext)
    with pytest.raises(ValueError, match=match):
        launch_gather(pos, w, torch.zeros((1, 64, 64, 64)), 64, BOX, 8, False, ext=ext)
