"""CIC deposit and gather on the global stepper's PM blocks: the wrappers
of the CUDA kernels of csrc/cells.cu launched on 2³-mesh-cell blocks
(cb = B = 2, z-major block ids c = (bz·nb + by)·nb + bx), and their plain
PyTorch versions.

Port of ``deposit_pallas_pos`` / ``gather_pallas_pos``
(concept_tpu/grid/pallas_pm.py:289-395) without the lane padding: slots
(K, C), C = nb³ blocks, nb = n/2.  A slot is served when its CIC anchor
lies in its block ±1 mesh cell (``_slot_geometry``); the test here is
periodic (see grid/cuda_cells.py), which keeps exactly the slots the TPU
kernels keep whenever the blocks were built from wrapped positions, as
forces/p3m.py builds them at every kick.  ``planes`` = (bx0, nbx) takes a
rank's nbx planes of blocks along x from block plane bx0 on (the tight
rung layout's PM over ranks): C = nbx·nb² blocks, ids (bz·nb + by)·nbx +
bx − bx0, onto the (2·nbx + 2, n, n) slab mesh of grid/cuda_cells.py.

Positions, weights and meshes are all float32 or all float64 (the
kernels' double twins).  On CPU tensors the wrappers run the plain
versions; on CUDA tensors they launch the kernels or raise.  Launches are
counted as in grid/cuda_cells.py.
"""

from __future__ import annotations

from concept_tpu_torch import _build
from concept_tpu_torch.grid.bucketed import B
from concept_tpu_torch.grid.cuda_cells import (
    cut_rows, deposit_cells_plain, gather_cells_plain, launch_deposit, launch_gather,
)


def deposit_blocks_plain(px, py, pz, w, gridsize: int, boxsize: float, planes=None):
    """Plain PyTorch version of :func:`deposit_blocks`."""
    return deposit_cells_plain((px, py, pz), w, gridsize, boxsize, cb=B,
                               zmajor=True, planes=planes)


def gather_blocks_plain(px, py, pz, w, grids, gridsize: int, boxsize: float, planes=None):
    """Plain PyTorch version of :func:`gather_blocks`."""
    return gather_cells_plain((px, py, pz), w, grids, gridsize, boxsize, cb=B,
                              zmajor=True, planes=planes)


def deposit_blocks(px, py, pz, w, gridsize: int, boxsize: float, ext=None, planes=None):
    """CIC deposit of the per-slot weights w (mass·valid) from the (K, C)
    block slots px, py, pz onto the (n, n, n) mesh, or with ``planes``
    onto their slab mesh.  ``ext`` (C,) int32, optional, cuts block c to
    its first ext[c] rows (the kernel then skips the rows past every
    block's extent)."""
    if px.device.type == "cpu":
        _build.scalar_dtype("cic_deposit", px, py, pz, w)
        return deposit_blocks_plain(px, py, pz, cut_rows(w, ext), gridsize, boxsize, planes)
    grid = launch_deposit((px, py, pz), w, gridsize, boxsize, B, zmajor=True, ext=ext,
                          planes=planes)
    _build.count_launch(deposit_blocks, grid.dtype)
    return grid


def gather_blocks(px, py, pz, w, grids, gridsize: int, boxsize: float, ext=None,
                  planes=None):
    """CIC interpolation of D mesh fields at every block slot, times w
    (the validity): ``grids`` (D, n, n, n), or their slab meshes with
    ``planes``, → (D, K, C); ``ext`` as in :func:`deposit_blocks`."""
    if px.device.type == "cpu":
        _build.scalar_dtype("cic_gather", px, py, pz, w, grids)
        return gather_blocks_plain(px, py, pz, cut_rows(w, ext), grids, gridsize, boxsize,
                                   planes)
    out = launch_gather((px, py, pz), w, grids, gridsize, boxsize, B, zmajor=True, ext=ext,
                        planes=planes)
    _build.count_launch(gather_blocks, out.dtype)
    return out


for _f in (deposit_blocks, gather_blocks):
    _f.launches = _f.launches_f64 = 0
