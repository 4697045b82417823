"""CIC deposit and gather straight from the (K, C) cell layout: the CUDA
kernels' wrappers (csrc/cells.cu) and their plain PyTorch versions.

Port of ``deposit_pallas_cells`` / ``gather_pallas_cells``
(concept_tpu/grid/pallas_cells.py).  Cells are ``cb`` mesh cells wide,
C = nc³ with ids (cx·nc + cy)·nc + cz, and the mesh is n = cb·nc cells a
side, cell-centred.  A slot whose CIC cloud leaves its cell's
±1-mesh-cell halo is dropped, as the TPU kernels' mini-grids drop it
(``_cell_geometry``): the deposited mass then falls short, which the
rung stepper checks.  The halo test here is periodic, where the TPU
kernels' is not: a particle that crossed a box face since the last
rebucket is kept (the JAX kernels drop it until the next rebucket).
``pos3`` (3, K, C) may be a row slice of a larger slot array; ``w``
(K, C) is the per-slot weight (mass·valid for the deposit, valid for the
gather).

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from concept_tpu_torch import _build
from concept_tpu_torch.device import FLOAT64_ITEM


def _check(pos3, w, gridsize: int, cb: int):
    if gridsize % cb:
        raise ValueError(f"mesh {gridsize} is not a multiple of cb = {cb}")
    nc = gridsize // cb
    K, C = w.shape
    if C != nc**3 or tuple(pos3.shape) != (3, K, C):
        raise ValueError(f"pos3 {tuple(pos3.shape)} / w {tuple(w.shape)} do "
                         f"not fit nc = {nc}")
    return nc, K, C


def cell_geometry(pos3, cols, nc: int, cb: int, inv_h: float):
    """CIC anchors, fractions and the halo test of slots in columns
    ``cols``: ((ix, iy, iz) int64, (fx, fy, fz), in_halo), each (K, cols).
    The halo test is periodic: a slot that crossed a box face since the
    last rebucket sits at the far side of the box in [0, boxsize), and its
    anchor lies in its cell's halo modulo the mesh."""
    n = nc * cb
    cells = torch.arange(cols.start, cols.stop, device=pos3.device)
    anchors, fracs, in_halo = [], [], None
    for d, cc in enumerate((cells // (nc * nc), (cells // nc) % nc, cells % nc)):
        u = pos3[d, :, cols] * inv_h - 0.5
        a = torch.floor(u)
        fracs.append(u - a)
        ia = a.to(torch.int64)
        anchors.append(ia)
        ok = torch.remainder(ia - (cc * cb - 1)[None], n) <= cb
        in_halo = ok if in_halo is None else in_halo & ok
    return anchors, fracs, in_halo


def _corners(anchors, fracs, n: int):
    """The 8 CIC corners: (flat periodic mesh index, weight) pairs in the
    kernels' order."""
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                idx = ((torch.remainder(anchors[0] + a, n) * n
                        + torch.remainder(anchors[1] + b, n)) * n
                       + torch.remainder(anchors[2] + c, n))
                wt = ((fracs[0] if a else 1.0 - fracs[0])
                      * (fracs[1] if b else 1.0 - fracs[1])
                      * (fracs[2] if c else 1.0 - fracs[2]))
                yield idx, wt


def _chunk(K: int, device) -> int:
    """Columns per plain-version chunk (bounds its (K, cols) temporaries)."""
    return max(1, (1 << (24 if device.type == "cuda" else 20)) // max(1, K))


def deposit_cells_plain(pos3, w, gridsize: int, boxsize: float, cb: int = 8):
    """Plain PyTorch version of the deposit kernel."""
    nc, K, C = _check(pos3, w, gridsize, cb)
    n = gridsize
    inv_h = float(n / boxsize)
    grid = torch.zeros(n**3, dtype=w.dtype, device=w.device)
    ch = _chunk(K, w.device)
    for c0 in range(0, C, ch):
        cols = slice(c0, min(C, c0 + ch))
        anchors, fracs, in_halo = cell_geometry(pos3, cols, nc, cb, inv_h)
        q = w[:, cols] * in_halo.to(w.dtype)
        for idx, wt in _corners(anchors, fracs, n):
            grid.index_add_(0, idx.reshape(-1), (wt * q).reshape(-1))
    return grid.reshape(n, n, n)


def gather_cells_plain(pos3, w, grids, gridsize: int, boxsize: float,
                       cb: int = 8):
    """Plain PyTorch version of the gather kernel: grids (D, n, n, n) →
    (D, K, C), zero for slots with w = 0 or outside the halo."""
    nc, K, C = _check(pos3, w, gridsize, cb)
    n = gridsize
    inv_h = float(n / boxsize)
    D = grids.shape[0]
    flat = grids.reshape(D, -1)
    out = torch.empty((D, K, C), dtype=grids.dtype, device=grids.device)
    ch = _chunk(K, w.device)
    for c0 in range(0, C, ch):
        cols = slice(c0, min(C, c0 + ch))
        anchors, fracs, in_halo = cell_geometry(pos3, cols, nc, cb, inv_h)
        q = w[:, cols] * in_halo.to(w.dtype)
        vals = torch.zeros((D,) + q.shape, dtype=grids.dtype,
                           device=grids.device)
        for idx, wt in _corners(anchors, fracs, n):
            vals += (wt * q)[None] * flat[:, idx]
        out[:, :, cols] = vals
    return out


def _fn(name: str, argtypes: list):
    fn = getattr(_build.load("cells"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(pos3, w, C: int):
    for t, what in ((pos3, "pos3"), (w, "w")):
        if t.dtype != torch.float32:
            raise NotImplementedError(f"{what} is {t.dtype}; the kernels "
                                      f"are float32 ({FLOAT64_ITEM})")
    if pos3.stride(2) != 1 or pos3.stride(1) != C:
        raise ValueError("pos3 rows must be contiguous with row stride C")
    if not w.is_contiguous() or w.device != pos3.device:
        raise ValueError("w must be contiguous on the positions' device")


_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float


def deposit_cells(pos3, w, gridsize: int, boxsize: float, cb: int = 8):
    """CIC deposit of the slot weights w onto the (n, n, n) mesh."""
    if pos3.device.type == "cpu":
        return deposit_cells_plain(pos3, w, gridsize, boxsize, cb)
    nc, K, C = _check(pos3, w, gridsize, cb)
    _check_cuda(pos3, w, C)
    n = gridsize
    grid = torch.zeros((n, n, n), dtype=torch.float32, device=pos3.device)
    err = _fn("deposit_cells_launch", [_P, _L, _P, _I, _I, _I, _F, _P, _P])(
        pos3.data_ptr(), pos3.stride(0), w.data_ptr(), K, nc, cb,
        float(n / boxsize), grid.data_ptr(),
        torch.cuda.current_stream(pos3.device).cuda_stream,
    )
    _build.check(err, "deposit_cells")
    deposit_cells.launches += 1
    return grid


def gather_cells(pos3, w, grids, gridsize: int, boxsize: float, cb: int = 8):
    """CIC interpolation of the D mesh fields ``grids`` (D, n, n, n) at
    every slot, times w: returns (D, K, C)."""
    if pos3.device.type == "cpu":
        return gather_cells_plain(pos3, w, grids, gridsize, boxsize, cb)
    nc, K, C = _check(pos3, w, gridsize, cb)
    _check_cuda(pos3, w, C)
    n = gridsize
    if grids.dim() != 4 or tuple(grids.shape[1:]) != (n, n, n) \
            or not grids.is_contiguous() or grids.dtype != torch.float32 \
            or grids.device != pos3.device:
        raise ValueError(f"grids must be contiguous float32 (D, {n}, {n}, {n})"
                         " on the positions' device")
    D = grids.shape[0]
    out = torch.empty((D, K, C), dtype=torch.float32, device=pos3.device)
    err = _fn("gather_cells_launch",
              [_P, _L, _P, _I, _I, _I, _F, _P, _I, _P, _P])(
        pos3.data_ptr(), pos3.stride(0), w.data_ptr(), K, nc, cb,
        float(n / boxsize), grids.data_ptr(), D, out.data_ptr(),
        torch.cuda.current_stream(pos3.device).cuda_stream,
    )
    _build.check(err, "gather_cells")
    gather_cells.launches += 1
    return out


deposit_cells.launches = 0
gather_cells.launches = 0
