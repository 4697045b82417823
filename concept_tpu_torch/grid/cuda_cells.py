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

``planes`` = (x0, nx) takes a rank's nx planes of columns from global
plane x0 on (C = nx·nc², the rung stepper over ranks; positions stay
global): the mesh is then the planes' rows with one halo row a side,
(nx·cb + 2, n, n) from global mesh row x0·cb − 1, not wrapped along x.
A slot's anchor row there is its column's local plane·cb plus its offset
in the column's (periodic) halo, so that a slot of the first plane that
drifted below x = 0 lands in the low halo row.  The caller moves these
rows onto the ranks' FFT slabs (deposit) or fills them from there
(gather): parallel/step.add_span_rows and span_rows.  Z-major ids over
planes (grid/cuda_blocks.py) run x fastest over the nx planes: c =
(cz·nc + cy)·nx + cx − x0.

Positions, weights and meshes are all float32 (the float kernels) or
all float64 (their double twins).  On CPU tensors the wrappers run the
plain versions; on CUDA tensors they launch the kernels or raise.  Each
wrapper counts its launches, ``launches`` in float and ``launches_f64``
in double.  The kernels and the plain versions take the cell width and
the column-id order as arguments: grid/cuda_blocks.py launches them on
the global stepper's 2-mesh-cell blocks with z-major ids.
"""

from __future__ import annotations

import ctypes

import torch

from concept_tpu_torch import _build
from concept_tpu_torch.grid.interp import cic_corners


def _check(pos3, w, gridsize: int, cb: int, planes=None):
    """pos3: a (3, K, C) tensor or three (K, C) tensors."""
    if gridsize % cb:
        raise ValueError(f"mesh {gridsize} is not a multiple of cb = {cb}")
    nc = gridsize // cb
    x0, nx = (0, nc) if planes is None else planes
    if not (nx >= 1 and 0 <= x0 and x0 + nx <= nc):
        raise ValueError(f"planes {planes} do not lie in the {nc} planes")
    K, C = w.shape
    if C != nx * nc * nc or len(pos3) != 3 \
            or any(tuple(p.shape) != (K, C) for p in pos3):
        raise ValueError(f"positions {[tuple(p.shape) for p in pos3]} / w "
                         f"{tuple(w.shape)} do not fit nc = {nc}, nx = {nx}")
    return nc, K, C


def mesh_rows(gridsize: int, cb: int, planes=None) -> int:
    """The mesh's rows along x: gridsize, or a slab's nx·cb + 2."""
    return gridsize if planes is None else planes[1] * cb + 2


def cell_geometry(pos3, cols, nc: int, cb: int, inv_h: float,
                  zmajor: bool = False, x0: int | None = None, nx: int | None = None):
    """CIC anchors, fractions and the halo test of slots in columns
    ``cols``: ((ix, iy, iz) int64, (fx, fy, fz), in_halo), each (K, cols).
    Column ids are x-major (c = (cx·nc + cy)·nc + cz), or z-major with
    ``zmajor``.  The halo test is periodic: a slot that crossed a box face
    since the last rebucket sits at the far side of the box in
    [0, boxsize), and its anchor lies in its cell's halo modulo the
    mesh.  With ``x0`` the columns are ``nx`` planes from global plane x0
    on, and ix is the anchor's row on their slab mesh (0 outside the
    halo; see the module docstring)."""
    n = nc * cb
    nx = nc if nx is None else nx
    cells = torch.arange(cols.start, cols.stop, device=pos3[0].device)
    if zmajor:
        coords = (cells % nx, (cells // nx) % nc, cells // (nx * nc))
    else:
        coords = (cells // (nc * nc), (cells // nc) % nc, cells % nc)
    anchors, fracs, in_halo = [], [], None
    for d, cc in enumerate(coords):
        u = pos3[d][:, cols] * inv_h - 0.5
        a = torch.floor(u)
        fracs.append(u - a)
        ia = a.to(torch.int64)
        slab = d == 0 and x0 is not None
        # the anchor's offset in the halo of the column's global cell
        off = torch.remainder(ia - ((cc + x0 if slab else cc) * cb - 1)[None], n)
        anchors.append(cc[None] * cb + off if slab else ia)
        ok = off <= cb
        in_halo = ok if in_halo is None else in_halo & ok
    if x0 is not None:
        anchors[0] = torch.where(in_halo, anchors[0], 0)
    return anchors, fracs, in_halo


def _corners(anchors, fracs, n: int, slab: bool):
    """The 8 CIC corners (flat mesh index, weight): interp.cic_corners on
    the periodic mesh, or on a slab mesh (rows along x not wrapped)."""
    if not slab:
        yield from cic_corners(anchors, fracs, n)
        return
    ws = [(1.0 - f, f) for f in fracs]
    for a, wx in enumerate(ws[0]):
        ia = (anchors[0] + a) * n
        for b, wy in enumerate(ws[1]):
            ib = (ia + torch.remainder(anchors[1] + b, n)) * n
            wxy = wx * wy
            for c, wz in enumerate(ws[2]):
                yield ib + torch.remainder(anchors[2] + c, n), wxy * wz


def _chunk(K: int, device) -> int:
    """Columns per plain-version chunk (bounds its (K, cols) temporaries)."""
    return max(1, (1 << (24 if device.type == "cuda" else 20)) // max(1, K))


def deposit_cells_plain(pos3, w, gridsize: int, boxsize: float, cb: int = 8,
                        zmajor: bool = False, planes=None):
    """Plain PyTorch version of the deposit kernel."""
    nc, K, C = _check(pos3, w, gridsize, cb, planes)
    n = gridsize
    x0, nx = (None, None) if planes is None else planes
    inv_h = float(n / boxsize)
    grid = torch.zeros(mesh_rows(n, cb, planes) * n * n, dtype=w.dtype, device=w.device)
    ch = _chunk(K, w.device)
    for c0 in range(0, C, ch):
        cols = slice(c0, min(C, c0 + ch))
        anchors, fracs, in_halo = cell_geometry(pos3, cols, nc, cb, inv_h, zmajor, x0, nx)
        q = w[:, cols] * in_halo.to(w.dtype)
        for idx, wt in _corners(anchors, fracs, n, x0 is not None):
            grid.index_add_(0, idx.reshape(-1), (wt * q).reshape(-1))
    return grid.reshape(-1, n, n)


def gather_cells_plain(pos3, w, grids, gridsize: int, boxsize: float,
                       cb: int = 8, zmajor: bool = False, planes=None):
    """Plain PyTorch version of the gather kernel: grids (D, n, n, n), or
    (D, nx·cb + 2, n, n) with ``planes`` → (D, K, C), zero for slots with
    w = 0 or outside the halo."""
    nc, K, C = _check(pos3, w, gridsize, cb, planes)
    n = gridsize
    x0, nx = (None, None) if planes is None else planes
    inv_h = float(n / boxsize)
    D = grids.shape[0]
    flat = grids.reshape(D, -1)
    out = torch.empty((D, K, C), dtype=grids.dtype, device=grids.device)
    ch = _chunk(K, w.device)
    for c0 in range(0, C, ch):
        cols = slice(c0, min(C, c0 + ch))
        anchors, fracs, in_halo = cell_geometry(pos3, cols, nc, cb, inv_h, zmajor, x0, nx)
        q = w[:, cols] * in_halo.to(w.dtype)
        vals = torch.zeros((D,) + q.shape, dtype=grids.dtype,
                           device=grids.device)
        for idx, wt in _corners(anchors, fracs, n, x0 is not None):
            vals += (wt * q)[None] * flat[:, idx]
        out[:, :, cols] = vals
    return out


def cut_rows(w, ext):
    """The weights w (K, C) with each column c cut to its first ext[c]
    rows (the kernels' optional extents); w itself when ext is None."""
    if ext is None:
        return w
    rows = torch.arange(w.shape[0], device=w.device)[:, None]
    return w * (rows < ext.to(w.device)[None, :])


def _fn(name: str, argtypes: list, dtype):
    """The launch function ``name`` (its ``_f64`` twin for float64), with
    ``_F`` in ``argtypes`` standing for the scalar type."""
    f64 = dtype == torch.float64
    fn = getattr(_build.load("cells"), name + ("_f64" if f64 else ""))
    if fn.argtypes is None:
        fn.argtypes = [(ctypes.c_double if f64 else _F) if a is _F else a for a in argtypes]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(pos3, w):
    for p in pos3:
        if p.stride(1) != 1 or p.stride(0) != w.shape[1] or p.device != w.device:
            raise ValueError("position rows must be contiguous with row stride "
                             "C, on the weights' device")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _check_ext(ext, C: int, device):
    """The optional per-column row extents: (C,) int32, contiguous, on the
    slots' device; returns its pointer (None for no extents)."""
    if ext is None:
        return None
    if ext.dtype != torch.int32 or tuple(ext.shape) != (C,) \
            or not ext.is_contiguous() or ext.device != device:
        raise ValueError(f"ext must be contiguous int32 ({C},) on the slots' device")
    return ext.data_ptr()


def launch_deposit(pos3, w, gridsize: int, boxsize: float, cb: int,
                   zmajor: bool, ext=None, planes=None):
    """Launch the deposit kernel on CUDA tensors: pos3 a (3, K, C) tensor
    or three (K, C) tensors, columns cb mesh cells wide: the rung cells
    (cb 8 or 4, x-major ids) or the PM blocks (cb 2, z-major ids).
    ``ext`` (C,) int32, optional, cuts column c to its first ext[c] rows.
    Returns the (n, n, n) mesh, or with ``planes`` the (nx·cb + 2, n, n)
    slab mesh."""
    nc, K, C = _check(pos3, w, gridsize, cb, planes)
    dtype = _build.scalar_dtype("cic_deposit", *pos3, w)
    _check_cuda(pos3, w)
    if (cb, bool(zmajor)) not in ((8, False), (4, False), (2, True)):
        raise ValueError(f"the deposit kernel takes cells of cb 8 or 4 with x-major ids "
                         f"or blocks of cb 2 with z-major ids, not cb {cb}, zmajor {zmajor}")
    ext_ptr = _check_ext(ext, C, w.device)
    n = gridsize
    x0, nx = (0, nc) if planes is None else planes
    grid = torch.zeros((mesh_rows(n, cb, planes), n, n), dtype=dtype, device=w.device)
    err = _fn("cic_deposit_launch",
              [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P], dtype)(
        *(p.data_ptr() for p in pos3), w.data_ptr(), K, nc, cb, int(zmajor), nx, x0,
        int(planes is not None), float(n / boxsize), ext_ptr, grid.data_ptr(),
        torch.cuda.current_stream(w.device).cuda_stream,
    )
    _build.check(err, "cic_deposit")
    return grid


def launch_gather(pos3, w, grids, gridsize: int, boxsize: float, cb: int,
                  zmajor: bool, ext=None, planes=None):
    """Launch the gather kernel on CUDA tensors (layout as
    :func:`launch_deposit`): grids (D, n, n, n), or (D, nx·cb + 2, n, n)
    with ``planes``, → (D, K, C).  ``ext`` (C,) int32, optional, cuts
    column c to its first ext[c] rows (the rows past them gather 0)."""
    nc, K, C = _check(pos3, w, gridsize, cb, planes)
    dtype = _build.scalar_dtype("cic_gather", *pos3, w, grids)
    _check_cuda(pos3, w)
    n = gridsize
    m = mesh_rows(n, cb, planes)
    if grids.dim() != 4 or tuple(grids.shape[1:]) != (m, n, n) \
            or not grids.is_contiguous() or grids.device != w.device:
        raise ValueError(f"grids must be contiguous (D, {m}, {n}, {n}) on the "
                         "positions' device")
    ext_ptr = _check_ext(ext, C, w.device)
    D = grids.shape[0]
    x0, nx = (0, nc) if planes is None else planes
    out = torch.empty((D, K, C), dtype=dtype, device=w.device)
    err = _fn("cic_gather_launch",
              [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P, _P, _I, _P, _P], dtype)(
        *(p.data_ptr() for p in pos3), w.data_ptr(), K, nc, cb, int(zmajor), nx, x0,
        int(planes is not None), float(n / boxsize), ext_ptr, grids.data_ptr(), D,
        out.data_ptr(), torch.cuda.current_stream(w.device).cuda_stream,
    )
    _build.check(err, "cic_gather")
    return out


def deposit_cells(pos3, w, gridsize: int, boxsize: float, cb: int = 8, planes=None):
    """CIC deposit of the slot weights w onto the (n, n, n) mesh, or with
    ``planes`` onto their (nx·cb + 2, n, n) slab mesh."""
    if pos3.device.type == "cpu":
        _build.scalar_dtype("cic_deposit", pos3, w)
        return deposit_cells_plain(pos3, w, gridsize, boxsize, cb, planes=planes)
    grid = launch_deposit(pos3, w, gridsize, boxsize, cb, zmajor=False, planes=planes)
    _build.count_launch(deposit_cells, grid.dtype)
    return grid


def gather_cells(pos3, w, grids, gridsize: int, boxsize: float, cb: int = 8,
                 ext=None, planes=None):
    """CIC interpolation of the D mesh fields ``grids`` (D, n, n, n), or
    their slab meshes (D, nx·cb + 2, n, n) with ``planes``, at every slot,
    times w: returns (D, K, C).  ``ext`` (C,) int32, optional: column c's
    rows r ≥ ext[c] count as w = 0 (the kernel reads nothing there)."""
    if pos3.device.type == "cpu":
        _build.scalar_dtype("cic_gather", pos3, w, grids)
        return gather_cells_plain(pos3, cut_rows(w, ext), grids, gridsize, boxsize, cb,
                                  planes=planes)
    out = launch_gather(pos3, w, grids, gridsize, boxsize, cb, zmajor=False, ext=ext,
                        planes=planes)
    _build.count_launch(gather_cells, out.dtype)
    return out


for _f in (deposit_cells, gather_cells):
    _f.launches = _f.launches_f64 = 0
