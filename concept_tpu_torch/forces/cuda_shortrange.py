"""The one-sided P³M short-range sweep: the CUDA kernels' wrappers
(csrc/pair_sweep.cu) and their plain PyTorch version.

Port of ``sweep_pallas_pair`` (flat and row-bounded), ``sweep_pallas_pair_reach``
and the global steppers' two-sided sweep (concept_tpu/forces/pallas_shortrange.py),
the rows of PERF.md's kernel table: :func:`pair_sweep` serves row 1 (the
rung stepper's row-bounded sweep), :func:`pair_sweep_reach` rows 5 and 7,
:func:`pair_sweep_global` row 6 (the global steppers' sweep, receivers =
suppliers) and :func:`pair_sweep_subset` row 2 (one set's receivers
against another's suppliers); the last two launch the global kernel,
which takes its work from a list of the occupied columns
(:func:`global_work_list`).
Contract: ``recv`` (3, K_r, C) and ``sup`` (3, K_s, C) slot positions
with invalid slots at a far sentinel ``±SENTINEL·boxsize`` (typically row
slices of one sentinel-filled (3, K, C) array); C = nx·n² cells of an
nx × n × n column grid, ids x-major and z-fastest: nx = n (the default)
for the whole box, or a rank's planes of columns between the neighbour
planes it received (the rung stepper over ranks: one a side for the ±1
sweep, nx = planes + 2, two for the reach sweep, nx = planes + 4), whose
receiver bounds are 0 there.  A neighbour across a face of the
grid is seen at ±boxsize.  Returns the accelerations (3, K_r, C); the
caller applies G·m.

:func:`pair_sweep` sweeps the 27 neighbour columns of |d| ≤ 1 (cells at
least a cutoff wide), :func:`pair_sweep_reach` a given offset table (the
kept reach-2 offsets of the 4-mesh-cell layout,
``shortrange.reach_offsets``).  Both take optional int32 row bounds
``rext`` (receivers) and ``sext`` (suppliers), per column (C,) or per
pencil (nx·n,), p = ci·n + cj, which stands for the same bound on each
column of the pencil: every valid receiver (supplier) of a column lies
in a row below its bound.  Rows of a column at or beyond its receiver
bound come out exactly 0; the supplier rows of a neighbour column at or
beyond its own supplier bound are skipped.  The TPU reach kernel takes
no bounds; with bounds that hold the valid slots the output is the same
on every row that carries a force.  Each wrapper counts its launches:
``launches`` for the float kernel, ``launches_f64`` for the double one.

recv and sup are float32 (the float kernel, the fitted screening) or
float64 (the double kernel, the exact screening), both of one dtype.  On
a CPU tensor they run :func:`pair_sweep_plain`; on a CUDA tensor they
launch the kernel or raise.
"""

from __future__ import annotations

import bisect
import ctypes

import numpy as np
import torch

from concept_tpu_torch import _build
from concept_tpu_torch.forces.shortrange import (
    _G_COEF, SENTINEL, shortrange_force_factor,
)

KERNEL_IDS = {"plummer": 0, "spline": 1, "none": 2}

OFFSETS_27 = tuple((i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                   for k in (-1, 0, 1))
MAX_OFFSETS = 125  # csrc/pair_sweep.cu: the offsets of |d| ≤ 2


def _check(recv, sup, n: int, kernel: str, offsets=OFFSETS_27, nx: int | None = None):
    nx = n if nx is None else nx
    if recv.dim() != 3 or sup.dim() != 3 or recv.shape[0] != 3 \
            or sup.shape[0] != 3 or recv.shape[2] != sup.shape[2]:
        raise ValueError(f"recv {tuple(recv.shape)} / sup {tuple(sup.shape)}"
                         " must be (3, K_r, C) / (3, K_s, C)")
    if not 1 <= len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"{len(offsets)} offsets; the kernel takes 1 to "
                         f"{MAX_OFFSETS}")
    # every offset of a column must name a distinct column
    side = 2 * max(abs(d) for off in offsets for d in off) + 1
    if min(n, nx) < max(3, side) or recv.shape[2] != nx * n * n:
        raise ValueError(f"C = {recv.shape[2]} is not nx·n² with n = {n}, nx = {nx} ≥ "
                         f"{max(3, side)}")
    if kernel not in KERNEL_IDS:
        raise ValueError(f"unknown softening kernel {kernel!r}")


def column_bounds(ext, n: int, nx: int | None = None):
    """Row bounds per column (C,) from bounds per column (C,) or per
    pencil (nx·n,) of an nx × n × n grid (nx = n by default); None stays
    None."""
    C = (n if nx is None else nx) * n * n
    if ext is None or ext.numel() == C:
        return ext
    if ext.numel() != C // n:
        raise ValueError(f"row bounds of {ext.numel()} entries: per column "
                         f"({C}) or per pencil ({C // n})")
    return ext[torch.arange(C, device=ext.device) // n]


def pair_sweep_plain(recv, sup, n_cells: int, boxsize: float, scale: float,
                     cutoff2: float, soft2: float, kernel: str = "plummer",
                     rext=None, sext=None, offsets=OFFSETS_27, nx: int | None = None):
    """Plain PyTorch version of the sweep kernel over the neighbour
    ``offsets``, on a list of pairs: every receiver that can feel a force
    (in its row bound and off the sentinel; the others come out 0, as
    from the kernel) with every supplier off the sentinel in its
    neighbour columns, below that column's supplier bound.  Receivers go in chunks whose pairs
    stay near 2²⁴ on the card and 2²¹ on the CPU.  Each receiver's pair
    forces, computed in the input's dtype, are summed in float64 and
    rounded once: on the card index_add_ adds in no fixed order, and a
    float32 sum whose terms cancel (a receiver between two near
    suppliers at softening 0) then moved by up to 1e-5 of the force from
    one call to the next."""
    _check(recv, sup, n_cells, kernel, offsets, nx)
    n = n_cells
    nx = n if nx is None else nx
    _, K_r, C = recv.shape
    K_s = sup.shape[1]
    dev = recv.device
    chunk_pairs = 1 << (24 if dev.type == "cuda" else 21)
    far = 0.5 * SENTINEL * boxsize
    out = torch.zeros((3, K_r, C), dtype=recv.dtype, device=dev)
    live = recv[0].abs() < far
    if rext is not None:
        live &= torch.arange(K_r, device=dev)[:, None] < column_bounds(rext, n, nx)[None]
    r_row, r_col = torch.nonzero(live, as_tuple=True)
    # suppliers off the sentinel and below their column's bound, column
    # by column
    supplies = sup[0].abs() < far
    if sext is not None:
        supplies &= torch.arange(K_s, device=dev)[:, None] < column_bounds(sext, n, nx)[None]
    s_col, s_row = torch.nonzero(supplies.T, as_tuple=True)
    s_pos = sup[:, s_row, s_col]
    counts = torch.bincount(s_col, minlength=C)
    starts = torch.cumsum(counts, 0) - counts
    offs = torch.as_tensor(offsets, device=dev)  # (n_off, 3)
    n_off = offs.shape[0]
    cc = (r_col // (n * n), (r_col // n) % n, r_col % n)
    nb = [c[:, None] + offs[None, :, d] for d, c in enumerate(cc)]  # (N_r, n_off)
    nb_col = ((torch.remainder(nb[0], nx) * n + torch.remainder(nb[1], n)) * n
              + torch.remainder(nb[2], n))
    # a neighbour across a face of the grid sits at ±boxsize
    shift = torch.stack([((m >= e).to(sup.dtype) - (m < 0).to(sup.dtype)) * boxsize
                         for m, e in zip(nb, (nx, n, n))])  # (3, N_r, n_off)
    n_pairs = counts[nb_col].sum(dim=1)  # per receiver
    ends = torch.cumsum(n_pairs, 0).tolist()
    i0 = 0
    while i0 < len(ends):
        base = ends[i0 - 1] if i0 else 0
        i1 = max(i0 + 1, bisect.bisect_right(ends, base + chunk_pairs, lo=i0))
        cnt = counts[nb_col[i0:i1]].reshape(-1)  # per (receiver, offset)
        grp = torch.repeat_interleave(torch.arange(cnt.numel(), device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        sidx = (starts[nb_col[i0:i1].reshape(-1)][grp]
                + torch.arange(grp.numel(), device=dev) - first[grp])
        ri = i0 + torch.div(grp, n_off, rounding_mode="floor")
        d = (recv[:, r_row[ri], r_col[ri]]
             - (s_pos[:, sidx] + shift.reshape(3, -1)[:, i0 * n_off + grp]))
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        m = (r2 < cutoff2) & (r2 > 0)
        f = torch.where(m, shortrange_force_factor(r2, scale, soft2, kernel), 0.0)
        acc = torch.zeros((3, i1 - i0), dtype=torch.float64, device=dev)
        acc.index_add_(1, ri - i0, (f[None] * d).double())
        out[:, r_row[i0:i1], r_col[i0:i1]] = acc.to(recv.dtype)
        i0 = i1
    return out


GLOBAL_ITEM_ROWS = 64  # csrc/pair_sweep.cu GW_ITEM: receiver rows a work item holds
_COL_SHIFT = 24  # GW_COL_SHIFT: an item is column << 24 | chunk


def global_work_list(rb, K_r: int):
    """The global kernel's work list from receiver bounds rb (C,) in
    [0, K_r]: (items (C·ch,) int64, n_items (1,) int32), ch =
    ⌈K_r/GLOBAL_ITEM_ROWS⌉.  An item is a column c and a chunk j of its
    rows, encoded c << 24 | j: rows j·GLOBAL_ITEM_ROWS on, below rb[c].
    The first n_items entries are every chunk of every column once, the
    columns with the most chunks first, then by column id (one stable
    sort by depth in chunks, with the empty (column, chunk) pairs last);
    the rest of the list is never read.  Device ops of fixed size only: no
    host sync."""
    dev = rb.device
    ch = max(1, -(-K_r // GLOBAL_ITEM_ROWS))
    n_ch = torch.div(rb.to(torch.int64) + GLOBAL_ITEM_ROWS - 1, GLOBAL_ITEM_ROWS,
                     rounding_mode="floor")
    j = torch.arange(ch, device=dev)
    key = torch.where(j[None, :] < n_ch[:, None], ch - n_ch[:, None], ch)
    _, order = torch.sort(key.reshape(-1), stable=True)
    items = torch.div(order, ch, rounding_mode="floor") << _COL_SHIFT | order % ch
    return items, n_ch.sum().to(torch.int32).reshape(1)


def _lib(f64: bool):
    lib = _build.load("pair_sweep")
    fn = lib.pair_sweep_launch_f64 if f64 else lib.pair_sweep_launch
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        if f64:
            D = ctypes.c_double
            fn.argtypes = [P, L, I, P, L, I, I, I, P, P, P, D, D, D, D, I, P, I, P]
        else:
            F = ctypes.c_float
            fn.argtypes = [P, L, I, P, L, I, I, I, P, P, P, F, F, F, F, I, P, P, I, P]
        fn.restype = ctypes.c_int
    return fn


def _lib_global(f64: bool):
    lib = _build.load("pair_sweep")
    fn = lib.pair_sweep_global_launch_f64 if f64 else lib.pair_sweep_global_launch
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        head = [P, L, I, P, L, I, I, P, P, P, P, P, P]
        if f64:
            D = ctypes.c_double
            fn.argtypes = head + [D, D, D, D, I, P]
        else:
            F = ctypes.c_float
            fn.argtypes = head + [F, F, F, F, I, P, P]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_rows(t, C: int, what: str):
    if t.stride(2) != 1 or t.stride(1) != C:
        raise ValueError(f"{what} rows must be contiguous with row stride C")


def _cuda_inputs(recv, sup, n_cells: int, kernel: str, rext, sext, offsets, nx):
    """Check the CUDA inputs: returns (dtype, K_r, K_s, C, the bounds per
    column (rb, sb), each None or contiguous int32)."""
    _check(recv, sup, n_cells, kernel, offsets, nx)
    dtype = _build.scalar_dtype("pair_sweep", recv, sup)
    _, K_r, C = recv.shape
    _check_cuda_rows(recv, C, "recv")
    _check_cuda_rows(sup, C, "sup")
    if sup.device != recv.device or K_r < 1:
        raise ValueError("recv and sup must share a device; K_r ≥ 1")
    bounds = [column_bounds(e, n_cells, nx) for e in (rext, sext)]
    for e in bounds:
        if e is not None and (e.dtype != torch.int32 or not e.is_contiguous()
                              or e.device != recv.device):
            raise ValueError("rext/sext must be contiguous int32 on the "
                             "receivers' device")
    return dtype, K_r, sup.shape[1], C, bounds


def _law_args(dtype, scale: float, kernel: str):
    """The launch functions' (inv_scale, kernel id[, coefficients])."""
    if dtype == torch.float64:
        # the double kernel evaluates the screening exactly from the scale
        return 1.0 / scale, KERNEL_IDS[kernel]
    coef = np.ascontiguousarray(_G_COEF, np.float32)
    return (float(np.float32(1.0) / np.float32(scale)), KERNEL_IDS[kernel],
            coef.ctypes.data)


def _launch_global(recv, sup, n_cells: int, boxsize: float, scale: float,
                   cutoff2: float, soft2: float, kernel: str, rext, sext):
    """Check the CUDA inputs, launch the float or the double global
    kernel over the work list of the receiver bounds (all K_r rows of
    every column without them), return its output."""
    dtype, K_r, K_s, C, (rb, sb) = _cuda_inputs(recv, sup, n_cells, kernel, rext, sext,
                                                OFFSETS_27, None)
    dev = recv.device
    rb = (torch.full((C,), K_r, dtype=torch.int32, device=dev) if rb is None
          else torch.clamp(rb, 0, K_r))
    items, n_items = global_work_list(rb, K_r)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty((3, K_r, C), dtype=dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    inv_scale, kid, *coef = _law_args(dtype, scale, kernel)
    err = _lib_global(dtype == torch.float64)(
        recv.data_ptr(), recv.stride(0), K_r, sup.data_ptr(), sup.stride(0), K_s, n_cells,
        rb.data_ptr(), None if sb is None else sb.data_ptr(), items.data_ptr(),
        n_items.data_ptr(), counter.data_ptr(), out.data_ptr(), boxsize, inv_scale,
        cutoff2, soft2, kid, *coef, stream)
    _build.check(err, "pair_sweep_global")
    return out


def _sweep_global(wrapper, recv, sup, n_cells: int, boxsize: float, scale: float,
                  cutoff2: float, soft2: float, kernel: str, rext, sext):
    """The plain version on the CPU, else the global kernel, its launch
    counted on ``wrapper``."""
    if recv.device.type == "cpu":
        _build.scalar_dtype(wrapper.__name__, recv, sup)
        return pair_sweep_plain(recv, sup, n_cells, boxsize, scale, cutoff2,
                                soft2, kernel, rext, sext)
    out = _launch_global(recv, sup, n_cells, boxsize, scale, cutoff2, soft2, kernel,
                         rext, sext)
    _build.count_launch(wrapper, out.dtype)
    return out


def _launch(recv, sup, n_cells: int, boxsize: float, scale: float,
            cutoff2: float, soft2: float, kernel: str, rext, sext, offsets, nx=None):
    """Check the CUDA inputs, launch the float or the double kernel,
    return its output."""
    dtype, K_r, K_s, C, bounds = _cuda_inputs(recv, sup, n_cells, kernel, rext, sext,
                                              offsets, nx)
    nx = n_cells if nx is None else nx
    rb, sb = (None if e is None else e.data_ptr() for e in bounds)
    out = torch.empty((3, K_r, C), dtype=dtype, device=recv.device)
    table = np.ascontiguousarray(offsets, np.int8)
    stream = torch.cuda.current_stream(recv.device).cuda_stream
    head = (recv.data_ptr(), recv.stride(0), K_r, sup.data_ptr(), sup.stride(0),
            K_s, n_cells, nx, rb, sb, out.data_ptr())
    inv_scale, kid, *coef = _law_args(dtype, scale, kernel)
    err = _lib(dtype == torch.float64)(*head, boxsize, inv_scale, cutoff2, soft2, kid,
                                       *coef, table.ctypes.data, len(offsets), stream)
    _build.check(err, "pair_sweep")
    return out


def pair_sweep(recv, sup, n_cells: int, boxsize: float, scale: float,
               cutoff2: float, soft2: float, kernel: str = "plummer",
               rext=None, sext=None, nx: int | None = None):
    """The ±1 sweep: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (see the module docstring for the contract; ``nx``
    the column planes along x, n_cells by default)."""
    if recv.device.type == "cpu":
        _build.scalar_dtype("pair_sweep", recv, sup)
        return pair_sweep_plain(recv, sup, n_cells, boxsize, scale, cutoff2,
                                soft2, kernel, rext, sext, nx=nx)
    out = _launch(recv, sup, n_cells, boxsize, scale, cutoff2, soft2, kernel,
                  rext, sext, OFFSETS_27, nx)
    _build.count_launch(pair_sweep, out.dtype)
    return out


def pair_sweep_global(recv, sup, n_cells: int, boxsize: float, scale: float,
                      cutoff2: float, soft2: float, kernel: str = "plummer",
                      rext=None, sext=None):
    """The global steppers' ±1 sweep (PERF.md row 6, port of the
    two-sided ``_make_kernel``): every slot of the whole box's n³ columns
    against the suppliers of its 27 neighbour columns, receivers =
    suppliers, with the occupancy bounds ``rext`` / ``sext`` of the
    layout (``min(counts, K)`` of a bucketize, ``_column_occ_ext`` of a
    persistent layout).  The global kernel for CUDA tensors (it visits
    only the rows below the bounds, and its output equals the unbounded
    launch of :func:`pair_sweep`'s kernel bit for bit where the bounds hold
    every valid slot), the plain version for CPU tensors."""
    return _sweep_global(pair_sweep_global, recv, sup, n_cells, boxsize, scale, cutoff2,
                         soft2, kernel, rext, sext)


def pair_sweep_subset(recv, sup, n_cells: int, boxsize: float, scale: float,
                      cutoff2: float, soft2: float, kernel: str = "plummer",
                      rext=None, sext=None):
    """The ±1 sweep of a receiver set against another set's suppliers
    (PERF.md row 2, port of ``sweep_pallas_pair`` → the flat
    ``_make_pair_kernel_flat``), with the receivers' and the suppliers'
    occupancy bounds ``rext`` / ``sext``: the global kernel of
    :func:`pair_sweep_global`, its launches counted apart; the plain
    version for CPU tensors."""
    return _sweep_global(pair_sweep_subset, recv, sup, n_cells, boxsize, scale, cutoff2,
                         soft2, kernel, rext, sext)


def pair_sweep_reach(recv, sup, n_cells: int, boxsize: float, scale: float,
                     cutoff2: float, soft2: float, offsets,
                     kernel: str = "plummer", rext=None, sext=None, nx: int | None = None):
    """The sweep over the neighbour ``offsets`` (|d| ≤ 2, n, nx ≥ 5): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Port of ``sweep_pallas_pair_reach``, whose receivers sit at
    −SENTINEL·boxsize and suppliers at +SENTINEL·boxsize; the row bounds
    are the port's own (see the module docstring).  ``nx`` as in
    :func:`pair_sweep`: a rank's planes between two neighbour planes a
    side (nx = planes + 4)."""
    offsets = tuple(tuple(int(d) for d in off) for off in offsets)
    if recv.device.type == "cpu":
        _build.scalar_dtype("pair_sweep_reach", recv, sup)
        return pair_sweep_plain(recv, sup, n_cells, boxsize, scale, cutoff2,
                                soft2, kernel, rext, sext, offsets, nx=nx)
    out = _launch(recv, sup, n_cells, boxsize, scale, cutoff2, soft2, kernel,
                  rext, sext, offsets, nx)
    _build.count_launch(pair_sweep_reach, out.dtype)
    return out


for _fn in (pair_sweep, pair_sweep_global, pair_sweep_subset, pair_sweep_reach):
    _fn.launches = _fn.launches_f64 = 0
