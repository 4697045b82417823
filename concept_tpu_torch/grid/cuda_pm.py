"""CIC deposit and gather on 2³-mesh-cell blocks from block-sorted
particles: the wrappers of the CUDA kernels of csrc/pm_blocks.cu (PERF.md
rows 10 and 11) and their plain PyTorch versions.

Port of ``deposit_pallas_kc`` / ``gather_pallas_kc``
(concept_tpu/grid/pallas_pm.py:128-186) without the padded slots.  The
particle arrays are (N,) in block-sorted order, as
grid/bucketed.sort_blocks makes them: ``lidx`` (int32) is the particle's
CIC anchor in its block's 4³ halo mini-grid, (lx·4 + ly)·4 + lz with lx,
ly, lz in [0, 2] (other values are clamped into it); ``fx, fy, fz`` the CIC
fractions; ``q`` the deposit weight.  ``starts`` (C,) int32 is the
exclusive running sum of the blocks' full particle counts, C = nb³ blocks
with x-major ids c = (bx·nb + by)·nb + bz, nb = n/2: sorted particle i
belongs to the block c with starts[c] ≤ i < starts[c + 1] (N for the
last).  ``counts`` (C,) int32 cuts each block: only its first counts[c]
particles are deposited or gathered (the rest gather 0), so counts
clamped to a capacity K give the TPU kernels' bucket truncation, and the
full counts take every particle.  A particle's global anchor is
2·(bx, by, bz) − 1 + (lx, ly, lz), modulo n.

The fractions, weights and meshes are all float32 or all float64 (the
kernels' double twins).  On CPU tensors the wrappers run the plain
versions; on CUDA tensors they launch the kernels or raise.  Each counts
its launches, ``launches`` in float and ``launches_f64`` in double.
"""

from __future__ import annotations

import ctypes

import torch

from concept_tpu_torch import _build
from concept_tpu_torch.grid.bucketed import B, LDIM, _block_count
from concept_tpu_torch.grid.cuda_cells import _chunk
from concept_tpu_torch.grid.interp import cic_corners


def _check(particles, starts, counts, gridsize: int):
    nb = _block_count(gridsize)
    N = particles[0].shape[0]
    if any(tuple(t.shape) != (N,) for t in particles) or any(
            tuple(t.shape) != (nb**3,) for t in (starts, counts)):
        raise ValueError(f"particle arrays {[tuple(t.shape) for t in particles]} and block "
                         f"arrays {[tuple(t.shape) for t in (starts, counts)]} do not fit "
                         f"nb = {nb}")
    return nb, N


def _geometry(lidx, fx, fy, fz, starts, counts, nb: int, sel: slice):
    """For the sorted particles ``sel``: their global CIC anchors (int64,
    unwrapped), fractions and the mask of those within their block's
    count."""
    i = torch.arange(sel.start, sel.stop, device=lidx.device)
    c = torch.searchsorted(starts.to(torch.int64), i, right=True) - 1
    keep = i - starts[c] < counts[c]
    blocks = (c // (nb * nb), (c // nb) % nb, c % nb)
    li = lidx[sel].to(torch.int64)
    local = (li // (LDIM * LDIM), (li // LDIM) % LDIM, li % LDIM)
    anchors = [B * b - 1 + torch.clamp(lo, 0, 2) for b, lo in zip(blocks, local)]
    return anchors, (fx[sel], fy[sel], fz[sel]), keep


def deposit_pm_plain(lidx, fx, fy, fz, q, starts, counts, gridsize: int):
    """Plain PyTorch version of :func:`deposit_pm`."""
    nb, N = _check((lidx, fx, fy, fz, q), starts, counts, gridsize)
    n = gridsize
    grid = torch.zeros(n**3, dtype=q.dtype, device=q.device)
    ch = _chunk(1, q.device)
    for i0 in range(0, N, ch):
        sel = slice(i0, min(N, i0 + ch))
        anchors, fr, keep = _geometry(lidx, fx, fy, fz, starts, counts, nb, sel)
        qk = q[sel] * keep
        for idx, wt in cic_corners(anchors, fr, n):
            grid.index_add_(0, idx, wt * qk)
    return grid.reshape(n, n, n)


def gather_pm_plain(lidx, fx, fy, fz, starts, counts, grids, gridsize: int):
    """Plain PyTorch version of :func:`gather_pm`."""
    nb, N = _check((lidx, fx, fy, fz), starts, counts, gridsize)
    n = gridsize
    D = grids.shape[0]
    flat = grids.reshape(D, -1)
    out = torch.empty((D, N), dtype=grids.dtype, device=grids.device)
    ch = _chunk(1, grids.device)
    for i0 in range(0, N, ch):
        sel = slice(i0, min(N, i0 + ch))
        anchors, fr, keep = _geometry(lidx, fx, fy, fz, starts, counts, nb, sel)
        vals = torch.zeros((D, sel.stop - i0), dtype=grids.dtype, device=grids.device)
        for idx, wt in cic_corners(anchors, fr, n):
            vals += wt[None] * flat[:, idx]
        out[:, sel] = vals * keep
    return out


def _fn(name: str, argtypes: list, dtype):
    """The launch function ``name`` (its ``_f64`` twin for float64)."""
    fn = getattr(_build.load("pm_blocks"), name + ("_f64" if dtype == torch.float64 else ""))
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(ints, floats):
    for t in ints:
        if t.dtype != torch.int32:
            raise ValueError(f"lidx, starts and counts must be int32, not {t.dtype}")
    dev = ints[0].device
    for t in (*ints, *floats):
        if not t.is_contiguous() or t.device != dev:
            raise ValueError("particle, block and mesh arrays must be contiguous and "
                             "on one device")


_P, _I = ctypes.c_void_p, ctypes.c_int


def deposit_pm(lidx, fx, fy, fz, q, starts, counts, gridsize: int):
    """CIC deposit of the sorted particles' weights q onto the (n, n, n)
    mesh."""
    dtype = _build.scalar_dtype("pm_deposit", fx, fy, fz, q)
    if q.device.type == "cpu":
        return deposit_pm_plain(lidx, fx, fy, fz, q, starts, counts, gridsize)
    nb, N = _check((lidx, fx, fy, fz, q), starts, counts, gridsize)
    _check_cuda((lidx, starts, counts), (fx, fy, fz, q))
    n = gridsize
    grid = torch.zeros((n, n, n), dtype=dtype, device=q.device)
    err = _fn("pm_deposit_launch", [_P] * 7 + [_I, _I, _P, _P], dtype)(
        *(t.data_ptr() for t in (lidx, fx, fy, fz, q, starts, counts)), N, nb,
        grid.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "pm_deposit")
    _build.count_launch(deposit_pm, dtype)
    return grid


def gather_pm(lidx, fx, fy, fz, starts, counts, grids, gridsize: int):
    """CIC interpolation of the D mesh fields ``grids`` (D, n, n, n) at
    every sorted particle, in one launch: returns (D, N)."""
    dtype = _build.scalar_dtype("pm_gather", fx, fy, fz, grids)
    if grids.device.type == "cpu":
        return gather_pm_plain(lidx, fx, fy, fz, starts, counts, grids, gridsize)
    nb, N = _check((lidx, fx, fy, fz), starts, counts, gridsize)
    _check_cuda((lidx, starts, counts), (fx, fy, fz, grids))
    n = gridsize
    if grids.dim() != 4 or tuple(grids.shape[1:]) != (n, n, n):
        raise ValueError(f"grids must be (D, {n}, {n}, {n}), not {tuple(grids.shape)}")
    D = grids.shape[0]
    out = torch.empty((D, N), dtype=dtype, device=grids.device)
    err = _fn("pm_gather_launch", [_P] * 6 + [_I, _I, _P, _I, _P, _P], dtype)(
        *(t.data_ptr() for t in (lidx, fx, fy, fz, starts, counts)), N, nb,
        grids.data_ptr(), D, out.data_ptr(),
        torch.cuda.current_stream(grids.device).cuda_stream)
    _build.check(err, "pm_gather")
    _build.count_launch(gather_pm, dtype)
    return out


for _f in (deposit_pm, gather_pm):
    _f.launches = _f.launches_f64 = 0
