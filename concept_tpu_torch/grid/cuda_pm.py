"""CIC deposit and gather on 2³-mesh-cell blocks from precomputed per-slot
geometry: the wrappers of the CUDA kernels of csrc/pm_blocks.cu (PERF.md
rows 10 and 11) and their plain PyTorch versions.

Port of ``deposit_pallas_kc`` / ``gather_pallas_kc``
(concept_tpu/grid/pallas_pm.py:128-186) without the lane padding.  The
per-slot arrays are slot-major (K, C), C = nb³ blocks with x-major ids
c = (bx·nb + by)·nb + bz, nb = n/2, as grid/bucketed.bucketize_blocks
lays them out: ``lidx`` (int32) is the slot's CIC anchor in its block's
4³ halo mini-grid, (lx·4 + ly)·4 + lz with lx, ly, lz in [0, 2];
``fx, fy, fz`` the CIC fractions; ``q`` the deposit weight, premasked by
validity, or ``w`` the gather's validity weight.  A slot's global anchor
is 2·(bx, by, bz) − 1 + (lx, ly, lz), modulo n.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from concept_tpu_torch import _build
from concept_tpu_torch.device import FLOAT64_ITEM
from concept_tpu_torch.grid.bucketed import B, LDIM, _block_count
from concept_tpu_torch.grid.cuda_cells import _chunk
from concept_tpu_torch.grid.interp import cic_corners


def _check(lidx, fracs, q, gridsize: int):
    nb = _block_count(gridsize)
    K, C = q.shape
    if C != nb**3 or any(tuple(t.shape) != (K, C) for t in (lidx, *fracs)):
        raise ValueError(f"slot arrays {[tuple(t.shape) for t in (lidx, *fracs, q)]}"
                         f" do not fit nb = {nb}")
    return nb, K, C


def _anchors(lidx, cols: slice, nb: int):
    """Global CIC anchors (int64, unwrapped) of the slots in block columns
    ``cols``: 2·block − 1 + the local anchor."""
    c = torch.arange(cols.start, cols.stop, device=lidx.device)
    blocks = (c // (nb * nb), (c // nb) % nb, c % nb)
    li = lidx[:, cols].to(torch.int64)
    local = (li // (LDIM * LDIM), (li // LDIM) % LDIM, li % LDIM)
    return [B * b[None] - 1 + lo for b, lo in zip(blocks, local)]


def deposit_pm_plain(lidx, fx, fy, fz, q, gridsize: int):
    """Plain PyTorch version of :func:`deposit_pm`."""
    nb, K, C = _check(lidx, (fx, fy, fz), q, gridsize)
    n = gridsize
    grid = torch.zeros(n**3, dtype=q.dtype, device=q.device)
    ch = _chunk(K, q.device)
    for c0 in range(0, C, ch):
        cols = slice(c0, min(C, c0 + ch))
        fr = (fx[:, cols], fy[:, cols], fz[:, cols])
        for idx, wt in cic_corners(_anchors(lidx, cols, nb), fr, n):
            grid.index_add_(0, idx.reshape(-1), (wt * q[:, cols]).reshape(-1))
    return grid.reshape(n, n, n)


def gather_pm_plain(lidx, fx, fy, fz, w, grids, gridsize: int):
    """Plain PyTorch version of :func:`gather_pm`."""
    nb, K, C = _check(lidx, (fx, fy, fz), w, gridsize)
    n = gridsize
    D = grids.shape[0]
    flat = grids.reshape(D, -1)
    out = torch.empty((D, K, C), dtype=grids.dtype, device=grids.device)
    ch = _chunk(K, w.device)
    for c0 in range(0, C, ch):
        cols = slice(c0, min(C, c0 + ch))
        fr = (fx[:, cols], fy[:, cols], fz[:, cols])
        vals = torch.zeros((D, K, cols.stop - c0), dtype=grids.dtype,
                           device=grids.device)
        for idx, wt in cic_corners(_anchors(lidx, cols, nb), fr, n):
            vals += (wt * w[:, cols])[None] * flat[:, idx]
        out[:, :, cols] = vals
    return out


def _fn(name: str, argtypes: list):
    fn = getattr(_build.load("pm_blocks"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(lidx, floats):
    if lidx.dtype != torch.int32:
        raise ValueError(f"lidx must be int32, not {lidx.dtype}")
    for t in floats:
        if t.dtype != torch.float32:
            raise NotImplementedError(f"{t.dtype} slot arrays; the kernels are "
                                      f"float32 ({FLOAT64_ITEM})")
    for t in (lidx, *floats):
        if not t.is_contiguous() or t.device != lidx.device:
            raise ValueError("slot arrays must be contiguous and on one device")


_P, _I = ctypes.c_void_p, ctypes.c_int


def deposit_pm(lidx, fx, fy, fz, q, gridsize: int):
    """CIC deposit of the per-slot weights q onto the (n, n, n) mesh."""
    if q.device.type == "cpu":
        return deposit_pm_plain(lidx, fx, fy, fz, q, gridsize)
    nb, K, _ = _check(lidx, (fx, fy, fz), q, gridsize)
    _check_cuda(lidx, (fx, fy, fz, q))
    n = gridsize
    grid = torch.zeros((n, n, n), dtype=torch.float32, device=q.device)
    err = _fn("pm_deposit_launch", [_P] * 5 + [_I, _I, _P, _P])(
        *(t.data_ptr() for t in (lidx, fx, fy, fz, q)), K, nb, grid.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "pm_deposit")
    deposit_pm.launches += 1
    return grid


def gather_pm(lidx, fx, fy, fz, w, grids, gridsize: int):
    """CIC interpolation of the D mesh fields ``grids`` (D, n, n, n) at
    every slot, times the validity weight w: returns (D, K, C)."""
    if w.device.type == "cpu":
        return gather_pm_plain(lidx, fx, fy, fz, w, grids, gridsize)
    nb, K, C = _check(lidx, (fx, fy, fz), w, gridsize)
    _check_cuda(lidx, (fx, fy, fz, w, grids))
    n = gridsize
    if grids.dim() != 4 or tuple(grids.shape[1:]) != (n, n, n):
        raise ValueError(f"grids must be (D, {n}, {n}, {n}), not {tuple(grids.shape)}")
    D = grids.shape[0]
    out = torch.empty((D, K, C), dtype=torch.float32, device=w.device)
    err = _fn("pm_gather_launch", [_P] * 5 + [_I, _I, _P, _I, _P, _P])(
        *(t.data_ptr() for t in (lidx, fx, fy, fz, w)), K, nb, grids.data_ptr(), D,
        out.data_ptr(), torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "pm_gather")
    gather_pm.launches += 1
    return out


deposit_pm.launches = 0
gather_pm.launches = 0
