"""The one-sided P³M short-range sweep: the CUDA kernel's wrapper
(csrc/pair_sweep.cu) and its plain PyTorch version.

Port of ``sweep_pallas_pair`` (concept_tpu/forces/pallas_shortrange.py),
flat and row-bounded.  Contract: ``recv`` (3, K_r, C) and ``sup``
(3, K_s, C) slot positions with invalid slots at the far sentinel
``SENTINEL·boxsize`` (typically row slices of one sentinel-filled
(3, K, C) array); C = n³ cells, ids x-major and z-fastest.  Returns the
accelerations (3, K_r, C); the caller applies G·m.  Optional per-pencil
extents ``rext``/``sext`` (n²,) int32: every valid receiver (supplier)
of pencil p = ci·n + cj lies in a row below rext[p] (sext[p]).  Rows of
a column at or beyond its receiver bound come out exactly 0.

On a CPU tensor :func:`pair_sweep` runs :func:`pair_sweep_plain`; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from concept_tpu_torch import _build
from concept_tpu_torch.device import FLOAT64_ITEM
from concept_tpu_torch.forces.shortrange import (
    _G_COEF, shortrange_force_factor, window_bounds,
)

KERNEL_IDS = {"plummer": 0, "spline": 1, "none": 2}

_OFFSETS = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
            for k in (-1, 0, 1)]


def _check(recv, sup, n: int, kernel: str):
    if recv.dim() != 3 or sup.dim() != 3 or recv.shape[0] != 3 \
            or sup.shape[0] != 3 or recv.shape[2] != sup.shape[2]:
        raise ValueError(f"recv {tuple(recv.shape)} / sup {tuple(sup.shape)}"
                         " must be (3, K_r, C) / (3, K_s, C)")
    if n < 3 or recv.shape[2] != n**3:
        raise ValueError(f"C = {recv.shape[2]} is not n³ with n = {n} ≥ 3")
    if kernel not in KERNEL_IDS:
        raise ValueError(f"unknown softening kernel {kernel!r}")


def _bounds(rext, sext, n: int, K_r: int, K_s: int, device):
    """Per-column receiver and supplier row bounds (C,) int64."""
    C = n**3
    pencil = torch.arange(C, device=device) // n
    if rext is None:
        return (torch.full((C,), K_r, device=device),
                torch.full((C,), K_s, device=device))
    rb = torch.clamp(rext.to(torch.int64), max=K_r)[pencil]
    sb = torch.clamp(window_bounds(sext.to(torch.int64), n, True),
                     max=K_s)[pencil]
    return rb, sb


def pair_sweep_plain(recv, sup, n_cells: int, boxsize: float, scale: float,
                     cutoff2: float, soft2: float, kernel: str = "plummer",
                     rext=None, sext=None):
    """Plain PyTorch version of the sweep kernel, chunked over columns so
    that a (K_r, K_s, columns) pair block stays near 2²⁴ elements on the
    card and 2²¹ on the CPU."""
    _check(recv, sup, n_cells, kernel)
    n = n_cells
    _, K_r, C = recv.shape
    K_s = sup.shape[1]
    dev = recv.device
    chunk_elems = 1 << (24 if dev.type == "cuda" else 21)
    rb, sb = _bounds(rext, sext, n, K_r, K_s, dev)
    cells = torch.arange(C, device=dev)
    ci, cj, ck = cells // (n * n), (cells // n) % n, cells % n
    rows_r = torch.arange(K_r, device=dev)[:, None]
    rows_s = torch.arange(K_s, device=dev)[:, None]
    out = torch.zeros((3, K_r, C), dtype=recv.dtype, device=dev)
    ch = max(1, chunk_elems // max(1, K_r * K_s))
    for c0 in range(0, C, ch):
        cols = slice(c0, min(C, c0 + ch))
        own = recv[:, :, cols][:, :, None, :]  # (3, K_r, 1, ch)
        smask = (rows_s < sb[cols][None])[None]  # (1, K_s, ch)
        acc = torch.zeros((3, K_r, own.shape[-1]), dtype=recv.dtype,
                          device=dev)
        for di, dj, dk in _OFFSETS:
            parts, ids = [], []
            for c, d in ((ci, di), (cj, dj), (ck, dk)):
                m = c[cols] + d
                # a neighbour across a box face sits at ±boxsize
                parts.append((m >= n).to(sup.dtype) - (m < 0).to(sup.dtype))
                ids.append(torch.remainder(m, n))
            col = (ids[0] * n + ids[1]) * n + ids[2]
            nb = sup[:, :, col] + (torch.stack(parts) * boxsize)[:, None, :]
            d = own - nb[:, None, :, :]  # (3, K_r, K_s, ch)
            r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            m = (r2 < cutoff2) & (r2 > 0) & smask
            f = torch.where(m, shortrange_force_factor(r2, scale, soft2,
                                                       kernel), 0.0)
            acc += (f[None] * d).sum(dim=2)
        out[:, :, cols] = torch.where(rows_r < rb[cols][None], acc, 0.0)
    return out


def _lib():
    fn = _build.load("pair_sweep").pair_sweep_launch
    if fn.argtypes is None:
        P, L, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, L, I, P, L, I, I, P, P, P, F, F, F, F, I, P, P]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_rows(t, C: int, what: str):
    if t.dtype != torch.float32:
        raise NotImplementedError(f"{what} is {t.dtype}; the kernels are "
                                  f"float32 ({FLOAT64_ITEM})")
    if t.stride(2) != 1 or t.stride(1) != C:
        raise ValueError(f"{what} rows must be contiguous with row stride C")


def pair_sweep(recv, sup, n_cells: int, boxsize: float, scale: float,
               cutoff2: float, soft2: float, kernel: str = "plummer",
               rext=None, sext=None):
    """The sweep: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (see the module docstring for the contract)."""
    if (rext is None) != (sext is None):
        raise ValueError("give both rext and sext, or neither")
    if recv.device.type == "cpu":
        return pair_sweep_plain(recv, sup, n_cells, boxsize, scale, cutoff2,
                                soft2, kernel, rext, sext)
    _check(recv, sup, n_cells, kernel)
    _, K_r, C = recv.shape
    K_s = sup.shape[1]
    _check_cuda_rows(recv, C, "recv")
    _check_cuda_rows(sup, C, "sup")
    if sup.device != recv.device or K_r < 1:
        raise ValueError("recv and sup must share a device; K_r ≥ 1")
    if rext is not None:
        for e in (rext, sext):
            if e.dtype != torch.int32 or not e.is_contiguous() \
                    or e.numel() != n_cells**2 or e.device != recv.device:
                raise ValueError("rext/sext must be contiguous (n²,) int32 "
                                 "on the receivers' device")
    out = torch.empty((3, K_r, C), dtype=torch.float32, device=recv.device)
    coef = np.ascontiguousarray(_G_COEF, np.float32)
    inv_scale = float(np.float32(1.0) / np.float32(scale))
    err = _lib()(
        recv.data_ptr(), recv.stride(0), K_r, sup.data_ptr(), sup.stride(0),
        K_s, n_cells, None if rext is None else rext.data_ptr(),
        None if sext is None else sext.data_ptr(), out.data_ptr(),
        boxsize, inv_scale, cutoff2, soft2, KERNEL_IDS[kernel],
        coef.ctypes.data, torch.cuda.current_stream(recv.device).cuda_stream,
    )
    _build.check(err, "pair_sweep")
    pair_sweep.launches += 1
    return out


pair_sweep.launches = 0
