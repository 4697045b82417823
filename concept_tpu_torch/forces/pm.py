"""Gravitational potential on the mesh (port of
``gravity_potential_slab``, concept_tpu/forces/pm.py:128)."""

from __future__ import annotations

import math

import torch

from concept_tpu_torch.grid import fourier


def gravity_potential_slab(rho_slab, gridsize: int, boxsize: float, G: float,
                           deconv_order: int = 0,
                           longrange_scale: float | None = None):
    """φ(k) = −4πG ϱ(k)/|k|² (·exp(−rₛ²|k|²) for the P³M long-range
    part), times the sinc deconvolution of total power ``deconv_order``
    (upstream + downstream, promoted to one global factor as in reference
    interactions.py:2060-2080).  The k = 0 mode is zeroed."""
    n = gridsize
    dtype = rho_slab.real.dtype
    dev = rho_slab.device
    k2 = (2 * math.pi / boxsize) ** 2 * fourier.k2_int_grid(n, dev).to(dtype)
    factor = torch.where(k2 > 0, -4 * math.pi * G / torch.where(k2 > 0, k2, 1.0),
                         0.0)
    if longrange_scale is not None:
        factor = factor * torch.exp(-(longrange_scale**2) * k2)
    if deconv_order:
        factor = factor * fourier.deconvolution_factor(n, deconv_order, dtype,
                                                       dev)
    phi = rho_slab * factor
    phi[0, 0, 0] = 0
    return phi
