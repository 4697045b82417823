"""P³M short-range pair force law and its host-side helpers (port of the
plain parts of concept_tpu/forces/shortrange.py and the host half of
concept_tpu/forces/pallas_shortrange.py).

The pair force is

    F(r) = −G·m²·r⃗ · S(r/rₛ) · r⁻³_soft,   S(x) = erfc(x/2) + x/√π·e^(−x²/4)

(reference gravity.py:373 get_shortrange_table).  The screening is
evaluated as S = 1 + x·g(x²) with a degree-10 polynomial fit of g in
u = r²/rₛ² (``_G_COEF``) — the same polynomial the CUDA sweep kernel
evaluates (csrc/pair_sweep.cu), so the plain sweep here and the kernel
compute one function.  ``_sweep_pair`` is the one-sided sweep with the
valid-mask contract of the JAX ``_sweep_pair``; it sentinels the invalid
slots and hands them to ``cuda_shortrange.pair_sweep``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Fit range of the screening polynomial: x = r/rₛ ∈ [0, 4.6] (the cutoff
# is 4.5·rₛ; beyond the fit the argument is clamped and the cutoff mask
# removes the pair anyway).
_X_MAX = 4.6
_U_MAX = _X_MAX * _X_MAX
_G_DEG = 10

SENTINEL = 1e4  # invalid slots sit at SENTINEL·boxsize (p3mrungs.py:470)


def _fit_screening_g(deg: int = _G_DEG) -> np.ndarray:
    """Monomial (Horner) coefficients of g(t), t = 2u/u_max − 1, highest
    degree first, float32.  Fitted in float64 in a Chebyshev basis and
    converted to monomials in t (|t| ≤ 1 keeps Horner stable in f32)."""
    x = np.linspace(1e-9, _X_MAX, 8001)
    S = np.asarray([math.erfc(0.5 * xi) for xi in x])
    S = S + x / math.sqrt(math.pi) * np.exp(-0.25 * x * x)
    g = (S - 1.0) / x
    t = 2 * (x * x) / _U_MAX - 1
    coef = np.polynomial.chebyshev.chebfit(t, g, deg)
    mono = np.polynomial.chebyshev.cheb2poly(coef)
    Sv = 1.0 + x * np.polynomial.polynomial.polyval(t, mono)
    err = np.abs(Sv - S).max()
    if err >= 1e-6:
        raise RuntimeError(f"screening fit error {err:.3g} ≥ 1e-6")
    return mono[::-1].astype(np.float32)


_G_COEF = _fit_screening_g()


def screening_g(u: torch.Tensor) -> torch.Tensor:
    """g(u) = (S(√u) − 1)/√u by the Horner fit.  u is clamped into the
    fitted range, which keeps far sentinels finite."""
    t = torch.clamp(2.0 * u / _U_MAX - 1.0, max=1.0)
    g = torch.full_like(t, float(_G_COEF[0]))
    for c in _G_COEF[1:]:
        g = g * t + float(c)
    return g


def softened_r3inv(r2: torch.Tensor, softening: float, kernel: str):
    """Softened r⁻³ per ``softening_kernel`` (reference get_softened_r3inv,
    interactions.py:1846-1910): 'plummer' 1/(r²+ε²)^{3/2}; 'spline' the
    GADGET-2 cubic spline with h = 2.8ε; 'none' plain 1/r³."""
    if kernel == "plummer":
        r2s = r2 + softening * softening
        return torch.rsqrt(r2s) / r2s
    inv_r = torch.rsqrt(torch.clamp(r2, min=1e-30))
    far = inv_r * inv_r * inv_r
    if kernel == "none":
        return far
    if kernel == "spline":
        h = 2.8 * softening
        inv_h = 1.0 / h if h > 0 else 1e30
        r = r2 * inv_r
        u = r * inv_h
        near = 32.0 * inv_h**3 * (1.0 / 3.0 + u * u * (-6.0 / 5.0 + u))
        mid = (32.0 / 3.0) * far * (
            u**3 * (2.0 + u * (-4.5 + u * (3.6 - u))) - 3.0 / 480.0
        )
        return torch.where(u >= 1.0, far, torch.where(u < 0.5, near, mid))
    raise ValueError(f"unknown softening kernel {kernel!r}")


def shortrange_force_factor(r2: torch.Tensor, scale: float, softening2: float,
                            kernel: str = "plummer") -> torch.Tensor:
    """−S(r/rₛ)·r⁻³_softened with the fitted screening, in the form the
    sweep kernels evaluate it (pallas_shortrange ``_make_accum``):
    'plummer' evaluates S at the softened r; the other kernels take the
    unsoftened far field S·r⁻³ and, for 'spline', add the near-field
    correction −S·(r⁻³_spline − r⁻³) where r < h = 2.8ε."""
    inv_scale = 1.0 / scale
    inv_scale2 = inv_scale * inv_scale
    if kernel == "plummer":
        r2s = r2 + softening2
        inv_r = torch.rsqrt(r2s)
        g = screening_g(r2s * inv_scale2)
        return -(inv_r * inv_r * (inv_r + inv_scale * g))
    inv_r = torch.rsqrt(torch.clamp(r2, min=1e-30))
    inv_r2 = inv_r * inv_r
    g = screening_g(r2 * inv_scale2)
    f = -(inv_r2 * (inv_r + inv_scale * g))
    if kernel == "none":
        return f
    if kernel != "spline":
        raise ValueError(f"unknown softening kernel {kernel!r}")
    S = 1.0 + (r2 * inv_r * inv_scale) * g
    near = softened_r3inv(r2, math.sqrt(softening2), kernel) - inv_r2 * inv_r
    return f - torch.where(r2 < 7.84 * softening2, S * near, 0.0)


def window_bounds(ext: torch.Tensor, n: int, neighbors: bool) -> torch.Tensor:
    """Per-pencil layout extents (n²,) → per-pencil row bounds (n²,).
    neighbors=True takes the max over the 9 pencils ((i±1) mod n,
    (j±1) mod n) a column's 27-cell neighbourhood reads — the supplier
    bound of ``_window_bounds(..., neighbors=True)`` at pack factor 1."""
    w = ext.reshape(n, n)
    if neighbors:
        m = w
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if di or dj:
                    m = torch.maximum(m, torch.roll(w, (di, dj), (0, 1)))
        w = m
    return w.reshape(n * n)


def _sweep_pair(bx, by, bz, bvalid, hx, hy, hz, valid, n_cells: int,
                boxsize: float, scale: float, cutoff2: float, soft2: float,
                kernel: str = "plummer"):
    """One-sided sweep with the valid-mask contract of the JAX
    ``_sweep_pair``: accelerations (3, K_r, C) ON the receiver slots
    (bx, by, bz, bvalid) FROM the supplier slots (hx, hy, hz, valid) of
    the 27 periodic neighbour cells; the caller applies G·m."""
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep

    big = SENTINEL * boxsize
    recv = torch.where(bvalid[None], torch.stack([bx, by, bz]), big)
    sup = torch.where(valid[None], torch.stack([hx, hy, hz]), big)
    return pair_sweep(recv, sup, n_cells, boxsize, scale, cutoff2, soft2,
                      kernel=kernel)


def f32_square(x: float) -> float:
    """x² rounded as the float32 kernels form it (f32(x)·f32(x))."""
    x = np.float32(x)
    return float(x * x)
