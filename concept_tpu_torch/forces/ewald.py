"""Ewald summation for exact periodic gravity (the PP method): port of
concept_tpu/forces/ewald.py (reference src/ewald.py: summation at :62,
the tabulation and its disk cache at :207-271, the lookup with symmetry
folding at :146).

Conventions (unit box, G = 1, unit masses; x = displacement from the
source):
  acceleration field a(x) = −Σ_images (x+n)/|x+n|³   (attraction)
  Ewald split (Hernquist, Bouchet & Suto 1991):
  a(x) = −Σ_n  x_n/|x_n|³ [erfc(α r_n) + 2α r_n/√π e^(−α²r_n²)]
         −Σ_h 2 h/|h|² e^(−π²|h|²/α²) sin(2π h·x)
  correction(x) ≡ a(x) + x_mi/|x_mi|³   (x_mi = minimum image),
so the total periodic force = direct minimum-image force + correction.

The correction is tabulated once on a (g+1)³ grid over the octant
[0, ½]³ of the unit box, in float64 with torch on the run's device, in
chunks of points with the images and the modes vectorised (the JAX
package tabulates on the host, through csrc/ewald.cpp where it is
built), and cached under ``.reusable/ewald`` with the JAX package's key.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

ALPHA = 2.0  # Ewald split parameter (images |n| ≤ 4, modes |h|² ≤ 40 suffice)


def ewald_acceleration(x, alpha: float = ALPHA, nmax: int = 4, h2max: int = 40):
    """Exact periodic acceleration field at the displacements x (..., 3)
    in [−½, ½] of the unit box, float64 on x's device (port of
    ``ewald_acceleration_np``)."""
    x = torch.as_tensor(x).to(torch.float64)
    dev = x.device
    shape = x.shape
    pts = x.reshape(-1, 3)
    rng = torch.arange(-nmax, nmax + 1, dtype=torch.float64, device=dev)
    images = torch.cartesian_prod(rng, rng, rng)  # (n_img, 3)
    hmax = int(math.isqrt(h2max))
    hr = torch.arange(-hmax, hmax + 1, dtype=torch.float64, device=dev)
    modes = torch.cartesian_prod(hr, hr, hr)
    h2 = (modes * modes).sum(1)
    keep = (h2 > 0) & (h2 <= h2max)
    modes, h2 = modes[keep], h2[keep]
    mode_coef = (2.0 / h2) * torch.exp(-(math.pi**2) * h2 / alpha**2)
    rows = max(1, (1 << (24 if dev.type == "cuda" else 21)) // (3 * images.shape[0]))
    out = torch.empty_like(pts)
    for i0 in range(0, pts.shape[0], rows):
        p = pts[i0:i0 + rows]
        # real-space sum over the images
        r = p[:, None, :] + images[None]
        r2 = (r * r).sum(-1)
        r1 = torch.sqrt(torch.clamp(r2, min=1e-30))
        w = torch.special.erfc(alpha * r1) + (2 * alpha / math.sqrt(math.pi)) * r1 * torch.exp(
            -(alpha**2) * r2)
        acc = -(r * (w / torch.clamp(r1**3, min=1e-30))[..., None]).sum(1)
        # k-space sum over the modes
        phase = 2 * math.pi * (p @ modes.T)
        out[i0:i0 + rows] = acc - (torch.sin(phase) * mode_coef[None]) @ modes
    return out.reshape(shape)


def tabulate_ewald_correction(gridsize: int = 64, device="cpu"):
    """The correction on a (g+1)³ grid over [0, ½]³, (g+1, g+1, g+1, 3)
    float64 on ``device``, read from the cache where it is there
    (reference ewald.py:207-271)."""
    from concept_tpu_torch.utils.cache import cache_filename

    fname = cache_filename("ewald", gridsize, ALPHA)
    if os.path.exists(fname):
        return torch.as_tensor(np.load(fname)["corr"], device=device)
    g = gridsize
    coords = torch.linspace(0.0, 0.5, g + 1, dtype=torch.float64, device=device)
    pts = torch.cartesian_prod(coords, coords, coords)
    acc = ewald_acceleration(pts)
    r2 = (pts * pts).sum(-1)
    r1 = torch.sqrt(torch.clamp(r2, min=1e-30))
    direct = -pts / torch.clamp(r1, min=1e-30)[:, None] ** 3
    corr = acc - direct
    corr[r2 == 0] = 0.0
    corr = corr.reshape(g + 1, g + 1, g + 1, 3)
    try:
        np.savez(fname, corr=corr.cpu().numpy())
    except OSError:
        pass
    return corr


def ewald_correction_lookup(table, x):
    """Trilinear lookup of the correction at the displacements x (unit
    box, x ∈ [−½, ½]³), using the odd symmetry of each force component
    under reflection of its own coordinate and its evenness under the
    others (reference ewald.py:146-206)."""
    g = table.shape[0] - 1
    sign = torch.where(x < 0, -1.0, 1.0).to(x.dtype)
    u = torch.clamp(x.abs() * (2 * g), 0.0, g - 1e-6)  # grid coordinates over [0, ½]
    # in float32 g − 1e-6 may round up to g: the cell below then takes u
    # at its far corner (weight 1), the value JAX's clamped gather reads
    a = torch.clamp(torch.floor(u), max=g - 1)
    f = u - a
    i0 = a.to(torch.int64)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[..., 0] if dx else 1 - f[..., 0])
                     * (f[..., 1] if dy else 1 - f[..., 1])
                     * (f[..., 2] if dz else 1 - f[..., 2]))
                vals = table[i0[..., 0] + dx, i0[..., 1] + dy, i0[..., 2] + dz]
                out = out + w[..., None] * vals
    # component d flips its sign with coordinate d
    return out * sign
