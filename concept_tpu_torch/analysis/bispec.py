"""Bispectrum by the shell-FFT estimator (port of
concept_tpu/analysis/bispec.py; reference analysis.py:929-3282).

Named triangle configurations, shell binning, per-triangle products of
three shell-filtered inverse FFTs, mode counting, the reduced
bispectrum and the tree-level prediction:
    B̂(k1,k2,k3) = (V²/n⁹) · ⟨Πᵢ δᵢ(x)⟩ₓ / ⟨Πᵢ wᵢ(x)⟩ₓ
with δᵢ = irfft(δ(k)·1_{|k|∈shell_i}), wᵢ = irfft(1_{shell_i}), and the
triangle count N_tri = n⁹·⟨Πwᵢ⟩ₓ.  The deposit is ``grid/interp.deposit``
and the FFTs are ``torch.fft`` (cuFFT on the card); the shell fields of
each distinct k stay on the device while the triangles are summed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from concept_tpu_torch.components import periodic_wrap
from concept_tpu_torch.grid import fourier
from concept_tpu_torch.grid.fft import irfft3, rfft3
from concept_tpu_torch.grid.interp import deposit


def _shellthickness_at(spec: dict, k: float, kf: float, gridsize: int):
    """Running shell thickness at wavenumber k: control points {k: value}
    interpolated in log10 k, both sides allowed as expressions in
    k_fundamental/k_f/nyquist/gridsize, the values also in 'k' (reference
    bispec_options 'shellthickness', param/example_explanatory:268-276)."""
    names = {
        "k_fundamental": kf, "k_f": kf, "k_min": kf,
        "nyquist": kf * (gridsize // 2), "gridsize": gridsize, "k": k,
        "min": min, "max": max, "log": math.log, "log10": math.log10,
        "sqrt": math.sqrt, "pi": math.pi,
    }

    def ev(x):
        if isinstance(x, str):
            return float(eval(x, {"__builtins__": {}}, names))  # noqa: S307
        return float(x)

    pts = sorted((ev(kk), ev(vv)) for kk, vv in spec.items())
    if len(pts) == 1:
        return pts[0][1]
    xs = np.log10([p[0] for p in pts])
    ys = [p[1] for p in pts]
    return float(np.interp(math.log10(max(k, 1e-30)), xs, ys))


def shell_field(delta_slab, gridsize: int, k_center: float, half_width: float,
                boxsize: float, antialias: bool = True):
    """(irfft of δ(k) restricted to |k| ∈ [k−Δ, k+Δ], irfft of the shell
    weights).  ``antialias``: each Fourier cell is weighted by a linear
    ramp over one k-cell of its overlap with the shell instead of a
    binary cut (the reference's anti-aliased cell-shell overlap,
    analysis.py:2803-3030, to first order)."""
    kfac = 2 * math.pi / boxsize
    dev = delta_slab.device
    kmag = kfac * torch.sqrt(fourier.k2_int_grid(gridsize, dev).to(torch.float32))
    if antialias:
        lo = (kmag - (k_center - half_width)) / kfac + 0.5
        hi = ((k_center + half_width) - kmag) / kfac + 0.5
        w = torch.clamp(torch.minimum(lo, hi), 0.0, 1.0)
    else:
        w = ((kmag >= k_center - half_width)
             & (kmag < k_center + half_width)).to(torch.float32)
    return (irfft3(w * delta_slab, gridsize),
            irfft3(w.to(torch.complex64), gridsize))


def _tri_from_ktmu(k1, t, mu):
    """(k₁, t, μ) → (k₁, k₂, k₃) with k₂ = t·k₁ and
    k₃² = k₁²(1 + t² − 2tμ) (analysis.py:1540-1760)."""
    k2 = t * k1
    k3 = k1 * math.sqrt(max(1.0 + t * t - 2.0 * t * mu, 0.0))
    return (k1, k2, k3)


def triangle_configurations(configuration, k_min, k_max, n=10):
    """Named configurations → list of (k1, k2, k3) (the reference's
    families, analysis.py:1540-1760, each as (k₁, t = k₂/k₁, μ)):
      equilateral     t = 1,   μ = ½          (k, k, k)
      stretched       t = ½,   μ = 1          (k, k/2, k/2)
      squeezed        t = 1,   μ = 0.99       k₃ ≥ k_min
      isosceles right t = μ = 1/√2
      L-isosceles     t = 1,   ½ ≤ μ ≤ μ_max  (2D)
      S-isosceles     ½ ≤ t ≤ 1, μ = 1/(2t)   (2D)
      elongated       ½ ≤ t ≤ t_max, μ = 1    (2D)
      right           1/√2 ≤ t = μ ≤ t_max    (2D)
      all             k₁ ≥ k₂ ≥ k₃ closing triples (3D)
    'name n' sets the number of k₁ points; a list of triples passes
    through."""
    if isinstance(configuration, (list, tuple)) and configuration and isinstance(
            configuration[0], (list, tuple)):
        return [tuple(c) for c in configuration]
    if not isinstance(configuration, str):
        raise ValueError(f"bad bispectrum configuration {configuration!r}")
    parts = configuration.split()
    name = parts[0].lower().replace("-", "").replace("_", "")
    if len(parts) > 1:
        n = int(parts[1])
    ks = np.exp(np.linspace(math.log(k_min), math.log(k_max), n))
    k3_min = k_min
    if name.startswith("equilat"):
        return [(k, k, k) for k in ks]
    if name.startswith("stretch"):
        return [_tri_from_ktmu(k, 0.5, 1.0) for k in ks]
    if name.startswith("squeez"):
        mu = 0.99
        k_bgn = max(k_min, k3_min / math.sqrt(2 * (1 - mu)))
        if k_max <= k_bgn:
            raise ValueError("k range too small for the squeezed configuration")
        nn = max(2, int(round(n * math.log10(k_max / k_bgn))))
        ks2 = np.exp(np.linspace(math.log(k_bgn), math.log(k_max), nn))
        return [_tri_from_ktmu(k, 1.0, mu) for k in ks2]
    if "iso" in name and "right" in name:
        r = 1 / math.sqrt(2)
        return [_tri_from_ktmu(k, r, r) for k in ks]
    if name.startswith("liso") or ("iso" in name and "large" in name) or name == "isosceles":
        out = []
        mu_lo = 0.5
        mus = np.linspace(mu_lo, 1.0, max(2, int(round(2 * n * 0.5))))
        for k in ks:
            mu_max = max(mu_lo, (2 - k3_min**2 / k**2) / 2)
            mu_i = np.append(mus[mus < mu_max], mu_max)
            out += [_tri_from_ktmu(k, 1.0, mu) for mu in mu_i]
        return out
    if name.startswith("siso") or ("iso" in name and "small" in name):
        ts = np.linspace(0.5, 1.0, max(2, int(round(2 * n * 0.720599))))
        return [_tri_from_ktmu(k, t, 1 / (2 * t)) for k in ks for t in ts]
    if (name.startswith("elongat") or name.startswith("flat")
            or name.startswith("fold") or name.startswith("linear")):
        out = []
        ts = np.linspace(0.5, 1.0, max(2, int(round(2 * n * 0.5))))
        for k in ks:
            t_max = max(0.5, 1.0 - k3_min / k)
            t_i = np.append(ts[ts < t_max], t_max)
            out += [_tri_from_ktmu(k, t, 1.0) for t in t_i]
        return out
    if name.startswith("right"):
        out = []
        t_lo = 1 / math.sqrt(2)
        ts = np.linspace(t_lo, 1.0, max(2, int(round(2 * n * math.sqrt(2) * (1 - t_lo)))))
        for k in ks:
            t_max = max(t_lo, math.sqrt(max(1 - k3_min**2 / k**2, 0.0)))
            t_i = np.append(ts[ts < t_max], t_max)
            out += [_tri_from_ktmu(k, t, t) for t in t_i]
        return out
    if name == "all":
        return [(k1, k2, k3) for k1 in ks for k2 in ks for k3 in ks
                if k1 >= k2 >= k3 and k3 >= k1 - k2]
    raise ValueError(f"unknown bispectrum configuration {name!r}")


def bispec(pos_list, weight_list, gridsize: int, boxsize: float,
           configuration="equilateral 10", order: int = 4, interlace: bool = True,
           shell_fac: float = 0.05, antialias: bool = True,
           shotnoise_correction: bool = False, n_particles: int | None = None,
           shellthickness=None):
    """Measure B(k1, k2, k3) of the particle groups ``pos_list`` (tensors
    on one device) with mass weights ``weight_list``.  Returns numpy
    arrays per triangle: triangles, B, the reduced Q = B/(P₁P₂ + P₂P₃ +
    P₃P₁) and n_triangles.

    shell_fac: shell half-width max(k_fundamental, shell_fac·k).
    shellthickness: the reference's running specification instead, a
    dict {k_or_expr: thickness_expr} (see :func:`_shellthickness_at`).
    antialias: the cell-shell overlap weights.  shotnoise_correction:
    P → P − 1/n̄ and B → B − (P₁ᶜ+P₂ᶜ+P₃ᶜ)/n̄ − 1/n̄², n̄ = N/V (needs
    n_particles)."""
    if shotnoise_correction and not n_particles:
        raise ValueError("shotnoise_correction requires n_particles")
    n = gridsize
    V = boxsize**3
    kf = 2 * math.pi / boxsize
    p0 = pos_list[0]

    def dep(shift):
        grid = None
        for p, w in zip(pos_list, weight_list):
            g = deposit(p if shift is None else periodic_wrap(p + shift, boxsize),
                        w, n, boxsize, order)
            grid = g if grid is None else grid + g
        return grid

    grid = dep(None)
    mean = grid.mean()
    slab = rfft3(grid / mean - 1.0)
    del grid
    if interlace:
        slab2 = rfft3(dep(0.5 * boxsize / n) / mean - 1.0)
        phase = fourier.interlace_phase(n, (-0.5, -0.5, -0.5), p0.dtype, p0.device)
        slab = 0.5 * (slab + slab2 * phase)
        del slab2
    slab = slab * fourier.deconvolution_factor(n, order, p0.dtype, p0.device)

    triangles = triangle_configurations(configuration, 2 * kf, 0.8 * kf * (n // 2))
    cache = {}  # shell fields by k centre, shared between triangles

    def get_shell(k):
        key = round(float(k) / kf, 3)
        if key not in cache:
            if shellthickness is not None:
                hw = 0.5 * _shellthickness_at(shellthickness, float(k), kf, n)
            else:
                hw = max(kf, shell_fac * k)
            cache[key] = shell_field(slab, n, k, hw, boxsize, antialias=antialias)
        return cache[key]

    out_B, out_T, out_Q = [], [], []
    pcache = {}
    inv_nbar = V / n_particles if shotnoise_correction else 0.0
    for (k1, k2, k3) in triangles:
        shells = [get_shell(k) for k in (k1, k2, k3)]
        (d1, w1), (d2, w2), (d3, w3) = shells
        num = float((d1 * d2 * d3).mean())
        den = float((w1 * w2 * w3).mean())
        if den <= 0:
            out_B.append(np.nan)
            out_T.append(0.0)
            out_Q.append(np.nan)
            continue
        # each irfft carries 1/n³, so num/den = ⟨δ_dft δ_dft δ_dft⟩ per
        # closed triangle, and B = (V²/n⁹)·⟨δδδ⟩
        B = (V**2 / float(n) ** 9) * (num / den)
        out_T.append(den * float(n) ** 9)
        Ps = []
        for k, (d, w) in zip((k1, k2, k3), shells):
            key = round(float(k) / kf, 3)
            if key not in pcache:
                # Parseval: ⟨|δ|²⟩_shell = Σd²/Σw², P = V/n⁶·⟨|δ|²⟩
                nume = float((d * d).sum())
                dene = float((w * w).sum())
                pcache[key] = (V / float(n) ** 6) * (nume / dene if dene > 0 else np.nan)
            Ps.append(pcache[key] - inv_nbar)
        P1, P2, P3 = Ps
        if shotnoise_correction:
            B = B - (P1 + P2 + P3) * inv_nbar - inv_nbar**2
        out_B.append(B)
        hierarchical = P1 * P2 + P2 * P3 + P3 * P1
        out_Q.append(B / hierarchical if hierarchical > 0 else np.nan)
    return {"triangles": np.asarray(triangles), "B": np.asarray(out_B),
            "Q": np.asarray(out_Q), "n_triangles": np.asarray(out_T)}


def bispec_treelevel(lin, triangles, a):
    """Tree-level prediction B = 2F₂(k1,k2)P(k1)P(k2) + cyclic (reference
    analysis.py:3195), F₂ with the cosine of the closed triangle."""
    def F2(ka, kb, kc):
        mu = (kc**2 - ka**2 - kb**2) / (2 * ka * kb)
        return 5.0 / 7.0 + 0.5 * mu * (ka / kb + kb / ka) + 2.0 / 7.0 * mu * mu

    out = []
    for (k1, k2, k3) in np.asarray(triangles):
        P = {k: float(lin.power_delta(np.float64(k), a)) for k in (k1, k2, k3)}
        out.append(2 * F2(k1, k2, k3) * P[k1] * P[k2]
                   + 2 * F2(k2, k3, k1) * P[k2] * P[k3]
                   + 2 * F2(k3, k1, k2) * P[k3] * P[k1])
    return np.asarray(out)
