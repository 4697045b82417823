"""Initial conditions: primordial noise and 1LPT particle realization
(port of the 'simple' scheme of concept_tpu/ic.py; reference
src/ic.py:928-1446).

The 'simple' noise is ``jax.random.normal(jax.random.key(seed), (n,n,n),
float32)`` of the JAX package, to rounding: JAX 0.9 draws it with
threefry2x32 (jax_threefry_partitionable = True) under the key data
[0, seed], one 64-bit counter per element in row-major order, the two
output words xor-ed, the top 23 bits mapped to a uniform in (−1, 1) and
that to a normal by √2·erfinv.  threefry2x32 runs here on int64 tensors
masked to 32 bits; the bits and uniforms equal JAX's exactly, and erfinv
uses XLA's float32 polynomial.

Conventions: δ_dft(k) = Σ_x δ(x) e^{−ikx}; ⟨|δ_dft(k)|²⟩ = N_cells²/V·P(k),
so the realization amplitude is √(N/V)·√P(k) on unit-variance noise.
Zel'dovich: x = q + ψ(q), ψ(k) = i k/k² δ(k); mom = a²·m·H·f1·ψ.
2LPT/3LPT, the 'distributed' noise, fixed amplitudes, phase shifts and
non-Gaussianity are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from concept_tpu_torch.components import (
    ComponentSpec, ParticleState, lattice_positions, periodic_wrap,
)
from concept_tpu_torch.grid import fourier
from concept_tpu_torch.grid.fft import irfft3, rfft3

IC_ITEM = "ROADMAP Queue 1 item 6: other IC schemes and LPT orders"
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: tuple[int, int], x0, x1):
    """Threefry-2x32 with 20 rounds (Random123; JAX's threefry2x32_p).
    key: two uint32 words; x0, x1: int64 tensors holding uint32 counters.
    Returns the two output words as int64 tensors in [0, 2³²)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def random_bits(seed: int, n_elems: int, device="cpu"):
    """JAX's partitionable 32-bit random bits of ``jax.random.key(seed)``
    for n_elems elements (row-major), as int64 in [0, 2³²)."""
    key = ((seed >> 32) & _M32, seed & _M32)
    lo = torch.arange(n_elems, dtype=torch.int64, device=device)
    hi = torch.zeros_like(lo) if n_elems <= 1 << 32 else lo >> 32
    b0, b1 = threefry2x32(key, hi, lo & _M32)
    return b0 ^ b1


# M. Giles, "Approximating the erfinv function": the single-precision
# polynomials XLA evaluates for lax.erf_inv (w < 5 and w ≥ 5 branches).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """erfinv as JAX computes it in float32 (Giles' approximation, ~3e-6
    relative): torch.erfinv is more accurate, and the noise is meant to
    equal the JAX package's, not the exact normal quantiles."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return p * x


def normal_noise(seed: int, n: int, device="cpu"):
    """``jax.random.normal(jax.random.key(seed), (n, n, n), float32)``."""
    bits = random_bits(seed, n**3, device)
    # top 23 bits → a float in [1, 2) → [0, 1) → (−1, 1)
    one = 0x3F800000
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.nextafter(np.float32(-1.0), np.float32(1.0)))
    width = float(np.float32(1.0) - np.float32(lo))
    u = torch.clamp(floats * width + lo, min=lo)
    return (math.sqrt(2.0) * erfinv_f32(u)).reshape(n, n, n)


def realize_delta_slab(lin, gridsize: int, boxsize: float, a: float,
                       seed: int = 0, dtype=torch.float32, device="cpu"):
    """δ(k) in DFT normalisation at scale factor a ('simple' noise;
    reference ic.py:542 get_amplitudes + ic.py:670 realize_grid)."""
    n = gridsize
    R = rfft3(normal_noise(seed, n, device).to(dtype))
    # the amplitude depends on |k|² only: evaluate the (float64, host)
    # linear layer once per integer |k|², then index
    k2 = fourier.k2_int_grid(n, device)
    k2_vals = np.arange(int(3 * (n // 2) ** 2) + 1, dtype=np.float64)
    kmag = (2 * math.pi / boxsize) * np.sqrt(k2_vals)
    amp = np.zeros_like(kmag)
    amp[1:] = lin.delta_amplitude(kmag[1:], a) * math.sqrt(n**3 / boxsize**3)
    return R * torch.as_tensor(amp, dtype=dtype, device=device)[k2]


def preic_lattice_of(N: int) -> str:
    """Pre-IC lattice implied by the particle count (reference
    species.py:1107-1117): n³ → sc, 2n³ → bcc, 4n³ → fcc."""
    def _iscube(m: int) -> bool:
        return round(m ** (1 / 3)) ** 3 == m

    if _iscube(N):
        return "sc"
    if N % 2 == 0 and _iscube(N // 2):
        return "bcc"
    if N % 4 == 0 and _iscube(N // 4):
        return "fcc"
    raise ValueError(f"N = {N} matches no pre-IC lattice (needs n**3, "
                     f"2*n**3 or 4*n**3 for sc/bcc/fcc)")


def realize_particles(lin, spec: ComponentSpec, boxsize: float, a: float,
                      seed: int = 0, lpt_order: int = 1, dtype=torch.float32,
                      device="cpu", with_ids: bool = False,
                      scheme: str = "simple", fixed_amplitude: bool = False,
                      phase_shift: float = 0.0, nongaussianity: float = 0.0,
                      dealias: bool = False, backscale: bool = False,
                      delta_k=None) -> ParticleState:
    """1LPT particle ICs on the sc lattice at scale factor a (reference
    ic.py:1199-1446).  ``delta_k`` overrides the realized density."""
    if lpt_order != 1 or scheme != "simple" or fixed_amplitude \
            or phase_shift or nongaussianity or dealias or backscale:
        raise NotImplementedError(
            f"only 1LPT with 'simple' noise is ported (lpt={lpt_order}, "
            f"scheme={scheme!r}; {IC_ITEM})")
    lattice = preic_lattice_of(spec.N)
    if lattice != "sc":
        raise NotImplementedError(f"{lattice} pre-IC lattice ({IC_ITEM})")
    n = round(spec.N ** (1 / 3))
    H = float(lin.bg.hubble_np(a))
    f1 = float(lin.bg.growth_np("f1", a))
    if delta_k is None:
        delta_k = realize_delta_slab(lin, n, boxsize, a, seed, dtype, device)
    kfac = 2 * math.pi / boxsize
    k2 = fourier.k2_int_grid(n, device).to(dtype) * kfac**2
    inv_k2 = torch.where(k2 > 0, 1.0 / k2, 0.0)
    kvecs = fourier.k_int_vectors(n, device)
    # ψ grids sampled at the sc lattice sites = the grid's cell centres
    disp = torch.stack([
        irfft3((1j * (kvecs[d].to(dtype) * kfac)) * inv_k2 * delta_k, n).reshape(-1)
        for d in range(3)], dim=1)
    q = lattice_positions(n, boxsize, "sc", dtype, device)
    pos = periodic_wrap(q + disp, boxsize)
    mom = (a * a * spec.mass) * (H * f1 * disp)
    ids = torch.arange(spec.N, dtype=torch.int32, device=device) if with_ids else None
    return ParticleState(pos=pos, mom=mom.to(dtype), ids=ids)
