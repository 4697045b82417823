"""Initial conditions: primordial noise and 1/2/3LPT particle realization
(port of concept_tpu/ic.py; reference src/ic.py:928-2058).

The 'simple' noise is ``jax.random.normal(jax.random.key(seed), (n,n,n),
float32)`` of the JAX package, to rounding: JAX 0.9 draws it with
threefry2x32 (jax_threefry_partitionable = True) under the key data
[0, seed], one 64-bit counter per element in row-major order, the two
output words xor-ed, the top 23 bits mapped to a uniform in (−1, 1) and
that to a normal by √2·erfinv.  threefry2x32 runs here on int64 tensors
masked to 32 bits; the bits and uniforms equal JAX's exactly, and erfinv
uses XLA's float32 polynomial.  In float64 (``enable_float64``) it is
``jax.random.normal(..., float64)`` as the JAX package draws it under x64:
the two output words as one 64-bit integer, its top 52 bits a uniform,
and torch's erfinv in double (XLA's double polynomial agrees to
rounding).

Conventions: δ_dft(k) = Σ_x δ(x) e^{−ikx}; ⟨|δ_dft(k)|²⟩ = N_cells²/V·P(k),
so the realization amplitude is √(N/V)·√P(k) on unit-variance noise.
Zel'dovich: x = q + ψ(q), ψ(k) = i k/k² δ(k); mom = a²·m·H·f1·ψ.
2LPT: x += ψ², ψ²(k) = (D2/D1²)·i k/k²·S(k), S = Σ_{i<j}(ψ¹ᵢ,ᵢψ¹ⱼ,ⱼ −
(ψ¹ᵢ,ⱼ)²); 3LPT adds the two scalar terms and the transverse one
(reference carryout_2lpt / carryout_3lpt_{a,b,c}, ic.py:1546-1845).

The 'distributed' noise is the JAX package's mode hash (a 32-bit integer
hash of the seed and the mode's coordinates), computed on int64 tensors
masked to 32 bits.
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
from concept_tpu_torch.grid.interp import gather

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


def _threefry_words(seed: int, n_elems: int, device="cpu"):
    """The two threefry2x32 output words of JAX's partitionable random
    bits of ``jax.random.key(seed)`` for n_elems elements (row-major), as
    int64 tensors in [0, 2³²)."""
    key = ((seed >> 32) & _M32, seed & _M32)
    lo = torch.arange(n_elems, dtype=torch.int64, device=device)
    hi = torch.zeros_like(lo) if n_elems <= 1 << 32 else lo >> 32
    return threefry2x32(key, hi, lo & _M32)


def random_bits(seed: int, n_elems: int, device="cpu"):
    """JAX's partitionable 32-bit random bits of ``jax.random.key(seed)``
    for n_elems elements (row-major), as int64 in [0, 2³²)."""
    b0, b1 = _threefry_words(seed, n_elems, device)
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


def normal_noise(seed: int, n: int, device="cpu", dtype=torch.float32):
    """``jax.random.normal(jax.random.key(seed), (n, n, n), dtype)``."""
    if dtype == torch.float64:
        # 64-bit bits (word 0 high, word 1 low), their top 52 bits → a
        # double in [1, 2) → [0, 1) → (−1, 1)
        b0, b1 = _threefry_words(seed, n**3, device)
        one = 0x3FF0000000000000
        floats = (((b0 << 20) | (b1 >> 12)) | one).view(torch.float64) - 1.0
        lo = float(np.nextafter(-1.0, 0.0))
        u = torch.clamp(floats * (1.0 - lo) + lo, min=lo)
        return (math.sqrt(2.0) * torch.erfinv(u)).reshape(n, n, n)
    bits = random_bits(seed, n**3, device)
    # top 23 bits → a float in [1, 2) → [0, 1) → (−1, 1)
    one = 0x3F800000
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.nextafter(np.float32(-1.0), np.float32(1.0)))
    width = float(np.float32(1.0) - np.float32(lo))
    u = torch.clamp(floats * width + lo, min=lo)
    return (math.sqrt(2.0) * erfinv_f32(u)).reshape(n, n, n)




def _mul32(x, c: int):
    """x·c mod 2³² for x int64 in [0, 2³²) and a 32-bit constant c, in two
    16-bit halves of c so that no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mode_hash(ki, kj, kk, key: tuple[int, int], salt: int):
    """The JAX package's 32-bit hash of a mode's coordinates (int64
    tensors) under the key words of ``jax.random.key(seed)``, as int64 in
    [0, 2³²)."""
    off = 1 << 15
    cnt = (((ki + off) & _M32) ^ (((kj + off) << 11) & _M32)
           ^ (((kk + off) << 22) & _M32) ^ salt)
    x = (_mul32(cnt, 0x9E3779B9) + key[0]) & _M32
    x ^= x >> 16
    x = (_mul32(x, 0x85EBCA6B) + key[1]) & _M32
    x ^= x >> 13
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _modewise_noise(gridsize: int, seed: int, dtype=torch.float32, device="cpu"):
    """Mode-indexed Gaussian noise over the rfft layout (port of
    ``_modewise_noise``): each mode's value is a function of (seed, ki,
    kj, kk) alone, the same at every grid size that holds the mode.
    Modes on the self-conjugate planes kk ∈ {0, n/2} take the conjugate
    of their canonical (lexicographically larger) partner; self-conjugate
    points are real with unit variance.  Normalised to ⟨|R|²⟩ = n³."""
    n = gridsize
    shape = (n, n, n // 2 + 1)
    ki, kj, kk = (k.expand(shape) for k in fourier.k_int_vectors(n, device))
    on_plane = (kk == 0) | (kk == n // 2)

    def alias_neg(k):  # −k with the Nyquist aliasing −(−n/2) ≡ −n/2
        return torch.where(-k == n // 2, -(n // 2), -k)

    pi, pj = alias_neg(ki), alias_neg(kj)
    flip = on_plane & ((kj < pj) | ((kj == pj) & (ki < pi)))
    ki_c = torch.where(flip, pi, ki)
    kj_c = torch.where(flip, pj, kj)
    key = ((seed >> 32) & _M32, seed & _M32)

    def uniform(salt):
        bits = _mode_hash(ki_c, kj_c, kk, key, salt).to(torch.float32)
        return (bits + 0.5) / np.float32(2**32)

    u1 = torch.clamp(uniform(0x1234ABCD), 1e-7, 1 - 1e-7)
    u2 = uniform(0x5678EF01)
    r = torch.sqrt(-torch.log(u1))
    theta = (2 * math.pi) * u2
    re = r * torch.cos(theta)
    im = torch.where(flip, -1.0, 1.0) * (r * torch.sin(theta))
    selfconj = on_plane & (ki == pi) & (kj == pj)
    re = torch.where(selfconj, re * math.sqrt(2), re)
    im = torch.where(selfconj, 0.0, im)
    R = torch.complex(re, im) * math.sqrt(n**3)
    return R.to(torch.complex64 if dtype == torch.float32 else torch.complex128)


def generate_primordial_noise(gridsize: int, seed: int = 0,
                              fixed_amplitude: bool = False,
                              phase_shift: float = 0.0, dtype=torch.float32,
                              scheme: str = "simple", device="cpu"):
    """Unit white noise in the rfft layout with Hermitian symmetry,
    ⟨|R(k)|²⟩ = n³: 'simple' is the transform of JAX's real-space normal
    draw (:func:`normal_noise`), 'distributed' the mode hash
    (:func:`_modewise_noise`).  ``fixed_amplitude`` sets |R| = √n³ and
    keeps the phase; ``phase_shift`` is added to every phase (π for the
    partner of a pair; reference ic.py:1058-1105)."""
    n = gridsize
    if scheme == "simple":
        R = rfft3(normal_noise(seed, n, device, dtype))
    elif scheme == "distributed":
        R = _modewise_noise(n, seed, dtype, device)
    else:
        raise ValueError(f"unknown noise scheme {scheme!r}")
    if fixed_amplitude or phase_shift != 0.0:
        amp = torch.full_like(R.real, math.sqrt(n**3)) if fixed_amplitude else R.abs()
        R = amp * torch.exp(1j * (torch.angle(R) + phase_shift))
    return R


def _by_k2(fn, gridsize: int, boxsize: float, dtype, device, on_device: bool = False):
    """fn(|k|) evaluated once per integer |k|² of the rfft layout and
    indexed onto it; 0 at k = 0.  fn takes the |k| values as a float64
    NumPy array, or, ``on_device``, as a tensor of ``dtype`` on
    ``device`` (the Boltzmann tables' interpolation runs there)."""
    n = gridsize
    k2 = fourier.k2_int_grid(n, device)
    kmag = (2 * math.pi / boxsize) * np.sqrt(
        np.arange(int(3 * (n // 2) ** 2) + 1, dtype=np.float64))
    if on_device:
        vals = fn(torch.as_tensor(kmag[1:], device=device).to(dtype)).to(dtype)
        return torch.cat([vals.new_zeros(1), vals])[k2]
    vals = np.zeros_like(kmag)
    vals[1:] = fn(kmag[1:])
    return torch.as_tensor(vals, dtype=dtype, device=device)[k2]


def _tabulated(lin, species: str) -> bool:
    """True where lin's Boltzmann tables hold the species' δ."""
    from concept_tpu_torch.cosmology.linear import _species_key

    tables = getattr(lin, "tables", None)
    return tables is not None and tables.has(_species_key(species), "delta")


def realize_delta_slab(lin, gridsize: int, boxsize: float, a: float,
                       seed: int = 0, fixed_amplitude: bool = False,
                       phase_shift: float = 0.0, dtype=torch.float32,
                       device="cpu", nongaussianity: float = 0.0,
                       scheme: str = "simple", backscale: bool = False,
                       species: str = "matter"):
    """δ(k) in DFT normalisation at scale factor a (reference ic.py:542
    get_amplitudes + ic.py:670 realize_grid).  ``nongaussianity`` f_NL
    adds the local-type term ζ → ζ + (3/5)f_NL(ζ² − ⟨ζ²⟩) to the
    primordial field; ``backscale`` realizes the a = 1 spectrum scaled
    back by D1(a) (the classic N-body convention).  ``species`` selects
    the transfer function (matter / cb / nu — reference TransferFunction
    species, linear.py:3517); where lin holds Boltzmann tables of it they
    are interpolated on ``device``."""
    n = gridsize
    norm = math.sqrt(n**3 / boxsize**3)
    bs_fac = float(lin.bg.growth_np("D1", a)) if backscale else 1.0
    a_amp = 1.0 if backscale else a
    on_device = _tabulated(lin, species)
    R = generate_primordial_noise(n, seed, fixed_amplitude, phase_shift, dtype,
                                  scheme, device)
    if nongaussianity == 0.0:
        return R * _by_k2(lambda k: lin.delta_amplitude(k, a_amp, species) * bs_fac * norm,
                          n, boxsize, dtype, device, on_device)
    zeta_k = R * _by_k2(lambda k: lin.primordial.zeta_amplitude(k) * norm,
                        n, boxsize, dtype, device)
    zeta_x = irfft3(zeta_k, n)
    zeta_k = zeta_k + rfft3((3.0 / 5.0) * nongaussianity
                            * (zeta_x**2 - (zeta_x**2).mean()))
    return zeta_k * _by_k2(lambda k: lin.transfer_delta(k, a_amp, species) * bs_fac,
                           n, boxsize, dtype, device, on_device)


def realize_sigma_grids(lin, gridsize: int, boxsize: float, a: float, rho_plus_P: float,
                        seed: int = 0, dtype=torch.float32, device="cpu",
                        species: str = "nu"):
    """The shear ςⁱⱼ = (ϱ̄ + c⁻²𝒫̄)·σⁱⱼ from the linear σ transfer function
    (reference ic.py:670 rank-2 kernel K(k⃗) = (3/2)(δⁱⱼ/3 − kⁱkⱼ/k²),
    ic.py:466 ς scaling), on the 'simple' noise of
    :func:`realize_delta_slab` (the same seed shares the phases of the
    component's δ and J).  ``rho_plus_P`` is the ϱ̄(1 + w) prefactor.
    Returns the packed (6, n, n, n) components (xx, xy, xz, yy, yz, zz),
    or None where lin has no σ table of the species (the analytic EH
    layer)."""
    if lin.transfer_sigma(torch.ones(1, dtype=dtype, device=device), a, species) is None:
        return None
    n = gridsize
    norm = math.sqrt(n**3 / boxsize**3)
    R = generate_primordial_noise(n, seed, False, 0.0, dtype, "simple", device)
    base_k = R * _by_k2(lambda k: lin.transfer_sigma(k, a, species)
                        * lin.primordial.zeta_amplitude(k) * norm,
                        n, boxsize, dtype, device, on_device=True)
    kfac = 2 * math.pi / boxsize
    kvecs = [k.to(dtype) * kfac for k in fourier.k_int_vectors(n, device)]
    k2 = fourier.k2_int_grid(n, device).to(dtype) * kfac**2
    inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
    grids = []
    for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
        Kij = 1.5 * ((1.0 if i == j else 0.0) / 3.0 - kvecs[i] * kvecs[j] * inv_k2)
        grids.append(irfft3(Kij * base_k, n))
    return rho_plus_P * torch.stack(grids).to(dtype)


def displacement_from_delta(delta_slab, gridsize: int, boxsize: float):
    """ψ_d(x) grids (3, n, n, n) from δ(k): ψ(k) = i k_d/k² δ(k)."""
    return torch.stack([irfft3(_grad_inv_laplacian(delta_slab, gridsize, boxsize, d),
                               gridsize) for d in range(3)])


def dealias_gridsize(n: int) -> int:
    """The Orszag 3/2-rule padded grid size, even (reference
    ic.py:1322-1323)."""
    m = (n * 3) // 2
    return m + (m & 1)


def _hessian_real(psi_k, gridsize: int, boxsize: float, m: int | None = None):
    """The 6 distinct ∂ᵢψⱼ real grids of the Fourier components psi_k
    (ψ = ∇Φ, so ∂ᵢψⱼ = Φ,ᵢⱼ), on an m-grid zero-padded in Fourier space
    for dealiased products.  Keys (i, j), i ≤ j."""
    n = gridsize
    m = m or n
    out = {}
    for i in range(3):
        for j in range(i, 3):
            dk = fourier.fourier_diff(psi_k[i], n, boxsize, j)
            if m != n:
                dk = fourier.copy_modes(dk, n, m)
            out[(i, j)] = irfft3(dk, m)
    return out


def _truncate_product(S_m, n: int, m: int):
    """A real m-grid product → the n-grid field (aliased modes dropped)."""
    if m == n:
        return S_m
    return irfft3(fourier.copy_modes(rfft3(S_m), m, n), n)


def lpt2_source(psi_k, gridsize: int, boxsize: float, dealias: bool = False):
    """The 2LPT source S(x) = Σ_{i<j}(ψᵢ,ᵢψⱼ,ⱼ − ψᵢ,ⱼ²) of the Fourier ψ¹
    components (reference ic.py:1546-1718), the products on the 3/2-padded
    grid with ``dealias`` (ic.py:1316-1325)."""
    n = gridsize
    m = dealias_gridsize(n) if dealias else n
    d = _hessian_real(psi_k, n, boxsize, m)
    S = (d[(0, 0)] * d[(1, 1)] + d[(0, 0)] * d[(2, 2)] + d[(1, 1)] * d[(2, 2)]
         - d[(0, 1)] ** 2 - d[(0, 2)] ** 2 - d[(1, 2)] ** 2)
    return _truncate_product(S, n, m)


def _grad_inv_laplacian(src_k, gridsize: int, boxsize: float, d: int):
    """i·k_d/k² · src(k) (0 at k = 0)."""
    n = gridsize
    kfac = 2 * math.pi / boxsize
    dtype = src_k.real.dtype
    k2 = fourier.k2_int_grid(n, src_k.device).to(dtype) * kfac**2
    inv_k2 = torch.where(k2 > 0, 1.0 / k2, 0.0)
    kd = fourier.k_int_vectors(n, src_k.device)[d].to(dtype) * kfac
    return (1j * kd) * inv_k2 * src_k


def lpt3_sources(psi_k, S2_k, fac2: float, gridsize: int, boxsize: float,
                 dealias: bool = False):
    """The 3LPT sources from ψ¹(k) and the 2LPT source S₂(k): (S3a(x),
    S3b(x), [the transverse term's A3c sources, i = 0, 1, 2]) with the
    reference's term lists (ic.py:1630-1645 '3a', 1708-1741 '3b',
    1799-1830 '3c'), Φ² the full 2LPT potential at the realization epoch
    (fac2·∇⁻²S₂), so that the growth ratios outside are D3a/D1³ and
    D3b/(D1·D2), D3c/(D1·D2)."""
    n = gridsize
    m = dealias_gridsize(n) if dealias else n
    psi2_k = [_grad_inv_laplacian(fac2 * S2_k, n, boxsize, d) for d in range(3)]
    d1 = _hessian_real(psi_k, n, boxsize, m)
    d2 = _hessian_real(psi2_k, n, boxsize, m)
    del psi2_k

    def g(d, i, j):
        return d[(min(i, j), max(i, j))]

    S3a = (g(d1, 2, 0) ** 2 * g(d1, 1, 1)
           - g(d1, 1, 1) * g(d1, 2, 2) * g(d1, 0, 0)
           + g(d1, 0, 0) * g(d1, 1, 2) ** 2
           - 2 * g(d1, 1, 2) * g(d1, 2, 0) * g(d1, 0, 1)
           + g(d1, 0, 1) ** 2 * g(d1, 2, 2))
    S3b = (-0.5 * (g(d1, 2, 2) * g(d2, 0, 0) + g(d2, 0, 0) * g(d1, 1, 1)
                   + g(d1, 1, 1) * g(d2, 2, 2) + g(d2, 2, 2) * g(d1, 0, 0)
                   + g(d1, 0, 0) * g(d2, 1, 1) + g(d2, 1, 1) * g(d1, 2, 2))
           + g(d2, 2, 0) * g(d1, 2, 0) + g(d2, 0, 1) * g(d1, 0, 1)
           + g(d2, 1, 2) * g(d1, 1, 2))
    A3c = []
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        A3c.append(g(d2, j, j) * g(d1, j, k) - g(d1, j, k) * g(d2, k, k)
                   - g(d1, i, j) * g(d2, i, k) - g(d1, j, j) * g(d2, j, k)
                   + g(d2, j, k) * g(d1, k, k) + g(d2, i, j) * g(d1, i, k))
    return (_truncate_product(S3a, n, m), _truncate_product(S3b, n, m),
            [_truncate_product(A, n, m) for A in A3c])


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
                      delta_k=None, lattice: str | None = None,
                      species: str = "matter") -> ParticleState:
    """LPT particle ICs of order ``lpt_order`` (1-3) at scale factor a on
    the sc, bcc or fcc lattice (``lattice`` None: the one N implies),
    reference ic.py:1199-2058.  ``delta_k`` overrides the realized
    density; the other options, ``species`` among them, go to
    :func:`realize_delta_slab`; with ``dealias`` the LPT products are
    3/2-padded."""
    if lattice is None:
        lattice = preic_lattice_of(spec.N)
    per_site = {"sc": 1, "bcc": 2, "fcc": 4}[lattice]
    n = round((spec.N // per_site) ** (1 / 3))
    if per_site * n**3 != spec.N:
        raise ValueError(f"N = {spec.N} is not a {lattice} lattice count "
                         f"(needs {per_site}·n³)")
    if not 1 <= lpt_order <= 3:
        raise NotImplementedError(f"LPT order {lpt_order} (the reference's are 1-3)")
    bg = lin.bg
    H = float(bg.hubble_np(a))
    if delta_k is None:
        delta_k = realize_delta_slab(lin, n, boxsize, a, seed, fixed_amplitude,
                                     phase_shift, dtype, device, nongaussianity,
                                     scheme, backscale, species)
    psi_k = [_grad_inv_laplacian(delta_k, n, boxsize, d) for d in range(3)]
    psi = torch.stack([irfft3(pk, n) for pk in psi_k])
    vel = (H * float(bg.growth_np("f1", a))) * psi
    if lpt_order >= 2:
        D1, D2 = float(bg.growth_np("D1", a)), float(bg.growth_np("D2", a))
        S_k = rfft3(lpt2_source(psi_k, n, boxsize, dealias))
        # Ψ²(k) = +(D2/D1²)·ik/k²·S(k) with D2 = +3/7 a² in EdS (the
        # reference's growth convention), i.e. the standard
        # Ψ² = −(3/7)D1²∇φ⁽²⁾, ∇²φ⁽²⁾ = S
        fac2 = D2 / (D1 * D1)
        f2 = float(bg.growth_np("f2", a))
        for d in range(3):
            psi2 = irfft3(_grad_inv_laplacian(fac2 * S_k, n, boxsize, d), n)
            psi[d] += psi2
            vel[d] += (H * f2) * psi2
    if lpt_order >= 3:
        gr = {k: float(bg.growth_np(k, a))
              for k in ("D3a", "D3b", "D3c", "f3a", "f3b", "f3c")}
        S3a, S3b, A3c = lpt3_sources(psi_k, S_k, fac2, n, boxsize, dealias)
        S3a_k = (gr["D3a"] / D1**3) * rfft3(S3a)
        S3b_k = (gr["D3b"] / (D1 * D2)) * rfft3(S3b)
        del S3a, S3b
        for d in range(3):
            p3a = irfft3(_grad_inv_laplacian(S3a_k, n, boxsize, d), n)
            p3b = irfft3(_grad_inv_laplacian(S3b_k, n, boxsize, d), n)
            psi[d] += p3a + p3b
            vel[d] += H * (gr["f3a"] * p3a + gr["f3b"] * p3b)
        # transverse: Ψ³ᶜ = ∇×A, ∇²Aᵢ = the A3c sources; Ψ³ᶜⱼ = ±∂ₖAᵢ with
        # + iff k == (j+1) mod 3 (reference ic.py:1844)
        kfac = 2 * math.pi / boxsize
        k2 = fourier.k2_int_grid(n, delta_k.device).to(dtype) * kfac**2
        inv_k2 = torch.where(k2 > 0, 1.0 / k2, 0.0)
        for i in range(3):
            A_k = inv_k2 * ((gr["D3c"] / (D1 * D2)) * rfft3(A3c[i]))
            for j in range(3):
                if j == i:
                    continue
                k_ax = 3 - i - j
                sign = 1.0 if k_ax == (j + 1) % 3 else -1.0
                p3c = sign * irfft3(fourier.fourier_diff(A_k, n, boxsize, k_ax), n)
                psi[j] += p3c
                vel[j] += (H * gr["f3c"]) * p3c
    q = lattice_positions(n, boxsize, lattice, dtype, device)
    if lattice == "sc":
        # the sc sites are the grid's cell centres
        disp, vel = psi.reshape(3, -1).T, vel.reshape(3, -1).T
    else:
        # the shifted lattice copies sample ψ by CIC
        disp = torch.stack([gather(psi[d], q, boxsize, order=2) for d in range(3)], 1)
        vel = torch.stack([gather(vel[d], q, boxsize, order=2) for d in range(3)], 1)
    pos = periodic_wrap(q + disp, boxsize)
    mom = (a * a * spec.mass) * vel
    ids = torch.arange(spec.N, dtype=torch.int32, device=device) if with_ids else None
    return ParticleState(pos=pos, mom=mom.to(dtype), ids=ids)
