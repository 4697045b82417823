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

Over the ranks of a grid/fft.GridDistribution (``dist``) each rank draws
the noise of its x-rows of the lattice grid (the counters are the
elements' own, so the rows are bit for bit the whole draw's), works on
its y-slab in Fourier space and its x-slab in real space, realizes the
particles of its lattice planes (parallel/step.realize_shard hands
them to the ranks whose index shards hold their ids).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from concept_tpu_torch.components import (
    ComponentSpec, ParticleState, lattice_positions, periodic_wrap,
)
from concept_tpu_torch.grid import fourier
from concept_tpu_torch.grid.fft import exchange, irfft3, rfft3, row_starts
from concept_tpu_torch.grid.interp import gather, spline_weights

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


def _threefry_words(seed: int, n_elems: int, device="cpu", start: int = 0):
    """The two threefry2x32 output words of JAX's partitionable random
    bits of ``jax.random.key(seed)`` for the n_elems elements from
    ``start`` on (row-major), as int64 tensors in [0, 2³²): the counter
    of element i is i, its high word i >> 32."""
    key = ((seed >> 32) & _M32, seed & _M32)
    lo = torch.arange(start, start + n_elems, dtype=torch.int64, device=device)
    hi = torch.zeros_like(lo) if start + n_elems <= 1 << 32 else lo >> 32
    return threefry2x32(key, hi, lo & _M32)


def random_bits(seed: int, n_elems: int, device="cpu", start: int = 0):
    """JAX's partitionable 32-bit random bits of ``jax.random.key(seed)``
    for the n_elems elements from ``start`` on (row-major), as int64 in
    [0, 2³²)."""
    b0, b1 = _threefry_words(seed, n_elems, device, start)
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


# elements of the noise drawn at a time where a draw is split (its int64
# temporaries take ~60 bytes an element)
NOISE_CHUNK = 1 << 25


def _normal_values(seed: int, start: int, count: int, device, dtype):
    """Elements [start, start + count) of ``jax.random.normal(
    jax.random.key(seed), shape, dtype)`` (row-major), flat."""
    if dtype == torch.float64:
        # 64-bit bits (word 0 high, word 1 low), their top 52 bits → a
        # double in [1, 2) → [0, 1) → (−1, 1)
        b0, b1 = _threefry_words(seed, count, device, start)
        one = 0x3FF0000000000000
        floats = (((b0 << 20) | (b1 >> 12)) | one).view(torch.float64) - 1.0
        lo = float(np.nextafter(-1.0, 0.0))
        u = torch.clamp(floats * (1.0 - lo) + lo, min=lo)
        return math.sqrt(2.0) * torch.erfinv(u)
    bits = random_bits(seed, count, device, start)
    # top 23 bits → a float in [1, 2) → [0, 1) → (−1, 1)
    one = 0x3F800000
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.nextafter(np.float32(-1.0), np.float32(1.0)))
    width = float(np.float32(1.0) - np.float32(lo))
    u = torch.clamp(floats * width + lo, min=lo)
    return math.sqrt(2.0) * erfinv_f32(u)


def normal_noise(seed: int, n: int, device="cpu", dtype=torch.float32, rows=None):
    """``jax.random.normal(jax.random.key(seed), (n, n, n), dtype)``, or
    with ``rows`` = (x0, count) its x-rows [x0, x0 + count): (count, n,
    n), bit for bit those rows of the whole draw (the counters are the
    elements' own).  A draw of more than ``NOISE_CHUNK`` elements is made
    a chunk of x-rows at a time."""
    x0, count = (0, n) if rows is None else rows
    if count * n * n <= NOISE_CHUNK:
        return _normal_values(seed, x0 * n * n, count * n * n, device, dtype).reshape(
            count, n, n)
    out = torch.empty((count, n, n), dtype=dtype, device=device)
    step = max(1, NOISE_CHUNK // (n * n))
    for a in range(0, count, step):
        b = min(count, a + step)
        out[a:b] = _normal_values(seed, (x0 + a) * n * n, (b - a) * n * n, device,
                                  dtype).reshape(b - a, n, n)
    return out


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


def _modewise_noise(gridsize: int, seed: int, dtype=torch.float32, device="cpu",
                    y_rows=None):
    """Mode-indexed Gaussian noise over the rfft layout (port of
    ``_modewise_noise``): each mode's value is a function of (seed, ki,
    kj, kk) alone, the same at every grid size that holds the mode.
    Modes on the self-conjugate planes kk ∈ {0, n/2} take the conjugate
    of their canonical (lexicographically larger) partner; self-conjugate
    points are real with unit variance.  Normalised to ⟨|R|²⟩ = n³.
    ``y_rows`` (first, rows) builds only those kj rows (a rank's y-slab)."""
    n = gridsize
    ki, kj, kk = fourier.k_int_vectors(n, device, y_rows)
    shape = (n, kj.shape[1], n // 2 + 1)
    ki, kj, kk = (k.expand(shape) for k in (ki, kj, kk))
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
                              scheme: str = "simple", device="cpu", dist=None):
    """Unit white noise in the rfft layout with Hermitian symmetry,
    ⟨|R(k)|²⟩ = n³: 'simple' is the transform of JAX's real-space normal
    draw (:func:`normal_noise`), 'distributed' the mode hash
    (:func:`_modewise_noise`).  ``fixed_amplitude`` sets |R| = √n³ and
    keeps the phase; ``phase_shift`` is added to every phase (π for the
    partner of a pair; reference ic.py:1058-1105).  With ``dist``
    (grid/fft.GridDistribution) the rank draws its x-rows and returns
    its y-slab."""
    n = gridsize
    if scheme == "simple":
        rows = None if dist is None else dist.rows(n)
        R = rfft3(normal_noise(seed, n, device, dtype, rows), dist)
    elif scheme == "distributed":
        R = _modewise_noise(n, seed, dtype, device, None if dist is None else dist.rows(n))
    else:
        raise ValueError(f"unknown noise scheme {scheme!r}")
    if fixed_amplitude or phase_shift != 0.0:
        amp = torch.full_like(R.real, math.sqrt(n**3)) if fixed_amplitude else R.abs()
        R = amp * torch.exp(1j * (torch.angle(R) + phase_shift))
    return R


def _by_k2(fn, gridsize: int, boxsize: float, dtype, device, on_device: bool = False,
           y_rows=None):
    """fn(|k|) evaluated once per integer |k|² of the rfft layout and
    indexed onto it (onto the kj rows ``y_rows`` only, where given); 0 at
    k = 0.  fn takes the |k| values as a float64 NumPy array, or,
    ``on_device``, as a tensor of ``dtype`` on ``device`` (the Boltzmann
    tables' interpolation runs there)."""
    n = gridsize
    k2 = fourier.k2_int_grid(n, device, y_rows)
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
                       species: str = "matter", dist=None):
    """δ(k) in DFT normalisation at scale factor a (reference ic.py:542
    get_amplitudes + ic.py:670 realize_grid).  ``nongaussianity`` f_NL
    adds the local-type term ζ → ζ + (3/5)f_NL(ζ² − ⟨ζ²⟩) to the
    primordial field; ``backscale`` realizes the a = 1 spectrum scaled
    back by D1(a) (the classic N-body convention).  ``species`` selects
    the transfer function (matter / cb / nu — reference TransferFunction
    species, linear.py:3517); where lin holds Boltzmann tables of it they
    are interpolated on ``device``.  With ``dist`` the rank's y-slab."""
    n = gridsize
    norm = math.sqrt(n**3 / boxsize**3)
    bs_fac = float(lin.bg.growth_np("D1", a)) if backscale else 1.0
    a_amp = 1.0 if backscale else a
    on_device = _tabulated(lin, species)
    y_rows = None if dist is None else dist.rows(n)
    R = generate_primordial_noise(n, seed, fixed_amplitude, phase_shift, dtype,
                                  scheme, device, dist)
    if nongaussianity == 0.0:
        return R * _by_k2(lambda k: lin.delta_amplitude(k, a_amp, species) * bs_fac * norm,
                          n, boxsize, dtype, device, on_device, y_rows)
    zeta_k = R * _by_k2(lambda k: lin.primordial.zeta_amplitude(k) * norm,
                        n, boxsize, dtype, device, y_rows=y_rows)
    del R
    zeta_x = irfft3(zeta_k, n, dist)
    if dist is None:
        mean = (zeta_x**2).mean()
    else:
        # ⟨ζ²⟩ of the whole grid: the ranks' sums over n³
        mean = (zeta_x**2).sum()
        torch.distributed.all_reduce(mean, group=dist.group)
        mean = mean / n**3
    zeta_k = zeta_k + rfft3((3.0 / 5.0) * nongaussianity * (zeta_x**2 - mean), dist)
    del zeta_x
    return zeta_k * _by_k2(lambda k: lin.transfer_delta(k, a_amp, species) * bs_fac,
                           n, boxsize, dtype, device, on_device, y_rows)


def realize_sigma_grids(lin, gridsize: int, boxsize: float, a: float, rho_plus_P: float,
                        seed: int = 0, dtype=torch.float32, device="cpu",
                        species: str = "nu", dist=None):
    """The shear ςⁱⱼ = (ϱ̄ + c⁻²𝒫̄)·σⁱⱼ from the linear σ transfer function
    (reference ic.py:670 rank-2 kernel K(k⃗) = (3/2)(δⁱⱼ/3 − kⁱkⱼ/k²),
    ic.py:466 ς scaling), on the 'simple' noise of
    :func:`realize_delta_slab` (the same seed shares the phases of the
    component's δ and J).  ``rho_plus_P`` is the ϱ̄(1 + w) prefactor.
    Returns the packed (6, n, n, n) components (xx, xy, xz, yy, yz, zz),
    or None where lin has no σ table of the species (the analytic EH
    layer).  With ``dist`` the rank draws the noise of its x-rows, forms
    the kernels on its y-slab and returns its x-rows (6, rows, n, n), as
    :func:`realize_delta_slab` does."""
    if lin.transfer_sigma(torch.ones(1, dtype=dtype, device=device), a, species) is None:
        return None
    n = gridsize
    norm = math.sqrt(n**3 / boxsize**3)
    y_rows = _y_rows(n, dist)
    R = generate_primordial_noise(n, seed, False, 0.0, dtype, "simple", device, dist)
    base_k = R * _by_k2(lambda k: lin.transfer_sigma(k, a, species)
                        * lin.primordial.zeta_amplitude(k) * norm,
                        n, boxsize, dtype, device, on_device=True, y_rows=y_rows)
    kfac = 2 * math.pi / boxsize
    kvecs = [k.to(dtype) * kfac for k in fourier.k_int_vectors(n, device, y_rows)]
    k2 = fourier.k2_int_grid(n, device, y_rows).to(dtype) * kfac**2
    inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
    grids = []
    for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
        Kij = 1.5 * ((1.0 if i == j else 0.0) / 3.0 - kvecs[i] * kvecs[j] * inv_k2)
        grids.append(irfft3(Kij * base_k, n, dist))
    return rho_plus_P * torch.stack(grids).to(dtype)


def _y_rows(n: int, dist):
    """The kj rows (first, rows) of this rank's y-slab of an n-grid, or
    None on one device."""
    return None if dist is None else dist.rows(n)


def displacement_from_delta(delta_slab, gridsize: int, boxsize: float, dist=None):
    """ψ_d(x) grids (3, n, n, n) from δ(k): ψ(k) = i k_d/k² δ(k) (with
    ``dist`` the rank's x-slabs of them from its y-slab of δ)."""
    y_rows = _y_rows(gridsize, dist)
    return torch.stack([irfft3(_grad_inv_laplacian(delta_slab, gridsize, boxsize, d, y_rows),
                               gridsize, dist) for d in range(3)])


def dealias_gridsize(n: int) -> int:
    """The Orszag 3/2-rule padded grid size, even (reference
    ic.py:1322-1323)."""
    m = (n * 3) // 2
    return m + (m & 1)


def _hessian_one(psi_k, i: int, j: int, n: int, boxsize: float, m: int, dist=None):
    """∂ⱼψᵢ as a real m-grid (zero-padded in Fourier space where m > n)."""
    dk = fourier.fourier_diff(psi_k[i], n, boxsize, j, _y_rows(n, dist))
    if m != n:
        dk = fourier.copy_modes(dk, n, m, dist=dist)
    return irfft3(dk, m, dist)


def _hessian_real(psi_k, gridsize: int, boxsize: float, m: int | None = None, dist=None):
    """The 6 distinct ∂ᵢψⱼ real grids of the Fourier components psi_k
    (ψ = ∇Φ, so ∂ᵢψⱼ = Φ,ᵢⱼ), on an m-grid zero-padded in Fourier space
    for dealiased products.  Keys (i, j), i ≤ j."""
    n = gridsize
    m = m or n
    return {(i, j): _hessian_one(psi_k, i, j, n, boxsize, m, dist)
            for i in range(3) for j in range(i, 3)}


def _truncate_product(S_m, n: int, m: int, dist=None):
    """A real m-grid product → the n-grid field (aliased modes dropped)."""
    if m == n:
        return S_m
    return irfft3(fourier.copy_modes(rfft3(S_m, dist), m, n, dist=dist), n, dist)


def lpt2_source(psi_k, gridsize: int, boxsize: float, dealias: bool = False, dist=None):
    """The 2LPT source S(x) = Σ_{i<j}(ψᵢ,ᵢψⱼ,ⱼ − ψᵢ,ⱼ²) of the Fourier ψ¹
    components (reference ic.py:1546-1718), the products on the 3/2-padded
    grid with ``dealias`` (ic.py:1316-1325).  The Hessian grids are made
    as the sum needs them (at most four at a time), the sum in the order
    of the expression above."""
    n = gridsize
    m = dealias_gridsize(n) if dealias else n

    def hess(i, j):
        return _hessian_one(psi_k, i, j, n, boxsize, m, dist)

    d00, d11 = hess(0, 0), hess(1, 1)
    S = d00 * d11
    d22 = hess(2, 2)
    S.add_(d00 * d22)
    del d00
    S.add_(d11 * d22)
    del d11, d22
    for i, j in ((0, 1), (0, 2), (1, 2)):
        S.sub_(hess(i, j) ** 2)
    return _truncate_product(S, n, m, dist)


def _grad_inv_laplacian(src_k, gridsize: int, boxsize: float, d: int, y_rows=None):
    """i·k_d/k² · src(k) (0 at k = 0), on the kj rows ``y_rows``."""
    n = gridsize
    kfac = 2 * math.pi / boxsize
    dtype = src_k.real.dtype
    k2 = fourier.k2_int_grid(n, src_k.device, y_rows).to(dtype) * kfac**2
    inv_k2 = torch.where(k2 > 0, 1.0 / k2, 0.0)
    kd = fourier.k_int_vectors(n, src_k.device, y_rows)[d].to(dtype) * kfac
    return (1j * kd) * inv_k2 * src_k


def lpt3_sources(psi_k, S2_k, fac2: float, gridsize: int, boxsize: float,
                 dealias: bool = False, dist=None):
    """The 3LPT sources from ψ¹(k) and the 2LPT source S₂(k): (S3a(x),
    S3b(x), [the transverse term's A3c sources, i = 0, 1, 2]) with the
    reference's term lists (ic.py:1630-1645 '3a', 1708-1741 '3b',
    1799-1830 '3c'), Φ² the full 2LPT potential at the realization epoch
    (fac2·∇⁻²S₂), so that the growth ratios outside are D3a/D1³ and
    D3b/(D1·D2), D3c/(D1·D2).  Each source is summed term by term in the
    order of its expression and truncated to the n-grid at once.  The six
    Hessian grids of ψ¹ are held throughout; each of ψ²'s is made where a
    run of terms needs it and freed after (21 made for 6), so that at
    most eight m-grids and a term's products are live, not twelve."""
    n = gridsize
    m = dealias_gridsize(n) if dealias else n
    y_rows = _y_rows(n, dist)
    psi2_k = [_grad_inv_laplacian(fac2 * S2_k, n, boxsize, d, y_rows) for d in range(3)]
    d1 = _hessian_real(psi_k, n, boxsize, m, dist)
    held = {}

    def h1(i, j):
        return d1[(min(i, j), max(i, j))]

    def h2(i, j):
        key = (min(i, j), max(i, j))
        if key not in held:
            held.clear()
            held[key] = _hessian_one(psi2_k, *key, n, boxsize, m, dist)
        return held[key]

    def summed(terms):
        # ((t0 ± t1) ± t2) …, the expression's own order of operations
        S = terms[0][1]()
        for sign, term in terms[1:]:
            (S.add_ if sign > 0 else S.sub_)(term())
        return S

    S3a = _truncate_product(summed([
        (1, lambda: h1(2, 0) ** 2 * h1(1, 1)),
        (-1, lambda: h1(1, 1) * h1(2, 2) * h1(0, 0)),
        (1, lambda: h1(0, 0) * h1(1, 2) ** 2),
        (-1, lambda: 2 * h1(1, 2) * h1(2, 0) * h1(0, 1)),
        (1, lambda: h1(0, 1) ** 2 * h1(2, 2))]), n, m, dist)
    S = summed([
        (1, lambda: h1(2, 2) * h2(0, 0)), (1, lambda: h2(0, 0) * h1(1, 1)),
        (1, lambda: h1(1, 1) * h2(2, 2)), (1, lambda: h2(2, 2) * h1(0, 0)),
        (1, lambda: h1(0, 0) * h2(1, 1)), (1, lambda: h2(1, 1) * h1(2, 2))])
    S.mul_(-0.5)
    for i, j in ((2, 0), (0, 1), (1, 2)):
        S.add_(h2(i, j) * h1(i, j))
    S3b = _truncate_product(S, n, m, dist)
    del S
    A3c = []
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        A3c.append(_truncate_product(summed([
            (1, lambda: h2(j, j) * h1(j, k)), (-1, lambda: h1(j, k) * h2(k, k)),
            (-1, lambda: h1(i, j) * h2(i, k)), (-1, lambda: h1(j, j) * h2(j, k)),
            (1, lambda: h2(j, k) * h1(k, k)), (1, lambda: h2(i, j) * h1(i, k))]), n, m, dist))
    return S3a, S3b, A3c


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
                      species: str = "matter", dist=None) -> ParticleState:
    """LPT particle ICs of order ``lpt_order`` (1-3) at scale factor a on
    the sc, bcc or fcc lattice (``lattice`` None: the one N implies),
    reference ic.py:1199-2058.  ``delta_k`` overrides the realized
    density; the other options, ``species`` among them, go to
    :func:`realize_delta_slab`; with ``dealias`` the LPT products are
    3/2-padded.

    With ``dist`` (grid/fft.GridDistribution) the rank realizes its part
    on the slab FFT: the noise of its x-rows of the lattice grid (split
    by ``dist.rows``, which need not be even), every Fourier product on
    its y-slab, every ψ grid's x-slab, and the particles of its lattice
    planes x ∈ [x0, x0 + rows) of every lattice copy, with their ids
    (copy·n³ + (x·n + y)·n + z, the one-device ids) whatever
    ``with_ids`` says.  ``delta_k`` is then the rank's y-slab.
    parallel/step.realize_shard hands them to the steppers' index
    shards."""
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
    y_rows = _y_rows(n, dist)
    if delta_k is None:
        delta_k = realize_delta_slab(lin, n, boxsize, a, seed, fixed_amplitude,
                                     phase_shift, dtype, device, nongaussianity,
                                     scheme, backscale, species, dist)
    k_device = delta_k.device
    psi_k = [_grad_inv_laplacian(delta_k, n, boxsize, d, y_rows) for d in range(3)]
    del delta_k
    psi = torch.stack([irfft3(pk, n, dist) for pk in psi_k])
    vel = (H * float(bg.growth_np("f1", a))) * psi
    if lpt_order >= 2:
        D1, D2 = float(bg.growth_np("D1", a)), float(bg.growth_np("D2", a))
        S_k = rfft3(lpt2_source(psi_k, n, boxsize, dealias, dist), dist)
        if lpt_order < 3:
            del psi_k
        # Ψ²(k) = +(D2/D1²)·ik/k²·S(k) with D2 = +3/7 a² in EdS (the
        # reference's growth convention), i.e. the standard
        # Ψ² = −(3/7)D1²∇φ⁽²⁾, ∇²φ⁽²⁾ = S
        fac2 = D2 / (D1 * D1)
        f2 = float(bg.growth_np("f2", a))
        for d in range(3):
            psi2 = irfft3(_grad_inv_laplacian(fac2 * S_k, n, boxsize, d, y_rows), n, dist)
            psi[d] += psi2
            vel[d] += (H * f2) * psi2
        del psi2
    if lpt_order >= 3:
        gr = {k: float(bg.growth_np(k, a))
              for k in ("D3a", "D3b", "D3c", "f3a", "f3b", "f3c")}
        S3a, S3b, A3c = lpt3_sources(psi_k, S_k, fac2, n, boxsize, dealias, dist)
        del psi_k, S_k
        S3a_k = (gr["D3a"] / D1**3) * rfft3(S3a, dist)
        S3b_k = (gr["D3b"] / (D1 * D2)) * rfft3(S3b, dist)
        del S3a, S3b
        for d in range(3):
            p3a = irfft3(_grad_inv_laplacian(S3a_k, n, boxsize, d, y_rows), n, dist)
            p3b = irfft3(_grad_inv_laplacian(S3b_k, n, boxsize, d, y_rows), n, dist)
            psi[d] += p3a + p3b
            vel[d] += H * (gr["f3a"] * p3a + gr["f3b"] * p3b)
        del S3a_k, S3b_k, p3a, p3b
        # transverse: Ψ³ᶜ = ∇×A, ∇²Aᵢ = the A3c sources; Ψ³ᶜⱼ = ±∂ₖAᵢ with
        # + iff k == (j+1) mod 3 (reference ic.py:1844)
        kfac = 2 * math.pi / boxsize
        k2 = fourier.k2_int_grid(n, k_device, y_rows).to(dtype) * kfac**2
        inv_k2 = torch.where(k2 > 0, 1.0 / k2, 0.0)
        for i in range(3):
            A_k = inv_k2 * ((gr["D3c"] / (D1 * D2)) * rfft3(A3c[i], dist))
            A3c[i] = None
            for j in range(3):
                if j == i:
                    continue
                k_ax = 3 - i - j
                sign = 1.0 if k_ax == (j + 1) % 3 else -1.0
                p3c = sign * irfft3(fourier.fourier_diff(A_k, n, boxsize, k_ax, y_rows), n,
                                    dist)
                psi[j] += p3c
                vel[j] += (H * gr["f3c"]) * p3c
    # this rank's lattice planes (all n on one device)
    planes = (0, n) if dist is None else dist.rows(n)
    q = lattice_positions(n, boxsize, lattice, dtype, device, rows=planes)
    if lattice == "sc":
        # the sc sites are the grid's cell centres
        disp, vel = psi.reshape(3, -1).T, vel.reshape(3, -1).T
    elif dist is None:
        # the shifted lattice copies sample ψ by CIC
        disp = torch.stack([gather(psi[d], q, boxsize, order=2) for d in range(3)], 1)
        vel = torch.stack([gather(vel[d], q, boxsize, order=2) for d in range(3)], 1)
    else:
        # their clouds reach the rows before and after the rank's: the
        # ranks that hold them (periodic) send them
        disp = _gather_planes(psi, _halo_rows(psi, n, dist), q, boxsize, planes[0])
        vel = _gather_planes(vel, _halo_rows(vel, n, dist), q, boxsize, planes[0])
    del psi
    ids = None
    if with_ids or dist is not None:
        ids = lattice_ids(n, lattice, planes, device)
    pos = periodic_wrap(q + disp, boxsize)
    mom = (a * a * spec.mass) * vel
    return ParticleState(pos=pos, mom=mom.to(dtype), ids=ids)


def lattice_ids(n: int, lattice: str, rows, device="cpu"):
    """The ids (int32, as the one-device realization's) of the particles
    of lattice planes [x0, x0 + rows) in :func:`components.
    lattice_positions`' order: copy·n³ + (x·n + y)·n + z."""
    x0, count = rows
    plane = torch.arange(x0 * n * n, (x0 + count) * n * n, dtype=torch.int32, device=device)
    per_site = {"sc": 1, "bcc": 2, "fcc": 4}[lattice]
    return torch.cat([plane + c * n**3 for c in range(per_site)]) if per_site > 1 else plane


def _halo_rows(grids, n: int, dist):
    """Grids (G, rows, n, n), this rank's x-rows [x0, x0 + rows) of an
    n-grid → (row x0 − 1, row x0 + rows), both mod n, each (G, n, n),
    which the ranks that hold them send (None, None where this rank holds
    no row).  Every rank with rows needs both; a rank may hold none."""
    starts = row_starts(n, dist.n_devices)
    x0, rows = dist.rows(n)
    # (destination, local row, 0 for the row before its planes, 1 after)
    sends = [(q, (want - x0) % n, side) for q in range(dist.n_devices)
             if starts[q + 1] > starts[q]
             for side, want in ((0, (starts[q] - 1) % n), (1, starts[q + 1] % n))
             if (want - x0) % n < rows]
    data = (torch.stack([grids[:, i] for _, i, _ in sends]) if sends
            else grids.new_empty((0, grids.shape[0], n, n)))
    dest = torch.tensor([q for q, _, _ in sends], dtype=torch.int64, device=grids.device)
    side = torch.tensor([t for _, _, t in sends], dtype=torch.int64, device=grids.device)
    got, got_side = exchange([data, side], dest, dist)
    if not rows:
        return None, None
    return got[got_side == 0][0], got[got_side == 1][0]


def _gather_planes(slabs, halo, pos, boxsize: float, x0: int):
    """The CIC interpolation of n-grids at pos (M, 3), whose clouds lie in
    their x-rows [x0 − 1, x0 + rows] (mod n), from this rank's rows (D,
    rows, n, n) and the rows before and after them (:func:`_halo_rows`;
    None where the rank holds no row, and then no particle): (M, D), bit
    for bit grid/interp.gather of each whole grid (the same corners,
    weights and sum).  A site on a plane's centre may round to just below
    it in float32, and then its cloud reaches the row before with a
    weight of a few float32 steps."""
    D, rows, n = slabs.shape[0], slabs.shape[1], slabs.shape[2]
    out = torch.zeros((D, pos.shape[0]), dtype=slabs.dtype, device=slabs.device)
    if not pos.shape[0]:
        return out.T
    before, after = halo
    u = pos / (boxsize / n) - 0.5
    lows, weights = zip(*(spline_weights(u[:, k], 2) for k in range(3)))
    for a, wx in enumerate(weights[0]):
        ia = torch.remainder(torch.remainder(lows[0] + a, n) - x0, n)
        own, is_after = ia < rows, ia == rows
        ia = torch.clamp(ia, max=rows - 1) * (n * n)
        for b, wy in enumerate(weights[1]):
            ib = torch.remainder(lows[1] + b, n) * n
            wxy = wx * wy
            for c, wz in enumerate(weights[2]):
                iyz = ib + torch.remainder(lows[2] + c, n)
                w = wxy * wz
                for d in range(D):
                    halo_v = torch.where(is_after, after[d].reshape(-1)[iyz],
                                         before[d].reshape(-1)[iyz])
                    v = torch.where(own, slabs[d].reshape(-1)[ia + iyz], halo_v)
                    out[d] += v * w
    return out.T
