"""The port's initial conditions (concept_tpu_torch.ic) vs the JAX
package's: the 'simple' primordial noise (threefry2x32 bits, uniform →
normal map) and the 1LPT particle realization.

Tolerances: the random bits are equal; the normal noise agrees to 1e-6
relative (XLA's float32 erfinv polynomial is reproduced, so only the last
ulp differs); positions and momenta agree to 1e-5 of the box and of the
largest momentum (float32 FFTs in another order)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from concept_tpu.components import ComponentSpec as JaxSpec  # noqa: E402
from concept_tpu.cosmology.background import Background as JaxBackground  # noqa: E402
from concept_tpu.cosmology.linear import LinearCosmology as JaxLinear  # noqa: E402
from concept_tpu.cosmology.primordial import PrimordialSpectrum as JaxPrim  # noqa: E402
from concept_tpu.ic import realize_particles as jax_realize  # noqa: E402
from concept_tpu_torch.components import ComponentSpec  # noqa: E402
from concept_tpu_torch.cosmology.background import Background  # noqa: E402
from concept_tpu_torch.cosmology.linear import LinearCosmology  # noqa: E402
from concept_tpu_torch.cosmology.primordial import PrimordialSpectrum  # noqa: E402
from concept_tpu_torch.ic import normal_noise, random_bits, realize_particles  # noqa: E402
from concept_tpu_torch.units import constants, units  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 123456789])
def test_random_bits_equal_jax(seed):
    n = 12
    got = random_bits(seed, n**3).numpy().astype(np.uint32)
    ref = np.asarray(jax.random.bits(jax.random.key(seed), (n, n, n),
                                     jnp.uint32)).reshape(-1)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 7])
def test_normal_noise_matches_jax(seed):
    n = 16
    got = normal_noise(seed, n).numpy()
    ref = np.asarray(jax.random.normal(jax.random.key(seed), (n, n, n),
                                       jnp.float32))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@functools.lru_cache(maxsize=1)
def _cosmologies():
    """The port's and the JAX package's linear cosmology, built once for
    the module (their growth and transfer tables take ~0.5 s a pair)."""
    h = 0.67
    H0 = 100 * h * units.km / (units.s * units.Mpc)
    prim = dict(A_s=2.1e-9, n_s=0.96, pivot=0.05 / units.Mpc)
    args = (0.049, 0.27, constants.light_speed, units.Mpc)
    return (LinearCosmology(Background(H0=H0, Omega_m=0.319), PrimordialSpectrum(**prim),
                            *args),
            JaxLinear(JaxBackground(H0=H0, Omega_m=0.319), JaxPrim(**prim), *args))


def test_realize_particles_matches_jax():
    box = 64 * units.Mpc / 0.67
    N = 16**3
    lin, lin_j = _cosmologies()
    mass = 1.0e10 * units.m_sun
    got = realize_particles(lin, ComponentSpec("matter", "matter", N=N, mass=mass),
                            box, 0.02, seed=3, with_ids=True)
    ref = jax_realize(lin_j, JaxSpec("matter", "matter", N=N, mass=mass), box,
                      0.02, seed=3, with_ids=True)
    pos, pos_j = got.pos.numpy(), np.asarray(ref.pos)
    dx = pos - pos_j
    dx -= box * np.round(dx / box)
    assert np.abs(dx).max() <= 1e-5 * box
    mom_j = np.asarray(ref.mom)
    assert np.abs(got.mom.numpy() - mom_j).max() <= 1e-5 * np.abs(mom_j).max()
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    with pytest.raises(NotImplementedError, match="LPT order 4"):
        realize_particles(lin, ComponentSpec("matter", "matter", N=N, mass=mass),
                          box, 0.02, lpt_order=4)


# (N, options): every LPT order, both noise schemes, the three lattices
# and each realization option, a few to a case
REALIZATIONS = {
    "2lpt-distributed-dealias": (16**3, dict(lpt_order=2, scheme="distributed",
                                             dealias=True)),
    "3lpt": (16**3, dict(lpt_order=3)),
    "3lpt-dealias-fixed-paired": (12**3, dict(lpt_order=3, dealias=True,
                                              fixed_amplitude=True,
                                              phase_shift=np.pi)),
    "bcc-2lpt-nongaussian": (2 * 8**3, dict(lpt_order=2, nongaussianity=300.0)),
    "fcc-backscale": (4 * 8**3, dict(backscale=True, scheme="distributed")),
}


@pytest.mark.parametrize("case", sorted(REALIZATIONS))
def test_realization_options_match_jax(case):
    """2LPT and 3LPT (with and without the 3/2 dealiasing), the
    'distributed' noise, fixed amplitudes with a phase shift of π, local
    non-Gaussianity, backscaling and the bcc/fcc lattices against the
    JAX package's realize_particles, at the 1LPT test's tolerance: 1e-5
    of the box and of the largest momentum."""
    N, kw = REALIZATIONS[case]
    lin, lin_j = _cosmologies()
    box = 64 * units.Mpc / 0.67
    mass = 1.0e10 * units.m_sun
    got = realize_particles(lin, ComponentSpec("matter", "matter", N=N, mass=mass),
                            box, 0.05, seed=4, **kw)
    ref = jax_realize(lin_j, JaxSpec("matter", "matter", N=N, mass=mass), box,
                      0.05, seed=4, **kw)
    dx = got.pos.numpy() - np.asarray(ref.pos)
    dx -= box * np.round(dx / box)
    assert np.abs(dx).max() <= 1e-5 * box
    mom_j = np.asarray(ref.mom)
    assert np.abs(got.mom.numpy() - mom_j).max() <= 1e-5 * np.abs(mom_j).max()


@pytest.mark.parametrize("seed", [0, 77])
def test_distributed_noise_matches_jax(seed):
    """The mode hash of the 'distributed' scheme: its 32-bit arithmetic on
    int64 tensors equals numpy's uint32 arithmetic bit for bit, and the
    noise equals the JAX package's (Box-Muller in float32: within 1e-6 of
    its largest mode), at an even and an odd grid size."""
    from concept_tpu.ic import _modewise_noise as jax_modewise
    from concept_tpu_torch.ic import _mode_hash, _modewise_noise

    rng = np.random.default_rng(seed)
    k = rng.integers(-(1 << 12), 1 << 12, size=(3, 1000))
    key = (rng.integers(0, 1 << 32), rng.integers(0, 1 << 32))
    got = _mode_hash(*torch.as_tensor(k), key, 0x1234ABCD).numpy()
    u = np.uint32
    with np.errstate(over="ignore"):
        ki, kj, kk = ((k + (1 << 15)).astype(np.int64) & 0xFFFFFFFF).astype(u)
        x = ki ^ (kj << u(11)) ^ (kk << u(22)) ^ u(0x1234ABCD)
        x = x * u(0x9E3779B9) + u(key[0])
        x ^= x >> u(16)
        x = x * u(0x85EBCA6B) + u(key[1])
        x ^= x >> u(13)
        x = x * u(0xC2B2AE35)
        x ^= x >> u(16)
    np.testing.assert_array_equal(got, x.astype(np.int64))
    for n in (12, 9):
        R = _modewise_noise(n, seed).numpy()
        R_j = np.asarray(jax_modewise(n, seed))
        np.testing.assert_allclose(R, R_j, rtol=0, atol=1e-6 * np.abs(R_j).max())
