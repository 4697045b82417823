"""The port's initial conditions (concept_tpu_torch.ic) vs the JAX
package's: the 'simple' primordial noise (threefry2x32 bits, uniform →
normal map) and the 1LPT particle realization.

Tolerances: the random bits are equal; the normal noise agrees to 1e-6
relative (XLA's float32 erfinv polynomial is reproduced, so only the last
ulp differs); positions and momenta agree to 1e-5 of the box and of the
largest momentum (float32 FFTs in another order)."""

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


def test_realize_particles_matches_jax():
    h = 0.67
    H0 = 100 * h * units.km / (units.s * units.Mpc)
    box = 64 * units.Mpc / h
    N = 16**3
    prim = dict(A_s=2.1e-9, n_s=0.96, pivot=0.05 / units.Mpc)
    args = (0.049, 0.27, constants.light_speed, units.Mpc)
    lin = LinearCosmology(Background(H0=H0, Omega_m=0.319),
                          PrimordialSpectrum(**prim), *args)
    lin_j = JaxLinear(JaxBackground(H0=H0, Omega_m=0.319), JaxPrim(**prim),
                      *args)
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        realize_particles(lin, ComponentSpec("matter", "matter", N=N, mass=mass),
                          box, 0.02, lpt_order=2)
