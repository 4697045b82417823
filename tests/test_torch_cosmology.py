"""The port's float64 cosmology layer (concept_tpu_torch.cosmology) vs the
JAX package's: background tables and integrals, growth factors, the
Eisenstein-Hu transfer function, the linear power spectrum, and the
backend selection of the default run.  Both are NumPy float64 code of the
same algorithm, so they agree to rtol 1e-10.  The JAX package evaluates
the Eisenstein-Hu formulas with jnp, in float32 unless 64-bit mode is on:
that test turns it on."""

import os

import jax
import numpy as np
import pytest

pytest.importorskip("torch").set_num_threads(1)  # parallel test workers share the cores

from concept_tpu.cosmology.background import Background as JaxBackground  # noqa: E402
from concept_tpu.cosmology.linear import LinearCosmology as JaxLinear  # noqa: E402
from concept_tpu.cosmology.primordial import PrimordialSpectrum as JaxPrim  # noqa: E402
from concept_tpu.cosmology.transfer import make_transfer as jax_transfer  # noqa: E402
from concept_tpu.units import constants as jax_constants  # noqa: E402
from concept_tpu.units import units as jax_units  # noqa: E402
from concept_tpu_torch.cosmology.background import Background  # noqa: E402
from concept_tpu_torch.cosmology.linear import LinearCosmology  # noqa: E402
from concept_tpu_torch.cosmology.primordial import PrimordialSpectrum  # noqa: E402
from concept_tpu_torch.cosmology.transfer import make_transfer  # noqa: E402
from concept_tpu_torch.units import constants, units  # noqa: E402

RTOL = 1e-10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    H0 = 67 * units.km / (units.s * units.Mpc)
    assert H0 == 67 * jax_units.km / (jax_units.s * jax_units.Mpc)
    return Background(H0=H0, Omega_m=0.319), JaxBackground(H0=H0, Omega_m=0.319)


def test_units_and_constants_match():
    for name in ("Mpc", "km", "s", "Gyr", "m_sun"):
        assert getattr(units, name) == getattr(jax_units, name)
    assert constants.G_Newton == jax_constants.G_Newton
    assert constants.light_speed == jax_constants.light_speed


def test_background_matches_jax(pair):
    bg, ref = pair
    a = np.geomspace(0.005, 1.0, 60)
    np.testing.assert_allclose(bg.t_of_a_np(a), ref.t_of_a_np(a), rtol=RTOL)
    t = ref.t_of_a_np(a)
    np.testing.assert_allclose(bg.a_of_t_np(t), ref.a_of_t_np(t), rtol=RTOL)
    np.testing.assert_allclose(bg.hubble_np(a), ref.hubble_np(a), rtol=RTOL)
    for g in ("D1", "f1"):
        np.testing.assert_allclose(bg.growth_np(g, a), ref.growth_np(g, a),
                                   rtol=RTOL)
    keys = ("1", "a**2", "a**(-1)", "a**(-2)", "ȧ/a")
    got = bg.integrals_np(t[5], t[40], keys=keys)
    want = ref.integrals_np(t[5], t[40], keys=keys)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    assert bg.rho_crit_of(constants.G_Newton) == pytest.approx(
        ref.rho_crit_of(constants.G_Newton), rel=RTOL)


def test_eh_transfer_and_linear_power_match_jax(pair):
    """The JAX linear layer reads its growth tables through jnp: the
    reference background is built in 64-bit mode too."""
    bg, ref = pair
    c = constants.light_speed
    Mpc = units.Mpc
    k = np.geomspace(1e-4, 20.0, 200) / Mpc
    prim = dict(A_s=2.1e-9, n_s=0.96, pivot=0.05 / Mpc)
    lin = LinearCosmology(bg, PrimordialSpectrum(**prim), 0.049, 0.27, c, Mpc)
    T = make_transfer("eisenstein_hu", 0.319, 0.049, 0.67, Mpc)(k)
    with jax.enable_x64(True):
        T_j = np.asarray(jax_transfer("eisenstein_hu", 0.319, 0.049, 0.67, Mpc)(k))
        ref64 = JaxBackground(H0=ref.H0, Omega_m=ref.Omega_m)
        lin_j = JaxLinear(ref64, JaxPrim(**prim), 0.049, 0.27, c, Mpc)
        want = {a: (np.asarray(lin_j.power_delta(k, a)),
                    np.asarray(lin_j.delta_amplitude(k, a))) for a in (0.02, 1.0)}
        sigma8_j = float(lin_j.sigma8())
    np.testing.assert_allclose(T, T_j, rtol=RTOL)
    for a, (P_j, amp_j) in want.items():
        np.testing.assert_allclose(lin.power_delta(k, a), P_j, rtol=RTOL)
        np.testing.assert_allclose(lin.delta_amplitude(k, a), amp_j, rtol=RTOL)
    assert lin.sigma8() == pytest.approx(sigma8_j, rel=RTOL)


def test_default_run_selects_eh():
    from concept_tpu.cosmology.backend import select_backend as jax_select
    from concept_tpu.param import load_params as jax_load
    from concept_tpu_torch.cosmology.backend import select_backend
    from concept_tpu_torch.param import load_params

    path = os.path.join(ROOT, "param", "example_basic.py")
    assert select_backend(load_params(path)) == jax_select(jax_load(path)) == "eh"
    eb = ["boltzmann_backend = 'eb'"]
    assert select_backend(load_params(path, overrides=eb)) == jax_select(
        jax_load(path, overrides=eb)) == "eb"
