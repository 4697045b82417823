"""The port's bispectrum, the rest of its power spectrum and its
measurements against the JAX package, on the CPU, from the same numpy
particles (12³ clustered positions on grid 16).

Tolerances: the triangle configurations, the running bin centres and the
shell thicknesses are host float64 arithmetic of the same expressions and
agree exactly.  The spectra are float32 deposits and FFTs summed in
another order: B, Q and the triangle counts to rtol 1e-4 (atol 1e-4 of
the largest |B|, for the triangles whose B cancels near 0); P(k) to rtol
1e-4 (measured: 2e-5), its shot-noise-corrected column to 1e-4 of the
largest P (it cancels to near 0 at high k), and k to 1e-5, as JAX bins k
in float32.  The tree-level B takes the port's float64 linear spectrum
against JAX's float32 one: rtol 1e-4.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax.numpy as jnp  # noqa: E402

from concept_tpu.analysis import bispec as jbispec  # noqa: E402
from concept_tpu.analysis import measure as jmeasure  # noqa: E402
from concept_tpu.analysis import powerspec as jps  # noqa: E402
from concept_tpu_torch.analysis import bispec as tbispec  # noqa: E402
from concept_tpu_torch.analysis import measure as tmeasure  # noqa: E402
from concept_tpu_torch.analysis import powerspec as tps  # noqa: E402

BOX = 100.0
GRID = 16


def _positions(seed, n=12):
    """n³ particles clustered around 5 centres, and a uniform third."""
    rng = np.random.default_rng(seed)
    m = n**3
    centres = rng.uniform(0, BOX, (5, 3))
    pos = centres[rng.integers(0, 5, m)] + rng.normal(0, 8.0, (m, 3))
    pos[: m // 3] = rng.uniform(0, BOX, (m // 3, 3))
    return np.mod(pos, BOX).astype(np.float32)


@pytest.fixture(scope="module")
def pos():
    return _positions(0)


def _close(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.nanmax(np.abs(ref)))


BISPEC_CASES = {
    "equilateral, antialiased": dict(configuration="equilateral 6"),
    "L-isosceles, binary shells": dict(configuration="L-isosceles 4", antialias=False),
    "stretched, running thickness": dict(
        configuration="stretched 5",
        shellthickness={"1*k_fundamental": "0.25*k_fundamental",
                        "4*k_fundamental": "max(3*k_fundamental, 1/20*log(10)*k)"}),
    "shot-noise corrected, no interlacing": dict(
        configuration="isosceles-right 5", interlace=False, shotnoise_correction=True,
        n_particles=12**3),
}


@pytest.mark.parametrize("case", sorted(BISPEC_CASES))
def test_bispec_matches_jax(pos, case):
    kw = BISPEC_CASES[case]
    got = tbispec.bispec([torch.as_tensor(pos)], [1.0], GRID, BOX, **kw)
    ref = jbispec.bispec([jnp.asarray(pos)], [1.0], GRID, BOX, **kw)
    np.testing.assert_array_equal(got["triangles"], ref["triangles"])
    for key in ("B", "Q", "n_triangles"):
        _close(got[key], ref[key], 1e-4)


@pytest.mark.parametrize("name", ["equilateral", "stretched", "squeezed", "isosceles-right",
                                  "L-isosceles", "S-isosceles", "elongated", "right", "all"])
def test_triangle_configurations_match_jax(name):
    kf = 2 * math.pi / BOX
    got = tbispec.triangle_configurations(f"{name} 7", 2 * kf, 0.8 * kf * 32)
    assert got == jbispec.triangle_configurations(f"{name} 7", 2 * kf, 0.8 * kf * 32)


def test_shellthickness_and_treelevel_match_jax():
    from concept_tpu.run import build_cosmology as jax_cosmology
    from concept_tpu.param import load_params as jax_load
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import build_cosmology

    spec = {"1*k_fundamental": "0.25*k_fundamental",
            "4*k_fundamental": "max(3*k_fundamental, 1/20*log(10)*k)"}
    kf = 2 * math.pi / BOX
    for k in (kf, 2.5 * kf, 7 * kf, 30 * kf):
        assert (tbispec._shellthickness_at(spec, k, kf, 64)
                == jbispec._shellthickness_at(spec, k, kf, 64))
    tri = tbispec.triangle_configurations("right 3", 2 * kf, 20 * kf)
    lin = build_cosmology(load_params(text="Ωcdm = 0.27\nΩb = 0.049"))[3]
    jlin = jax_cosmology(jax_load(text="Ωcdm = 0.27\nΩb = 0.049"))[3]
    np.testing.assert_allclose(tbispec.bispec_treelevel(lin, tri, 0.5),
                               jbispec.bispec_treelevel(jlin, tri, 0.5), rtol=1e-4)


def _assert_spectra_close(got, ref):
    np.testing.assert_allclose(got["k"], ref["k"], rtol=1e-5)
    np.testing.assert_array_equal(got["modes"], ref["modes"])
    np.testing.assert_allclose(got["power"], ref["power"], rtol=1e-4)
    if "power_corrected" in ref:
        np.testing.assert_allclose(got["power_corrected"], ref["power_corrected"],
                                   atol=1e-4 * ref["power"].max())


RUNNING_BINS = [{"2*k_min": 4, "16*k_min": 20, "nyquist": 60},
                {"k_min": "gridsize/4"}]


@pytest.mark.parametrize("bpd", RUNNING_BINS, ids=["three points", "one expression"])
def test_running_bins_match_jax(pos, bpd):
    kf = 2 * math.pi / BOX
    k_max = kf * math.sqrt(3) * (GRID // 2)
    np.testing.assert_array_equal(
        tps.running_bin_centers(kf, k_max, bpd, GRID, BOX),
        jps.running_bin_centers(kf, k_max, bpd, GRID, BOX))
    got = tps.powerspec(torch.as_tensor(pos), GRID, BOX, len(pos), bins_per_decade=bpd)
    ref = jps.powerspec([jnp.asarray(pos)], [1.0], GRID, BOX, len(pos), bins_per_decade=bpd)
    _assert_spectra_close(got, ref)


def test_combined_and_grid_powerspec_match_jax(pos):
    pos2 = _positions(1, n=8)
    fluid = np.random.default_rng(2).uniform(0.5, 1.5, (8, 8, 8)).astype(np.float32)
    w = (1.0, 0.25)
    shot = tps.combined_shotnoise(w, (len(pos), len(pos2)), BOX)
    assert shot == jps.combined_shotnoise(w, (len(pos), len(pos2)), BOX)
    got = tps.combined_powerspec([torch.as_tensor(pos), torch.as_tensor(pos2)], list(w),
                                 [torch.as_tensor(fluid)], GRID, BOX, shotnoise=shot)
    ref = jps.combined_powerspec([jnp.asarray(pos), jnp.asarray(pos2)], list(w),
                                 [jnp.asarray(fluid)], GRID, BOX, shotnoise=shot)
    _assert_spectra_close(got, ref)
    delta = np.random.default_rng(3).standard_normal((GRID,) * 3).astype(np.float32)
    _assert_spectra_close(tps.grid_powerspec(torch.as_tensor(delta), BOX, 4096),
                          jps.grid_powerspec(jnp.asarray(delta), BOX, 4096))


def test_measure_matches_jax(pos):
    mom = np.random.default_rng(4).standard_normal(pos.shape).astype(np.float32)
    got = tmeasure.measure_particles(torch.as_tensor(pos), torch.as_tensor(mom), 2.5, 0.5)
    ref = jmeasure.measure_particles(jnp.asarray(pos), jnp.asarray(mom), 2.5, 0.5)
    for key in ("v_max", "v_rms", "mom_total", "mass_total"):
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(ref[key]), rtol=1e-5,
                                   err_msg=key)
    rng = np.random.default_rng(5)
    varrho = rng.uniform(0.5, 2.0, (8, 8, 8)).astype(np.float32)
    J = rng.standard_normal((3, 8, 8, 8)).astype(np.float32)
    got = tmeasure.measure_fluid(torch.as_tensor(varrho), torch.as_tensor(J))
    ref = jmeasure.measure_fluid(jnp.asarray(varrho), jnp.asarray(J))
    for key in ("rho_min", "rho_max", "rho_sum", "u_max", "vacuum_imminent"):
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(ref[key]), rtol=1e-5,
                                   err_msg=key)
