"""PP and Ewald gravity in the port (concept_tpu_torch.forces.pp,
forces/ewald.py, ``Simulation`` with 'pp' / 'ppnonperiodic') against the
JAX package: mirrors tests/test_pp_p3m.py and tests/test_orbits.py.

Tolerances: the Ewald field and table 1e-12 relative (float64 sums in
another order); PP momentum updates max|Δ|/max|ref| 1e-5 in float32 and
1e-12 in float64 (summation order over 256 particles); P³M against PP rms
0.05 (the JAX package's bound, set by the PM mesh); the orbits 2 % of
the separation and speed (tests/test_orbits.py); the CLI run's final
positions 1e-8 of the box in float64 (166 steps of the same
arithmetic)."""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from concept_tpu.forces.pp import pp_momentum_updates as jax_pp  # noqa: E402
from concept_tpu.units import constants, units  # noqa: E402
from concept_tpu_torch.forces.ewald import (  # noqa: E402
    ewald_acceleration, tabulate_ewald_correction,
)
from concept_tpu_torch.forces.pp import make_ewald_table, pp_momentum_updates  # noqa: E402

G = constants.G_Newton
BOX = 100 * units.Mpc


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    """Ewald tables go to the test's own directory, not the repository."""
    monkeypatch.setenv("CONCEPT_TPU_CACHE", str(tmp_path))


@pytest.fixture(scope="module")
def table32(tmp_path_factory):
    """The gridsize-32 table, tabulated once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CONCEPT_TPU_CACHE", str(tmp_path_factory.mktemp("ewald")))
        return make_ewald_table(32)


def test_two_particle_direct_force():
    """Non-periodic PP: Δmom = G m²/r²·ᔑdt along the separation."""
    m, r, dt = 5.0, 10 * units.Mpc, 0.1
    pos = torch.tensor([[10.0, 50.0, 50.0], [10.0 + r, 50.0, 50.0]], dtype=torch.float32)
    dmom = pp_momentum_updates(pos, m, BOX, dt, G, periodic=False).numpy()
    expected = G * m * m / r**2 * dt
    assert np.isclose(dmom[0, 0], expected, rtol=1e-5)
    assert np.isclose(dmom[1, 0], -expected, rtol=1e-5)
    assert np.allclose(dmom[:, 1:], 0.0, atol=1e-12)


def test_two_particle_ewald_force(table32):
    """Periodic PP: the images pull back, so the attraction is slightly
    weaker than the direct one, and Newton's third law holds with the
    correction."""
    table = table32
    r = 5 * units.Mpc
    pos = torch.tensor([[0.0, 0.0, 0.0], [r, 0.0, 0.0]], dtype=torch.float32)
    dmom = pp_momentum_updates(pos, 1.0, BOX, 1.0, G, ewald_table=table).numpy()
    assert 0.9 < dmom[0, 0] / (G / r**2) < 1.0
    np.testing.assert_allclose(dmom[0], -dmom[1], atol=1e-5 * abs(dmom[0, 0]))


def test_ewald_force_antisymmetric_across_box(table32):
    """A particle at exactly half the box away feels no net force."""
    table = table32
    pos = torch.tensor([[0.0, 0.0, 0.0], [BOX / 2, 0.0, 0.0]], dtype=torch.float32)
    dmom = pp_momentum_updates(pos, 1.0, BOX, 1.0, G, ewald_table=table).numpy()
    assert abs(dmom[0, 0]) < 0.05 * G / (BOX / 2) ** 2


def test_ewald_field_and_table_match_jax(tmp_path, monkeypatch):
    """The exact periodic field against ``ewald_acceleration_np`` and the
    tabulated correction (gridsize 8) against ``tabulate_ewald_correction``.
    Both packages cache the table under the same key, so each tabulates
    into an empty cache directory of its own."""
    from concept_tpu.forces.ewald import ewald_acceleration_np, tabulate_ewald_correction as jt

    pts = np.random.default_rng(1).uniform(-0.5, 0.5, (64, 3))
    np.testing.assert_allclose(ewald_acceleration(torch.as_tensor(pts)).numpy(),
                               ewald_acceleration_np(pts), rtol=1e-12)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setenv("CONCEPT_TPU_CACHE", str(jax_dir))
    ref = jt(8)
    monkeypatch.setenv("CONCEPT_TPU_CACHE", str(port_dir))
    assert not port_dir.exists()
    got = tabulate_ewald_correction(8)
    assert got.dtype == torch.float64 and tuple(got.shape) == (9, 9, 9, 3)
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    assert len(list((port_dir / "ewald").iterdir())) == 1
    # a second call reads the cached file the first one wrote
    np.testing.assert_array_equal(tabulate_ewald_correction(8).numpy(), got.numpy())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kernel", ["plummer", "spline", "none"])
@pytest.mark.parametrize("periodic", [True, False])
def test_pp_momentum_updates_match_jax(periodic, kernel, dtype):
    """256 particles, clustered and across the box faces, softened: the
    port's PP against the JAX package's, on the JAX package's float32
    Ewald table (gridsize 8), in float32 and in float64 (x64)."""
    from concept_tpu.forces.pp import make_ewald_table as jax_table

    rng = np.random.default_rng(2)
    pos = np.mod(np.concatenate([rng.normal(0.5 * BOX, 0.05 * BOX, (128, 3)),
                                 rng.uniform(0, 0.1 * BOX, (128, 3))]), BOX)
    pos = pos.astype(dtype)
    soft = 0.01 * BOX
    table = np.array(jax_table(8)) if periodic else None
    kw = dict(softening=soft, periodic=periodic, softening_kernel=kernel)
    got = pp_momentum_updates(torch.as_tensor(pos), 3.0, BOX, 0.5, G,
                              ewald_table=None if table is None else torch.as_tensor(table),
                              **kw).numpy()
    with jax.enable_x64(dtype == "float64"):
        ref = np.asarray(jax_pp(jnp.asarray(pos), 3.0, BOX, 0.5, G,
                                ewald_table=None if table is None else jnp.asarray(table),
                                **kw))
    assert got.dtype == ref.dtype == np.dtype(dtype)
    tol = 1e-5 if dtype == "float32" else 1e-12
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def test_p3m_matches_pp(table32):
    """The port's P³M (PM long range, interlaced, and the short-range
    sweep) reproduces its exact Ewald PP force on 2048 random particles
    (tests/test_pp_p3m.py::test_p3m_matches_pp, on a gridsize-32 table)."""
    from concept_tpu_torch.forces.pm import pm_gravity_momentum_updates
    from concept_tpu_torch.forces.shortrange import (
        cell_grid_shape, shortrange_momentum_updates,
    )

    rng = np.random.default_rng(11)
    N, m, grid = 2048, 3.0, 32
    pos = torch.as_tensor(rng.uniform(0, BOX, (N, 3)).astype(np.float32))
    scale = 1.25 * BOX / grid
    cutoff = 4.5 * scale
    pp = pp_momentum_updates(pos, m, BOX, 1.0, G, ewald_table=table32).numpy()
    (long,) = pm_gravity_momentum_updates([pos], [m], grid, BOX, G, 1.0, order=2,
                                          longrange_scale=scale, interlace=True)
    n_cells = cell_grid_shape(BOX, cutoff)
    short, _ = shortrange_momentum_updates(
        pos.unbind(1), m, BOX, scale, cutoff, 1.0, n_cells=n_cells,
        capacity=max(32, int(8 * N / n_cells**3)), G=G)
    p3m = long.numpy() + torch.stack(short, 1).numpy()
    rms_err = np.sqrt(np.mean((p3m - pp) ** 2))
    assert rms_err / np.sqrt(np.mean(pp**2)) < 0.05


def _orbit(T, n_steps):
    """Two equal masses on a circular orbit through ``evolve_static``
    with 'ppnonperiodic' (tests/test_orbits.py): (start, end) states."""
    from concept_tpu_torch.components import ComponentSpec, ParticleState
    from concept_tpu_torch.cosmology.background import Background
    from concept_tpu_torch.sim import SimConfig, Simulation

    box, m, r = 100 * units.Mpc, 1e6, 1 * units.Mpc
    v = math.sqrt(G * m / (2 * r))
    c = box / 2
    pos = np.array([[c - r / 2, c, c], [c + r / 2, c, c]], np.float32)
    mom = np.array([[0, -v * m, 0], [0, v * m, 0]], np.float32)
    bg = Background(H0=67 * units.km / (units.s * units.Mpc), Omega_m=1.0,
                    enable_Hubble=False)
    sim = Simulation(ComponentSpec(name="pair", species="matter", N=2, mass=m),
                     SimConfig(boxsize=box, potential_gridsize=8, device=torch.device("cpu"),
                               G=G, method="ppnonperiodic"), bg)
    out = sim.evolve_static(ParticleState(pos=torch.tensor(pos), mom=torch.tensor(mom)),
                            T(G * m, r), n_steps)
    return pos, mom, out, r, v * m


def test_two_body_circular_orbit_nonperiodic():
    """After one analytic period the pair is back where it started."""
    pos0, mom0, out, r, p = _orbit(lambda Gm, r: 2 * math.pi / math.sqrt(2 * Gm / r**3), 2000)
    np.testing.assert_allclose(out.pos.numpy(), pos0, atol=0.02 * r)
    np.testing.assert_allclose(out.mom.numpy(), mom0, atol=0.02 * p)


def test_two_body_half_period():
    """After half a period the two particles have swapped places."""
    pos0, _, out, r, _ = _orbit(lambda Gm, r: math.pi / math.sqrt(2 * Gm / r**3), 1000)
    np.testing.assert_allclose(out.pos.numpy(), pos0[[1, 0]], atol=0.02 * r)


def test_cli_pp_run_matches_jax(tmp_path, monkeypatch):
    """Gravity 'pp' through the port's CLI at 4³ (example_basic's box and
    cosmology, a = 0.02 → 1, float64) against the JAX package's run:
    the same steps and positions within 1e-8 of the box.  The CLI's
    ``run`` result is caught on its way out; each package tabulates its
    Ewald table in a cache directory of its own."""
    import concept_tpu_torch.run as port_run
    from concept_tpu.param import load_params as jax_load
    from concept_tpu.run import run as jax_run
    from concept_tpu_torch.cli import main

    param = os.path.join(os.path.dirname(os.path.dirname(__file__)), "param",
                         "example_basic.py")
    over = ["initial_conditions={'species':'matter','N':4**3}",
            "select_forces={'all': {'gravity': 'pp'}}", "enable_float64=True",
            "ewald_gridsize=8"]
    results = []
    real_run = port_run.run

    def caught_run(*args, **kwargs):
        results.append(real_run(*args, **kwargs))
        return results[-1]

    monkeypatch.setattr(port_run, "run", caught_run)
    monkeypatch.setenv("CONCEPT_TPU_CACHE", str(tmp_path / "port_cache"))
    out = tmp_path / "cli"
    assert main(["-p", param, "--device", "cpu", *sum((["-c", o] for o in over), []),
                 "-c", f"output_dirs='{out}'"]) == 0
    assert np.all(np.isfinite(np.loadtxt(out / "powerspec_a=1.txt")[:, :3]))
    ((sim, st, a),) = results
    monkeypatch.setenv("CONCEPT_TPU_CACHE", str(tmp_path / "jax_cache"))
    was = jax.config.jax_enable_x64
    try:
        cfg = jax_load(param, overrides=over + [f"output_dirs='{tmp_path / 'j'}'"])
        jsim, jst, ja = jax_run(cfg)
        jpos = np.asarray(jst.pos)
    finally:
        jax.config.update("jax_enable_x64", was)
    assert sim.hysteresis["step_count"] == jsim.hysteresis["step_count"]
    assert st.pos.dtype == torch.float64 and jpos.dtype == np.float64
    box = cfg.boxsize
    dx = st.pos.numpy() - jpos
    dx -= box * np.round(dx / box)
    assert np.abs(dx).max() <= 1e-8 * box


def test_kick_is_a_step_without_drift():
    """``Simulation.kick`` gives the momenta of a step with no drift and
    leaves the positions where they were."""
    from concept_tpu_torch.components import ComponentSpec, ParticleState
    from concept_tpu_torch.cosmology.background import Background
    from concept_tpu_torch.sim import SimConfig, Simulation

    rng = np.random.default_rng(5)
    pos = torch.as_tensor(rng.uniform(0, BOX, (16, 3)))
    bg = Background(H0=67 * units.km / (units.s * units.Mpc), Omega_m=1.0,
                    enable_Hubble=False)
    sim = Simulation(ComponentSpec(name="p", species="matter", N=16, mass=2.0),
                     SimConfig(boxsize=BOX, potential_gridsize=8, device=torch.device("cpu"),
                               G=G, method="ppnonperiodic", dtype=torch.float64), bg)
    kicked = sim.kick(ParticleState(pos=pos.clone(), mom=torch.zeros_like(pos)), 0.5)
    stepped = sim.step(ParticleState(pos=pos.clone(), mom=torch.zeros_like(pos)), 0.5, 0.0)
    assert torch.equal(kicked.pos, pos)
    assert torch.equal(kicked.mom, stepped.mom) and bool(kicked.mom.abs().max() > 0)
    assert sim.stats["kicks"] == 2
