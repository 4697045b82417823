"""The port's global-step rungs (concept_tpu_torch.rungs) vs the JAX
package's (concept_tpu/rungs.py), after the four cases of
tests/test_rungs.py.  The grid-16 runs have 2 short-range cells a side,
so their sweeps are the folded ones.

Tolerances: rungs, schedules and the work counters are equal; positions
after several base steps agree to 5e-5 of the box
(tests/test_torch_p3mrungs.py).  The JAX package's rung stepper sweeps
with its functions' default softening kernel, 'plummer', whatever the
configuration says; the port's takes the configuration's, so both are
configured with 'plummer' here."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from concept_tpu import rungs as jr  # noqa: E402
from concept_tpu.components import ComponentSpec as JaxSpec, ParticleState as JaxState  # noqa: E402
from concept_tpu.cosmology.background import Background as JaxBackground  # noqa: E402
from concept_tpu.sim import SimConfig as JaxConfig, Simulation as JaxSimulation  # noqa: E402
from concept_tpu_torch import rungs  # noqa: E402
from concept_tpu_torch.components import ComponentSpec, ParticleState  # noqa: E402
from concept_tpu_torch.cosmology.background import Background  # noqa: E402
from concept_tpu_torch.sim import SimConfig, Simulation  # noqa: E402
from concept_tpu_torch.units import constants, units  # noqa: E402


def test_assign_rungs_scaling():
    # 4× the acceleration halves Δt: one rung up (tests/test_rungs.py)
    dm = np.asarray([[1.0, 0, 0], [4.0, 0, 0], [16.0, 0, 0], [0.0, 0, 0]], np.float32)
    kw = dict(mass=1.0, kick_integral=1.0, dt_base=1.0, softening=1.0, N_rungs=8, fac=1.0)
    r = rungs.assign_rungs(torch.as_tensor(dm), **kw).numpy()
    assert r[1] - r[0] == 1 and r[2] - r[1] == 1 and r[3] == 0
    rng = np.random.default_rng(0)
    dm = (rng.standard_normal((500, 3)) * 10.0 ** rng.uniform(-3, 3, (500, 1))).astype(np.float32)
    kw.update(kick_integral=0.3, dt_base=2.0, fac=0.025)
    np.testing.assert_array_equal(rungs.assign_rungs(torch.as_tensor(dm), **kw).numpy(),
                                  np.asarray(jr.assign_rungs(jnp.asarray(dm), **kw)))


def test_schedule_cadence():
    assert rungs.rung_kick_schedule(2) == [[2], [1, 2], [2], [0, 1, 2]]
    for m in range(5):
        assert rungs.rung_kick_schedule(m) == jr.rung_kick_schedule(m)
    for m in (0, 1, 255, 256, 257, 1000):
        assert rungs._pad_suffix(m, 700) == jr._pad_suffix(m, 700)


def _sims(N, box, grid, softening, bg, bg_j, mass=1.0, **extra):
    common = dict(boxsize=box, potential_gridsize=grid, G=constants.G_Newton,
                  method="p3m", softening=softening, softening_kernel="plummer", **extra)
    sim = Simulation(ComponentSpec("m", "matter", N=N, mass=mass),
                     SimConfig(device=torch.device("cpu"), **common), bg)
    sim_j = JaxSimulation(JaxSpec(name="m", species="matter", N=N, mass=mass),
                          JaxConfig(**common), bg_j)
    return sim, sim_j


def _periodic_max(a, b, box):
    d = np.abs(a - b)
    return np.minimum(d, box - d).max()


def test_rungs_match_jax_and_global_stepping():
    """evolve_rungs_p3m from one realized state against the JAX package's
    (5e-5 of the box) and, as tests/test_rungs.py asks, against the
    global stepper to well within a mesh cell."""
    from concept_tpu_torch.cosmology.linear import LinearCosmology
    from concept_tpu_torch.cosmology.primordial import PrimordialSpectrum
    from concept_tpu_torch.ic import realize_particles

    H0 = 67 * units.km / (units.s * units.Mpc)
    BOX = 128 * units.Mpc
    NG, grid = 8, 16
    N = NG**3
    bg, bg_j = Background(H0=H0, Omega_m=0.319), JaxBackground(H0=H0, Omega_m=0.319)
    mass = 0.319 * bg_j.rho_crit_of(constants.G_Newton) * BOX**3 / N
    sim, sim_j = _sims(N, BOX, grid, 0.025 * BOX / NG, bg, bg_j, mass=mass)
    assert sim._sr_ncells == 2
    a0, a1 = 0.05, 0.07
    # the ICs (the port's realization, held to the JAX package's by
    # tests/test_torch_ic.py) feed both runs
    lin = LinearCosmology(bg, PrimordialSpectrum(A_s=2.1e-9, n_s=0.96, pivot=0.05 / units.Mpc),
                          0.049, 0.27, constants.light_speed, units.Mpc)
    st0 = realize_particles(lin, sim.spec, BOX, a0, seed=3)
    pos, mom = st0.pos.numpy(), st0.mom.numpy()
    st_j = JaxState(pos=jnp.asarray(pos), mom=jnp.asarray(mom),
                    rungs=jnp.zeros((N,), jnp.int8))
    stats, stats_j = {}, {}
    out_j, _ = jr.evolve_rungs_p3m(sim_j, jax.tree.map(jnp.copy, st_j), a0, a1,
                                   N_rungs=3, stats=stats_j)
    state = ParticleState(pos=torch.as_tensor(pos), mom=torch.as_tensor(mom),
                          ids=torch.arange(N), rungs=torch.zeros(N, dtype=torch.int8))
    out, a = rungs.evolve_rungs_p3m(sim, state, a0, a1, N_rungs=3, stats=stats)
    assert a == pytest.approx(a1)
    assert stats == stats_j
    np.testing.assert_array_equal(out.rungs.numpy(), np.asarray(out_j.rungs))
    assert _periodic_max(out.pos.numpy(), np.asarray(out_j.pos), BOX) <= 5e-5 * BOX
    glob, _ = sim.evolve(ParticleState(pos=torch.as_tensor(pos), mom=torch.as_tensor(mom)),
                         a0, a1)
    # the rungs sort the particles: back to the original order by id
    by_id = out.pos[torch.argsort(out.ids)].numpy()
    assert _periodic_max(by_id, glob.pos.numpy(), BOX) < 0.1 * BOX / grid


def test_rung_compaction_reduces_work():
    """tests/test_rungs.py's clustered blob in a diffuse background (deep
    rungs for the blob): the same receiver rows, full rows and largest
    rung as the JAX package, the same positions, and far fewer receiver
    rows than full sweeps would take."""
    BOX = 100 * units.Mpc
    H0 = 67 * units.km / (units.s * units.Mpc)
    bg, bg_j = Background(H0=H0, Omega_m=0.31), JaxBackground(H0=H0, Omega_m=0.31)
    rng = np.random.default_rng(8)
    pos = np.mod(np.concatenate([rng.normal(50, 0.2, (256, 3)),
                                 rng.uniform(0, BOX, (768, 3))]), BOX).astype(np.float32)
    N = pos.shape[0]
    sim, sim_j = _sims(N, BOX, 16, 0.025 * BOX / round(N ** (1 / 3)), bg, bg_j)
    assert sim._sr_ncells == 2
    stats, stats_j = {}, {}
    out_j, _ = jr.evolve_rungs_p3m(
        sim_j, JaxState(pos=jnp.asarray(pos), mom=jnp.zeros_like(jnp.asarray(pos))),
        0.5, 0.52, N_rungs=4, stats=stats_j)
    out, _ = rungs.evolve_rungs_p3m(
        sim, ParticleState(pos=torch.as_tensor(pos), mom=torch.zeros(N, 3)),
        0.5, 0.52, N_rungs=4, stats=stats)
    assert stats == stats_j
    assert stats["max_rung"] >= 1 and stats["full_rows"] > 0
    assert stats["receiver_rows"] < 0.6 * stats["full_rows"], stats
    assert _periodic_max(out.pos.numpy(), np.asarray(out_j.pos), BOX) <= 5e-5 * BOX
