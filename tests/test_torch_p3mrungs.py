"""The port's rung stepper (concept_tpu_torch.p3mrungs, the 8-mesh-cell
unified layout) vs the JAX package's P3MRungSimulation(unified=True,
unified_cb=8), both started from one state through convert.from_jax_state,
in the setup of tests/test_unified_layout.py: 8³ particles, mesh 32,
N_rungs = 4, spline softening.

The integer layouts must be identical: valid, ids order, rungs and the
occupancy extent after init_state, and the rungs and K_act after the
initial rung assignment.  After evolving a = 0.02 → 0.05 the mean
|Δx|/box must stay ≤ 5e-5, 4× below the 2e-4 that test_unified_layout.py
allows between two JAX layouts: here the layout is the same, and on the
CPU the JAX package deposits through pm_gradient_layout while the port
deposits on the cell layout, which differ at rounding level only.  (They
agree because the port's halo test is periodic: the JAX cell kernels would
drop a particle that crossed a box face until the next rebucket, which
moves this run's positions by 1.3e-4 of the box.)"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax.numpy as jnp  # noqa: E402

from concept_tpu.components import particle_mass  # noqa: E402
from concept_tpu.cosmology.background import Background as JaxBackground  # noqa: E402
from concept_tpu.p3mrungs import P3MRungSimulation as JaxRungs  # noqa: E402
from concept_tpu.p3mrungs import RungState as JaxRungState  # noqa: E402
from concept_tpu.p3mrungs import extract_flat as jax_extract  # noqa: E402
from concept_tpu.units import constants, units  # noqa: E402
from concept_tpu_torch.convert import from_jax_state, to_numpy  # noqa: E402
from concept_tpu_torch.cosmology.background import Background  # noqa: E402
from concept_tpu_torch.p3mrungs import P3MRungSimulation, extract_flat  # noqa: E402

FIELDS = ("pos", "mom", "valid", "rungs", "ids")


@pytest.fixture(scope="module")
def setup():
    h = 0.70
    H0 = 70 * units.km / (units.s * units.Mpc)
    box = 8 * units.Mpc / h
    G = constants.G_Newton
    N = 8**3
    jbg = JaxBackground(H0=H0, Omega_m=0.30)
    mass = particle_mass(0.30, jbg.rho_crit_of(G), box, N)
    rng = np.random.default_rng(5)
    lin = (np.arange(8, dtype=np.float32) + 0.5) * (box / 8)
    pos = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    pos = np.mod(
        pos + 0.2 * (box / 8) * rng.standard_normal(pos.shape).astype(np.float32),
        box,
    ).astype(np.float32)
    kw = dict(mesh=32, N_rungs=4, softening=0.03 * box / 8,
              softening_kernel="spline")
    jsim = JaxRungs(8, box, mass, G, bg=jbg, unified=True, unified_cb=8, **kw)
    tsim = P3MRungSimulation(8, box, mass, G, bg=Background(H0=H0, Omega_m=0.30),
                             **kw)
    assert (jsim.nc, jsim.capacity, jsim.margin) == (tsim.nc, tsim.capacity,
                                                     tsim.margin)
    jstate = jsim.init_state(tuple(jnp.asarray(pos[:, d]) for d in range(3)),
                             tuple(jnp.zeros(N, jnp.float32) for _ in range(3)))
    tpos = torch.as_tensor(pos)
    tstate = tsim.init_state(tuple(tpos[:, d] for d in range(3)),
                             tuple(torch.zeros(N) for _ in range(3)))
    return dict(box=box, N=N, jsim=jsim, tsim=tsim, tarrays=to_numpy(tstate),
                jarrays={f: np.asarray(getattr(jstate, f)) for f in FIELDS})


def test_init_state_layout_identical(setup):
    s = setup
    got = s["tarrays"]
    for f in ("valid", "ids", "rungs"):
        np.testing.assert_array_equal(got[f], s["jarrays"][f], err_msg=f)
    np.testing.assert_array_equal(got["pos"], s["jarrays"]["pos"])
    assert s["tsim"]._K_occ == s["jsim"]._K_occ
    assert s["tsim"].capacity == s["jsim"].capacity


def test_evolve_matches_jax(setup):
    s = setup
    jsim, tsim = s["jsim"], s["tsim"]
    state = from_jax_state(s["jarrays"], device="cpu")
    jstate = JaxRungState(**{f: jnp.asarray(s["jarrays"][f]) for f in FIELDS})
    t0 = float(jsim.bg.t_of_a_np(0.02))
    dt0 = jsim._timestep(0.02, 0.0)
    # initial rung assignment: same rungs and K_act
    jstate = jsim.assign_initial_rungs(jstate, dt0)
    state = tsim.assign_initial_rungs(state, tsim._timestep(0.02, 0.0))
    np.testing.assert_array_equal(to_numpy(state)["rungs"], np.asarray(jstate.rungs))
    np.testing.assert_array_equal(to_numpy(state)["ids"], np.asarray(jstate.ids))
    np.testing.assert_array_equal(tsim._K_act, jsim._K_act)
    assert tsim._K_occ == jsim._K_occ
    t1 = float(jsim.bg.t_of_a_np(0.05))
    jstate = jsim.evolve(jstate, t0, t1)
    state = tsim.evolve(state, t0, t1)
    p_j, _, ids_j = (np.asarray(a) for a in jax_extract(jstate, s["N"]))
    p, _, ids = (a.numpy() for a in extract_flat(state, s["N"]))
    p_j, p = p_j[np.argsort(ids_j)], p[np.argsort(ids)]
    dx = p - p_j
    dx -= s["box"] * np.round(dx / s["box"])
    assert np.mean(np.sqrt((dx**2).sum(1))) / s["box"] <= 5e-5
    assert tsim.stats["max_rung"] == jsim.stats["max_rung"]
