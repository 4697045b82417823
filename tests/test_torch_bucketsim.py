"""The port's persistent-bucket PM stepper (concept_tpu_torch.bucketsim)
against the JAX package's (concept_tpu.bucketsim) on the CPU, both started
from one state through convert.bucket_state_from_jax, at the sizes of
tests/test_bucketsim.py (3000 particles, mesh 16, 8³ blocks, so the JAX
package pads no block columns).

Tolerances: layouts (slots, validity, capacities) exactly; positions
after one step 2e-4 of the box and after four 1e-3 (tests/test_bucketsim.py;
measured 7.6e-6: float32 sums in another order); the capped, spilled
stepper against the port's plain 'scatter' PM step (held against the JAX
package in tests/test_torch_pm_only.py) at the JAX test's 2e-4 and 2e-3.
The port's straggler test is periodic (its block kernels keep particles
that crossed a box face), so it counts fewer stragglers than the JAX
stepper; the sums are the same.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax.numpy as jnp  # noqa: E402

from concept_tpu.bucketsim import (  # noqa: E402
    BucketSimulation as JaxBucketSimulation, bucketize_state as jax_bucketize_state,
)
from concept_tpu_torch.bucketsim import (  # noqa: E402
    BucketSimulation, bucketize_state, flatten_state,
)
from concept_tpu_torch.components import periodic_wrap  # noqa: E402
from concept_tpu_torch.convert import bucket_state_from_jax  # noqa: E402
from concept_tpu_torch.forces.pm import pm_gravity_momentum_updates  # noqa: E402

N_GRID, BOX, MASS, G = 16, 40.0, 2.0, 1.0


def make_particles(n=3000, seed=0, mom_scale=0.02):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, BOX, (n, 3)).astype(np.float32)
    mom = (mom_scale * rng.standard_normal((n, 3))).astype(np.float32)
    return pos, mom


def _numpy(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def sort_rows(x, by=None):
    """Rows of x in the lexicographic order of the rows of ``by`` (x)."""
    x = np.asarray(x, dtype=np.float64)
    by = x if by is None else np.asarray(by)
    return x[np.lexsort((by[:, 2], by[:, 1], by[:, 0]))]


def reference_step(pos, mom, int_a1, int_a2, n_grid=N_GRID, box=BOX):
    """The port's plain PM kick ('scatter') and drift on (N, 3) tensors."""
    (dmom,) = pm_gravity_momentum_updates([pos], [MASS], n_grid, box, G,
                                          kick_integral=int_a1, deposit_method="scatter")
    mom = mom + dmom
    return periodic_wrap(pos + mom * (int_a2 / MASS), box), mom


def test_bucketize_state_matches_jax():
    pos, mom = make_particles()
    st_j = _numpy(jax_bucketize_state(jnp.asarray(pos), jnp.asarray(mom), N_GRID, BOX, 24))
    st_t = bucketize_state(torch.as_tensor(pos), torch.as_tensor(mom), N_GRID, BOX, 24)
    for k in ("pos", "mom", "valid"):
        np.testing.assert_array_equal(getattr(st_t, k).numpy(), st_j[k], err_msg=k)
    p, _ = flatten_state(st_t)
    np.testing.assert_array_equal(sort_rows(p), sort_rows(pos))


@pytest.fixture(scope="module")
def stepped():
    """Both steppers from one state (momenta boosted so that particles
    leave their blocks' halos), four steps, then a rebucket: the JAX and
    port states and straggler counts after each step."""
    pos, mom = make_particles(seed=5, mom_scale=1.0)
    jsim = JaxBucketSimulation(N_GRID, BOX, MASS, G, capacity=24)
    js = jsim.init_state(jnp.asarray(pos), jnp.asarray(mom))
    tsim = BucketSimulation(N_GRID, BOX, MASS, G, capacity=24, device="cpu")
    ts = tsim.init_state(torch.as_tensor(pos), torch.as_tensor(mom))
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    ts = bucket_state_from_jax(_numpy(js), N_GRID)
    steps = []
    for _ in range(4):
        js, nj = jsim.step(js, 0.3, 0.25)
        ts, nt = tsim.step(ts, 0.3, 0.25)
        steps.append((_numpy(js), {k: v.clone() for k, v in ts._asdict().items()}, int(nj), nt))
    rebucketed = (_numpy(jsim.maybe_rebucket(js)), tsim.maybe_rebucket(ts))
    return steps, rebucketed, (jsim, tsim)


@pytest.mark.parametrize("i, tol", [(0, 2e-4), (3, 1e-3)], ids=["one-step", "four-steps"])
def test_steps_match_jax(stepped, i, tol):
    steps, _, _ = stepped
    sj, st, _, _ = steps[i]
    np.testing.assert_array_equal(st["valid"].numpy(), sj["valid"])
    np.testing.assert_allclose(st["pos"].numpy(), sj["pos"], atol=tol * BOX)
    np.testing.assert_allclose(st["mom"].numpy(), sj["mom"],
                               atol=tol * np.abs(sj["mom"]).max())
    # the steps took both straggler paths (the port's counts no box-face
    # crossers, JAX's does)
    assert 0 < sum(s[3] for s in steps) < sum(s[2] for s in steps)


def test_rebucket_matches_jax(stepped):
    _, (sj, st), (jsim, tsim) = stepped
    assert tsim.capacity == jsim.capacity
    np.testing.assert_array_equal(st.valid.numpy(), sj["valid"])
    np.testing.assert_allclose(st.pos.numpy(), sj["pos"], atol=1e-3 * BOX)
    assert int(st.valid.sum()) == 3000


def test_capped_capacity_spill_matches_jax_and_is_exact():
    """A clump of 100 particles in one block, the capacity capped at 16:
    the rebucket spills the overflow into free slots in the JAX package's
    order, and the step (the spill rides the straggler path) equals the
    plain PM step."""
    pos, mom = make_particles(seed=3)
    pos[:100] = (BOX / 2) + np.random.default_rng(0).uniform(0, 0.8 * BOX / N_GRID, (100, 3))
    pos = pos.astype(np.float32)
    jsim = JaxBucketSimulation(N_GRID, BOX, MASS, G, capacity=16, capacity_max=16)
    js = jsim.maybe_rebucket(jsim.init_state(
        tuple(jnp.asarray(np.ascontiguousarray(pos[:, d])) for d in range(3)),
        tuple(jnp.asarray(np.ascontiguousarray(mom[:, d])) for d in range(3))))
    tsim = BucketSimulation(N_GRID, BOX, MASS, G, capacity=16, capacity_max=16,
                            device="cpu")
    ts = tsim.maybe_rebucket(tsim.init_state(torch.as_tensor(pos), torch.as_tensor(mom)))
    assert tsim._n_spilled == jsim._n_spilled > 0
    assert tsim.capacity == jsim.capacity == 16
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    ts, ns = tsim.step(ts, 0.3, 0.25)
    # spilled slots whose position lies outside their block's halo
    assert ns > 0.9 * tsim._n_spilled and int(ts.valid.sum()) == pos.shape[0]
    ref_pos, ref_mom = reference_step(torch.as_tensor(pos), torch.as_tensor(mom), 0.3, 0.25)
    p1, m1 = flatten_state(ts)
    np.testing.assert_allclose(sort_rows(p1), sort_rows(ref_pos), atol=2e-4)
    np.testing.assert_allclose(sort_rows(m1, p1), sort_rows(ref_mom, ref_pos), atol=2e-3)


def test_odd_block_count_step_matches_plain_step():
    """Mesh 12 → 6³ = 216 block columns (the JAX stepper pads them to
    256; the port keeps 216): one step against the plain PM step."""
    n_grid, box = 12, 30.0
    rng = np.random.default_rng(11)
    pos = torch.as_tensor(rng.uniform(0, box, (800, 3)).astype(np.float32))
    mom = torch.as_tensor((0.01 * rng.standard_normal((800, 3))).astype(np.float32))
    sim = BucketSimulation(n_grid, box, MASS, G, capacity=24, device="cpu")
    st = sim.init_state(pos, mom)
    assert st.valid.shape == (24, 216) and int(st.valid.sum()) == 800
    st, _ = sim.step(st, 0.4, 0.3)
    ref_pos, _ = reference_step(pos, mom, 0.4, 0.3, n_grid, box)
    p, _ = flatten_state(st)
    np.testing.assert_allclose(sort_rows(p), sort_rows(ref_pos), atol=2e-4)
