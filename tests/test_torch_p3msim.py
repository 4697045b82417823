"""The port's persistent-layout P³M stepper (concept_tpu_torch.p3msim)
vs the JAX package's (concept_tpu/p3msim.py), after the cases of
tests/test_p3msim.py, and the memory-lean PM kick.

Both start from one state (the JAX layout carried over by
concept_tpu_torch.convert).  Tolerances: integer layouts (slots, valid,
capacities, the PM binding's blocks, ranks and stragglers, counts) are
equal; positions after steps agree to 5e-5 of the box
(tests/test_torch_p3mrungs.py); momenta after one step to 1e-5 of the
largest momentum (the sweep's max-relative 1e-5,
tests/test_pallas_shortrange.py:41), after several to 5e-5 of it (the
positions' relative scale: the sweep's error feeds the next steps);
the lean kick's momentum change to rtol 2e-5 / atol 1e-5·max|ref|, the
deposit/gather tolerance of tests/test_pallas_cells.py:62."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax.numpy as jnp  # noqa: E402

from concept_tpu import p3msim as jp  # noqa: E402
from concept_tpu_torch import p3msim  # noqa: E402
from concept_tpu_torch.convert import from_jax_state, to_numpy  # noqa: E402

BOX = 64.0
POS_TOL = 5e-5 * BOX


def _particles(n_part, seed=11):
    rng = np.random.default_rng(seed)
    lin = (np.arange(n_part) + 0.5) * (BOX / n_part)
    pos = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    pos += rng.standard_normal(pos.shape) * (0.45 * BOX / n_part)
    pos = np.mod(pos, BOX).astype(np.float32)
    mom = (rng.standard_normal(pos.shape) * 0.1).astype(np.float32)
    return pos, mom


def _sims(n_part, **kw):
    args = (n_part, BOX)
    kwargs = dict(mass=2.0, G=1.0, mesh=2 * n_part, **kw)
    return jp.P3MSimulation(*args, **kwargs), p3msim.P3MSimulation(*args, **kwargs)


def _init(js, ps, pos, mom):
    """The JAX state and the port's own (which must be equal)."""
    jstate = js.init_state(tuple(jnp.asarray(pos[:, d]) for d in range(3)),
                           tuple(jnp.asarray(mom[:, d]) for d in range(3)))
    pstate = ps.init_state(tuple(torch.as_tensor(pos[:, d]) for d in range(3)),
                           tuple(torch.as_tensor(mom[:, d]) for d in range(3)))
    return jstate, pstate


def _np(jstate):
    return {k: np.asarray(getattr(jstate, k)) for k in ("pos", "mom", "valid")}


def _assert_states_close(port, ref: dict, mom_tol=1e-5):
    got = to_numpy(port)
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    dx = got["pos"] - ref["pos"]
    dx -= BOX * np.round(dx / BOX)
    assert np.abs(dx).max() <= POS_TOL
    assert np.abs(got["mom"] - ref["mom"]).max() <= mom_tol * np.abs(ref["mom"]).max()


def test_bucketize_equals_jax():
    """init_state: the same capacity and the same slots, bit for bit."""
    pos, mom = _particles(12)
    js, ps = _sims(12)
    jstate, pstate = _init(js, ps, pos, mom)
    assert ps.capacity == js.capacity and ps.nc == js.nc == 3
    ref = _np(jstate)
    got = to_numpy(pstate)
    for k in ("pos", "mom", "valid"):
        np.testing.assert_array_equal(got[k], ref[k])
    assert p3msim._occupancy_probe_sr(pstate, BOX, ps.nc) == int(
        jp._occupancy_probe_sr(jstate, jnp.float32(BOX), js.nc))


def test_rebucketize_after_drift_equals_jax():
    """Every particle drifted by a full cell, then rebucketized: the same
    layout as the JAX package's, and no particle lost."""
    pos, mom = _particles(12)
    js, ps = _sims(12)
    jstate, _ = _init(js, ps, pos, mom)
    drift = js.cell_width
    jstate = jstate._replace(pos=jnp.where(jstate.valid[None],
                                           jnp.mod(jstate.pos + drift, BOX), 0.0))
    pstate = from_jax_state(_np(jstate))
    ref = _np(js.rebucket(jstate))
    got = ps.rebucket(pstate)
    assert ps.capacity == js.capacity
    assert int(got.valid.sum()) == pos.shape[0]
    for k in ("pos", "mom", "valid"):
        np.testing.assert_array_equal(to_numpy(got)[k], ref[k])
    assert pstate.pos.numel() == 0  # the old state was consumed


@pytest.mark.parametrize("n_part", [12, 8], ids=["nc3", "nc2-folded"])
def test_one_step_matches_jax(n_part):
    """One KDK step from one state: at 3 cells a side (the ±1 sweep, row
    6's plain version) and at 2 (the folded sweep), with the PM through
    the persistent binding."""
    pos, mom = _particles(n_part)
    js, ps = _sims(n_part)
    jstate, _ = _init(js, ps, pos, mom)
    pstate = from_jax_state(_np(jstate))
    jstate, (j_over, j_vmax) = js.step(jstate, 1e-3, 2e-3)
    pstate, (p_over, p_vmax) = ps.step(pstate, 1e-3, 2e-3)
    assert p_over == j_over == 0
    assert p_vmax == pytest.approx(j_vmax, rel=1e-5)
    _assert_states_close(pstate, _np(jstate))
    assert ps.stats["binding_refreshes"] == 1 and ps.stats["pm_mass_warnings"] == 0


def test_multi_step_with_rebucket_matches_jax():
    """Four steps with a rebucket whenever the margin budget is spent, as
    the JAX test drives them (with drifts long enough to spend it): the
    same rebuckets, the same final layout.  The particles keep 5 units
    from the box faces, which none reaches in four steps: the JAX block
    kernels drop a particle that crossed a face from the bound PM blocks
    (their halo test is not periodic, ROADMAP Queue 3), the port's keep
    it."""
    pos, mom = _particles(12)
    pos = (5.0 + pos * (54.0 / BOX)).astype(np.float32)
    js, ps = _sims(12, margin_frac=0.15)
    jstate, _ = _init(js, ps, pos, mom)
    pstate = from_jax_state(_np(jstate))
    for _ in range(4):
        jstate, _ = js.step(jstate, 5e-3, 4.0)
        pstate, _ = ps.step(pstate, 5e-3, 4.0)
        assert ps.needs_rebucket == js.needs_rebucket
        if js.needs_rebucket:
            jstate = js.rebucket(jstate)
            pstate = ps.rebucket(pstate)
    assert ps.stats["rebuckets"] >= 1 and ps.stats["pm_mass_warnings"] == 0
    _assert_states_close(pstate, _np(jstate), mom_tol=5e-5)


def test_pm_overflow_counted_and_exact():
    """128 particles crammed into one deposit block: the binding's block
    overflow equals the JAX package's and the kick agrees."""
    pos, _ = _particles(12)
    rng = np.random.default_rng(5)
    pos[:128] = 32.0 + rng.uniform(0, 1.5, (128, 3))
    mom = np.zeros_like(pos)
    js, ps = _sims(12, k_pm=8)
    jstate, _ = _init(js, ps, pos, mom)
    pstate = from_jax_state(_np(jstate))
    jstate, (j_over, _) = js.step(jstate, 1e-3, 0.0)
    pstate, (p_over, _) = ps.step(pstate, 1e-3, 0.0)
    assert p_over == j_over > 0
    _assert_states_close(pstate, _np(jstate))


def test_pm_binding_matches_jax():
    """build_pm_binding: the same block and rank for every slot, the same
    straggler slots and overflow count as the JAX binding (its lane
    padding aside), on a state with an overcrowded block; the mapped PM
    equals the sorted one."""
    pos, _ = _particles(12)
    rng = np.random.default_rng(6)
    pos[:40] = 20.0 + rng.uniform(0, 1.0, (40, 3))
    js, ps = _sims(12)
    jstate, pstate = _init(js, ps, pos, np.zeros_like(pos))
    mesh, k_pm = js.mesh, 8
    jb = jp.build_pm_binding(jstate.pos, jstate.valid, BOX, mesh, k_pm, 4096)
    pb = p3msim.build_pm_binding(pstate.pos, pstate.valid, BOX, mesh, k_pm)
    C_pm = (mesh // 2) ** 3
    Cp = np.asarray(jb["w1"]).shape[1]
    j_map = np.asarray(jb["pm_map"]).astype(np.int64)
    p_map = np.full(pstate.valid.numel(), k_pm * C_pm, np.int64)
    p_map[pb["src"].numpy()] = pb["dst"].numpy()
    j_in, p_in = j_map < k_pm * Cp, p_map < k_pm * C_pm
    np.testing.assert_array_equal(p_in, j_in)
    np.testing.assert_array_equal(p_map[p_in] // C_pm, j_map[j_in] // Cp)  # rank
    np.testing.assert_array_equal(p_map[p_in] % C_pm, j_map[j_in] % Cp)  # block
    s_ok = np.asarray(jb["s_ok"])
    assert pb["n_over"] == int(jb["n_over"]) == int(s_ok.sum()) > 0
    np.testing.assert_array_equal(np.sort(pb["s_idx"].numpy()),
                                  np.sort(np.asarray(jb["s_idx"])[s_ok]))
    np.testing.assert_array_equal(pb["w1"].numpy(), np.asarray(jb["w1"])[:, :C_pm])
    args = (pstate.pos, pstate.valid, 2.0, 1.0, ps.scale, BOX, mesh)
    fd_m, n_m, m_m = p3msim.pm_gradient_layout(*args, k_pm=k_pm, binding=pb)
    fd_s, n_s, m_s = p3msim.pm_gradient_layout(*args, k_pm=k_pm)
    assert n_m == n_s and float(m_m) == pytest.approx(float(m_s), rel=1e-6)
    torch.testing.assert_close(fd_m, fd_s, rtol=2e-5, atol=1e-5 * float(fd_s.abs().max()))


def test_zero_integral_step_preserves_state():
    pos, mom = _particles(12)
    _, ps = _sims(12)
    state = ps.init_state(tuple(torch.as_tensor(pos[:, d]) for d in range(3)),
                          tuple(torch.as_tensor(mom[:, d]) for d in range(3)))
    before = to_numpy(state)
    state, _ = ps.step(state, 0.0, 0.0)
    after = to_numpy(state)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])


def test_autotune_picks_a_candidate_and_preserves_particles():
    """autotune_margin times the candidates whose cell counts differ, as
    the JAX package's, keeps the fastest and loses no particle."""
    pos, mom = _particles(12)
    _, ps = _sims(12)
    state = ps.init_state(tuple(torch.as_tensor(pos[:, d]) for d in range(3)),
                          tuple(torch.as_tensor(mom[:, d]) for d in range(3)))
    cands = (0.05, 0.2, 0.21)
    state, results = p3msim.autotune_margin(ps, state, candidates=cands, n_time=1)
    ncs = [p3msim.margin_cell_count(BOX, ps.cutoff, m) for m in cands]
    assert ncs[1] == ncs[2] and list(results) == [0.05, 0.2]
    assert results[ps.margin_frac] == min(results.values())
    assert ps.nc == p3msim.margin_cell_count(BOX, ps.cutoff, ps.margin_frac)
    flat = state.pos.reshape(3, -1).T[state.valid.reshape(-1)].numpy()
    a, b = np.lexsort(flat.T), np.lexsort(pos.T)
    np.testing.assert_array_equal(flat[a], pos[b])


def _cell_layout(mesh, cb, K, seed=3):
    """tests/test_p3msim.py's lean-kick layout: particles bucketized by
    cell, each slot inside its own column."""
    rng = np.random.default_rng(seed)
    nc = mesh // cb
    C = nc**3
    N = K * C // 3
    cell = rng.integers(0, C, N)
    cw = BOX / nc
    pos = np.zeros((3, K, C), np.float32)
    valid = np.zeros((K, C), bool)
    slot = np.zeros(C, np.int64)
    for c in cell:
        s = slot[c]
        pos[:, s, c] = (np.array([c // nc**2, (c // nc) % nc, c % nc])
                        + rng.uniform(0.1, 0.9, 3)) * cw
        valid[s, c] = True
        slot[c] += 1
    mom = np.where(valid[None], rng.standard_normal((3, K, C)), 0).astype(np.float32)
    return pos, valid, mom, N


def test_lean_kick_matches_jax():
    """pm_kick_cells_lean (order-4 stencil gradients one at a time)
    against the JAX package's (Pallas in interpret mode) at mesh 32, cb 8;
    and, as the JAX test, close to the spectral pm_gradient_cells up to
    the stencil's truncation."""
    mesh, cb, K = 32, 8, 32
    pos, valid, mom, N = _cell_layout(mesh, cb, K)
    mass, G, int_pm, scale = 2.0, 1.0, 1e-3, 1.25 * BOX / mesh
    ref, ref_sum = jp.pm_kick_cells_lean(jnp.asarray(pos), jnp.asarray(mom),
                                         jnp.asarray(valid), mass, G, int_pm, scale,
                                         BOX, mesh, cb=cb, interpret=True)
    pos_t, valid_t = torch.as_tensor(pos), torch.as_tensor(valid)
    got, got_sum = p3msim.pm_kick_cells_lean(pos_t, torch.as_tensor(mom.copy()),
                                             valid_t, mass, G, int_pm, scale, BOX,
                                             mesh, cb=cb)
    for msum in (got_sum, ref_sum):
        assert float(msum) == pytest.approx(N * mass, rel=1e-5)
    d_ref = np.asarray(ref) - mom
    d_got = got.numpy() - mom
    np.testing.assert_allclose(d_got, d_ref, rtol=2e-5, atol=1e-5 * np.abs(d_ref).max())
    assert np.all(got.numpy()[:, ~valid] == 0)
    fd3, _ = p3msim.pm_gradient_cells(pos_t, valid_t, mass, G, scale, BOX, mesh, cb=cb)
    d_spec = ((-mass * int_pm) * fd3).numpy()[:, valid]
    d_lean = d_got[:, valid]
    corr = (d_lean * d_spec).sum() / np.sqrt((d_lean**2).sum() * (d_spec**2).sum())
    assert corr > 0.99
    assert np.sqrt(((d_lean - d_spec) ** 2).mean()) < 0.2 * np.sqrt((d_spec**2).mean())
