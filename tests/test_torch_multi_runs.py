"""Several components and fluids: the runs of the port's MultiSimulation
and run.run against the JAX package's on the CPU (the cheap cases are in
tests/test_torch_sim_multi.py, whose helpers this file uses).

- The two hand-built configurations of tests/test_torch_sim_multi.py
  (PM particles with 'class' fluids at orders 0 and 1 and a MacCormack
  fluid at odd parity, on another grid than the potential; two P³M
  particle components, the plain paths of PERF.md rows 6 and 2, with a
  decaying fluid, its decay product and the lapse component), each
  stepped three times by both packages' ``_step`` (the JAX one jitted,
  one variant) from one numpy-made state carried by convert.py, with
  the same scalars.  After the first and the third step the particles
  agree to 1e-5 of the box and 1e-4 of the largest momentum, the fluid
  grids to 1e-4 of their largest value.
- example_nonlinnu (matter 8³ with the ν fluid on grid 8, potential 16)
  to a = 0.0201 and example_relativistic shrunk as tests/test_cli_e2e.py
  runs it, through run.run of both packages (the JAX step compiled once
  a run, see _OneVariant): the same steps, Δt hysteresis and limiter;
  the matter and combined-pair spectra to 1 % up to half the Nyquist
  wavenumber and the ν spectrum in all its bins (measured 7e-6 and
  1.7e-3), the realized ν grids to 1e-5, the final states as above.
  example_relativistic runs in float64, where the radiation's δ (~3e-7)
  is resolved: its δ to 5 % of its rms (measured: equal; the δ realized
  at a_begin differs by 2.2 rms).  The ν run reads the EB fixture's
  rows from a cache of its own, as tests/test_torch_boltzmann.py does.

The file holds three tests: pytest-xdist's ``--dist loadfile`` hands out
the files with fewer tests last, so these JAX compiles run while the
long few-test files of the JAX package occupy the other workers."""

import glob
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from concept_tpu import sim_multi as jsm  # noqa: E402
from concept_tpu_torch.convert import from_jax_state  # noqa: E402
from test_torch_sim_multi import (  # noqa: E402
    CONFIGS, ROOT, _assert_states_close, _build, _initial_arrays, _jax_state,
)

NONLINNU = os.path.join(ROOT, "param", "example_nonlinnu.py")
RELATIVISTIC = os.path.join(ROOT, "param", "example_relativistic.py")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "eb", "eb_5c2f1bb77ed40020.npz")
EB_KEY = "41b37a4fde5ce466"  # tests/test_torch_boltzmann.py: today's key of the fixture's rows
NU_OPTIONS = "'modes_per_decade':3,'rtol':1e-4,'n_q':4,'l_max_ncdm':6,'l_max_ur':10,'k_max':3.0"
NU_SHRUNK = ["initial_conditions=[{'species':'matter','N':8**3},"
             "{'species':'neutrino','gridsize':8,'boltzmann order':1}]",
             "potential_options=16", "output_times={'powerspec': [0.0201]}",
             "powerspec_select={'all': True, 'all combinations': True}"]
REL_SHRUNK = ["initial_conditions=[{'species':'matter','N':8**3},"
              "{'name':'linear','species':'radiation','gridsize':16,"
              "'boltzmann order':-1,'boltzmann closure':'class'}]",
              "potential_options=16", "output_times={'powerspec': [0.02]}",
              "boltzmann_options={'modes_per_decade':3,'rtol':1e-4,'l_max_g':10,"
              "'l_max_ur':10,'k_max':0.5}"]
STEPS = 3
PARITY = {"pm_fluids": 1, "p3m_pair_decay": 0}  # 1: the MacCormack fluid's odd steps


@pytest.fixture(autouse=True)
def _jax_cache(tmp_path_factory, monkeypatch):
    """The JAX background caches its tables on disk: a directory of this
    test's."""
    monkeypatch.setenv("CONCEPT_TPU_CACHE", str(tmp_path_factory.mktemp("reusable")))


def _scalars(sim_j, t, dt, t_mom):
    """One step's scalars from the JAX package's host functions, as its
    evolve hands them to the step (float32 arrays), and the same values
    as floats for the port."""
    bg = sim_j.bg
    t_mid = t + 0.5 * dt
    a_kick = float(bg.a_of_t_np(t_mid))
    cf, cp, weff, w = sim_j.fluid_step_scalars(t, t + dt, a_kick, dt)
    decay_fac, decay_gain = sim_j.decay_step_scalars(t, t + dt)
    args = [bg.integral_power_np(t_mom, t_mid, -1.0), bg.integral_power_np(t, t + dt, -2.0),
            dt, cf, cp, a_kick, weff, w, decay_fac, decay_gain]
    lapse = sim_j.lapse_step_scalars(t_mom, t_mid)
    jargs = [jnp.asarray(x, jnp.float32) if isinstance(x, float) else x for x in args]

    def floats(x):
        return {k: float(v) for k, v in x.items()} if isinstance(x, dict) else float(
            np.float32(x))

    return jargs, [floats(x) for x in args], lapse, {k: float(v) for k, v in lapse.items()}


def test_hand_built_steps_match_jax():
    """Both configurations, three steps each (see the module's docstring)."""
    for case in sorted(CONFIGS):
        sim_t, box, rho_crit = _build("torch", case)
        sim_j, _, _ = _build("jax", case)
        arrays = _initial_arrays(case, box, rho_crit)
        st_t, st_j = from_jax_state(arrays), _jax_state(arrays)
        if sim_j.p3m_names:
            sim_j._refresh_sr_capacities(st_j)
            sim_t._refresh_sr_capacities(st_t)
            assert sim_t._sr_caps == sim_j._sr_caps
        bg = sim_j.bg
        a0 = CONFIGS[case]["a0"]
        t = t_mom = float(bg.t_of_a_np(a0))
        dt = 0.9 * sim_j.timestep_size(a0)
        for step in range(1, STEPS + 1):
            jargs, targs, jlapse, tlapse = _scalars(sim_j, t, dt, t_mom)
            st_j = sim_j._step_jit(st_j, *jargs, parity=PARITY[case], lapse_ints=jlapse)
            st_t = sim_t._step(st_t, *targs, parity=PARITY[case], lapse_ints=tlapse)
            if step in (1, STEPS):
                _assert_states_close(st_t, st_j, box, f"{case}, step {step}")
            t_mom, t = t + 0.5 * dt, t + dt


class _OneVariant:
    """The JAX MultiSimulation's jitted step, called with one argument
    structure throughout a run without MacCormack fluids, decaying
    fluids or a lapse component: parity (which only the MacCormack
    solver reads) 0, and the closing kick's missing decay and lapse
    dicts as the empty ones its steps pass (``_step`` treats both alike).
    Each run then compiles its step once, not three times; the
    arithmetic is the JAX package's."""

    def __set__(self, sim, fn):
        sim.__dict__["_one_variant"] = fn

    def __get__(self, sim, owner=None):
        fn = sim.__dict__["_one_variant"]

        def call(state, *args, parity=0, lapse_ints=None):
            args = list(args) + [{}] * (10 - len(args))
            return fn(state, *args, parity=0, lapse_ints=lapse_ints or {})

        assert "maccormack" not in sim.fluid_scheme.values() and not sim.lapse_supplier
        assert not any(s.decay_rate for s in sim.fspecs.values())
        return call


def _spectra(out):
    return {os.path.basename(f).split("_a=")[0]: np.loadtxt(f)
            for f in glob.glob(os.path.join(out, "powerspec_*"))}


def test_nonlinnu_run_matches_jax(tmp_path, monkeypatch):
    """example_nonlinnu shrunk to a = 0.0201 through run.run of both
    packages: the spectra; the same steps, limiter and final a; the
    realized ν grids (ϱ, J, 𝒫 and the shear from the ν tables) to 1e-5;
    softening 0 and the Plummer kernel in both (ROADMAP Queue 3); Σϱ of
    the ν fluid conserved to 1e-5 (or the JAX run's own drift); the final
    states."""
    import concept_tpu.sim_multi
    import concept_tpu_torch.sim_multi
    from concept_tpu.param import load_params as jax_load
    from concept_tpu.run import run as jax_run
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    cache = tmp_path / "eb"
    cache.mkdir()
    shutil.copy(FIXTURE, cache / f"eb_{EB_KEY}.npz")
    realized = []
    monkeypatch.setattr(jsm.MultiSimulation, "_step_jit", _OneVariant(), raising=False)
    for module in (concept_tpu_torch.sim_multi, concept_tpu.sim_multi):
        def keep(*args, _realize=module.realize_fluid_from_linear, **kw):
            realized.append(_realize(*args, **kw))
            return realized[-1]

        monkeypatch.setattr(module, "realize_fluid_from_linear", keep)
    over = NU_SHRUNK + [f"boltzmann_options={{{NU_OPTIONS},'cache_dir':'{cache}'}}"]
    out_t, out_j = tmp_path / "torch", tmp_path / "jax"
    sim, state, a = run(load_params(NONLINNU, overrides=over + [f"output_dirs='{out_t}'"]),
                        device="cpu")
    sim_j, state_j, a_j = jax_run(jax_load(NONLINNU, overrides=over + [
        f"output_dirs='{out_j}'"]))
    assert os.listdir(cache) == [f"eb_{EB_KEY}.npz"], "a table was solved"

    got, want = _spectra(out_t), _spectra(out_j)
    assert sorted(got) == sorted(want) == [
        "powerspec_matter", "powerspec_matter+neutrino", "powerspec_neutrino"]
    for kind in ("matter", "neutrino", "matter+neutrino"):
        P, P_j = got[f"powerspec_{kind}"], want[f"powerspec_{kind}"]
        np.testing.assert_allclose(P[:, 0], P_j[:, 0], rtol=1e-5)
        # the ν grid (8³) has one bin below half its Nyquist: all its bins
        kmax = np.inf if kind == "neutrino" else 0.5 * np.pi * 16 / (200 / 0.67)
        sel = P[:, 0] <= kmax
        assert sel.sum() >= 3 and np.all(np.isfinite(P[:, 2]))
        np.testing.assert_allclose(P[sel, 2], P_j[sel, 2], rtol=0.01, err_msg=kind)

    assert a == pytest.approx(0.0201) and float(a_j) == pytest.approx(0.0201)
    assert sim.hysteresis["step_count"] == sim_j.hysteresis["step_count"] > 100
    for key in ("dt", "dt_min", "t_mom"):
        assert sim.hysteresis[key] == pytest.approx(sim_j.hysteresis[key], rel=1e-12)
    assert sim.timestep_limiter(0.02)[1] == "courant neutrino"
    assert sim.timestep_size(0.02) == pytest.approx(sim_j.timestep_size(0.02), rel=1e-12)
    assert (sim.config.softening, sim.config.softening_kernel) == (
        sim_j.config.softening, sim_j.config.softening_kernel) == (0.0, "plummer")
    got, want = realized
    for field in ("varrho", "J", "P", "sigma"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), field
    rho0 = float(got.varrho.double().sum())
    drift = abs(float(state.fluids["neutrino"].varrho.double().sum()) / rho0 - 1)
    drift_j = abs(float(np.asarray(state_j.fluids["neutrino"].varrho, np.float64).sum())
                  / rho0 - 1)
    assert drift <= max(1e-5, drift_j)
    _assert_states_close(state, state_j, sim.config.boxsize, "final")


def test_relativistic_run_matches_jax(tmp_path, monkeypatch):
    """example_relativistic shrunk, in float64 (the radiation's δ is ~1e-6,
    below float32's resolution of ϱ = ϱ̄(1 + δ)): the same steps; the
    matter spectrum to 1 % up to half the Nyquist wavenumber; the
    radiation's δ, realized anew at every kick, to 5 % of its rms; the
    particles to 1e-5 of the box."""
    from concept_tpu.param import load_params as jax_load
    from concept_tpu.run import run as jax_run
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    monkeypatch.setattr(jsm.MultiSimulation, "_step_jit", _OneVariant(), raising=False)
    over = REL_SHRUNK + ["enable_float64=True"]
    out_t, out_j = tmp_path / "torch", tmp_path / "jax"
    sim, state, a = run(load_params(RELATIVISTIC, overrides=over + [
        f"output_dirs='{out_t}'"]), device="cpu")
    was = jax.config.jax_enable_x64
    try:
        sim_j, state_j, a_j = jax_run(jax_load(RELATIVISTIC, overrides=over + [
            f"output_dirs='{out_j}'"]))  # switches x64 on for the process
        v_j = np.asarray(state_j.fluids["linear"].varrho)
        pos_j = np.asarray(state_j.particles["matter"].pos)
    finally:
        jax.config.update("jax_enable_x64", was)
    v = state.fluids["linear"].varrho.numpy()
    assert v.dtype == v_j.dtype == pos_j.dtype == np.float64
    assert a == pytest.approx(0.02) and float(a_j) == pytest.approx(0.02)
    assert sim.hysteresis["step_count"] == sim_j.hysteresis["step_count"] > 5
    got, want = _spectra(out_t), _spectra(out_j)
    assert sorted(got) == sorted(want) == ["powerspec_linear", "powerspec_matter"]
    P, P_j = got["powerspec_matter"], want["powerspec_matter"]
    sel = P[:, 0] <= 0.5 * np.pi * 16 / 1024
    assert sel.sum() >= 2
    np.testing.assert_allclose(P[sel, 2], P_j[sel, 2], rtol=0.01)
    delta, delta_j = v / v_j.mean() - 1, v_j / v_j.mean() - 1
    rms = float(np.sqrt(np.mean(delta_j**2)))
    assert rms > 0 and np.abs(delta - delta_j).max() <= 0.05 * rms
    assert state.fluids["linear"].J is None and state_j.fluids["linear"].J is None
    box = sim.config.boxsize
    dx = state.particles["matter"].pos.numpy() - pos_j
    dx -= box * np.round(dx / box)
    assert np.abs(dx).max() <= 1e-5 * box
