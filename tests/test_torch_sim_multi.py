"""Several components and fluids: the port's registry
(concept_tpu_torch.forces.registry), MultiSimulation
(concept_tpu_torch.sim_multi) and run_multi / dump_multi / the multi
autosave (concept_tpu_torch.run) vs the JAX package's on the CPU; the
runs of both packages that compile JAX steps are in
tests/test_torch_multi_runs.py, which uses this file's configurations.

- The registry: the four cases of tests/test_registry.py, and the same
  built-in forces as the JAX package's.
- The per-step host functions (Δt limiters, fluid, decay and lapse
  scalars) of two hand-built configurations (PM particles with 'class'
  fluids at orders 0 and 1 and a MacCormack fluid; two P³M components
  with a decaying fluid, its decay product and the lapse component) to
  rtol 1e-12 (the same float64 host arithmetic; the JAX package hands
  the step scalars on in float32, so those to 1e-6), and the fluid
  Courant limit of the full example_nonlinnu (ROADMAP Queue 3: its
  factor a²).
- The closing kick of a segment without the lapse force (ROADMAP Queue
  3), recorded on the port's evolve.
- realize_fluid_from_linear at orders −1, 0 and 1 (EH) to 1e-5.
- The multi autosave and its resume (equal to the uninterrupted run, in
  the run's dtype), component lives, fluid CONCEPT-HDF5 files across the
  packages with
  ``-u info``, and the refusals that remain (a fluid grid too narrow for
  its ranks, under ``-n 2`` and ``-n 2x1`` alike)."""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax.numpy as jnp  # noqa: E402

from concept_tpu import components as jcomp  # noqa: E402
from concept_tpu import sim_multi as jsm  # noqa: E402
from concept_tpu.forces import registry as jreg  # noqa: E402
from concept_tpu_torch import components as tcomp  # noqa: E402
from concept_tpu_torch import sim_multi as tsm  # noqa: E402
from concept_tpu_torch.convert import from_jax_state, to_numpy  # noqa: E402
from concept_tpu_torch.forces import registry as treg  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def _jax_cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("reusable"))


@pytest.fixture(autouse=True)
def _fresh_jax_cache(_jax_cache, monkeypatch):
    """The JAX background caches its tables on disk: a directory of this
    module's."""
    monkeypatch.setenv("CONCEPT_TPU_CACHE", _jax_cache)


# --------------------------------------------------------------------- #
# the registry (tests/test_registry.py)
# --------------------------------------------------------------------- #
def test_builtin_forces_registered():
    reg = treg.registered()
    assert "gravity" in reg and "lapse" in reg
    assert "p3m" in reg["gravity"].methods
    assert {k: v.__dict__ for k, v in reg.items()} == {
        k: v.__dict__ for k, v in jreg.registered().items()}


def test_find_interactions_grouping():
    a = tcomp.ComponentSpec(name="a", species="matter", forces=(("gravity", "p3m"),))
    b = tcomp.ComponentSpec(name="b", species="cdm", forces=(("gravity", "p3m"),))
    c = tcomp.ComponentSpec(name="c", species="neutrino", forces=(("gravity", "pm"),))
    out = treg.find_interactions([a, b, c])
    assert [(f, m, [s.name for s in r]) for f, m, r, _ in out] == [
        (f, m, [s.name for s in r]) for f, m, r, _ in jreg.find_interactions([a, b, c])]
    (f1, m1, recv1, _), (f2, m2, recv2, _) = out
    assert {m1, m2} == {"p3m", "pm"}
    p3m_group = recv1 if m1 == "p3m" else recv2
    assert {s.name for s in p3m_group} == {"a", "b"}


def test_find_interactions_range_split():
    a = tcomp.ComponentSpec(name="a", species="matter", forces=(("gravity", "p3m"),))
    c = tcomp.ComponentSpec(name="c", species="x", forces=(("gravity", "ppnonperiodic"),))
    long = treg.find_interactions([a, c], "long-range")
    short = treg.find_interactions([a, c], "short-range")
    assert [m for _, m, _, _ in long] == ["p3m"]
    assert sorted(m for _, m, _, _ in short) == ["p3m", "ppnonperiodic"]


def test_unknown_method_rejected():
    bad = tcomp.ComponentSpec(name="z", species="matter", forces=(("gravity", "tree"),))
    with pytest.raises(ValueError):
        treg.find_interactions([bad])
    with pytest.raises(KeyError):
        treg.find_interactions([tcomp.ComponentSpec(name="z", species="matter",
                                                    forces=(("magnetism", "pm"),))])


# --------------------------------------------------------------------- #
# hand-built configurations
# --------------------------------------------------------------------- #
BOX = 100.0  # Mpc
GAMMA = 0.3  # the dcdm decay rate, 1/Gyr


def _cosmology(pkg, nu: bool = False):
    """Background and EH linear layer of one package (Ω_m = 0.31, or a
    massive-ν cosmology with Σmν = 0.5 eV)."""
    if pkg == "jax":
        from concept_tpu.cosmology.background import Background
        from concept_tpu.cosmology.linear import LinearCosmology
        from concept_tpu.cosmology.neutrino import NeutrinoBackground
        from concept_tpu.cosmology.primordial import PrimordialSpectrum
        from concept_tpu.units import constants, units
    else:
        from concept_tpu_torch.cosmology.background import Background
        from concept_tpu_torch.cosmology.linear import LinearCosmology
        from concept_tpu_torch.cosmology.neutrino import NeutrinoBackground
        from concept_tpu_torch.cosmology.primordial import PrimordialSpectrum
        from concept_tpu_torch.units import constants, units
    H0 = 67 * units.km / (units.s * units.Mpc)
    nubg, Omega_nu = None, 0.0
    if nu:
        nubg = NeutrinoBackground(m_nu_eV=0.5 / 3, N_nu=3)
        Omega_nu = nubg.omega_nu_h2() / 0.67**2
    bg = Background(H0=H0, Omega_m=0.31, Omega_nu=Omega_nu, nu_background=nubg)
    lin = LinearCosmology(bg, PrimordialSpectrum(A_s=2.1e-9, n_s=0.96, pivot=0.05 / units.Mpc),
                          Omega_b=0.049, Omega_cdm=0.261, light_speed=constants.light_speed,
                          Mpc=units.Mpc, Omega_nu=Omega_nu)
    lin.nu_background = nubg
    return bg, lin, constants, units


def _fluid(name, species, n, w, order, closure="truncate", **kw):
    return dict(name=name, species=species, representation="fluid", gridsize=n, w=w,
                boltzmann_order=order, boltzmann_closure=closure, **kw)


CONFIGS = {
    # PM particles; fluids on grid 8 (potential grid 16): 'class' fluids
    # at orders 0 (ϱ and J re-realized, KT) and 1 (𝒫 re-realized, KT with
    # its own 𝒫; order −1 is example_relativistic's, below), and a
    # constant-w MacCormack fluid with 𝒫 = wϱc² (KT with 𝒫 = wϱc² is the
    # ν fluid's, in example_nonlinnu below)
    "pm_fluids": dict(
        grid=16, a0=0.05, particles=[dict(name="matter", species="matter", N=8**3,
                                          forces=(("gravity", "pm"),))],
        fluids=[_fluid("de", "dark energy", 8, 0.05, 0, "class"),
                _fluid("rad", "radiation", 8, 1 / 3, 1, "class"),
                _fluid("mc", "matter", 8, 0.02, 1)],
        scheme={"mc": "maccormack"}, approx={"rad": False}),
    # two P³M components (self sweeps: row 6; pair sweeps: row 2, on
    # 4³ short-range cells), a decaying fluid credited to a radiation
    # fluid (its ϱ only: order 0), and the lapse component
    "p3m_pair_decay": dict(
        grid=24, a0=0.3, particles=[
            dict(name="cdm", species="cold dark matter", N=8**3, forces=(("gravity", "p3m"),)),
            dict(name="baryon", species="baryon", N=8**3, forces=(("gravity", "p3m"),))],
        fluids=[_fluid("dcdm", "decaying cold dark matter", 8, 0.0, 1, decay_rate=GAMMA,
                       decay_to="dr", forces=(("gravity", "pm"),)),
                _fluid("dr", "radiation", 8, 1 / 3, 0, forces=(("gravity", "pm"),)),
                _fluid("lapse", "lapse", 8, 0.0, 0, forces=(("gravity", "pm"),))],
        scheme={}, approx={}),
}


def _build(pkg, case):
    spec = CONFIGS[case]
    bg, lin, c, units = _cosmology(pkg)
    comp = jcomp if pkg == "jax" else tcomp
    msim = jsm if pkg == "jax" else tsm
    box = BOX * units.Mpc
    rho_crit = bg.rho_crit_of(c.G_Newton)
    pspecs = [comp.ComponentSpec(**p, mass=(0.5 if i else 1.0) * 0.31 * rho_crit * box**3
                                 / p["N"]) for i, p in enumerate(spec["particles"])]
    fspecs = [comp.ComponentSpec(**f) for f in spec["fluids"]]
    if pkg == "jax":
        from concept_tpu.sim import SimConfig

        config = SimConfig(boxsize=box, potential_gridsize=spec["grid"], G=c.G_Newton)
    else:
        from concept_tpu_torch.sim import SimConfig

        config = SimConfig(boxsize=box, potential_gridsize=spec["grid"], G=c.G_Newton,
                           device=torch.device("cpu"), softening_kernel="plummer")
    Omegas = {f.name: 0.01 for f in fspecs}
    sim = msim.MultiSimulation(pspecs, fspecs, config, bg, lin, light_speed=c.light_speed,
                               fluid_Omegas=Omegas, rho_crit=rho_crit,
                               fluid_seeds={f.name: 3 for f in fspecs},
                               fluid_scheme_select=spec["scheme"],
                               approximations=spec["approx"])
    return sim, box, rho_crit


def _initial_arrays(case, box, rho_crit):
    """One state of numpy arrays: lattice particles displaced at random,
    random momenta (mom/m ~ 3 Mpc/Gyr), fluids at 1 % ϱ̄ of their Ω with
    2 % fluctuations and small J, 𝒫 = wc²ϱ where the fluid has 𝒫 (order
    ≥ 1, or the 'class' closure, whose step re-realizes it)."""
    spec = CONFIGS[case]
    rng = np.random.default_rng(7)
    parts = {}
    for i, p in enumerate(spec["particles"]):
        n = round(p["N"] ** (1 / 3))
        q = (np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1).reshape(-1, 3)
             + 0.5) * box / n
        pos = np.mod(q + rng.normal(0, 0.02 * box, q.shape) + 0.13 * i * box / n, box)
        mass = (0.5 if i else 1.0) * 0.31 * rho_crit * box**3 / p["N"]
        parts[p["name"]] = {"pos": pos.astype(np.float32),
                            "mom": (mass * rng.normal(0, 3.0, q.shape)).astype(np.float32)}
    fluids = {}
    for f in spec["fluids"]:
        n = f["gridsize"]
        rho = 0.01 * rho_crit * (1 + 0.02 * rng.standard_normal((n, n, n)))
        state = {"varrho": rho.astype(np.float32), "J": None, "P": None, "sigma": None}
        if f["boltzmann_order"] >= 1 or f["boltzmann_closure"] == "class":
            state["J"] = (1e-3 * rho_crit * rng.standard_normal((3, n, n, n))).astype(np.float32)
            state["P"] = (f["w"] * 306.6**2 * rho).astype(np.float32)
        if f["boltzmann_order"] == -1:
            state["J"] = state["P"] = None
        fluids[f["name"]] = state
    return {"particles": parts, "fluids": fluids}


def _jax_state(arrays):
    return jsm.MultiState(
        particles={k: jcomp.ParticleState(pos=jnp.asarray(v["pos"]), mom=jnp.asarray(v["mom"]))
                   for k, v in arrays["particles"].items()},
        fluids={k: jcomp.FluidState(**{f: None if x is None else jnp.asarray(x)
                                        for f, x in v.items()})
                for k, v in arrays["fluids"].items()})


def _assert_states_close(got, want, box, what):
    """got: the port's MultiState; want: the JAX MultiState."""
    got = to_numpy(got)
    assert set(got["particles"]) == set(want.particles)
    assert set(got["fluids"]) == set(want.fluids)
    for name, ps in want.particles.items():
        dx = got["particles"][name]["pos"] - np.asarray(ps.pos)
        dx -= box * np.round(dx / box)
        assert np.abs(dx).max() <= 1e-5 * box, (what, name, np.abs(dx).max() / box)
        mom = np.asarray(ps.mom)
        err = np.abs(got["particles"][name]["mom"] - mom).max()
        assert err <= 1e-4 * np.abs(mom).max(), (what, name, err / np.abs(mom).max())
    for name, fs in want.fluids.items():
        for field in ("varrho", "J", "P", "sigma"):
            w = getattr(fs, field)
            g = got["fluids"][name].get(field)
            assert (g is None) == (w is None), (what, name, field)
            if w is None:
                continue
            w = np.asarray(w)
            err = np.abs(g - w).max()
            assert err <= 1e-4 * np.abs(w).max(), (what, name, field, err / np.abs(w).max())


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def sims(request):
    """Both packages' MultiSimulation of one configuration (built only:
    their host functions compile nothing), the box and the initial
    state's numpy arrays."""
    case = request.param
    sim_t, box, rho_crit = _build("torch", case)
    sim_j, _, _ = _build("jax", case)
    return {"case": case, "box": box, "sim_t": sim_t, "sim_j": sim_j,
            "arrays": _initial_arrays(case, box, rho_crit)}


@pytest.mark.parametrize("sims", ["p3m_pair_decay"], indirect=True)
def test_closing_kick_skips_the_lapse_force(sims):
    """A segment ends with a half kick that synchronises the momenta: the
    JAX package's evolve calls the step without decay and lapse there
    (concept_tpu/sim_multi.py:888-903), and so does the port's (ROADMAP
    Queue 3; recorded here over a two-step segment of the configuration
    with a decaying fluid and the lapse component).  Every other step's
    kick takes the lapse force."""
    sim_t = sims["sim_t"]
    calls = []
    kick = sim_t._kick
    sim_t._kick = lambda *args, lapse_ints=None: calls.append(lapse_ints) or kick(
        *args, lapse_ints=lapse_ints)
    try:
        a0 = CONFIGS["p3m_pair_decay"]["a0"]
        bg = sim_t.bg
        a1 = float(bg.a_of_t_np(float(bg.t_of_a_np(a0)) + 1.5 * sim_t.timestep_size(a0)))
        sim_t.evolve(from_jax_state(sims["arrays"]), a0, a1)
    finally:
        sim_t._kick = kick
    assert len(calls) == 3 and calls[-1] is None
    assert all(set(c) == {"dcdm"} and c["dcdm"] > 0 for c in calls[:-1])


def test_per_step_scalars_match_jax(sims):
    """timestep_size (and the limiter's name), fluid_step_scalars,
    decay_step_scalars and lapse_step_scalars at several a."""
    sim_t, sim_j = sims["sim_t"], sims["sim_j"]
    bg = sim_t.bg
    for a in (0.03, 0.2, 0.9):
        limits = sim_t.timestep_limits(a)
        assert sim_t.timestep_size(a) == pytest.approx(sim_j.timestep_size(a), rel=1e-12)
        dt, name = sim_t.timestep_limiter(a)
        assert dt == min(limits.values()) and limits[name] == dt
        t0, t1 = float(bg.t_of_a_np(a)), float(bg.t_of_a_np(a * 1.01))
        cf, cp, weff, w = sim_t.fluid_step_scalars(t0, t1, a * 1.005, t1 - t0)
        jcf, jcp, jweff, jw = sim_j.fluid_step_scalars(t0, t1, a * 1.005, t1 - t0)
        for got, want in ((cf, jcf), (cp, jcp), (weff, jweff), (w, jw)):
            assert set(got) == set(want)
            for k in got:
                assert got[k] == pytest.approx(float(want[k]), rel=1e-6)
        for got, want in zip(sim_t.decay_step_scalars(t0, t1), sim_j.decay_step_scalars(t0, t1)):
            assert set(got) == set(want)
            for k in got:
                assert got[k] == pytest.approx(float(want[k]), rel=1e-6)
        got, want = sim_t.lapse_step_scalars(t0, t1), sim_j.lapse_step_scalars(t0, t1)
        assert set(got) == set(want)
        for k in got:
            assert got[k] == pytest.approx(float(want[k]), rel=1e-6)


def test_neutrino_eos_scalars_and_courant_limit_match_jax():
    """The ν fluid's spline EoS in the step scalars, and the Courant limit
    of the full example_nonlinnu (box 200 Mpc/h, ν grid 40): at a = 0.02
    it sets Δt at ~4.0e-7 Gyr in both packages, a factor a² below the
    sound-crossing step 0.21·a·Δx/(c√w) of the KT update (ROADMAP Queue
    3)."""
    sims = {}
    for pkg in ("torch", "jax"):
        bg, lin, c, units = _cosmology(pkg, nu=True)
        comp, msim = (jcomp, jsm) if pkg == "jax" else (tcomp, tsm)
        box = 200 / 0.67 * units.Mpc
        spec = comp.ComponentSpec(**_fluid("neutrino", "neutrino", 40, 0.0, 1))
        mspec = comp.ComponentSpec(name="matter", species="matter", N=80**3,
                                   mass=0.27 * bg.rho_crit_of(c.G_Newton) * box**3 / 80**3,
                                   forces=(("gravity", "p3m"),))
        if pkg == "jax":
            from concept_tpu.sim import SimConfig

            config = SimConfig(boxsize=box, potential_gridsize=40, G=c.G_Newton)
        else:
            from concept_tpu_torch.sim import SimConfig

            config = SimConfig(boxsize=box, potential_gridsize=40, G=c.G_Newton,
                               device=torch.device("cpu"))
        sims[pkg] = (msim.MultiSimulation(
            [mspec], [spec], config, bg, lin, light_speed=c.light_speed,
            eos={"neutrino": comp.EquationOfState.from_neutrino(lin.nu_background)}), box, c)
    (sim_t, box, c), (sim_j, _, _) = sims["torch"], sims["jax"]
    dt, name = sim_t.timestep_limiter(0.02)
    assert name == "courant neutrino"
    assert dt == pytest.approx(sim_j.timestep_size(0.02), rel=1e-12)
    assert dt == pytest.approx(4.0e-7, rel=0.02)
    w = sim_t.eos["neutrino"].w_np(0.02)
    assert w == pytest.approx(0.0104, rel=0.02)
    sound = 0.21 * 0.02 * (box / 40) / (c.light_speed * math.sqrt(w))
    assert dt == pytest.approx(sound * 0.02**2, rel=1e-9)
    bg = sim_t.bg
    for a in (0.02, 0.1, 0.7):
        t0, t1 = float(bg.t_of_a_np(a)), float(bg.t_of_a_np(a * 1.01))
        got = sim_t.fluid_step_scalars(t0, t1, a * 1.005, t1 - t0)
        want = sim_j.fluid_step_scalars(t0, t1, a * 1.005, t1 - t0)
        for g, w_ in zip(got, want):
            assert g["neutrino"] == pytest.approx(float(w_["neutrino"]), rel=1e-6)


@pytest.mark.parametrize("order", [-1, 0, 1])
def test_realize_fluid_from_linear_matches_jax(order):
    """realize_fluid_from_linear of both packages (EH: no σ tables, so no
    shear) at orders −1, 0 and 1, 12³, w = 0.1."""
    out = {}
    for pkg in ("torch", "jax"):
        bg, lin, c, units = _cosmology(pkg)
        comp, msim = (jcomp, jsm) if pkg == "jax" else (tcomp, tsm)
        spec = comp.ComponentSpec(**_fluid("f", "matter", 12, 0.1, order))
        out[pkg] = msim.realize_fluid_from_linear(lin, spec, BOX * units.Mpc, 0.05,
                                                  3.0, seed=5)
    got, want = out["torch"], out["jax"]
    for field in ("varrho", "J", "P", "sigma"):
        w = getattr(want, field)
        g = getattr(got, field)
        assert (g is None) == (w is None), field
        if w is not None:
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), field


# --------------------------------------------------------------------- #
# files: the multi autosave, fluid snapshots, refusals
# --------------------------------------------------------------------- #
BASIC = os.path.join(ROOT, "param", "example_basic.py")
SMALL = ["initial_conditions=[{'species':'matter','N':4**3},"
         "{'name':'dust','species':'matter','gridsize':8,'boltzmann order':1,'w':0.0}]",
         "potential_options=8", "boltzmann_backend='eh'",
         "output_times={'powerspec': [0.025, 0.03]}", "autosave_interval=0"]


@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
def test_multi_autosave_resumes_exactly(tmp_path, monkeypatch, f64):
    """A run interrupted after its first segment's autosave, then run
    again: it resumes from the autosave (the components, a, the events
    and the Δt hysteresis) and ends where the uninterrupted run ends, bit
    for bit, in the run's dtype (the JAX package resumes in float32: a
    departure, ROADMAP Queue 3); the autosave is cleared at the end."""
    from concept_tpu_torch import run as trun
    from concept_tpu_torch.param import load_params

    def cfg(out):
        return load_params(BASIC, overrides=SMALL + [
            f"output_dirs={{'powerspec': '{out}', 'autosave': '{tmp_path}/autosave'}}",
            f"enable_float64={f64}"])

    sim, ref, _ = trun.run(cfg(tmp_path / "ref"), device="cpu")
    assert not os.path.exists(trun.autosave_path(cfg(tmp_path)))
    dump = trun.dump_multi

    def dump_then_stop(*args, **kw):
        dump(*args, **kw)
        raise SystemExit(3)

    monkeypatch.setattr(trun, "dump_multi", dump_then_stop)
    with pytest.raises(SystemExit):
        trun.run(cfg(tmp_path / "cut"), device="cpu")
    monkeypatch.setattr(trun, "dump_multi", dump)
    saved = trun.check_autosave_multi(cfg(tmp_path))
    assert saved is not None and saved[1] == pytest.approx(0.025)
    assert [e[1] for e in saved[2]] == ["powerspec", "powerspec"]
    sim2, got, a = trun.run(cfg(tmp_path / "cut"), device="cpu")
    assert a == pytest.approx(0.03)
    assert sim2.hysteresis == sim.hysteresis
    dtype = torch.float64 if f64 else torch.float32
    for name in ref.particles:
        for field in ("pos", "mom"):
            g, w = getattr(got.particles[name], field), getattr(ref.particles[name], field)
            assert g.dtype == dtype and torch.equal(g, w)
    for field in ("varrho", "J", "P"):
        g, w = getattr(got.fluids["dust"], field), getattr(ref.fluids["dust"], field)
        assert g.dtype == dtype and torch.equal(g, w)
    assert not os.path.exists(trun.autosave_path(cfg(tmp_path)))
    assert (sorted(os.listdir(tmp_path / "cut")) == sorted(os.listdir(tmp_path / "ref")))


def test_multi_trap_resumes_mid_segment_exactly(tmp_path, monkeypatch):
    """SIGTERM after the 5th step of the first segment: the trap's
    autosave holds that step's state and that step's Δt hysteresis (the
    step count and the kick sync point t_mom), and the resumed run ends
    where the uninterrupted run ends, bit for bit.  The hysteresis was
    one step behind the state once, which moved the resumed run by 8.4e-5
    of the box at softening 0 (CDM 8³ + baryons 4³ + a fluid)."""
    import signal

    from concept_tpu_torch import run as trun
    from concept_tpu_torch.param import load_params

    def cfg(out):
        return load_params(BASIC, overrides=SMALL[:-1] + [
            f"output_dirs={{'powerspec': '{out}', 'autosave': '{tmp_path}/autosave'}}"])

    sim, ref, _ = trun.run(cfg(tmp_path / "ref"), device="cpu")
    step, calls = tsm.MultiSimulation._step, [0]

    def hooked(self, *args, **kw):
        out = step(self, *args, **kw)
        calls[0] += 1
        if calls[0] == 5:
            signal.raise_signal(signal.SIGTERM)
        return out

    monkeypatch.setattr(tsm.MultiSimulation, "_step", hooked)
    with pytest.raises(SystemExit):
        trun.run(cfg(tmp_path / "cut"), device="cpu")
    monkeypatch.setattr(tsm.MultiSimulation, "_step", step)
    saved = trun.check_autosave_multi(cfg(tmp_path))
    assert saved[1] < 0.025 and saved[3]["step_count"] == 5
    sim2, got, a = trun.run(cfg(tmp_path / "cut"), device="cpu")
    assert a == pytest.approx(0.03) and sim2.hysteresis == sim.hysteresis
    for field in ("pos", "mom"):
        assert torch.equal(getattr(got.particles["matter"], field),
                           getattr(ref.particles["matter"], field)), field
    for field in ("varrho", "J", "P"):
        assert torch.equal(getattr(got.fluids["dust"], field),
                           getattr(ref.fluids["dust"], field)), field


def test_component_lives_activate_and_terminate(tmp_path):
    """select_lives: a fluid alive from a = 0.025 to 0.035 is realized at
    its activation, dumped at 0.03 and gone at 0.04 (the JAX package's
    run of the same file writes the same three spectra)."""
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    cfg = load_params(BASIC, overrides=SMALL[:3] + [
        "select_lives={'dust': (0.025, 0.035)}", "output_times={'powerspec': [0.03, 0.04]}",
        f"output_dirs='{tmp_path}'"])
    sim, state, a = run(cfg, device="cpu")
    assert a == pytest.approx(0.04)
    assert sorted(os.listdir(tmp_path)) == [
        "powerspec_dust_a=0.03.txt", "powerspec_matter_a=0.03.txt", "powerspec_matter_a=0.04.txt"]
    assert list(state.particles) == ["matter"] and not state.fluids


def test_fluid_snapshots_cross_the_packages(tmp_path, capsys):
    """A multi-component CONCEPT-HDF5 snapshot written by the port (a
    particle component and a fluid with ϱ, J, 𝒫, ς) reads back in the JAX
    package field for field, and the JAX package's in the port; ``-u
    info`` of both packages prints the same lines for it."""
    pytest.importorskip("h5py")
    from concept_tpu.io import snapshot as jsnap
    from concept_tpu_torch.io import snapshot as snap

    rng = np.random.default_rng(4)
    n = 4
    arrays = {"pos": rng.uniform(0, 10, (27, 3)), "mom": rng.normal(size=(27, 3)),
              "varrho": rng.uniform(1, 2, (n, n, n)), "J": rng.normal(size=(3, n, n, n)),
              "P": rng.uniform(0, 1, (n, n, n)), "sigma": rng.normal(size=(6, n, n, n))}
    specs = {}
    for pkg, comp in (("torch", tcomp), ("jax", jcomp)):
        specs[pkg] = {"m": comp.ComponentSpec(name="m", species="matter", N=27, mass=2.5),
                      "nu": comp.ComponentSpec(**_fluid("nu", "neutrino", n, 0.2, 2, "class"))}
    t_state = {"m": tcomp.ParticleState(pos=torch.as_tensor(arrays["pos"]),
                                        mom=torch.as_tensor(arrays["mom"])),
               "nu": tcomp.FluidState(*(torch.as_tensor(arrays[k])
                                        for k in ("varrho", "J", "P", "sigma")))}
    j_state = {"m": jcomp.ParticleState(pos=arrays["pos"], mom=arrays["mom"]),
               "nu": jcomp.FluidState(varrho=arrays["varrho"], J=arrays["J"], P=None,
                                      sigma=None)}
    for writer, reader, pkg, state, fn in (
            (snap, jsnap, "torch", t_state, tmp_path / "port.hdf5"),
            (jsnap, snap, "jax", j_state, tmp_path / "jax.hdf5")):
        meta = writer.SnapshotMeta(a=0.1, boxsize=10.0, H0=0.07, Omega_b=0.05, Omega_cdm=0.26)
        writer.save_concept(str(fn), meta, {k: (specs[pkg][k], state[k]) for k in state})
        _, comps = reader.load_concept(str(fn))
        assert sorted(comps) == ["m", "nu"]
        spec, fl = comps["nu"]
        assert (spec.representation, spec.gridsize, spec.w, spec.boltzmann_order,
                spec.boltzmann_closure) == ("fluid", n, 0.2, 2, "class")
        for field in ("varrho", "J", "P", "sigma"):
            want = getattr(state["nu"], field)
            if want is None:
                assert getattr(fl, field) is None
            else:
                np.testing.assert_array_equal(getattr(fl, field), np.asarray(want))
        np.testing.assert_array_equal(comps["m"][1].pos, arrays["pos"])
    from concept_tpu import utilities as jutil
    from concept_tpu_torch import utilities as tutil

    printed = []
    for util in (tutil, jutil):
        capsys.readouterr()
        util.util_info([str(tmp_path / "port.hdf5")], None)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and "fluid gridsize=4" in printed[0]


def test_kept_refusals_name_their_items(tmp_path):
    """A multi run over ranks raises ValueError, before anything is
    realized, where a fluid grid leaves a rank fewer rows than its stencil
    reaches (run.check_multi_layout), under ``-n 2x1`` as under ``-n 2``:
    several components run over the A·B ranks of ``-n AxB`` as over those
    of ``-n A·B`` (runs over ranks that can run are
    tests/test_torch_parallel_multi.py's and
    tests/test_torch_parallel_pencils.py's).  Its renders (item 13) are
    ported: tests/test_torch_render.py runs them."""
    from concept_tpu_torch import run as trun
    from concept_tpu_torch.param import load_params

    narrow = [SMALL[0].replace("'gridsize':8", "'gridsize':3")]
    cfg = load_params(BASIC, overrides=SMALL + narrow + [f"output_dirs='{tmp_path}'"])
    for n in ("2x1", 2):
        with pytest.raises(ValueError, match="fluid grid 3 of 'dust' over 2 ranks leaves a "
                                             "rank 1 rows"):
            trun.run(cfg, device="cpu", n_devices=n)
    assert not os.listdir(tmp_path)
