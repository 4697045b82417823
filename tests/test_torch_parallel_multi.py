"""Several components and fluids over ranks of their own processes
(``gloo`` on the CPU, parallel/ranks.Ranks with this process as rank 0):
each rank holds the index shard of every particle component and its
x-rows of every fluid grid (sim_multi.MultiSimulation(dist=...),
sim_multi.shard_multi_state).

(1) The fluid stencils on a rank's rows with their halo
(parallel/step.halo_rows): ``kt_step`` at RK order 1 and 2, with and
without ς, four limiters; ``maccormack_step`` at both parities;
``vacuum_redistribute`` + ``vacuum_correct``, over 2 and 4 ranks on a
16³ grid and over 4 on an 18-row grid (5 + 4 + 5 + 4 rows), each
``torch.equal`` to the whole grid's rows.
(2) The ς grids and a fluid's realization over 2 and 4 ranks
(``ic.realize_sigma_grids(dist=)``, ``realize_fluid_from_linear(dist=)``
at order 1 with the example_nonlinnu ν tables of the EB fixture) against
one device's rows within 1e-5 of the largest value: the slab FFT
transforms along the axes one at a time where ``irfftn`` does them at
once, so the two round differently (tests/test_torch_parallel_realize.py
holds δ(k) to the same bound); the noise rows are one device's bit for
bit there.
(3) The step: tests/test_fluid_distributed.py's state (the 16³ 'dust'
fluid beside 8³ CDM, PM, a = 0.05 → 0.06) through
``MultiSimulation(dist=).evolve`` over 2 and 4 ranks against the port on
one process and against the JAX package's ``MultiSimulation.evolve`` on
that state sharded by its own ``shard_multi_state`` over 2 host devices,
at that test's bounds (ϱ 2e-6 and J 2e-5 of their largest, positions
1e-5 of the box); and the two hand-built configurations of
tests/test_torch_sim_multi.py (PM particles with 'class' fluids at
orders 0 and 1 re-realized every kick and a MacCormack fluid with its
vacuum passes, on grid 8 under potential grid 16; two P³M components at
softening 0, the plain versions of PERF.md rows 6 and 2, a decaying
fluid, its product and the lapse component) for three steps with the
same scalars over 2 and 4 ranks against one process: positions 1e-5 of
the box, each receiver's momentum within 1e-5 of the largest momentum
change, fluid grids within 1e-5 of their largest.
(4) Runs through ``run(cfg, n_devices=2)``: example_nonlinnu shrunk (8³
matter, the ν fluid on grid 8, potential 16, in float64, where the ν's
δ ~ 1e-4 is resolved), CDM 8³ + baryons 4³ at potential 16 and
example_relativistic shrunk (float64): every spectrum within rtol 1e-4
of ``-n 1``'s, and the CDM + baryon one against the JAX package's
``-n 2`` run at tests/test_torch_multi_runs.py's tolerance (1 % up to
half the Nyquist wavenumber).  With equal N the two components are
realized as twins (the same lattice and displacements), which at
softening 0 separate at the rounding of rows 6 and 2 and then feel
forces that no two summation orders share: such a run is chaotic on one
device already, so these runs take unequal N.
(5) What cannot run over the ranks raises ValueError before anything is
realized (run.check_multi_layout; ``ic.realize_particles`` and
``realize_fluid_from_linear`` patched to record calls).
(6) An autosave over ranks (SIGTERM to rank 0 of a -n 2 run with a
fluid, the snapshot and bispectra dumped by rank 0) resumed under -n 1
and -n 2 to the same end.

The module fixture starts four ranks once: ranks 0-3 run the d = 4
cases, ranks 0-1 then the d = 2 cases, while rank 2 leaves the group for
the one-device steps, the relativistic runs of (4) and the runs of (6),
and rank 3 for the ν runs of (4) (each ``-n 2`` run starts a rank of its
own); then rank 0 (this process, with tests/conftest.py's host devices)
runs the JAX package's sharded step and the CDM + baryon runs, rank 1
the JAX package's ``-n 2`` run.  JAX is imported inside the functions that use it.
"""

import functools
import glob
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

from concept_tpu_torch.parallel.ranks import Ranks, init_rank  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "eb", "eb_5c2f1bb77ed40020.npz")
EB_KEY = "41b37a4fde5ce466"  # tests/test_torch_boltzmann.py: today's key of the fixture's rows
NU_OPTIONS = "'modes_per_decade':3,'rtol':1e-4,'n_q':4,'l_max_ncdm':6,'l_max_ur':10,'k_max':3.0"

# (1): case → (kind, grid, options, world sizes)
STENCILS = {
    "kt_rk2_mc_sigma": ("kt", 16, dict(rk_order=2, limiter="mc", sigma=True), (2, 4)),
    "kt_rk1_minmod": ("kt", 16, dict(rk_order=1, limiter="minmod", sigma=False), (2, 4)),
    "kt_rk2_vanleer_sigma_uneven": ("kt", 18, dict(rk_order=2, limiter="vanleer", sigma=True),
                                    (4,)),
    "kt_rk1_superbee_wrho_uneven": ("kt", 18, dict(rk_order=1, limiter="superbee",
                                                   sigma=False, approx=True), (4,)),
    "maccormack_even": ("mc", 16, dict(parity=0), (2, 4)),
    "maccormack_odd": ("mc", 16, dict(parity=1), (2, 4)),
    "maccormack_odd_uneven": ("mc", 18, dict(parity=1), (4,)),
    "vacuum": ("vacuum", 16, {}, (2, 4)),
    "vacuum_uneven": ("vacuum", 18, {}, (4,)),
}
# (3): the hand-built configurations of tests/test_torch_sim_multi.py
HAND_BUILT = ("pm_fluids", "p3m_pair_decay")
PARITY = {"pm_fluids": 1, "p3m_pair_decay": 0}
STEPS = 3
# (4): name → (parameter file, overrides)
RUNS = {
    "nonlinnu": ("example_nonlinnu.py", [
        "initial_conditions=[{'species':'matter','N':8**3},"
        "{'species':'neutrino','gridsize':8,'boltzmann order':1}]",
        "potential_options=16", "output_times={'powerspec': [0.02005]}",
        "powerspec_select={'all': True, 'all combinations': True}", "enable_float64=True"]),
    "cdm_baryon": ("example_basic.py", [
        "initial_conditions=[{'species':'cold dark matter','N':8**3},"
        "{'species':'baryon','N':4**3}]", "potential_options=16",
        "output_times={'powerspec': [0.03]}",
        "powerspec_select={'all': True, 'all combinations': True}"]),
    "relativistic": ("example_relativistic.py", [
        "initial_conditions=[{'species':'matter','N':8**3},{'name':'linear','species':"
        "'radiation','gridsize':16,'boltzmann order':-1,'boltzmann closure':'class'}]",
        "potential_options=16", "output_times={'powerspec': [0.02]}",
        "boltzmann_options={'modes_per_decade':3,'rtol':1e-4,'l_max_g':10,"
        "'l_max_ur':10,'k_max':0.5}", "enable_float64=True"]),
}
JAX_RUN = "cdm_baryon"


# --------------------------------------------------------------------- #
# (1) the stencils
# --------------------------------------------------------------------- #
def _stencil_inputs(case):
    """The whole grids of a case, from a numpy seed: ϱ ~ 1 with 30 %
    fluctuations (a few cells below the vacuum density 0.75 for the
    vacuum cases), small J, 𝒫 and ς."""
    kind, n, _, _ = STENCILS[case]
    rng = np.random.default_rng(sorted(STENCILS).index(case))
    rho = 1.0 + 0.3 * rng.standard_normal((n, n, n))
    if kind == "vacuum":
        rho = np.where(rng.random((n, n, n)) < 0.05, 0.1, np.abs(rho))
    return {"rho": torch.as_tensor(rho, dtype=torch.float32),
            "J": torch.as_tensor(0.05 * rng.standard_normal((3, n, n, n)), dtype=torch.float32),
            "P": torch.as_tensor(0.1 * rng.random((n, n, n)), dtype=torch.float32),
            "sigma": torch.as_tensor(0.01 * rng.standard_normal((6, n, n, n)),
                                     dtype=torch.float32)}


def _stencil(case, dist=None):
    """The case's solver on the whole grids (``dist`` None) or on this
    rank's x-rows of them: its outputs."""
    from concept_tpu_torch import fluid

    kind, n, opts, _ = STENCILS[case]
    g = _stencil_inputs(case)
    if dist is not None:
        x0, rows = dist.rows(n)
        g = {k: v[..., x0:x0 + rows, :, :] for k, v in g.items()}
    box, dt, cf, cp = 10.0, 0.02, 0.9, 1.1
    if kind == "kt":
        return fluid.kt_step(g["rho"], g["J"], g["P"], dt, cf, cp, box, 0.3, 0.5,
                             limiter=opts["limiter"], rk_order=opts["rk_order"],
                             approx_P_eq_wrho=opts.get("approx", False), w=0.2,
                             sigma=g["sigma"] if opts["sigma"] else None, dist=dist)
    if kind == "mc":
        return fluid.maccormack_step(g["rho"], g["J"], g["P"], dt, cf, cp, box, 0.5,
                                     step_parity=opts["parity"], approx_P_eq_wrho=False,
                                     dist=dist)
    rho, J = fluid.vacuum_redistribute(g["rho"], g["J"], 0.75, smoothing=1.0, passes=2,
                                       dist=dist)
    return fluid.vacuum_correct(rho, J, 0.5)


# --------------------------------------------------------------------- #
# (2) the ς grids and a fluid's realization
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _nu_cosmology(cache):
    """example_nonlinnu's cosmology with the EB fixture's ν tables (read
    from ``cache``): (lin, box, the ν spec, ϱ̄_ν, its EoS)."""
    from concept_tpu_torch.components import ComponentSpec, EquationOfState
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import build_cosmology

    cfg = load_params(os.path.join(ROOT, "param", "example_nonlinnu.py"), overrides=[
        f"boltzmann_options={{{NU_OPTIONS},'cache_dir':'{cache}'}}"])
    units, consts, bg, lin = build_cosmology(cfg)
    spec = ComponentSpec(name="neutrino", species="neutrino", representation="fluid",
                         gridsize=12, w=0.0, boltzmann_order=1)
    return (lin, cfg.boxsize, spec, lin.Omega_nu * bg.rho_crit_of(consts.G_Newton),
            EquationOfState.from_neutrino(lin.nu_background))


def _realized(cache, dist=None):
    """ς at n = 12 and the ν fluid's realization (order 1: ϱ, J, 𝒫, ς) at
    a = 0.02, whole or this rank's rows."""
    from concept_tpu_torch.ic import realize_sigma_grids
    from concept_tpu_torch.sim_multi import realize_fluid_from_linear

    lin, box, spec, rho_mean, eos = _nu_cosmology(cache)
    sigma = realize_sigma_grids(lin, 12, box, 0.02, rho_mean, seed=2, species="nu", dist=dist)
    fl = realize_fluid_from_linear(lin, spec, box, 0.02, rho_mean, seed=2, eos=eos, dist=dist)
    return {"sigma": sigma, **fl._asdict()}


def _eb_cache(outdir):
    cache = os.path.join(outdir, "eb")
    os.makedirs(cache, exist_ok=True)
    shutil.copy(FIXTURE, os.path.join(cache, f"eb_{EB_KEY}.npz"))
    return cache


# --------------------------------------------------------------------- #
# (3) the step
# --------------------------------------------------------------------- #
def _dust_setup():
    """tests/test_fluid_distributed.py's units, background, box, ϱ̄ and
    specs, the port's."""
    from concept_tpu_torch.components import ComponentSpec
    from concept_tpu_torch.cosmology.background import Background
    from concept_tpu_torch.units import constants, units

    H0 = 67 * units.km / (units.s * units.Mpc)
    box = 1024 * units.Mpc
    bg = Background(H0=H0, Omega_m=0.319)
    G = constants.G_Newton
    rho_mean = 0.319 * bg.rho_crit_of(G)
    pspec = ComponentSpec(name="cdm", species="matter", N=8**3, mass=0.5 * rho_mean * box**3 / 8**3)
    fspec = ComponentSpec(name="dust", species="matter", representation="fluid", gridsize=16,
                          w=0.0, boltzmann_order=1)
    return bg, box, G, rho_mean, pspec, fspec, constants.light_speed


def _dust_arrays():
    """tests/test_fluid_distributed.py's _make_state as numpy arrays."""
    import math

    _, box, _, rho_mean, _, _, _ = _dust_setup()
    ng = 16
    rng = np.random.default_rng(0)
    x = (np.arange(ng) + 0.5) * box / ng
    delta = (0.01 * np.cos(2 * math.pi * 2 / box * x)[:, None, None]
             + 0.008 * np.sin(2 * math.pi / box * x)[None, :, None]) * np.ones((ng,) * 3)
    J = 0.002 * rho_mean * rng.standard_normal((3, ng, ng, ng))
    lin = (np.arange(8) + 0.5) * box / 8
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1).reshape(-1, 3)
    pos = (grid + rng.normal(0, 0.05 * box / 8, (8**3, 3))) % box
    return {"particles": {"cdm": {"pos": pos.astype(np.float32),
                                  "mom": np.zeros((8**3, 3), np.float32)}},
            "fluids": {"dust": {"varrho": (rho_mean * (1 + delta)).astype(np.float32),
                                "J": J.astype(np.float32),
                                "P": np.zeros((ng,) * 3, np.float32), "sigma": None}}}


def _dust_evolve(dist=None):
    """The dust state from a = 0.05 to 0.06, whole on every rank."""
    from concept_tpu_torch.convert import from_jax_state
    from concept_tpu_torch.sim import SimConfig
    from concept_tpu_torch.sim_multi import MultiSimulation

    bg, box, G, _, pspec, fspec, c = _dust_setup()
    sim = MultiSimulation([pspec], [fspec], SimConfig(boxsize=box, potential_gridsize=16, G=G,
                                                      device=CPU), bg, light_speed=c, dist=dist)
    state, _ = sim.evolve(sim.shard(from_jax_state(_dust_arrays())), 0.05, 0.06, max_steps=50)
    return {"state": sim.whole(state), "steps": sim.hysteresis["step_count"]}


def _hand_built_steps(case, dist=None):
    """STEPS steps of a configuration of tests/test_torch_sim_multi.py
    with the JAX package's host scalars (as tests/test_torch_multi_runs.py
    takes them, from the port's own host functions here), whole on every
    rank after each step."""
    from test_torch_sim_multi import CONFIGS, _build, _initial_arrays

    from concept_tpu_torch.convert import from_jax_state

    sim, box, rho_crit = _build("torch", case)
    sim.dist = dist
    st = sim.shard(from_jax_state(_initial_arrays(case, box, rho_crit)))
    if sim.p3m_names:
        sim._refresh_sr_capacities(st)
    bg = sim.bg
    a0 = CONFIGS[case]["a0"]
    t = t_mom = float(bg.t_of_a_np(a0))
    dt = 0.9 * sim.timestep_size(a0)
    start, out = sim.whole(st), []
    for _ in range(STEPS):
        t_mid = t + 0.5 * dt
        a_kick = float(bg.a_of_t_np(t_mid))
        cf, cp, weff, w = sim.fluid_step_scalars(t, t + dt, a_kick, dt)
        fac, gain = sim.decay_step_scalars(t, t + dt)
        st = sim._step(st, bg.integral_power_np(t_mom, t_mid, -1.0),
                       bg.integral_power_np(t, t + dt, -2.0), dt, cf, cp, a_kick, weff, w,
                       fac, gain, parity=PARITY[case],
                       lapse_ints=sim.lapse_step_scalars(t_mom, t_mid))
        out.append(sim.whole(st))
        t_mom, t = t_mid, t + dt
    return {"start": start, "steps": out, "caps": dict(getattr(sim, "_sr_caps", {})),
            "box": box}


def _jax_dust():
    """The JAX package's MultiSimulation.evolve of the dust state sharded
    by its shard_multi_state over 2 host devices (tests/conftest.py's),
    as the port's MultiState."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from concept_tpu.components import ComponentSpec as JSpec
    from concept_tpu.components import FluidState as JFluid
    from concept_tpu.components import ParticleState as JParticles
    from concept_tpu.cosmology.background import Background as JBackground
    from concept_tpu.grid.fft import GridDistribution as JDist
    from concept_tpu.sim import SimConfig as JConfig
    from concept_tpu.sim_multi import MultiSimulation as JMulti
    from concept_tpu.sim_multi import MultiState as JState
    from concept_tpu.sim_multi import shard_multi_state as jshard
    from concept_tpu.units import constants, units

    from concept_tpu_torch.convert import from_jax_multi

    box = _dust_setup()[1]
    arrays = _dust_arrays()
    H0 = 67 * units.km / (units.s * units.Mpc)
    jbg = JBackground(H0=H0, Omega_m=0.319)
    rho_mean = 0.319 * jbg.rho_crit_of(constants.G_Newton)
    jsim = JMulti([JSpec(name="cdm", species="matter", N=8**3,
                         mass=0.5 * rho_mean * box**3 / 8**3)],
                  [JSpec(name="dust", species="matter", representation="fluid", gridsize=16,
                         w=0.0, boltzmann_order=1)],
                  JConfig(boxsize=box, potential_gridsize=16, G=constants.G_Newton), jbg,
                  light_speed=constants.light_speed)
    jstate = JState(
        particles={"cdm": JParticles(**{k: jnp.asarray(v) for k, v in
                                        arrays["particles"]["cdm"].items()})},
        fluids={"dust": JFluid(**{k: None if v is None else jnp.asarray(v)
                                  for k, v in arrays["fluids"]["dust"].items()})})
    jdist = JDist(mesh=Mesh(np.array(jax.devices()[:2]), ("x",)), axis="x")
    jout, _ = jsim.evolve(jshard(jstate, jdist), 0.05, 0.06, max_steps=50)
    return from_jax_multi(jout)


# --------------------------------------------------------------------- #
# (4) the runs
# --------------------------------------------------------------------- #
def _cfg(name, out, cache, more=()):
    from concept_tpu_torch.param import load_params

    param, over = RUNS[name]
    if name == "nonlinnu":
        over = over + [f"boltzmann_options={{{NU_OPTIONS},'cache_dir':'{cache}'}}"]
    return load_params(os.path.join(ROOT, "param", param),
                       overrides=over + [f"output_dirs='{out}'", *more])


def _runs(outdir, names):
    """The runs of (4) at -n 1 and -n 2, in outdir/<name><n>."""
    from concept_tpu_torch.run import run

    cache = _eb_cache(outdir)
    for name in names:
        for n in (1, 2):
            sim, _, a = run(_cfg(name, os.path.join(outdir, f"{name}{n}"), cache),
                            device="cpu", n_devices=n)
            torch.save({"a": a, "steps": sim.hysteresis["step_count"]},
                       os.path.join(outdir, f"{name}{n}.pt"))


# (6): an autosave over ranks and its resume
AUTOSAVE = ["initial_conditions=[{'species':'cold dark matter','N':8**3},"
            "{'species':'baryon','N':4**3},{'name':'dust','species':'matter','gridsize':8,"
            "'boltzmann order':1,'w':0.0}]", "potential_options=16", "boltzmann_backend='eh'",
            "output_times={'powerspec': [0.025, 0.03], 'snapshot': [0.025], "
            "'bispec': [0.025]}"]


def _autosave_runs(outdir):
    """A -n 2 run with a fluid, SIGTERM in this process (rank 0) after its
    8th step: the ranks agree on it and rank 0 writes the autosave from
    the rows the others send; then that autosave resumed under -n 1 and,
    from a copy, under -n 2."""
    import signal

    from concept_tpu_torch import sim_multi
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    def cfg(out, more=()):
        return load_params(os.path.join(ROOT, "param", "example_basic.py"),
                           overrides=AUTOSAVE + [f"output_dirs='{out}'", *more])

    d = os.path.join(outdir, "autosave")
    os.makedirs(d)
    os.chdir(d)
    step, calls = sim_multi.MultiSimulation._step, [0]

    def hooked(self, *args, **kw):
        out = step(self, *args, **kw)
        calls[0] += 1
        if calls[0] == 8:
            signal.raise_signal(signal.SIGTERM)
        return out

    sim_multi.MultiSimulation._step = hooked
    code = None
    try:
        run(cfg("two", ["autosave_interval=0"]), device="cpu", n_devices=2)
    except SystemExit as e:
        code = e.code
    finally:
        sim_multi.MultiSimulation._step = step
    out = {"code": code, "saved": sorted(os.listdir(os.path.join("two", "example_basic")))}
    shutil.copytree("two", "two_again")
    for run_dir, n in (("two", 1), ("two_again", 2)):
        _, state, a = run(cfg(run_dir), device="cpu", n_devices=n)
        out[n] = (state, a, sorted(os.listdir(run_dir)))
    torch.save(out, "autosave.pt")


def _jax_run(outdir):
    """The JAX package's -n 2 run of JAX_RUN on two host devices."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from concept_tpu.param import load_params as jax_load
    from concept_tpu.run import run as jax_run

    param, over = RUNS[JAX_RUN]
    jax_run(jax_load(os.path.join(ROOT, "param", param),
                     overrides=over + [f"output_dirs='{os.path.join(outdir, 'jax2')}'"]),
            n_devices=2)


def _spectra(out):
    return {os.path.basename(f).split("_a=")[0]: np.loadtxt(f)
            for f in glob.glob(os.path.join(out, "powerspec_*"))}


# --------------------------------------------------------------------- #
# the fixture
# --------------------------------------------------------------------- #
def _rank_work(outdir, rank):
    """A rank's part of the fixture (see the module's docstring)."""
    import torch.distributed as tdist

    from concept_tpu_torch.grid.fft import GridDistribution

    r, store = rank
    init_rank(r, 4, store, CPU)
    four, pair = tdist.new_group([0, 1, 2, 3]), tdist.new_group([0, 1])
    cache = _eb_cache(os.path.join(outdir, f"rank{r}"))
    for d, group in ((4, four), (2, pair)):
        if r >= d:
            break
        dist = GridDistribution(group)
        out = {"stencils": {case: _stencil(case, dist) for case, (*_, worlds) in
                            STENCILS.items() if d in worlds},
               "realized": _realized(cache, dist), "rows": {n: dist.rows(n) for n in (12, 16, 18)}}
        step = {"dust": _dust_evolve(dist),
                **{case: _hand_built_steps(case, dist) for case in HAND_BUILT}}
        if r == 0:
            out.update(step)
        torch.save(out, os.path.join(outdir, f"d{d}_rank{r}.pt"))
    tdist.destroy_process_group()
    if r == 0:
        torch.save(_jax_dust(), os.path.join(outdir, "jax_dust.pt"))
        _runs(outdir, ("cdm_baryon",))
    elif r == 1:
        _jax_run(outdir)
    elif r == 2:
        torch.save({"dust": _dust_evolve(), **{c: _hand_built_steps(c) for c in HAND_BUILT},
                    "realized": _realized(cache)}, os.path.join(outdir, "one.pt"))
        _runs(outdir, ("relativistic",))
        _autosave_runs(outdir)
    else:
        _runs(outdir, ("nonlinnu",))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four ranks started once: {d: [each rank's results]}, 'one': the
    one-process results, 'dir': the runs' directory."""
    outdir = str(tmp_path_factory.mktemp("multi"))
    with Ranks(4, CPU) as started:
        started.start(_rank_work, outdir)
        _rank_work(outdir, rank=(0, started.store))
    out = {d: [torch.load(os.path.join(outdir, f"d{d}_rank{r}.pt"), weights_only=False)
               for r in range(d)] for d in (2, 4)}
    out.update(one=torch.load(os.path.join(outdir, "one.pt"), weights_only=False), dir=outdir,
               jax_dust=torch.load(os.path.join(outdir, "jax_dust.pt"), weights_only=False))
    return out


# --------------------------------------------------------------------- #
# the tests
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case, d", [(c, d) for c, (*_, w) in STENCILS.items() for d in w])
def test_fluid_stencils_over_ranks_bit_for_bit(ranks, case, d):
    """Each rank's outputs are the whole grid's rows, bit for bit."""
    n = STENCILS[case][1]
    whole = _stencil(case)
    for r, res in enumerate(ranks[d]):
        x0, rows = res["rows"][n]
        assert rows >= 4, (case, d, r)
        for got, want in zip(res["stencils"][case], whole):
            if want is None:
                assert got is None
                continue
            assert torch.equal(got, want[..., x0:x0 + rows, :, :]), (case, d, r)


@pytest.mark.parametrize("d", [2, 4])
def test_realized_sigma_and_fluid_over_ranks(ranks, d):
    """ς and the ν fluid's ϱ, J, 𝒫, ς on each rank's rows within 1e-5 of
    one device's largest value (the slab FFT's rounding)."""
    one = ranks["one"]["realized"]
    for r, res in enumerate(ranks[d]):
        x0, rows = res["rows"][12]
        for field, want in one.items():
            got = res["realized"][field]
            assert (got is None) == (want is None), field
            if want is None:
                continue
            err = (got - want[..., x0:x0 + rows, :, :]).abs().max()
            assert err <= 1e-5 * want.abs().max(), (d, r, field, float(err))
    assert one["sigma"] is not None  # the ν tables hold σ


def _close_states(got, want, box, what, dmom_ref=None):
    """Positions within 1e-5 of the box, momenta within 1e-5 of the
    largest momentum change (``dmom_ref``) or of the largest momentum,
    each fluid grid within 1e-5 of its largest value (ϱ 2e-6 and J 2e-5
    in the dust state, tests/test_fluid_distributed.py's bounds)."""
    for name, ps in want.particles.items():
        dx = got.particles[name].pos.double() - ps.pos.double()
        dx -= box * torch.round(dx / box)
        assert float(dx.abs().max()) <= 1e-5 * box, (what, name)
        scale = (dmom_ref[name] if dmom_ref else ps.mom).abs().max()
        err = (got.particles[name].mom - ps.mom).abs().max()
        assert err <= 1e-5 * scale, (what, name, float(err / scale))
    for name, fs in want.fluids.items():
        for field, w in fs._asdict().items():
            g = getattr(got.fluids[name], field)
            assert (g is None) == (w is None), (what, name, field)
            if w is None:
                continue
            tol = {"varrho": 2e-6, "J": 2e-5}.get(field, 1e-5) if name == "dust" else 1e-5
            err = (g - w).abs().max()
            assert err <= tol * w.abs().max(), (what, name, field, float(err / w.abs().max()))


def test_step_over_ranks_matches_one_process_and_jax(ranks):
    """The dust state over 2 and 4 ranks against one process, and the
    JAX package's evolve of that state sharded over 2 host devices; the
    hand-built configurations over 2 and 4 ranks against one process,
    each receiver's momentum held to the largest change of a step."""
    one = ranks["one"]
    box = _dust_setup()[1]
    for d in (2, 4):
        res = ranks[d][0]
        assert res["dust"]["steps"] == one["dust"]["steps"] > 1
        _close_states(res["dust"]["state"], one["dust"]["state"], box, f"dust, d = {d}")
        for case in HAND_BUILT:
            assert res[case]["caps"] == one[case]["caps"]
            ref = {name: one[case]["steps"][0].particles[name].mom - ps.mom
                   for name, ps in one[case]["start"].particles.items()}
            for step, (got, want) in enumerate(zip(res[case]["steps"], one[case]["steps"])):
                _close_states(got, want, one[case]["box"], f"{case}, d = {d}, step {step}",
                              ref)
    want = ranks["jax_dust"]
    for d in (2, 4):
        _close_states(ranks[d][0]["dust"]["state"], want, box, f"dust against JAX, d = {d}",
                      {"cdm": want.particles["cdm"].mom})


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_over_two_ranks_matches_one(ranks, name):
    """Every spectrum of the -n 2 run within rtol 1e-4 of -n 1's, the same
    steps and final a; the CDM + baryon run's spectra against the JAX
    package's -n 2 run to 1 % up to half the Nyquist wavenumber."""
    d = ranks["dir"]
    runs = {n: torch.load(os.path.join(d, f"{name}{n}.pt"), weights_only=False)
            for n in (1, 2)}
    assert runs[1] == runs[2] and runs[1]["steps"] > 5
    one, two = (_spectra(os.path.join(d, f"{name}{n}")) for n in (1, 2))
    assert sorted(one) == sorted(two) and len(one) >= 2
    for kind, P in one.items():
        np.testing.assert_allclose(two[kind][:, :2], P[:, :2], rtol=1e-12, err_msg=kind)
        np.testing.assert_allclose(two[kind][:, 2], P[:, 2], rtol=1e-4, err_msg=kind)
    if name == JAX_RUN:
        jax2 = _spectra(os.path.join(d, "jax2"))
        assert sorted(jax2) == sorted(two)
        kmax = 0.5 * np.pi * 16 / _cfg(name, d, d).boxsize
        for kind, P in two.items():
            sel = P[:, 0] <= kmax
            assert sel.sum() >= 3
            np.testing.assert_allclose(P[sel, 2], jax2[kind][sel, 2], rtol=0.01, err_msg=kind)


def test_autosave_over_ranks_resumes(ranks):
    """SIGTERM to rank 0 of a -n 2 run with a fluid: both ranks stop after
    the same step, rank 0 writes the autosave; resumed under -n 1 and
    under -n 2 the runs end at the same a with the same files, the
    positions within mean |Δx|/box 1e-5 and the fluid's ϱ within 1e-5 of
    its largest of each other (a resume is not an uninterrupted run: at
    softening 0 it parts from one by its P³M buckets' capacities, on one
    device too)."""
    import signal

    res = torch.load(os.path.join(ranks["dir"], "autosave", "autosave.pt"),
                     weights_only=False)
    assert res["code"] == 128 + signal.SIGTERM
    assert res["saved"] == ["auxiliary.json", "snapshot.hdf5"]
    (one, a1, files1), (two, a2, files2) = res[1], res[2]
    assert a1 == a2 == pytest.approx(0.03)
    assert files1 == files2 and "snapshot_a=0.025.hdf5" in files1 and "example_basic" not in files1
    assert len([f for f in files1 if f.startswith("bispec")]) == 2
    box = _cfg("cdm_baryon", ranks["dir"], ranks["dir"]).boxsize
    for name, ps in one.particles.items():
        dx = two.particles[name].pos.double() - ps.pos.double()
        dx -= box * torch.round(dx / box)
        assert float(dx.norm(dim=1).mean()) <= 1e-5 * box, name
    rho = one.fluids["dust"].varrho
    assert (two.fluids["dust"].varrho - rho).abs().max() <= 1e-5 * rho.abs().max()
    d = os.path.join(ranks["dir"], "autosave")
    for kind, P in _spectra(os.path.join(d, "two")).items():
        np.testing.assert_allclose(_spectra(os.path.join(d, "two_again"))[kind][:, 2], P[:, 2],
                                   rtol=1e-4, err_msg=kind)


@pytest.mark.parametrize("over, match", [
    (["potential_options=15"], "potential grid 15 does not split over 2 ranks"),
    (["initial_conditions=[{'species':'cold dark matter','N':8**3},"
      "{'species':'baryon','N':5**3}]"], "125 particles of 'baryon' do not split evenly"),
    (["initial_conditions=[{'species':'matter','N':4**3},{'name':'dust','species':'matter',"
      "'gridsize':3,'boltzmann order':1,'w':0.0}]"],
     "fluid grid 3 of 'dust' over 2 ranks leaves a rank 1 rows; its stencil reaches 2")])
def test_layout_check_raises_before_realizing(tmp_path, monkeypatch, over, match):
    from concept_tpu_torch import ic, sim_multi
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    realized = []
    monkeypatch.setattr(ic, "realize_particles", lambda *a, **kw: realized.append(1))
    monkeypatch.setattr(sim_multi, "realize_fluid_from_linear",
                        lambda *a, **kw: realized.append(1))
    cfg = load_params(os.path.join(ROOT, "param", "example_basic.py"), overrides=[
        "initial_conditions=[{'species':'cold dark matter','N':8**3},"
        "{'species':'baryon','N':4**3}]", "potential_options=16", "boltzmann_backend='eh'",
        f"output_dirs='{tmp_path}'", *over])
    with pytest.raises(ValueError, match=match):
        run(cfg, device="cpu", n_devices=2)
    assert not realized and not os.listdir(tmp_path)
