"""The global stepper (``N_rungs = 1``: concept_tpu_torch.sim.Simulation)
vs the JAX package's Simulation on the CPU: its Δt limiters and capacity
refresh on a clustered state, the shrunk example_basic (8³ particles,
grid 32) through both command-line interfaces, and the kicks across
dumps.

Tolerances: Δt limiters to 1e-12 relative (the same float64 host
arithmetic); capacities, budgets and step counts exactly; spectra at
a = 1 to 1 % up to half the Nyquist wavenumber (tests/test_torch_run.py;
measured 8.5e-6, the same 166 steps on both sides); positions after 17
steps (a ≈ 0.03) to a mean |Δx|/box of 1e-8 (measured 3.5e-10: float32
rounding in another order); recorded time-stepping rows to 1e-9."""

import contextlib
import glob
import io
import math
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax.numpy as jnp  # noqa: E402

from concept_tpu.cli import main as jax_main  # noqa: E402
from concept_tpu.components import ParticleState as JaxState  # noqa: E402
from concept_tpu.param import load_params as jax_load_params  # noqa: E402
from concept_tpu_torch.cli import main  # noqa: E402
from concept_tpu_torch.components import ParticleState  # noqa: E402
from concept_tpu_torch.param import load_params  # noqa: E402
from concept_tpu_torch.run import run  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM = os.path.join(ROOT, "param", "example_basic.py")
SHRUNK = ["initial_conditions={'species':'matter','N':8**3}", "potential_options=32",
          "N_rungs=1"]
BOXSIZE_MPC = 256 / 0.67  # param/example_basic.py, in Mpc like the k column
BOXSIZE = load_params(PARAM).boxsize  # in the packages' length unit


def _cli_args(out):
    args = ["-p", PARAM]
    for o in SHRUNK + [f"output_dirs='{out}'"]:
        args += ["-c", o]
    return args


def _steps(text: str) -> int:
    m = re.search(r"Time-step summary: (\d+) steps", text)
    assert m, text[-2000:]
    return int(m.group(1))


def _spectrum(out):
    files = glob.glob(os.path.join(out, "powerspec_a=1.txt"))
    assert files, f"no power spectrum in {out}"
    data = np.loadtxt(files[0])
    assert np.all(np.isfinite(data[:, :3]))
    return data[:, 0], data[:, 2]


def _sims(tmp_path):
    """A port and a JAX Simulation of the shrunk example_basic, and one
    clustered state (a 200-particle blob in the 8³ lattice) for both."""
    over = SHRUNK + [f"output_dirs='{tmp_path}'"]
    cfg_t, cfg_j = load_params(PARAM, overrides=over), jax_load_params(PARAM, overrides=over)
    from concept_tpu import run as jrun
    from concept_tpu.sim import SimConfig as JaxConfig, Simulation as JaxSim
    from concept_tpu_torch import run as trun
    from concept_tpu_torch.sim import SimConfig, Simulation

    _, c, bg, lin = trun.build_cosmology(cfg_t)
    spec, _ = trun.build_components(cfg_t, bg, c)[0]
    soft = trun.softening_length(cfg_t, spec, 32)
    sim_t = Simulation(spec, SimConfig(boxsize=cfg_t.boxsize, potential_gridsize=32,
                                       device=torch.device("cpu"), G=c.G_Newton,
                                       softening=soft), bg, lin)
    _, jc, jbg, jlin = jrun.build_cosmology(cfg_j)
    jspec, _ = jrun.build_components(cfg_j, jbg, jc)[0]
    sim_j = JaxSim(jspec, JaxConfig(boxsize=cfg_j.boxsize, potential_gridsize=32,
                                    G=jc.G_Newton, method="p3m", softening=soft,
                                    softening_kernel="spline"), jbg, jlin)
    rng = np.random.default_rng(2)
    box = cfg_t.boxsize
    lin1 = (np.arange(8) + 0.5) * (box / 8)
    pos = np.stack(np.meshgrid(lin1, lin1, lin1, indexing="ij"), -1).reshape(-1, 3)
    pos[:200] = 0.3 * box + rng.normal(0, 0.01 * box, (200, 3))
    pos = np.mod(pos, box).astype(np.float32)
    mom = rng.normal(0, 1.0, pos.shape).astype(np.float32) * spec.mass
    return (sim_t, ParticleState(pos=torch.as_tensor(pos), mom=torch.as_tensor(mom)),
            sim_j, JaxState(pos=jnp.asarray(pos), mom=jnp.asarray(mom)))


def test_timestep_and_capacity_match_jax(tmp_path):
    sim_t, st_t, sim_j, st_j = _sims(tmp_path)
    assert (sim_t._sr_ncells, sim_t._sr_capacity, sim_t._sr_max_overflow,
            sim_t._pm_max_overflow) == (sim_j._sr_ncells, sim_j._sr_capacity,
                                        sim_j._sr_max_overflow, sim_j._pm_max_overflow)
    for a in (0.02, 0.05, 0.3, 1.0):
        for v in (None, 0.0, 3.0, 300.0):
            dt_t, bn_t = sim_t.base_timestep_size(a, v_max=v)
            dt_j, bn_j = sim_j.base_timestep_size(a, v_max=v)
            assert bn_t == bn_j
            assert dt_t == pytest.approx(dt_j, rel=1e-12)
    # the blob holds 200 particles in one short-range cell: K doubles
    for budget in (2048, 60):  # the default budget, and one that must grow
        sim_t._sr_max_overflow = sim_j._sr_max_overflow = budget
        sim_t._sr_capacity = sim_j._sr_capacity = 8
        sim_t._refresh_shortrange_capacity(st_t)
        sim_j._refresh_shortrange_capacity(st_j)
        assert (sim_t._sr_capacity, sim_t._sr_max_overflow) == \
            (sim_j._sr_capacity, sim_j._sr_max_overflow)
    assert sim_t._sr_capacity > 8


EARLY_STEP = 17  # a ≈ 0.03


def _snapshot_step(monkeypatch, cls, to_numpy, out: dict):
    """Keep the positions after the EARLY_STEP-th call of cls.step."""
    step = cls.step

    def counting(self, state, int_a1, int_a2):
        state = step(self, state, int_a1, int_a2)
        out["calls"] = out.get("calls", 0) + 1
        if out["calls"] == EARLY_STEP:
            out["pos"] = to_numpy(state.pos)
        return state

    monkeypatch.setattr(cls, "step", counting)


def _cli(entry, out: str, extra: list) -> int:
    """One CLI run of the shrunk example_basic with N_rungs = 1, recording
    its time-stepping to out/steps.txt; returns its step count."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert entry(_cli_args(out) + extra
                     + ["-c", f"static_timestepping='{out}/steps.txt'"]) == 0
    return _steps(buf.getvalue())


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The shrunk example_basic with N_rungs = 1 through both CLIs from the
    same ICs, once for the module: per package (output directory, step
    count, positions after step EARLY_STEP)."""
    from concept_tpu.sim import Simulation as JaxSim
    from concept_tpu_torch.sim import Simulation

    tmp = tmp_path_factory.mktemp("cli")
    early_t, early_j = {}, {}
    out_t, out_j = str(tmp / "torch"), str(tmp / "jax")
    with pytest.MonkeyPatch.context() as mp:
        _snapshot_step(mp, Simulation, lambda p: p.numpy().astype(np.float64), early_t)
        _snapshot_step(mp, JaxSim, lambda p: np.asarray(p, np.float64), early_j)
        steps_t = _cli(main, out_t, ["--device", "cpu"])
        steps_j = _cli(jax_main, out_j, [])
    return {"torch": (out_t, steps_t, early_t["pos"]), "jax": (out_j, steps_j, early_j["pos"])}


def test_cli_global_steps_positions_and_spectra_agree(cli_runs):
    """The same number of global steps (166), the same positions particle
    by particle after step 17 (the mean periodic |Δx| over the box), and
    the same spectra at a = 1."""
    (out_t, steps_t, early_t), (out_j, steps_j, early_j) = cli_runs["torch"], cli_runs["jax"]
    assert steps_t == steps_j
    d = early_t - early_j
    d -= BOXSIZE * np.round(d / BOXSIZE)
    assert np.abs(d).mean() / BOXSIZE < 1e-8
    k, P = _spectrum(out_t)
    k_j, P_j = _spectrum(out_j)
    np.testing.assert_allclose(k, k_j, rtol=1e-5)  # JAX bins k in float32
    sel = k <= 0.5 * math.pi * 32 / BOXSIZE_MPC
    assert sel.sum() >= 5
    np.testing.assert_allclose(P[sel], P_j[sel], rtol=0.01)


def test_cli_recorded_timestepping_agrees(cli_runs):
    """static_timestepping to a fresh path records the same (a, Δa) rows
    in both packages."""
    rows = np.loadtxt(os.path.join(cli_runs["torch"][0], "steps.txt"), ndmin=2)
    assert len(rows) >= 10
    np.testing.assert_allclose(
        rows, np.loadtxt(os.path.join(cli_runs["jax"][0], "steps.txt"), ndmin=2), rtol=1e-9)


def test_kicks_cover_the_run_once_across_dumps(tmp_path, monkeypatch):
    """Three dumps make three evolve segments, each ending with the
    momenta synchronised at its end, so the kick integrals add up to
    ∫a⁻¹dt over the run.  (The JAX package's Simulation takes the
    previous segment's kick sync point over and kicks that stretch twice;
    a port doing so fails here.)"""
    from concept_tpu_torch.sim import Simulation

    ints = []
    kick = Simulation._kick

    def counting(self, state, int_a1):
        ints.append(float(int_a1))
        return kick(self, state, int_a1)

    monkeypatch.setattr(Simulation, "_kick", counting)
    cfg = load_params(PARAM, overrides=SHRUNK + [
        "output_times={'powerspec': [0.025, 0.03, 0.035]}", f"output_dirs='{tmp_path}'"])
    sim, _, a = run(cfg, device="cpu")
    assert a == pytest.approx(0.035)
    assert len(glob.glob(os.path.join(tmp_path, "powerspec_a=*.txt"))) == 3
    bg = sim.bg
    ts = np.linspace(float(bg.t_of_a_np(0.02)), float(bg.t_of_a_np(0.035)), 1001)
    total = sum(bg.integrals_np(lo, hi, keys=("a**(-1)",))["a**(-1)"]
                for lo, hi in zip(ts[:-1], ts[1:]))
    assert sum(ints) == pytest.approx(total, rel=1e-6)
    assert sim.stats["steps"] == sim.hysteresis["step_count"]
    assert sim.stats["kicks"] == sim.stats["steps"] + 3  # a closing kick per segment


def test_static_timestepping_replays_a_file(tmp_path):
    """A static_timestepping file of constant Δa = 0.002 from a = 0.02:
    the global stepper replays it.  Δt starts at Δt_initial_fac = 0.95 of
    the replayed step and may grow only at a period boundary (8 steps),
    so a = 0.03 takes 6 steps, not 5."""
    path = tmp_path / "steps.txt"
    np.savetxt(path, [[0.02 + 0.002 * i, 0.002] for i in range(6)])
    sim, _, a = run(load_params(PARAM, overrides=SHRUNK + [
        "output_times={'powerspec': [0.03]}", f"output_dirs='{tmp_path}'",
        f"static_timestepping='{path}'"]), device="cpu")
    assert a == pytest.approx(0.03)
    assert sim.hysteresis["step_count"] == 6
