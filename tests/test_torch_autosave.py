"""Autosave, resume and the signal trap of the port's run, on the CPU.

SIGTERM is raised in-process after a chosen base step (a hook around the
stepper's step, never a timer), on the rung stepper and with
``N_rungs = 1``.  The run writes its autosave after that step and exits
with 128 + 15; a second run resumes from the autosave.  Its final power
spectrum agrees with the uninterrupted run's within rtol 1e-5 (the
tolerance tests/test_signal_trap.py holds the JAX package to), and the PM
kick integrals of the interrupted and the resumed run add up to ∫a⁻¹dt
within 1e-6: a resume that kicked [t_mom, t] twice would not.
"""

import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

from concept_tpu_torch import p3mrungs, run as run_mod  # noqa: E402
from concept_tpu_torch.param import load_params  # noqa: E402
from concept_tpu_torch.sim import Simulation  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM = os.path.join(ROOT, "param", "example_basic.py")
SHRUNK = ["initial_conditions={'species':'matter','N':8**3}", "potential_options=32"]
# (extra parameters, a of the two dumps, the base step after which SIGTERM
# comes).  The rung factor makes the shrunk run's rungs reach 2, so the
# resume re-assigns rungs that are not all 0.
STEPPERS = {
    "rungs": (["Delta_t_rung_factor=0.002"], (0.03, 0.05), 20),
    "global": (["N_rungs=1"], (0.025, 0.035), 24),
}


def _cfg(out, extra, dumps, more=()):
    return load_params(PARAM, overrides=SHRUNK + extra + [
        f"output_times={{'powerspec': {list(dumps)}}}", f"output_dirs='{out}'", *more])


def _kick_recorder(monkeypatch, stepper):
    """The PM kick integrals of every kick, in a list."""
    ints = []
    if stepper == "rungs":
        kick = p3mrungs.pm_kick_rungs

        def counting(state, mass, G, int_pm, *args, **kw):
            ints.append(float(int_pm))
            return kick(state, mass, G, int_pm, *args, **kw)

        monkeypatch.setattr(p3mrungs, "pm_kick_rungs", counting)
    else:
        kick = Simulation._kick

        def counting(self, state, int_a1):
            ints.append(float(int_a1))
            return kick(self, state, int_a1)

        monkeypatch.setattr(Simulation, "_kick", counting)
    return ints


def _sigterm_after_step(monkeypatch, stepper, n: int):
    """Raise SIGTERM in this process at the end of the n-th base step."""
    cls, name = ((p3mrungs.P3MRungSimulation, "base_step") if stepper == "rungs"
                 else (Simulation, "step"))
    step = getattr(cls, name)
    calls = [0]

    def hooked(self, *args, **kw):
        out = step(self, *args, **kw)
        calls[0] += 1
        if calls[0] == n:
            assert signal.getsignal(signal.SIGTERM) not in (signal.SIG_DFL, None)
            signal.raise_signal(signal.SIGTERM)
        return out

    monkeypatch.setattr(cls, name, hooked)


@pytest.mark.parametrize("stepper", sorted(STEPPERS))
def test_sigterm_autosave_and_resume_match_the_uninterrupted_run(tmp_path, monkeypatch,
                                                                 stepper):
    extra, dumps, n_step = STEPPERS[stepper]
    last = f"powerspec_a={dumps[-1]:.4g}.txt"
    base = tmp_path / "base"
    run_mod.run(_cfg(base, extra, dumps), device="cpu")

    out = tmp_path / "interrupted"
    autosaves = []
    write = run_mod.write_autosave

    def recording(cfg, sim, state, a, events, hysteresis=None, step_total=0):
        autosaves.append((a, dict(hysteresis), float(sim.bg.t_of_a_np(a))))
        return write(cfg, sim, state, a, events, hysteresis, step_total)

    monkeypatch.setattr(run_mod, "write_autosave", recording)
    ints = _kick_recorder(monkeypatch, stepper)
    with monkeypatch.context() as m:
        _sigterm_after_step(m, stepper, n_step)
        with pytest.raises(SystemExit) as exc:
            run_mod.run(_cfg(out, extra, dumps, ["autosave_interval=0"]), device="cpu")
    assert exc.value.code == 128 + signal.SIGTERM
    # the periodic autosave at the first dump (momenta synchronised
    # there), then the trap's after step n_step (mid-segment)
    assert len(autosaves) == 2
    (a_dump, h_dump, t_dump), (a_trap, h_trap, t_trap) = autosaves
    assert a_dump == pytest.approx(dumps[0]) and h_dump["t_mom"] == t_dump
    assert dumps[0] < a_trap < dumps[1] and h_trap["t_mom"] != t_trap
    assert h_trap["step_count"] == n_step - (1 if stepper == "global" else 0)
    d = out / "example_basic"
    with open(d / "auxiliary.json") as f:
        aux = json.load(f)
    assert aux["a"] == a_trap and aux["events"] == [[dumps[1], "powerspec"]]
    assert aux["hysteresis"]["t_mom"] == h_trap["t_mom"]
    assert not (out / last).exists()

    sim, _, a = run_mod.run(_cfg(out, extra, dumps), device="cpu")
    assert a == pytest.approx(dumps[1])
    assert not d.exists()  # a finished run clears its autosave
    if stepper == "rungs":
        assert sim.inner.stats["max_rung"] >= 1
    P = np.loadtxt(out / last)[:, 2]
    P_base = np.loadtxt(base / last)[:, 2]
    np.testing.assert_allclose(P, P_base, rtol=1e-5)
    bg = sim.bg
    ts = np.linspace(float(bg.t_of_a_np(0.02)), float(bg.t_of_a_np(dumps[1])), 1001)
    total = sum(bg.integrals_np(lo, hi, keys=("a**(-1)",))["a**(-1)"]
                for lo, hi in zip(ts[:-1], ts[1:]))
    assert sum(ints) == pytest.approx(total, rel=1e-6)


def test_signal_trap_defers_the_first_signal_and_exits_on_the_second():
    trap = run_mod.SignalTrap()
    with trap:
        signal.raise_signal(signal.SIGINT)
        assert trap.signum == signal.SIGINT
        with pytest.raises(SystemExit) as exc:
            signal.raise_signal(signal.SIGTERM)
        assert exc.value.code == 128 + signal.SIGTERM
        saved = []
        with pytest.raises(SystemExit) as exc:
            trap.exit_if_signalled(lambda: saved.append(1))
        assert saved == [1] and exc.value.code == 128 + signal.SIGINT
    assert signal.getsignal(signal.SIGINT) is signal.default_int_handler


def _fake_sim(spec):
    from types import SimpleNamespace

    return SimpleNamespace(spec=spec)


def test_autosaves_cross_between_the_packages(tmp_path):
    """Each package resumes from the other's autosave: the same state,
    a, events and hysteresis."""
    from concept_tpu import run as jax_run
    from concept_tpu.components import ComponentSpec as JSpec, ParticleState as JState
    from concept_tpu.param import load_params as jax_load_params
    from concept_tpu_torch.components import ComponentSpec, ParticleState

    rng = np.random.default_rng(3)
    pos = rng.uniform(0, 100, (64, 3)).astype(np.float32)
    mom = rng.standard_normal((64, 3)).astype(np.float32)
    ids = np.arange(64, dtype=np.int32)
    events = [(0.5, "powerspec"), (1.0, "snapshot")]
    hyst = {"dt": 0.01, "dt_min": 1e-6, "step_count": 12, "step_last_sync": 8,
            "t_mom": 0.37}
    over = [f"output_dirs='{tmp_path}'"]
    cfg_t = load_params(PARAM, overrides=over)
    cfg_j = jax_load_params(PARAM, overrides=over)
    run_mod.write_autosave(cfg_t, _fake_sim(ComponentSpec("matter", "matter", N=64,
                                                          mass=2.0)),
                           ParticleState(torch.as_tensor(pos), torch.as_tensor(mom),
                                         torch.as_tensor(ids)),
                           0.25, events, hyst, 12)
    st, a, ev, h, steps = jax_run.check_autosave(cfg_j)
    np.testing.assert_array_equal(st.pos, pos)
    np.testing.assert_array_equal(st.mom, mom)
    np.testing.assert_array_equal(st.ids, ids)
    assert (a, ev, h, steps) == (0.25, events, hyst, 12)
    run_mod.clear_autosave(cfg_t)
    jax_run.write_autosave(cfg_j, _fake_sim(JSpec("matter", "matter", N=64, mass=2.0)),
                           JState(pos=pos, mom=mom, ids=ids), 0.25, events, None,
                           hysteresis=hyst, step_total=12)
    st, a, ev, h, steps = run_mod.check_autosave(cfg_t)
    np.testing.assert_array_equal(st.pos, pos)
    np.testing.assert_array_equal(st.ids, ids)
    assert (a, ev, h, steps) == (0.25, events, hyst, 12)


def test_a_multi_component_autosave_is_not_resumed(tmp_path, capsys):
    cfg = load_params(PARAM, overrides=[f"output_dirs='{tmp_path}'"])
    from concept_tpu_torch.components import ComponentSpec, ParticleState

    state = ParticleState(torch.zeros(8, 3), torch.zeros(8, 3))
    run_mod.write_autosave(cfg, _fake_sim(ComponentSpec("matter", "matter", N=8, mass=1.0)),
                           state, 0.1, [(1.0, "powerspec")])
    assert run_mod.check_autosave(cfg) is not None
    path = os.path.join(run_mod.autosave_path(cfg), "auxiliary.json")
    with open(path) as f:
        aux = json.load(f)
    with open(path, "w") as f:
        json.dump({**aux, "multi": True}, f)
    assert run_mod.check_autosave(cfg) is None
    assert "a multi-component autosave" in " ".join(capsys.readouterr().out.split())
