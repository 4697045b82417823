"""The shrunk default run (example_basic at N = 8³, grid 32) through both
command-line interfaces, on the CPU: the power spectra at a = 1 agree bin
by bin to 1 % up to half the Nyquist wavenumber.  Both packages step the
tight cell layout on the CPU (5³ cells, the block PM); the port's summation
order differs, so its rungs and time steps may part from the JAX package's
late in the run, and the spectra agree to the integrator's accuracy."""

import glob
import math
import os

import numpy as np
import pytest

pytest.importorskip("torch").set_num_threads(1)  # parallel test workers share the cores

from concept_tpu.cli import main as jax_main  # noqa: E402
from concept_tpu_torch.cli import main  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHRUNK = ["-c", "initial_conditions={'species':'matter','N':8**3}",
          "-c", "potential_options=32"]


def _spectrum(out):
    files = glob.glob(os.path.join(out, "powerspec_a=1.txt"))
    assert files, f"no power spectrum in {out}"
    data = np.loadtxt(files[0])
    assert np.all(np.isfinite(data[:, :3]))
    return data[:, 0], data[:, 2]


def test_cli_power_spectra_agree(tmp_path):
    param = os.path.join(ROOT, "param", "example_basic.py")
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    assert main(["-p", param, *SHRUNK, "-c", f"output_dirs='{out_t}'",
                 "--device", "cpu"]) == 0
    assert jax_main(["-p", param, *SHRUNK, "-c", f"output_dirs='{out_j}'"]) == 0
    k, P = _spectrum(out_t)
    k_j, P_j = _spectrum(out_j)
    np.testing.assert_allclose(k, k_j, rtol=1e-5)  # JAX bins k in float32
    boxsize = 256 / 0.67  # param/example_basic.py, in Mpc like the k column
    k_nyq = math.pi * 32 / boxsize
    sel = k <= 0.5 * k_nyq
    assert sel.sum() >= 5
    np.testing.assert_allclose(P[sel], P_j[sel], rtol=0.01)


def test_pm_kicks_cover_the_run_once_across_dumps(tmp_path, monkeypatch):
    """Three power-spectrum dumps make three evolve segments, each ending
    with the momenta synchronised at its end, so the PM kick integrals of
    the run add up to ∫a⁻¹dt over it.  (The JAX package's adapter starts
    each later segment from the previous kick sync point and kicks that
    stretch twice; a port doing so fails here.)"""
    from concept_tpu_torch import p3mrungs
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    ints = []
    kick = p3mrungs.pm_kick_rungs

    def counting(state, mass, G, int_pm, *args, **kw):
        ints.append(float(int_pm))
        return kick(state, mass, G, int_pm, *args, **kw)

    monkeypatch.setattr(p3mrungs, "pm_kick_rungs", counting)
    cfg = load_params(os.path.join(ROOT, "param", "example_basic.py"), overrides=[
        SHRUNK[1], SHRUNK[3], "output_times={'powerspec': [0.1, 0.5, 1.0]}",
        f"output_dirs='{tmp_path}'"])
    sim, _, a = run(cfg, device="cpu")
    assert a == pytest.approx(1.0)
    assert len(glob.glob(os.path.join(tmp_path, "powerspec_a=*.txt"))) == 3
    bg = sim.bg
    ts = np.linspace(float(bg.t_of_a_np(0.02)), float(bg.t_of_a_np(1.0)), 1001)
    total = sum(bg.integrals_np(lo, hi, keys=("a**(-1)",))["a**(-1)"]
                for lo, hi in zip(ts[:-1], ts[1:]))
    assert sum(ints) == pytest.approx(total, rel=1e-6)


@pytest.mark.parametrize("override, match", [
    ("shortrange_params={'gravity': {'scale': '2*boxsize/gridsize'}}", "shortrange_params"),
    ("static_timestepping='{tmp}/dt.txt'", "static_timestepping"),
], ids=["shortrange_params", "static_timestepping"])
def test_rung_stepper_refuses_what_it_would_ignore(tmp_path, monkeypatch, override, match):
    """With N_rungs > 1 the JAX package ignores shortrange_params overrides
    and never records a static_timestepping file; the port refuses both
    (a departure, see run.run) before anything is realized."""
    from concept_tpu_torch import ic
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    cfg = load_params(os.path.join(ROOT, "param", "example_basic.py"), overrides=[
        SHRUNK[1], SHRUNK[3], override.replace("{tmp}", str(tmp_path)),
        f"output_dirs='{tmp_path}'"])
    assert cfg.N_rungs > 1
    realized = []
    monkeypatch.setattr(ic, "realize_particles", lambda *a, **kw: realized.append(1))
    with pytest.raises(NotImplementedError, match=match):
        run(cfg, device="cpu")
    assert not realized
