"""The port's command-line utilities and options against the JAX
package's, on the CPU: -u info (--generate-params), -u convert, -u
gadget, -u powerspec and -u bispec of a snapshot, -m, -i, -n, the
CONCEPT_* environment defaults, and the Slurm and TORQUE/PBS job scripts
of --submit (no scheduler is called: a stub stands in for sbatch)."""

import os
import stat
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

from concept_tpu import cli as jax_cli  # noqa: E402
from concept_tpu.io import snapshot as jsnap  # noqa: E402
from concept_tpu_torch import cli  # noqa: E402
from concept_tpu_torch.submit import build_job_script, detect_scheduler  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM = os.path.join(ROOT, "param", "example_basic.py")


@pytest.fixture
def snapshot(tmp_path):
    """A JAX-written CONCEPT snapshot of 8³ uniform particles."""
    from concept_tpu.components import ComponentSpec, ParticleState
    from concept_tpu.units import units

    rng = np.random.default_rng(0)
    box = 100 * units.Mpc
    state = ParticleState(pos=rng.uniform(0, box, (512, 3)).astype(np.float32),
                          mom=rng.standard_normal((512, 3)).astype(np.float32),
                          ids=np.arange(512, dtype=np.int32))
    meta = jsnap.SnapshotMeta(a=0.25, boxsize=box, H0=67 * units.km / (units.s * units.Mpc),
                              Omega_b=0.049, Omega_cdm=0.27)
    fn = str(tmp_path / "snap.hdf5")
    jsnap.save_concept(fn, meta, {"matter": (ComponentSpec("matter", "matter", N=512,
                                                           mass=3.0), state)})
    return fn


def test_info_generates_the_jax_parameter_file(snapshot, capsys, tmp_path):
    from concept_tpu_torch.param import load_params

    assert cli.main(["-u", "info", snapshot, "--generate-params"]) == 0
    out = capsys.readouterr().out
    with open(snapshot + ".params.py") as f:
        text = f.read()
    assert jax_cli.main(["-u", "info", snapshot, "--generate-params"]) == 0
    assert capsys.readouterr().out == out
    with open(snapshot + ".params.py") as f:
        assert f.read() == text
    cfg = load_params(snapshot + ".params.py")
    assert cfg.initial_conditions == snapshot and cfg.a_begin == 0.25


@pytest.mark.parametrize("target", ["gadget", "concept"])
def test_convert_writes_the_jax_file(snapshot, tmp_path, target):
    import shutil

    jax_copy = str(tmp_path / "jax_copy.hdf5")
    shutil.copy(snapshot, jax_copy)
    assert cli.main(["-u", "convert", snapshot, f"snapshot_type={target}"]) == 0
    assert jax_cli.main(["-u", "convert", jax_copy, f"snapshot_type={target}"]) == 0
    ext = ".gadget" if target == "gadget" else ".hdf5"
    if target == "gadget":
        with open(snapshot + ext, "rb") as a, open(jax_copy + ext, "rb") as b:
            assert a.read() == b.read()
    meta, comps = jsnap.load(snapshot + ext)
    jmeta, jcomps = jsnap.load(jax_copy + ext)
    assert meta == jmeta
    for (_, st), (_, jst) in zip(comps.values(), jcomps.values()):
        np.testing.assert_array_equal(st.pos, jst.pos)
        np.testing.assert_array_equal(st.mom, jst.mom)


def test_gadget_utility_writes_the_jax_parameter_file(tmp_path):
    outs = {}
    for name, main in (("torch", cli.main), ("jax", jax_cli.main)):
        out = str(tmp_path / name)
        assert main(["-u", "gadget", PARAM, "ic=ic.gadget", f"output={out}"]) == 0
        with open(os.path.join(out, "gadget.param")) as f:
            outs[name] = f.read().splitlines()[2:]  # below the generator's comment
        outs[name] = [ln.replace(out, "<out>") for ln in outs[name]]
        np.testing.assert_array_equal(np.loadtxt(os.path.join(out, "outputlist.txt")), 1.0)
    assert outs["torch"] == outs["jax"]


def test_powerspec_and_bispec_utilities_measure_a_snapshot(snapshot):
    assert cli.main(["--device", "cpu", "-u", "powerspec", snapshot]) == 0
    assert cli.main(["--device", "cpu", "-u", "bispec", snapshot]) == 0
    pk = np.loadtxt(snapshot + "_powerspec_matter.txt")
    bk = np.loadtxt(snapshot + "_bispec_matter.txt")
    assert pk.shape[1] == 4 and np.all(np.isfinite(pk))
    assert bk.shape == (10, 5) and np.all(np.isfinite(bk))


def test_main_script_sees_cfg_and_units(tmp_path):
    script = tmp_path / "custom.py"
    marker = tmp_path / "ran.txt"
    script.write_text(f"open({str(marker)!r}, 'w').write(f'{{cfg.boxsize}} {{units.Mpc}}')\n")
    assert cli.main(["-m", str(script), "-c", "boxsize = 77*Mpc"]) == 0
    assert marker.read_text() == "77.0 1.0"


def test_interactive_session_without_a_run():
    r = subprocess.run(
        [sys.executable, "-c", "import sys; from concept_tpu_torch.cli import main;"
                               "sys.exit(main(['-i', '-c', 'boxsize = 55*Mpc']))"],
        input="print('BOX', cfg.boxsize, units.Mpc)\n", capture_output=True, text=True,
        timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-1000:]
    assert "BOX 55.0 1.0" in r.stdout
    assert "Realizing" not in r.stdout


def test_more_than_one_device_names_its_item(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # -n AxB reaches the run through the CLI: several components over its
    # A·B ranks, whose layout check refuses 5³ baryons over 2 ranks before
    # anything is realized (runs that can run:
    # tests/test_torch_parallel_multi.py, tests/test_torch_parallel_pencils.py)
    with pytest.raises(ValueError, match="125 particles of 'baryon' do not split evenly "
                                         "over 2 ranks"):
        cli.main(["-p", PARAM, "-n", "2x1", "--device", "cpu", "-c",
                  "initial_conditions=[{'species':'cdm','N':8**3},{'species':'baryon','N':5**3}]"])
    assert "output" not in os.listdir(tmp_path)


def test_concept_env_var_mirrors(monkeypatch):
    monkeypatch.setenv("CONCEPT_param", "/tmp/somewhere.py")
    monkeypatch.setenv("CONCEPT_device", "cpu")
    monkeypatch.setenv("CONCEPT_local", "True")
    monkeypatch.setenv("CONCEPT_command_line_params", "boxsize=1*Mpc")
    args = cli.make_parser().parse_args([])
    assert (args.param, args.device, args.local) == ("/tmp/somewhere.py", "cpu", True)
    assert args.command_line_params == ["boxsize=1*Mpc"]
    # flags on the command line win over the environment
    args = cli.make_parser().parse_args(["-p", "other.py", "--device", "cuda"])
    assert (args.param, args.device) == ("other.py", "cuda")


def test_slurm_script_headers():
    text = build_job_script(
        "slurm", ["-p", "param.py", "--submit", "-q", "gpu", "-w", "12:00:00",
                  "--memory", "64G"],
        jobname="myjob", logfile="/j/log", errfile="/j/err", queue="gpu",
        walltime="12:00:00", memory="64G", nprocs=4, directives=["--account=cosmo"])
    for line in ("#SBATCH --job-name=myjob", "#SBATCH --partition=gpu",
                 "#SBATCH --time=12:00:00", "#SBATCH --mem=64G", "#SBATCH --account=cosmo"):
        assert line in text
    run_line = text.strip().splitlines()[-1]
    assert "--submit" not in run_line and "-q" not in run_line.split()
    assert run_line.endswith("--local")
    assert "-m concept_tpu_torch " in run_line and "param.py" in run_line


def test_torque_script_headers():
    text = build_job_script("torque", ["-p", "p.py"], jobname="j", logfile="L", errfile="E",
                            queue="batch", walltime="01:00:00", memory="8gb", nprocs=2)
    for line in ("#PBS -N j", "#PBS -q batch", "#PBS -l walltime=01:00:00",
                 "#PBS -l nodes=1:ppn=2", 'cd "$PBS_O_WORKDIR"'):
        assert line in text


def test_detect_scheduler_forced(monkeypatch):
    for forced, want in (("torque", "torque"), ("slurm", "slurm"), ("nonsense", None)):
        monkeypatch.setenv("CONCEPT_TPU_SCHEDULER", forced)
        assert detect_scheduler() == want


def test_submit_end_to_end(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    param = tmp_path / "tiny.py"
    param.write_text("boxsize = 16 * Mpc\n")
    record = tmp_path / "sbatch_args.txt"
    stub = tmp_path / "sbatch"
    stub.write_text(f"#!/usr/bin/env bash\necho \"$@\" > {record}\n"
                    "echo Submitted batch job 42\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CONCEPT_TPU_SCHEDULER", "slurm")
    monkeypatch.setenv("CONCEPT_TPU_SUBMIT_CMD", str(stub))
    assert cli.main(["-p", str(param), "--submit", "-w", "00:10:00"]) == 0
    script = tmp_path / "job" / "0" / "jobscript"
    assert (tmp_path / "job" / "0" / "param").exists()
    assert "job/0/jobscript" in record.read_text()
    assert "#SBATCH --time=00:10:00" in script.read_text()
    assert os.access(script, os.X_OK)


def test_submit_without_a_scheduler_writes_the_script(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CONCEPT_TPU_SCHEDULER", "")
    monkeypatch.setenv("PATH", str(tmp_path))  # hide any real sbatch/qsub
    assert cli.main(["-p", "/nonexistent_param_placeholder.py", "--submit"]) == 1
    assert "jobscript" in capsys.readouterr().err


def test_renders_and_class_name_their_items(snapshot, tmp_path):
    """The renders (ROADMAP item 13, ported; tests/test_torch_render.py
    holds them against the JAX package's) and ``-u class``
    (tests/test_torch_boltzmann.py) write their files."""
    pytest.importorskip("matplotlib")
    for util in ("render2D", "render3D"):
        assert cli.main(["--device", "cpu", "-u", util, snapshot]) == 0
        assert os.path.exists(snapshot + f"_{util}_matter.png")
    pytest.importorskip("h5py")
    out = tmp_path / "class.hdf5"
    assert cli.main(["-u", "class", str(out), "--modes", "8"]) == 0
    assert out.exists()
