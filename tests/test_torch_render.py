"""The port's renders and plots (graphics/render.py, the render and plot
dumps of run.py, ``-u render2D`` / ``-u render3D``) against the JAX
package's concept_tpu/graphics/render.py on the CPU, with the same numpy
inputs; mirrors tests/test_render3d.py, test_analysis_extra.py::
test_render2d / ::test_render3d, test_utilities.py::test_util_render2d and
test_output_select.py's render cases.

Tolerances: project_density rtol 1e-6 (float32 deposits summed in another
order); the per-particle CIC density 1e-10 in float64 (measured: equal);
the host image functions exactly (the same numpy arithmetic); the file
names of a run and a utility those the JAX package writes.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores
pytest.importorskip("matplotlib")

import jax.numpy as jnp  # noqa: E402

from concept_tpu.graphics import render as J  # noqa: E402
from concept_tpu_torch.graphics import render as T  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM = os.path.join(ROOT, "param", "example_basic.py")
BOX = 10.0


def _pos(n=4096, seed=2):
    return np.random.default_rng(seed).uniform(0, BOX, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("axis, extent", [(2, None), (0, (2.0, 5.5))], ids=["whole", "extent"])
def test_project_density_matches_jax(axis, extent):
    pos = _pos()
    got = T.project_density(torch.as_tensor(pos), 16, BOX, axis=axis, extent=extent)
    ref = J.project_density(jnp.asarray(pos), 16, BOX, axis=axis, extent=extent)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    if extent is None:
        assert abs(got.sum() - len(pos)) < 1e-2


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cic_density_at_particles_matches_jax(dtype):
    pos = _pos(3000, 4).astype(dtype)
    got = T._cic_density_at_particles(torch.as_tensor(pos), 16, BOX)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), J._cic_density_at_particles(pos, 16, BOX),
                               rtol=0, atol=1e-10)


def test_host_image_functions_match_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 5, (32, 32))
    np.testing.assert_array_equal(T.enhance(img), J.enhance(img))
    np.testing.assert_array_equal(T.enhance(img, 90, log=False), J.enhance(img, 90, log=False))
    a, b = rng.uniform(0, 1, (6, 6, 4)), rng.uniform(0, 1, (6, 6, 4))
    for mode in ("screen", "over", "under", "overunder"):
        np.testing.assert_array_equal(T.blend_images(a.copy(), b.copy(), mode),
                                      J.blend_images(a.copy(), b.copy(), mode))
    with pytest.raises(ValueError):
        T.blend_images(a.copy(), b, "add")
    dim = rng.uniform(0, 0.05, (16, 16, 4))
    dim[..., 3] = 1.0
    out = T.enhance_brightness(dim.copy(), target=0.3)
    np.testing.assert_array_equal(out, J.enhance_brightness(dim.copy(), target=0.3))
    assert T._perceived_brightness(out) == pytest.approx(0.3, rel=0.05)
    enhanced = T.enhance(T.project_density(torch.as_tensor(_pos()), 32, BOX))
    ansi = T.terminal_render(enhanced, resolution=16)
    assert ansi == J.terminal_render(enhanced, resolution=16) and "\033[38;2;" in ansi


def test_render2d_and_render3d_write_their_files(tmp_path):
    pytest.importorskip("h5py")
    pos = _pos(2000, 3)
    img = T.render2D(torch.as_tensor(pos), 32, BOX, filename=str(tmp_path / "r.png"),
                     save_data=True)
    np.testing.assert_allclose(img, J.render2D(jnp.asarray(pos), 32, BOX), atol=1e-6)
    assert (tmp_path / "r.png").stat().st_size > 0 and (tmp_path / "r.hdf5").exists()
    T.render3D(torch.as_tensor(pos), BOX, str(tmp_path / "r3.png"), resolution=120)
    T.render3D(None, BOX, str(tmp_path / "m3.png"), resolution=120,
               components={"a": (pos, "inferno"), "b": (np.mod(pos + 5, BOX), "viridis")})
    for name in ("r3.png", "m3.png"):
        assert (tmp_path / name).stat().st_size > 1000


def test_plots_write_their_files(tmp_path):
    k = np.geomspace(0.1, 1.0, 8)
    pk = {"k": k, "power": k**-2, "power_corrected": k**-2 - 0.5}
    T.plot_powerspec(pk, str(tmp_path / "p.png"), linear=k**-2.1, a=0.5)
    tri = np.stack([k, k, k], axis=1)
    out = {"triangles": tri, "B": k**-4, "Q": np.ones_like(k)}
    T.plot_bispec(out, str(tmp_path / "b.png"), treelevel=k**-4.1, a=0.5)
    T.plot_bispec(out, str(tmp_path / "q.png"), a=0.5, prefer="reduced")
    for name in ("p.png", "b.png", "q.png"):
        assert (tmp_path / name).stat().st_size > 1000


def test_render_utilities_write_what_jax_writes(tmp_path):
    pytest.importorskip("h5py")
    from concept_tpu.components import ComponentSpec, ParticleState
    from concept_tpu.io import snapshot as jsnap
    from concept_tpu.units import units
    from concept_tpu.utilities import util_render2d as jax_render2d
    from concept_tpu_torch import cli

    box = 100 * units.Mpc
    state = ParticleState(pos=np.random.default_rng(0).uniform(0, box, (512, 3))
                          .astype(np.float32), mom=np.zeros((512, 3), np.float32))
    meta = jsnap.SnapshotMeta(a=0.25, boxsize=box, H0=67 * units.km / (units.s * units.Mpc),
                              Omega_b=0.049, Omega_cdm=0.27)
    files = {}
    for tag, render in (("jax", jax_render2d), ("port", None)):
        fn = str(tmp_path / tag / "snap.hdf5")
        os.makedirs(os.path.dirname(fn))
        jsnap.save_concept(fn, meta, {"matter": (ComponentSpec("matter", "matter", N=512,
                                                               mass=3.0), state)})
        if render is None:
            assert cli.main(["--device", "cpu", "-u", "render2D", fn]) == 0
            assert cli.main(["--device", "cpu", "-u", "render3D", fn]) == 0
        else:
            assert render([fn], None) == 0
        files[tag] = sorted(os.listdir(os.path.dirname(fn)))
    assert files["port"] == sorted(files["jax"] + ["snap.hdf5_render3D_matter.png"])


RUN = ["initial_conditions={'species':'matter','N':8**3}", "potential_options=16",
       "N_rungs=1", "a_begin=0.02", "powerspec_options={'plot': True}",
       "bispec_options={'configuration': 'equilateral 4'}",
       "bispec_select={'all': {'data': True, 'plot': True}}",
       "render2D_select={'all': {'data': True, 'image': True, 'terminal image': True}}",
       "render3D_options={'resolution': 100}",
       "output_times={'powerspec': [0.021], 'bispec': [0.021], 'render2D': [0.021],"
       " 'render3D': [0.021]}"]
MULTI = ["initial_conditions=[{'species':'cdm','N':8**3},{'species':'baryon','N':8**3}]"]


@pytest.mark.parametrize("extra", [[], MULTI], ids=["single", "multi"])
def test_run_writes_the_renders_and_plots_jax_writes(tmp_path, capsys, extra):
    """A run with render2D (image, data, terminal image), render3D, the
    power-spectrum plot and the bispectrum plot switched on writes the
    files that the JAX package's dump writes for the same outputs at the
    same a (its dump called on the port's final state)."""
    pytest.importorskip("h5py")
    from concept_tpu import run as jrun
    from concept_tpu.components import ComponentSpec
    from concept_tpu.param import load_params as jax_load
    from concept_tpu.units import units
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    over = RUN + extra
    sim, state, a = run(load_params(PARAM, overrides=over + [f"output_dirs='{tmp_path}/port'"]),
                        device="cpu")
    assert "\033[38;2;" in capsys.readouterr().out
    jcfg = jax_load(PARAM, overrides=over + [f"output_dirs='{tmp_path}/jax'"])
    conf = SimpleNamespace(potential_gridsize=16)
    if extra:
        specs = {n: ComponentSpec(n, s.species, N=s.N, mass=s.mass)
                 for n, s in sim.pspecs.items()}
        jsim = SimpleNamespace(pspecs=specs, fspecs={}, config=conf)
        jstate = SimpleNamespace(particles={n: SimpleNamespace(pos=jnp.asarray(p.pos.numpy()))
                                            for n, p in state.particles.items()}, fluids={})
        kinds, dump = ("bispec", "render2D", "render3D"), jrun.dump_multi
    else:
        jsim = SimpleNamespace(spec=ComponentSpec("matter", "matter", N=sim.spec.N,
                                                  mass=sim.spec.mass), config=conf)
        jstate = SimpleNamespace(pos=jnp.asarray(state.pos.numpy()))
        kinds, dump = ("powerspec", "bispec", "render2D", "render3D"), jrun.dump
    for kind in kinds:
        dump(jcfg, jsim, jstate, a, kind, units, None)
    port = set(os.listdir(tmp_path / "port"))
    jax = set(os.listdir(tmp_path / "jax"))
    assert jax <= port and any(f.endswith(".png") for f in jax)
    # the multi run's spectra, which the JAX dump was not asked for
    assert all(f.startswith("powerspec") for f in port - jax)
