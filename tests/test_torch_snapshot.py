"""The port's snapshot I/O against the JAX package's, on the CPU.

From the same numpy state both packages write byte-identical GADGET-2
files (formats 1 and 2, 32- and 64-bit data, one file and several, with
a header override); each loads the other's CONCEPT-HDF5, GADGET-2 (with
a MASS block too) and TIPSY files to equal arrays; CONCEPT-HDF5 files
hold the same attrs and datasets under a snapshot_select mask.  Then one
CLI run in each package from the same JAX-written GADGET file (8³
particles, grid 32, a = 0.02 → 0.05): the spectra agree to 1 % up to
half the Nyquist wavenumber, as in tests/test_torch_run.py, and the
dumped positions to max |Δx|/box ≤ 1e-6: a float32 position is good to
6e-8 of the box, and the two summation orders part the positions by 8e-8
of the box at most (mean 1e-9) in this run.
"""

import math
import os
import struct

import h5py
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

from concept_tpu.cli import main as jax_main  # noqa: E402
from concept_tpu.components import ComponentSpec as JSpec, ParticleState as JState  # noqa: E402
from concept_tpu.io import snapshot as jsnap  # noqa: E402
from concept_tpu.units import units as junits  # noqa: E402
from concept_tpu_torch.cli import main  # noqa: E402
from concept_tpu_torch.components import ComponentSpec, ParticleState  # noqa: E402
from concept_tpu_torch.io import snapshot as snap  # noqa: E402
from concept_tpu_torch.units import units  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM = os.path.join(ROOT, "param", "example_basic.py")
N = 100
BOX = 64 * units.Mpc


def _state(seed=5, with_ids=True):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, BOX, (N, 3)).astype(np.float32)
    mom = (rng.standard_normal((N, 3)) * 7.5).astype(np.float32)
    ids = rng.permutation(N).astype(np.int32) if with_ids else None
    return pos, mom, ids


def _meta(pkg):
    return pkg.SnapshotMeta(a=0.5, boxsize=BOX, H0=67 * units.km / (units.s * units.Mpc),
                            Omega_b=0.049, Omega_cdm=0.27)


def _both(pos, mom, ids):
    """(port state of tensors, JAX state of numpy arrays, port spec, JAX spec)."""
    t = ParticleState(torch.as_tensor(pos), torch.as_tensor(mom),
                      None if ids is None else torch.as_tensor(ids))
    return (t, JState(pos=pos, mom=mom, ids=ids),
            ComponentSpec("matter", "matter", N=N, mass=7.5), JSpec("matter", "matter", N=N,
                                                                    mass=7.5))


def _assert_loaded_equal(got, ref):
    meta, comps = got
    jmeta, jcomps = ref
    assert meta.__dict__ == jmeta.__dict__
    assert list(comps) == list(jcomps)
    for (spec, st), (jspec, jst) in zip(comps.values(), jcomps.values()):
        assert (spec.name, spec.species, spec.N, spec.mass) == (
            jspec.name, jspec.species, jspec.N, jspec.mass)
        for f in ("pos", "mom", "ids", "rungs"):
            a, b = getattr(st, f), getattr(jst, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == np.asarray(b).dtype, f
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)


GADGET_CASES = [(fmt, prec, files) for fmt in (1, 2) for prec in (32, 64)
                for files in (1, 3)]


@pytest.mark.parametrize("snapformat,dataformat,n_files", GADGET_CASES)
def test_gadget_files_are_byte_identical_and_load_alike(tmp_path, snapformat, dataformat,
                                                        n_files):
    """n_files = 3 splits 100 particles 34/34/32 and overrides a header
    field; n_files = 1 writes the ids the writer makes up."""
    pos, mom, ids = _state(with_ids=n_files > 1)
    tstate, jstate, spec, jspec = _both(pos, mom, ids)
    kw = dict(particles_per_file=-(-N // n_files), snapformat=snapformat,
              single_precision=dataformat == 32,
              header_overrides={"FlagCooling": 1} if n_files > 1 else None)
    files = snap.save_gadget_multifile(str(tmp_path / "t"), _meta(snap), spec, tstate,
                                       units, **kw)
    jfiles = jsnap.save_gadget_multifile(str(tmp_path / "j"), _meta(jsnap), jspec, jstate,
                                         junits, **kw)
    assert len(files) == len(jfiles) == n_files
    for f, jf in zip(files, jfiles):
        with open(f, "rb") as a, open(jf, "rb") as b:
            assert a.read() == b.read()
    for base in ("t", "j"):
        path = str(tmp_path / base)
        assert snap.snapshot_type(path) == jsnap.snapshot_type(path) == "gadget"
        _assert_loaded_equal(snap.load(path), jsnap.load(path))


def test_gadget_components_are_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    comps, jcomps = {}, {}
    for name, n, mass in (("matter", 64, 2.0), ("b", 32, 0.5)):
        pos = rng.uniform(0, BOX, (n, 3)).astype(np.float32)
        mom = rng.standard_normal((n, 3)).astype(np.float32)
        comps[name] = (ComponentSpec(name, "matter", N=n, mass=mass),
                       ParticleState(torch.as_tensor(pos), torch.as_tensor(mom)))
        jcomps[name] = (JSpec(name, "matter", N=n, mass=mass), JState(pos=pos, mom=mom))
    f = snap.save_gadget_components(str(tmp_path / "t"), _meta(snap), comps, units)
    jf = jsnap.save_gadget_components(str(tmp_path / "j"), _meta(jsnap), jcomps, junits)
    with open(f, "rb") as a, open(jf, "rb") as b:
        assert a.read() == b.read()
    _assert_loaded_equal(snap.load(f), jsnap.load(f))


@pytest.mark.parametrize("masses", [[3.0] * 16, list(np.linspace(1.0, 2.0, 16))],
                         ids=["uniform", "varying"])
def test_gadget_mass_block_loads_alike(tmp_path, masses):
    """A file whose header mass is 0 carries a MASS block of per-particle
    masses (ids as uint64 here, the 64-bit form)."""
    n = len(masses)
    rng = np.random.default_rng(1)
    header = jsnap._gadget_header_bytes([0, n, 0, 0, 0, 0], [0.0] * 6, 0.5, 1.0, 1000.0,
                                        0.3, 0.7, 0.67)

    def block(payload):
        return struct.pack("<I", len(payload)) + payload + struct.pack("<I", len(payload))

    raw = (block(header) + block(rng.uniform(0, 1000, (n, 3)).astype(np.float32).tobytes())
           + block(rng.standard_normal((n, 3)).astype(np.float32).tobytes())
           + block(np.arange(n, dtype=np.uint64).tobytes())
           + block(np.asarray(masses, np.float32).tobytes()))
    fn = tmp_path / "mass.gadget"
    fn.write_bytes(raw)
    _assert_loaded_equal(snap.load(str(fn)), jsnap.load(str(fn)))


SELECTS = [None, {"matter": {"pos": True, "mom": False}}, {"all": {"ids": False}}]


@pytest.mark.parametrize("select", SELECTS, ids=["all", "no-mom", "no-ids"])
def test_concept_hdf5_files_match_and_load_alike(tmp_path, select):
    pos, mom, ids = _state()
    tstate, jstate, spec, jspec = _both(pos, mom, ids)
    rungs = np.arange(N, dtype=np.int8) % 3
    tstate = tstate._replace(rungs=torch.as_tensor(rungs))
    jstate = jstate._replace(rungs=rungs)
    ft = snap.save_concept(str(tmp_path / "t.hdf5"), _meta(snap), {"matter": (spec, tstate)},
                           select=select)
    fj = jsnap.save_concept(str(tmp_path / "j.hdf5"), _meta(jsnap),
                            {"matter": (jspec, jstate)}, select=select)
    with h5py.File(ft, "r") as a, h5py.File(fj, "r") as b:
        assert dict(a.attrs) == dict(b.attrs)
        ga, gb = a["components/matter"], b["components/matter"]
        assert dict(ga.attrs) == dict(gb.attrs)
        assert sorted(ga) == sorted(gb)
        for name in ga:
            assert ga[name].dtype == gb[name].dtype
            np.testing.assert_array_equal(ga[name][()], gb[name][()])
    if select is None:
        assert snap.snapshot_type(ft) == jsnap.snapshot_type(fj) == "concept"
        for f in (ft, fj):
            _assert_loaded_equal(snap.load(f), jsnap.load(f))
        # the float32 state comes back exactly
        _, comps = snap.load(fj)
        np.testing.assert_array_equal(comps["matter"][1].pos.astype(np.float32), pos)


@pytest.mark.parametrize("endian", ["<", ">"])
@pytest.mark.parametrize("with_units", [False, True])
def test_tipsy_loads_alike(tmp_path, endian, with_units):
    ndark = 8
    rng = np.random.default_rng(2)
    header = struct.pack(f"{endian}d i i i i i 4x", 0.5, ndark, 3, 0, ndark, 0)
    parts = [struct.pack(f"{endian}9f", 2.5, *rng.uniform(-0.5, 0.5, 3),
                         *rng.standard_normal(3), 0.01, 0.0) for _ in range(ndark)]
    fn = tmp_path / "tipsy.bin"
    fn.write_bytes(header + b"".join(parts))
    assert snap.snapshot_type(str(fn)) == jsnap.snapshot_type(str(fn)) == "tipsy"
    kw = dict(boxsize=BOX, H0=67 * units.km / (units.s * units.Mpc)) if with_units else {}
    _assert_loaded_equal(snap.load(str(fn), **kw), jsnap.load(str(fn), **kw))


def test_fluid_components_name_their_item(tmp_path):
    """A JAX-written fluid component loads in the port (it raised, naming
    ROADMAP Queue 1 item 12, before the port had fluids): the same spec
    and grids, the missing ones None."""
    spec = JSpec(name="nu", species="neutrino", representation="fluid", gridsize=4)
    from concept_tpu.components import FluidState

    fn = str(tmp_path / "fluid.hdf5")
    rho = np.random.default_rng(1).uniform(1, 2, (4, 4, 4))
    jsnap.save_concept(fn, _meta(jsnap), {"nu": (spec, FluidState(varrho=rho))})
    _, comps = snap.load(fn)
    (got_spec, got), = comps.values()
    (want_spec, want), = jsnap.load_concept(fn)[1].values()
    assert got_spec.__dict__ == want_spec.__dict__
    np.testing.assert_array_equal(got.varrho, want.varrho)
    assert got.J is got.P is got.sigma is None


def _ids_sorted_positions(fn):
    with h5py.File(fn, "r") as f:
        (g,) = f["components"].values()
        return np.asarray(g["pos"])[np.argsort(np.asarray(g["ids"]))]


def test_cli_runs_from_a_jax_written_gadget_file_agree(tmp_path):
    from concept_tpu_torch.ic import realize_particles
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import build_components, build_cosmology

    cfg = load_params(PARAM, overrides=["initial_conditions={'species':'matter','N':8**3}"])
    _, consts, bg, lin = build_cosmology(cfg)
    spec, _ = build_components(cfg, bg, consts)[0]
    st = realize_particles(lin, spec, cfg.boxsize, 0.02, seed=0, device="cpu")
    ic = str(tmp_path / "ic")
    meta = jsnap.SnapshotMeta(a=0.02, boxsize=cfg.boxsize, H0=cfg.H0, Omega_b=cfg.Omega_b,
                              Omega_cdm=cfg.Omega_cdm)
    jsnap.save_gadget(ic, meta, JSpec(spec.name, spec.species, N=spec.N, mass=spec.mass),
                      JState(pos=st.pos.numpy(), mom=st.mom.numpy()), junits)
    outs = {}
    for name, fn, extra in (("torch", main, ["--device", "cpu"]), ("jax", jax_main, [])):
        out = str(tmp_path / name)
        outs[name] = out
        assert fn(["-p", PARAM, "-c", f"initial_conditions='{ic}'",
                   "-c", "potential_options=32",
                   "-c", "output_times={'powerspec': [0.05], 'snapshot': [0.05]}",
                   "-c", f"output_dirs='{out}'", *extra]) == 0
    P, P_j = (np.loadtxt(os.path.join(outs[n], "powerspec_a=0.05.txt")) for n in ("torch",
                                                                                  "jax"))
    np.testing.assert_allclose(P[:, 0], P_j[:, 0], rtol=1e-5)  # JAX bins k in float32
    sel = P[:, 0] <= 0.5 * math.pi * 32 / cfg.boxsize
    assert sel.sum() >= 5
    np.testing.assert_allclose(P[sel, 2], P_j[sel, 2], rtol=0.01)
    pos, pos_j = (_ids_sorted_positions(os.path.join(outs[n], "snapshot_a=0.05.hdf5"))
                  for n in ("torch", "jax"))
    dx = pos - pos_j
    dx -= cfg.boxsize * np.round(dx / cfg.boxsize)
    assert np.sqrt((dx**2).sum(1)).max() / cfg.boxsize <= 1e-6


def test_a_float32_file_may_round_a_position_onto_the_box_edge(tmp_path):
    """example_basic's box is 256000 kpc/h in float32, so a particle within
    half a float32 step of the edge is written as the edge and reads back
    at ≥ boxsize.  The port wraps it to 0 (the JAX package aborts); a
    particle truly outside still aborts."""
    from concept_tpu_torch import run as run_mod
    from concept_tpu_torch.param import load_params

    cfg = load_params(PARAM)
    box = cfg.boxsize
    meta = snap.SnapshotMeta(a=0.02, boxsize=box, H0=cfg.H0, Omega_b=cfg.Omega_b,
                             Omega_cdm=cfg.Omega_cdm)
    pos = np.full((8, 3), 0.5 * box)
    pos[0, 1] = box * (1 - 1e-12)
    spec = ComponentSpec("matter", "matter", N=8, mass=1.0)
    fn = snap.save_gadget(str(tmp_path / "edge"), meta, spec,
                          ParticleState(pos, np.zeros((8, 3))), cfg.units)
    _, st = run_mod.load_snapshot_component(cfg, fn, cfg.units)
    assert st.pos[0, 1] >= box
    moved = run_mod._to_device(st, torch.device("cpu"), torch.float32, box)
    assert float(moved.pos[0, 1]) == 0.0 and float(moved.pos.max()) < box
    pos[0, 1] = 1.01 * box
    fn = snap.save_gadget(str(tmp_path / "out"), meta, spec,
                          ParticleState(pos, np.zeros((8, 3))), cfg.units)
    with pytest.raises(SystemExit):
        run_mod.load_snapshot_component(load_params(PARAM), fn, cfg.units)
