"""The port's Boltzmann layer vs the JAX package's: the internal
Einstein-Boltzmann solver (concept_tpu_torch.cosmology.ebsolver) and its
recombination history, the tables (cosmology.boltzmann) as build_cosmology
installs them for param/example_nonlinnu.py, the run of that
configuration's matter component, backend selection, the CLASS bridge's
gate and the ``-u class`` utility.

The configuration is example_nonlinnu's (Σmν = 0.5 eV) with its matter
component only, 8³ particles on grid 16, and the light
boltzmann_options of tests/test_cli_e2e.py: 8 modes, k = 0.0105-3.0 /Mpc,
96 scale factors.

- The solver's tests read no cache.  The right-hand sides, initial
  conditions and Jacobian sparsity agree to rtol 1e-12 (the same float64
  NumPy code), and so do the two lowest modes solved by each package
  (1e-10).  Those two modes also equal the columns of
  tests/fixtures/eb/eb_5c2f1bb77ed40020.npz at 1e-10, so every run shows
  that the fixture's rows are what the solver gives today.
- The table and end-to-end tests read the fixture's rows from a cache
  directory of their own, under the file key of today's configuration
  (the fixture's own file name is an older key).  The test asserts that
  the port's key equals the JAX package's formula, and that no other
  table was written, so neither side solves: they compare everything
  after the solve.  The installed tables are equal; the interpolation
  (float32 tables on both sides) agrees to 1e-6, σ_R to 1e-6; the
  spectra of the run to 1 % (tests/test_torch_run.py) and its realized
  particles to 1e-5 of the box and of the largest momentum
  (tests/test_torch_ic.py)."""

import glob
import hashlib
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from concept_tpu.cosmology import backend as jax_backend  # noqa: E402
from concept_tpu.cosmology import class_bridge as jax_class_bridge  # noqa: E402
from concept_tpu.cosmology import ebsolver as jax_eb  # noqa: E402
from concept_tpu_torch.cosmology import backend, class_bridge, ebsolver as eb  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM = os.path.join(ROOT, "param", "example_nonlinnu.py")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "eb", "eb_5c2f1bb77ed40020.npz")
KEY = "41b37a4fde5ce466"  # today's file key of the configuration below
OPTIONS = ("'modes_per_decade':3,'rtol':1e-4,'n_q':4,'l_max_ncdm':6,'l_max_ur':10,"
           "'k_max':3.0")
SHRUNK = ["initial_conditions={'species':'matter','N':8**3}", "potential_options=16"]
RTOL = 1e-12


@pytest.fixture(scope="module")
def _jax_cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("reusable"))


@pytest.fixture(autouse=True)
def _fresh_jax_cache(_jax_cache, monkeypatch):
    """The JAX background caches its tables on disk: a directory of this
    module's makes it compute each cosmology once."""
    monkeypatch.setenv("CONCEPT_TPU_CACHE", _jax_cache)


def _eb_params(module, **exotic):
    """EBParams of example_nonlinnu as build_tables makes them (h from
    H0 in the param's units), or of an exotic cosmology."""
    if exotic:
        return module.EBParams(**exotic)
    return module.EBParams(h=0.6699999999999999, Omega_b=0.049, Omega_cdm=0.259, N_ur=0.0,
                           m_ncdm=0.5 / 3, N_ncdm=3, l_max_ur=10, l_max_ncdm=6, n_q=4)


COSMOLOGIES = {
    "nu": {},
    "dcdm": dict(Omega_dcdm=0.05, Gamma_dcdm=100.0 / 299792.458, l_max_g=8, l_max_pol=6,
                 l_max_ur=8, l_max_dr=8),
    "cpl": dict(Omega_fld=0.7, w0_fld=-0.9, wa_fld=0.1, l_max_g=8, l_max_pol=6, l_max_ur=8),
}


@pytest.mark.parametrize("case", sorted(COSMOLOGIES))
def test_solver_equations_match_jax(case):
    """EBSolver._rhs and _rhs_rsa on random states, the initial
    conditions, the Jacobian's sparsity and the recombination history."""
    solver = eb.EBSolver(_eb_params(eb, **COSMOLOGIES[case]))
    ref = jax_eb.EBSolver(_eb_params(jax_eb, **COSMOLOGIES[case]))
    assert solver.n_eq == ref.n_eq
    rng = np.random.default_rng(11)
    n_rsa = ref.n_eq - (ref.i_nc - 5)  # the RSA drops the radiation hierarchies
    for k in (0.02, 0.3):
        for lna in np.log([1e-5, 1e-3, 0.5]):
            y = rng.standard_normal(ref.n_eq)
            np.testing.assert_allclose(solver._rhs(lna, y, k), ref._rhs(lna, y, k),
                                       rtol=RTOL, atol=0)
            y2 = rng.standard_normal(n_rsa)
            np.testing.assert_allclose(solver._rhs_rsa(lna, y2, k), ref._rhs_rsa(lna, y2, k),
                                       rtol=RTOL, atol=0)
        np.testing.assert_allclose(solver._initial_conditions(k, 1e-6, 0.01),
                                   ref._initial_conditions(k, 1e-6, 0.01), rtol=RTOL, atol=0)
    assert (solver._jac_sparsity() != ref._jac_sparsity()).nnz == 0
    a = np.geomspace(1e-5, 1.0, 40)
    for fn in ("x_e", "kappa_dot", "cs2_baryon"):
        np.testing.assert_allclose([getattr(solver.bg.rec, fn)(x) for x in a],
                                   [getattr(ref.bg.rec, fn)(x) for x in a], rtol=RTOL,
                                   err_msg=fn)
    np.testing.assert_allclose(solver.bg.tau_of_a(a), ref.bg.tau_of_a(a), rtol=RTOL)


@pytest.mark.parametrize("mode", [0, 1])
def test_solved_mode_matches_jax_and_fixture(mode):
    """Mode 0 or 1 of the configuration solved by both packages, with no
    cache (1e-10); normalised by −ℛ_init as solve_tables does, both equal
    the fixture's column (1e-10).  The fixture predates the export of
    α, which the N-body gauge does not use."""
    with np.load(FIXTURE) as z:
        rows = {name: z[name] for name in z.files}
    a_out = np.logspace(np.log10(0.01 / 5), 0.0, 96)
    np.testing.assert_array_equal(rows["a"], a_out)
    k = float(rows["k_mpc"][mode])
    got = eb.EBSolver(_eb_params(eb)).solve_mode(k, a_out, rtol=1e-4)
    want = jax_eb.EBSolver(_eb_params(jax_eb)).solve_mode(k, a_out, rtol=1e-4)
    assert set(got) == set(want) == set(rows) - {"k_mpc", "a"} | {"alpha"}
    norm, norm_j = -got["R_init"][0], -want["R_init"][0]
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-10, atol=0, err_msg=name)
        if name == "alpha":
            continue
        div = 1.0 if name in ("R_init", "a_rsa", "tau") else norm
        div_j = 1.0 if name in ("R_init", "a_rsa", "tau") else norm_j
        for series in (got[name] / div, want[name] / div_j):
            np.testing.assert_allclose(series, rows[name][:, mode], rtol=1e-10, atol=0,
                                       err_msg=name)


def _jax_file_key(params, k_mpc, a_out, rtol):
    """The JAX package's cache key (concept_tpu/cosmology/ebsolver.py,
    solve_tables), written out."""
    return hashlib.sha256(
        (params.key() + np.asarray(k_mpc).tobytes().hex()
         + a_out.tobytes().hex() + f"{rtol}").encode()
    ).hexdigest()[:16]


@pytest.fixture
def seeded_cache(tmp_path):
    """A cache directory holding the fixture's rows under the file key of
    today's configuration: the port's key, equal to the JAX formula's."""
    with np.load(FIXTURE) as z:
        k_mpc, a_out = z["k_mpc"], z["a"]
    key = eb.table_key(_eb_params(eb), k_mpc, a_out, 1e-4)
    assert key == _jax_file_key(_eb_params(jax_eb), k_mpc, a_out, 1e-4) == KEY
    cache = tmp_path / "eb"
    cache.mkdir()
    shutil.copy(FIXTURE, cache / f"eb_{key}.npz")
    yield str(cache)
    assert os.listdir(cache) == [f"eb_{key}.npz"], "a table was solved"


def _overrides(cache, extra=()):
    return [*SHRUNK, f"boltzmann_options={{{OPTIONS},'cache_dir':'{cache}'}}", *extra]


def test_tables_match_jax(seeded_cache):
    """build_cosmology of both packages on the seeded cache: the same
    backend, the same N-body-gauge tables, δ/θ/σ per species through the
    float32 interpolation, and σ_R."""
    from concept_tpu.param import load_params as jax_load
    from concept_tpu.run import build_cosmology as jax_build
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import build_cosmology

    units, _, bg, lin = build_cosmology(load_params(PARAM, overrides=_overrides(seeded_cache)))
    _, _, bg_j, lin_j = jax_build(jax_load(PARAM, overrides=_overrides(seeded_cache)))
    T, J = lin.tables, lin_j.tables
    assert T.gauge == J.gauge == "nbody"
    assert sorted(T.tables) == sorted(J.tables) and sorted(T.aux) == sorted(J.aux)
    np.testing.assert_array_equal(T.k, J.k)
    np.testing.assert_array_equal(T.a, J.a)
    for key in T.tables:
        np.testing.assert_allclose(T.tables[key], J.tables[key], rtol=1e-10, atol=0,
                                   err_msg=str(key))
    k = np.geomspace(0.012, 2.9, 64).astype(np.float32) / np.float32(units.Mpc)
    for species in ("matter", "cb", "nu", "radiation", "photon", "ur", "b", "cdm"):
        for a in (0.0025, 0.02, 1.0):
            for fn in ("transfer_delta", "transfer_theta", "transfer_sigma"):
                want = getattr(lin_j, fn)(jnp.asarray(k), a, species)
                got = getattr(lin, fn)(torch.as_tensor(k), a, species)
                if want is None:
                    assert got is None
                    continue
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max(),
                                           err_msg=f"{fn} {species} a={a}")
    assert lin.sigma8() == pytest.approx(lin_j.sigma8(), rel=1e-6)
    assert lin.sigma_R(20 * units.Mpc, 0.02) == pytest.approx(
        lin_j.sigma_R(20 * units.Mpc, 0.02), rel=1e-6)


def test_nonlinnu_run_matches_jax(tmp_path, seeded_cache, monkeypatch):
    """The configuration through run.run of both packages to a = 0.04,
    on the CPU: the spectra agree bin by bin to 1 % up to half the
    Nyquist wavenumber, and the particles each run realized at a_begin
    to 1e-5."""
    import concept_tpu.ic
    import concept_tpu_torch.ic
    from concept_tpu.param import load_params as jax_load
    from concept_tpu.run import run as jax_run
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    realized = []
    for module in (concept_tpu_torch.ic, concept_tpu.ic):
        def keep(*args, _realize=module.realize_particles, **kw):
            realized.append(_realize(*args, **kw))
            return realized[-1]

        monkeypatch.setattr(module, "realize_particles", keep)
    extra = ["output_times={'powerspec': [0.04]}"]
    out_t, out_j = tmp_path / "torch", tmp_path / "jax"
    sim, _, a = run(load_params(PARAM, overrides=_overrides(
        seeded_cache, extra + [f"output_dirs='{out_t}'"])), device="cpu")
    sim_j, _, a_j = jax_run(jax_load(PARAM, overrides=_overrides(
        seeded_cache, extra + [f"output_dirs='{out_j}'"])))
    assert a == pytest.approx(0.04) and float(a_j) == pytest.approx(0.04)
    assert sim.lin.tables is not None and sim_j.lin.tables is not None
    P, P_j = (np.loadtxt(glob.glob(str(d / "powerspec_a=0.04.txt"))[0]) for d in (out_t, out_j))
    np.testing.assert_allclose(P[:, 0], P_j[:, 0], rtol=1e-5)  # JAX bins k in float32
    boxsize = 200 / 0.67  # the param's box, in Mpc like the k column
    sel = P[:, 0] <= 0.5 * np.pi * 16 / boxsize
    assert sel.sum() >= 3
    np.testing.assert_allclose(P[sel, 2], P_j[sel, 2], rtol=0.01)

    box = sim.config.boxsize
    got, ref = realized
    dx = got.pos.numpy() - np.asarray(ref.pos)
    dx -= box * np.round(dx / box)
    assert np.abs(dx).max() <= 1e-5 * box
    mom_j = np.asarray(ref.mom)
    assert np.abs(got.mom.numpy() - mom_j).max() <= 1e-5 * np.abs(mom_j).max()


# the branches of select_backend (concept_tpu/cosmology/backend.py:56-89)
BACKENDS = {
    "default": ("auto", {}, {"species": "matter", "N": 8}, {}, False),
    "eh": ("eh", {"N_ncdm": 1}, {"species": "matter", "N": 8}, {}, False),
    "eb": ("eb", {}, {"species": "matter", "N": 8}, {}, False),
    "class-without-classy": ("class", {}, {"species": "matter", "N": 8}, {}, False),
    "class-with-classy": ("class", {}, {"species": "matter", "N": 8}, {}, True),
    "auto-classy": ("auto", {}, {"species": "matter", "N": 8}, {}, True),
    "auto-ncdm": ("auto", {"N_ncdm": 1}, {"species": "matter", "N": 8}, {}, False),
    "auto-neutrino": ("auto", {}, [{"species": "matter", "N": 8},
                                   {"species": "neutrino", "gridsize": 8}], {}, False),
    "auto-photon": ("auto", {}, {"species": "photon", "gridsize": 8}, {}, False),
    "auto-metric": ("auto", {}, {"species": "metric", "gridsize": 8}, {}, False),
    "auto-boltzmann-order": ("auto", {}, {"species": "matter", "gridsize": 8,
                                          "boltzmann order": 1}, {}, False),
    "auto-select-order": ("auto", {}, {"species": "matter", "N": 8}, {"all": 1}, False),
}


@pytest.mark.parametrize("case", sorted(BACKENDS))
def test_select_backend_matches_jax(case, monkeypatch):
    name, cp, ics, orders, classy = BACKENDS[case]
    monkeypatch.setattr(backend, "_classy_available", lambda: classy)
    monkeypatch.setattr(jax_backend, "_classy_available", lambda: classy)
    cfg = SimpleNamespace(boltzmann_backend=name, class_params=cp, initial_conditions=ics,
                          select_boltzmann_order=orders)
    assert backend.select_backend(cfg) == jax_backend.select_backend(cfg)


def test_class_bridge_is_gated_as_jax(monkeypatch):
    """Where classy does not import, the bridge is unavailable and
    refuses to start, and 'class' resolves to 'eb', as in the JAX
    package."""
    import sys

    monkeypatch.setitem(sys.modules, "classy", None)
    assert class_bridge.available() is jax_class_bridge.available() is False
    assert backend._classy_available() is jax_backend._classy_available() is False
    for module in (class_bridge, jax_class_bridge):
        with pytest.raises(ModuleNotFoundError, match="classy"):
            module.ClassBridge({"h": 0.67})
    cfg = SimpleNamespace(boltzmann_backend="class", class_params={},
                          initial_conditions=None, select_boltzmann_order={})
    assert backend.select_backend(cfg) == jax_backend.select_backend(cfg) == "eb"


def test_util_class_matches_jax(tmp_path):
    """``-u class`` on the default cosmology (EH): the HDF5 of both
    packages holds the same datasets and attributes."""
    h5py = pytest.importorskip("h5py")
    from concept_tpu.utilities import util_class as jax_util_class
    from concept_tpu_torch.utilities import util_class

    out_t, out_j = str(tmp_path / "torch.hdf5"), str(tmp_path / "jax.hdf5")
    args = ["--modes", "32", "--times", "0.02,1.0"]
    assert util_class([out_t, *args], SimpleNamespace(param=None)) == 0
    assert jax_util_class([out_j, *args], SimpleNamespace(param=None)) == 0
    with h5py.File(out_t) as f, h5py.File(out_j) as g:
        assert dict(f.attrs) == dict(g.attrs)
        names = []
        f.visit(names.append)
        gnames = []
        g.visit(gnames.append)
        assert names == gnames
        for name in names:
            if isinstance(f[name], h5py.Dataset):
                want = g[name][()]
                rtol = 1e-10 if want.dtype == np.float64 else 1e-5
                np.testing.assert_allclose(f[name][()], want, rtol=rtol, err_msg=name)
