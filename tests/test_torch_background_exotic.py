"""The port's exotic background and analytic species vs the JAX package's:
the Fermi-Dirac neutrino background (concept_tpu_torch.cosmology.neutrino),
the Background with massive neutrinos, curvature, a CPL dark-energy
fluid and decaying cold dark matter, build_cosmology's class_params
plumbing, and the Eisenstein-Hu no-wiggle and EH99 massive-neutrino
transfer functions with the species of the linear layer.

The cases are those of tests/test_neutrino.py,
tests/test_neutrino_background.py and tests/test_background_exotic.py.
The backgrounds are float64 NumPy code of the same algorithm on both
sides: H(a), the growth tables, t(a), a(t) and the step integrals agree
to rtol 1e-10.  The JAX package's ρ_ν(a) for jitted code (a jnp spline)
is compared under 64-bit mode at 1e-6, as are the analytic species at
the 1e-10 of tests/test_torch_cosmology.py.  The JAX background caches
its tables on disk: this module points that cache at a directory of its
own, so that the JAX side computes each cosmology once."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax  # noqa: E402

from concept_tpu.cosmology import neutrino as jax_nu  # noqa: E402
from concept_tpu.cosmology import transfer as jax_transfer  # noqa: E402
from concept_tpu.cosmology.background import Background as JaxBackground  # noqa: E402
from concept_tpu.cosmology.linear import LinearCosmology as JaxLinear  # noqa: E402
from concept_tpu.cosmology.primordial import PrimordialSpectrum as JaxPrim  # noqa: E402
from concept_tpu_torch.cosmology import neutrino as nu  # noqa: E402
from concept_tpu_torch.cosmology import transfer  # noqa: E402
from concept_tpu_torch.cosmology.background import Background  # noqa: E402
from concept_tpu_torch.cosmology.linear import LinearCosmology  # noqa: E402
from concept_tpu_torch.cosmology.primordial import PrimordialSpectrum  # noqa: E402
from concept_tpu_torch.units import constants, units  # noqa: E402

RTOL = 1e-10
H0 = 67 * units.km / (units.s * units.Mpc)
GROWTH = ("D1", "f1", "D2", "f2", "D3a", "f3a", "D3b", "f3b", "D3c", "f3c")


@pytest.fixture(scope="module")
def _jax_cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("reusable"))


@pytest.fixture(autouse=True)
def _fresh_jax_cache(_jax_cache, monkeypatch):
    monkeypatch.setenv("CONCEPT_TPU_CACHE", _jax_cache)


# (m_ν in eV, N_ν): tests/test_neutrino_background.py's species
NEUTRINOS = [(0.05, 1), (0.1, 1), (0.3, 1), (0.1, 3)]


@pytest.mark.parametrize("m,N", NEUTRINOS)
def test_neutrino_background_matches_jax(m, N):
    y = np.concatenate([[0.0], np.geomspace(1e-4, 1e3, 40)])
    np.testing.assert_allclose(nu.fermi_dirac_F(y), jax_nu.fermi_dirac_F(y), rtol=RTOL)
    np.testing.assert_allclose(nu.fermi_dirac_G(y), jax_nu.fermi_dirac_G(y), rtol=RTOL)
    got, ref = nu.NeutrinoBackground(m, N), jax_nu.NeutrinoBackground(m, N)
    a = np.geomspace(1e-7, 1.0, 60)
    for fn in ("w", "w_eff", "rho_ratio_np"):
        np.testing.assert_allclose(getattr(got, fn)(a), getattr(ref, fn)(a), rtol=RTOL,
                                   err_msg=fn)
    assert got.omega_nu_h2() == pytest.approx(ref.omega_nu_h2(), rel=RTOL)
    with jax.enable_x64(True):
        ref64 = jax_nu.NeutrinoBackground(m, N)
        want = np.asarray(ref64.rho_ratio(a))
    np.testing.assert_allclose(got.rho_ratio(torch.as_tensor(a)).numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(got.rho_ratio(torch.as_tensor(a)).numpy(),
                               got.rho_ratio_np(a), rtol=1e-12)


def _nu_kwargs(m, N, Omega_m):
    """Ω_ν and the two packages' neutrino backgrounds for m_ν = m."""
    nubg, jnubg = nu.NeutrinoBackground(m, N), jax_nu.NeutrinoBackground(m, N)
    Omega_nu = nubg.omega_nu_h2() / 0.67**2
    return (dict(Omega_m=Omega_m, Omega_nu=Omega_nu, nu_background=nubg),
            dict(Omega_m=Omega_m, Omega_nu=Omega_nu, nu_background=jnubg))


# the backgrounds of tests/test_background_exotic.py (and a massive-ν one)
BACKGROUNDS = {
    "nu": lambda: _nu_kwargs(0.1, 3, 0.3),
    "wcdm": lambda: 2 * (dict(Omega_m=0.3, Omega_lambda=0.0, Omega_fld=0.7,
                              w0_fld=-0.9, wa_fld=0.1),),
    "curvature": lambda: 2 * (dict(Omega_m=0.3, Omega_k=0.05),),
    "curvature-fld-closure": lambda: 2 * (dict(Omega_m=0.3, Omega_k=0.02, Omega_fld=0.1,
                                               w0_fld=-0.8, Omega_lambda=None),),
    "dcdm": lambda: 2 * (dict(Omega_m=0.25, Omega_dcdm=0.05, Gamma_dcdm=0.3 * H0),),
}


@pytest.mark.parametrize("case", sorted(BACKGROUNDS))
def test_exotic_background_matches_jax(case):
    kw, jkw = BACKGROUNDS[case]()
    bg, ref = Background(H0=H0, **kw), JaxBackground(H0=H0, **jkw)
    for name in ("Omega_lambda", "Omega_dcdm", "Omega_dr", "Omega_ini_dcdm", "Omega_fld"):
        want = getattr(ref, name)
        if want is None:
            assert getattr(bg, name) is None
        else:
            assert getattr(bg, name) == pytest.approx(want, rel=RTOL, abs=1e-300), name
    assert bg._exotic == ref._exotic
    a = np.geomspace(1e-3, 1.0, 60)
    np.testing.assert_allclose(bg.hubble_np(a), ref.hubble_np(a), rtol=RTOL)
    np.testing.assert_allclose(bg.addot_np(a), ref.addot_np(a), rtol=1e-8)
    np.testing.assert_allclose(bg.t_of_a_np(a), ref.t_of_a_np(a), rtol=RTOL)
    t = ref.t_of_a_np(a)
    np.testing.assert_allclose(bg.a_of_t_np(t), ref.a_of_t_np(t), rtol=RTOL)
    for g in GROWTH:
        np.testing.assert_allclose(bg.growth_np(g, a), ref.growth_np(g, a), rtol=RTOL,
                                   err_msg=g)
    keys = ("1", "a**2", "a**(-1)", "a**(-2)", "ȧ/a")
    got, want = bg.integrals_np(t[5], t[40], keys=keys), ref.integrals_np(t[5], t[40], keys=keys)
    for k in keys:
        assert got[k] == pytest.approx(want[k], rel=RTOL), k
    assert bg.integral_power_np(t[5], t[40], -1.5) == pytest.approx(
        ref.integral_power_np(t[5], t[40], -1.5), rel=RTOL)
    if bg._has_dcdm:
        np.testing.assert_allclose(bg.rho_ratio_dcdm_np(a), ref.rho_ratio_dcdm_np(a), rtol=RTOL)
        np.testing.assert_allclose(bg.rho_ratio_dr_np(a), ref.rho_ratio_dr_np(a), rtol=RTOL)
        np.testing.assert_allclose(bg.w_eff_dcdm_np(a[:-1]), ref.w_eff_dcdm_np(a[:-1]),
                                   rtol=RTOL)
        fn, jfn = bg.w_eff_dcdm_np, ref.w_eff_dcdm_np
        assert bg.integral_custom_np(t[5], t[40], lambda x: x ** (-3 * fn(x))) == pytest.approx(
            ref.integral_custom_np(t[5], t[40], lambda x: x ** (-3 * jfn(x))), rel=RTOL)
    if bg.Omega_fld:
        np.testing.assert_allclose(bg.fld_rho_ratio_np(a), ref.fld_rho_ratio_np(a), rtol=RTOL)
        np.testing.assert_allclose(bg.w_fld(a), ref.w_fld(a), rtol=RTOL)


def _run_config(package, Omega_cdm, class_params, enable_Hubble=True):
    """A RunConfig of ``package`` as tests/test_background_exotic.py
    builds them, with the analytic backend."""
    import importlib

    cfg = importlib.import_module(package.__name__ + ".param").RunConfig()
    cfg.units = importlib.import_module(package.__name__ + ".units").UnitSystem(
        "Mpc", "Gyr", "1e10 m_sun")
    cfg.H0 = 67 * cfg.units.km / (cfg.units.s * cfg.units.Mpc)
    cfg.Omega_b = 0.05
    cfg.Omega_cdm = Omega_cdm
    cfg.boltzmann_backend = "eh"
    cfg.class_params = class_params
    cfg.enable_Hubble = enable_Hubble
    return cfg


# (Ωcdm, class_params, whether to tabulate a(t) and the growth: the
# decay's background is held to the JAX package's above, and its solve
# comes before the tables)
CLASS_PARAMS = {
    "fld-closure": (0.25, {"Omega_k": 0.02, "Omega_Lambda": 0.0, "w0_fld": -0.9,
                           "wa_fld": 0.05}, True),
    "dcdm-ini": (0.22, {"Omega_ini_dcdm": 0.06, "Gamma_dcdm": 20.0}, False),
    "nu": (0.259, {"N_ur": 0, "N_ncdm": 1, "deg_ncdm": 3, "m_ncdm": 0.5 / 3}, True),
}


@pytest.mark.parametrize("case", sorted(CLASS_PARAMS))
def test_build_cosmology_class_params_match_jax(case):
    """class_params reach the background as in the JAX package: the fld
    closure of Omega_Lambda: 0, Omega_ini_dcdm with Gamma_dcdm in
    km/s/Mpc, Ω_ν from the Fermi-Dirac integral."""
    import concept_tpu.run
    import concept_tpu_torch.run

    Omega_cdm, cp, tabulate = CLASS_PARAMS[case]
    _, _, bg, lin = concept_tpu_torch.run.build_cosmology(
        _run_config(concept_tpu_torch, Omega_cdm, dict(cp), tabulate))
    _, _, ref, lin_j = concept_tpu.run.build_cosmology(
        _run_config(concept_tpu, Omega_cdm, dict(cp), tabulate))
    for name in ("Omega_lambda", "Omega_k", "Omega_fld", "w0_fld", "wa_fld", "Omega_dcdm",
                 "Omega_ini_dcdm", "Gamma_dcdm", "Omega_dr", "Omega_nu"):
        assert getattr(bg, name) == pytest.approx(getattr(ref, name), rel=RTOL), name
    assert lin.Omega_nu == pytest.approx(lin_j.Omega_nu, rel=RTOL)
    assert lin.N_nu == lin_j.N_nu
    assert (lin.nu_background is None) == (lin_j.nu_background is None)
    a = np.geomspace(1e-3, 1.0, 30)
    np.testing.assert_allclose(bg._E2_np(a), ref._E2_np(a), rtol=RTOL)
    if tabulate:
        np.testing.assert_allclose(bg.hubble_np(a), ref.hubble_np(a), rtol=RTOL)
        np.testing.assert_allclose(bg.growth_np("D1", a), ref.growth_np("D1", a), rtol=RTOL)


def test_omega_lambda_zero_with_decay_raises_as_jax():
    import concept_tpu
    import concept_tpu.run
    import concept_tpu_torch
    import concept_tpu_torch.run

    cp = {"Omega_Lambda": 0.0, "Omega_dcdm": 0.03, "Gamma_dcdm": 100.0}
    for package in (concept_tpu, concept_tpu_torch):
        with pytest.raises(ValueError, match="Gamma_dcdm"):
            package.run.build_cosmology(_run_config(package, 0.22, dict(cp)))


def test_example_basic_background_unchanged():
    """Port only: example_basic's cosmology takes the matter + Λ path it
    took before the exotic sectors came: no exotic sector, no tables,
    H(a) the closed form bit for bit, and the same background as one
    built with the matter + Λ arguments alone."""
    import os

    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import build_cosmology

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_params(os.path.join(root, "param", "example_basic.py"))
    _, _, bg, lin = build_cosmology(cfg)
    assert lin.tables is None and lin.Omega_nu == 0.0 and not bg._exotic
    assert bg.Omega_lambda == 1.0 - cfg.Omega_m
    a = np.geomspace(1e-4, 1.0, 50)
    np.testing.assert_array_equal(bg.hubble_np(a),
                                  bg.H0 * np.sqrt(cfg.Omega_m / a**3 + bg.Omega_lambda))
    plain = Background(H0=cfg.H0, Omega_m=cfg.Omega_m)
    for g in GROWTH:
        np.testing.assert_array_equal(bg.growth_np(g, a), plain.growth_np(g, a))
    np.testing.assert_array_equal(bg.t_of_a_np(a), plain.t_of_a_np(a))
    t = bg.t_of_a_np(a)
    assert bg.integrals_np(t[3], t[30]) == plain.integrals_np(t[3], t[30])


# --------------------------------------------------------------------- #
# analytic species (tests/test_neutrino.py's cosmologies)
# --------------------------------------------------------------------- #
def _linear_pair(Omega_nu):
    Ob, Ocdm = 0.049, 0.27 - Omega_nu
    prim = dict(A_s=2.1e-9, n_s=0.96, pivot=0.05 / units.Mpc)
    args = dict(Omega_b=Ob, Omega_cdm=Ocdm, Omega_nu=Omega_nu,
                light_speed=constants.light_speed, Mpc=units.Mpc)
    lin = LinearCosmology(Background(H0=H0, Omega_m=Ob + Ocdm + Omega_nu),
                          PrimordialSpectrum(**prim), **args)
    lin_j = JaxLinear(JaxBackground(H0=H0, Omega_m=Ob + Ocdm + Omega_nu), JaxPrim(**prim),
                      **args)
    return lin, lin_j


@pytest.mark.parametrize("Omega_nu", [0.0, 0.02])
def test_analytic_species_match_jax(Omega_nu):
    """EisensteinHuNoWiggle, EisensteinHuNuTransfer (master, growth
    ratios) and transfer_delta / transfer_theta of 'matter', 'cb', 'nu'
    and 'radiation' on the EH path, in 64-bit mode on the JAX side."""
    k = np.geomspace(1e-4, 20.0, 120) / units.Mpc
    nw = transfer.EisensteinHuNoWiggle(0.319, 0.049, 0.67, units.Mpc)(k)
    with jax.enable_x64(True):
        nw_j = np.asarray(jax_transfer.EisensteinHuNoWiggle(0.319, 0.049, 0.67, units.Mpc)(k))
        lin, lin_j = _linear_pair(Omega_nu)
        species = ("matter", "cb", "nu", "radiation") if Omega_nu else ("matter", "radiation")
        want = {(s, a): (np.asarray(lin_j.transfer_delta(k, a, s)),
                         np.asarray(lin_j.transfer_theta(k, a, s)))
                for s in species for a in (0.02, 0.5, 1.0)}
        if Omega_nu:
            t_j = lin_j._transfer_nu
            master_j = np.asarray(t_j.master(k))
            ratios_j = {s: np.asarray(t_j.growth_ratio(k, 0.3, s)) for s in ("cb", "cbnu")}
    np.testing.assert_allclose(nw, nw_j, rtol=RTOL)
    for (s, a), (d_j, th_j) in want.items():
        np.testing.assert_allclose(lin.transfer_delta(k, a, s), d_j, rtol=RTOL, err_msg=s)
        np.testing.assert_allclose(lin.transfer_theta(k, a, s), th_j, rtol=RTOL, err_msg=s)
    if Omega_nu:
        t = lin._transfer_nu
        np.testing.assert_allclose(t.master(k), master_j, rtol=RTOL)
        for s, r_j in ratios_j.items():
            np.testing.assert_allclose(t.growth_ratio(k, 0.3, s), r_j, rtol=RTOL)
        # f_cb δ_cb + f_ν δ_ν = δ_m (tests/test_neutrino.py)
        d = {s: lin.transfer_delta(k, 1.0, s) for s in ("matter", "cb", "nu")}
        np.testing.assert_allclose(t.f_cb * d["cb"] + t.f_nu * d["nu"], d["matter"],
                                   rtol=1e-10)
    assert transfer.k_is_f64(k) and transfer.k_is_f64(torch.as_tensor(k))
    assert not transfer.k_is_f64(k.astype(np.float32))
    for kind in ("eh", "nowiggle"):
        assert type(transfer.make_transfer(kind, 0.3, 0.05, 0.67)).__name__ == type(
            jax_transfer.make_transfer(kind, 0.3, 0.05, 0.67)).__name__
    for kind, err in (("class", ModuleNotFoundError), ("bbks", ValueError)):
        with pytest.raises(err):
            transfer.make_transfer(kind, 0.3, 0.05, 0.67)
