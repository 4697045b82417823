"""The port's fluid solvers (concept_tpu_torch.fluid) vs the JAX package's
concept_tpu/fluid.py on the CPU: every flux limiter, the Kurganov-Tadmor
step at Runge-Kutta order 1 and 2, with and without the shear, with its
own 𝒫 and with 𝒫 = wϱc², the MacCormack step at both parities, the
vacuum redistribution and clamp, and the Hubble source; plus mass
conservation, as tests/test_fluid.py holds it for the JAX package.

The grids are 8³-16³, made from a numpy seed.  The JAX functions run
with jit disabled (op by op: the same arithmetic without a compile per
static configuration).  Tolerances: max |Δ| within 1e-5 of the largest
value in float32 and 1e-10 in float64 (under ``jax.enable_x64``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from concept_tpu import fluid as jf  # noqa: E402
from concept_tpu_torch import fluid as tf  # noqa: E402

BOX = 3.0
TOL = {np.float32: 1e-5, np.float64: 1e-10}


def _close(got, want, dtype, what=""):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype == dtype, what
    err = np.abs(got - want).max()
    assert err <= TOL[dtype] * max(np.abs(want).max(), 1e-30), (what, err)


def _fields(n, dtype, seed=0, sigma=False):
    """A lumpy positive ϱ, J, 𝒫 (and a packed shear) on an n³ grid."""
    rng = np.random.default_rng(seed)
    x = np.arange(n) * 2 * np.pi / n
    bump = np.sin(x)[:, None, None] * np.cos(2 * x)[None, :, None] + np.cos(x)[None, None, :]
    rho = (2.0 + 0.4 * bump + 0.1 * rng.standard_normal((n, n, n))).astype(dtype)
    J = (0.3 * rng.standard_normal((3, n, n, n))).astype(dtype)
    P = (0.2 * rho + 0.02 * rng.standard_normal((n, n, n))).astype(dtype)
    s = (0.05 * rng.standard_normal((6, n, n, n))).astype(dtype) if sigma else None
    return rho, J, P, s


def _t(a):
    return None if a is None else torch.as_tensor(a)


@pytest.mark.parametrize("name", sorted(jf.FLUX_LIMITERS))
def test_limiter_matches_jax(name):
    assert sorted(tf.FLUX_LIMITERS) == sorted(jf.FLUX_LIMITERS)
    r = np.concatenate([np.linspace(-5, 5, 401), [0.0, 1e-30, -1e-30, 1e6, -1e6]])
    for dtype in (np.float32, np.float64):
        with jax.enable_x64(dtype == np.float64):
            want = np.asarray(jf.FLUX_LIMITERS[name](jnp.asarray(r.astype(dtype))))
        _close(tf.FLUX_LIMITERS[name](torch.as_tensor(r.astype(dtype))), want, dtype, name)


KT_CASES = [(rk, shear, own_P) for rk in (1, 2) for shear in (False, True)
            for own_P in (True, False)]


@pytest.mark.parametrize("rk, shear, own_P", KT_CASES,
                         ids=[f"rk{rk}-{'shear' if s else 'noshear'}-{'ownP' if o else 'wrho'}"
                              for rk, s, o in KT_CASES])
def test_kt_step_matches_jax(rk, shear, own_P):
    """One KT drift step of both packages from one state: an 8³ float32
    grid with the 'mc' limiter and an 8³ float64 grid with 'vanleer'."""
    for n, dtype, limiter in ((8, np.float32, "mc"), (8, np.float64, "vanleer")):
        rho, J, P, s = _fields(n, dtype, seed=rk + 2 * shear, sigma=shear)
        args = (0.01, 0.9, 1.1, BOX, 0.4, 0.5)
        kw = dict(limiter=limiter, rk_order=rk, approx_P_eq_wrho=not own_P, w=0.15,
                  light_speed=1.3)
        got = tf.kt_step(_t(rho), _t(J), _t(P), *args, sigma=_t(s), **kw)
        with jax.enable_x64(dtype == np.float64), jax.disable_jit():
            sig = None if s is None else [[jnp.asarray(s[tf.SIGMA_INDEX[tuple(sorted((m, ax)))]])
                                           for ax in range(3)] for m in range(3)]
            want = jf.kt_step(jnp.asarray(rho), jnp.asarray(J), jnp.asarray(P), *args,
                              sigma=sig, **kw)
            want = [np.asarray(x) for x in want]
        for g, w_, what in zip(got, want, ("rho", "J", "P")):
            _close(g, w_, dtype, f"{what} n={n}")


@pytest.mark.parametrize("parity", [0, 1])
def test_maccormack_step_matches_jax(parity):
    for n, dtype in ((8, np.float32), (8, np.float64)):
        rho, J, P, _ = _fields(n, dtype, seed=5 + parity)
        for approx in (True, False):
            args = (0.01, 0.9, 1.1, BOX, 0.5)
            kw = dict(step_parity=parity, approx_P_eq_wrho=approx, w=0.2, light_speed=1.1)
            got = tf.maccormack_step(_t(rho), _t(J), _t(P), *args, **kw)
            with jax.enable_x64(dtype == np.float64), jax.disable_jit():
                want = [np.asarray(x) for x in jf.maccormack_step(
                    jnp.asarray(rho), jnp.asarray(J), jnp.asarray(P), *args, **kw)]
            for g, w_, what in zip(got, want, ("rho", "J", "P")):
                _close(g, w_, dtype, f"{what} n={n} approx={approx}")


def test_vacuum_and_hubble_source_match_jax():
    """vacuum_redistribute (2 and 3 passes) on a grid with vacuum cells,
    vacuum_correct, and hubble_source_rho; Σϱ conserved by the
    redistribution."""
    for n, dtype in ((8, np.float32), (8, np.float64)):
        rho, J, P, _ = _fields(n, dtype, seed=9)
        rho[1:3, 2, 2] = -0.5
        rho[5, 5, 5] = 1e-4
        vac = 0.1
        for passes, smoothing in ((2, 1.0), (3, 0.5)):
            got = tf.vacuum_redistribute(_t(rho), _t(J), vac, smoothing, passes)
            with jax.enable_x64(dtype == np.float64), jax.disable_jit():
                want = [np.asarray(x) for x in jf.vacuum_redistribute(
                    jnp.asarray(rho), jnp.asarray(J), vac, smoothing, passes)]
            _close(got[0], want[0], dtype, "rho")
            _close(got[1], want[1], dtype, "J")
            assert float(got[0].double().sum()) == pytest.approx(float(rho.sum(dtype=np.float64)),
                                                                 rel=10 * TOL[dtype])
            got_c = tf.vacuum_correct(got[0], got[1], vac)
            with jax.enable_x64(dtype == np.float64):
                want_c = jf.vacuum_correct(jnp.asarray(want[0]), jnp.asarray(want[1]), vac)
            _close(got_c[0], want_c[0], dtype, "clamped rho")
            _close(got_c[1], want_c[1], dtype, "clamped J")
        with jax.enable_x64(dtype == np.float64):
            want = jf.hubble_source_rho(jnp.asarray(rho), jnp.asarray(P), 0.03, 0.2, 0.7)
        _close(tf.hubble_source_rho(_t(rho), _t(P), 0.03, 0.2, 0.7), want, dtype, "source")


@pytest.mark.parametrize("scheme", ["kt", "maccormack"])
def test_mass_conservation(scheme):
    """The flux form conserves Σϱ to float32 summation roundoff (as
    tests/test_fluid.py::test_mass_conservation holds the JAX KT step),
    also with pressure, over 10 steps."""
    rho, J, P, _ = _fields(16, np.float32, seed=3)
    rho, J = torch.as_tensor(rho), torch.as_tensor(J)
    total = float(rho.double().sum())
    for step in range(10):
        if scheme == "kt":
            rho, J, _ = tf.kt_step(rho, J, None, 0.005, 1.0, 1.0, 1.0, 0.5, 1.0,
                                   approx_P_eq_wrho=True, w=0.25)
        else:
            rho, J, _ = tf.maccormack_step(rho, J, None, 0.005, 1.0, 1.0, 1.0, 1.0,
                                           step_parity=step, w=0.25)
    assert float(rho.double().sum()) == pytest.approx(total, rel=1e-5)
