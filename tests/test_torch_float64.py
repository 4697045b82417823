"""The port in float64 against the JAX package in x64 (``with
jax.enable_x64(True)``, in process), and the float64 dispatch of every
kernel wrapper on the CPU.

Tolerances: the short-range force factor 1e-13 relative (the same
expression of erfc and exp; the float32 Horner fit of the screening is
~1e-5 off in relative terms, so a factor that keeps it in float64
fails); the slot sweep max|Δ|/max|ref| 1e-12 (summation order of a few
hundred pairs); five global steps and a rung run within 1e-10 of the box
and a total momentum drift under 1e-10 (tests/test_float64.py's bound);
the power spectrum 1e-10 relative."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from concept_tpu.forces.shortrange import (  # noqa: E402
    _sweep_pair as jax_sweep_pair, bucketize, shortrange_force_factor as jax_factor,
)
from concept_tpu_torch.forces.shortrange import (  # noqa: E402
    _sweep_pair, shortrange_force_factor,
)

BOX = 100.0


def _x64():
    return jax.enable_x64(True)


@pytest.mark.parametrize("kernel", ["plummer", "spline", "none"])
def test_force_factor_matches_jax_x64(kernel):
    """The repaired float64 factor: exact screening, within 1e-13 of the
    JAX package's over r² ∈ [0.01, 20.25]·rₛ² with ε² = 0.01·rₛ² (the
    spline's near field and its middle branch included)."""
    scale, soft2 = 1.3, 0.01 * 1.3**2
    r2 = np.linspace(0.01, 20.25, 20001) * scale**2
    with _x64():
        ref = np.asarray(jax_factor(jnp.asarray(r2), scale, soft2, jnp.float64, kernel))
    got = shortrange_force_factor(torch.as_tensor(r2), scale, soft2, kernel)
    assert got.dtype == torch.float64
    assert np.max(np.abs(got.numpy() / ref - 1)) < 1e-13


@pytest.mark.parametrize("kernel", ["plummer", "spline", "none"])
def test_slot_sweep_matches_jax_x64(kernel):
    """The plain one-sided sweep (the double kernel's plain version) on
    8³ particles, clustered and across the wrap, in 5³ cells against the
    JAX package's XLA ``_sweep_pair`` in x64."""
    rng = np.random.default_rng(12)
    blob = rng.normal(50, 4.0, (312, 3))
    edge = rng.uniform(0, 12, (200, 3))
    pos = np.mod(np.concatenate([blob, edge]), BOX)
    nc, scale, cutoff, soft = 5, 4.0, 18.0, 0.5
    with _x64():
        counts = np.asarray(bucketize(jnp.asarray(pos), BOX, nc, 8)["counts"])
        K = -(-int(counts.max()) // 8) * 8
        b = bucketize(jnp.asarray(pos), BOX, nc, K)
        args = (b["hx"], b["hy"], b["hz"], b["valid"]) * 2
        ref = np.asarray(jax_sweep_pair(*args, nc, jnp.float64(BOX), jnp.float64(scale),
                                        jnp.float64(cutoff) ** 2, jnp.float64(soft) ** 2,
                                        kernel=kernel))
        t = [torch.as_tensor(np.array(b[k])) for k in ("hx", "hy", "hz", "valid")]
    assert t[0].dtype == torch.float64
    got = _sweep_pair(*t, *t, nc, BOX, scale, cutoff**2, soft**2, kernel=kernel).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def _six_cubed(rng):
    n = 6
    lin = (np.arange(n) + 0.5) * (BOX / n)
    pos = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    pos = np.mod(pos + rng.standard_normal((n**3, 3)) * 1.5, BOX)
    return pos, rng.standard_normal((n**3, 3)) * 0.1


@pytest.mark.parametrize("method, grid", [("pm", 16), ("p3m", 32)])
def test_global_steps_match_jax_x64(method, grid):
    """Five global steps at 6³ in float64 (tests/test_float64.py's PM
    pipeline, and P³M with the ±1 sweep over 5³ cells): the dtypes stay
    float64, the total momentum drifts by less than 1e-10 of its scale,
    and the positions stay within 1e-10 of the box of the JAX package's."""
    from concept_tpu.components import ComponentSpec as JSpec, ParticleState as JState
    from concept_tpu.cosmology.background import Background as JBackground
    from concept_tpu.sim import SimConfig as JConfig, Simulation as JSim
    from concept_tpu_torch.components import ComponentSpec, ParticleState
    from concept_tpu_torch.cosmology.background import Background
    from concept_tpu_torch.sim import SimConfig, Simulation

    pos, mom = _six_cubed(np.random.default_rng(0))
    N = pos.shape[0]
    kw = dict(boxsize=BOX, potential_gridsize=grid, G=1.0, method=method,
              softening=0.3, softening_kernel="spline")
    sim = Simulation(ComponentSpec(name="m", species="matter", N=N, mass=2.0),
                     SimConfig(device=torch.device("cpu"), dtype=torch.float64, **kw),
                     Background(H0=0.07, Omega_m=0.3))
    st = ParticleState(pos=torch.tensor(pos), mom=torch.tensor(mom))  # copies: kicks act in place
    for _ in range(5):
        st = sim.step(st, 1e-3, 1e-3)
    assert st.pos.dtype == st.mom.dtype == torch.float64
    drift = np.max(np.abs(st.mom.sum(0).numpy() - mom.sum(0))) / (np.mean(np.abs(mom)) * N)
    assert drift < 1e-10
    with _x64():
        jsim = JSim(JSpec(name="m", species="matter", N=N, mass=2.0),
                    JConfig(dtype=jnp.float64, **kw), JBackground(H0=0.07, Omega_m=0.3))
        jst = JState(pos=jnp.asarray(pos), mom=jnp.asarray(mom))
        for _ in range(5):
            jst = jsim.step(jst, 1e-3, 1e-3)
        jpos, jmom = np.asarray(jst.pos), np.asarray(jst.mom)
    assert jpos.dtype == np.float64
    dx = st.pos.numpy() - jpos
    dx -= BOX * np.round(dx / BOX)
    assert np.abs(dx).max() <= 1e-10 * BOX
    assert np.abs(st.mom.numpy() - jmom).max() <= 1e-10 * np.abs(jmom).max()


def test_rung_run_matches_jax_x64(tmp_path):
    """``run()`` with enable_float64 through the rung stepper at 4³ / grid
    8 (tests/test_float64.py::test_enable_float64_p3m_rungs_subprocess):
    float64 throughout, and the final positions within 1e-10 of the box
    of the JAX package's x64 run."""
    from concept_tpu.param import load_params as jax_load
    from concept_tpu.run import run as jax_run
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    def text(out):
        return ("initial_conditions = {'species': 'matter', 'N': 4**3}\n"
                "boxsize = 32*Mpc\npotential_options = 8\nH0 = 67*km/(s*Mpc)\n"
                "Omega_b = 0.049\nOmega_cdm = 0.27\na_begin = 0.1\n"
                "output_times = {'powerspec': [0.12]}\n"
                f"output_dirs = '{out}'\n"
                "select_forces = {'all': {'gravity': 'p3m'}}\n"
                "boltzmann_backend = 'eh'\nenable_float64 = True\n")

    sim, st, a = run(load_params(None, text=text(tmp_path / "torch")), device="cpu")
    assert st.pos.dtype == st.mom.dtype == torch.float64
    was = jax.config.jax_enable_x64
    try:
        cfg = jax_load(None, text=text(tmp_path / "jax"))
        box = cfg.boxsize
        _, jst, ja = jax_run(cfg)  # switches x64 on for the process
        jpos = np.asarray(jst.pos)
    finally:
        jax.config.update("jax_enable_x64", was)
    assert jpos.dtype == np.float64 and a == pytest.approx(ja, rel=1e-12)
    dx = st.pos.numpy() - jpos
    dx -= box * np.round(dx / box)
    assert np.abs(dx).max() <= 1e-10 * box


@pytest.mark.parametrize("interlace", [False, True])
def test_powerspec_f64_matches_jax_x64(interlace):
    """The float64 power spectrum (deposit, FFT, binning) against the JAX
    package's in x64, which bins |k| in float32 as the port does: 1e-10
    relative without interlacing; with it 1e-6, as the JAX package keeps
    the interlacing phase in complex64 under x64 (the port's is
    complex128; ROADMAP Queue 3)."""
    from concept_tpu.analysis.powerspec import powerspec as jax_powerspec
    from concept_tpu_torch.analysis.powerspec import powerspec

    rng = np.random.default_rng(1)
    N, box = 2048, 32.0
    pos = rng.uniform(0, box, (N, 3))
    got = powerspec(torch.as_tensor(pos), 16, box, N, interlace=interlace)
    with _x64():
        ref = jax_powerspec([jnp.asarray(pos)], [1.0], 16, box, n_particles=N,
                            interlace=interlace)
        ref = {k: np.asarray(v) for k, v in ref.items()}
    np.testing.assert_array_equal(got["modes"], ref["modes"])
    np.testing.assert_allclose(got["power"], ref["power"], rtol=1e-6 if interlace else 1e-10)


# ---------------------------------------------------------------------- #
# The float64 dispatch of the wrappers on the CPU: the plain version, in
# float64, no launch counted; a mix of dtypes raises.

def _sweep_case():
    rng = np.random.default_rng(3)
    n, K, box = 5, 8, 1.0
    cells = np.arange(n**3)
    base = np.stack([cells // (n * n), (cells // n) % n, cells % n]) / n
    counts = rng.integers(0, K + 1, size=n**3)
    valid = np.arange(K)[:, None] < counts[None, :]
    s = np.where(valid[None], base[:, None, :] + rng.random((3, K, n**3)) / n, 1e4 * box)
    return torch.as_tensor(s), n, box


def _slot_case(n=16, cb=8):
    rng = np.random.default_rng(4)
    nc = n // cb
    K, C = 6, nc**3
    cols = np.arange(C)
    base = np.stack([cols // (nc * nc), (cols // nc) % nc, cols % nc]) * cb / n
    pos = torch.as_tensor(base[:, None, :] + rng.uniform(0, cb, (3, K, C)) / n)
    return pos, torch.full((K, C), 0.5, dtype=torch.float64), torch.as_tensor(
        rng.standard_normal((3, n, n, n)))


def _wrapper_calls(other):
    """Each wrapper's name → (wrapper, call(wrapper), its plain version's
    call): float64 inputs of which one is cast to ``other``."""
    from concept_tpu_torch.forces import cuda_shortrange as sr
    from concept_tpu_torch.forces.shortrange import reach_offsets
    from concept_tpu_torch.grid import cuda_blocks as cbk, cuda_cells as cc, cuda_pm as cpm
    from concept_tpu_torch.grid.bucketed import sort_blocks

    s, n, box = _sweep_case()
    args = (n, box, 0.05, 0.2**2, 0.01**2, "spline")
    offs = reach_offsets(box / n, 0.05 * box / n)
    pos, w, grids = _slot_case()
    bpos, bw, _ = _slot_case(16, 2)
    sb = sort_blocks(torch.as_tensor(np.random.default_rng(5).uniform(0, 1, (300, 3))), 16, 1.0)
    part = (sb["lidx"], sb["fx"], sb["fy"], sb["fz"])
    q = torch.ones(300, dtype=torch.float64)
    blocks = (sb["starts"], sb["counts"])
    return {
        "pair_sweep": (sr.pair_sweep, lambda f: f(s, s.to(other), *args),
                       lambda: sr.pair_sweep_plain(s, s, *args)),
        "pair_sweep_subset": (sr.pair_sweep_subset, lambda f: f(s, s.to(other), *args),
                              lambda: sr.pair_sweep_plain(s, s, *args)),
        "pair_sweep_global": (sr.pair_sweep_global, lambda f: f(s, s.to(other), *args),
                              lambda: sr.pair_sweep_plain(s, s, *args)),
        "pair_sweep_reach": (sr.pair_sweep_reach,
                             lambda f: f(s, s.to(other), *args[:5], offs, args[5]),
                             lambda: sr.pair_sweep_plain(s, s, *args, offsets=offs)),
        "deposit_cells": (cc.deposit_cells, lambda f: f(pos, w.to(other), 16, 1.0),
                          lambda: cc.deposit_cells_plain(pos, w, 16, 1.0)),
        "gather_cells": (cc.gather_cells, lambda f: f(pos, w, grids.to(other), 16, 1.0),
                         lambda: cc.gather_cells_plain(pos, w, grids, 16, 1.0)),
        "deposit_blocks": (cbk.deposit_blocks, lambda f: f(*bpos, bw.to(other), 16, 1.0),
                           lambda: cbk.deposit_blocks_plain(*bpos, bw, 16, 1.0)),
        "gather_blocks": (cbk.gather_blocks, lambda f: f(*bpos, bw, grids.to(other), 16, 1.0),
                          lambda: cbk.gather_blocks_plain(*bpos, bw, grids, 16, 1.0)),
        "deposit_pm": (cpm.deposit_pm, lambda f: f(*part, q.to(other), *blocks, 16),
                       lambda: cpm.deposit_pm_plain(*part, q, *blocks, 16)),
        "gather_pm": (cpm.gather_pm, lambda f: f(*part, *blocks, grids.to(other), 16),
                      lambda: cpm.gather_pm_plain(*part, *blocks, grids, 16)),
    }


WRAPPERS = ("pair_sweep", "pair_sweep_subset", "pair_sweep_global", "pair_sweep_reach",
            "deposit_cells", "gather_cells", "deposit_blocks", "gather_blocks", "deposit_pm",
            "gather_pm")


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_float64_dispatch_on_the_cpu(name):
    """Each wrapper takes float64 CPU tensors to its plain version (the
    same numbers, float64 out, no launch counted) and raises on a launch
    whose floating inputs mix float64 with float32."""
    fn, call, plain = _wrapper_calls(torch.float64)[name]
    counts = (fn.launches, fn.launches_f64)
    got = call(fn)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, plain(), rtol=0, atol=0)
    assert (fn.launches, fn.launches_f64) == counts
    fn, call, _ = _wrapper_calls(torch.float32)[name]
    with pytest.raises(TypeError, match="mixed dtypes"):
        call(fn)


def test_resolve_dtype_gives_float64_on_either_device():
    """enable_float64 means float64 on the card too: every kernel has a
    double instantiation, so nothing raises."""
    from concept_tpu_torch.device import resolve_dtype

    for dev in ("cpu", "cuda"):
        assert resolve_dtype(torch.device(dev), True) == torch.float64
        assert resolve_dtype(torch.device(dev), False) == torch.float32


def test_normal_noise_f64_matches_jax_x64():
    """The 'simple' noise of a float64 run is ``jax.random.normal(key,
    shape, float64)``, as the JAX package draws it under x64 (64-bit
    threefry words, 52-bit uniforms; erfinv to rounding), not the float32
    draw cast up."""
    from concept_tpu_torch.ic import normal_noise

    with _x64():
        ref = np.asarray(jax.random.normal(jax.random.key(3), (8, 8, 8), dtype=jnp.float64))
    got = normal_noise(3, 8, dtype=torch.float64)
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - ref).max() < 1e-13 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rung_substep_squares_in_the_state_dtype(dtype, monkeypatch):
    """The rung stepper hands the sweep cutoff² and ε² squared as the
    state's dtype squares them: f32(x)² in float32, x·x in float64 (the
    JAX package squares the f64 values under x64)."""
    from concept_tpu_torch import p3mrungs

    rng = np.random.default_rng(2)
    N, box, nc = 64, 10.0, 3
    pos = tuple(torch.as_tensor(rng.uniform(0, box, N), dtype=dtype) for _ in range(3))
    mom = tuple(torch.zeros(N, dtype=dtype) for _ in range(3))
    state, _ = p3mrungs.bucketize_rungs(pos, mom, torch.zeros(N, dtype=torch.int8),
                                        torch.arange(N, dtype=torch.int32), box, nc, 16, 8)
    seen = {}

    def fake_sweep(recv, sup, n, boxsize, scale, cutoff2, soft2, **kw):
        seen.update(cutoff2=cutoff2, soft2=soft2)
        return torch.zeros_like(recv)

    monkeypatch.setattr(p3mrungs, "sweep_slots", fake_sweep)
    cutoff, soft = 3.1, 0.07
    p3mrungs.rung_substep(state, 1.0, 1.0, 0.0, torch.zeros(8, dtype=dtype), box, nc, 0.7,
                          cutoff, soft, 16)
    want = (float(np.float32(cutoff) ** 2), float(np.float32(soft) ** 2)) \
        if dtype == torch.float32 else (cutoff * cutoff, soft * soft)
    assert (seen["cutoff2"], seen["soft2"]) == want
