"""The port's rung stepper on its two other layouts — cells 4 mesh cells
wide with the reach-2 sweep (``ucb = 4``) and the tight cutoff-wide
layout with the block PM — against the JAX package, in the setup of
tests/test_unified_layout.py (8³ particles, mesh 32, N_rungs = 4, spline
softening; 8³ cells at ucb = 4, 5³ tight cells), and the tight layout at
mesh 16, whose 2³ cells take the folded sweep.

- ``kept_offsets`` equals the JAX function; the reach sweeps equal the
  JAX XLA sweeps over the same offsets within max|Δ|/max|ref| 1e-5 (the
  flat sweeps' metric, tests/test_pallas_shortrange.py:41).
- ``init_state`` gives exactly the JAX layout, and the initial rung
  assignment the same rungs and K_act.  After evolving a = 0.02 → 0.05
  (0.03 at mesh 16) the mean |Δx|/box stays ≤ 5e-5 and the deepest rung is the same, as in
  tests/test_torch_p3mrungs.py (on the CPU the JAX package deposits
  every layout through pm_gradient_layout, the port the ucb = 4 layout
  on its cells: they differ at rounding level).
- The layout rule, pinned without a card.
- From the frozen PP-Ewald fixture the port tracks the converged
  trajectory within mean |Δx|/box ≤ 1.2e-2 at a = 0.1 and 0.5, the TOL
  of tests/test_vs_oracle_p3m.py:33, on both layouts."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax.numpy as jnp  # noqa: E402

from concept_tpu.components import particle_mass  # noqa: E402
from concept_tpu.cosmology.background import Background as JaxBackground  # noqa: E402
from concept_tpu.forces.pallas_shortrange import kept_offsets as jax_kept_offsets  # noqa: E402
from concept_tpu.forces.shortrange import _sweep as jax_sweep  # noqa: E402
from concept_tpu.forces.shortrange import _sweep_pair as jax_sweep_pair  # noqa: E402
from concept_tpu.p3mrungs import P3MRungSimulation as JaxRungs  # noqa: E402
from concept_tpu.p3mrungs import RungState as JaxRungState  # noqa: E402
from concept_tpu.p3mrungs import extract_flat as jax_extract  # noqa: E402
from concept_tpu.units import constants, units  # noqa: E402
from concept_tpu_torch.convert import from_jax_state, to_numpy  # noqa: E402
from concept_tpu_torch.cosmology.background import Background  # noqa: E402
from concept_tpu_torch.forces.shortrange import (  # noqa: E402
    _sweep_pair, f32_square, kept_offsets, reach_offsets, sweep_reach,
)
from concept_tpu_torch.p3mrungs import P3MRungSimulation, extract_flat  # noqa: E402

FIELDS = ("pos", "mom", "valid", "rungs", "ids")
LAYOUTS = {"ucb4": dict(unified=True, unified_cb=4), "tight": dict(unified=False),
           # mesh 16: 2³ tight cells, the folded sweep (to a = 0.03)
           "tight16": dict(unified=False, mesh=16, a_end=0.03)}
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "oracle_pp_8cube.npz")
TOL = 1e-5


def _maxrel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("cw,cutoff,margin,reach,count", [
    (4.0, 5.625, 0.55, 2, 117),  # the ucb = 4 layout: 5³ less the corners
    (1.0, 1.2, 0.1, 2, 81),  # one axis at ±2 only
    (2.0, 1.0, 0.3, 1, 27),
])
def test_kept_offsets_match_jax(cw, cutoff, margin, reach, count):
    got = kept_offsets(cw, cutoff, margin, reach)
    assert got == jax_kept_offsets(cw, cutoff, margin, reach)
    assert len(got) == count
    if count == 117:
        assert reach_offsets(cw, margin) == got


def _slots(rng, nc, K, box):
    """A prefix-valid (3, K, C) layout of nc³ cells, positions inside
    their cells, one column full."""
    C = nc**3
    counts = rng.integers(0, K + 1, size=C)
    counts[rng.integers(C)] = K
    valid = np.arange(K)[:, None] < counts[None, :]
    cells = np.arange(C)
    cw = box / nc
    base = np.stack([cells // (nc * nc), (cells // nc) % nc, cells % nc]) * cw
    pos = (base[:, None, :] + rng.random((3, K, C)) * cw).astype(np.float32)
    return np.where(valid[None], pos, 0.0).astype(np.float32), valid


def _geometry(nc, box):
    cw = box / nc
    return cw, (4.5 * 1.25 / 4.0) * cw, 0.55 * cw / 4.0, 1.25 * cw / 4.0


@pytest.mark.parametrize("kernel", ["plummer", "spline", "none"])
@pytest.mark.parametrize("nc", [5, 6])
def test_one_sided_reach_sweep_matches_jax(nc, kernel):
    """Receivers = the leading 5 of 8 slot rows, as a rung substep
    sweeps them; at nc = 5 the ±2 offsets wrap onto distinct columns."""
    rng = np.random.default_rng(nc + 3)
    box, K, K_r = 24.0, 8, 5
    cw, cutoff, margin, scale = _geometry(nc, box)
    h, valid = _slots(rng, nc, K, box)
    soft = 0.05 * cw
    offs = jax_kept_offsets(cw, cutoff, margin, 2)
    ref = np.asarray(jax_sweep_pair(
        *(jnp.asarray(h[d, :K_r]) for d in range(3)), jnp.asarray(valid[:K_r]),
        *(jnp.asarray(h[d]) for d in range(3)), jnp.asarray(valid), nc,
        jnp.float32(box), jnp.float32(scale), jnp.float32(cutoff) ** 2,
        jnp.float32(soft) ** 2, kernel=kernel, offsets_ext=offs))
    t = torch.as_tensor(h)
    tv = torch.as_tensor(valid)
    got = _sweep_pair(*t[:, :K_r], tv[:K_r], *t, tv, nc, box, scale,
                      f32_square(cutoff), f32_square(soft), kernel=kernel,
                      offsets_ext=reach_offsets(cw, margin)).numpy()
    assert _maxrel(got, ref) < TOL
    assert np.all(got[:, ~valid[:K_r]] == 0)


@pytest.mark.parametrize("kernel", ["plummer", "spline", "none"])
def test_two_sided_reach_sweep_matches_jax(kernel):
    """sweep_reach (receivers = suppliers) against the JAX ``_sweep``
    with Newton halving over the positive half of the kept offsets."""
    rng = np.random.default_rng(17)
    nc, box, K = 6, 24.0, 8
    cw, cutoff, margin, scale = _geometry(nc, box)
    h, valid = _slots(rng, nc, K, box)
    soft = 0.05 * cw
    half = [o for o in jax_kept_offsets(cw, cutoff, margin, 2) if o > (0, 0, 0)]
    ref = np.asarray(jax_sweep(
        *(jnp.asarray(h[d]) for d in range(3)), jnp.asarray(valid), nc,
        jnp.float32(box), jnp.float32(scale), jnp.float32(cutoff) ** 2,
        jnp.float32(soft) ** 2, halve=True, kernel=kernel, offsets_half=half))
    t = torch.as_tensor(h)
    got = sweep_reach(*t, torch.as_tensor(valid), nc, box, scale, cutoff, soft,
                      cw, margin, kernel=kernel).numpy()
    assert _maxrel(got, ref) < TOL


@pytest.mark.parametrize("mesh,device,ucb", [
    (128, "cuda", 8), (124, "cuda", 4), (126, "cuda", 0), (20, "cuda", 4),
    (10, "cuda", 0), (128, "cpu", 0), (124, "cpu", 0),
])
def test_layout_rule(mesh, device, ucb):
    """The JAX package's rule with the device for its backend (no card
    needed to construct); each layout's geometry equals the JAX one."""
    sim = P3MRungSimulation(mesh // 2, 100.0, 1.0, 1.0, mesh=mesh, device=device)
    assert sim.ucb == ucb and sim.unified == (ucb > 0)
    jsim = JaxRungs(mesh // 2, 100.0, 1.0, 1.0, mesh=mesh, unified=ucb > 0,
                    unified_cb=ucb or None)
    assert (sim.nc, sim.cell_width, sim.margin, sim.capacity) == (
        jsim.nc, jsim.cell_width, jsim.margin, jsim.capacity)


@pytest.mark.parametrize("mesh,kw", [
    (16, dict(device="cuda")),  # mesh % 4 == 0 but too small for either cb
    (16, dict(unified=True, unified_cb=4)),  # 4³ cells: reach 2 needs 5
    (20, dict(unified=True, unified_cb=8)),  # 20 % 8 != 0
    (32, dict(unified=True, unified_cb=2)),
])
def test_impossible_layout_raises(mesh, kw):
    with pytest.raises(ValueError, match="mesh"):
        P3MRungSimulation(mesh // 2, 100.0, 1.0, 1.0, mesh=mesh, **kw)


@pytest.fixture(scope="module", params=list(LAYOUTS))
def runs(request):
    """One JAX run and one port run per layout from the same state: the
    layouts after init_state and after the initial rung assignment, and
    the positions at a = 0.05 (0.03 at mesh 16)."""
    h = 0.70
    H0 = 70 * units.km / (units.s * units.Mpc)
    box = 8 * units.Mpc / h
    G = constants.G_Newton
    N = 8**3
    jbg = JaxBackground(H0=H0, Omega_m=0.30)
    mass = particle_mass(0.30, jbg.rho_crit_of(G), box, N)
    rng = np.random.default_rng(5)
    lin = (np.arange(8, dtype=np.float32) + 0.5) * (box / 8)
    pos = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    pos = np.mod(
        pos + 0.2 * (box / 8) * rng.standard_normal(pos.shape).astype(np.float32),
        box,
    ).astype(np.float32)
    kw = dict(mesh=32, N_rungs=4, softening=0.03 * box / 8, softening_kernel="spline")
    kw.update(LAYOUTS[request.param])
    a_end = kw.pop("a_end", 0.05)
    jsim = JaxRungs(8, box, mass, G, bg=jbg, **kw)
    tsim = P3MRungSimulation(8, box, mass, G, bg=Background(H0=H0, Omega_m=0.30),
                             device="cpu", **kw)
    out = dict(box=box, layout=request.param, jsim=jsim, tsim=tsim)
    jstate = jsim.init_state(tuple(jnp.asarray(pos[:, d]) for d in range(3)),
                             tuple(jnp.zeros(N, jnp.float32) for _ in range(3)))
    tpos = torch.as_tensor(pos)
    tstate = tsim.init_state(tuple(tpos[:, d] for d in range(3)),
                             tuple(torch.zeros(N) for _ in range(3)))
    jarrays = {f: np.asarray(getattr(jstate, f)) for f in FIELDS}
    out["init"] = (to_numpy(tstate), jarrays, (tsim._K_occ, tsim.capacity),
                   (jsim._K_occ, jsim.capacity))
    # both continue from the JAX layout
    state = from_jax_state(jarrays, device="cpu")
    jstate = JaxRungState(**{f: jnp.asarray(jarrays[f]) for f in FIELDS})
    t0 = float(jsim.bg.t_of_a_np(0.02))
    jstate = jsim.assign_initial_rungs(jstate, jsim._timestep(0.02, 0.0))
    state = tsim.assign_initial_rungs(state, tsim._timestep(0.02, 0.0))
    out["assign"] = (to_numpy(state), {f: np.asarray(getattr(jstate, f)) for f in FIELDS},
                     (tsim._K_act, tsim._K_occ), (jsim._K_act, jsim._K_occ))
    t1 = float(jsim.bg.t_of_a_np(a_end))
    jstate = jsim.evolve(jstate, t0, t1)
    state = tsim.evolve(state, t0, t1)
    p_j, _, ids_j = (np.asarray(a) for a in jax_extract(jstate, N))
    p, _, ids = (a.numpy() for a in extract_flat(state, N))
    out["final"] = (p[np.argsort(ids)], p_j[np.argsort(ids_j)])
    return out


def test_layout_geometry_matches_jax(runs):
    j, t = runs["jsim"], runs["tsim"]
    assert t.ucb == {"ucb4": 4, "tight": 0, "tight16": 0}[runs["layout"]] == j.ucb
    assert (t.nc, t.cell_width, t.margin, t.capacity) == (
        j.nc, j.cell_width, j.margin, j.capacity)
    assert (t.nc, len(t.offsets or ())) == {"ucb4": (8, 117), "tight": (5, 0),
                                            "tight16": (2, 0)}[runs["layout"]]


def test_init_state_layout_identical(runs):
    got, ref, t_sizes, j_sizes = runs["init"]
    for f in ("valid", "ids", "rungs", "pos"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    assert t_sizes == j_sizes  # _K_occ, capacity


def test_initial_rungs_identical(runs):
    got, ref, (K_act, K_occ), (jK_act, jK_occ) = runs["assign"]
    for f in ("rungs", "ids", "valid"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    np.testing.assert_array_equal(K_act, jK_act)
    assert K_occ == jK_occ


def test_evolve_matches_jax(runs):
    p, p_j = runs["final"]
    box = runs["box"]
    dx = p - p_j
    dx -= box * np.round(dx / box)
    assert np.mean(np.sqrt((dx**2).sum(1))) / box <= 5e-5
    assert runs["tsim"].stats["max_rung"] == runs["jsim"].stats["max_rung"]
    assert runs["tsim"].stats["budget_warnings"] == 0


@pytest.mark.skipif(not os.path.exists(FIXTURE), reason="oracle fixture not generated")
@pytest.mark.parametrize("layout", ["ucb4", "tight"])
def test_rungs_track_frozen_oracle(layout):
    """The port's stepper (N_rungs = 8) from the fixture's initial
    conditions against its converged PP-Ewald trajectory
    (scripts/make_oracle_fixture.py), as the JAX package's
    test_production_rung_p3m_vs_frozen_oracle holds its own."""
    fx = np.load(FIXTURE)
    box = float(fx["boxsize"])
    bg = Background(H0=float(fx["H0"]), Omega_m=float(fx["Omega_m"]))
    N = fx["ic_pos"].shape[0]
    sim = P3MRungSimulation(8, box, float(fx["mass"]), constants.G_Newton, mesh=32,
                            bg=bg, N_rungs=8, softening=float(fx["softening"]),
                            softening_kernel="spline", device="cpu", **LAYOUTS[layout])
    pos = torch.as_tensor(fx["ic_pos"], dtype=torch.float32)
    mom = torch.as_tensor(fx["ic_mom"], dtype=torch.float32)
    st = sim.init_state(tuple(pos[:, d] for d in range(3)),
                        tuple(mom[:, d] for d in range(3)))
    a = float(fx["a_begin"])
    for a_next, ref in ((0.1, fx["pos_a0p1"]), (0.5, fx["pos_a0p5"])):
        st = sim.evolve(st, float(bg.t_of_a_np(a)), float(bg.t_of_a_np(a_next)))
        a = a_next
        p, _, ids = extract_flat(st, N)
        dx = p.numpy()[np.argsort(ids.numpy())] - ref
        dx -= box * np.round(dx / box)
        assert np.mean(np.sqrt((dx**2).sum(1))) / box <= 1.2e-2, a_next
