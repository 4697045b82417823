"""PM-only gravity of the port (forces/pm.py, grid/bucketed.py,
grid/cuda_pm.py, grid/interp.py, grid/stencil.py, the PM route of run.py)
against the JAX package on the CPU: the block buckets and the block sort,
the plain versions of the block kernels (PERF.md rows 10-11) on the
block-sorted particles against JAX's Pallas kernels in interpret mode
(counts clamped to the capacity) and its plain CIC (every particle), the
PM momentum updates over the options, the block overflow, and the shrunk
PM-only run through both command-line interfaces.

Tolerances: bucket layouts exactly (integers, and the same float32
arithmetic); deposit and gather rtol 2e-5, atol 1e-5·max|ref|
(tests/test_pallas_cells.py:62: float32 sums in another order); momentum
updates 1e-5 of their maximum (tests/test_pallas_pm.py:74-78); spectra at
a = 1 to 1 % up to half the Nyquist wavenumber (tests/test_torch_run.py;
measured 2.1e-5, 172 steps on both sides).  All particle sets have
N = 4096 on mesh 16, so the JAX package compiles each shape once: block
capacity max(16, 4·8N/n³) = 32, JAX overflow budget max(256, N/16) = 256.
"""

import glob
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax.numpy as jnp  # noqa: E402

from concept_tpu.cli import main as jax_main  # noqa: E402
from concept_tpu.forces.pm import pm_gravity_momentum_updates as jax_pm  # noqa: E402
from concept_tpu.grid.bucketed import bucketize_blocks as jax_bucketize  # noqa: E402
from concept_tpu.grid.interp import deposit as jax_deposit  # noqa: E402
from concept_tpu.grid.interp import gather as jax_gather  # noqa: E402
from concept_tpu.grid.pallas_pm import deposit_pallas, gather_pallas  # noqa: E402
from concept_tpu_torch.cli import main  # noqa: E402
from concept_tpu_torch.forces.pm import pm_gravity_momentum_updates  # noqa: E402
from concept_tpu_torch.grid.bucketed import bucketize_blocks, sort_blocks  # noqa: E402
from concept_tpu_torch.grid.cuda_pm import (  # noqa: E402
    deposit_pm, deposit_pm_plain, gather_pm, gather_pm_plain,
)
from concept_tpu_torch.param import load_params  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM = os.path.join(ROOT, "param", "example_basic.py")
N_GRID, BOX, N, MASS = 16, 40.0, 4096, 2.0
BOX_EB = load_params(PARAM).boxsize  # example_basic's box, in the packages' unit
CAPACITY = 32  # max(16, 4·8N/n³), the kernel path's block capacity
CLUMP = 400  # particles added to one 2³ block, beyond the JAX budget


def _uniform():
    return np.random.default_rng(3).uniform(0, BOX, (N, 3)).astype(np.float32)


def _clumped():
    """CLUMP particles in the block of mesh cells [8, 10)³, the rest
    uniform; returns (pos, the number beyond the block capacity), the
    latter well past the JAX budget of 256."""
    pos = _uniform()
    h = BOX / N_GRID
    pos[:CLUMP] = 8 * h + np.random.default_rng(4).uniform(0, 1.9 * h, (CLUMP, 3))
    pos = pos.astype(np.float32)
    blocks = np.clip((pos / h).astype(np.int32), 0, N_GRID - 1) // 2
    counts = np.bincount((blocks[:, 0] * 8 + blocks[:, 1]) * 8 + blocks[:, 2])
    return pos, int(np.maximum(counts - CAPACITY, 0).sum())


def _close(got, ref, rtol=2e-5, atol_rel=1e-5):
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_rel * np.abs(ref).max())


def test_bucketize_blocks_matches_jax():
    """Slots, fractions, validity, order and overflow identical to JAX's
    (its (C, K) arrays are the port's (K, C) ones transposed, its slot
    key·K + rank the port's rank·C + key)."""
    pos, n_over = _clumped()
    q = np.random.default_rng(5).uniform(0.5, 1.5, N).astype(np.float32)
    bj = {k: np.asarray(v) for k, v in
          jax_bucketize(jnp.asarray(pos), jnp.asarray(q), N_GRID, BOX, CAPACITY).items()}
    bt = {k: v.numpy() for k, v in
          bucketize_blocks(torch.as_tensor(pos), torch.as_tensor(q), N_GRID, BOX,
                           CAPACITY).items()}
    C = (N_GRID // 2) ** 3
    lidx_j = (bj["lx"] * 4 + bj["ly"]) * 4 + bj["lz"]
    np.testing.assert_array_equal(bt["lidx"], lidx_j.T)
    for k in ("fx", "fy", "fz", "q", "valid"):
        np.testing.assert_array_equal(bt[k], bj[k].T, err_msg=k)
    np.testing.assert_array_equal(bt["order"], bj["order"])
    np.testing.assert_array_equal(bt["overflow"], bj["overflow"])
    np.testing.assert_array_equal(bt["key_sorted"], bj["key_sorted"])
    inb = ~bt["overflow"]
    np.testing.assert_array_equal(bt["slot"][inb] % C, bj["slot"][inb] // CAPACITY)
    np.testing.assert_array_equal(bt["slot"][inb] // C, bj["slot"][inb] % CAPACITY)
    assert int(bt["overflow"].sum()) == n_over > 256
    np.testing.assert_array_equal(np.sort(bt["over_idx"]),
                                  np.sort(bt["order"][bt["overflow"]]))


def _sorted(pos, capacity=None):
    """The block-sorted particles of pos through the port: (sort dict,
    the particle arrays, starts, counts clamped to ``capacity`` or
    full)."""
    sb = sort_blocks(torch.as_tensor(pos), N_GRID, BOX)
    counts = sb["counts"] if capacity is None else torch.clamp(sb["counts"], max=capacity)
    return sb, (sb["lidx"], sb["fx"], sb["fy"], sb["fz"]), sb["starts"], counts


def _grids():
    grids = np.random.default_rng(6).standard_normal((3, N_GRID, N_GRID, N_GRID))
    return grids.astype(np.float32)


def test_sort_blocks_matches_jax_buckets():
    """The block sort against JAX's buckets on the clumped set: the same
    order; starts and counts consistent with its sorted keys; the sorted
    lidx, fx, fy, fz equal its in-capacity slots."""
    pos, n_over = _clumped()
    bj = {k: np.asarray(v) for k, v in
          jax_bucketize(jnp.asarray(pos), MASS, N_GRID, BOX, CAPACITY, uniform_q=True).items()}
    sb = {k: v.numpy() for k, v in sort_blocks(torch.as_tensor(pos), N_GRID, BOX).items()}
    C = (N_GRID // 2) ** 3
    np.testing.assert_array_equal(sb["order"], bj["order"])
    np.testing.assert_array_equal(sb["key"], bj["key_sorted"])
    assert sb["starts"].dtype == sb["counts"].dtype == np.int32
    np.testing.assert_array_equal(sb["counts"], np.bincount(bj["key_sorted"], minlength=C))
    np.testing.assert_array_equal(sb["starts"], np.cumsum(sb["counts"]) - sb["counts"])
    rank = np.arange(N) - sb["starts"][sb["key"]]
    inb = rank < CAPACITY
    assert int((~inb).sum()) == n_over
    key, rank = sb["key"][inb], rank[inb]
    lidx_j = (bj["lx"] * 4 + bj["ly"]) * 4 + bj["lz"]
    np.testing.assert_array_equal(sb["lidx"][inb], lidx_j[key, rank])
    for k in ("fx", "fy", "fz"):
        np.testing.assert_array_equal(sb[k][inb], bj[k][key, rank], err_msg=k)


@pytest.mark.parametrize("cut", ["capacity", "all"])
def test_sorted_deposit_plain_matches_jax(cut):
    """The plain row-10 deposit on the block-sorted clumped set: with
    counts clamped to the capacity, equal to JAX's deposit_pallas in
    interpret mode (the in-capacity particles); with the full counts,
    equal to JAX's plain CIC deposit of every particle."""
    pos, n_over = _clumped()
    sb, parts, starts, counts = _sorted(pos, CAPACITY if cut == "capacity" else None)
    q = torch.full((N,), MASS)
    got = deposit_pm_plain(*parts, q, starts, counts, N_GRID).numpy()
    if cut == "capacity":
        bj = jax_bucketize(jnp.asarray(pos), MASS, N_GRID, BOX, CAPACITY, uniform_q=True)
        ref = np.asarray(deposit_pallas(bj, N_GRID, interpret=True))
        assert got.sum() == pytest.approx((N - n_over) * MASS, rel=1e-5)
    else:
        ref = np.asarray(jax_deposit(jnp.asarray(pos), MASS, N_GRID, BOX))
        assert got.sum() == pytest.approx(N * MASS, rel=1e-5)
    _close(got, ref)


@pytest.mark.parametrize("cut", ["capacity", "all"])
def test_sorted_gather_plain_matches_jax(cut):
    """The plain row-11 gather of D = 3 fields at the block-sorted
    clumped set: with counts clamped to the capacity, equal to JAX's
    gather_pallas in interpret mode at the in-capacity particles, and 0
    beyond; with the full counts, equal to JAX's plain CIC gather at
    every particle."""
    pos, n_over = _clumped()
    sb, parts, starts, counts = _sorted(pos, CAPACITY if cut == "capacity" else None)
    grids = _grids()
    got = gather_pm_plain(*parts, starts, counts, torch.as_tensor(grids), N_GRID).numpy()
    assert got.shape == (3, N)
    if cut == "capacity":
        bj = jax_bucketize(jnp.asarray(pos), MASS, N_GRID, BOX, CAPACITY, uniform_q=True)
        ref = np.asarray(gather_pallas(bj, jnp.asarray(grids), N_GRID, interpret=True))
        rank = np.arange(N) - sb["starts"].numpy()[sb["key"].numpy()]
        inb = rank < CAPACITY
        _close(got[:, inb], ref[sb["key"].numpy()[inb], rank[inb]].T)
        assert int((~inb).sum()) == n_over and not got[:, ~inb].any()
    else:
        order = sb["order"].numpy()
        ref = np.stack([np.asarray(jax_gather(jnp.asarray(g), jnp.asarray(pos[order]), BOX))
                        for g in grids])
        _close(got, ref)


def test_block_kernels_plain_match_jax_pallas():
    """The plain versions of rows 10 and 11 (the CPU path of deposit_pm /
    gather_pm) against the JAX package's deposit_pallas / gather_pallas
    in interpret mode, on the clumped set with the counts clamped to the
    capacity (deep blocks full)."""
    pos, _ = _clumped()
    bj = jax_bucketize(jnp.asarray(pos), MASS, N_GRID, BOX, CAPACITY, uniform_q=True)
    sb, parts, starts, counts = _sorted(pos, CAPACITY)
    before = (deposit_pm.launches, gather_pm.launches)
    got = deposit_pm(*parts, torch.full((N,), MASS), starts, counts, N_GRID)
    _close(got.numpy(), np.asarray(deposit_pallas(bj, N_GRID, interpret=True)))
    grids = _grids()
    got = gather_pm(*parts, starts, counts, torch.as_tensor(grids), N_GRID).numpy()
    ref = np.asarray(gather_pallas(bj, jnp.asarray(grids), N_GRID, interpret=True))
    rank = np.arange(N) - sb["starts"].numpy()[sb["key"].numpy()]
    inb = rank < CAPACITY
    _close(got[:, inb], ref[sb["key"].numpy()[inb], rank[inb]].T)
    # the CPU path is the plain version: no kernel launch is counted
    assert (deposit_pm.launches, gather_pm.launches) == before


@pytest.mark.parametrize("kw", [
    dict(deposit_method="scatter"), dict(deposit_method="pallas"), dict(order=1),
    dict(order=4), dict(interlace="bcc"),
    dict(interlace="fcc"), dict(interlace=("bcc", "fcc")), dict(differentiation=4),
    dict(differentiation=4, interlace=(False, "bcc"), order=3),
    dict(longrange_scale=3.0, interlace="bcc"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_pm_momentum_updates_match_jax(kw):
    """One keyword set to both packages; the port's 'pallas' runs the
    plain versions of rows 10-11, JAX's its kernels in interpret mode."""
    pos = _uniform()
    (ref,) = jax_pm([jnp.asarray(pos)], [MASS], N_GRID, BOX, 1.0, kick_integral=0.5, **kw)
    info = {}
    (got,) = pm_gravity_momentum_updates([torch.as_tensor(pos)], [MASS], N_GRID, BOX, 1.0,
                                         kick_integral=0.5, info=info, **kw)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy() / np.abs(ref).max(), ref / np.abs(ref).max(),
                               atol=1e-5)
    assert info["n_overflow"] == 0
    assert abs(float(info["mass_sum"]) / MASS - N) < 1e-2


def test_block_overflow_is_exact_where_jax_truncates():
    """Some 375 particles beyond the block capacity: the JAX 'pallas'
    path deposits at most 256 of them (max(256, N/16),
    forces/pm.py:335-337) and gives the rest the zero force; the port's
    kernel path has no capacity (block-sorted particles), deposits and
    gathers them all, counts no overflow, and equals its (and JAX's)
    'scatter' path."""
    pos, n_over = _clumped()
    kick = dict(kick_integral=0.5)
    (scatter,) = pm_gravity_momentum_updates([torch.as_tensor(pos)], [MASS], N_GRID, BOX,
                                             1.0, deposit_method="scatter", **kick)
    info = {}
    (pallas,) = pm_gravity_momentum_updates([torch.as_tensor(pos)], [MASS], N_GRID, BOX,
                                            1.0, deposit_method="pallas", info=info, **kick)
    assert info["n_overflow"] == 0
    assert float(info["mass_sum"]) == pytest.approx(N * MASS, rel=1e-6)
    scale = float(scatter.abs().max())
    np.testing.assert_allclose(pallas.numpy() / scale, scatter.numpy() / scale, atol=1e-5)
    (jax_scatter,) = jax_pm([jnp.asarray(pos)], [MASS], N_GRID, BOX, 1.0,
                            deposit_method="scatter", **kick)
    np.testing.assert_allclose(np.asarray(jax_scatter) / scale, scatter.numpy() / scale,
                               atol=1e-5)
    # the reference fault: JAX's kernel path loses the overflow past its budget
    (jax_pallas,) = jax_pm([jnp.asarray(pos)], [MASS], N_GRID, BOX, 1.0,
                           deposit_method="pallas", **kick)
    jax_pallas = np.asarray(jax_pallas)
    lost = int((np.abs(jax_pallas).max(axis=1) == 0).sum())
    assert lost == n_over - 256
    assert np.abs(jax_pallas - scatter.numpy()).max() > 0.1 * scale
    bj = jax_bucketize(jnp.asarray(pos), MASS, N_GRID, BOX, CAPACITY, uniform_q=True)
    jax_grid = np.asarray(deposit_pallas(bj, N_GRID, interpret=True))
    assert jax_grid.sum() == pytest.approx((N - n_over) * MASS, rel=1e-5)
    assert float(jax_deposit(jnp.asarray(pos), MASS, N_GRID, BOX).sum()) == \
        pytest.approx(N * MASS, rel=1e-5)


def test_kernel_path_honours_stencil_differentiation():
    """The port's 'pallas' path takes the order-4 stencil gradients as its
    'scatter' path (and JAX's) does: the block kernels swap only the
    deposit and the gather.  The reference fault: JAX's 'pallas' path
    takes Fourier gradients whatever ``differentiation`` says
    (forces/pm.py:366-368), so it equals the Fourier run instead."""
    pos = _uniform()
    kw = dict(kick_integral=0.5, differentiation=4)
    (scatter,) = pm_gravity_momentum_updates([torch.as_tensor(pos)], [MASS], N_GRID, BOX,
                                             1.0, deposit_method="scatter", **kw)
    (pallas,) = pm_gravity_momentum_updates([torch.as_tensor(pos)], [MASS], N_GRID, BOX,
                                            1.0, deposit_method="pallas", **kw)
    scale = float(scatter.abs().max())
    np.testing.assert_allclose(pallas.numpy() / scale, scatter.numpy() / scale, atol=1e-5)
    (jax_scatter,) = jax_pm([jnp.asarray(pos)], [MASS], N_GRID, BOX, 1.0,
                            deposit_method="scatter", **kw)
    np.testing.assert_allclose(np.asarray(jax_scatter) / scale, scatter.numpy() / scale,
                               atol=1e-5)
    (fourier,) = pm_gravity_momentum_updates([torch.as_tensor(pos)], [MASS], N_GRID, BOX,
                                             1.0, kick_integral=0.5)
    assert float((fourier - scatter).abs().max()) > 1e-2 * scale
    (jax_pallas,) = jax_pm([jnp.asarray(pos)], [MASS], N_GRID, BOX, 1.0,
                           deposit_method="pallas", **kw)
    np.testing.assert_allclose(np.asarray(jax_pallas) / scale, fourier.numpy() / scale,
                               atol=1e-5)


def _spectrum(out):
    files = glob.glob(os.path.join(out, "powerspec_a=1.txt"))
    assert files, f"no power spectrum in {out}"
    data = np.loadtxt(files[0])
    assert np.all(np.isfinite(data[:, :3]))
    return data[:, 0], data[:, 2]


def test_cli_pm_only_spectra_agree(tmp_path):
    """example_basic with PM gravity at 16³ particles on grid 32 through
    both command-line interfaces (the JAX package's deposit on the CPU is
    'scatter', as is the port's 'auto' there), a = 0.02 → 1."""
    common = ["-p", PARAM, "-c", "initial_conditions={'species':'matter','N':16**3}",
              "-c", "potential_options=32", "-c", "select_forces={'all': {'gravity': 'pm'}}"]
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    assert main([*common, "-c", f"output_dirs='{out_t}'", "--device", "cpu"]) == 0
    assert jax_main([*common, "-c", f"output_dirs='{out_j}'"]) == 0
    k, P = _spectrum(out_t)
    k_j, P_j = _spectrum(out_j)
    np.testing.assert_allclose(k, k_j, rtol=1e-5)  # JAX bins k in float32
    k_nyq = math.pi * 32 / (256 / 0.67)  # example_basic's box, in Mpc like k
    sel = k <= 0.5 * k_nyq
    assert sel.sum() >= 5
    np.testing.assert_allclose(P[sel], P_j[sel], rtol=0.01)


def _shrunk_pm(tmp_path, a_end=0.03):
    return load_params(PARAM, overrides=[
        "initial_conditions={'species':'matter','N':8**3}", "potential_options=16",
        "select_forces={'all': {'gravity': 'pm'}}",
        f"output_times={{'powerspec': [{a_end}]}}", f"output_dirs='{tmp_path}'"])


@pytest.fixture(scope="module")
def auto_run(tmp_path_factory):
    from concept_tpu_torch.run import run

    return run(_shrunk_pm(tmp_path_factory.mktemp("auto")), device="cpu")[1]


@pytest.mark.parametrize("method", ["pallas", "sorted"])
def test_run_deposit_methods_agree(tmp_path, auto_run, method):
    """run(cfg, deposit_method=...) with the JAX package's value names:
    'pallas' (the plain versions of rows 10-11 on the CPU) and 'sorted'
    (the same index_add_ as 'scatter') step as 'auto', which is 'scatter'
    on the CPU: positions at a = 0.03 to 1e-5 of the box."""
    from concept_tpu_torch.run import run

    ref = auto_run
    sim, got, a = run(_shrunk_pm(tmp_path), device="cpu", deposit_method=method)
    assert a == pytest.approx(0.03)
    assert sim.stats["steps"] > 10 and sim.stats["pm_mass_deficit_max"] < 1e-3
    d = torch.remainder(got.pos - ref.pos + BOX_EB / 2, BOX_EB) - BOX_EB / 2
    assert float(d.abs().max()) < 1e-5 * BOX_EB


def test_generic_p3m_kick_adds_the_short_range_sweep():
    """P³M with options the fused kick does not take (here bcc
    interlacing) runs the generic PM with the split scale plus the
    short-range sweep, as the JAX package's sim.py:277-291."""
    from concept_tpu_torch.components import ComponentSpec, ParticleState
    from concept_tpu_torch.forces.shortrange import shortrange_momentum_updates
    from concept_tpu_torch.sim import SimConfig, Simulation

    pos = torch.as_tensor(_uniform()[:1000])
    n_grid = 32  # 5³ short-range cells
    spec = ComponentSpec(name="m", species="matter", N=1000, mass=MASS)
    cfg = SimConfig(boxsize=BOX, potential_gridsize=n_grid, device=torch.device("cpu"),
                    method="p3m", interlace="bcc", softening=0.05)
    sim = Simulation(spec, cfg, None)
    assert not sim._fused
    state, (n_sr, n_pm) = sim._kick(ParticleState(pos=pos, mom=torch.zeros_like(pos)), 0.5)
    (pm,) = pm_gravity_momentum_updates([pos], [MASS], n_grid, BOX, 1.0, kick_integral=0.5,
                                        longrange_scale=sim._sr_scale, interlace="bcc")
    sr, n_ref = shortrange_momentum_updates(
        pos.unbind(1), MASS, BOX, sim._sr_scale, sim._sr_range, 0.5,
        n_cells=sim._sr_ncells, capacity=sim._sr_capacity, softening=0.05,
        max_overflow=sim._sr_max_overflow, softening_kernel=cfg.softening_kernel)
    torch.testing.assert_close(state.mom, pm + torch.stack(sr, dim=1), rtol=0, atol=0)
    assert (n_sr, n_pm) == (n_ref, 0)
