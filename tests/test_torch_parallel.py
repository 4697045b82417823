"""The port's slab decomposition (grid/fft.py, parallel/step.py, the
y-slab factors of grid/fourier.py and forces/pm.py, the distributed
spectrum, ``Simulation(dist=...)`` and ``run.make_distribution``) on a
world of one ``gloo`` rank in the test process, against the JAX package's
``shard_map`` functions on ``jax.devices()[:1]`` and its single-device
ones.  The ranks of more than one process are
tests/test_torch_parallel_ranks.py's.

At world size 1 the ring neighbour is the rank itself and the halo
planes wrap.  The JAX halo deposit counts them twice there (its full-grid
deposit already wraps them; a layout its make_distribution never builds),
so the port's halo deposit and PM kick are held to the JAX single-device
deposit and kick, and the JAX halo deposit's excess is pinned.

Tolerances: FFTs 1e-5 of the largest mode; sort_to_slabs exact (the same
float32 owner arithmetic); deposits and gathers rtol 2e-5 / atol 1e-5
(tests/test_pallas_cells.py:62); the PM kick 1e-5 of the largest update
(tests/test_distributed.py:40-43); spectra rtol 2e-5
(tests/test_distributed.py:153); the y-slab factors exactly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as tdist  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from concept_tpu.grid import fft as jfft  # noqa: E402
from concept_tpu.grid.interp import deposit as jax_deposit  # noqa: E402
from concept_tpu.parallel import step as jstep  # noqa: E402
from concept_tpu_torch.forces.pm import gravity_potential_slab  # noqa: E402
from concept_tpu_torch.grid import fourier  # noqa: E402
from concept_tpu_torch.grid.fft import GridDistribution, irfft3, rfft3  # noqa: E402
from concept_tpu_torch.parallel import step  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GRID, BOX, N = 16, 100.0, 2048


@pytest.fixture(scope="module")
def dist(tmp_path_factory):
    """A world of one gloo rank in this process."""
    store = tdist.FileStore(str(tmp_path_factory.mktemp("store") / "store"), 1)
    tdist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield GridDistribution()
    tdist.destroy_process_group()


@pytest.fixture(scope="module")
def jdist():
    return jfft.GridDistribution(mesh=Mesh(np.array(jax.devices()[:1]), ("x",)), axis="x")


def _pos(seed=4):
    return np.random.default_rng(seed).uniform(0, BOX, (N, 3)).astype(np.float32)


def _jit(fn, *static):
    """fn with the trailing arguments ``static`` bound, jitted (the JAX
    package's steps run jitted; op by op its shard_maps take seconds)."""
    return jax.jit(lambda *a: fn(*a, *static))


def _close(got, ref, rtol=2e-5, atol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * np.abs(ref).max())


def test_slab_fft_round_trip_matches_jax(dist, jdist):
    grid = np.random.default_rng(3).standard_normal((N_GRID,) * 3).astype(np.float32)
    slab = rfft3(torch.as_tensor(grid), dist)
    ref = np.asarray(jfft.rfft3(jnp.asarray(grid), jdist))
    np.testing.assert_allclose(slab.numpy(), ref, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(irfft3(slab, N_GRID, dist).numpy(), grid, atol=1e-5)


def test_sort_to_slabs_matches_jax(dist, jdist):
    pos = _pos()
    got, w, idx, n_over = step.sort_to_slabs(torch.as_tensor(pos), dist, BOX)
    ref, jw, jidx, jover = _jit(jstep.sort_to_slabs, jdist, BOX)(jnp.asarray(pos))
    valid = np.asarray(jw) > 0
    assert n_over == int(jover) == 0 and valid.sum() == N
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx)[valid])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref)[valid])
    np.testing.assert_array_equal(w.numpy(), np.ones(N, np.float32))


def test_deposits_match_jax_and_the_self_halo_is_periodic(dist, jdist):
    """The reduce-scatter deposit against JAX's psum_scatter one; the
    halo deposit against JAX's single-device deposit (the JAX halo
    deposit adds its wrapped halo planes twice at one device)."""
    pos = _pos()
    tpos = torch.as_tensor(pos)
    ref = np.asarray(_jit(jax_deposit, 1.0, N_GRID, BOX)(jnp.asarray(pos)))
    full = step.deposit_distributed(tpos, 1.0, N_GRID, BOX, 2, dist)
    _close(full, _jit(jstep.deposit_distributed, 1.0, N_GRID, BOX, 2, jdist)(jnp.asarray(pos)))
    slabbed, w, _, _ = step.sort_to_slabs(tpos, dist, BOX)
    halo = step.deposit_distributed_halo(slabbed, w, 1.0, N_GRID, BOX, 2, dist)
    _close(halo, ref)
    assert abs(float(halo.sum(dtype=torch.float64)) - N) < 1e-2
    js, jw, _, _ = _jit(jstep.sort_to_slabs, jdist, BOX)(jnp.asarray(pos))
    jhalo = np.asarray(_jit(jstep.deposit_distributed_halo, 1.0, N_GRID, BOX, 2, jdist)(js, jw))
    excess = jhalo - ref
    np.testing.assert_allclose(excess[[0, -1]], ref[[0, -1]], rtol=1e-5, atol=1e-4)
    assert np.abs(excess[1:-1]).max() < 1e-4


def test_halo_gather_and_replicate_match_jax(dist, jdist):
    g = np.random.default_rng(5).standard_normal((N_GRID,) * 3).astype(np.float32)
    pos = _pos()
    slabbed, w, _, _ = step.sort_to_slabs(torch.as_tensor(pos), dist, BOX)
    js, jw, _, _ = _jit(jstep.sort_to_slabs, jdist, BOX)(jnp.asarray(pos))
    got = step.gather_distributed_halo(torch.as_tensor(g), slabbed, w, BOX, 2, dist)
    ref = np.asarray(_jit(jstep.gather_distributed_halo, BOX, 2, jdist)(jnp.asarray(g), js, jw))
    _close(got, ref[np.asarray(jw) > 0])
    np.testing.assert_array_equal(step.replicate(torch.as_tensor(g), dist).numpy(), g)


@pytest.mark.parametrize("deconvolve", [(True, True), (False, True)], ids=["deconv4", "deconv2"])
def test_halo_pm_kick_matches_jax_single_device(dist, deconvolve):
    from concept_tpu.forces.pm import pm_gravity_momentum_updates as jax_pm

    pos = _pos(6)
    got, n_over = step.pm_momentum_updates_distributed_halo(
        torch.as_tensor(pos), 2.0, N_GRID, BOX, 1.0, 1e-3, dist, deconvolve=deconvolve,
        longrange_scale=1.25 * BOX / N_GRID)
    (ref,) = jax.jit(lambda p: jax_pm([p], [2.0], N_GRID, BOX, 1.0, kick_integral=1e-3,
                                      deconvolve=deconvolve,
                                      longrange_scale=1.25 * BOX / N_GRID))(jnp.asarray(pos))
    ref = np.asarray(ref)
    assert n_over == 0
    np.testing.assert_allclose(got.numpy() / np.abs(ref).max(), ref / np.abs(ref).max(),
                               atol=1e-5)


def test_distributed_powerspec_matches_one_device(dist):
    """The spectrum over the ranks (reduce-scatter deposit, slab FFT, the
    bins summed over the ranks) against the one-device spectrum, which
    tests/test_torch_float64.py::test_powerspec_f64_matches_jax_x64 holds
    to the JAX package's."""
    from concept_tpu_torch.analysis.powerspec import powerspec

    pos = torch.as_tensor(_pos(7))
    got = powerspec(pos, N_GRID, BOX, N, dist=dist)
    ref = powerspec(pos, N_GRID, BOX, N)
    np.testing.assert_allclose(got["k"], ref["k"], rtol=1e-6)
    np.testing.assert_array_equal(got["modes"], ref["modes"])
    np.testing.assert_allclose(got["power"], ref["power"], rtol=2e-5)


@pytest.mark.parametrize("d", [2, 4])
def test_y_slab_factors_are_the_rows_of_the_whole(d):
    """Each rank's k-vectors: its rows of the whole layout's factors, at
    d = 2 and 4, where k_y = 0 (rank 0) and the Nyquist row −n/2 (rank
    d/2) lie on different ranks."""
    n = N_GRID
    slab = torch.as_tensor(np.random.default_rng(8).standard_normal((n, n, n // 2 + 1, 2))
                           .astype(np.float32)).view(torch.complex64)[..., 0]
    whole = gravity_potential_slab(slab, n, BOX, 1.0, deconv_order=4, longrange_scale=3.0)
    rows = n // d
    for r in range(d):
        yr = (r * rows, rows)
        part = slab[:, r * rows:(r + 1) * rows]
        assert torch.equal(gravity_potential_slab(part, n, BOX, 1.0, deconv_order=4,
                                                  longrange_scale=3.0, y_rows=yr),
                           whole[:, r * rows:(r + 1) * rows])
        for dim in range(3):
            assert torch.equal(fourier.fourier_diff(part, n, BOX, dim, yr),
                               fourier.fourier_diff(slab, n, BOX, dim)[:, r * rows:(r + 1) * rows])
        assert torch.equal(fourier.interlace_phase(n, (0.5, 0.5, 0.5), y_rows=yr),
                           fourier.interlace_phase(n, (0.5, 0.5, 0.5))[:, r * rows:(r + 1) * rows])


def test_world_of_one_simulation_steps_as_one_device(dist):
    """A P³M and a PM step through Simulation(dist=...) (the halo kick,
    the all-gathered short range) against the one-device Simulation."""
    from concept_tpu_torch.components import ComponentSpec, ParticleState
    from concept_tpu_torch.cosmology.background import Background
    from concept_tpu_torch.sim import SimConfig, Simulation
    from concept_tpu_torch.units import constants, units

    bg = Background(H0=67 * units.km / (units.s * units.Mpc), Omega_m=0.319)
    pos = torch.as_tensor(_pos(9))
    for method in ("p3m", "pm"):
        spec = ComponentSpec("matter", "matter", N=N, mass=1e9)
        cfg = SimConfig(boxsize=BOX, potential_gridsize=N_GRID, device=torch.device("cpu"),
                        G=constants.G_Newton, method=method)
        out = []
        for dd in (None, dist):
            st = ParticleState(pos=pos.clone(), mom=torch.zeros_like(pos))
            sim = Simulation(spec, cfg, bg, dist=dd)
            out.append(sim.step(st, 1e-3, 1e-3).mom)
        scale = out[0].abs().max()
        assert float((out[1] - out[0]).abs().max() / scale) < 1e-5


def test_make_distribution_counts_and_refuses(dist):
    from concept_tpu_torch.run import make_distribution, rank_count

    cpu = torch.device("cpu")
    assert make_distribution(1, "cpu") is None
    assert rank_count(0, cpu) == os.cpu_count()
    with pytest.raises(ValueError, match="only"):
        rank_count(os.cpu_count() + 1, cpu)
    # -n AxB: A·B ranks, 1x1 one device; pencils are made by the ranks of
    # a run (tests/test_torch_parallel_pencils.py)
    assert rank_count("2x2", cpu) == 4 and make_distribution("1x1", "cpu") is None
    with pytest.raises(ValueError, match="only"):
        rank_count(f"{os.cpu_count()}x2", cpu)
    with pytest.raises(RuntimeError, match="no rank of a group of 4"):
        make_distribution("2x2", "cpu")
    with pytest.raises(TypeError, match="no grid distribution"):
        rfft3(torch.zeros(4, 4, 4), dist=object())
    with pytest.raises(RuntimeError, match="no rank of a group of 2"):
        make_distribution(2, "cpu")
