"""The port's slab decomposition over ranks of their own processes
(``gloo`` on the CPU, started by parallel/ranks.Ranks with this process
as rank 0), against the JAX package's ``shard_map`` on
``jax.devices()[:d]``: (1) the collectives of parallel/step.py and the
slab FFT at d = 2 and 4, (2) ``run(cfg, n_devices=2)`` for global-step PM
and P³M and the refusals of ``-n``, (3) the slab exchange where the JAX
package's drops particles.

Three tests; tests 1 and 3 read one start of four ranks (a module
fixture: a start costs ~5 s here, most of it importing torch and scipy),
which run d = 2 on a group of ranks 0-1; test 2 starts a run's ranks
twice:
pytest-xdist's ``--dist loadfile`` hands this file out after the files
with more tests.  JAX is imported inside the tests: the ranks import this
module to find their work, and need no JAX.

Tolerances: sort_to_slabs exact; deposits rtol 2e-5 / atol 1e-5 of the
largest value (tests/test_pallas_cells.py:62); FFTs 1e-5 of the largest
mode; PM momentum updates 1e-5 of the largest (tests/test_distributed.py:
40-43); the spectrum of ``-n 2`` within 1e-4 of the port's ``-n 1``
(measured at 8³ to a = 0.025: PM 2.5e-6, P³M 7.1e-6) and, for P³M, 2e-2
of the JAX package's ``-n 2`` (tests/test_distributed.py:218; measured
5.5e-6; PM's JAX -n 2 run, 4.3e-6, cost 10 s of compiles for the same
halo kick).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

from concept_tpu_torch.parallel.ranks import Ranks, init_rank  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM = os.path.join(ROOT, "param", "example_basic.py")
N_GRID, BOX, N, MASS, KICK = 16, 100.0, 4096, 2.0, 1e-3
CPU = torch.device("cpu")


def _uniform():
    return np.random.default_rng(11).uniform(0, BOX, (N, 3)).astype(np.float32)


def _clustered():
    """Two thirds of the particles in x < BOX/5, the rest uniform: at
    d = 4 slab 0 holds more than the JAX capacity 2N/d."""
    pos = _uniform()
    pos[: 2 * N // 3, 0] *= 0.2
    return pos


def _grid():
    return np.random.default_rng(12).standard_normal((N_GRID,) * 3).astype(np.float32)


def _collectives(outdir, rank):
    """A rank's part of tests 1 and 3: the uniform positions at d = 4 and
    on the group of ranks 0-1, the clustered ones at d = 4; its results
    into outdir/<positions>_d<d>_rank<r>.pt."""
    import torch.distributed as tdist

    from concept_tpu_torch.grid.fft import GridDistribution

    r, store = rank
    init_rank(r, 4, store, CPU)
    dist = GridDistribution()
    _collectives_on(outdir, dist, _uniform)
    _collectives_on(outdir, dist, _clustered)
    pair = tdist.new_group([0, 1])
    if r < 2:
        _collectives_on(outdir, GridDistribution(pair), _uniform)


def _collectives_on(outdir, dist, positions):
    from concept_tpu_torch.grid.fft import irfft3, rfft3
    from concept_tpu_torch.parallel import step

    pos = torch.as_tensor(positions())
    lo, hi = dist.shard(N)
    start, rows = dist.slab(N_GRID)
    slabbed, w, idx, n_over = step.sort_to_slabs(pos[lo:hi], dist, BOX)
    out = {"slabbed": slabbed, "idx": idx, "n_over": n_over,
           "halo": step.deposit_distributed_halo(slabbed, w, MASS, N_GRID, BOX, 2, dist)}
    if positions is _uniform:
        grid = torch.as_tensor(_grid())
        slab = rfft3(grid[start:start + rows], dist)
        dmom, _ = step.pm_momentum_updates_distributed_halo(pos[lo:hi], MASS, N_GRID, BOX,
                                                            1.0, KICK, dist)
        out.update(deposit=step.deposit_distributed(pos[lo:hi], MASS, N_GRID, BOX, 2, dist),
                   fft=slab, back=irfft3(slab, N_GRID, dist), dmom=dmom)
    torch.save(out, os.path.join(
        outdir, f"{positions.__name__}_d{dist.n_devices}_rank{dist.rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four ranks started once: {(positions, d): [each rank's results]}."""
    outdir = str(tmp_path_factory.mktemp("ranks"))
    with Ranks(4, CPU) as started:
        started.start(_collectives, outdir)
        _collectives(outdir, rank=(0, started.store))
    return {(name, d): [torch.load(os.path.join(outdir, f"{name}_d{d}_rank{r}.pt"))
                        for r in range(d)]
            for name, d in (("_uniform", 2), ("_uniform", 4), ("_clustered", 4))}


def _jit(fn, *static):
    """fn with the trailing arguments ``static`` bound, jitted (the JAX
    package's steps run jitted; op by op its PM kick takes 30 s here)."""
    import jax

    return jax.jit(lambda *a: fn(*a, *static))


def _jdist(d):
    import jax
    from jax.sharding import Mesh

    from concept_tpu.grid.fft import GridDistribution

    return GridDistribution(mesh=Mesh(np.array(jax.devices()[:d]), ("x",)), axis="x")


def _close(got, ref, rtol=2e-5, atol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol, atol=atol * np.abs(ref).max())


def test_collectives_over_ranks_match_jax_shard_map(ranks):
    import jax.numpy as jnp

    from concept_tpu.grid.fft import irfft3 as jax_irfft3, rfft3 as jax_rfft3
    from concept_tpu.parallel import step as jstep

    pos, grid = _uniform(), _grid()
    for d in (2, 4):
        res, jd = ranks["_uniform", d], _jdist(d)
        js, jw, jidx, jover = _jit(jstep.sort_to_slabs, jd, BOX)(jnp.asarray(pos))
        js, jw, jidx = (np.asarray(a).reshape(d, -1, *np.shape(a)[1:]) for a in (js, jw, jidx))
        assert int(jover) == 0
        for r, out in enumerate(res):
            valid = jw[r] > 0
            assert out["n_over"] == 0
            np.testing.assert_array_equal(out["idx"].numpy(), jidx[r][valid])
            np.testing.assert_array_equal(out["slabbed"].numpy(), js[r][valid])
        ref = _jit(jstep.deposit_distributed, MASS, N_GRID, BOX, 2, jd)(jnp.asarray(pos))
        _close(torch.cat([o["deposit"] for o in res]), ref)
        _close(torch.cat([o["halo"] for o in res]),
               _jit(jstep.deposit_distributed_halo, MASS, N_GRID, BOX, 2, jd)(
                   jnp.asarray(js.reshape(-1, 3)), jnp.asarray(jw.reshape(-1))))
        slab = _jit(jax_rfft3, jd)(jnp.asarray(grid))
        _close(torch.cat([o["fft"] for o in res], dim=1), slab, rtol=0)
        _close(torch.cat([o["back"] for o in res]), _jit(jax_irfft3, N_GRID, jd)(slab), rtol=0)
        dmom, _ = _jit(jstep.pm_momentum_updates_distributed_halo, MASS, N_GRID, BOX, 1.0,
                       KICK, jd)(jnp.asarray(pos))
        _close(torch.cat([o["dmom"] for o in res]), dmom, rtol=0)


def _run_spectrum(tmp_path, tag, method, n_devices, jax=False):
    from concept_tpu_torch.param import load_params

    out = tmp_path / tag
    over = ["initial_conditions={'species':'matter','N':8**3}", "potential_options=16",
            "N_rungs=1", f"select_forces={{'all': {{'gravity': '{method}'}}}}",
            "a_begin=0.02", "output_times={'powerspec': [0.025]}", f"output_dirs='{out}'"]
    if jax:
        from concept_tpu.param import load_params as jax_load
        from concept_tpu.run import run as jax_run

        jax_run(jax_load(PARAM, overrides=over), n_devices=n_devices)
    else:
        from concept_tpu_torch.run import run

        sim, state, _ = run(load_params(PARAM, overrides=over), device="cpu",
                            n_devices=n_devices)
        assert state.pos.shape == (8**3, 3) and sim.stats["pm_mass_deficit_max"] < 0.5
    return np.loadtxt(out / "powerspec_a=0.025.txt")


def test_run_over_two_ranks_matches_one_and_jax(tmp_path, monkeypatch):
    """run(cfg, n_devices=2) for PM and P³M (N_rungs = 1): its spectrum
    against the port's one rank, and P³M's (the halo PM kick and the
    short range) against the JAX package's two devices; ValueError for
    -n 2x1 on a grid A = 2 does not divide (run.check_pencil_layout), rungs whose tight
    layout has 2 cells a side (grid 16 on the CPU: the folded sweep, which
    does not run over ranks) and several components on a potential grid
    the ranks do not divide (run.check_multi_layout), before anything is
    realized."""
    from concept_tpu_torch import ic
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    monkeypatch.chdir(tmp_path)
    for method in ("pm", "p3m"):
        two = _run_spectrum(tmp_path, f"{method}2", method, 2)
        one = _run_spectrum(tmp_path, f"{method}1", method, 1)
        np.testing.assert_allclose(two[:, :2], one[:, :2], rtol=1e-12)
        np.testing.assert_allclose(two[:, 2], one[:, 2], rtol=1e-4)
    ref = _run_spectrum(tmp_path, "p3mjax", "p3m", 2, jax=True)
    np.testing.assert_allclose(two, ref, rtol=2e-2)
    realized = []
    monkeypatch.setattr(ic, "realize_particles", lambda *a, **kw: realized.append(1))
    small = ["initial_conditions={'species':'matter','N':8**3}", "potential_options=16",
             f"output_dirs='{tmp_path}'"]
    for over, n, error, match in (
            # -n AxB: the pencils' layout check (A = 2 does not divide 15)
            (["N_rungs=1", "potential_options=15"], "2x1", ValueError,
             "potential grid 15 does not split over A = 2 of -n 2x1"),
            # N_rungs = 8, the default
            ([], 2, ValueError, "2 cells a side take the folded sweep"),
            (["initial_conditions=[{'species':'cdm','N':8**3},{'species':'baryon','N':8**3}]",
              "N_rungs=1", "potential_options=15"], 2, ValueError,
             "the potential grid 15 does not split over 2 ranks")):
        with pytest.raises(error, match=match):
            run(load_params(PARAM, overrides=small + over), device="cpu", n_devices=n)
    assert not realized


def test_slab_exchange_drops_nothing_where_jax_drops(ranks):
    """Two thirds of the particles in slab 0 of 4: the JAX package's
    sort_to_slabs keeps 2N/4 of them, and its halo deposit loses the
    rest's mass; the port's exchange moves every particle."""
    import jax.numpy as jnp

    from concept_tpu.grid.interp import deposit as jax_deposit
    from concept_tpu.parallel import step as jstep

    pos = _clustered()
    res = ranks["_clustered", 4]
    jd = _jdist(4)
    js, jw, _, jover = _jit(jstep.sort_to_slabs, jd, BOX)(jnp.asarray(pos))
    assert int(jover) > 0
    jmass = float(jnp.sum(_jit(jstep.deposit_distributed_halo, MASS, N_GRID, BOX, 2, jd)(
        js, jw)))
    assert jmass < MASS * (N - int(jover)) * (1 + 1e-5)
    assert sum(len(o["idx"]) for o in res) == N
    assert sorted(torch.cat([o["idx"] for o in res]).tolist()) == list(range(N))
    halo = torch.cat([o["halo"] for o in res])
    assert abs(float(halo.sum(dtype=torch.float64)) - MASS * N) < 1e-3 * MASS
    _close(halo, _jit(jax_deposit, MASS, N_GRID, BOX)(jnp.asarray(pos)))
