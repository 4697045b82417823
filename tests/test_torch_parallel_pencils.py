"""``-n AxB``: the 2D pencil decomposition over ranks of their own
processes (``gloo`` on the CPU, parallel/ranks.Ranks with this process as
rank 0): grid/fft.GridDistribution2D (``make_pencils``), the pencil
``rfft3`` / ``irfft3``, parallel/step.deposit_distributed_2d and
pm_momentum_updates_distributed_2d, ``Simulation`` on the pencils and
``run(n_devices='AxB')``.

(1) The pencil FFT on a 2 × 2 mesh at n = 16 and n = 12 (n/2+1 = 7,
padded to 8 for B = 2), each rank's Fourier pencil against
``torch.fft.rfftn``'s block and the round trip against its z-pencil, the
whole against the JAX package's pencil ``rfft3`` on a 2 × 2 mesh of its
host devices: max |Δ| ≤ 1e-5 of the largest value (the slab test's
bound, tests/test_torch_parallel.py:80); the same on 1 × 2 and 2 × 1
meshes of the first two ranks against ``rfftn``.
(2) The deposit and the PM kick (P³M's long-range part) of the same
numpy particles on the 2 × 2 mesh at grids 16 and 12, through ``grid/interp`` ('scatter')
and through the plain versions of PERF.md rows 10-11 ('pallas'), against
the JAX package's ``deposit_distributed_2d`` and
``pm_momentum_updates_distributed_2d`` on its 2 × 2 mesh: deposits
within rtol 2e-5 / atol 1e-5 of the largest value, momenta within 1e-5
of the largest (tests/test_torch_parallel.py:71-73, :139); the padded
kz columns of the potential and of its gradients exactly zero.
(3) ``Simulation`` on the pencils: an interlaced and a stencil kick run
the 1D paths over the A·B ranks, equal to the kick over ``-n 4``'s
ranks, where the JAX package's generic PM reads its 1D ``dist.axis``
from the pencils and raises AttributeError (ROADMAP Queue 3); the
pencil kick honours ``deconvolve`` (the JAX package's deconvolves by
2·order whatever it says), equal within 1e-5 to the halo kick's over
``-n 4``.
(4) ``run(n_devices='2x2')``: PM and P³M (``N_rungs = 1``) at 8³ / grid
16 to a = 0.025 (tests/test_distributed.py:230-284's shape) within rtol
2e-5 of ``-n 1``'s spectrum; a rung run and a run of two components
equal to ``-n 4``'s; the layout check's ValueErrors before anything is
realized.

The module fixture starts four ranks once.  All four make the 2 × 2
pencils and then the 1 × 2 and 2 × 1 pencils of ranks 0-1; then they
leave the group: rank 0 (this process, with tests/conftest.py's host
devices) runs the JAX package's pencils, ranks 1-3 the runs (each run
over ranks starts its own).  JAX is imported inside the functions that
use it: the ranks import this module to find their work.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

from concept_tpu_torch.parallel.ranks import Ranks, init_rank  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM = os.path.join(ROOT, "param", "example_basic.py")
CPU = torch.device("cpu")
FFT_SIZES = (16, 12)
N, BOX, G, KICK = 8**3, 100.0, 1.0, 0.01
N_GRID = 16  # the stepper kicks' grid


def _scale(n: int) -> float:
    """The P³M split scale of grid n."""
    return 1.25 * BOX / n


METHODS = ("scatter", "pallas")
# (4): name → (overrides, the other -n)
RUNS = {
    "pm": (["initial_conditions={'species':'matter','N':8**3}", "potential_options=16",
            "N_rungs=1", "select_forces={'all': {'gravity': 'pm'}}", "a_begin=0.02",
            "boxsize=128*Mpc", "output_times={'powerspec': [0.025]}"], 1),
    "p3m": (["initial_conditions={'species':'matter','N':8**3}", "potential_options=16",
             "N_rungs=1", "a_begin=0.02", "boxsize=128*Mpc",
             "output_times={'powerspec': [0.025]}"], 1),
    # example_basic shrunk as tests/test_torch_parallel_rungs.py runs it
    # (the tight layout, 5 planes of cells: 1 + 2 + 1 + 1 a rank)
    "rungs": (["initial_conditions={'species':'matter','N':8**3}", "potential_options=32",
               "N_rungs=4", "Delta_t_rung_factor=0.002",
               "output_times={'powerspec': [0.03]}"], 4),
    "multi": (["initial_conditions=[{'species':'cold dark matter','N':8**3},"
               "{'species':'baryon','N':4**3}]", "potential_options=16",
               "boltzmann_backend='eh'", "output_times={'powerspec': [0.03]}",
               "powerspec_select={'all': True, 'all combinations': True}"], 4),
}
RUNS_OF_RANK = {1: ("pm", "p3m"), 2: ("rungs",), 3: ("multi",)}
# (4): the layout check through run(): -n, overrides, message
REFUSED = [
    ("2x1", ["N_rungs=1", "potential_options=15"],
     "the potential grid 15 does not split over A = 2 of -n 2x1"),
    ("2x2", ["N_rungs=1", "initial_conditions={'species':'matter','N':5**3}",
             "potential_options=16"], "125 particles do not split evenly over the 4 ranks"),
]


def _inputs():
    """The numpy inputs every rank and the JAX package share: random grids
    of each FFT size and N particles in the box, float32."""
    rng = np.random.default_rng(19)
    grids = {n: rng.standard_normal((n, n, n)).astype(np.float32) for n in FFT_SIZES}
    return grids, (rng.random((N, 3)) * BOX).astype(np.float32)


def _fft_pieces(dist):
    """Per FFT size: this rank's rows, z-pencil's Fourier pencil and the
    round trip."""
    from concept_tpu_torch.grid.fft import irfft3, rfft3

    grids, _ = _inputs()
    out = {}
    for n, g in grids.items():
        (x0, rx), (y0, ry) = dist.x_rows(n), dist.y_rows(n)
        pencil = torch.from_numpy(g[x0:x0 + rx, y0:y0 + ry]).contiguous()
        f = rfft3(pencil, dist)
        out[n] = dict(x=(x0, rx), y=(y0, ry), z=dist.z_cols(n), f=f,
                      back=irfft3(f.clone(), n, dist), pencil=pencil)
    return out


def _kicks(dist):
    """The deposit and the kick of this rank's shard of the particles on
    the pencils, by each deposit method; the potential's and gradients'
    padded columns."""
    from concept_tpu_torch.forces.pm import gravity_potential_slab
    from concept_tpu_torch.grid.fft import irfft3, rfft3
    from concept_tpu_torch.grid.fourier import fourier_diff
    from concept_tpu_torch.parallel.step import (
        deposit_distributed_2d, pm_momentum_updates_distributed_2d,
    )

    _, pos = _inputs()
    lo, hi = dist.flat.shard(N)
    shard = torch.from_numpy(pos[lo:hi])
    out = {"lo": lo}
    for n in FFT_SIZES:
        out[n] = {"x": dist.x_rows(n), "y": dist.y_rows(n)}
        for m in METHODS:
            out[n][m] = dict(
                deposit=deposit_distributed_2d(shard, 1.0, n, BOX, 2, dist, m)[:2],
                kick=pm_momentum_updates_distributed_2d(shard, 1.0, n, BOX, G, KICK, dist,
                                                        longrange_scale=_scale(n),
                                                        deposit_method=m))
    # n = 12 with B = 2: 7 kz columns padded to 8
    n = 12
    grids, _ = _inputs()
    (x0, rx), (y0, ry) = dist.x_rows(n), dist.y_rows(n)
    rho = rfft3(torch.from_numpy(grids[n][x0:x0 + rx, y0:y0 + ry]).contiguous(), dist)
    rho[..., max(0, n // 2 + 1 - dist.z_cols(n)[0]):] = float("nan")  # what padding held
    phi = gravity_potential_slab(rho, n, BOX, G, deconv_order=4, longrange_scale=_scale(n),
                                 y_rows=dist.x_rows(n), z_cols=dist.z_cols(n))
    grads = [fourier_diff(phi, n, BOX, d, dist.x_rows(n), dist.z_cols(n)) for d in range(3)]
    out["padded"] = dict(z=dist.z_cols(n), phi=phi, grads=grads,
                         real=[irfft3(g.clone(), n, dist) for g in grads])
    return out


def _stepper_kicks(dist):
    """One kick of a Simulation on the pencils and on their flat ranks
    (-n 4's decomposition) from the same particles: interlaced, a stencil,
    and Fourier gradients without deconvolution."""
    from concept_tpu_torch.components import ComponentSpec, ParticleState
    from concept_tpu_torch.cosmology.background import Background
    from concept_tpu_torch.sim import SimConfig, Simulation
    from concept_tpu_torch.units import units

    _, pos = _inputs()
    lo, hi = dist.flat.shard(N)
    bg = Background(H0=70 * units.km / (units.s * units.Mpc), Omega_m=0.3)
    spec = ComponentSpec(name="matter", species="matter", N=N, mass=1.0)
    out = {}
    for case, kw in (("interlaced", dict(interlace=True)), ("stencil", dict(differentiation=4)),
                     ("no_deconvolution", dict(deconvolve=(False, False)))):
        cfg = SimConfig(boxsize=BOX, potential_gridsize=N_GRID, device=CPU, method="pm",
                        deposit_method="scatter", **kw)
        for tag, dd in (("pencils", dist), ("flat", dist.flat)):
            sim = Simulation(spec, cfg, bg, dist=dd)
            st = ParticleState(pos=torch.from_numpy(pos[lo:hi]).clone(),
                               mom=torch.zeros(hi - lo, 3))
            out[case, tag] = sim.kick(st, KICK).mom
    return out


def _spectra(outdir):
    import glob

    return {os.path.basename(f): np.loadtxt(f)
            for f in sorted(glob.glob(os.path.join(outdir, "powerspec_*")))}


def _runs(outdir, names):
    """Each named run at -n 2x2 and at its other -n, in its own
    directory; then (rank 3) the layout check's refusals."""
    from concept_tpu_torch import ic
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    res = {}
    for name in names:
        over, other = RUNS[name]
        for n in ("2x2", other):
            d = os.path.join(outdir, f"{name}_{n}")
            run(load_params(PARAM, overrides=over + [f"output_dirs='{d}'"]), device="cpu",
                n_devices=n)
            res[name, n] = _spectra(d)
    if "multi" in names:
        realized = []
        ic.realize_particles = lambda *a, **kw: realized.append(1)
        for n, over, _ in REFUSED:
            d = os.path.join(outdir, f"refused_{n}")
            try:
                run(load_params(PARAM, overrides=over + [f"output_dirs='{d}'"]),
                    device="cpu", n_devices=n)
                res["refused", n] = None
            except ValueError as e:
                res["refused", n] = (str(e), list(realized), os.path.exists(d))
    return res


def _jax_pencils():
    """The JAX package's pencil rfft3 of each grid, and its deposit and
    kick of the particles on each grid, on a 2 × 2 mesh of host devices;
    and what its generic PM does with an interlaced kick on those
    pencils."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from concept_tpu.forces.pm import pm_gravity_momentum_updates
    from concept_tpu.grid.fft import GridDistribution2D, rfft3
    from concept_tpu.parallel.step import (
        deposit_distributed_2d, pm_momentum_updates_distributed_2d,
    )

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    dist = GridDistribution2D(mesh=mesh, axis_a="x", axis_b="y")
    grids, pos = _inputs()
    out = {n: np.asarray(rfft3(jnp.asarray(g), dist)) for n, g in grids.items()}
    p = jnp.asarray(pos)
    for n in FFT_SIZES:
        out["deposit", n] = np.asarray(deposit_distributed_2d(p, 1.0, n, BOX, 2, dist))
        out["kick", n] = np.asarray(pm_momentum_updates_distributed_2d(
            p, 1.0, n, BOX, G, KICK, dist, order=2, longrange_scale=_scale(n)))
    try:
        pm_gravity_momentum_updates([p], [1.0], N_GRID, BOX, G, kick_integral=KICK, dist=dist,
                                    interlace=True)
        out["interlaced"] = None
    except AttributeError as e:
        out["interlaced"] = str(e)
    return out


def _rank_work(outdir, rank):
    import torch.distributed as tdist

    from concept_tpu_torch.grid.fft import make_pencils

    r, store = rank
    init_rank(r, 4, store, CPU)
    res = {}
    try:
        d22 = make_pencils(2, 2)
        res["2x2"] = dict(fft=_fft_pieces(d22), kicks=_kicks(d22), stepper=_stepper_kicks(d22),
                          place=(d22.a, d22.b))
        for shape in ((1, 2), (2, 1)):
            d = make_pencils(*shape)
            if d is not None:
                res[shape] = _fft_pieces(d)
    finally:
        tdist.destroy_process_group()
    torch.save(res, os.path.join(outdir, f"rank{r}.pt"))
    os.chdir(outdir)
    if r == 0:
        torch.save(_jax_pencils(), os.path.join(outdir, "jax.pt"))
    else:
        torch.save(_runs(outdir, RUNS_OF_RANK[r]), os.path.join(outdir, f"runs{r}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{rank: its group results}, 'jax': the JAX package's, 'runs': the
    runs' spectra and refusals."""
    outdir = str(tmp_path_factory.mktemp("pencils"))
    cwd = os.getcwd()
    try:
        with Ranks(4, CPU) as started:
            started.start(_rank_work, outdir)
            _rank_work(outdir, rank=(0, started.store))
    finally:
        os.chdir(cwd)
    out = {r: torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
           for r in range(4)}
    out["jax"] = torch.load(os.path.join(outdir, "jax.pt"), weights_only=False)
    out["runs"] = {}
    for r in RUNS_OF_RANK:
        out["runs"].update(torch.load(os.path.join(outdir, f"runs{r}.pt"), weights_only=False))
    return out


def _whole_fourier(pieces, n):
    """The Fourier pencils of every rank → the whole padded (n, n, nkp),
    and nkp."""
    nkp = max(p["z"][0] + p["z"][1] for p in pieces)
    whole = torch.zeros((n, n, nkp), dtype=pieces[0]["f"].dtype)
    for p in pieces:
        (x0, rx), (z0, c) = p["x"], p["z"]
        whole[:, x0:x0 + rx, z0:z0 + c] = p["f"]
    return whole, nkp


# --------------------------------------------------------------------- #
# (1) the pencil FFT
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n", FFT_SIZES)
def test_pencil_fft_matches_rfftn_and_jax(ranks, n):
    """On 2 × 2: each Fourier pencil is rfftn's block, its padded columns
    zero, the round trip its z-pencil, and the whole is the JAX
    package's pencil rfft3."""
    grids, _ = _inputs()
    ref = torch.fft.rfftn(torch.from_numpy(grids[n]))
    scale = ref.abs().max()
    pieces = [ranks[r]["2x2"]["fft"][n] for r in range(4)]
    whole, nkp = _whole_fourier(pieces, n)
    assert nkp == 2 * -(-(n // 2 + 1) // 2)
    assert torch.count_nonzero(whole[..., n // 2 + 1:]) == 0
    assert float((whole[..., :n // 2 + 1] - ref).abs().max() / scale) <= 1e-5
    jax_f = torch.from_numpy(ranks["jax"][n])
    assert float((whole[..., :n // 2 + 1] - jax_f).abs().max() / scale) <= 1e-5
    for p in pieces:
        assert float((p["back"] - p["pencil"]).abs().max() / p["pencil"].abs().max()) <= 1e-5


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_pencil_fft_on_two_ranks(ranks, shape):
    """1 × 2 and 2 × 1 over ranks 0-1 (ranks 2-3 made the groups with them
    and hold no pencils): rfftn's blocks and the round trip, both sizes."""
    assert shape not in ranks[2] and shape not in ranks[3]
    grids, _ = _inputs()
    for n in FFT_SIZES:
        ref = torch.fft.rfftn(torch.from_numpy(grids[n]))
        pieces = [ranks[r][shape][n] for r in range(2)]
        whole, _ = _whole_fourier(pieces, n)
        assert float((whole[..., :n // 2 + 1] - ref).abs().max() / ref.abs().max()) <= 1e-5
        assert torch.count_nonzero(whole[..., n // 2 + 1:]) == 0
        for p in pieces:
            assert float((p["back"] - p["pencil"]).abs().max()
                         / p["pencil"].abs().max()) <= 1e-5


# --------------------------------------------------------------------- #
# (2) the deposit and the kick
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n", FFT_SIZES)
@pytest.mark.parametrize("method", METHODS)
def test_pencil_deposit_and_kick_match_jax(ranks, method, n):
    """The z-pencils of the deposit put together, and the momenta of the
    rank's shards, against the JAX package's on its 2 × 2 mesh, on grid
    16 and on grid 12 (its kz columns padded)."""
    jax_dep = torch.from_numpy(ranks["jax"]["deposit", n])
    jax_kick = torch.from_numpy(ranks["jax"]["kick", n])
    dep = torch.zeros_like(jax_dep)
    kick = torch.zeros_like(jax_kick)
    for r in range(4):
        k = ranks[r]["2x2"]["kicks"]
        (x0, rx), (y0, ry) = k[n]["x"], k[n]["y"]
        pencil, total = k[n][method]["deposit"]
        dep[x0:x0 + rx, y0:y0 + ry] = pencil
        assert total.dtype == torch.float64 and float(total) == pytest.approx(N, rel=1e-6)
        kick[k["lo"]:k["lo"] + N // 4] = k[n][method]["kick"]
    torch.testing.assert_close(dep, jax_dep, rtol=2e-5, atol=1e-5 * float(jax_dep.abs().max()))
    assert float((kick - jax_kick).abs().max() / jax_kick.abs().max()) <= 1e-5


def test_padded_columns_stay_zero(ranks):
    """At n = 12 on B = 2 the last b's Fourier pencil has one padded
    column: the potential and its gradients are exactly zero there (NaN
    put there first), finite elsewhere, and the gradients' real pencils
    finite."""
    for r in range(4):
        assert ranks[r]["2x2"]["place"] == divmod(r, 2)  # rank r = a·B + b
        p = ranks[r]["2x2"]["kicks"]["padded"]
        z0, c = p["z"]
        pad = max(0, 7 - z0)
        assert (r % 2 == 1) == (pad < c)
        for f in [p["phi"], *p["grads"]]:
            assert torch.count_nonzero(f[..., pad:]) == 0
            assert bool(torch.isfinite(f[..., :pad]).all())
        for g in p["real"]:
            assert bool(torch.isfinite(g).all())


# --------------------------------------------------------------------- #
# (3) Simulation on the pencils
# --------------------------------------------------------------------- #
def test_stepper_kicks_on_the_pencils(ranks):
    """Interlaced and stencil kicks run the 1D paths over the pencils'
    A·B ranks, equal to -n 4's (the JAX package's generic PM reads
    ``dist.axis`` from its pencils and raises); the pencil kick without
    deconvolution matches the halo kick's within 1e-5 of the largest."""
    assert "axis" in ranks["jax"]["interlaced"]
    for r in range(4):
        st = ranks[r]["2x2"]["stepper"]
        for case in ("interlaced", "stencil"):
            assert torch.equal(st[case, "pencils"], st[case, "flat"]), (r, case)
        got, want = st["no_deconvolution", "pencils"], st["no_deconvolution", "flat"]
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


# --------------------------------------------------------------------- #
# (4) runs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["pm", "p3m"])
def test_run_2x2_matches_one(ranks, name):
    """PM and P³M with N_rungs = 1 at 8³ / grid 16 to a = 0.025: -n 2x2's
    spectrum within rtol 2e-5 of -n 1's."""
    two, one = ranks["runs"][name, "2x2"], ranks["runs"][name, 1]
    assert list(two) == list(one) == ["powerspec_a=0.025.txt"]
    for f, P in one.items():
        np.testing.assert_array_equal(two[f][:, :2], P[:, :2])
        np.testing.assert_allclose(two[f][:, 2], P[:, 2], rtol=2e-5)


@pytest.mark.parametrize("name", ["rungs", "multi"])
def test_run_2x2_equals_four_ranks(ranks, name):
    """The rung run and the run of CDM + baryons at -n 2x2 run over its
    four ranks as -n 4: the same spectra, every pair included."""
    two, four = ranks["runs"][name, "2x2"], ranks["runs"][name, 4]
    assert list(two) == list(four) and len(four) == (1 if name == "rungs" else 3)
    for f, P in four.items():
        np.testing.assert_array_equal(two[f], P)


def test_layout_check_raises_before_realizing(ranks):
    """A grid that A does not divide and an N that A·B does not divide
    raise ValueError through run() before anything is realized or
    written; check_pencil_layout's other cases."""
    from concept_tpu_torch.run import check_pencil_layout, pencil_shape

    for n, _, match in REFUSED:
        msg, realized, wrote = ranks["runs"]["refused", n]
        assert match in msg and not realized and not wrote, (n, msg)
    for args, match in ((("1x3", 16, 512, "pencils"), "over B = 3"),
                        (("2x2", 18, 512, "slabs"), "over A·B = 4"),
                        (("2x2", 16, 510, "pencils"), "510 particles do not split evenly"),
                        (("2x2", 16, 510, None), "510 particles do not split evenly")):
        with pytest.raises(ValueError, match=match):
            check_pencil_layout(*args)
    # the pencil FFT needs A | n and B | n only; PP has no grid
    for args in (("2x2", 18, 512, "pencils"), ("4x2", 16, 512, "pencils"),
                 ("2x2", 15, 512, None)):
        check_pencil_layout(*args)
    assert pencil_shape("4") is None and pencil_shape("2X3") == (2, 3)
    for bad in ("0x2", "2x", "ax2"):
        with pytest.raises(ValueError):
            pencil_shape(bad)
