"""The port's rung stepper over ranks of their own processes (``gloo`` on
the CPU, parallel/ranks.Ranks with this process as rank 0): each rank
steps its x-planes of cells of the layout one device takes
(p3mrungs.P3MRungSimulation(dist=...)), the planes split ⌊r·nc/d + ½⌋ on
(parallel/step.rank_planes), evenly or not.

(1) The setup of tests/test_distributed_rungs.py (8³ particles,
N_rungs = 4, 'spline' softening, a = 0.02 → 0.05) on every layout
against the port's one device: the 8-mesh-cell layout at mesh 32 (nc =
4) over d = 2 (two planes a rank) and d = 4 (one) and at mesh 24 over
d = 2 (2 + 1 planes); the 4-mesh-cell layout at mesh 28 over d = 2
(4 + 3 planes) and at mesh 32 over d = 4 (2 planes a rank, the reach-2
sweep's least); the tight layout at mesh 32 (nc = 5) over d = 2 (3 + 2).
Each rank's first layout is the one-device layout's planes, slot for
slot (and so each particle's column and rung), and the final positions
lie within mean |Δx|/box < 1e-5 of it (the JAX package's own bound
between 8 devices and one, test_distributed_rungs.py:88).  At mesh 32
with cells 8 mesh cells wide, and at mesh 28 with cells 4 wide, they lie
within 5e-5 of the JAX package's P3MRungSimulation(unified=True,
unified_cb=8, resp. 4) on one device (the bound of
tests/test_torch_p3mrungs.py).  The lean PM kick (order-4 stencil
gradients, forced at mesh 32) over two ranks gives one device's kick
within 1e-5 of the largest (the PM bound of tests/test_distributed.py:
40-43; measured ~4e-7, the slab FFT's rounding).
(2) ``run(cfg, n_devices=2, device='cpu')`` on example_basic shrunk (8³,
grid 32, N_rungs = 4, a rung factor that lifts rungs to 2): it takes the
tight layout, as ``-n 1`` on the CPU does (nc = 5: 3 + 2 planes), its
spectrum lies within 1e-4 of ``-n 1``'s, and its autosave, made by
SIGTERM mid-segment, resumes under ``-n 1`` and under ``-n 2`` within
mean |Δx|/box 1e-5 of the uninterrupted ``-n 1`` run.  What the
decomposition cannot run raises ValueError before anything is realized
(p3mrungs.check_rank_layout), and so do several components whose
particles the ranks cannot share evenly (run.check_multi_layout).

The module fixture starts five ranks once (a start costs ~5 s here):
rank 4 runs the JAX package's 4-mesh-cell stepper from the start; ranks
0-3 run d = 4, then ranks 0-1 d = 2 and rank 1 the one-device steppers,
while ranks 2 and 3 leave the group, rank 2 for the JAX package's
8-mesh-cell stepper, rank 3 for test 2's runs (its ``-n 2`` runs each
start a rank).  Each JAX stepper's compiles take longer than any other
rank's work.  JAX is imported inside the functions that use it: the
ranks import this module to find their work.
"""

import functools
import os
import shutil
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

from concept_tpu_torch.parallel.ranks import Ranks, init_rank  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM = os.path.join(ROOT, "param", "example_basic.py")
CPU = torch.device("cpu")
N = 8**3
A0, A1 = 0.02, 0.05


@functools.lru_cache(maxsize=None)
def _background():
    """The port's background of tests/test_distributed_rungs.py, built once
    a process (a build solves its growth ODEs, ~0.25 s here) and shared by
    its steppers, which only read it."""
    from concept_tpu_torch.cosmology.background import Background
    from concept_tpu_torch.units import units

    return Background(H0=70 * units.km / (units.s * units.Mpc), Omega_m=0.30)


def _setup():
    """tests/test_distributed_rungs.py's state: (box, G, mass, H0, pos)."""
    from concept_tpu_torch.components import particle_mass
    from concept_tpu_torch.units import constants, units

    H0 = 70 * units.km / (units.s * units.Mpc)
    box = 8 * units.Mpc / 0.70
    G = constants.G_Newton
    mass = particle_mass(0.30, _background().rho_crit_of(G), box, N)
    rng = np.random.default_rng(9)
    lin = (np.arange(8, dtype=np.float32) + 0.5) * (box / 8)
    pos = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    pos = np.mod(pos + 0.2 * (box / 8) * rng.standard_normal(pos.shape).astype(np.float32),
                 box).astype(np.float32)
    return box, G, mass, H0, pos


# each case: the mesh, the layout's P3MRungSimulation arguments, the
# world sizes it runs over
CASES = {
    "cb8": (32, dict(unified=True, unified_cb=8), (2, 4)),
    "cb8_uneven": (24, dict(unified=True, unified_cb=8), (2,)),
    "cb4_uneven": (28, dict(unified=True, unified_cb=4), (2,)),
    "cb4": (32, dict(unified=True, unified_cb=4), (4,)),
    "tight_uneven": (32, dict(unified=False), (2,)),
}
JAX_CASES = ("cb8", "cb4_uneven")


def _sim(dist, case="cb8", **kw):
    from concept_tpu_torch.p3mrungs import P3MRungSimulation

    mesh, layout, _ = CASES[case]
    box, G, mass, _, _ = _setup()
    return P3MRungSimulation(8, box, mass, G, mesh=mesh, bg=_background(),
                             N_rungs=4, softening=0.03 * box / 8, softening_kernel="spline",
                             device="cpu", dist=dist, **layout, **kw)


def _start(sim, dist):
    """The state's layout from this rank's index shard (the whole state
    on one device)."""
    pos = torch.as_tensor(_setup()[-1])
    if dist is not None:
        pos = pos[slice(*dist.split(N))]
    return sim.init_state(tuple(pos[:, k] for k in range(3)),
                          tuple(torch.zeros(pos.shape[0]) for _ in range(3)))


def _layout(sim, st):
    return {"valid": st.valid, "ids": st.ids, "rungs": st.rungs, "ext": sim._ext_occ}


def _steps(dist, case="cb8", lean=False):
    """The first layout, the final one after a = A0 → A1 and, with
    ``lean`` (the 8-mesh-cell case on one device and over two ranks), one
    lean PM kick's momenta from the first layout (zero momenta before)."""
    sim = _sim(dist, case)
    st = _start(sim, dist)
    out = {"init": _layout(sim, st), "nc": sim.nc}
    bg = sim.bg
    st = sim.evolve(st, float(bg.t_of_a_np(A0)), float(bg.t_of_a_np(A1)))
    out["final"] = dict(_layout(sim, st), pos=st.pos, max_rung=sim.stats["max_rung"])
    if lean:
        sim = _sim(dist, case, pm_diff="lean")
        st = sim._pm_kick(_start(sim, dist), 1.0, sim._K_occ)[0]
        out["lean"] = {"mom": st.mom, "ids": st.ids, "valid": st.valid}
    return out


def _jax_final(case):
    """The JAX package's one-device unified stepper from the same state:
    the final positions (N, 3) in id order."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from concept_tpu.cosmology.background import Background as JaxBackground
    from concept_tpu.p3mrungs import P3MRungSimulation as JaxRungs
    from concept_tpu.p3mrungs import extract_flat as jax_extract

    mesh, layout, _ = CASES[case]
    box, G, mass, H0, pos = _setup()
    jbg = JaxBackground(H0=H0, Omega_m=0.30)
    jsim = JaxRungs(8, box, mass, G, mesh=mesh, bg=jbg, N_rungs=4, softening=0.03 * box / 8,
                    softening_kernel="spline", **layout)
    jst = jsim.init_state(tuple(jnp.asarray(pos[:, k]) for k in range(3)),
                          tuple(jnp.zeros(N, jnp.float32) for _ in range(3)))
    jst = jsim.evolve(jst, float(jbg.t_of_a_np(A0)), float(jbg.t_of_a_np(A1)))
    jp, _, jids = (np.asarray(a) for a in jax_extract(jst, N))
    return jp[np.argsort(jids)]


def _rank_work(outdir, rank):
    """A rank's part of the fixture: rank 4 runs the JAX package's
    4-mesh-cell stepper from the start; the d = 4 cases on ranks 0-3;
    then the d = 2 cases on ranks 0-1 while rank 2 leaves the group for
    the JAX package's 8-mesh-cell stepper and rank 3 for test 2's runs;
    then rank 1 the one-device steppers."""
    import torch.distributed as tdist

    from concept_tpu_torch.grid.fft import GridDistribution

    r, store = rank
    init_rank(r, 5, store, CPU)
    four, pair = tdist.new_group([0, 1, 2, 3]), tdist.new_group([0, 1])
    if r == 4:
        np.save(os.path.join(outdir, "jax_cb4_uneven.npy"), _jax_final("cb4_uneven"))
        return
    for d, group in ((4, four), (2, pair)):
        if d == 2 and r >= 2:
            break
        for case, (_, _, worlds) in CASES.items():
            if d in worlds:
                torch.save(_steps(GridDistribution(group), case, lean=case == "cb8" and d == 2),
                           os.path.join(outdir, f"{case}_d{d}_rank{r}.pt"))
    if r == 1:
        for case in CASES:
            torch.save(_steps(None, case, lean=case == "cb8"),
                       os.path.join(outdir, f"one_{case}.pt"))
    if r < 2:
        return
    tdist.destroy_process_group()
    if r == 2:
        np.save(os.path.join(outdir, "jax_cb8.npy"), _jax_final("cb8"))
    else:
        _runs(os.path.join(outdir, "runs"))


def _cfg(out, more=()):
    from concept_tpu_torch.param import load_params

    return load_params(PARAM, overrides=[
        "initial_conditions={'species':'matter','N':8**3}", "potential_options=32",
        "N_rungs=4", "Delta_t_rung_factor=0.002", "output_times={'powerspec': [0.03, 0.05]}",
        f"output_dirs='{out}'", *more])


def _runs(outdir):
    """Test 2's runs, in outdir (a rank of the fixture's, which changes
    its directory): ``-n 1`` uninterrupted; ``-n 2`` with SIGTERM after
    base step 20 (the ranks agree on it: the spectrum at a = 0.03 and an
    autosave mid-segment), then that autosave resumed under ``-n 1`` and,
    from a copy, under ``-n 2``."""
    from concept_tpu_torch import p3mrungs
    from concept_tpu_torch.run import run

    os.makedirs(outdir, exist_ok=True)
    os.chdir(outdir)
    sim, whole, _ = run(_cfg("one"), device="cpu")
    torch.save({"ucb": sim.inner.ucb, "pos": whole.pos}, "one.pt")
    step, calls, seen = p3mrungs.P3MRungSimulation.base_step, [0], []

    def hooked(self, *args, **kw):
        out = step(self, *args, **kw)
        calls[0] += 1
        seen.append((self.ucb, self.stats["max_rung"]))
        if calls[0] == 20:
            signal.raise_signal(signal.SIGTERM)
        return out

    p3mrungs.P3MRungSimulation.base_step = hooked
    code = None
    try:
        run(_cfg("two", ["autosave_interval=0"]), device="cpu", n_devices=2)
    except SystemExit as e:
        code = e.code
    p3mrungs.P3MRungSimulation.base_step = step
    out = {"code": code, "seen": seen[-1],
           "autosave": os.path.exists(os.path.join("two", "example_basic", "auxiliary.json"))}
    shutil.copytree("two", "two_again")
    for d, n in (("two", 1), ("two_again", 2)):
        _, state, a = run(_cfg(d), device="cpu", n_devices=n)
        out[n] = (state.pos, a)
    torch.save(out, "two.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Five ranks started once: {(case, d): [each rank's results], 'one':
    the one-device runs' by case, 'jax': the JAX package's final
    positions by case, 'runs': test 2's directory}."""
    outdir = str(tmp_path_factory.mktemp("rungs"))
    with Ranks(5, CPU) as started:
        started.start(_rank_work, outdir)
        _rank_work(outdir, rank=(0, started.store))
    out = {(case, d): [torch.load(os.path.join(outdir, f"{case}_d{d}_rank{r}.pt"))
                       for r in range(d)]
           for case, (_, _, worlds) in CASES.items() for d in worlds}
    out.update(one={case: torch.load(os.path.join(outdir, f"one_{case}.pt"))
                    for case in CASES},
               jax={case: np.load(os.path.join(outdir, f"jax_{case}.npy"))
                    for case in JAX_CASES},
               runs=os.path.join(outdir, "runs"))
    return out


def _by_id(slots, ids, valid):
    """(3 or D, K, C) slot values → (N, 3) in id order."""
    v = valid.reshape(-1)
    vals = slots.reshape(slots.shape[0], -1)[:, v].T
    return vals[torch.argsort(ids.reshape(-1)[v])].double().numpy()


def _mean_disp(a, b, box):
    dx = a - b
    dx -= box * np.round(dx / box)
    return float(np.mean(np.sqrt((dx**2).sum(1))) / box)


def _check_case(ranks, case, d):
    """The ranks' first layouts against one device's planes, slot for
    slot, and their final positions against one device's (and the JAX
    package's, where it ran the case); returns the ranks' results."""
    from concept_tpu_torch.parallel.step import plane_starts

    box = _setup()[0]
    one, res = ranks["one"][case], ranks[(case, d)]
    ref = _by_id(one["final"]["pos"], one["final"]["ids"], one["final"]["valid"])
    P = one["nc"] ** 2  # columns a plane
    starts = plane_starts(one["nc"], d)
    for r, out in enumerate(res):
        cols = slice(starts[r] * P, starts[r + 1] * P)
        for f in ("valid", "ids", "rungs"):
            assert torch.equal(out["init"][f], one["init"][f][:, cols]), (case, d, r, f)
        assert torch.equal(out["init"]["ext"], one["init"]["ext"][cols])
        assert out["final"]["max_rung"] == one["final"]["max_rung"]
    cat = {f: torch.cat([o["final"][f] for o in res], dim=-1)
           for f in ("pos", "ids", "valid", "rungs")}
    got = _by_id(cat["pos"], cat["ids"], cat["valid"])
    assert _mean_disp(got, ref, box) < 1e-5, (case, d)
    if case in ranks["jax"]:
        assert _mean_disp(got, ranks["jax"][case], box) <= 5e-5, (case, d)
    np.testing.assert_array_equal(
        _by_id(cat["rungs"][None], cat["ids"], cat["valid"]),
        _by_id(one["final"]["rungs"][None], one["final"]["ids"], one["final"]["valid"]))
    return res


def test_rung_stepper_over_ranks_matches_one_device_and_jax(ranks):
    one = ranks["one"]["cb8"]
    lean_ref = _by_id(one["lean"]["mom"], one["lean"]["ids"], one["lean"]["valid"])
    for d in (2, 4):
        res = _check_case(ranks, "cb8", d)
        if d == 2:
            lean = {f: torch.cat([o["lean"][f] for o in res], dim=-1)
                    for f in ("mom", "ids", "valid")}
            np.testing.assert_allclose(_by_id(lean["mom"], lean["ids"], lean["valid"]),
                                       lean_ref, rtol=0, atol=1e-5 * np.abs(lean_ref).max())


@pytest.mark.parametrize("case, planes", [("cb8_uneven", (2, 1)), ("cb4_uneven", (4, 3)),
                                          ("cb4", (2, 2, 2, 2)), ("tight_uneven", (3, 2))])
def test_every_layout_over_ranks_matches_one_device(ranks, case, planes):
    """The 8-mesh-cell layout on 2 + 1 planes, the 4-mesh-cell layout on
    4 + 3 planes (also against the JAX package) and on 2 a rank, the
    tight layout on 3 + 2."""
    res = _check_case(ranks, case, len(planes))
    nc = ranks["one"][case]["nc"]
    assert tuple(o["init"]["valid"].shape[1] // nc**2 for o in res) == planes


@pytest.mark.parametrize("mesh, d, device, layout", [
    (40, 2, "cuda", dict(unified_cb=4)), (124, 2, "cuda", {}), (124, 4, "cuda", {}),
    (126, 2, "cuda", {}), (24, 2, "cpu", {}), (20, 2, "cpu", {}), (32, 4, "cpu", {})])
def test_check_rank_layout_takes_the_one_device_layout(mesh, d, device, layout):
    """Every layout over ranks, with planes split evenly or not: the
    4-mesh-cell layout at grid 124 (31 planes) over 2 and 4 ranks, the
    tight one at grid 126 (20 planes), grids 24 and 20 on the CPU (tight,
    3 planes)."""
    from concept_tpu_torch.p3mrungs import check_rank_layout, layout_planes

    assert check_rank_layout(mesh, d, device, **layout) == layout_planes(mesh, 1.0, device,
                                                                         **layout)


def test_run_over_two_ranks_with_rungs(ranks, tmp_path, monkeypatch):
    from concept_tpu_torch import ic, p3mrungs
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    d = ranks["runs"]
    one = torch.load(os.path.join(d, "one.pt"))
    two = torch.load(os.path.join(d, "two.pt"))
    assert one["ucb"] == 0  # one rank on the CPU: the tight layout
    assert two["code"] == 128 + signal.SIGTERM and two["autosave"]
    assert two["seen"] == (0, 2)  # the tight layout over ranks too, rungs up to 2
    spectra = [np.loadtxt(os.path.join(d, run_dir, "powerspec_a=0.03.txt"))
               for run_dir in ("one", "two")]
    np.testing.assert_allclose(spectra[1][:, :2], spectra[0][:, :2], rtol=1e-12)
    np.testing.assert_allclose(spectra[1][:, 2], spectra[0][:, 2], rtol=1e-4)
    box = float(load_params(PARAM).boxsize)
    for run_dir, n in (("two", 1), ("two_again", 2)):
        resumed, a = two[n]
        assert a == pytest.approx(A1)
        assert _mean_disp(resumed.double().numpy(), one["pos"].double().numpy(),
                          box) < 1e-5, n
        np.testing.assert_allclose(
            np.loadtxt(os.path.join(d, run_dir, "powerspec_a=0.05.txt"))[:, 2],
            np.loadtxt(os.path.join(d, "one", "powerspec_a=0.05.txt"))[:, 2], rtol=1e-4)
    # what the decomposition cannot run raises before anything is realized
    realized = []
    monkeypatch.setattr(ic, "realize_particles", lambda *a, **kw: realized.append(1))
    small = ["initial_conditions={'species':'matter','N':8**3}", f"output_dirs='{tmp_path}'"]
    for over, error, match in (
            (["potential_options=33"], ValueError, "grid 33 does not split over 2 ranks"),
            (["potential_options=16"], ValueError, "2 cells a side take the folded sweep"),
            (["initial_conditions=[{'species':'cdm','N':8**3},"
              "{'species':'baryon','N':5**3}]", "potential_options=32"],
             ValueError, "125 particles of 'baryon' do not split evenly over 2 ranks")):
        with pytest.raises(error, match=match):
            run(load_params(PARAM, overrides=small + over), device="cpu", n_devices=2)
    for mesh, d, layout, match in ((24, 4, dict(unified_cb=8), "leave a rank 0"),
                                   (20, 4, dict(unified_cb=4), "leave a rank 1; the sweep "
                                                               "reaches 2")):
        with pytest.raises(ValueError, match=match):
            p3mrungs.check_rank_layout(mesh, d, "cuda", **layout)
    assert not realized
