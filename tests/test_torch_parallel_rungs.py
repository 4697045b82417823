"""The port's rung stepper over ranks of their own processes (``gloo`` on
the CPU, parallel/ranks.Ranks with this process as rank 0): each rank
steps its x-planes of cells of the 8-mesh-cell layout
(p3mrungs.P3MRungSimulation(dist=...)).

(1) The setup of tests/test_distributed_rungs.py (8³ particles, mesh 32:
nc = 4 planes of cells, N_rungs = 4, 'spline' softening, a = 0.02 →
0.05) at d = 2 (two planes a rank) and d = 4 (one) against the port's one
device: each rank's first layout is the one-device layout's planes, slot
for slot (and so each particle's column and rung), and the final
positions lie within mean |Δx|/box < 1e-5 of it (the JAX package's own
bound between 8 devices and one, test_distributed_rungs.py:88) and
within 5e-5 of the JAX package's P3MRungSimulation(unified=True,
unified_cb=8) on one device (the bound of tests/test_torch_p3mrungs.py).
The lean PM kick (order-4 stencil gradients, forced at mesh 32) over two
ranks gives one device's kick within 1e-5 of the largest (the PM bound
of tests/test_distributed.py:40-43; measured ~4e-7, the slab FFT's
rounding).
(2) ``run(cfg, n_devices=2, device='cpu')`` on example_basic shrunk (8³,
grid 32, N_rungs = 4, a rung factor that lifts rungs to 2): it takes the
8-mesh-cell layout where ``-n 1`` on the CPU takes the tight one (the
departure of ROADMAP Queue 3), its spectrum lies within 1e-4 of ``-n 1``'s
(measured 1.6e-7 at a = 0.05 without the factor), and its autosave, made
by SIGTERM mid-segment, resumes under ``-n 1`` and under ``-n 2`` within
mean |Δx|/box 1e-5 of the uninterrupted ``-n 1`` run (measured 2.0e-7
under ``-n 2``).  What the decomposition does not cover
raises ``NotImplementedError`` naming its item before anything is
realized.

The module fixture starts five ranks once (a start costs ~5 s here):
ranks 0-3 run d = 4, then ranks 0-1 d = 2 while ranks 2 and 3 leave the
group and make test 2's runs (rank 3's two ``-n 2`` runs start a rank
each), and rank 4 runs the JAX package's stepper meanwhile, the longest
of these.  JAX is imported inside the functions that use it: the ranks
import this module to find their work.
"""

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


def _setup():
    """tests/test_distributed_rungs.py's state: (box, G, mass, H0, pos)."""
    from concept_tpu_torch.components import particle_mass
    from concept_tpu_torch.cosmology.background import Background
    from concept_tpu_torch.units import constants, units

    H0 = 70 * units.km / (units.s * units.Mpc)
    box = 8 * units.Mpc / 0.70
    G = constants.G_Newton
    mass = particle_mass(0.30, Background(H0=H0, Omega_m=0.30).rho_crit_of(G), box, N)
    rng = np.random.default_rng(9)
    lin = (np.arange(8, dtype=np.float32) + 0.5) * (box / 8)
    pos = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    pos = np.mod(pos + 0.2 * (box / 8) * rng.standard_normal(pos.shape).astype(np.float32),
                 box).astype(np.float32)
    return box, G, mass, H0, pos


def _sim(dist, **kw):
    from concept_tpu_torch.cosmology.background import Background
    from concept_tpu_torch.p3mrungs import P3MRungSimulation

    box, G, mass, H0, _ = _setup()
    return P3MRungSimulation(8, box, mass, G, mesh=32, bg=Background(H0=H0, Omega_m=0.30),
                             N_rungs=4, softening=0.03 * box / 8, softening_kernel="spline",
                             device="cpu", unified=True, unified_cb=8, dist=dist, **kw)


def _start(sim, dist):
    """The state's layout from this rank's index shard (the whole state
    on one device)."""
    pos = torch.as_tensor(_setup()[-1])
    if dist is not None:
        pos = pos[slice(*dist.shard(N))]
    return sim.init_state(tuple(pos[:, k] for k in range(3)),
                          tuple(torch.zeros(pos.shape[0]) for _ in range(3)))


def _layout(sim, st):
    return {"valid": st.valid, "ids": st.ids, "rungs": st.rungs, "ext": sim._ext_occ}


def _steps(dist):
    """The first layout, the final one after a = A0 → A1, and one lean PM
    kick's momenta from the first layout (zero momenta before)."""
    sim = _sim(dist)
    st = _start(sim, dist)
    out = {"init": _layout(sim, st)}
    bg = sim.bg
    st = sim.evolve(st, float(bg.t_of_a_np(A0)), float(bg.t_of_a_np(A1)))
    out["final"] = dict(_layout(sim, st), pos=st.pos, max_rung=sim.stats["max_rung"])
    lean = _sim(dist, pm_diff="lean")
    st = _start(lean, dist)
    st = lean._pm_kick(st, 1.0, lean._K_occ)[0]
    out["lean"] = {"mom": st.mom, "ids": st.ids, "valid": st.valid}
    return out


def _jax_final():
    """The JAX package's one-device unified stepper from the same state:
    the final positions (N, 3) in id order."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from concept_tpu.cosmology.background import Background as JaxBackground
    from concept_tpu.p3mrungs import P3MRungSimulation as JaxRungs
    from concept_tpu.p3mrungs import extract_flat as jax_extract

    box, G, mass, H0, pos = _setup()
    jbg = JaxBackground(H0=H0, Omega_m=0.30)
    jsim = JaxRungs(8, box, mass, G, mesh=32, bg=jbg, N_rungs=4, softening=0.03 * box / 8,
                    softening_kernel="spline", unified=True, unified_cb=8)
    jst = jsim.init_state(tuple(jnp.asarray(pos[:, k]) for k in range(3)),
                          tuple(jnp.zeros(N, jnp.float32) for _ in range(3)))
    jst = jsim.evolve(jst, float(jbg.t_of_a_np(A0)), float(jbg.t_of_a_np(A1)))
    jp, _, jids = (np.asarray(a) for a in jax_extract(jst, N))
    return jp[np.argsort(jids)]


def _rank_work(outdir, rank):
    """A rank's part of the fixture: d = 4 on ranks 0-3, then d = 2 on
    ranks 0-1, while ranks 2 and 3 leave the group for runs of their own
    (test 2's: rank 2 the one-device stepper and ``-n 1``, rank 3 ``-n 2``
    and its resumes); rank 4 runs the JAX package's stepper meanwhile."""
    import torch.distributed as tdist

    from concept_tpu_torch.grid.fft import GridDistribution

    r, store = rank
    init_rank(r, 5, store, CPU)
    four, pair = tdist.new_group([0, 1, 2, 3]), tdist.new_group([0, 1])
    if r == 4:
        np.save(os.path.join(outdir, "jax.npy"), _jax_final())
        return
    torch.save(_steps(GridDistribution(four)), os.path.join(outdir, f"d4_rank{r}.pt"))
    if r < 2:
        torch.save(_steps(GridDistribution(pair)), os.path.join(outdir, f"d2_rank{r}.pt"))
        return
    tdist.destroy_process_group()
    if r == 2:
        torch.save(_steps(None), os.path.join(outdir, "one.pt"))
    _runs(os.path.join(outdir, "runs"), r)


def _cfg(out, more=()):
    from concept_tpu_torch.param import load_params

    return load_params(PARAM, overrides=[
        "initial_conditions={'species':'matter','N':8**3}", "potential_options=32",
        "N_rungs=4", "Delta_t_rung_factor=0.002", "output_times={'powerspec': [0.03, 0.05]}",
        f"output_dirs='{out}'", *more])


def _runs(outdir, r):
    """Test 2's runs, in outdir: on rank 2 ``-n 1`` uninterrupted; on rank
    3 ``-n 2`` with SIGTERM after base step 20 (the ranks agree on it: the
    spectrum at a = 0.03 and an autosave mid-segment), then that autosave
    resumed under ``-n 1`` and, from a copy, under ``-n 2``."""
    from concept_tpu_torch import p3mrungs
    from concept_tpu_torch.run import run

    os.makedirs(outdir, exist_ok=True)
    os.chdir(outdir)
    if r == 2:
        sim, whole, _ = run(_cfg("one"), device="cpu")
        torch.save({"ucb": sim.inner.ucb, "pos": whole.pos}, "one.pt")
        return
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
    """Five ranks started once: {d: [each rank's results], 'one': the
    one-device run's, 'jax': the JAX package's final positions, 'runs':
    test 2's directory}."""
    outdir = str(tmp_path_factory.mktemp("rungs"))
    with Ranks(5, CPU) as started:
        started.start(_rank_work, outdir)
        _rank_work(outdir, rank=(0, started.store))
    out = {d: [torch.load(os.path.join(outdir, f"d{d}_rank{r}.pt")) for r in range(d)]
           for d in (2, 4)}
    out.update(one=torch.load(os.path.join(outdir, "one.pt")),
               jax=np.load(os.path.join(outdir, "jax.npy")),
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


def test_rung_stepper_over_ranks_matches_one_device_and_jax(ranks):
    box = _setup()[0]
    one, jax_pos = ranks["one"], ranks["jax"]
    ref = _by_id(one["final"]["pos"], one["final"]["ids"], one["final"]["valid"])
    lean_ref = _by_id(one["lean"]["mom"], one["lean"]["ids"], one["lean"]["valid"])
    P = 16  # columns a plane
    for d, res in ((2, ranks[2]), (4, ranks[4])):
        npl = 4 // d
        for r, out in enumerate(res):
            cols = slice(r * npl * P, (r + 1) * npl * P)
            for f in ("valid", "ids", "rungs"):
                assert torch.equal(out["init"][f], one["init"][f][:, cols]), (d, r, f)
            assert torch.equal(out["init"]["ext"], one["init"]["ext"][cols])
            assert out["final"]["max_rung"] == one["final"]["max_rung"]
        cat = {f: torch.cat([o["final"][f] for o in res], dim=-1)
               for f in ("pos", "ids", "valid", "rungs")}
        got = _by_id(cat["pos"], cat["ids"], cat["valid"])
        assert _mean_disp(got, ref, box) < 1e-5, d
        assert _mean_disp(got, jax_pos, box) <= 5e-5, d
        np.testing.assert_array_equal(
            _by_id(cat["rungs"][None], cat["ids"], cat["valid"]),
            _by_id(one["final"]["rungs"][None], one["final"]["ids"], one["final"]["valid"]))
        if d == 2:
            lean = {f: torch.cat([o["lean"][f] for o in res], dim=-1)
                    for f in ("mom", "ids", "valid")}
            np.testing.assert_allclose(_by_id(lean["mom"], lean["ids"], lean["valid"]),
                                       lean_ref, rtol=0, atol=1e-5 * np.abs(lean_ref).max())


def test_run_over_two_ranks_with_rungs(ranks, tmp_path, monkeypatch):
    from concept_tpu_torch import ic, p3mrungs
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    d = ranks["runs"]
    one = torch.load(os.path.join(d, "one.pt"))
    two = torch.load(os.path.join(d, "two.pt"))
    assert one["ucb"] == 0  # one rank on the CPU: the tight layout
    assert two["code"] == 128 + signal.SIGTERM and two["autosave"]
    assert two["seen"] == (8, 2)  # the 8-mesh-cell layout over ranks, rungs up to 2
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
    # what the decomposition does not cover raises before anything is realized
    realized = []
    monkeypatch.setattr(ic, "realize_particles", lambda *a, **kw: realized.append(1))
    small = ["initial_conditions={'species':'matter','N':8**3}", f"output_dirs='{tmp_path}'"]
    for over, match in ((["potential_options=24"], "do not split over 2 ranks.*item 14e"),
                        (["potential_options=20"], "no 8-mesh-cell layout.*item 14e"),
                        (["initial_conditions=[{'species':'cdm','N':8**3},"
                          "{'species':'baryon','N':8**3}]", "potential_options=32"],
                         "item 14d")):
        with pytest.raises(NotImplementedError, match=match):
            run(load_params(PARAM, overrides=small + over), device="cpu", n_devices=2)
    with pytest.raises(NotImplementedError, match="4-mesh-cell layouts.*item 14e"):
        p3mrungs.check_rank_layout(40, 2, unified_cb=4)
    assert not realized
