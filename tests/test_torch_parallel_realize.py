"""The port's realization over ranks of their own processes (``gloo`` on
the CPU, parallel/ranks.Ranks with this process as rank 0): each rank
draws the noise of its x-rows of the lattice grid, transforms on its
y-slab, realizes the particles of its lattice planes
(``ic.realize_particles(dist=...)``) and hands them to the ranks whose
index shards hold their ids (``parallel/step.hand_off``), through
``sim.Simulation(dist=...).initial_state`` (the shards of
``GridDistribution.shard``) and ``p3mrungs.RungSimulationAdapter(
dist=...).initial_state`` (``GridDistribution.split``).

Cases: 2LPT sc at n = 8 over d = 2 and 4; 3LPT sc with the 3/2
dealiasing (n = 8, m = 12) over 4; bcc at n = 6 over 4 (2 + 1 + 2 + 1
planes); the 'distributed' noise with fixed amplitudes and a phase shift
of π at n = 8 over 2; f_NL = 300 at n = 8 over 2; sc at n = 6 over 4.

Tolerances: the noise x-slab bit for bit the rows of one device's draw;
δ(k) on a rank's y-rows within 1e-5 of one device's largest mode (the
slab FFT's bound, tests/test_torch_parallel_ranks.py); positions by id
within 1e-5 of one device's largest displacement |x − q| plus 2·box·2⁻²⁴
(the rounding of a stored float32 position), momenta within 1e-5 of the
largest (tests/test_distributed.py:40-43); each rank holds exactly its
shard's ids, in order.  Where d divides n, against the JAX package's
``realize_particles(dist=...)`` on ``jax.devices()[:d]`` by id to the same
bounds (three configurations: 2LPT and 3LPT over 4, f_NL over 2).

In the ranks, ``parallel.step.replicate``, ``parallel.step.gather_rows``
and every ``torch.distributed.all_gather*`` raise, during
``initial_state`` and the adapter's ``_to_flat``, on a tensor of more
than d·64 elements: neither gathers the state or a grid.

The module fixture starts four ranks once (~5 s here): ranks 0-3 run the
d = 4 cases, then ranks 0-1 the d = 2 cases on their own group.  JAX is
imported inside the tests: the ranks import this module to find their
work, and need no JAX.
"""

import contextlib
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

from concept_tpu_torch.parallel.ranks import Ranks, init_rank  # noqa: E402

CPU = torch.device("cpu")
A, SEED, MASS = 0.05, 4, 1.0
# name: (N, lattice n, realize_particles options, world sizes)
CASES = {
    "2lpt": (8**3, 8, dict(lpt_order=2), (2, 4)),
    "3lpt_dealias": (8**3, 8, dict(lpt_order=3, dealias=True), (4,)),
    "bcc_uneven": (2 * 6**3, 6, dict(lpt_order=2), (4,)),
    "distributed_fixed_paired": (8**3, 8, dict(scheme="distributed", fixed_amplitude=True,
                                               phase_shift=np.pi), (2,)),
    "fnl": (8**3, 8, dict(lpt_order=2, nongaussianity=300.0), (2,)),
    "sc_uneven": (6**3, 6, dict(), (4,)),
}
JAX_CASES = (("2lpt", 4), ("3lpt_dealias", 4), ("fnl", 2))
# the bcc and fcc halo over 4 ranks at n = 13 (3 + 4 + 3 + 3 planes): in
# float32 the unshifted sites of plane 10, a rank's first, lie just below
# its centre, so their clouds reach row 9, the rank before's
HALO_N = 13


@functools.lru_cache(maxsize=None)
def _cosmology():
    """The port's linear cosmology of tests/test_torch_ic.py and its box."""
    from concept_tpu_torch.cosmology.background import Background
    from concept_tpu_torch.cosmology.linear import LinearCosmology
    from concept_tpu_torch.cosmology.primordial import PrimordialSpectrum
    from concept_tpu_torch.units import constants, units

    h = 0.67
    lin = LinearCosmology(Background(H0=100 * h * units.km / (units.s * units.Mpc),
                                     Omega_m=0.319),
                          PrimordialSpectrum(A_s=2.1e-9, n_s=0.96, pivot=0.05 / units.Mpc),
                          0.049, 0.27, constants.light_speed, units.Mpc)
    return lin, 64 * units.Mpc / h


def _spec(N):
    from concept_tpu_torch.components import ComponentSpec

    return ComponentSpec("matter", "matter", N=N, mass=MASS)


@contextlib.contextmanager
def _no_gathers(d):
    """``parallel.step.replicate`` / ``gather_rows`` and every
    ``torch.distributed.all_gather*`` raise on a tensor of more than d·64
    elements (counts pass).  Yields the patched ``replicate``."""
    import torch.distributed as tdist

    from concept_tpu_torch import sim
    from concept_tpu_torch.parallel import step

    limit = d * 64

    def guard(name, fn, size):
        def wrapped(*args, **kw):
            if size(*args) > limit:
                raise AssertionError(f"{name} of {size(*args)} elements")
            return fn(*args, **kw)
        return wrapped

    patches = [(step, "replicate", lambda a, dist: a.numel() * dist.n_devices),
               (sim, "replicate", lambda a, dist: a.numel() * dist.n_devices),
               (step, "gather_rows",
                lambda rows, dist: sum(x.numel() for x in rows) * dist.n_devices),
               (step, "_all_gather", lambda out, inp, **kw: out.numel()),
               (tdist, "all_gather", lambda out, inp, **kw: inp.numel() * len(out)),
               (tdist, "all_gather_into_tensor", lambda out, inp, **kw: out.numel())]
    if hasattr(tdist, "all_gather_single"):
        patches.append((tdist, "all_gather_single", lambda out, inp, **kw: out.numel()))
    saved = [(m, f, getattr(m, f)) for m, f, _ in patches]
    for m, f, size in patches:
        setattr(m, f, guard(f, getattr(m, f), size))
    try:
        yield step.replicate
    finally:
        for m, f, fn in saved:
            setattr(m, f, fn)


def _case_on(outdir, case, dist):
    """A rank's part of a case: its noise x-slab, δ(k) y-slab and raw
    realization, then the two entry points' shards and the adapter's flat
    state from its layout, the gathers patched."""
    from concept_tpu_torch.ic import normal_noise, realize_delta_slab, realize_particles
    from concept_tpu_torch.p3mrungs import RungSimulationAdapter
    from concept_tpu_torch.sim import SimConfig, Simulation

    N, n, kw, _ = CASES[case]
    lin, box = _cosmology()
    d = dist.n_devices
    out = {"rows": dist.rows(n), "noise": normal_noise(SEED, n, rows=dist.rows(n)),
           "delta": realize_delta_slab(
               lin, n, box, A, SEED, kw.get("fixed_amplitude", False),
               kw.get("phase_shift", 0.0), nongaussianity=kw.get("nongaussianity", 0.0),
               scheme=kw.get("scheme", "simple"), dist=dist)}
    raw = realize_particles(lin, _spec(N), box, A, seed=SEED, dist=dist, **kw)
    out["raw"] = (raw.pos, raw.mom, raw.ids)
    config = SimConfig(boxsize=box, potential_gridsize=32, device=CPU, method="pm")
    with _no_gathers(d) as replicate:
        with pytest.raises(AssertionError):  # the patch bites
            replicate(torch.zeros(64 + 1), dist)
        st = Simulation(_spec(N), config, lin.bg, lin, dist=dist).initial_state(
            A, seed=SEED, with_ids=True, **kw)
        out["sim"] = (st.pos, st.mom, st.ids)
        adapter = RungSimulationAdapter(_spec(N), config, lin.bg, lin, N_rungs=4, dist=dist)
        flat = adapter.initial_state(A, seed=SEED, **kw)
        out["adapter"] = (flat.pos, flat.mom, flat.ids)
        back = adapter._to_flat(adapter._to_layout(flat))
        out["to_flat"] = (back.pos, back.mom, back.ids)
    # the dumps' rows go to rank 0 alone
    whole = adapter.whole(flat, root=0)
    out["whole_rows"] = whole.pos.shape[0]
    torch.save(out, os.path.join(outdir, f"{case}_d{d}_rank{dist.rank}.pt"))


def _halo_grids():
    """Two random grids at HALO_N, the same on every rank."""
    g = torch.Generator().manual_seed(SEED)
    return torch.rand((2, HALO_N, HALO_N, HALO_N), generator=g)


def _halo_on(outdir, dist):
    """A rank's CIC interpolation of the bcc and fcc sites of its planes
    from its rows of :func:`_halo_grids` and the halo rows the others send
    (ic._halo_rows, ic._gather_planes)."""
    from concept_tpu_torch.components import lattice_positions
    from concept_tpu_torch.ic import _gather_planes, _halo_rows

    _, box = _cosmology()
    x0, rows = dist.rows(HALO_N)
    slabs = _halo_grids()[:, x0:x0 + rows]
    out = {}
    for kind in ("bcc", "fcc"):
        q = lattice_positions(HALO_N, box, kind, rows=(x0, rows))
        out[kind] = (q, _gather_planes(slabs, _halo_rows(slabs, HALO_N, dist), q, box, x0))
    torch.save(out, os.path.join(outdir, f"halo_d{dist.n_devices}_rank{dist.rank}.pt"))


def _rank_work(outdir, rank):
    import torch.distributed as tdist

    from concept_tpu_torch.grid.fft import GridDistribution

    r, store = rank
    init_rank(r, 4, store, CPU)
    pair = tdist.new_group([0, 1])
    _halo_on(outdir, GridDistribution())
    for d, dist in ((4, GridDistribution()), (2, GridDistribution(pair))):
        if r >= d:
            break
        for case, (*_, worlds) in CASES.items():
            if d in worlds:
                _case_on(outdir, case, dist)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four ranks started once: {(case, d): [each rank's results]}, and
    under ("halo", 4) each rank's bcc and fcc interpolations."""
    outdir = str(tmp_path_factory.mktemp("realize"))
    with Ranks(4, CPU) as started:
        started.start(_rank_work, outdir)
        _rank_work(outdir, rank=(0, started.store))
    out = {(case, d): [torch.load(os.path.join(outdir, f"{case}_d{d}_rank{r}.pt"))
                       for r in range(d)]
           for case, (*_, worlds) in CASES.items() for d in worlds}
    out["halo", 4] = [torch.load(os.path.join(outdir, f"halo_d4_rank{r}.pt"))
                      for r in range(4)]
    return out


@functools.lru_cache(maxsize=None)
def _one(case):
    """One device's realization: (noise, δ(k), pos, mom, q)."""
    from concept_tpu_torch.components import lattice_positions
    from concept_tpu_torch.ic import (normal_noise, preic_lattice_of, realize_delta_slab,
                                      realize_particles)

    N, n, kw, _ = CASES[case]
    lin, box = _cosmology()
    st = realize_particles(lin, _spec(N), box, A, seed=SEED, with_ids=True, **kw)
    delta = realize_delta_slab(lin, n, box, A, SEED, kw.get("fixed_amplitude", False),
                               kw.get("phase_shift", 0.0),
                               nongaussianity=kw.get("nongaussianity", 0.0),
                               scheme=kw.get("scheme", "simple"))
    q = lattice_positions(n, box, preic_lattice_of(N))
    return normal_noise(SEED, n), delta, st.pos.double(), st.mom.double(), q.double()


def _bounds(case):
    """(position bound, momentum bound) of a case against one device's."""
    _, box = _cosmology()
    _, _, pos, mom, q = _one(case)
    disp = pos - q
    disp -= box * torch.round(disp / box)
    return 1e-5 * float(disp.abs().max()) + 2 * box * 2.0**-24, 1e-5 * float(mom.abs().max())


def _check_by_id(case, pos, mom, ids, ref_pos, ref_mom):
    _, box = _cosmology()
    pb, mb = _bounds(case)
    dx = pos.double() - ref_pos[ids]
    dx -= box * torch.round(dx / box)
    assert float(dx.abs().max()) <= pb, case
    assert float((mom.double() - ref_mom[ids]).abs().max()) <= mb, case


def test_noise_and_delta_slabs_over_ranks(ranks):
    """Each rank's noise x-slab is bit for bit its rows of one device's
    draw, and its δ(k) y-slab lies within 1e-5 of one device's largest
    mode; the slabs, even or not, cover the grid once."""
    for (case, d), res in ranks.items():
        if case == "halo":
            continue
        noise, delta, *_ = _one(case)
        n = CASES[case][1]
        assert sum(o["rows"][1] for o in res) == n
        for o in res:
            x0, rows = o["rows"]
            assert torch.equal(o["noise"], noise[x0:x0 + rows]), (case, d)
        got = torch.cat([o["delta"] for o in res], dim=1)
        assert float((got - delta).abs().max()) <= 1e-5 * float(delta.abs().max()), (case, d)


def test_realized_shards_match_one_device_and_jax(ranks):
    """Per id against one device's realization: the raw lattice planes,
    and the shards of both entry points (each rank exactly its shard's
    ids, in order); the adapter's flat state from its layout is its
    shard bit for bit.  Where d divides n, against the JAX package's
    realize_particles(dist=...)."""
    import jax
    from jax.sharding import Mesh

    from concept_tpu.components import ComponentSpec as JaxSpec
    from concept_tpu.cosmology.background import Background as JaxBackground
    from concept_tpu.cosmology.linear import LinearCosmology as JaxLinear
    from concept_tpu.cosmology.primordial import PrimordialSpectrum as JaxPrim
    from concept_tpu.grid.fft import GridDistribution as JaxDist
    from concept_tpu.ic import realize_particles as jax_realize
    from concept_tpu_torch.units import constants, units

    for (case, d), res in ranks.items():
        if case == "halo":
            continue
        N = CASES[case][0]
        _, _, pos, mom, _ = _one(case)
        raw_ids = torch.cat([o["raw"][2].long() for o in res])
        assert torch.equal(torch.sort(raw_ids).values, torch.arange(N)), (case, d)
        for o in res:
            _check_by_id(case, *o["raw"][:2], o["raw"][2].long(), pos, mom)
        for entry, split in (("sim", False), ("adapter", True)):
            for r, o in enumerate(res):
                lo, hi = r * N // d, (r + 1) * N // d
                if not split:
                    lo, hi = r * (N // d), (r + 1) * (N // d)
                p, m, ids = o[entry]
                assert torch.equal(ids.long(), torch.arange(lo, hi)), (case, d, entry, r)
                _check_by_id(case, p, m, ids.long(), pos, mom)
        for r, o in enumerate(res):
            for got, ref in zip(o["to_flat"], o["adapter"]):
                assert torch.equal(got, ref), (case, d, r)
            assert o["whole_rows"] == (N if r == 0 else 0)
    h = 0.67
    H0 = 100 * h * units.km / (units.s * units.Mpc)
    lin_j = JaxLinear(JaxBackground(H0=H0, Omega_m=0.319),
                      JaxPrim(A_s=2.1e-9, n_s=0.96, pivot=0.05 / units.Mpc),
                      0.049, 0.27, constants.light_speed, units.Mpc)
    _, box = _cosmology()
    for case, d in JAX_CASES:
        N, _, kw, _ = CASES[case]
        jd = JaxDist(mesh=Mesh(np.array(jax.devices()[:d]), ("x",)), axis="x")
        ref = jax_realize(lin_j, JaxSpec("matter", "matter", N=N, mass=MASS), box, A,
                          seed=SEED, dist=jd, **kw)
        ref_pos = torch.as_tensor(np.array(ref.pos), dtype=torch.float64)
        ref_mom = torch.as_tensor(np.array(ref.mom), dtype=torch.float64)
        for o in ranks[case, d]:
            _check_by_id(case, *o["sim"][:2], o["sim"][2].long(), ref_pos, ref_mom)


def test_uneven_lattice_planes_over_ranks(ranks):
    """n = 6 over 4 ranks: 2 + 1 + 2 + 1 planes, for sc (one copy) and bcc
    (two, the shifted copy sampled by CIC with the next rank's first row,
    periodic at the box face); each rank realizes only its planes.  The
    bcc and fcc sites of each rank's planes at n = 13 over 4, interpolated
    from its rows and the rows before and after them sent by the others,
    are bit for bit grid/interp.gather of the whole grids, also where a
    site's cloud reaches the row before the rank's."""
    from concept_tpu_torch.grid.fft import row_starts
    from concept_tpu_torch.grid.interp import gather

    _, box = _cosmology()
    grids = _halo_grids()
    starts = row_starts(HALO_N, 4)
    reached = set()
    for r, o in enumerate(ranks["halo", 4]):
        for kind in ("bcc", "fcc"):
            q, got = o[kind]
            ref = torch.stack([gather(g, q, box) for g in grids], 1)
            assert torch.equal(got, ref), (kind, r)
            u = q[:, 0] / (box / HALO_N) - 0.5
            if bool((torch.floor(u) < starts[r]).any()):
                reached.add((kind, r))
    assert {("bcc", 3), ("fcc", 3)} <= reached
    for case, per_site in (("sc_uneven", 1), ("bcc_uneven", 2)):
        res = ranks[case, 4]
        assert [o["rows"][1] for o in res] == [2, 1, 2, 1]
        for o in res:
            x0, rows = o["rows"]
            assert o["raw"][0].shape[0] == per_site * rows * 36
            ids = o["raw"][2].long()
            plane = torch.div(ids % 216, 36, rounding_mode="floor")
            assert bool(((plane >= x0) & (plane < x0 + rows)).all())
