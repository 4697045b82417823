"""Per-column row bounds of the port's short-range sweeps, on the CPU
(the kernels' plain versions; tests/test_torch_kernels_cuda.py holds the
kernels against them on the card).

- The plain sweep with per-column bounds (1 + the highest valid row of
  each column, a column with holes below its bound included) equals the
  unbounded plain sweep exactly on every row below the receiver bound,
  and gives exactly 0 at or beyond it, for the ±1 table (n = 3, 6) and
  the reach-2 table (n = 5, 6); at these n every column has neighbours
  across a box face.  So do receiver bounds cut below the occupancy
  and per-pencil bounds (the wrapper expands them to columns).
- The rung stepper on its three layouts gives the same state, bit for
  bit, with its per-column bounds and with per-pencil ones (the max over
  each pencil of the same extents) over two base steps of a clumped
  state that fires rungs above 0."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

from concept_tpu_torch import p3mrungs  # noqa: E402
from concept_tpu_torch.components import particle_mass  # noqa: E402
from concept_tpu_torch.cosmology.background import Background  # noqa: E402
from concept_tpu_torch.forces.cuda_shortrange import (  # noqa: E402
    OFFSETS_27, pair_sweep_plain,
)
from concept_tpu_torch.forces.shortrange import SENTINEL, reach_offsets  # noqa: E402
from concept_tpu_torch.p3mrungs import P3MRungSimulation  # noqa: E402
from concept_tpu_torch.units import constants, units  # noqa: E402

FIELDS = ("pos", "mom", "valid", "rungs", "ids")


def _holey_layout(rng, n, K, box):
    """Sentinel-filled slots over n³ cells whose valid slots are NOT a
    column prefix (each slot valid with probability 0.6; column 0 has a
    hole below its highest valid row), and their per-column extents."""
    C = n**3
    valid = rng.random((K, C)) < 0.6
    valid[:, 0] = False
    valid[[0, 2, K - 2], 0] = True  # holes at rows 1 and 3..K-3
    cells = np.arange(C)
    cw = box / n
    base = np.stack([cells // (n * n), (cells // n) % n, cells % n]) * cw
    pos = base[:, None, :] + rng.random((3, K, C)) * cw
    s = np.where(valid[None], pos, SENTINEL * box).astype(np.float32)
    ext = np.where(valid, np.arange(1, K + 1)[:, None], 0).max(axis=0).astype(np.int32)
    return s, valid, ext


@pytest.mark.parametrize("bounds", ["occupancy", "restricted", "pencil"])
@pytest.mark.parametrize("table, n", [("pm1", 3), ("pm1", 6), ("reach", 5), ("reach", 6)])
def test_plain_column_bounds_are_exact(table, n, bounds):
    rng = np.random.default_rng(7 * n + len(table))
    K, box = 10, 1.0
    s, valid, ext = _holey_layout(rng, n, K, box)
    cw = box / n
    if table == "pm1":
        offsets, scale, cutoff = OFFSETS_27, 0.2 * cw, 0.9 * cw
    else:
        cutoff = (4.5 * 1.25 / 4.0) * cw
        offsets, scale = reach_offsets(cw, 0.55 * cw / 4.0), 1.25 * cw / 4.0
    sup = torch.as_tensor(s)
    recv = sup if table == "pm1" else torch.where(
        torch.as_tensor(valid)[None], sup, -SENTINEL * box)
    rb = ext
    if bounds == "restricted":
        rb = np.minimum(ext, rng.integers(0, K, size=n**3)).astype(np.int32)
    elif bounds == "pencil":
        rb = ext.reshape(n * n, n).max(axis=1)
    args = (n, box, scale, float(np.float32(cutoff) ** 2),
            float(np.float32(0.05 * cw) ** 2), "spline")
    ref = pair_sweep_plain(recv, sup, *args, offsets=offsets).numpy()
    sb = ext.reshape(n * n, n).max(axis=1) if bounds == "pencil" else ext
    got = pair_sweep_plain(recv, sup, *args, rext=torch.as_tensor(rb),
                           sext=torch.as_tensor(sb), offsets=offsets).numpy()
    rows = np.minimum(rb, K)[np.arange(n**3) // n] if bounds == "pencil" else rb
    inside = np.arange(K)[:, None] < rows[None, :]
    assert (np.abs(ref[:, inside & valid]) > 0).mean() > 0.9  # forces to compare
    np.testing.assert_array_equal(got[:, inside], ref[:, inside])
    assert np.all(got[:, ~inside] == 0)
    assert not valid[1, 0] and ext[0] == K - 1  # the hole lies below the bound


def _clumped_state(N1=8, box=10.0, seed=3):
    """A jittered N1³ lattice with an eighth of it pulled into a clump a
    few softening lengths wide: accelerations that fire rungs > 0."""
    rng = np.random.default_rng(seed)
    lin = (np.arange(N1) + 0.5) * (box / N1)
    pos = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    pos = pos + 0.2 * (box / N1) * rng.standard_normal(pos.shape)
    clump = rng.choice(N1**3, size=N1**3 // 8, replace=False)
    pos[clump] = 0.37 * box + 0.02 * box * rng.standard_normal((clump.size, 3))
    return np.mod(pos, box).astype(np.float32)


def _pencil(column_ext):
    """The same extents reduced to pencils (max over each pencil's
    columns): (…, C) → (…, n²)."""
    def ext(*args):
        e = column_ext(*args)
        nc = round(e.shape[-1] ** (1 / 3))
        return e.reshape(*e.shape[:-1], nc * nc, nc).max(dim=-1).values.contiguous()
    return ext


def _two_base_steps(layout):
    N1 = 8
    box = 8 * units.Mpc / 0.7
    G = constants.G_Newton
    bg = Background(H0=70 * units.km / (units.s * units.Mpc), Omega_m=0.30)
    mass = particle_mass(0.30, bg.rho_crit_of(G), box, N1**3)
    sim = P3MRungSimulation(N1, box, mass, G, mesh=32, bg=bg, N_rungs=4,
                            softening=0.004 * box, softening_kernel="spline",
                            fac_rung=0.03,  # small steps: rungs 1-3 fire
                            device="cpu", **layout)
    pos = torch.as_tensor(_clumped_state(N1, box))
    state = sim.init_state(tuple(pos[:, d] for d in range(3)),
                           tuple(torch.zeros(N1**3) for _ in range(3)))
    t = float(bg.t_of_a_np(0.02))
    state = sim.assign_initial_rungs(state, sim._timestep(0.02, 0.0))
    t_mom, vmax = t, 0.0
    for _ in range(2):
        a = float(bg.a_of_t_np(t))
        dt = sim._timestep(a, vmax / (a * mass))
        state, vmax = sim.base_step(state, t, dt, t_mom)
        t_mom, t = t + 0.5 * dt, t + dt
    return sim, state


@pytest.mark.parametrize("layout", [dict(unified=True, unified_cb=8),
                                    dict(unified=True, unified_cb=4),
                                    dict(unified=False)], ids=["ucb8", "ucb4", "tight"])
def test_stepper_column_and_pencil_bounds_agree(layout, monkeypatch):
    sim, state = _two_base_steps(layout)
    assert sim.stats["max_rung"] >= 1  # interior substeps with rung bounds ran
    assert sim._ext_occ.shape == (sim.nc**3,)
    occ = _pencil(p3mrungs._column_occ_ext)
    monkeypatch.setattr(p3mrungs, "_column_occ_ext", occ)
    monkeypatch.setattr(p3mrungs, "_column_rung_ext", lambda rungs, valid, NR: torch.stack(
        [occ(valid & (rungs >= k)) for k in range(NR)]))
    psim, pstate = _two_base_steps(layout)
    assert psim._ext_occ.shape == (sim.nc**2,)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(state, f).numpy(),
                                      getattr(pstate, f).numpy(), err_msg=f)
    assert sim.stats == psim.stats
