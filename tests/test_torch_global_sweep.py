"""The global sweeps' occupancy bounds and work list (PERF.md rows 6 and
2), on the CPU through the kernels' plain version
(tests/test_torch_kernels_cuda.py holds the global kernel against it, and
against the unbounded launch bit for bit, on the card).

- The bounds the global callers derive hold every valid slot: min(counts,
  K) of a bucketize layout is exactly its column prefix, and
  ``p3mrungs._column_occ_ext`` of a persistent layout with holes lies
  above every valid row.
- With those bounds the plain sweep equals the unbounded plain sweep
  exactly: row 6 (receivers = suppliers) on both layouts, row 2 with 99 %
  of the receiver columns empty and K_r > 256.
- ``shortrange_momentum_updates``, ``_on_subset`` and
  ``p3msim.p3m_bucket_step`` hand the sweep those bounds.
- The work list covers every row below the receiver bounds exactly once,
  the columns with the most items first."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

from concept_tpu_torch import p3msim  # noqa: E402
from concept_tpu_torch.forces import cuda_shortrange  # noqa: E402
from concept_tpu_torch.forces.cuda_shortrange import (  # noqa: E402
    GLOBAL_ITEM_ROWS, global_work_list, pair_sweep_global, pair_sweep_plain,
    pair_sweep_subset,
)
from concept_tpu_torch.forces.shortrange import (  # noqa: E402
    SENTINEL, bucketize, occupancy_bounds, shortrange_momentum_updates,
    shortrange_momentum_updates_on_subset,
)
from concept_tpu_torch.p3mrungs import _column_occ_ext  # noqa: E402

N_CELLS, BOX = 8, 16.0
CW = BOX / N_CELLS
ARGS = (N_CELLS, BOX, 0.22 * CW, float(np.float32(0.95 * CW) ** 2),
        float(np.float32(0.05 * CW) ** 2), "spline")


def _clumped(rng, n, centre, sigma, box=BOX):
    """n positions (n, 3) float32: a uniform half and a Gaussian clump."""
    pos = rng.uniform(0, box, (n, 3))
    pos[: n // 2] = np.mod(centre + rng.normal(0, sigma, (n // 2, 3)), box)
    return pos.astype(np.float32)


def _bucketized(pos, capacity):
    """(sentinel-filled slots (3, K, C), valid (K, C), counts (C,)) of a
    bucketize at ``capacity``."""
    b = bucketize(tuple(torch.as_tensor(pos[:, d]) for d in range(3)), BOX, N_CELLS, capacity)
    slots = torch.where(b["valid"][None], torch.stack([b["hx"], b["hy"], b["hz"]]),
                        SENTINEL * BOX)
    return slots, b["valid"], b["counts"]


def _holey(rng, K):
    """Sentinel-filled slots of a persistent layout whose valid slots are
    not a column prefix (each slot valid with probability 0.5)."""
    C = N_CELLS**3
    valid = torch.as_tensor(rng.random((K, C)) < 0.5)
    cells = np.arange(C)
    base = np.stack([cells // N_CELLS**2, (cells // N_CELLS) % N_CELLS,
                     cells % N_CELLS]) * CW
    pos = torch.as_tensor((base[:, None, :] + rng.random((3, K, C)) * CW).astype(np.float32))
    return torch.where(valid[None], pos, SENTINEL * BOX), valid


def _rows_below(ext, K):
    return torch.arange(K)[:, None] < ext[None, :].long()


@pytest.mark.parametrize("layout", ["bucketize", "persistent"])
def test_bounds_hold_every_valid_slot(layout):
    rng = np.random.default_rng(3)
    if layout == "bucketize":
        _, valid, counts = _bucketized(_clumped(rng, 3000, 5.0, 0.8), 24)
        ext = occupancy_bounds(counts, 24)
        assert ext.dtype == torch.int32 and int(counts.max()) > 24  # stragglers
        assert torch.equal(_rows_below(ext, 24), valid)  # exactly the prefix
    else:
        _, valid = _holey(rng, 12)
        ext = _column_occ_ext(valid)
        below = _rows_below(ext, 12)
        assert not (valid & ~below).any()
        assert (below & ~valid).any()  # holes below the extents
        assert torch.equal(ext.long(), torch.where(
            valid.any(0), 12 - valid.flip(0).int().argmax(0), 0))


@pytest.mark.parametrize("layout", ["bucketize", "persistent"])
def test_row6_bounded_plain_equals_unbounded(layout):
    rng = np.random.default_rng(5)
    if layout == "bucketize":
        slots, _, counts = _bucketized(_clumped(rng, 2500, 9.0, 1.0), 32)
        ext = occupancy_bounds(counts, 32)
    else:
        slots, valid = _holey(rng, 10)
        ext = _column_occ_ext(valid)
    got = pair_sweep_global(slots, slots, *ARGS, rext=ext, sext=ext)
    ref = pair_sweep_plain(slots, slots, *ARGS)
    assert float(ref.abs().max()) > 0
    assert torch.equal(got, ref)


def test_row2_bounded_plain_equals_unbounded():
    """Receivers in 5 of the 512 columns (99 % empty), one 300 deep, at
    K_r = 320 > 256, against suppliers over the whole box."""
    rng = np.random.default_rng(9)
    recv = np.mod(np.array([5.1, 7.2, 3.3]) + rng.normal(0, 0.3, (300, 3)), BOX)
    recv = np.clip(recv, 4.0 + 1e-3, 6.0 - 1e-3)  # one cell: (2, 2, 2)
    recv = np.concatenate([recv, rng.uniform(0, 2.0, (4, 3)) + [[0, 0, 0], [2, 0, 0],
                                                               [0, 2, 0], [0, 0, 2]]])
    r_slots, r_valid, r_counts = _bucketized(recv.astype(np.float32), 320)
    s_slots, _, s_counts = _bucketized(_clumped(rng, 3000, 5.0, 1.5), 64)
    assert int((r_counts > 0).sum()) == 5 and int(r_counts.max()) == 300
    rext, sext = occupancy_bounds(r_counts, 320), occupancy_bounds(s_counts, 64)
    got = pair_sweep_subset(r_slots, s_slots, *ARGS, rext=rext, sext=sext)
    ref = pair_sweep_plain(r_slots, s_slots, *ARGS)
    assert float(ref[:, :300].abs().max()) > 0
    assert torch.equal(got, ref)


def _recording(monkeypatch, name):
    """Replace cuda_shortrange.<name> by a wrapper that records its row
    bounds and calls it."""
    seen = []
    fn = getattr(cuda_shortrange, name)

    def rec(*a, **kw):
        seen.append((kw.get("rext"), kw.get("sext")))
        return fn(*a, **kw)

    monkeypatch.setattr(cuda_shortrange, name, rec)
    return seen


def test_global_callers_pass_occupancy_bounds(monkeypatch):
    rng = np.random.default_rng(11)
    pos = _clumped(rng, 12**3, 8.0, 1.2)
    comps = tuple(torch.as_tensor(pos[:, d]) for d in range(3))
    seen = _recording(monkeypatch, "pair_sweep_global")
    _, n_over = shortrange_momentum_updates(comps, 1.0, BOX, 0.22 * CW, 0.95 * CW, 1.0,
                                            N_CELLS, 16, softening=0.05 * CW)
    counts = bucketize(comps, BOX, N_CELLS, 16)["counts"]
    assert n_over > 0
    assert all(torch.equal(e, occupancy_bounds(counts, 16)) for e in seen.pop())

    seen = _recording(monkeypatch, "pair_sweep_subset")
    recv, sup = torch.as_tensor(pos[:400]), torch.as_tensor(pos)
    shortrange_momentum_updates_on_subset(recv, sup, 1.0, BOX, 0.22 * CW, 0.95 * CW,
                                          N_CELLS, 40, 80)
    rext, sext = seen.pop()
    for p, K, e in ((recv, 40, rext), (sup, 80, sext)):
        c = bucketize(p.unbind(1), BOX, N_CELLS, K)["counts"]
        assert torch.equal(e, occupancy_bounds(c, K))

    seen = _recording(monkeypatch, "pair_sweep_global")
    sim = p3msim.P3MSimulation(12, BOX, 1.0, 1.0, mesh=32, softening=0.05 * CW)
    st = sim.init_state(comps, tuple(torch.zeros(12**3) for _ in range(3)))
    for _ in range(2):
        st, _ = sim.step(st, 1e-3, 1e-3)
    ext = _column_occ_ext(st.valid)
    assert len(seen) == 2 and all(torch.equal(e, ext) for pair in seen for e in pair)
    assert seen[0][0] is seen[1][0]  # once a layout


@pytest.mark.parametrize("K_r", [1, GLOBAL_ITEM_ROWS, GLOBAL_ITEM_ROWS + 1, 600])
def test_work_list_covers_every_row_once_deepest_first(K_r):
    rng = np.random.default_rng(K_r)
    C = N_CELLS**3
    rb = torch.as_tensor(np.where(rng.random(C) < 0.6, 0, rng.integers(0, K_r + 1, C)),
                         dtype=torch.int32)
    rb[17] = K_r
    items, n_items = global_work_list(rb, K_r)
    n = int(n_items)
    ch = -(-K_r // GLOBAL_ITEM_ROWS)
    assert items.shape == (C * ch,) and n_items.dtype == torch.int32
    col, chunk = items[:n] >> 24, items[:n] & 0xFFFFFF
    covered = torch.zeros((K_r, C), dtype=torch.int64)
    for c, j in zip(col.tolist(), chunk.tolist()):
        r0 = j * GLOBAL_ITEM_ROWS
        assert r0 < int(rb[c])
        covered[r0:min(r0 + GLOBAL_ITEM_ROWS, int(rb[c])), c] += 1
    assert torch.equal(covered, _rows_below(rb, K_r).long())
    depth = -(-rb.long()[col] // GLOBAL_ITEM_ROWS)
    assert (depth[1:] <= depth[:-1]).all()
    # within one depth, by column, and a column's chunks in order
    key = (ch - depth) * C * ch + col * ch + chunk
    assert (key[1:] > key[:-1]).all()
