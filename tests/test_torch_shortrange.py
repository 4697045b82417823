"""The port's one-sided short-range sweep (concept_tpu_torch.forces) vs
the JAX package's XLA sweep (_sweep_pair) and its Pallas kernels in
interpret mode (sweep_pallas_pair, flat and row-bounded).

Tolerance: max|Δ|/max|ref| < 1e-5, the Pallas-vs-XLA sweep metric of
tests/test_pallas_shortrange.py:41 (it absorbs the screening fit, ≤ 1e-6
on S, and float32 summation order).  Rows beyond a receiver bound must
be exactly 0."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax.numpy as jnp  # noqa: E402

from concept_tpu.forces.pallas_shortrange import (  # noqa: E402
    _G_COEF as JAX_G_COEF, _lane_valid_packs, screening_g as jax_screening_g,
    sweep_pallas_pair,
)
from concept_tpu.forces.shortrange import (  # noqa: E402
    _sweep_pair as jax_sweep_pair, bucketize,
)
from concept_tpu_torch.forces.cuda_shortrange import pair_sweep  # noqa: E402
from concept_tpu_torch.forces.shortrange import (  # noqa: E402
    _G_COEF, SENTINEL, _sweep_pair, screening_g, window_bounds,
)

TOL = 1e-5
DATA = os.path.join(os.path.dirname(__file__), "data")


def _maxrel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _port_sweep(b, n, box, scale, cutoff, soft, kernel):
    t = [torch.as_tensor(np.array(b[k])) for k in ("hx", "hy", "hz", "valid")]
    c2 = float(np.float32(cutoff) ** 2)
    s2 = float(np.float32(soft) ** 2)
    return _sweep_pair(*t, *t, n, box, scale, c2, s2, kernel=kernel).numpy()


def _jax_sweeps(b, n, box, scale, cutoff, soft, kernel):
    args = (b["hx"], b["hy"], b["hz"], b["valid"]) * 2
    xla = jax_sweep_pair(*args, n, jnp.float32(box), jnp.float32(scale),
                         jnp.float32(cutoff) ** 2, jnp.float32(soft) ** 2,
                         kernel=kernel)
    pallas = sweep_pallas_pair(*args, n, box, scale, cutoff, soft,
                               interpret=True, kernel=kernel)
    return np.asarray(xla), np.asarray(pallas)


def test_screening_fit_matches_jax():
    np.testing.assert_array_equal(_G_COEF, JAX_G_COEF)
    u = np.linspace(0, 25.0, 4001, dtype=np.float32)
    np.testing.assert_allclose(screening_g(torch.as_tensor(u)).numpy(),
                               np.asarray(jax_screening_g(jnp.asarray(u))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kernel", ["plummer", "spline", "none"])
def test_flat_sweep_matches_jax(kernel):
    """Clustered blobs + uniform background near the wrap (the inputs of
    tests/test_pallas_shortrange.py), all three softening kernels."""
    rng = np.random.default_rng(9)
    box, nc = 100.0, 5
    blob = rng.normal(50, 4.0, (150, 3))
    edge = rng.uniform(0, 10, (100, 3))
    pos = np.mod(np.concatenate([blob, edge]), box).astype(np.float32)
    counts = np.asarray(bucketize(jnp.asarray(pos), box, nc, 8)["counts"])
    K = -(-int(counts.max()) // 8) * 8
    b = bucketize(jnp.asarray(pos), box, nc, K)
    scale, cutoff, soft = 4.0, 18.0, 0.5
    got = _port_sweep(b, nc, box, scale, cutoff, soft, kernel)
    xla, pallas = _jax_sweeps(b, nc, box, scale, cutoff, soft, kernel)
    v = np.asarray(b["valid"])
    assert _maxrel(got[:, v], xla[:, v]) < TOL
    assert _maxrel(got[:, v], pallas[:, v]) < TOL
    assert np.all(got[:, ~v] == 0)


def test_oracle_8cube_sweep_matches_jax():
    """The 8³ PP oracle's initial positions, spline softening, mesh-32
    split (tests/data/oracle_pp_8cube.npz)."""
    d = np.load(os.path.join(DATA, "oracle_pp_8cube.npz"))
    box = float(d["boxsize"])
    pos = np.mod(d["ic_pos"], box).astype(np.float32)
    scale = 1.25 * box / 32
    cutoff = 4.5 * scale
    nc = int(box / cutoff)
    K = 32
    b = bucketize(jnp.asarray(pos), box, nc, K)
    assert nc >= 3 and int(np.asarray(b["counts"]).max()) <= K
    soft = float(d["softening"])
    got = _port_sweep(b, nc, box, scale, cutoff, soft, "spline")
    xla, pallas = _jax_sweeps(b, nc, box, scale, cutoff, soft, "spline")
    v = np.asarray(b["valid"])
    assert _maxrel(got[:, v], xla[:, v]) < TOL
    assert _maxrel(got[:, v], pallas[:, v]) < TOL


def _layout(rng, n, K, box):
    """Random prefix-valid sentinel layout + per-pencil extents (the
    construction of tests/test_bounded_sweep.py)."""
    C = n**3
    counts = rng.integers(0, K + 1, size=C)
    valid = np.arange(K)[:, None] < counts[None, :]
    ci, cj, ck = np.arange(C) // (n * n), (np.arange(C) // n) % n, np.arange(C) % n
    cw = box / n
    base = np.stack([ci * cw, cj * cw, ck * cw])
    pos = base[:, None, :] + rng.random((3, K, C)) * cw
    s = np.where(valid[None], pos, SENTINEL * box).astype(np.float32)
    ext = counts.reshape(n * n, n).max(axis=1).astype(np.int32)
    return s, valid, ext


@pytest.mark.parametrize("kernel", ["plummer", "spline"])
@pytest.mark.parametrize("bounds", ["full_K", "occupancy", "restricted"])
def test_bounded_sweep_matches_jax(kernel, bounds):
    """Row-bounded sweep on a dense random layout.  Rows beyond a bound
    are exactly 0; rows inside it match the XLA ``_sweep_pair`` and the
    Pallas bounded kernel."""
    rng = np.random.default_rng(3)
    n, K, box = 16, 16, 1.0
    s, valid, ext = _layout(rng, n, K, box)
    assert _lane_valid_packs(n, n**3)  # the Pallas bounded kernel applies
    scale, cutoff, soft = 0.012, 0.054, 0.004
    sext = ext
    if bounds == "full_K":
        rext = sext = np.full(n * n, K, np.int32)
    elif bounds == "occupancy":
        rext = ext
    else:
        rc = rng.integers(0, K // 2, size=n**3) * (rng.random(n**3) < 0.3)
        rext = rc.reshape(n * n, n).max(axis=1).astype(np.int32)
    sj = [jnp.asarray(a) for a in s]
    vj = jnp.asarray(valid)
    pallas = np.asarray(sweep_pallas_pair(
        *sj, vj, *sj, vj, n, box, scale, cutoff, soft, interpret=True,
        kernel=kernel, sentineled=True, rext=jnp.asarray(rext),
        sext=jnp.asarray(sext)))
    xla = np.asarray(jax_sweep_pair(
        *sj, vj, *sj, vj, n, jnp.float32(box), jnp.float32(scale),
        jnp.float32(cutoff) ** 2, jnp.float32(soft) ** 2, kernel=kernel))
    st = torch.as_tensor(s)
    got = pair_sweep(st, st, n, box, scale, float(np.float32(cutoff) ** 2),
                     float(np.float32(soft) ** 2), kernel=kernel,
                     rext=torch.as_tensor(rext), sext=torch.as_tensor(sext)).numpy()
    rb = np.minimum(rext, K)[np.arange(n**3) // n]
    inside = (np.arange(K)[:, None] < rb[None, :]) & valid
    beyond = np.arange(K)[:, None] >= rb[None, :]
    assert inside.any()
    assert _maxrel(got[:, inside], xla[:, inside]) < TOL
    assert _maxrel(got[:, inside], pallas[:, inside]) < TOL
    assert np.all(got[:, beyond] == 0)
    if bounds != "restricted":
        # true extents: the Pallas kernel's window bounds (a max over
        # packed pencils) cover the same valid rows
        assert np.all(pallas[:, beyond] == 0)


def test_window_bounds_match_jax_at_pack_1():
    from concept_tpu.forces.pallas_shortrange import _window_bounds

    rng = np.random.default_rng(1)
    n = 6
    ext = rng.integers(0, 20, size=n * n).astype(np.int32)
    for nb in (False, True):
        np.testing.assert_array_equal(
            window_bounds(torch.as_tensor(ext), n, nb).numpy(),
            np.asarray(_window_bounds(jnp.asarray(ext), n, 1, nb)))
