"""The port's mesh layer and unified-layout PM (concept_tpu_torch.grid.fft,
forces.pm, p3msim.pm_gradient_cells) vs the JAX package: jnp.fft,
gravity_potential_slab and pm_gradient_cells(cb = 8) with its Pallas cell
kernels in interpret mode."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax.numpy as jnp  # noqa: E402

from concept_tpu.forces.pm import (  # noqa: E402
    gravity_potential_slab as jax_potential,
)
from concept_tpu.p3msim import margin_cell_count as jax_margin_cells  # noqa: E402
from concept_tpu.p3msim import pm_gradient_cells as jax_pm_cells  # noqa: E402
from concept_tpu_torch.forces.pm import gravity_potential_slab  # noqa: E402
from concept_tpu_torch.grid.fft import irfft3, rfft3  # noqa: E402
from concept_tpu_torch.p3msim import margin_cell_count, pm_gradient_cells  # noqa: E402


def test_rfft3_layout_matches_jnp():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((16, 16, 16)).astype(np.float32)
    slab = rfft3(torch.as_tensor(g)).numpy()
    ref = np.asarray(jnp.fft.rfftn(jnp.asarray(g)))
    assert slab.shape == ref.shape == (16, 16, 9)
    np.testing.assert_allclose(slab, ref, rtol=1e-5, atol=1e-4)
    back = irfft3(torch.as_tensor(slab), 16).numpy()
    np.testing.assert_allclose(back, g, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("deconv,scale", [(0, None), (4, 0.3)])
def test_gravity_potential_slab_matches_jax(deconv, scale):
    rng = np.random.default_rng(1)
    n, box, G = 16, 5.0, 2.5
    slab = np.array(jnp.fft.rfftn(jnp.asarray(
        rng.standard_normal((n, n, n)).astype(np.float32))))
    got = gravity_potential_slab(torch.as_tensor(slab), n, box, G,
                                 deconv_order=deconv,
                                 longrange_scale=scale).numpy()
    ref = np.asarray(jax_potential(jnp.asarray(slab), n, box, G,
                                   deconv_order=deconv, longrange_scale=scale))
    assert got[0, 0, 0] == 0
    np.testing.assert_allclose(got, ref, rtol=2e-5,
                               atol=2e-5 * np.abs(ref).max())


def test_pm_gradient_cells_matches_jax():
    """8-mesh-cell layout at mesh 32 with one slot pushed out of its halo:
    the gradient at every slot and the deposited mass (which falls short
    by that slot's mass) agree."""
    n, box, mass, G = 32, 6.0, 0.8, 1.3
    nc = n // 8
    C, K = nc**3, 16
    rng = np.random.default_rng(4)
    counts = rng.integers(4, K + 1, size=C)
    valid = np.arange(K)[:, None] < counts[None, :]
    cw = box / nc
    cells = np.arange(C)
    base = np.stack([cells // (nc * nc), (cells // nc) % nc, cells % nc]) * cw
    pos = (base[:, None, :] + rng.random((3, K, C)) * cw).astype(np.float32)
    pos[0, 0, 5] = np.float32((base[0, 5] + cw + 1.7 * box / n) % box)
    pos = np.where(valid[None], pos, 0.0).astype(np.float32)
    scale = 1.25 * box / n
    fd, mass_sum = pm_gradient_cells(torch.as_tensor(pos),
                                     torch.as_tensor(valid), mass, G, scale,
                                     box, n, cb=8)
    fd_j, _, mass_j = jax_pm_cells(jnp.asarray(pos), jnp.asarray(valid), mass,
                                   G, scale, box, n, cb=8, interpret=True)
    fd, fd_j = fd.numpy(), np.asarray(fd_j)
    assert fd.shape == fd_j.shape == (3, K, C)
    np.testing.assert_allclose(fd, fd_j, rtol=2e-5, atol=2e-5 * np.abs(fd_j).max())
    expect = (valid.sum() - 1) * mass
    assert math.isclose(float(mass_sum), float(mass_j), rel_tol=1e-5)
    assert math.isclose(float(mass_sum), expect, rel_tol=1e-5)
    assert np.all(fd[:, 0, 5] == 0) and np.all(fd[:, ~valid] == 0)


@pytest.mark.parametrize("box,cutoff,frac,cap", [
    (256.0, 4.5 * 1.25 * 256 / 128, 0.1, 512),  # example_basic's split
    (10.0, 0.01, 0.0, 512),  # capped
    (1.0, 2.0, 0.5, 512),  # cutoff beyond the box: one cell
])
def test_margin_cell_count_matches_jax(box, cutoff, frac, cap):
    assert margin_cell_count(box, cutoff, frac, cap) == jax_margin_cells(
        box, cutoff, frac, cap)
