"""The port's Fourier-space helpers (concept_tpu_torch.grid.fourier) vs
the JAX package's (concept_tpu/grid/fourier.py), and the fourier cases of
tests/test_grid.py on the port.

Tolerances: integer wavenumbers and mode masks are equal; float factors
and copied modes agree to rtol 1e-6 (float32, the same operations in
the same order); the physical checks keep tests/test_grid.py's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

import jax.numpy as jnp  # noqa: E402

from concept_tpu.grid import fourier as jf  # noqa: E402
from concept_tpu_torch.grid import fourier  # noqa: E402
from concept_tpu_torch.grid.fft import irfft3, rfft3  # noqa: E402


def _slab(n, seed=0):
    g = np.random.default_rng(seed).standard_normal((n, n, n)).astype(np.float32)
    return np.fft.rfftn(g).astype(np.complex64)


@pytest.mark.parametrize("n", [8, 10, 16])
def test_integer_and_physical_wavenumbers_match_jax(n):
    np.testing.assert_array_equal(fourier.k_int_1d(n).numpy(), np.asarray(jf.k_int_1d(n)))
    np.testing.assert_allclose(fourier.laplacian_inverse_factor(n, 3.0).numpy(),
                               np.asarray(jf.laplacian_inverse_factor(n, 3.0)), rtol=1e-6)
    for d in range(3):
        np.testing.assert_allclose(fourier.k_physical(n, 3.0, d).numpy(),
                                   np.asarray(jf.k_physical(n, 3.0, d)), rtol=1e-6)


@pytest.mark.parametrize("n", [8, 16])
def test_nullify_match_jax(n):
    slab = _slab(n, 1)
    t = torch.as_tensor(slab)
    got = fourier.nullify_origin(t)
    assert t[0, 0, 0] != 0  # the input is left as it was
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf.nullify_origin(jnp.asarray(slab))))
    np.testing.assert_array_equal(fourier.nullify_nyquist(t, n).numpy(),
                                  np.asarray(jf.nullify_nyquist(jnp.asarray(slab), n)))
    for k2 in (0, 5, n * n // 4):
        np.testing.assert_array_equal(
            fourier.nullify_beyond_sphere(t, n, k2).numpy(),
            np.asarray(jf.nullify_beyond_sphere(jnp.asarray(slab), n, k2)))


@pytest.mark.parametrize("n1,n2", [(16, 24), (24, 16), (8, 32), (16, 16)])
@pytest.mark.parametrize("norm,centred", [(True, True), (False, False)])
def test_copy_modes_matches_jax(n1, n2, norm, centred):
    slab = _slab(n1, 2)
    got = fourier.copy_modes(torch.as_tensor(slab), n1, n2, norm, centred).numpy()
    ref = np.asarray(jf.copy_modes(jnp.asarray(slab), n1, n2, norm, centred))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_check_hermitian_matches_jax():
    slab = _slab(16, 9)
    bad = slab.copy()
    bad[3, 5, 0] += 1.0
    for s in (slab, bad):
        got = fourier.check_hermitian(torch.as_tensor(s), 16)
        assert got == pytest.approx(float(jf.check_hermitian(jnp.asarray(s), 16)), rel=1e-6)
    assert fourier.check_hermitian(torch.as_tensor(slab), 16) < 1e-4
    assert fourier.check_hermitian(torch.as_tensor(bad), 16) > 0.4


def test_laplacian_inverse():
    # ∇²φ = ρ with ρ a single mode → φ = −ρ/k² (tests/test_grid.py)
    n, box = 32, 2.0
    kx = 2 * np.pi / box * 3
    x = (np.arange(n) + 0.5) * box / n
    rho = np.cos(kx * x)[:, None, None] * np.ones((1, n, n))
    slab = rfft3(torch.as_tensor(rho, dtype=torch.float32))
    phi = irfft3(slab * (-fourier.laplacian_inverse_factor(n, box)), n)
    np.testing.assert_allclose(phi.numpy(), -rho / kx**2, atol=1e-4)


def test_fourier_diff():
    n, box = 32, 2.0
    kx = 2 * np.pi / box * 2
    x = (np.arange(n) + 0.5) * box / n
    f = np.sin(kx * x)[:, None, None] * np.ones((1, n, n))
    slab = rfft3(torch.as_tensor(f, dtype=torch.float32))
    df = irfft3(fourier.fourier_diff(slab, n, box, 0), n)
    expected = kx * np.cos(kx * x)[:, None, None] * np.ones((1, n, n))
    np.testing.assert_allclose(df.numpy(), expected, atol=1e-3)


def test_copy_modes_upscale_preserves_field():
    # a smooth field upscaled in k-space reproduces the same physical
    # field sampled on the finer grid
    n1, n2, box = 16, 32, 1.0
    kx = 2 * np.pi / box
    x1 = (np.arange(n1) + 0.5) * box / n1
    x2 = (np.arange(n2) + 0.5) * box / n2
    f1 = np.cos(kx * x1)[:, None, None] * np.ones((1, n1, n1))
    f2 = np.cos(kx * x2)[:, None, None] * np.ones((1, n2, n2))
    slab2 = fourier.copy_modes(rfft3(torch.as_tensor(f1, dtype=torch.float32)), n1, n2)
    np.testing.assert_allclose(irfft3(slab2, n2).numpy(), f2, atol=1e-4)


def test_hermitian_multiplicity_counts_all_modes():
    n = 8
    w = fourier.hermitian_multiplicity(n)
    assert float(w.expand(n, n, n // 2 + 1).sum()) == n**3
