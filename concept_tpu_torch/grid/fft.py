"""3D real FFTs on ``torch.fft`` (cuFFT on the card), on one device or
as a slab FFT over the ranks of a ``torch.distributed`` process group
(port of concept_tpu/grid/fft.py; reference src/fft.c:105-290,
mesh.py:3769-4181).

Layouts match ``jnp.fft.rfftn``: a real (n, n, n) grid ↔ a complex
(n, n, n//2+1) slab with the last axis halved.  Over d ranks
(:class:`GridDistribution`) each rank holds n/d of the rows, as the
reference and the JAX package lay them out (fft.c:34-73):

  real    : x-slab (n/d, n, n),         rows [r·n/d, (r+1)·n/d) of x
  fourier : y-slab (n, n/d, n//2+1),    rows [r·n/d, (r+1)·n/d) of y

and the x↔y transpose is one ``all_to_all_single``.  The 2D pencil
decomposition (``-n AxB``) is ROADMAP Queue 1 item 14b.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as tdist


@dataclass(frozen=True)
class GridDistribution:
    """The 1D slab decomposition over the ranks of a process group
    (``group`` None: the default group): grids are split along x in real
    space and along y in Fourier space, particles by index (N/d a rank,
    the JAX package's P('x', None)).  ``n_devices`` is the world size."""

    group: object = None

    @property
    def n_devices(self) -> int:
        return tdist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return tdist.get_rank(self.group)

    def slab(self, n: int, rank: int | None = None) -> tuple[int, int]:
        """(first row, rows) of a rank's slab of an n-row axis."""
        d = self.n_devices
        if n % d:
            raise ValueError(f"gridsize {n} is not divisible by the {d} ranks")
        rows = n // d
        return (self.rank if rank is None else rank) * rows, rows

    def shard(self, N: int) -> tuple[int, int]:
        """[lo, hi) of this rank's particle indices."""
        d = self.n_devices
        if N % d:
            raise ValueError(f"{N} particles do not split evenly over the {d} ranks")
        return self.rank * (N // d), (self.rank + 1) * (N // d)

    def split(self, N: int, rank: int | None = None) -> tuple[int, int]:
        """[lo, hi) of a rank's indices of N, which need not split evenly:
        rank r takes [⌊r·N/d⌋, ⌊(r+1)·N/d⌋), :meth:`shard` wherever that
        applies (the rung stepper's flat states over ranks)."""
        d, r = self.n_devices, self.rank if rank is None else rank
        return r * N // d, (r + 1) * N // d


def check_distribution(dist):
    """None (one device) or a :class:`GridDistribution`; any other kind
    of distribution (the 2D pencils of ``-n AxB``) raises."""
    if dist is not None and not isinstance(dist, GridDistribution):
        raise NotImplementedError(
            f"{type(dist).__name__}: the 2D pencil decomposition (-n AxB) is "
            "ROADMAP Queue 1 item 14b")
    return dist


def all_to_all(x: torch.Tensor, dist: GridDistribution) -> torch.Tensor:
    """Equal-split ``all_to_all_single`` along dim 0 (complex tensors as
    their real views)."""
    src = (torch.view_as_real(x) if x.is_complex() else x).contiguous()
    out = torch.empty_like(src)
    tdist.all_to_all_single(out, src, group=dist.group)
    return torch.view_as_complex(out) if x.is_complex() else out


def rfft3(grid: torch.Tensor, dist: GridDistribution | None = None) -> torch.Tensor:
    """Forward real 3D FFT: (n, n, n) → (n, n, n//2+1), unnormalised.
    With ``dist`` an x-slab (n/d, n, n) → its y-slab (n, n/d, n//2+1):
    rfft along z, fft along y, the transpose, fft along x."""
    if check_distribution(dist) is None:
        return torch.fft.rfftn(grid, dim=(-3, -2, -1))
    d = dist.n_devices
    rows, n = grid.shape[0], grid.shape[1]
    f = torch.fft.fft(torch.fft.rfft(grid, dim=2), dim=1)
    nk = f.shape[2]
    # split y into d blocks, block j to rank j; the blocks received stack
    # along x in rank order
    f = all_to_all(f.reshape(rows, d, n // d, nk).transpose(0, 1), dist)
    return torch.fft.fft(f.reshape(n, n // d, nk), dim=0)


def irfft3(slab: torch.Tensor, gridsize: int,
           dist: GridDistribution | None = None) -> torch.Tensor:
    """Inverse of :func:`rfft3` (normalised like jnp.fft.irfftn).  On one
    device a leading batch axis is transformed slab by slab."""
    n = gridsize
    if check_distribution(dist) is None:
        return torch.fft.irfftn(slab, s=(n, n, n), dim=(-3, -2, -1))
    d = dist.n_devices
    cols, nk = slab.shape[1], slab.shape[2]
    f = torch.fft.ifft(slab, dim=0)
    # split x into d blocks, block j to rank j; the blocks received stack
    # along y in rank order
    f = all_to_all(f.reshape(d, n // d, cols, nk), dist)
    f = f.transpose(0, 1).reshape(n // d, n, nk)
    return torch.fft.irfft(torch.fft.ifft(f, dim=1), n=n, dim=2)
