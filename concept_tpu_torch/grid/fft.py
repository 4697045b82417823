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

and the x↔y transpose is one ``all_to_all_single``.  A grid whose n the
ranks do not divide (the realization's lattice grid, ic.py) splits both
axes by :func:`row_starts`, rank r taking rows [⌊r·n/d + ½⌋, ⌊(r+1)·n/d
+ ½⌋) (:meth:`GridDistribution.rows`; a rank may hold none), so the
transposes take split sizes; where d divides n they are the even ones.
The PM's mesh keeps the even rule (:meth:`GridDistribution.slab` raises
otherwise).  :func:`exchange`, which sends each row of a tensor to the
rank its destination names, is the one collective under both the
transposes and the moves of grid rows and particles (grid/fourier.py,
ic.py, parallel/step.py).

The 2D pencil decomposition of ``-n AxB`` (:class:`GridDistribution2D`)
splits the ranks into an A × B mesh, rank r at (a, b) = (r // B, r % B),
and grids over both (the JAX package's ``GridDistribution2D``,
concept_tpu/grid/fft.py:61-146):

  real    : z-pencil (n/A, n/B, n),       x rows [a·n/A, …), y rows [b·n/B, …)
  fourier : (n, n/A, nkp/B),              ky rows [a·n/A, …), kz columns
                                          [b·nkp/B, …)

with nkp = ⌈(n/2+1)/B⌉·B; the columns past n/2 are zero.  Its transforms
take two ``all_to_all_single`` transposes, one within the B ranks that
share a (split z, concat y), one within the A ranks that share b (split
y, concat x).  Particles split by index over all A·B ranks, as over the
1D decomposition of d = A·B ranks (:attr:`GridDistribution2D.flat`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as tdist


def row_starts(n: int, d: int) -> list:
    """The first row of each of d ranks' rows of an n-row axis, and n:
    rank r takes rows [⌊r·n/d + ½⌋, ⌊(r+1)·n/d + ½⌋), n/d each where d
    divides n."""
    return [(2 * r * n + d) // (2 * d) for r in range(d)] + [n]


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

    def rows(self, n: int, rank: int | None = None) -> tuple[int, int]:
        """(first row, rows) of a rank's rows of an n-row axis split by
        :func:`row_starts`: :meth:`slab` wherever d divides n."""
        starts = row_starts(n, self.n_devices)
        r = self.rank if rank is None else rank
        return starts[r], starts[r + 1] - starts[r]

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


@dataclass(frozen=True)
class GridDistribution2D:
    """The 2D pencil decomposition over an A × B mesh of ranks (``-n
    AxB``; module docstring): this rank's place (a, b), the process groups
    of the B ranks that share its a (``group_b``) and of the A ranks that
    share its b (``group_a``), and ``flat``, the 1D distribution over all
    A·B ranks, over which particles split by index.  Made by
    :func:`make_pencils`."""

    na: int
    nb: int
    a: int
    b: int
    group_a: object
    group_b: object
    flat: GridDistribution

    @property
    def n_devices(self) -> int:
        return self.na * self.nb

    @property
    def rank(self) -> int:
        return self.flat.rank

    def check(self, n: int):
        """ValueError unless A and B divide n (the tiled transposes)."""
        for what, p in (("A", self.na), ("B", self.nb)):
            if n % p:
                raise ValueError(f"gridsize {n} is not divisible by {what} = {p} of the "
                                 f"{self.na}x{self.nb} pencils")

    def nk_pad(self, n: int) -> int:
        """nkp: n/2+1 rounded up to a multiple of B."""
        return -(-(n // 2 + 1) // self.nb) * self.nb

    def x_rows(self, n: int) -> tuple[int, int]:
        """(first row, rows) of this rank's x rows of a real pencil, and of
        its ky rows of a Fourier pencil."""
        return self.a * (n // self.na), n // self.na

    def y_rows(self, n: int) -> tuple[int, int]:
        """(first row, rows) of this rank's y rows of a real pencil."""
        return self.b * (n // self.nb), n // self.nb

    def z_cols(self, n: int) -> tuple[int, int]:
        """(first column, columns) of this rank's kz columns of a Fourier
        pencil, padded ones included."""
        c = self.nk_pad(n) // self.nb
        return self.b * c, c


def make_pencils(na: int, nb: int) -> GridDistribution2D | None:
    """The pencils of an na × nb mesh over the first na·nb ranks of the
    default group, made by every rank of it (``new_group`` is collective:
    the other ranks take part and get None).  Every rank creates the na
    B-groups, the nb A-groups and, unless the mesh is the whole world,
    the flat group, in that order."""
    world = tdist.get_world_size()
    if na < 1 or nb < 1 or na * nb > world:
        raise ValueError(f"{na}x{nb} pencils need {na * nb} of the {world} ranks")
    r = tdist.get_rank()
    groups_b = [tdist.new_group([a * nb + b for b in range(nb)]) for a in range(na)]
    groups_a = [tdist.new_group([a * nb + b for a in range(na)]) for b in range(nb)]
    flat = None if na * nb == world else tdist.new_group(list(range(na * nb)))
    if r >= na * nb:
        return None
    a, b = divmod(r, nb)
    return GridDistribution2D(na, nb, a, b, groups_a[b], groups_b[a], GridDistribution(flat))


def check_distribution(dist):
    """None (one device), a :class:`GridDistribution` or a
    :class:`GridDistribution2D`; anything else raises TypeError."""
    if dist is not None and not isinstance(dist, (GridDistribution, GridDistribution2D)):
        raise TypeError(f"{type(dist).__name__} is no grid distribution")
    return dist


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of equal blocks along dim 0 within ``group``,
    complex tensors as their real views."""
    v = (torch.view_as_real(x) if x.is_complex() else x).contiguous()
    out = torch.empty_like(v)
    tdist.all_to_all_single(out, v, group=group)
    return torch.view_as_complex(out) if x.is_complex() else out


def _rfft3_pencil(grid: torch.Tensor, dist: GridDistribution2D) -> torch.Tensor:
    """A real z-pencil (n/A, n/B, n) → its Fourier pencil (n, n/A, nkp/B):
    the rfft along z, padded to nkp; within the B-group split z and
    concat y, the fft along y; within the A-group split y and concat x,
    the fft along x."""
    na, nb = dist.na, dist.nb
    rx, ry, n = grid.shape
    nk, nkp = n // 2 + 1, dist.nk_pad(n)
    f = torch.fft.rfft(grid, dim=2)
    f = torch.nn.functional.pad(torch.view_as_real(f), (0, 0, 0, nkp - nk))
    f = torch.view_as_complex(f.contiguous())
    c = nkp // nb
    # block j: kz columns [j·c, (j+1)·c), sent to b = j; received block j:
    # y rows of b = j
    f = _a2a(f.reshape(rx, ry, nb, c).permute(2, 0, 1, 3), dist.group_b)
    f = torch.fft.fft(f.permute(1, 0, 2, 3).reshape(rx, n, c), dim=1)
    # block i: ky rows [i·n/A, …), sent to a = i; received block i: x rows
    # of a = i
    f = _a2a(f.reshape(rx, na, n // na, c).permute(1, 0, 2, 3), dist.group_a)
    return torch.fft.fft(f.reshape(n, n // na, c), dim=0)


def _irfft3_pencil(slab: torch.Tensor, n: int, dist: GridDistribution2D) -> torch.Tensor:
    """Inverse of :func:`_rfft3_pencil`: the ifft along x; within the
    A-group split x and concat ky; the ifft along y; within the B-group
    split y and concat kz; the c2r along z (:func:`_irfft_z`)."""
    na, nb = dist.na, dist.nb
    ry, c = slab.shape[1], slab.shape[2]
    rx = n // na
    f = _a2a(torch.fft.ifft(slab, dim=0).reshape(na, rx, ry, c), dist.group_a)
    f = torch.fft.ifft(f.permute(1, 0, 2, 3).reshape(rx, n, c), dim=1)
    f = _a2a(f.reshape(rx, nb, n // nb, c).permute(1, 0, 2, 3), dist.group_b)
    f = f.permute(1, 2, 0, 3).reshape(rx, n // nb, nb * c)
    return _irfft_z(f[..., :n // 2 + 1].contiguous(), n)


def _a2a_rows(src: torch.Tensor, send: list, recv: list, dist: GridDistribution):
    """``all_to_all_single`` of the rows (dim 0) of src, ``send[j]`` rows to
    rank j, ``recv[i]`` rows from rank i, complex tensors as their real
    views."""
    x = (torch.view_as_real(src) if src.is_complex() else src).contiguous()
    out = x.new_empty((sum(recv), *x.shape[1:]))
    tdist.all_to_all_single(out, x, output_split_sizes=recv, input_split_sizes=send,
                            group=dist.group)
    return torch.view_as_complex(out) if src.is_complex() else out


def exchange(rows: list, dest, dist: GridDistribution) -> list:
    """Send row i of each tensor in ``rows`` to rank ``dest[i]``: the
    rows received, stacked by source rank, each source's rows in its own
    order (a stable sort by destination)."""
    d = dist.n_devices
    order = torch.argsort(dest, stable=True)
    send = torch.bincount(dest, minlength=d)
    recv = torch.empty_like(send)
    tdist.all_to_all_single(recv, send, group=dist.group)
    send_l, recv_l = send.tolist(), recv.tolist()
    return [_a2a_rows(x[order], send_l, recv_l, dist) for x in rows]


def rfft3(grid: torch.Tensor, dist: GridDistribution | None = None) -> torch.Tensor:
    """Forward real 3D FFT: (n, n, n) → (n, n, n//2+1), unnormalised.
    With ``dist`` an x-slab (rows, n, n) → its y-slab (n, cols, n//2+1):
    rfft along z, fft along y, the transpose, fft along x; with pencils
    (:class:`GridDistribution2D`) a z-pencil → its Fourier pencil."""
    if check_distribution(dist) is None:
        return torch.fft.rfftn(grid, dim=(-3, -2, -1))
    if isinstance(dist, GridDistribution2D):
        return _rfft3_pencil(grid, dist)
    rows, n = grid.shape[0], grid.shape[1]
    nk = n // 2 + 1
    sizes = [dist.rows(n, r)[1] for r in range(dist.n_devices)]
    cols = sizes[dist.rank]
    # rank j's y-rows of every x-row go to rank j, which stacks what it
    # receives along x in rank order
    if rows:
        f = torch.fft.fft(torch.fft.rfft(grid, dim=2), dim=1)
        f = torch.cat([b.reshape(-1, nk) for b in torch.split(f, sizes, dim=1)])
    else:
        f = grid.new_empty((0, nk), dtype=_complex(grid.dtype))
    f = _a2a_rows(f, [rows * c for c in sizes], [x * cols for x in sizes], dist)
    f = f.reshape(n, cols, nk)
    return torch.fft.fft(f, dim=0) if cols else f


def irfft3(slab: torch.Tensor, gridsize: int,
           dist: GridDistribution | None = None) -> torch.Tensor:
    """Inverse of :func:`rfft3`, normalised by 1/n³ (numpy's convention);
    with ``dist`` a y-slab → its x-slab (a Fourier pencil → its
    z-pencil), the steps of :func:`rfft3` reversed."""
    n = gridsize
    if check_distribution(dist) is None:
        return torch.fft.irfftn(slab, s=(n, n, n), dim=(-3, -2, -1))
    if isinstance(dist, GridDistribution2D):
        return _irfft3_pencil(slab, n, dist)
    cols, nk = slab.shape[1], slab.shape[2]
    sizes = [dist.rows(n, r)[1] for r in range(dist.n_devices)]
    rows = sizes[dist.rank]
    # rank j's x-rows of every y-row go to rank j, which stacks what it
    # receives along y in rank order
    f = torch.fft.ifft(slab, dim=0) if cols else slab
    recv = [rows * c for c in sizes]
    f = _a2a_rows(f.reshape(n * cols, nk), [x * cols for x in sizes], recv, dist)
    f = torch.cat([b.reshape(rows, c, nk) for b, c in zip(torch.split(f, recv), sizes)], dim=1)
    if not rows:
        return slab.real.new_empty((0, n, n))
    return _irfft_z(torch.fft.ifft(f, dim=1), n)


def _irfft_z(f: torch.Tensor, n: int) -> torch.Tensor:
    """The c2r along the last axis of f (consumed) with numpy's meaning:
    the imaginary parts of bins 0 and n/2, which a real signal's
    transform cannot have, are dropped first.  The slab FFT's last step,
    after the x- and y-transforms, where those bins hold what the kk = 0
    and n/2 planes are not Hermitian in (the LPT grids' i·k·δ on a
    Nyquist row).  numpy, the CPU's c2r and cuFFT's 3D c2r never read
    them (on the CPU the result is the same bit for bit); cuFFT's float
    1D c2r does at some lengths (scripts/c2r_probe.py)."""
    f[..., 0].imag.zero_()
    if n % 2 == 0:
        f[..., n // 2].imag.zero_()
    return torch.fft.irfft(f, n=n, dim=-1)


def _complex(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64
