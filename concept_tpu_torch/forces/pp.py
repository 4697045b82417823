"""Direct particle-particle (PP) gravity: exact pairwise forces with
Ewald periodic images, and the non-periodic variant (port of
concept_tpu/forces/pp.py; reference gravity.py:121 gravity_pairwise and
gravity.py:491 gravity_pairwise_nonperiodic).

All pairs, in chunks of receiver rows: PP is the reference's small-N
validation method, and the JAX package computes it in XLA, in no Pallas
kernel, so plain PyTorch is its counterpart.  The chunk holds its
(rows, N, 3) temporaries within about 2 GiB on the card (256 MiB on the
CPU); it changes only the order of summation.
"""

from __future__ import annotations


import torch

from concept_tpu_torch.forces.ewald import ewald_correction_lookup, tabulate_ewald_correction
from concept_tpu_torch.forces.shortrange import softened_r3inv

# (rows, N, 3)-sized temporaries alive at once (the Ewald lookup's)
_LIVE_TEMPORARIES = 12


def _rows(N: int, dtype, device) -> int:
    budget = 1 << (31 if device.type == "cuda" else 28)
    itemsize = torch.finfo(dtype).bits // 8
    return max(1, budget // (_LIVE_TEMPORARIES * 3 * max(1, N) * itemsize))


def pp_momentum_updates(pos, mass: float, boxsize: float, kick_integral: float, G: float,
                        softening: float = 0.0, ewald_table=None, periodic: bool = True,
                        softening_kernel: str = "plummer"):
    """Δmom (N, 3) of every particle from direct summation over all the
    others.  periodic=True: the minimum-image direct force plus the Ewald
    correction looked up in ``ewald_table`` (tabulated for the unit box,
    so divided by boxsize²); periodic=False: plain 1/r² (the reference's
    'ppnonperiodic').  softening_kernel: 'plummer' | 'spline' | 'none'
    (reference get_softened_r3inv, interactions.py:1846-1910)."""
    N = pos.shape[0]
    dtype = pos.dtype
    rows = _rows(N, dtype, pos.device)
    acc = torch.empty_like(pos)
    for i0 in range(0, N, rows):
        dx = pos[i0:i0 + rows, None, :] - pos[None, :, :]  # (rows, N, 3)
        if periodic:
            dx = dx - boxsize * torch.round(dx / boxsize)  # minimum image
        r2 = (dx * dx).sum(-1)
        mask = r2 > 0
        r3inv = softened_r3inv(r2, softening, softening_kernel)
        a = -(dx * torch.where(mask, r3inv, 0.0)[..., None]).sum(1)
        if periodic and ewald_table is not None:
            corr = ewald_correction_lookup(ewald_table, dx / boxsize)
            a = a + torch.where(mask[..., None], corr, 0.0).sum(1) / boxsize**2
        acc[i0:i0 + rows] = a
    return (G * mass * mass * kick_integral) * acc


def make_ewald_table(gridsize: int = 64, device="cpu"):
    """The Ewald correction table in float32, as the JAX package keeps it
    (concept_tpu/forces/pp.py), also in float64 runs."""
    return tabulate_ewald_correction(gridsize, device).to(torch.float32)
