"""The sweep and cell kernels at nx = nc against another checkout's, on
the card: rows 1, 2, 5 and 6 (csrc/pair_sweep.cu) and rows 3, 4, 8 and 9
(csrc/cells.cu) on seeded inputs, in float and double.

    # each checkout's outputs (the package imported from --repo; its
    # kernels built into that checkout's _build_out/)
    python3 scripts/nx_parity.py --repo .parent --dump out/parent.pt
    python3 scripts/nx_parity.py --repo . --dump out/change.pt
    python3 scripts/nx_parity.py --repo . --dump out/change2.pt
    python3 scripts/nx_parity.py --compare out/parent.pt out/change.pt out/change2.pt

--compare prints, per output, whether the first two files agree bit for
bit and their largest |Δ| over the largest |value|, and the same between
the second and a third file (the same checkout run again: the deposits
add by atomics in no fixed order, so two runs of one checkout need not
agree bit for bit there).  Every call takes only the wrappers' signatures
that both checkouts share.
"""

from __future__ import annotations

import argparse
import os
import sys


def _inputs(torch, dtype, dev):
    """A random layout over 8³ cells: its positions, validity and
    occupancy, D = 3 random 64³ meshes, the box."""
    g = torch.Generator(device="cpu").manual_seed(11)
    n, K, box = 8, 32, 4.0
    C = n**3
    counts = torch.randint(0, K + 1, (C,), generator=g)
    valid = torch.arange(K)[:, None] < counts[None, :]
    cells = torch.arange(C)
    base = torch.stack([cells // (n * n), (cells // n) % n, cells % n]).double() * (box / n)
    pos = base[:, None, :] + torch.rand((3, K, C), generator=g, dtype=torch.float64) * (box / n)
    pos = pos.to(dtype)
    grids = torch.randn((3, 64, 64, 64), generator=g, dtype=torch.float64).to(dtype)
    to = dict(device=dev)
    return (pos.to(**to), valid.to(**to), counts.to(torch.int32).to(**to), grids.to(**to), box)


def dump(path: str):
    import torch

    from concept_tpu_torch.forces.cuda_shortrange import (
        pair_sweep, pair_sweep_reach, pair_sweep_subset,
    )
    from concept_tpu_torch.forces.shortrange import reach_offsets
    from concept_tpu_torch.grid.cuda_blocks import deposit_blocks, gather_blocks
    from concept_tpu_torch.grid.cuda_cells import deposit_cells, gather_cells

    dev = torch.device("cuda")
    out = {}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split(".")[1]
        pos, valid, occ, grids, box = _inputs(torch, dtype, dev)
        s = torch.where(valid[None], pos, 1e4 * box)
        args = (8, box, 0.06, 0.24**2, 0.02**2)
        out[f"row1_{tag}"] = pair_sweep(s[:, :16], s, *args, kernel="spline", rext=occ, sext=occ)
        out[f"row2_{tag}"] = pair_sweep_subset(s[:, :16], s, *args, kernel="plummer")
        out[f"row6_{tag}"] = pair_sweep(s, s, *args, kernel="none")
        recv = torch.where(valid[None], pos, -1e4 * box)
        out[f"row5_{tag}"] = pair_sweep_reach(recv, s, 8, box, 0.03, 0.135**2, 0.01**2,
                                              reach_offsets(box / 8, 0.1), kernel="spline")
        w = valid.to(dtype)
        out[f"row3_{tag}"] = deposit_cells(pos, w, 64, box, 8)
        out[f"row4_{tag}"] = gather_cells(pos, w, grids, 64, box, 8, ext=occ)
        # the same slots as 2-mesh-cell blocks of a 16³ mesh: z-major ids,
        # so the x-major cell's z runs along the block's x
        blocks = (pos[2].contiguous(), pos[1].contiguous(), pos[0].contiguous())
        out[f"row8_{tag}"] = deposit_blocks(*blocks, w, 16, box)
        out[f"row9_{tag}"] = gather_blocks(*blocks, w, grids[:, :16, :16, :16].contiguous(),
                                           16, box)
    torch.cuda.synchronize()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.cpu() for k, v in out.items()}, path)
    print(f"wrote {len(out)} outputs to {path}")


def compare(paths):
    import torch

    runs = [torch.load(p) for p in paths]
    for pair in ((0, 1), (1, 2))[:len(runs) - 1]:
        a, b = runs[pair[0]], runs[pair[1]]
        print(f"{paths[pair[0]]} vs {paths[pair[1]]}")
        for k in sorted(a):
            x, y = a[k].double(), b[k].double()
            rel = float((x - y).abs().max() / x.abs().max().clamp(min=1e-300))
            print(f"  {k:14s} bitwise {torch.equal(a[k], b[k])!s:5s} max|Δ|/max {rel:.3g}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=".", help="checkout whose package to import")
    ap.add_argument("--dump", help="write this checkout's outputs here")
    ap.add_argument("--compare", nargs="+", help="two or three dumps to compare")
    a = ap.parse_args()
    if a.compare:
        compare(a.compare)
        return
    sys.path.insert(0, os.path.abspath(a.repo))
    dump(a.dump)


if __name__ == "__main__":
    main()
