"""The float32 sweeps at softening 0 against their plain version, run to
run, on the card: rows 6 and 2 (and row 6 with the 'spline' kernel) on
the final slots of chip_smoke.py's CDM + baryon run (param/example_basic.py
with n³ cold dark matter and n³ baryons, P³M grid 2n, to a = 1),
repeated --runs times, each run's final state its own (the deposits add
by atomics in no fixed order).

For each run and sweep it prints one JSON line with chip_smoke.py's
per-receiver measure (`_max_rel_recv`) between: the kernel and its plain
version, two calls of the kernel, two calls of the plain version, each
against the float64 plain version; and, at the receiver where kernel
and plain differ most, its force, the median force, Σ_j |f_ij| (the
sum's scale) and their ratio, the cancellation κ.

    python3 scripts/sweep_plain_spread.py --runs 8 --out out/spread.json
    python3 scripts/sweep_plain_spread.py --device cpu --n 12 --runs 1
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def abs_sum(recv, sup, n, boxsize, scale, cutoff2, soft2, kernel):
    """Per receiver Σ_j |f_ij d_ij| over the ±1 columns, in float64."""
    import torch

    from concept_tpu_torch.forces.cuda_shortrange import (
        OFFSETS_27, SENTINEL, shortrange_force_factor,
    )

    recv, sup = recv.double(), sup.double()
    dev = recv.device
    far = 0.5 * SENTINEL * boxsize
    K_r, C = recv.shape[1:]
    out = torch.zeros((K_r, C), dtype=torch.float64, device=dev)
    r_row, r_col = torch.nonzero(recv[0].abs() < far, as_tuple=True)
    s_col, s_row = torch.nonzero((sup[0].abs() < far).T, as_tuple=True)
    s_pos = sup[:, s_row, s_col]
    counts = torch.bincount(s_col, minlength=C)
    starts = torch.cumsum(counts, 0) - counts
    offs = torch.as_tensor(OFFSETS_27, device=dev)
    n_off = offs.shape[0]
    cc = (r_col // (n * n), (r_col // n) % n, r_col % n)
    nb = [c[:, None] + offs[None, :, d] for d, c in enumerate(cc)]
    nb_col = ((torch.remainder(nb[0], n) * n + torch.remainder(nb[1], n)) * n
              + torch.remainder(nb[2], n))
    shift = torch.stack([((m >= n).double() - (m < 0).double()) * boxsize for m in nb])
    chunk = 20000
    for i0 in range(0, r_row.numel(), chunk):
        i1 = min(i0 + chunk, r_row.numel())
        cnt = counts[nb_col[i0:i1]].reshape(-1)
        grp = torch.repeat_interleave(torch.arange(cnt.numel(), device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        sidx = (starts[nb_col[i0:i1].reshape(-1)][grp]
                + torch.arange(grp.numel(), device=dev) - first[grp])
        ri = i0 + torch.div(grp, n_off, rounding_mode="floor")
        d = (recv[:, r_row[ri], r_col[ri]]
             - (s_pos[:, sidx] + shift.reshape(3, -1)[:, i0 * n_off + grp]))
        r2 = (d * d).sum(0)
        m = (r2 < cutoff2) & (r2 > 0)
        f = torch.where(m, shortrange_force_factor(r2, scale, soft2, kernel), 0.0)
        acc = torch.zeros(i1 - i0, dtype=torch.float64, device=dev)
        acc.index_add_(0, ri - i0, (f[None] * d).norm(dim=0))
        out[r_row[i0:i1], r_col[i0:i1]] = acc
    return out


def measure(got, ref):
    """chip_smoke.py's per-receiver measure, the receiver where it peaks
    and the median force."""
    d = (got - ref).double().norm(dim=0)
    r = ref.double().norm(dim=0)
    med = float(r[r > 0].median())
    q = d / r.clamp(min=med)
    return float(q.max()), int(q.argmax()), med


def one_run(k: int, n: int, device: str) -> dict:
    import chip_smoke as cs
    from concept_tpu_torch.forces.cuda_shortrange import (
        pair_sweep, pair_sweep_plain, pair_sweep_subset,
    )
    from concept_tpu_torch.forces.shortrange import dtype_square

    outdir = tempfile.mkdtemp(prefix="sweep_plain_spread_")
    t0 = time.time()
    try:
        sim, state, *_ = cs._multi_run(
            cs.PARAM, [f"initial_conditions=[{{'species':'cold dark matter','N':{n}**3}},"
                       f"{{'species':'baryon','N':{n}**3}}]", f"potential_options={2 * n}",
                       cs.ALL_PAIRS], outdir, cs.PAIR_ROWS, device)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    g = cs._sweep_geometry(sim)
    cdm = cs._component_slots(sim, state.particles["cold dark matter"].pos)
    bar = cs._component_slots(sim, state.particles["baryon"].pos)
    row = {"run": k, "K": [cdm.shape[1], bar.shape[1]], "run_s": time.time() - t0}
    for key, kernel, sup in (("row6", "plummer", cdm), ("row2", "plummer", bar),
                             ("row6_spline", "spline", cdm)):
        args = (g.nc, g.boxsize, g.scale, dtype_square(g.cutoff, cdm.dtype),
                dtype_square(g.softening, cdm.dtype), kernel)
        fn = pair_sweep_subset if key == "row2" else pair_sweep
        got, got2 = fn(cdm, sup, *args), fn(cdm, sup, *args)
        ref, ref2 = pair_sweep_plain(cdm, sup, *args), pair_sweep_plain(cdm, sup, *args)
        r64 = pair_sweep_plain(cdm.double(), sup.double(), *args)
        scale = abs_sum(cdm, sup, *args).reshape(-1)
        kp, i, med = measure(got, ref)
        force = float(r64.norm(dim=0).reshape(-1)[i])
        row[key] = {
            "kern_vs_plain": kp, "kern_vs_kern": measure(got, got2)[0],
            "plain_vs_plain": measure(ref, ref2)[0], "kern_vs_f64": measure(got, r64)[0],
            "plain_vs_f64": measure(ref, r64)[0],
            "worst": {"force": force, "median": med, "abs_sum": float(scale[i]),
                      "kappa": float(scale[i]) / max(force, med)},
        }
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=8)
    p.add_argument("--n", type=int, default=64, help="particles a side of each component")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", help="also write the lines to this JSON file")
    a = p.parse_args(argv)
    rows = []
    for k in range(a.runs):
        rows.append(one_run(k, a.n, a.device))
        print(json.dumps(rows[-1]), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
