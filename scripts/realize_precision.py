"""Where a multi run's realization over ranks parts from one device's, in
float32 and in float64: each component of example_nonlinnu (80³ matter,
the ν fluid on grid 40) and example_relativistic (128³ matter, the
radiation on grid 128) realized on one device (the 3D transforms) and
over a world of one rank (the slab FFT: 1D transforms along each axis
and the transposes), at a_begin with the run's seed, both in each dtype.

For each component and dtype it prints the largest relative difference
of the power spectrum (measured alike on one device in float64, so that
only the realization differs) with the k and the mode count of its bin,
the largest |Δx| / box and |Δq| / max |q| of the particles, and |Δϱ| /
max |ϱ| and |ΔJ| / max |J| of a fluid.  If the float64 realizations
agree to ~1e-10, the float32 differences are the rounding of the two
transform paths.

    python3 scripts/realize_precision.py [--device cpu] [--small] [--out FILE]

``--small`` realizes 8³ (the ν on grid 8, the radiation on grid 16) for
the CPU.  One process, one card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def _spectrum(x, spec, cfg):
    """(k, modes, P) of a particle state or a fluid's δ, measured on one
    device in float64."""
    import torch

    from concept_tpu_torch.analysis.powerspec import grid_powerspec, powerspec

    if hasattr(x, "pos"):
        n = 2 * round(spec.N ** (1 / 3))
        out = powerspec(x.pos.to(torch.float64), n, cfg.boxsize, spec.N)
    else:
        rho = x.varrho.to(torch.float64)
        out = grid_powerspec(rho / rho.mean() - 1.0, cfg.boxsize)
    return np.stack([np.asarray(out["k"]), np.asarray(out["modes"]),
                     np.asarray(out["power"])], axis=1)


def _compare(one, rank, spec, cfg) -> dict:
    import torch

    P1, P2 = _spectrum(one, spec, cfg), _spectrum(rank, spec, cfg)
    good = P1[:, 2] > 0
    rel = np.abs(P2[good, 2] / P1[good, 2] - 1)
    i = int(np.argmax(rel))
    res = {"spectrum_max_rel": float(rel[i]), "bin_k": float(P1[good][i, 0]),
           "bin_modes": int(P1[good][i, 1])}
    if hasattr(one, "pos"):
        dx = (rank.pos - one.pos).double()
        dx -= cfg.boxsize * torch.round(dx / cfg.boxsize)
        res["pos_max_of_box"] = float(dx.abs().max()) / cfg.boxsize
        res["mom_max_of_max"] = float((rank.mom - one.mom).abs().max() / one.mom.abs().max())
    else:
        for f in ("varrho", "J"):
            a, b = getattr(one, f), getattr(rank, f)
            if a is not None:
                res[f"{f}_max_of_max"] = float((b - a).abs().max() / a.abs().max())
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    p.add_argument("--out", help="also write the JSON line to this file")
    a = p.parse_args(argv)

    import torch
    import torch.distributed as tdist

    import ranks_multi
    from concept_tpu_torch import sim_multi
    from concept_tpu_torch.device import resolve_device
    from concept_tpu_torch.grid.fft import GridDistribution
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.parallel.step import realize_shard
    from concept_tpu_torch.run import build_components, build_cosmology, make_multi

    results = {}
    if a.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()
        print("\n".join(smi))
        results["nvidia_smi"] = smi
    dev = resolve_device(a.device)
    tmp = tempfile.mkdtemp(prefix="realize_precision_")
    shutil.copy(ranks_multi.FIXTURE, os.path.join(tmp, "eb_41b37a4fde5ce466.npz"))
    tdist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                             store=tdist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
                             world_size=1)
    try:
        cases = ranks_multi._cases(["nonlinnu"], a.small, 1, 1, tmp, a.device)
        for name in ("nonlinnu", "relativistic"):
            param, overrides, _ = cases[name]
            cfg = load_params(param, overrides=overrides)
            units, consts, bg, lin = build_cosmology(cfg)
            comps = build_components(cfg, bg, consts)
            seed = int(cfg.random_seeds.get("primordial amplitudes", 0))
            rank = GridDistribution()
            sims = {tag: make_multi(cfg, comps, units, consts, bg, lin, dev, torch.float32,
                                    dist=dd) for tag, dd in (("one", None), ("rank", rank))}
            for dtype in (torch.float32, torch.float64):
                for cname, spec in {**sims["one"].pspecs, **sims["one"].fspecs}.items():
                    got = {}
                    for tag, sim in sims.items():
                        if spec.representation == "particles":
                            got[tag] = realize_shard(
                                lin, spec, cfg.boxsize, cfg.a_begin, sim.dist, seed=seed,
                                lpt_order=int(cfg.realization_options.get("lpt", 1)),
                                dtype=dtype, device=dev, scheme=cfg.primordial_noise_imprinting)
                        else:
                            got[tag] = sim_multi.realize_fluid_from_linear(
                                lin, spec, cfg.boxsize, cfg.a_begin,
                                sim.fluid_Omegas[cname] * sim.rho_crit, seed=seed, dtype=dtype,
                                device=dev, eos=sim.eos[cname], dist=sim.dist)
                    res = _compare(got["one"], got["rank"], spec, cfg)
                    key = f"{name} {cname} {str(dtype).split('.')[-1]}"
                    results[key] = res
                    print(f"{key}: {json.dumps(res)}", flush=True)
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    line = json.dumps(results)
    print(line)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
