"""Time variants of the PM-only block kernels (PERF.md rows 10 and 11) on
one NVIDIA card.

    python3 scripts/pm_block_variants.py [--N 256**3] [--mesh 256]
        [--clustered] [--out variants.json]

Builds scripts/pm_block_variants.cu (csrc/pm_blocks.cu's kernels as
built, beside other tile shapes, the alternatives their design was chosen
over, and splits that leave one part of the work out) with nvcc for
sm_90a, then times every deposit variant and every gather variant at
D = 3 and D = 1 on a realized N-particle state sorted by block on PM grid
`mesh` (example_basic's cosmology), and with --clustered also on PM-only
example_basic's final state at a = 1.  Each variant is timed twice in
turn (CUDA events, 20 launches after a warm-up); the complete ones are
held against the plain versions (rtol 2e-5, atol 1e-5·max|ref|).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _build():
    from concept_tpu_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(_build.BUILD_DIR, "pm_block_variants.so")
    src = os.path.join(ROOT, "scripts", "pm_block_variants.cu")
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
    lib = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.deposit_variant_run.argtypes = [I] + [P] * 7 + [I, I, P, P]
    lib.gather_variant_run.argtypes = [I] + [P] * 6 + [I, I, P, I, P, P]
    for kind in ("deposit", "gather"):
        getattr(lib, f"{kind}_variant_name").restype = ctypes.c_char_p
    return lib


def _names(lib, kind: str) -> list[str]:
    return [getattr(lib, f"{kind}_variant_name")(v).decode()
            for v in range(getattr(lib, f"{kind}_variants")())]


def _time_variants(lib, sb, n: int, tag: str) -> dict:
    import torch

    import chip_smoke as cs
    from concept_tpu_torch.grid.cuda_pm import deposit_pm_plain, gather_pm_plain

    N = sb["lidx"].shape[0]
    parts = [sb[k] for k in ("lidx", "fx", "fy", "fz")]
    blocks = [sb["starts"], sb["counts"]]
    ptrs = [t.data_ptr() for t in parts]
    bptrs = [t.data_ptr() for t in blocks]
    stream = torch.cuda.current_stream().cuda_stream
    q = torch.ones(N, device="cuda")

    def close(got, ref):
        return bool(torch.allclose(got, ref, rtol=2e-5, atol=1e-5 * float(ref.abs().max())))

    def deposit(v):
        grid = torch.zeros((n, n, n), device="cuda")
        err = lib.deposit_variant_run(v, *ptrs, q.data_ptr(), *bptrs, N, n // 2,
                                      grid.data_ptr(), stream)
        if err:
            raise RuntimeError(f"deposit variant {v}: cudaError_t {err}")
        return grid

    def gather(v, grids):
        out = torch.empty((grids.shape[0], N), device="cuda")
        err = lib.gather_variant_run(v, *ptrs, *bptrs, N, n // 2, grids.data_ptr(),
                                     grids.shape[0], out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"gather variant {v}: cudaError_t {err}")
        return out

    grids3 = torch.randn((3, n, n, n), device="cuda")
    cases = [("deposit", _names(lib, "deposit"), deposit,
              deposit_pm_plain(*parts, q, *blocks, n))]
    for D in (3, 1):
        g = grids3[:D].contiguous()
        cases.append((f"gather D = {D}", _names(lib, "gather"),
                      lambda v, g=g: gather(v, g), gather_pm_plain(*parts, *blocks, g, n)))
    res = {}
    print(f"{tag}: {N} particles, mesh {n}, deepest block {int(sb['counts'].max())}")
    for kind, names, run, ref in cases:
        for v, name in enumerate(names):
            got = run(v)
            torch.cuda.synchronize()
            if not name.startswith("split") and not close(got, ref):
                raise SystemExit(f"{kind} variant {name!r} disagrees with the plain version")
        times = {name: [] for name in names}
        for _ in range(2):
            for v, name in enumerate(names):
                times[name].append(cs._time_ms(lambda v=v: run(v), 20))
        for name, ms in times.items():
            print(f"  {kind:12s} {name:36s} " + " ".join(f"{t:.4f}" for t in ms) + " ms")
        res[kind] = times
    return res


def _count(text: str) -> int:
    """A particle count given as "n" or "n**3"."""
    base, _, exp = text.partition("**")
    return int(base) ** int(exp or 1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--N", default="256**3")
    p.add_argument("--mesh", type=int, default=256)
    p.add_argument("--clustered", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from concept_tpu_torch.grid.bucketed import sort_blocks

    print(cs._nvidia_smi())
    lib = _build()
    torch.manual_seed(0)
    sim, flat = cs._global_sim(_count(args.N), args.mesh, "cuda")
    sb = sort_blocks(flat.pos, args.mesh, sim.config.boxsize)
    out = {"card": cs._nvidia_smi(), "realized": _time_variants(
        lib, sb, args.mesh, f"realized {args.N}, grid {args.mesh}")}
    del sim, flat, sb
    if args.clustered:
        outdir = tempfile.mkdtemp(prefix="pm_variants_")
        try:
            sim, state, _, _, _ = cs._run([cs.PM_ONLY], outdir, cs.PM_KERNELS)
        finally:
            shutil.rmtree(outdir, ignore_errors=True)
        n = sim.config.potential_gridsize
        sb = sort_blocks(state.pos, n, sim.config.boxsize)
        out["clustered"] = _time_variants(lib, sb, n, "PM-only example_basic at a = 1")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
