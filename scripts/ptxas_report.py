"""What ptxas makes of the port's CUDA sources: registers, spills, stack
and shared memory of every kernel instantiation.

    python3 scripts/ptxas_report.py [--csrc DIR ...] [--out FILE.json]

Compiles every ``*.cu`` of each DIR (default: concept_tpu_torch/csrc)
with the flags of concept_tpu_torch/_build.py into a temporary directory,
all nvcc processes at once, and prints one line per kernel (names
demangled with cu++filt where the toolkit has it).  Given two DIRs (a
copy of an earlier commit's csrc and this one) it shows whether an
instantiation compiles as before.  Needs nvcc: run it on the machine
with the card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from concept_tpu_torch import _build  # noqa: E402


def _demangle(names):
    tool = shutil.which("cu++filt") or os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    if not os.path.exists(tool):
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    return dict(zip(names, out.stdout.splitlines()))


def _parse(log: str) -> list[dict]:
    """One dict per compiled entry function of a ptxas -v log."""
    entries, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"mangled": m.group(1)}
            entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+)(?:\+(\d+))? bytes smem", line)
            cur["smem"] = int(s.group(1)) + int(s.group(2) or 0) if s else 0
    return entries


def report(csrc: str) -> list[dict]:
    sources = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(src, subprocess.Popen(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
             os.path.join(tmp, os.path.basename(src) + ".so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for src in sources]
        rows = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed for {src}:\n{log}")
            for e in _parse(log):
                e["source"] = os.path.basename(src)
                rows.append(e)
    names = _demangle([r["mangled"] for r in rows])
    for r in rows:
        r["kernel"] = names.get(r["mangled"], r["mangled"])
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--csrc", action="append",
                   help="a directory of .cu sources (repeatable; default the package's)")
    p.add_argument("--out", help="also write the rows as JSON")
    args = p.parse_args(argv)
    dirs = args.csrc or [_build.CSRC]
    result = {}
    for d in dirs:
        rows = report(d)
        result[d] = rows
        print(f"{d}:")
        for r in sorted(rows, key=lambda r: (r["source"], r["kernel"])):
            print(f"  {r['source']}: {r['kernel'][:150]}: {r.get('registers')} registers, "
                  f"{r.get('spill_stores')}/{r.get('spill_loads')} bytes spill stores/loads, "
                  f"{r.get('stack')} bytes stack, {r.get('smem')} bytes static smem")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
