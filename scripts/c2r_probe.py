"""cuFFT's inverse real FFTs against numpy's meaning where the input's
kk = 0 and n/2 planes are not Hermitian, as the LPT grids' are not
(i·k·δ on a Nyquist row: ic.py).  The slab FFT over ranks ends with a
1D c2r along z after the x- and y-transforms; grid/fft._irfft_z drops
the imaginary parts of bins 0 and n/2 first, as numpy's c2r ignores
them:

  random   random modes at n = 64 and 256 in complex64 and complex128,
           against the CPU's ``irfftn``, max |Δ| over the largest value:
           the card's 3D ``irfftn``; the x- and y-transforms then its 1D
           ``irfft`` as is ('raw'), and after ``_irfft_z``'s drop;
  1d       the card's 1D ``irfft`` of float rows at n = 256 and 512
           against the CPU's, max |Δ|;
  psi      example_basic's 256³ ψ_d = irfft(i k_d/k² δ) realized on the
           card: the 'raw' and the dropped forms against the card's 3D
           ``irfftn`` (one device's), max |Δ| over max |ψ_d|.

    python3 scripts/c2r_probe.py [--out FILE]

Needs a card; prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _xy(X):
    import torch

    return torch.fft.ifft(torch.fft.ifft(X, dim=-3), dim=-2)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", help="also write the JSON line to this file")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("c2r_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from concept_tpu_torch import ic
    from concept_tpu_torch.grid.fft import _irfft_z
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import build_cosmology

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator().manual_seed(0)
    out = {"random": {}, "1d": {}, "psi": {}}
    for n in (64, 256):
        for dt in (torch.complex64, torch.complex128):
            X = torch.randn((n, n, n // 2 + 1), dtype=dt, generator=gen)
            ref = torch.fft.irfftn(X, s=(n, n, n))
            Xc = X.cuda()
            out["random"][f"{n} {dt}"] = {
                "irfftn": _rel(torch.fft.irfftn(Xc, s=(n, n, n)).cpu(), ref),
                "raw": _rel(torch.fft.irfft(_xy(Xc), n=n, dim=-1).cpu(), ref),
                "dropped": _rel(_irfft_z(_xy(Xc), n).cpu(), ref)}
    for n in (256, 512):
        X = torch.randn((4096, n // 2 + 1), dtype=torch.complex64, generator=gen)
        out["1d"][n] = float((torch.fft.irfft(X.cuda(), n=n).cpu()
                              - torch.fft.irfft(X, n=n)).abs().max())
    cfg = load_params(os.path.join(ROOT, "param", "example_basic.py"),
                      overrides=["initial_conditions={'species':'matter','N':256**3}",
                                 "potential_options=512"])
    lin = build_cosmology(cfg)[3]
    n = 256
    delta = ic.realize_delta_slab(lin, n, cfg.boxsize, cfg.a_begin, 0, device="cuda")
    for d in range(3):
        pk = ic._grad_inv_laplacian(delta, n, cfg.boxsize, d)
        one = torch.fft.irfftn(pk, s=(n, n, n))
        out["psi"][d] = {"raw": _rel(torch.fft.irfft(_xy(pk), n=n, dim=-1), one),
                         "dropped": _rel(_irfft_z(_xy(pk), n), one)}
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
