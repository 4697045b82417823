"""Text output writers for spectra (reference analysis.py:796-833 columns +
get_txt_info analysis.py:3495)."""

from __future__ import annotations

import os

import numpy as np


def save_powerspec_txt(filename: str, pk: dict, a: float, boxsize: float,
                       unit_length: str = "Mpc", sigma: float | None = None,
                       tophat_R: float | None = None,
                       linear: np.ndarray | None = None,
                       sigma_linear: float | None = None,
                       significant_figures: int = 18):
    """Write a power spectrum text file: columns k, modes, P
    (+ corrected, linear when available).  ``sigma`` is the measured
    σ(R); ``sigma_linear`` the linear prediction (reference prints σ per
    column kind, analysis.py:811-826)."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    cols = [pk["k"], pk["modes"], pk["power"]]
    names = [f"k [{unit_length}⁻¹]", "modes", f"P [{unit_length}³]"]
    if "power_corrected" in pk:
        cols.append(pk["power_corrected"])
        names.append(f"P_corrected [{unit_length}³]")
    if linear is not None:
        cols.append(linear)
        names.append(f"P_linear [{unit_length}³]")
    header_lines = [f"Power spectrum at a = {a:.6g} (boxsize {boxsize:.6g} {unit_length})"]
    if sigma is not None and tophat_R is not None:
        line = f"σ(R={tophat_R:.4g} {unit_length}) = {sigma:.6g}"
        if sigma_linear is not None:
            line += f"  (linear: {sigma_linear:.6g})"
        header_lines.append(line)
    header_lines.append("  ".join(f"{n:<24}" for n in names))
    data = np.column_stack(cols)
    fmt = f"%.{max(1, int(significant_figures)) - 1}e"
    np.savetxt(filename, data, header="\n".join(header_lines), fmt=fmt)
    return filename
