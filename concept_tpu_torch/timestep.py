"""Static time-stepping: replay the base time-stepping as (a, Δa) pairs
(reference src/main.py:499-646 ``prepare_static_timestepping``).  The
``static_timestepping`` parameter is a path to a previously recorded
(a, Δa) file → replay it, or a callable a ↦ Δa → apply it directly.
Recording a run's stepping to a fresh path is not ported yet.
Host-side scalar bookkeeping only.
"""

from __future__ import annotations

import math
import os

import numpy as np

from concept_tpu_torch.utils.terminal import masterprint

DT_RELTOL = 1e-9  # relative precision of the recorded a values


class StaticTimestepping:
    """Replay of the base time-stepping as (a, Δa) pairs (reference
    prepare_static_timestepping, main.py:499-646).

    Modes:
      * ``apply`` — param points at an existing file: Δa(a) is replayed,
        exact values when a matches a recorded row (duplicates consumed
        in order, handling synchronizations), log-log interpolation over
        monotonically increasing Δa intervals otherwise.
      * ``callable`` — user function a ↦ Δa, applied directly.
    """

    def __init__(self, param):
        self.mode = None
        self._func = None
        self._data: dict[str, list[float]] = {}
        self._intervals: list[tuple[float, float, object]] = []
        # number of significant digits used to key exact-row lookups
        self._ndig = int(math.ceil(math.log10(1 / DT_RELTOL) + 0.5))
        if param is None:
            return
        if callable(param):
            self.mode = "callable"
            self._func = param
            masterprint("Static time-stepping configured using supplied function")
            return
        if not isinstance(param, (str, os.PathLike)):
            raise ValueError(
                f"Could not interpret static_timestepping = {param!r} "
                f"of type {type(param)}"
            )
        path = os.fspath(param)
        if os.path.isdir(path):
            raise ValueError(
                f'static_timestepping = "{path}" is a directory, not a file'
            )
        if not os.path.exists(path):
            raise NotImplementedError(
                f'static_timestepping = "{path}" does not exist: recording the '
                f"time-stepping is not ported (ROADMAP Queue 1 item 7)")
        self.mode = "apply"
        self._load(path)
        masterprint(
            f'Static time-stepping information will be read from "{path}"'
        )

    # -------------------------------------------------------------- #
    @property
    def applies(self) -> bool:
        return self.mode in ("apply", "callable")

    def _key(self, a: float) -> str:
        return f"{a:.{self._ndig}e}"

    def _load(self, path: str):
        a_arr, da_arr = np.loadtxt(path, unpack=True, ndmin=2)
        # duplicates (one a, several Δa due to synchronizations): keep
        # every Δa per a, consumed FIFO on replay
        for a, da in zip(a_arr, da_arr):
            self._data.setdefault(self._key(float(a)), []).append(float(da))
        # dedupe rows for the interpolant (first occurrence wins)
        seen = set()
        aa, dd = [], []
        for a, da in zip(a_arr, da_arr):
            k = self._key(float(a))
            if k in seen:
                continue
            seen.add(k)
            aa.append(float(a))
            dd.append(float(da))
        aa = np.asarray(aa)
        dd = np.asarray(dd)
        # split into intervals of monotonically increasing Δa — a drop in
        # Δa marks a reduction event; interpolating across it would be
        # wrong (reference main.py:546-565)
        if len(aa) == 1:
            aa = np.concatenate([aa, aa * (1 + 1e-9)])
            dd = np.concatenate([dd, dd])
        mask = np.diff(dd) < 0
        for i in range(1, len(mask)):
            mask[i] &= not mask[i - 1]
        if len(mask):
            mask[-1] = False
        idx = list(np.where(mask)[0] + 1)
        bounds = [0] + idx + [len(aa)]
        a_right = 0.0
        for j in range(len(bounds) - 1):
            lo, hi = bounds[j], bounds[j + 1]
            seg_a = np.log(aa[lo:hi])
            seg_d = np.log(dd[lo:hi])
            if len(seg_a) == 1:
                seg_a = np.array([seg_a[0], seg_a[0] + 1e-9])
                seg_d = np.array([seg_d[0], seg_d[0]])
            a_left, a_right = a_right, (
                float("inf") if j == len(bounds) - 2 else aa[bounds[j + 1]]
            )
            self._intervals.append((a_left, a_right, (seg_a, seg_d)))

    # -------------------------------------------------------------- #
    def delta_a(self, a: float) -> float:
        """Δa at scale factor a in apply/callable mode."""
        if self.mode == "callable":
            return float(self._func(a))
        if self.mode != "apply":
            raise RuntimeError("delta_a() only valid in apply/callable mode")
        lst = self._data.get(self._key(a))
        if lst:
            return lst.pop(0)
        for a_left, a_right, seg in self._intervals:
            if a_right != float("inf") and math.isclose(a, a_right):
                continue
            if a_left <= a < a_right:
                break
        else:
            seg = self._intervals[-1][2]
        seg_a, seg_d = seg
        # piecewise-linear in log-log with extrapolation beyond the ends
        # (reference interp1d fill_value='extrapolate', main.py:566-576)
        x = np.log(a)
        i = int(np.clip(np.searchsorted(seg_a, x) - 1, 0, len(seg_a) - 2))
        slope = (seg_d[i + 1] - seg_d[i]) / (seg_a[i + 1] - seg_a[i] + 1e-300)
        return float(np.exp(seg_d[i] + slope * (x - seg_a[i])))


def prepare_static_timestepping(param) -> StaticTimestepping | None:
    """Build the StaticTimestepping helper, or None when unset."""
    if param is None:
        return None
    return StaticTimestepping(param)
