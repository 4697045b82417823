"""Base time-step hysteresis and static time-stepping (port of
concept_tpu/timestep.py; reference src/main.py:499-646
``prepare_static_timestepping``, main.py:920-983
``update_base_timestep_size``, constants main.py:2320-2381).

* Δt never *increases* mid-period: only once ``DT_PERIOD`` steps have
  passed since the last synchronization, and then at most by a ramp
  factor ``1 + period_frac·(Δt_increase_max_factor − 1)``.
* Δt *decreases* immediately whenever it exceeds the current maximum,
  to ``DT_REDUCE_FAC·Δt_max``; reductions below ``DT_RATIO_WARN`` warn
  and below ``DT_RATIO_ABORT`` abort (unless tolerate_danger).
* ``static_timestepping`` (parameter): a path to a previously recorded
  (a, Δa) file → replay it; a fresh path → record this run's stepping
  (the global stepper records, the rung stepper only replays, as in the
  JAX package); a callable a ↦ Δa → apply it directly.

Host-side scalar bookkeeping only.
"""

from __future__ import annotations

import math
import os

import numpy as np

from concept_tpu_torch.utils.terminal import masterprint, masterwarn

# Reference numeric defaults (main.py:2320-2381)
DT_INITIAL_FAC = 0.95
DT_REDUCE_FAC = 0.94
DT_INCREASE_FAC = 0.96
DT_INCREASE_MIN_FAC = 1.01
DT_RATIO_WARN = 0.7
DT_RATIO_ABORT = 0.01
DT_RELTOL = 1e-9  # relative precision of the recorded a values
DT_PERIOD = 8


def update_base_timestep_size(
    dt: float,
    dt_min: float,
    dt_max: float,
    bottleneck: str,
    steps_since_sync: int = -1,
    *,
    dt_increase_max_factor: float = float("inf"),
    allow_increase: bool = True,
    tolerate_danger: bool = False,
) -> tuple[float, str]:
    """Hysteretic Δt update (reference main.py:920-983).  Returns the new
    (Δt, bottleneck); bottleneck becomes '' when Δt was raised."""
    if dt > dt_max:
        dt_new = DT_REDUCE_FAC * dt_max
        ratio = dt_new / dt if dt > 0 else 1.0
        message = (
            f"Rescaling time step size by a factor {ratio:.1g} due to {bottleneck}"
        )
        if ratio < DT_RATIO_ABORT and not tolerate_danger:
            raise RuntimeError(
                f"Due to {bottleneck}, the time step size needs to be "
                f"rescaled by a factor {ratio:.1g}. "
                f"This extreme change is unacceptable."
            )
        if ratio < DT_RATIO_WARN:
            masterwarn(message)
        if dt_new < dt_min:
            raise RuntimeError(
                f"Time evolution effectively halted with a time step size "
                f"of {dt_new}"
            )
        return dt_new, bottleneck
    if not allow_increase:
        return dt, bottleneck
    dt_new = max(DT_INCREASE_FAC * dt_max, dt)
    # ramp: the longer since the last sync, the larger the allowed jump
    period_frac = min(max((steps_since_sync + 1) / DT_PERIOD, 0.0), 1.0)
    if math.isfinite(dt_increase_max_factor):
        dt_new = min(dt_new, (1 + period_frac * (dt_increase_max_factor - 1)) * dt)
    if dt_new > dt:
        return dt_new, ""
    return dt, bottleneck


class StaticTimestepping:
    """Record/replay of the base time-stepping as (a, Δa) pairs
    (reference prepare_static_timestepping, main.py:499-646).

    Modes:
      * ``apply`` — param points at an existing file: Δa(a) is replayed,
        exact values when a matches a recorded row (duplicates consumed
        in order, handling synchronizations), log-log interpolation over
        monotonically increasing Δa intervals otherwise.
      * ``record`` — param points at a fresh path: (a, Δa_max) appended
        every time the global stepper (re)computes the base step size.
      * ``callable`` — user function a ↦ Δa, applied directly.
    """

    def __init__(self, param):
        self.mode = None
        self._func = None
        self._path = None
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
        self._path = path
        if os.path.isdir(path):
            raise ValueError(
                f'static_timestepping = "{path}" is a directory, not a file'
            )
        if os.path.exists(path):
            self.mode = "apply"
            self._load(path)
            masterprint(
                f'Static time-stepping information will be read from "{path}"'
            )
        else:
            self.mode = "record"
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            masterprint(
                f'Static time-stepping information will be written to "{path}"'
            )

    # -------------------------------------------------------------- #
    @property
    def applies(self) -> bool:
        return self.mode in ("apply", "callable")

    @property
    def records(self) -> bool:
        return self.mode == "record"

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

    def record(self, a: float, da_max: float):
        """Append one (a, Δa_max) row in record mode."""
        if self.mode != "record":
            return
        header_needed = (
            not os.path.exists(self._path) or os.path.getsize(self._path) == 0
        )
        with open(self._path, "a", encoding="utf-8") as f:
            if header_needed:
                n = self._ndig
                f.write(
                    "# Time-stepping recorded by concept_tpu\n#\n"
                    "# {}a{}Δa\n".format(" " * ((n + 3) // 2), " " * (n + 5))
                )
            f.write(f"{a:.{self._ndig}e} {da_max:.{self._ndig}e}\n")


def prepare_static_timestepping(param) -> StaticTimestepping | None:
    """Build the StaticTimestepping helper, or None when unset."""
    if param is None:
        return None
    return StaticTimestepping(param)
