"""Natural cubic splines in NumPy float64, optionally on log axes.

Replaces the reference's GSL cubic splines (reference:
src/integration.py:39-327, including the log-axis handling at
integration.py:90-140).  The cosmology tables are tiny and live on the
host; the spline evaluates vectorised over query points.
"""

from __future__ import annotations

import numpy as np


def _natural_cubic_coeffs(x: np.ndarray, y: np.ndarray):
    """Natural cubic spline coefficients (match scipy CubicSpline 'natural').

    Returns (x, a, b, c, d) such that on interval i:
        S(t) = a[i] + b[i]*(t-x[i]) + c[i]*(t-x[i])**2 + d[i]*(t-x[i])**3
    """
    n = len(x)
    if n == 2:
        # Linear fallback
        b = np.array([(y[1] - y[0]) / (x[1] - x[0])])
        return x, y[:-1].copy(), b, np.zeros(1), np.zeros(1)
    h = np.diff(x)
    # Solve for second derivatives m (natural: m0 = m_{n-1} = 0)
    rhs = np.zeros(n)
    rhs[1:-1] = 6 * ((y[2:] - y[1:-1]) / h[1:] - (y[1:-1] - y[:-2]) / h[:-1])
    diag = np.ones(n)
    diag[1:-1] = 2 * (h[:-1] + h[1:])
    lower = np.zeros(n - 1)
    upper = np.zeros(n - 1)
    lower[:-1] = h[:-1]
    upper[1:] = h[1:]
    lower[-1] = 0.0
    upper[0] = 0.0
    # Thomas algorithm
    m = _thomas(lower, diag, upper, rhs)
    a = y[:-1].copy()
    b = (y[1:] - y[:-1]) / h - h / 6 * (2 * m[:-1] + m[1:])
    c = m[:-1] / 2
    d = (m[1:] - m[:-1]) / (6 * h)
    return x, a, b, c, d


def _thomas(lower, diag, upper, rhs):
    n = len(diag)
    cp = np.zeros(n - 1)
    dp = np.zeros(n)
    cp[0] = upper[0] / diag[0]
    dp[0] = rhs[0] / diag[0]
    for i in range(1, n):
        denom = diag[i] - (lower[i - 1] * cp[i - 1] if i >= 1 else 0.0)
        if i < n - 1:
            cp[i] = upper[i] / denom
        dp[i] = (rhs[i] - lower[i - 1] * dp[i - 1]) / denom
    x = np.zeros(n)
    x[-1] = dp[-1]
    for i in range(n - 2, -1, -1):
        x[i] = dp[i] - cp[i] * x[i + 1]
    return x


class Spline:
    """Cubic spline y(x), optionally in log(x) and/or log(y).

    Log axes are chosen automatically (as in reference integration.py:90-140)
    when the abscissa/ordinate span many decades and are strictly positive,
    unless explicitly given.
    """

    def __init__(self, x, y, logx: bool | None = None, logy: bool | None = None):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        order = np.argsort(x)
        x, y = x[order], y[order]
        # Drop duplicate abscissas
        keep = np.concatenate([[True], np.diff(x) > 0])
        x, y = x[keep], y[keep]
        if logx is None:
            logx = bool(x[0] > 0 and x[-1] / max(x[0], 1e-300) > 1e2)
        if logy is None:
            positive = bool(np.all(y > 0))
            logy = positive and bool(np.max(y) / max(np.min(y), 1e-300) > 1e2)
        self.logx, self.logy = logx, logy
        xt = np.log(x) if logx else x
        yt = np.log(y) if logy else y
        knots, a, b, c, d = _natural_cubic_coeffs(xt, yt)
        self._np_knots = knots
        self._np_coeffs = np.stack([a, b, c, d])
        self.xmin, self.xmax = float(x[0]), float(x[-1])

    def eval_np(self, xq):
        """Evaluate (float64).  Clamps to the tabulated range."""
        xq = np.asarray(xq, dtype=np.float64)
        t = np.log(xq) if self.logx else xq
        t = np.clip(t, self._np_knots[0], self._np_knots[-1])
        i = np.clip(np.searchsorted(self._np_knots, t, side="right") - 1, 0, len(self._np_knots) - 2)
        dt = t - self._np_knots[i]
        a, b, c, d = (self._np_coeffs[j, i] for j in range(4))
        val = a + dt * (b + dt * (c + dt * d))
        return np.exp(val) if self.logy else val

    __call__ = eval_np

    def eval_torch(self, xq):
        """Evaluate on a tensor, in its dtype and on its device.  Clamps
        to the tabulated range."""
        import torch

        knots = torch.as_tensor(self._np_knots, dtype=xq.dtype, device=xq.device)
        coeffs = torch.as_tensor(self._np_coeffs, dtype=xq.dtype, device=xq.device)
        t = torch.log(xq) if self.logx else xq
        t = t.clamp(knots[0], knots[-1])
        i = (torch.searchsorted(knots, t, right=True) - 1).clamp(0, len(knots) - 2)
        dt = t - knots[i]
        a, b, c, d = (coeffs[j, i] for j in range(4))
        val = a + dt * (b + dt * (c + dt * d))
        return torch.exp(val) if self.logy else val
