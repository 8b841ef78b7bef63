"""Cubic-spline control paths for neural CDEs (twin of
``ganode_tpu/ode/spline.py``).

* ``hermite_cubic_coefficients`` fits a path ``x (..., T, C)`` sampled at
  times ``t`` (default ``arange(T)``) with a C^1 piecewise cubic whose nodal
  derivatives are backward differences (the forward difference at i = 0), as
  torchcde's ``hermite_cubic_coefficients_with_backward_differences``.
* ``linear_coefficients``: the piecewise-linear path; ``natural_cubic_
  coefficients``: the natural cubic spline (zero second derivative at both
  ends) by a dense solve of its tridiagonal moment system.
* :class:`CubicSpline` evaluates values and derivatives at any time, the
  boundary polynomials extended outside ``[t[0], t[-1]]``.

A solver asks for the spline at host times (Python or numpy floats): the
interval is then found on the host from a host copy of the knots, so no
evaluation waits for the device. A time given as a tensor is located with
``torch.searchsorted`` on its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .solve import host_scalar


@dataclasses.dataclass
class CubicSpline:
    """Piecewise cubic ``p_i(u) = a_i + b_i u + c_i u^2 + d_i u^3``,
    ``u = t - knots[i]``. Coefficients ``(..., T-1, C)``, ``knots (T,)`` on
    their device; ``host_knots`` is the knots' numpy copy (None: copied from
    the device when first needed)."""

    knots: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor
    host_knots: np.ndarray | None = None

    def _locate(self, t):
        """-> (interval index, ``u = t - knots[idx]``): ``searchsorted(side=
        "right") - 1`` clipped to ``[0, T-2]`` (``ganode_tpu/ode/spline.py:
        49-52``), so a time on a knot takes the interval to its right."""
        n = self.knots.shape[0]
        if isinstance(t, torch.Tensor):
            t = t.to(self.knots.device, self.knots.dtype)
            idx = torch.searchsorted(self.knots, t.reshape(1), right=True) - 1
            idx = idx.clamp(0, n - 2)
            return idx, (t - self.knots[idx]).reshape(())
        if self.host_knots is None:
            self.host_knots = self.knots.detach().cpu().numpy()
        s = host_scalar(self.knots.dtype)
        t = s(t)
        idx = int(np.clip(np.searchsorted(self.host_knots, t, side="right") - 1,
                          0, n - 2))
        return idx, float(t - s(self.host_knots[idx]))

    def _take(self, arr, idx):
        if isinstance(idx, int):
            return arr[..., idx, :]
        return arr.index_select(-2, idx).squeeze(-2)

    def evaluate(self, t) -> torch.Tensor:
        """Value at scalar time ``t`` -> ``(..., C)``."""
        idx, u = self._locate(t)
        a, b, c, d = (self._take(x, idx) for x in (self.a, self.b, self.c, self.d))
        return a + u * (b + u * (c + u * d))

    def derivative(self, t) -> torch.Tensor:
        """dX/dt at scalar time ``t`` -> ``(..., C)``."""
        idx, u = self._locate(t)
        b, c, d = (self._take(x, idx) for x in (self.b, self.c, self.d))
        return b + u * (2.0 * c + u * 3.0 * d)

    def evaluate_batch(self, ts) -> torch.Tensor:
        """Values at each time of ``ts`` -> ``(..., len(ts), C)``."""
        return torch.stack([self.evaluate(t) for t in ts], dim=-2)


def _times(x: torch.Tensor, t):
    """The knots on ``x``'s device and their host copy (None when ``t`` is
    already on the card: copied when first needed)."""
    s = host_scalar(x.dtype)
    if t is None:
        host = np.arange(x.shape[-2], dtype=s)
    elif isinstance(t, torch.Tensor) and t.device.type != "cpu":
        return t.to(x.dtype), None
    else:
        host = np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t
                          ).astype(s)
    return torch.as_tensor(host, device=x.device), host


def _steps(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t[1:] - t[:-1]`` shaped ``(1, ..., T-1, 1)`` against ``x``."""
    return (t[1:] - t[:-1]).reshape((1,) * (x.ndim - 2) + (-1, 1))


def _hermite_from_derivs(x, derivs, t):
    """Per-interval cubic coefficients from nodal values and derivatives."""
    h = _steps(x, t)
    x0, x1 = x[..., :-1, :], x[..., 1:, :]
    d0, d1 = derivs[..., :-1, :], derivs[..., 1:, :]
    delta = (x1 - x0) / h
    c = (3.0 * delta - 2.0 * d0 - d1) / h
    d = (d0 + d1 - 2.0 * delta) / (h * h)
    return x0, d0, c, d


def hermite_cubic_coefficients(x: torch.Tensor, t=None) -> CubicSpline:
    """Hermite cubic spline with backward-difference nodal derivatives (the
    forward difference at i = 0)."""
    t, host = _times(x, t)
    diffs = (x[..., 1:, :] - x[..., :-1, :]) / _steps(x, t)
    derivs = torch.cat([diffs[..., :1, :], diffs], dim=-2)
    a, b, c, d = _hermite_from_derivs(x, derivs, t)
    return CubicSpline(t, a, b, c, d, host)


def linear_coefficients(x: torch.Tensor, t=None) -> CubicSpline:
    """Piecewise-linear control path."""
    t, host = _times(x, t)
    b = (x[..., 1:, :] - x[..., :-1, :]) / _steps(x, t)
    a = x[..., :-1, :]
    z = torch.zeros_like(a)
    return CubicSpline(t, a, b, z, z, host)


def natural_cubic_coefficients(x: torch.Tensor, t=None) -> CubicSpline:
    """Natural cubic spline: the moment system ``A m = rhs`` (``m_0 =
    m_{T-1} = 0``) solved densely with ``torch.linalg.solve``."""
    t, host = _times(x, t)
    n, ch = x.shape[-2], x.shape[-1]
    h = t[1:] - t[:-1]
    one = torch.ones(1, dtype=x.dtype, device=x.device)
    zero = torch.zeros(1, dtype=x.dtype, device=x.device)
    main = torch.cat([one, 2.0 * (h[:-1] + h[1:]), one])
    lower = torch.cat([h[:-1], zero])
    upper = torch.cat([zero, h[1:]])
    A = torch.diag(main) + torch.diag(lower, -1) + torch.diag(upper, 1)

    hh = _steps(x, t)
    slope = (x[..., 1:, :] - x[..., :-1, :]) / hh
    rhs_mid = 6.0 * (slope[..., 1:, :] - slope[..., :-1, :])
    zeros = x.new_zeros(x.shape[:-2] + (1, ch))
    rhs = torch.cat([zeros, rhs_mid, zeros], dim=-2)
    m = torch.linalg.solve(A, rhs.reshape(-1, n, ch)).reshape(rhs.shape)

    m0, m1 = m[..., :-1, :], m[..., 1:, :]
    x0, x1 = x[..., :-1, :], x[..., 1:, :]
    b = (x1 - x0) / hh - hh * (2.0 * m0 + m1) / 6.0
    return CubicSpline(t, x0, b, m0 / 2.0, (m1 - m0) / (6.0 * hh), host)
