"""Neural controlled differential equations as an ODE reduction (twin of
``ganode_tpu/ode/cde.py``). A CDE

    dz = f(t, z) dX(t)

with a differentiable control path X is solved as the ODE
``dz/dt = f(t, z) @ dX/dt``, ``f`` returning a matrix field
``(..., hidden, input)`` and the spline's derivative ``(..., input)``.

The solve is ``solve.odeint``, whose times are host scalars: the spline
locates every stage's interval on the host, and no stage waits for the
device.
"""
from __future__ import annotations

from typing import Callable

import torch

from .solve import _with_args, odeint
from .spline import CubicSpline


def cdeint(X: CubicSpline, z0: torch.Tensor, func: Callable, ts, args=None,
           *, method: str = "rk4", steps_per_interval: int = 1,
           return_stats: bool = False):
    """Solve ``dz = f(t, z) dX`` over the output grid ``ts`` (host values)
    with a fixed-grid ``method``, differentiable by autograd
    (``ganode_tpu/ode/cde.py:25-61``).

    Returns the trajectory ``(len(ts), ..., hidden)`` with ``zs[0] == z0``,
    and its ``SolveStats`` with ``return_stats``.
    """
    f = _with_args(func, args)

    def rhs(t, z):
        return torch.einsum("...hi,...i->...h", f(t, z), X.derivative(t))

    return odeint(rhs, z0, ts, method=method,
                  steps_per_interval=steps_per_interval,
                  return_stats=return_stats)
