"""Fixed-grid ODE integration over one tensor state (twin of the fixed-grid
part of ``ganode_tpu/ode/solve.py``).

Contract, as torchdiffeq and the JAX package have it:

* ``ts`` is the output grid AND the step grid: one RK step per consecutive
  pair ``(ts[i], ts[i+1])``, optionally subdivided by ``steps_per_interval``.
* The trajectory is stacked along a new leading time axis with ``ys[0] == y0``.
* The vector field is ``func(t, y, args) -> dy/dt`` (or ``func(t, y)`` when
  ``args`` is None).

The loop is plain Python over eager PyTorch ops. The rk4 motion solve of the
generator runs in one CUDA kernel instead (``ganode_tpu_torch.ops.fused_rk4``);
this solver serves the other fixed-grid methods. Adaptive stepping, the
backsolve adjoint, SDEs and CDEs wait for ROADMAP M9 and M10.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import tableaus as tb

VectorField = Callable[..., torch.Tensor]


def rk_step(tableau: tb.ButcherTableau, f, t0, dt, y0):
    """One explicit RK step of ``f(t, y)``. Returns ``(y1, ks)``.

    Stage sums run in the JAX package's order: ``y0 + sum_j (dt * a_ij) k_j``,
    each coefficient cast to the state's dtype.
    """
    ks = []
    for i in range(tableau.stages):
        yi = y0
        for aij, kj in zip(tableau.a[i], ks):
            yi = yi + (dt * aij).to(y0.dtype) * kj
        ks.append(f(t0 + tableau.c[i] * dt, yi))
    y1 = y0
    for bi, ki in zip(tableau.b, ks):
        y1 = y1 + (dt * bi).to(y0.dtype) * ki
    return y1, ks


def odeint(func: VectorField, y0: torch.Tensor, ts: torch.Tensor, args=None,
           *, method: str = "rk4", steps_per_interval: int = 1) -> torch.Tensor:
    """Integrate ``dy/dt = func(t, y, args)`` over the grid ``ts``.

    Returns a tensor of shape ``(len(ts),) + y0.shape`` with ``ys[0] == y0``.
    """
    if method not in tb.FIXED_GRID:
        raise ValueError(
            f"Unknown fixed-grid method {method!r}; choose from "
            f"{sorted(tb.FIXED_GRID)} (adaptive stepping waits for ROADMAP M9)")
    spi = int(steps_per_interval)
    if spi < 1:
        raise ValueError("steps_per_interval must be >= 1")
    tableau = tb.FIXED_GRID[method]
    f = (lambda t, y: func(t, y)) if args is None else \
        (lambda t, y: func(t, y, args))
    ts = torch.as_tensor(ts, device=y0.device)
    ys = [y0]
    y = y0
    for i in range(ts.shape[0] - 1):
        t0 = ts[i]
        h = (ts[i + 1] - t0) / spi
        for j in range(spi):
            y, _ = rk_step(tableau, f, t0 + j * h if j else t0, h, y)
        ys.append(y)
    return torch.stack(ys)
