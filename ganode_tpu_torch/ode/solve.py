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
this solver serves the other fixed-grid methods. Adaptive stepping is
``ode.adaptive``, the continuous adjoint ``ode.adjoint``, SDEs ``ode.sde``
and CDEs ``ode.cde``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from . import tableaus as tb
from .tree import Tree, tree_lincomb

VectorField = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SolveStats:
    """Solver instrumentation (``ganode_tpu/ode/solve.py:42``). Fixed-grid
    counts follow from the grid; adaptive ones are counted as the solve runs."""

    nfe: int           # number of right-hand-side evaluations
    n_steps: int       # accepted steps
    n_rejected: int = 0
    # adaptive only: True if an interval hit max_steps before reaching its
    # output time; the returned trajectory is then truncated
    steps_exhausted: bool = False
    # the port's own: times the solve waited for the device to decide on the
    # host (adaptive only: one per attempt, two for the first step's size)
    syncs: int = 0


def host_scalar(dtype: torch.dtype):
    """The numpy scalar type a solver's host-side times and steps take for a
    state of ``dtype``: float64 for float64 states, float32 otherwise, as
    the JAX solver's scalars follow the state."""
    return np.float64 if dtype == torch.float64 else np.float32


def rk_step_tree(tableau: tb.ButcherTableau, f, t0, h, y0: Tree, f0=None):
    """One explicit RK step of ``f(t, y)`` over a tuple state, with the time
    ``t0`` and step ``h`` as host scalars (numpy, in the state's precision):
    ``(y1, ks)``. ``f0`` supplies the first stage (FSAL reuse). The twin of
    the JAX ``rk_step`` over pytrees: coefficients ``h * a_ij`` rounded to
    the scalar type, stage sums in the same order."""
    ks = []
    for i in range(tableau.stages):
        if i == 0:
            k = f0 if f0 is not None else f(t0, y0)
        else:
            coeffs = [h * type(h)(aij) for aij in tableau.a[i]]
            yi = tree_lincomb(coeffs, ks[:len(coeffs)], base=y0)
            k = f(t0 + type(h)(tableau.c[i]) * h, yi)
        ks.append(k)
    y1 = tree_lincomb([h * type(h)(bi) for bi in tableau.b], ks, base=y0)
    return y1, ks


def _fixed_grid(method: str) -> tb.ButcherTableau:
    if method not in tb.FIXED_GRID:
        raise ValueError(
            f"Unknown fixed-grid method {method!r}; choose from "
            f"{sorted(tb.FIXED_GRID)} (for adaptive stepping use "
            "ganode_tpu_torch.ode.odeint_adaptive)")
    return tb.FIXED_GRID[method]


def _with_args(func, args):
    return (lambda t, y: func(t, y)) if args is None else \
        (lambda t, y: func(t, y, args))


def host_times(ts, dtype: torch.dtype) -> np.ndarray:
    """``ts`` as a numpy array on the host, in its own floating dtype (a
    list, or integers, take the state's ``host_scalar``), so that every time
    and step derived from it rounds as the JAX solver's scalars do."""
    if isinstance(ts, torch.Tensor):
        ts = ts.detach().cpu().numpy()
    ts = np.asarray(ts)
    return ts if ts.dtype.kind == "f" else ts.astype(host_scalar(dtype))


def odeint(func: VectorField, y0: torch.Tensor, ts, args=None, *,
           method: str = "rk4", steps_per_interval: int = 1,
           return_stats: bool = False):
    """Integrate ``dy/dt = func(t, y, args)`` over the grid ``ts``.

    The times are host scalars (``ts`` read once on the host; pass it there
    to keep the solve from waiting for the device), so ``func`` gets ``t``
    as a numpy scalar. Returns a tensor of shape ``(len(ts),) + y0.shape``
    with ``ys[0] == y0``, and its ``SolveStats`` with ``return_stats``.
    """
    tableau = _fixed_grid(method)
    spi = int(steps_per_interval)
    if spi < 1:
        raise ValueError("steps_per_interval must be >= 1")
    f = _with_args(func, args)
    ft = lambda t, y: (f(t, y[0]),)  # noqa: E731
    ts = host_times(ts, y0.dtype)
    s = ts.dtype.type
    ys, y = [y0], (y0,)
    for i in range(len(ts) - 1):
        t0 = ts[i]
        h = (ts[i + 1] - t0) / s(spi)
        for j in range(spi):
            y, _ = rk_step_tree(tableau, ft, t0 + s(j) * h if j else t0, h, y)
        ys.append(y[0])
    ys = torch.stack(ys)
    if return_stats:
        n = len(ts) - 1
        return ys, SolveStats(nfe=tableau.stages * n * spi, n_steps=n * spi)
    return ys


def odeint_final(func: VectorField, y0: torch.Tensor, t0, t1, args=None, *,
                 method: str = "rk4", num_steps: int = 1) -> torch.Tensor:
    """Integrate from ``t0`` to ``t1`` in ``num_steps`` equal steps and
    return only the final state (``ganode_tpu/ode/solve.py:153``: the
    primitive behind ODE-RNN and the continuous-depth block). The times are
    host scalars, float32 unless ``t0`` is float64, as JAX types them."""
    tableau = _fixed_grid(method)
    f = _with_args(func, args)
    ft = lambda t, y: (f(t, y[0]),)  # noqa: E731
    s = (np.float64 if getattr(t0, "dtype", None) in (np.float64, torch.float64)
         else np.float32)
    t0, t1 = s(float(t0)), s(float(t1))
    h = (t1 - t0) / s(num_steps)
    y = (y0,)
    for j in range(num_steps):
        y, _ = rk_step_tree(tableau, ft, t0 + s(j) * h, h, y)
    return y[0]


def nfe_fixed_grid(method: str, n_outputs: int,
                   steps_per_interval: int = 1) -> int:
    """Exact NFE of a fixed-grid solve: rk4 over 16 output times is 60."""
    return _fixed_grid(method).stages * (n_outputs - 1) * steps_per_interval
