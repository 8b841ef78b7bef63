"""Continuous-adjoint (backsolve) gradients for fixed-grid solves (twin of
``ganode_tpu/ode/adjoint.py``).

Instead of keeping the solver's intermediates, the backward integrates the
adjoint system

    da/dt     = -a^T df/dy
    da_th/dt  = -a^T df/dtheta

backward in time beside the state, restarting each interval from the saved
forward output (so the reconstructed state cannot drift over a long
horizon), with the same tableau and sub-steps as the forward. The default
path for gradients stays autograd through ``solve.odeint`` (the discrete
adjoint: exact gradients of the discrete solver); this one exists for the
models' ``adjoint="backsolve"`` option. ``ts`` gets no gradient.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import tableaus as tb
from .solve import host_scalar, host_times, odeint, rk_step_tree
from .tree import tree_zeros_like


def augmented_dynamics(func, params):
    """The adjoint system's right-hand side over ``(y, a, *a_params)``:
    ``(f(t, y), -a^T df/dy, -a^T df/dparams)``, the products by
    ``torch.autograd.grad`` (the JAX ``aug_dyn``'s ``jax.vjp``)."""
    def aug_dyn(t, aug):
        y, a = aug[0], aug[1]
        with torch.enable_grad():
            leaves = (y.detach().requires_grad_(),
                      *(p.detach().requires_grad_() for p in params))
            f_val = func(t, leaves[0], leaves[1:])
            vjps = torch.autograd.grad(f_val, leaves, a, allow_unused=True)
        return (f_val.detach(), *(torch.zeros_like(x) if v is None else -v
                                  for v, x in zip(vjps, leaves)))
    return aug_dyn


def odeint_backsolve(func, y0: torch.Tensor, ts, params, method: str = "rk4",
                     steps_per_interval: int = 1) -> torch.Tensor:
    """``solve.odeint(func, y0, ts, params, method=...)`` with continuous-
    adjoint gradients; ``func(t, y, params) -> dy`` with ``params`` a tuple
    of tensors."""
    if method not in tb.FIXED_GRID:
        raise ValueError(f"Unknown fixed-grid method {method!r}; choose from "
                         f"{sorted(tb.FIXED_GRID)}")
    params = tuple(params)
    return _Backsolve.apply(func, ts, method, int(steps_per_interval), y0,
                            *params)


class _Backsolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, func, ts, method, spi, y0, *params):
        ts = host_times(ts, y0.dtype).astype(host_scalar(y0.dtype))
        ys = odeint(func, y0, ts, params, method=method,
                    steps_per_interval=spi)
        ctx.func, ctx.method, ctx.spi, ctx.ts = func, method, spi, ts
        ctx.save_for_backward(ys, *params)
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        ys, *params = ctx.saved_tensors
        ts, spi = ctx.ts, ctx.spi
        tableau = tb.FIXED_GRID[ctx.method]
        aug_dyn = augmented_dynamics(ctx.func, params)
        # for i = n-1 .. 1: from ts[i] down to ts[i-1], restarting y from the
        # saved ys[i], then add the output cotangent g[i-1]
        a, a_params = g[-1], tree_zeros_like(tuple(params))
        for i in range(len(ts) - 1, 0, -1):
            t1 = ts[i]
            h = (ts[i - 1] - t1) / type(t1)(spi)  # negative: backward in time
            aug = (ys[i], a, *a_params)
            for j in range(spi):
                aug, _ = rk_step_tree(tableau, aug_dyn,
                                      t1 + type(t1)(j) * h, h, aug)
            _, a, *a_params = aug
            a = a + g[i - 1]
        return (None, None, None, None, a, *a_params)
