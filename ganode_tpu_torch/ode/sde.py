"""Stochastic differential equation solvers (twin of ``ganode_tpu/ode/sde.py``).

Ito SDE ``dy = f(t, y) dt + g(t, y) dW`` with diagonal noise (one Brownian
channel per state element, the diffusion acting elementwise), over an output
grid ``ts`` whose every interval is split into ``ceil(interval / dt)`` equal
substeps (torchsde's fixed-step semantics; 3 per interval, 45 in all, for the
reference's T = 16 on [0, 1] at dt = 2.5e-2).

The Brownian increments are an explicit input, ``dW`` of shape
``(K, *y.shape)`` with ``K = (len(ts) - 1) * substeps``, each already scaled
by ``sqrt(|h|)`` of its interval's substep ``h``: what the JAX solver draws
inside as ``sqrt(|h|) * normal(fold_in(key, k))``. ``brownian_increments``
draws them from a ``torch.Generator``. Replaying the same ``dW`` replays the
same path, which the reversible adjoint's backward relies on.

Times and substep sizes are host scalars (numpy, in the state's precision,
rounded as the JAX solver's float32 ones), so no step waits for the device.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .solve import SolveStats, host_scalar

METHODS = ("euler", "milstein", "reversible_heun")


def _substeps(ts, dt) -> int:
    """Substeps per output interval (uniform grid): ``ceil(interval / dt)``,
    taken on the host."""
    if dt is None:
        return 1
    host_ts = np.asarray(ts.cpu() if isinstance(ts, torch.Tensor) else ts)
    interval = float(host_ts[1] - host_ts[0])
    return max(1, math.ceil(round(interval / float(dt), 9)))


def _grid(ts, spi: int, dtype: torch.dtype):
    """-> [(t0, h) per interval]: host scalars of the state's precision,
    ``h = (t1 - t0) / spi`` rounded as JAX's float32 arithmetic rounds it."""
    s = host_scalar(dtype)
    host = np.asarray(ts.cpu() if isinstance(ts, torch.Tensor) else ts
                      ).astype(s)
    return [(host[i], (host[i + 1] - host[i]) / s(spi))
            for i in range(len(host) - 1)]


def brownian_increments(ts, dt, shape, generator: torch.Generator,
                        dtype=torch.float32) -> torch.Tensor:
    """Diagonal Brownian increments ``(K, *shape)`` for the grid ``ts`` at
    max step ``dt``, drawn from ``generator`` on its device: unit normals
    scaled by ``sqrt(|h|)`` of each substep's interval."""
    spi = _substeps(ts, dt)
    scales = np.asarray([np.sqrt(np.abs(h)) for _, h in _grid(ts, spi, dtype)
                         for _ in range(spi)])
    dev = generator.device
    z = torch.randn((len(scales), *shape), generator=generator, device=dev,
                    dtype=dtype)
    return z * torch.as_tensor(scales, device=dev).reshape(
        (-1,) + (1,) * len(shape))


def _diag_jacobian(g: Callable, t, y: torch.Tensor) -> torch.Tensor:
    """Exact ``diag(J_g)``, ``dg_i/dy_i`` per state element, from one basis
    JVP per feature (``torch.func.jvp`` under ``vmap``), differentiable in
    ``y`` and in what ``g`` closes over. Assumes ``g`` couples no leading
    (batch) axes, as the diagonal-noise contract implies."""
    d = y.shape[-1]
    basis = torch.eye(d, dtype=y.dtype, device=y.device).reshape(
        (d,) + (1,) * (y.ndim - 1) + (d,)).expand((d,) + y.shape)

    def jvp_at(e):
        return torch.func.jvp(lambda y_: g(t, y_), (y,), (e,))[1]

    cols = torch.func.vmap(jvp_at)(basis)                     # (d, *y.shape)
    return torch.diagonal(cols, dim1=0, dim2=-1)


def _check(method, dW, y0, ts, spi):
    if method not in METHODS:
        raise ValueError(f"unknown SDE method {method!r}; choose from "
                         f"{list(METHODS)}")
    k = (len(ts) - 1) * spi
    if tuple(dW.shape) != (k, *y0.shape):
        raise ValueError(f"dW must have shape {(k, *y0.shape)} ((len(ts) - 1)"
                         f" * {spi} substeps), got {tuple(dW.shape)}")


def _with_args(func, args):
    return (lambda t, y: func(t, y)) if args is None else \
        (lambda t, y: func(t, y, args))


def _reversible_heun(f, g, y0, grid, spi, dW):
    """The reversible Heun scheme (Kidger, Foster, Li & Lyons,
    arXiv:2105.13493; ``ganode_tpu/ode/sde.py:115-161``):

        yhat_{n+1} = 2 y_n - yhat_n + h f(t_n, yhat_n) + g(t_n, yhat_n) dW_n
        y_{n+1}    = y_n + h/2 [f(t_n, yhat_n) + f(t_{n+1}, yhat_{n+1})]
                         + dW_n/2 [g(t_n, yhat_n) + g(t_{n+1}, yhat_{n+1})]

    one drift and one diffusion evaluation per substep (carried). Returns
    the interval-boundary states and the final pair ``(y_N, yhat_N)``."""
    y = yhat = y0
    fh, gh = f(grid[0][0], y0), g(grid[0][0], y0)
    ys, k = [y0], 0
    for t0, h in grid:
        hf = float(h)
        for j in range(spi):
            w = dW[k]
            yhat1 = 2 * y - yhat + hf * fh + gh * w
            t_next = t0 + type(h)(j + 1) * h
            fh1, gh1 = f(t_next, yhat1), g(t_next, yhat1)
            y = y + (hf / 2) * (fh + fh1) + (w / 2) * (gh + gh1)
            yhat, fh, gh, k = yhat1, fh1, gh1, k + 1
        ys.append(y)
    return torch.stack(ys), (y, yhat)


def sdeint(drift: Callable, diffusion: Callable, y0: torch.Tensor, ts,
           dW: torch.Tensor, args=None, *, dt: float | None = None,
           method: str = "euler", noise_type: str = "diagonal",
           return_stats: bool = False):
    """Integrate the Ito SDE ``dy = f dt + g dW`` over the output grid
    ``ts`` (``ganode_tpu/ode/sde.py:164-260``), differentiable by autograd.

    Args:
      drift, diffusion: ``(t, y[, args]) -> like y``.
      y0: initial state; ts: output times (host values: a numpy array, a list
        or a CPU tensor); dW: the increments, ``(K, *y0.shape)``, scaled.
      dt: max internal step (None: one substep per interval).
      method: ``euler`` (Euler-Maruyama), ``milstein`` (diagonal Milstein
        with the exact Jacobian diagonal) or ``reversible_heun``.

    Returns ``ys`` stacked over a leading time axis (``ys[0] == y0``), and
    its ``SolveStats`` with ``return_stats``.
    """
    if noise_type != "diagonal":
        raise NotImplementedError("only diagonal noise is implemented")
    spi = _substeps(ts, dt)
    _check(method, dW, y0, ts, spi)
    f, g = _with_args(drift, args), _with_args(diffusion, args)
    grid = _grid(ts, spi, y0.dtype)
    n_steps = len(grid) * spi
    if method == "reversible_heun":
        ys, _ = _reversible_heun(f, g, y0, grid, spi, dW)
        # one f and one g per substep (carried), plus the initial pair
        nfe = 2 * (n_steps + 1)
    else:
        y, k, ys = y0, 0, [y0]
        for t0, h in grid:
            hf = float(h)
            for j in range(spi):
                t, w = t0 + type(h)(j) * h, dW[k]
                gv = g(t, y)
                y1 = y + f(t, y) * hf + gv * w
                if method == "milstein":
                    # + 0.5 g_i (dg_i/dy_i) (dW_i^2 - h)
                    y1 = y1 + 0.5 * gv * _diag_jacobian(g, t, y) * (w * w - hf)
                y, k = y1, k + 1
            ys.append(y)
        ys = torch.stack(ys)
        # f and g, and for milstein one JVP (~2 g evaluations) per feature
        nfe = (2 if method == "euler" else 2 + 2 * y0.shape[-1]) * n_steps
    if return_stats:
        return ys, SolveStats(nfe=nfe, n_steps=n_steps)
    return ys


def sdeint_reversible_adjoint(drift: Callable, diffusion: Callable,
                              y0: torch.Tensor, ts, dW: torch.Tensor,
                              params=None, *, dt: float | None = None,
                              return_stats: bool = False):
    """Reversible Heun with its exact, O(1)-memory adjoint
    (``ganode_tpu/ode/sde.py:263-407``).

    ``drift(t, y, params)`` and ``diffusion(t, y, params)`` with ``params``
    a tuple of tensors, whose gradients the backward returns beside
    ``y0``'s (``drift(t, y)`` and ``diffusion(t, y)`` when ``params`` is
    None). The forward keeps no trajectory for the backward: the step is
    algebraically invertible,

        yhat_n = 2 y_{n+1} - yhat_{n+1} - h f(t_{n+1}, yhat_{n+1})
                                        - g(t_{n+1}, yhat_{n+1}) dW_n
        y_n    = y_{n+1} - h/2 [f(t_n, yhat_n) + f(t_{n+1}, yhat_{n+1})]
                         - dW_n/2 [g(t_n, yhat_n) + g(t_{n+1}, yhat_{n+1})],

    so the backward rebuilds each step's input from its output and takes
    the step's VJP, replaying the same ``dW``: the discrete adjoint of the
    scheme, up to the rounding of the reconstruction. ``ts`` and ``dW`` get
    no gradient.
    """
    spi = _substeps(ts, dt)
    _check("reversible_heun", dW, y0, ts, spi)
    if params is None:
        f, g = drift, diffusion
        drift = lambda t, y, p: f(t, y)      # noqa: E731
        diffusion = lambda t, y, p: g(t, y)  # noqa: E731
        params = ()
    params = tuple(params)
    grid = _grid(ts, spi, y0.dtype)
    ys = _RevHeunAdjoint.apply(drift, diffusion, grid, spi, dW, y0, *params)
    if return_stats:
        n_steps = len(grid) * spi
        return ys, SolveStats(nfe=2 * (n_steps + 1), n_steps=n_steps)
    return ys


class _RevHeunAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, drift, diffusion, grid, spi, dW, y0, *params):
        f = lambda t, y: drift(t, y, params)        # noqa: E731
        g = lambda t, y: diffusion(t, y, params)    # noqa: E731
        ys, (y_n, yhat_n) = _reversible_heun(f, g, y0, grid, spi, dW)
        ctx.drift, ctx.diffusion, ctx.grid, ctx.spi = drift, diffusion, grid, spi
        ctx.save_for_backward(y_n, yhat_n, dW, *params)
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        y1, yhat1, dW, *params = ctx.saved_tensors
        fcall, gcall, spi = ctx.drift, ctx.diffusion, ctx.spi
        ybar, yhatbar = gbar[-1], torch.zeros_like(y1)
        thbar = [torch.zeros_like(p) for p in params]
        k = len(ctx.grid) * spi
        for i in range(len(ctx.grid) - 1, -1, -1):
            t0, h = ctx.grid[i]
            hf = float(h)
            for j in range(spi - 1, -1, -1):
                k -= 1
                t_m, w = t0 + type(h)(j) * h, dW[k]
                t_n = t_m + h
                # the algebraic inverse: the step's input from its output
                f1, g1 = fcall(t_n, yhat1, params), gcall(t_n, yhat1, params)
                yhat0 = 2 * y1 - yhat1 - hf * f1 - g1 * w
                f0, g0 = fcall(t_m, yhat0, params), gcall(t_m, yhat0, params)
                y0 = y1 - (hf / 2) * (f0 + f1) - (w / 2) * (g0 + g1)
                with torch.enable_grad():
                    leaves = (y0.detach().requires_grad_(),
                              yhat0.detach().requires_grad_(),
                              *(p.detach().requires_grad_() for p in params))
                    y, yhat, th = leaves[0], leaves[1], leaves[2:]
                    fa, ga = fcall(t_m, yhat, th), gcall(t_m, yhat, th)
                    yh1 = 2 * y - yhat + hf * fa + ga * w
                    fb, gb = fcall(t_n, yh1, th), gcall(t_n, yh1, th)
                    yn1 = y + (hf / 2) * (fa + fb) + (w / 2) * (ga + gb)
                    vjps = torch.autograd.grad((yn1, yh1), leaves,
                                               (ybar, yhatbar),
                                               allow_unused=True)
                ybar = vjps[0]
                yhatbar = vjps[1]
                thbar = [a if v is None else a + v
                         for a, v in zip(thbar, vjps[2:])]
                y1, yhat1 = y0, yhat0
            # the forward emitted y at this boundary: its output cotangent
            ybar = ybar + gbar[i]
        # y0 seeds both slots of the pair (yhat_0 = y_0)
        return (None, None, None, None, None, ybar + yhatbar, *thbar)
