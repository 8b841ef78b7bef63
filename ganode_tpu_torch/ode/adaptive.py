"""Adaptive Dormand-Prince 5(4) with a PI step-size controller (twin of
``ganode_tpu/ode/adaptive.py``).

The controller is the JAX package's, constant for constant: safety 0.9, the
factor clipped to [0.2, 10], PI exponents 0.7/5 and 0.4/5, at most 4096
attempts per output interval; FSAL reuse (an attempt costs 6 evaluations);
steps clipped to land on each output time, an accepted clipped step keeping
the unclipped proposal; one RMS error norm over the whole state, so a batch
shares one step size; and the ``steps_exhausted`` flag when an interval runs
out of attempts (the trajectory is then truncated, as in JAX, not refused).

Where JAX runs each interval as a device ``while_loop``, the loop here runs
on the host: the step size, time and controller live in host scalars of the
state's precision (numpy float32 for a float32 state, as JAX's float32
scalars), and each attempt reads its error norm back to decide, which is one
host sync per attempt (two more for the first step's size). ``SolveStats``
counts them as ``syncs``.

Gradients flow through the continuous adjoint, :func:`odeint_adaptive_adjoint`,
a ``torch.autograd.Function`` whose backward solves the augmented system
``[y, a, a_params]`` adaptively in reverse time, restarting each interval from
the saved forward outputs.
"""
from __future__ import annotations

import collections
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import tableaus as tb
from .adjoint import augmented_dynamics
from .solve import SolveStats, host_scalar, rk_step_tree
from .tree import tree_lincomb, tree_zeros_like

# Every adaptive solve of this process, summed by kind: "forward" (each
# odeint_adaptive, the adjoint's forward included) and "backward" (each
# adjoint backward, its reverse-time interval solves summed; "exhausted"
# counts intervals). Keys "<kind>_<calls|nfe|accepted|rejected|syncs|
# exhausted>". Reset it to 0 before a run to count that run, like the
# kernels' launch counters.
tally = collections.Counter()


class _Controller(NamedTuple):
    rtol: float
    atol: float
    safety: float = 0.9
    factor_min: float = 0.2
    factor_max: float = 10.0
    # PI exponents (Hairer II.4): h *= safety * err^-beta1 * prev_err^beta2
    beta1: float = 0.7 / 5.0
    beta2: float = 0.4 / 5.0
    max_steps: int = 4096


def _error_norm(y0, y1, y_err, rtol, atol) -> torch.Tensor:
    """RMS of ``y_err / (atol + rtol max(|y0|, |y1|))`` over every element of
    every leaf: one norm for the whole state (a 0-d tensor on the device)."""
    total, count = 0.0, 0
    for e, a, b in zip(y_err, y0, y1):
        scale = atol + rtol * torch.maximum(torch.abs(a), torch.abs(b))
        total = total + torch.sum(torch.square(e / scale))
        count += e.numel()
    return torch.sqrt(total / count)


def _rms(tree, ref, rtol, atol) -> torch.Tensor:
    total, count = 0.0, 0
    for x, r in zip(tree, ref):
        scale = atol + rtol * torch.abs(r)
        total = total + torch.sum(torch.square(x / scale))
        count += x.numel()
    return torch.sqrt(total / count)


def _initial_step(f, t0, y0, order, rtol, atol):
    """Hairer's starting-step heuristic (Solving ODEs I, II.4), simplified,
    as the JAX package has it -> ``(h, f(t0, y0))``. Two host syncs."""
    s = type(t0)
    f0 = f(t0, y0)
    d0, d1 = (s(v) for v in torch.stack([_rms(y0, y0, rtol, atol),
                                         _rms(f0, y0, rtol, atol)]).tolist())
    h0 = s(1e-6) if min(d0, d1) < s(1e-5) else \
        s(0.01) * d0 / max(d1, s(1e-12))
    y1 = tree_lincomb([h0], [f0], base=y0)
    f1 = f(t0 + h0, y1)
    diff = tuple(a - b for a, b in zip(f1, f0))
    d2 = s(_rms(diff, y0, rtol, atol).item()) / h0
    if max(d1, d2) <= s(1e-15):
        h1 = max(s(1e-6), h0 * s(1e-3))
    else:
        h1 = (s(0.01) / max(d1, d2)) ** s(1.0 / (order + 1.0))
    return min(s(100.0) * h0, h1), f0


def odeint_adaptive(func: Callable, y0, ts, args=None, *, rtol: float = 1e-5,
                    atol: float = 1e-6, safety: float = 0.9,
                    factor_min: float = 0.2, factor_max: float = 10.0,
                    beta1: float = 0.7 / 5.0, beta2: float = 0.4 / 5.0,
                    max_steps: int = 4096, return_stats: bool = False):
    """Adaptive dopri5 solve of ``dy/dt = func(t, y[, args])`` over the
    output grid ``ts`` (forward only; for gradients use
    :func:`odeint_adaptive_adjoint`). ``y0`` is a tensor or a tuple of
    tensors; the result has a new leading time axis of ``len(ts)`` with
    ``ys[0] == y0`` (a tuple of such for a tuple state), and its
    ``SolveStats`` with ``return_stats``. ``func`` receives ``t`` as a host
    scalar."""
    ctrl = _Controller(rtol, atol, safety, factor_min, factor_max, beta1,
                       beta2, max_steps)
    f = (lambda t, y: func(t, y)) if args is None else \
        (lambda t, y: func(t, y, args))
    single = isinstance(y0, torch.Tensor)
    tree = (y0,) if single else tuple(y0)
    ft = (lambda t, y: (f(t, y[0]),)) if single else \
        (lambda t, y: tuple(f(t, y)))
    ys, stats = _solve(ft, tree, _host_times(ts, tree[0].dtype), ctrl)
    _count("forward", stats)
    ys = tuple(torch.stack([y[j] for y in ys]) for j in range(len(tree)))
    ys = ys[0] if single else ys
    return (ys, stats) if return_stats else ys


def _host_times(ts, dtype) -> np.ndarray:
    ts = ts.detach().cpu().numpy() if isinstance(ts, torch.Tensor) else ts
    return np.asarray(ts, dtype=host_scalar(dtype))


def _count(kind: str, stats: SolveStats, calls: int = 1):
    tally[f"{kind}_calls"] += calls
    tally[f"{kind}_nfe"] += stats.nfe
    tally[f"{kind}_accepted"] += stats.n_steps
    tally[f"{kind}_rejected"] += stats.n_rejected
    tally[f"{kind}_syncs"] += stats.syncs
    tally[f"{kind}_exhausted"] += int(stats.steps_exhausted)


def _solve(f, y0, ts: np.ndarray, ctrl: _Controller):
    """The solve over host times ``ts`` for a tuple state -> (the state at
    each output time, ``SolveStats``)."""
    tableau = tb.DOPRI5
    s = type(ts[0])
    t = ts[0]
    h, fsal = _initial_step(f, t, y0, tableau.order, ctrl.rtol, ctrl.atol)
    direction = s(np.sign(ts[-1] - ts[0]))
    h = h * direction
    safety, beta1, beta2 = s(ctrl.safety), s(-ctrl.beta1), s(ctrl.beta2)
    fmin, fmax, floor, tiny = (s(ctrl.factor_min), s(ctrl.factor_max),
                               s(1e-10), s(1e-12))
    y, prev_err = y0, s(1.0)
    # _initial_step used 2 evaluations; FSAL covers stage 1 of the first
    nfe, nacc, nrej, syncs, exhausted = 2, 0, 0, 2, False
    ys = [y0]
    for t_target in ts[1:]:
        steps = 0
        while direction * (t_target - t) > tiny and steps < ctrl.max_steps:
            # clip the step so that it lands exactly on the output time
            h_clip = t_target - t if direction * (t + h - t_target) > 0 else h
            y1, ks = rk_step_tree(tableau, f, t, h_clip, y, f0=fsal)
            y_err = tree_lincomb([h_clip * s(e) for e in tableau.b_err], ks)
            err = s(_error_norm(y, y1, y_err, ctrl.rtol, ctrl.atol).item())
            syncs += 1
            accept = err <= s(1.0)
            err_c, prev_c = max(err, floor), max(prev_err, floor)
            factor = safety * err_c ** beta1 * prev_c ** beta2
            factor = min(max(factor, fmin), fmax)
            # an accepted attempt that was short only because it was clipped
            # to the output time keeps at least the unclipped proposal
            h_next = abs(h_clip) * factor
            if accept and abs(h_clip) < abs(h):
                h_next = max(h_next, abs(h))
            h = direction * h_next
            if accept:
                t, y, fsal, prev_err = t + h_clip, y1, ks[-1], err_c
                nacc += 1
            else:
                nrej += 1
            nfe += 6  # 6 fresh evaluations per attempt (FSAL gives the 7th)
            steps += 1
        exhausted |= (steps >= ctrl.max_steps
                      and bool(direction * (t_target - t) > tiny))
        ys.append(y)
    return ys, SolveStats(nfe=nfe, n_steps=nacc, n_rejected=nrej,
                          steps_exhausted=exhausted, syncs=syncs)


def odeint_adaptive_adjoint(func: Callable, y0: torch.Tensor, ts, params,
                            rtol: float = 1e-5,
                            atol: float = 1e-6) -> torch.Tensor:
    """Adaptive dopri5 with continuous-adjoint gradients
    (``ganode_tpu/ode/adaptive.py:184-232``).

    ``func(t, y, params) -> dy`` with ``params`` a tuple of tensors, whose
    gradients the backward returns. The backward integrates the augmented
    system (state, state adjoint, parameter adjoint) in reverse time, one
    adaptive solve per output interval, each restarting from the saved
    forward output. ``ts`` gets no gradient (the models never differentiate
    their time grid).
    """
    params = tuple(params)
    return _AdaptiveAdjoint.apply(func, ts, rtol, atol, y0, *params)


class _AdaptiveAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, func, ts, rtol, atol, y0, *params):
        ctx.func, ctx.rtol, ctx.atol = func, rtol, atol
        ctx.ts = _host_times(ts, y0.dtype)
        ys = odeint_adaptive(func, y0, ctx.ts, params, rtol=rtol, atol=atol)
        ctx.save_for_backward(ys, *params)
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        ys, *params = ctx.saved_tensors
        ts = ctx.ts
        aug_dyn = augmented_dynamics(ctx.func, params)
        ctrl = _Controller(ctx.rtol, ctx.atol)
        a, a_params = g[-1], tree_zeros_like(tuple(params))
        for i in range(len(ts) - 1, 0, -1):
            out, stats = _solve(aug_dyn, (ys[i], a, *a_params),
                                ts[[i, i - 1]], ctrl)
            _count("backward", stats, calls=0)
            _, a, *a_params = out[-1]
            a = a + g[i - 1]
        tally["backward_calls"] += 1
        return (None, None, None, None, a, *a_params)
