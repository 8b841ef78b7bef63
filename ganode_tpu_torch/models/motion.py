"""Motion-latent samplers (twins of ``MotionODE`` and ``MotionGRU`` in
``ganode_tpu/models/motion.py``). Contract:

    sampler(n, video_len, *, generator=None, <noise>=None) -> (n, video_len, dim)

The JAX modules draw their noise inside from ``make_rng("sample")``; the two
frameworks give different numbers from one seed, so here the noise is an
optional explicit tensor (``x0`` for the ODE, ``h0`` and ``e`` for the GRU),
drawn from ``generator`` only when absent.

Each sampler runs its whole recursion in one CUDA kernel
(``ganode_tpu_torch.ops``) wherever the JAX package would take its Pallas
kernel: the ODE for rk4 with one step per interval and the checkpoint
adjoint, the GRU always. The ODE's other solvers (the fixed-grid methods,
sub-steps, the backsolve adjoint and adaptive dopri5) run ``ode``'s plain
solvers, as JAX runs them without Pallas. On CPU tensors the kernels' calls
run their plain versions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import GRUCell, MLP, WarmupMLP
from ..ode import (FIXED_GRID, odeint, odeint_adaptive_adjoint,
                   odeint_backsolve)
from ..ops import fused_gru_motion, fused_rk4_motion


def draw_normal(shape, generator, device) -> torch.Tensor:
    """N(0, I) noise from an explicit generator; there is no global-RNG path."""
    if generator is None:
        raise ValueError(
            "no torch.Generator given: pass one, or pass the noise explicitly")
    return torch.randn(shape, generator=generator, device=device)


class MotionGRU(nn.Module):
    """Baseline MoCoGAN recurrence: ``h_0 ~ N(0, I)``; ``h_t = GRU(e_t, h_{t-1})``
    with fresh noise ``e_t ~ N(0, I)``; output ``[h_1..h_T]``. The recurrence
    runs in the fused GRU kernel (K2)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.gru = GRUCell(dim)

    def init_parameters(self, generator: torch.Generator):
        self.gru.init_parameters(generator)

    def draw_noise(self, n: int, video_len: int, generator) -> dict:
        """The noise one call consumes, drawn from ``generator`` on its
        device: ``h0 (n, dim)`` and ``e (video_len, n, dim)``."""
        dev = generator.device
        return {"h0": draw_normal((n, self.dim), generator, dev),
                "e": draw_normal((video_len, n, self.dim), generator, dev)}

    def forward(self, n: int, video_len: int, *, generator=None, h0=None,
                e=None) -> torch.Tensor:
        dev = self.gru.wi.device
        if h0 is None:
            h0 = draw_normal((n, self.dim), generator, dev)
        if e is None:
            e = draw_normal((video_len, n, self.dim), generator, dev)
        g = self.gru
        hs = fused_gru_motion(h0.contiguous(), e.contiguous(), g.wi, g.wh,
                              g.bi, g.bh)
        return hs.transpose(0, 1)  # (n, T, dim)


def _mlp_field(t, y, p):
    """The ODE field ``Linear -> tanh -> Linear`` over explicit parameters
    ``(w0, b0, w1, b1)`` (``nn.Linear`` layout), as the solvers with their
    own adjoints take it."""
    return F.linear(torch.tanh(F.linear(y, p[0], p[1])), p[2], p[3])


class MotionODE(nn.Module):
    """Neural-ODE motion: ``x ~ N(0, I)`` -> warm-up MLP (``use_warmup``) ->
    ``odeint(f, x, linspace(0, 1, T))`` with ``f = Linear(d, h) -> tanh ->
    Linear(h, d)``, autonomous, ``h = dim_hidden or d`` (rk4 by default: 60
    evaluations at T=16).

    The options are the JAX module's (``ganode_tpu/models/motion.py:81-121``).
    rk4 with one step per interval and the checkpoint adjoint runs in the
    fused RK4 kernel (K1), as JAX gates its Pallas kernel; ``method="dopri5"``
    solves adaptively at ``rtol``/``atol`` with the continuous adjoint
    (``ode.odeint_adaptive_adjoint``); ``adjoint="backsolve"`` takes the
    fixed-grid continuous adjoint; every other combination runs ``odeint``
    and autograd through it (the discrete adjoint, as JAX's checkpointed
    scan differentiates).
    """

    def __init__(self, dim: int, dim_hidden: int | None = None,
                 use_warmup: bool = True, method: str = "rk4",
                 steps_per_interval: int = 1, adjoint: str = "checkpoint",
                 rtol: float = 1e-5, atol: float = 1e-6):
        super().__init__()
        if method != "dopri5" and method not in FIXED_GRID:
            raise ValueError(f"unknown motion method {method!r}; choose from "
                             f"{sorted(FIXED_GRID) + ['dopri5']}")
        if adjoint not in ("checkpoint", "backsolve"):
            raise ValueError(f"unknown adjoint {adjoint!r}; choose "
                             "'checkpoint' or 'backsolve'")
        self.dim = dim
        self.method = method
        self.steps_per_interval = steps_per_interval
        self.adjoint = adjoint
        self.rtol, self.atol = rtol, atol
        if use_warmup:
            self.WarmupMLP_0 = WarmupMLP(dim)
        self.use_warmup = use_warmup
        self.ode_fn = MLP(dim, (dim_hidden or dim, dim))

    def init_parameters(self, generator: torch.Generator):
        if self.use_warmup:
            self.WarmupMLP_0.init_parameters(generator)
        self.ode_fn.init_parameters(generator)

    def draw_noise(self, n: int, video_len: int, generator) -> dict:
        """The noise one call consumes, drawn from ``generator`` on its
        device: ``x0 (n, dim)``."""
        return {"x0": draw_normal((n, self.dim), generator, generator.device)}

    @property
    def uses_kernel(self) -> bool:
        """Whether the solve runs in K1 (JAX's Pallas gate)."""
        return (self.method == "rk4" and self.steps_per_interval == 1
                and self.adjoint == "checkpoint")

    def forward(self, n: int, video_len: int, *, generator=None,
                x0=None) -> torch.Tensor:
        l0, l1 = self.ode_fn.Dense_0, self.ode_fn.Dense_1
        if x0 is None:
            x0 = draw_normal((n, self.dim), generator, l0.weight.device)
        x = self.WarmupMLP_0(x0) if self.use_warmup else x0
        # built on the CPU: the kernel and the adaptive solver read their
        # times on the host
        ts = torch.linspace(0.0, 1.0, video_len)
        params = (l0.weight, l0.bias, l1.weight, l1.bias)
        if self.uses_kernel:
            zs = fused_rk4_motion(x, l0.weight.t().contiguous(), l0.bias,
                                  l1.weight.t().contiguous(), l1.bias, ts)
        elif self.method == "dopri5":
            zs = odeint_adaptive_adjoint(_mlp_field, x, ts, params,
                                         self.rtol, self.atol)
        elif self.adjoint == "backsolve":
            zs = odeint_backsolve(_mlp_field, x, ts.to(x.device), params,
                                  self.method, self.steps_per_interval)
        else:
            zs = odeint(_mlp_field, x, ts.to(x.device), params,
                        method=self.method,
                        steps_per_interval=self.steps_per_interval)
        return zs.transpose(0, 1)  # (n, T, dim)


MOTION_SAMPLERS = {"gru": MotionGRU, "ode": MotionODE}
NOT_PORTED = {"sde": "M10", "cde": "M10", "ode_rnn": "M10", "moe_ode": "M10"}


def make_motion_sampler(kind: str, dim: int, **kwargs) -> nn.Module:
    if kind in NOT_PORTED:
        raise NotImplementedError(
            f"the {kind!r} motion sampler waits for ROADMAP {NOT_PORTED[kind]}")
    if kind not in MOTION_SAMPLERS:
        raise ValueError(f"unknown motion sampler {kind!r}; choose from "
                         f"{sorted(MOTION_SAMPLERS) + sorted(NOT_PORTED)}")
    return MOTION_SAMPLERS[kind](dim=dim, **kwargs)
