"""Motion-latent samplers (twins of ``MotionODE`` and ``MotionGRU`` in
``ganode_tpu/models/motion.py``). Contract:

    sampler(n, video_len, *, generator=None, <noise>=None) -> (n, video_len, dim)

The JAX modules draw their noise inside from ``make_rng("sample")``; the two
frameworks give different numbers from one seed, so here the noise is an
optional explicit tensor (``x0`` for the ODE, ``h0`` and ``e`` for the GRU),
drawn from ``generator`` only when absent.

On the serving path each sampler runs its whole recursion in one CUDA kernel
(``ganode_tpu_torch.ops``): the ODE wherever the JAX package would take its
Pallas kernel (rk4, one step per interval), the GRU always.
On CPU tensors the same calls run the kernels' plain versions.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import GRUCell, MLP, WarmupMLP
from ..ode import FIXED_GRID, odeint
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


class MotionODE(nn.Module):
    """Neural-ODE motion: ``x ~ N(0, I)`` -> warm-up MLP ->
    ``odeint(f, x, linspace(0, 1, T))`` with ``f = Linear(d, d) -> tanh ->
    Linear(d, d)``, autonomous (rk4 by default: 60 evaluations at T=16).

    rk4 runs in the fused RK4 kernel (K1), as the JAX package's Pallas kernel
    does; the other fixed-grid methods run ``odeint``. The JAX module's other
    options (hidden width, no warm-up, sub-steps, the backsolve adjoint) are
    set by no config and come with the code that needs them (ROADMAP M9).
    """

    def __init__(self, dim: int, method: str = "rk4"):
        super().__init__()
        if method == "dopri5":
            raise NotImplementedError(
                "adaptive (dopri5) motion waits for ROADMAP M9")
        if method not in FIXED_GRID:
            raise ValueError(f"unknown motion method {method!r}; choose from "
                             f"{sorted(FIXED_GRID)}")
        self.dim = dim
        self.method = method
        self.WarmupMLP_0 = WarmupMLP(dim)
        self.ode_fn = MLP(dim, (dim, dim))

    def init_parameters(self, generator: torch.Generator):
        self.WarmupMLP_0.init_parameters(generator)
        self.ode_fn.init_parameters(generator)

    def forward(self, n: int, video_len: int, *, generator=None,
                x0=None) -> torch.Tensor:
        l0, l1 = self.ode_fn.Dense_0, self.ode_fn.Dense_1
        if x0 is None:
            x0 = draw_normal((n, self.dim), generator, l0.weight.device)
        x = self.WarmupMLP_0(x0)
        # built on the CPU: the kernel reads only its uniform step, on the host
        ts = torch.linspace(0.0, 1.0, video_len)
        if self.method == "rk4":
            zs = fused_rk4_motion(x, l0.weight.t().contiguous(), l0.bias,
                                  l1.weight.t().contiguous(), l1.bias, ts)
        else:
            zs = odeint(lambda t, y: self.ode_fn(y), x, ts.to(x.device),
                        method=self.method)
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
