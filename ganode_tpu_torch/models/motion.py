"""Motion-latent samplers (twins of the samplers in
``ganode_tpu/models/motion.py``). Contract:

    sampler(n, video_len, *, generator=None, <noise>=None) -> (n, video_len, dim)

The JAX modules draw their noise inside from ``make_rng("sample")``; the two
frameworks give different numbers from one seed, so here the noise is an
optional explicit tensor, drawn from ``generator`` only when absent, and each
sampler's ``draw_noise`` returns what one call consumes: ``x0`` (ODE, MoE
ODE), ``x0`` and the Brownian increments ``dW`` (SDE), ``noise`` (CDE), ``h0``
and ``e`` (GRU, ODE-RNN).

The ODE and GRU samplers run their whole recursion in one CUDA kernel
(``ganode_tpu_torch.ops``) wherever the JAX package would take its Pallas
kernel: the ODE for rk4 with one step per interval and the checkpoint
adjoint, the GRU always. Everything else runs ``ode``'s plain solvers, as
JAX runs them without Pallas: the ODE's other options, the SDE, CDE, MoE ODE
and ODE-RNN. On CPU tensors the kernels' calls run their plain versions.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import GRUCell, MLP, WarmupMLP, leaky_relu
from ..nn.moe import MoEField, moe_field
from ..ode import (FIXED_GRID, brownian_increments, cdeint,
                   hermite_cubic_coefficients, odeint, odeint_adaptive_adjoint,
                   odeint_backsolve, odeint_final, sdeint,
                   sdeint_reversible_adjoint)
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


def _check_ode_options(method: str, adjoint: str):
    if method != "dopri5" and method not in FIXED_GRID:
        raise ValueError(f"unknown motion method {method!r}; choose from "
                         f"{sorted(FIXED_GRID) + ['dopri5']}")
    if adjoint not in ("checkpoint", "backsolve"):
        raise ValueError(f"unknown adjoint {adjoint!r}; choose "
                         "'checkpoint' or 'backsolve'")


def _solve_ode(m: nn.Module, field, x, ts, params) -> torch.Tensor:
    """The plain solve of an ODE sampler ``m`` (its ``method``,
    ``steps_per_interval``, ``adjoint``, ``rtol``, ``atol``) of
    ``field(t, y, params)`` from ``x`` over the host grid ``ts``: dopri5
    with the continuous adjoint, the fixed-grid continuous adjoint, or
    ``odeint`` and autograd through it (the discrete adjoint, as JAX's
    checkpointed scan differentiates) -> ``(T, n, dim)``."""
    if m.method == "dopri5":
        return odeint_adaptive_adjoint(field, x, ts, params, m.rtol, m.atol)
    if m.adjoint == "backsolve":
        return odeint_backsolve(field, x, ts, params, m.method,
                                m.steps_per_interval)
    return odeint(field, x, ts, params, method=m.method,
                  steps_per_interval=m.steps_per_interval)


def _mlp_params(mlp: MLP) -> tuple:
    return (mlp.Dense_0.weight, mlp.Dense_0.bias, mlp.Dense_1.weight,
            mlp.Dense_1.bias)


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
        _check_ode_options(method, adjoint)
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
        # built on the CPU: the kernel and the solvers read their times on
        # the host; float64 for a float64 solve, as JAX's under x64
        ts = torch.linspace(0.0, 1.0, video_len, dtype=torch.float64
                            if x.dtype == torch.float64 else torch.float32)
        params = _mlp_params(self.ode_fn)
        if self.uses_kernel:
            zs = fused_rk4_motion(x, l0.weight.t().contiguous(), l0.bias,
                                  l1.weight.t().contiguous(), l1.bias, ts)
        else:
            zs = _solve_ode(self, _mlp_field, x, ts, params)
        return zs.transpose(0, 1)  # (n, T, dim)


class MotionSDE(nn.Module):
    """Neural-SDE motion: ``x ~ N(0, I)`` -> warm-up MLP -> the Ito SDE
    ``dz = f(z) dt + g(z) dW`` over ``linspace(0, 1, T)`` with diagonal noise,
    ``f`` (``drift_fn``) and ``g`` (``diffusion_fn``) ``Linear -> tanh ->
    Linear``, at most ``dt`` per internal step (``ganode_tpu/models/motion.py:
    143-195``; 45 substeps at T = 16 and the default dt).

    ``method``: ``euler`` (the reference's), ``milstein``,
    ``reversible_heun``, or ``reversible_heun_adjoint`` (the same scheme with
    the exact O(1)-memory backward, ``ode.sdeint_reversible_adjoint``). The
    increments ``dW (K, n, dim)`` are scaled by ``sqrt(|h|)``
    (``ode.brownian_increments``).
    """

    METHODS = ("euler", "milstein", "reversible_heun",
               "reversible_heun_adjoint")

    def __init__(self, dim: int, dim_hidden: int | None = None,
                 use_warmup: bool = True, dt: float = 2.5e-2,
                 method: str = "euler"):
        super().__init__()
        if method not in self.METHODS:
            raise ValueError(f"unknown SDE motion method {method!r}; choose "
                             f"from {list(self.METHODS)}")
        self.dim, self.dt, self.method = dim, dt, method
        if use_warmup:
            self.WarmupMLP_0 = WarmupMLP(dim)
        self.use_warmup = use_warmup
        self.drift_fn = MLP(dim, (dim_hidden or dim, dim))
        self.diffusion_fn = MLP(dim, (dim_hidden or dim, dim))

    def init_parameters(self, generator: torch.Generator):
        if self.use_warmup:
            self.WarmupMLP_0.init_parameters(generator)
        self.drift_fn.init_parameters(generator)
        self.diffusion_fn.init_parameters(generator)

    @staticmethod
    def times(video_len: int) -> np.ndarray:
        return np.linspace(0.0, 1.0, video_len)

    def draw_noise(self, n: int, video_len: int, generator) -> dict:
        """``x0 (n, dim)`` and ``dW (K, n, dim)``, drawn from ``generator``
        on its device."""
        return {"x0": draw_normal((n, self.dim), generator, generator.device),
                "dW": brownian_increments(self.times(video_len), self.dt,
                                          (n, self.dim), generator)}

    def forward(self, n: int, video_len: int, *, generator=None, x0=None,
                dW=None) -> torch.Tensor:
        dev = self.drift_fn.Dense_0.weight.device
        if x0 is None:
            x0 = draw_normal((n, self.dim), generator, dev)
        ts = self.times(video_len)
        if dW is None:
            if generator is None:
                raise ValueError("no torch.Generator given: pass one, or "
                                 "pass dW explicitly")
            dW = brownian_increments(ts, self.dt, (n, self.dim), generator)
        x = self.WarmupMLP_0(x0) if self.use_warmup else x0
        params = _mlp_params(self.drift_fn) + _mlp_params(self.diffusion_fn)
        drift = lambda t, y, p: _mlp_field(t, y, p[:4])      # noqa: E731
        diffusion = lambda t, y, p: _mlp_field(t, y, p[4:])  # noqa: E731
        if self.method == "reversible_heun_adjoint":
            zs = sdeint_reversible_adjoint(drift, diffusion, x, ts, dW, params,
                                           dt=self.dt)
        else:
            zs = sdeint(drift, diffusion, x, ts, dW, params, dt=self.dt,
                        method=self.method)
        return zs.transpose(0, 1)


class MotionCDE(nn.Module):
    """Neural-CDE motion: the path ``(t, noise_t)`` over ``t = 0 .. T-1`` is
    fitted with a Hermite cubic spline (backward differences); the hidden
    state starts at ``z0 = init_net(X(0))`` and follows ``dz = f(z) dX`` with
    ``f(z) = tanh(cde_fn(z))`` reshaped to ``(dim, cde_input_dim)`` in
    row-major order (``ganode_tpu/models/motion.py:198-237``): ``init_net``
    Linear(2, 64) -> LeakyReLU(0.2) -> Linear(64, dim) -> LeakyReLU(0.2),
    ``cde_fn`` Linear(dim, field_width) -> ReLU -> Linear(field_width,
    2 dim). ``method`` is any fixed-grid one."""

    def __init__(self, dim: int, cde_input_dim: int = 2,
                 field_width: int = 128, method: str = "rk4"):
        super().__init__()
        if method not in FIXED_GRID:
            raise ValueError(f"unknown CDE motion method {method!r}; choose "
                             f"from {sorted(FIXED_GRID)}")
        self.dim, self.cde_input_dim, self.method = dim, cde_input_dim, method
        self.init_net = MLP(cde_input_dim, (64, dim), activation=leaky_relu,
                            activate_final=True)
        self.cde_fn = MLP(dim, (field_width, dim * cde_input_dim),
                          activation=torch.relu)

    def init_parameters(self, generator: torch.Generator):
        self.init_net.init_parameters(generator)
        self.cde_fn.init_parameters(generator)

    def draw_noise(self, n: int, video_len: int, generator) -> dict:
        """The path's noise ``(n, video_len)``, drawn from ``generator`` on
        its device."""
        return {"noise": draw_normal((n, video_len), generator,
                                     generator.device)}

    def _matrix_field(self, t, z):
        out = torch.tanh(self.cde_fn(z))
        return out.reshape(*z.shape[:-1], self.dim, self.cde_input_dim)

    def forward(self, n: int, video_len: int, *, generator=None,
                noise=None) -> torch.Tensor:
        dev = self.cde_fn.Dense_0.weight.device
        if noise is None:
            noise = draw_normal((n, video_len), generator, dev)
        ts = np.arange(video_len, dtype=np.float32)
        t_path = torch.as_tensor(ts, device=dev,
                                 dtype=noise.dtype).expand(n, video_len)
        spline = hermite_cubic_coefficients(
            torch.stack([t_path, noise], dim=-1), ts)        # (n, T, 2)
        z0 = self.init_net(spline.evaluate(ts[0]))
        zs = cdeint(spline, z0, self._matrix_field, ts, method=self.method)
        return zs.transpose(0, 1)


class MotionMoEODE(nn.Module):
    """Mixture-of-experts Neural-ODE motion (``ganode_tpu/models/motion.py:
    240-288``): ``x ~ N(0, I)`` -> warm-up MLP -> ``odeint(f, x, linspace(0,
    1, T))`` with ``f`` the gated mixture of ``n_experts`` tanh-MLP fields
    (``nn.MoEField``, ``top_k`` 0 dense). The solve options are
    ``MotionODE``'s; no kernel runs, as in JAX."""

    def __init__(self, dim: int, dim_hidden: int | None = None,
                 n_experts: int = 4, top_k: int = 0, use_warmup: bool = True,
                 method: str = "rk4", steps_per_interval: int = 1,
                 adjoint: str = "checkpoint", rtol: float = 1e-5,
                 atol: float = 1e-6):
        super().__init__()
        _check_ode_options(method, adjoint)
        self.dim, self.top_k = dim, top_k
        self.method = method
        self.steps_per_interval = steps_per_interval
        self.adjoint = adjoint
        self.rtol, self.atol = rtol, atol
        if use_warmup:
            self.WarmupMLP_0 = WarmupMLP(dim)
        self.use_warmup = use_warmup
        self.moe_fn = MoEField(dim, dim_hidden or dim, n_experts, top_k)

    def init_parameters(self, generator: torch.Generator):
        if self.use_warmup:
            self.WarmupMLP_0.init_parameters(generator)
        self.moe_fn.init_parameters(generator)

    def draw_noise(self, n: int, video_len: int, generator) -> dict:
        """``x0 (n, dim)``, drawn from ``generator`` on its device."""
        return {"x0": draw_normal((n, self.dim), generator, generator.device)}

    def _field(self, t, y, p):
        return moe_field(y, *p, top_k=self.top_k, ep=self.moe_fn.ep)

    def forward(self, n: int, video_len: int, *, generator=None,
                x0=None) -> torch.Tensor:
        if x0 is None:
            x0 = draw_normal((n, self.dim), generator,
                             self.moe_fn.expert_w1.device)
        x = self.WarmupMLP_0(x0) if self.use_warmup else x0
        ts = torch.linspace(0.0, 1.0, video_len)
        zs = _solve_ode(self, self._field, x, ts, self.moe_fn.field_params())
        return zs.transpose(0, 1)  # (n, T, dim)


class MotionODERNN(nn.Module):
    """ODE-RNN motion (``ganode_tpu/models/motion.py:291-333``): ``h_0 ~
    N(0, I)``; per frame, ``h' = odeint_final(f, h, 0, 1)`` (``solve_steps``
    steps of ``method``; one rk4 step by default) with ``f`` (``ode_fn``)
    ``Linear -> tanh -> Linear``, then ``h = GRU(e_t, h')`` with fresh noise
    ``e_t ~ N(0, I)``; output ``[h_1..h_T]``. The ODE solve between the GRU
    cells keeps the fused GRU kernel off this path, as in JAX."""

    def __init__(self, dim: int, dim_hidden: int | None = None,
                 method: str = "rk4", solve_steps: int = 1):
        super().__init__()
        if method not in FIXED_GRID:
            raise ValueError(f"unknown ODE-RNN motion method {method!r}; "
                             f"choose from {sorted(FIXED_GRID)}")
        self.dim, self.method, self.solve_steps = dim, method, solve_steps
        self.ode_fn = MLP(dim, (dim_hidden or dim, dim))
        self.gru = GRUCell(dim)

    def init_parameters(self, generator: torch.Generator):
        self.ode_fn.init_parameters(generator)
        self.gru.init_parameters(generator)

    def draw_noise(self, n: int, video_len: int, generator) -> dict:
        """``h0 (n, dim)`` and ``e (video_len, n, dim)``, drawn from
        ``generator`` on its device."""
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
        params = _mlp_params(self.ode_fn)
        h, hs = h0, []
        for t in range(video_len):
            h = self.gru(odeint_final(_mlp_field, h, 0.0, 1.0, params,
                                      method=self.method,
                                      num_steps=self.solve_steps), e[t])
            hs.append(h)
        return torch.stack(hs, dim=1)  # (n, T, dim)


MOTION_SAMPLERS = {"gru": MotionGRU, "ode": MotionODE, "sde": MotionSDE,
                   "cde": MotionCDE, "ode_rnn": MotionODERNN,
                   "moe_ode": MotionMoEODE}


def make_motion_sampler(kind: str, dim: int, **kwargs) -> nn.Module:
    if kind not in MOTION_SAMPLERS:
        raise ValueError(f"unknown motion sampler {kind!r}; choose from "
                         f"{sorted(MOTION_SAMPLERS)}")
    return MOTION_SAMPLERS[kind](dim=dim, **kwargs)
