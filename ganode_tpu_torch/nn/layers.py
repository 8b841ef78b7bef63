"""Core layers: flax-semantics BatchNorm, additive noise, GRU cell and small
MLPs (twins of ``ganode_tpu/nn/layers.py`` and of the ``nn.BatchNorm`` the JAX
models use).

Submodule and parameter names follow the flax tree (``Dense_0``, ``wi``...), so
``ganode_tpu_torch.bridge`` maps one onto the other by name.

Parameters are created uninitialised; ``init_parameters`` fills them from an
explicit ``torch.Generator`` with the JAX package's initialisers.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import comm


class _LeakyReLU(torch.autograd.Function):
    """``F.leaky_relu`` whose derivative at 0 is 1, as flax's
    ``jnp.where(x >= 0, x, slope * x)`` has it (torch's is the slope). The
    backward is made of differentiable ops, so a penalty's double backward
    runs through it."""

    @staticmethod
    def forward(ctx, x, negative_slope):
        ctx.save_for_backward(x)
        ctx.negative_slope = negative_slope
        return F.leaky_relu(x, negative_slope)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, grad, grad * ctx.negative_slope), None


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """The JAX package's ``leaky_relu``: the slope below 0, the identity from
    0 up, derivative included. Exact zeros reach it wherever DiffAugment's
    cutout and translation zero a whole conv window, and a gradient
    penalty differentiates there."""
    return _LeakyReLU.apply(x, negative_slope)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over dim 1 of an
    ``(N, C, ...)`` input: 2-D (NCHW) and 3-D (NCDHW) alike.

    Train mode normalises by the batch mean and the **biased** batch variance
    and moves the running statistics towards them, both biased:
    ``running = (1 - momentum) * running + momentum * batch``, momentum 0.1 in
    torch's terms (flax's 0.9). ``torch.nn.BatchNorm2d`` keeps the unbiased
    variance instead, so its running variance drifts from flax's by
    ``n / (n - 1)``. Eval mode normalises by the running statistics.

    The keys are ``nn.BatchNorm2d``'s (``weight``, ``bias``, ``running_mean``,
    ``running_var``, ``num_batches_tracked``), so the bridge maps flax's
    ``scale``/``bias``/``mean``/``var`` onto them as before. ``affine=False``
    is flax's ``use_scale=False, use_bias=False``: no ``weight`` or ``bias``,
    the statistics only (``nn.norm.ConditionalNorm``).

    An input in a lower precision than the float32 parameters (a bfloat16
    compute dtype) is normalised as flax does under a half-precision
    ``dtype`` (``flax/linen/normalization.py``, ``_compute_stats`` and
    ``_normalize``): statistics and normalisation in float32, the result in
    the input's dtype. ``F.batch_norm`` takes the mixed dtypes so; flax's
    variance is ``mean(x^2) - mean(x)^2``, torch's the two-pass one, equal
    up to float32 rounding, far below a bfloat16 step.

    Inside a parallel step (``parallel.comm.batch_stats_over``) train mode
    takes the statistics over the group's whole batch
    (``comm.global_moments``: one differentiable all-gather of each rank's
    mean and variance), so that every rank normalises and moves its running
    statistics as the single-device step on the global batch does.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        if affine:
            self.weight = nn.Parameter(torch.empty(num_features))
            self.bias = nn.Parameter(torch.empty(num_features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def reset_parameters(self):
        """flax's init: scale 1, bias 0, running mean 0 and variance 1."""
        if self.weight is not None:
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.num_batches_tracked.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = [0, *range(2, x.ndim)]
        group = comm.batch_stats_group()
        if group is not None:
            return self._forward_over(x, dims, group)
        with torch.no_grad():
            var, mean = torch.var_mean(x.to(self.running_mean.dtype),
                                       dim=dims, correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        # batch statistics only: F.batch_norm normalises by the biased
        # variance, as flax does, and updates no running buffer
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _forward_over(self, x: torch.Tensor, dims, group) -> torch.Tensor:
        """Train mode with the statistics of ``group``'s whole batch."""
        xf = x.to(self.running_mean.dtype)
        mean, var = comm.global_moments(xf, dims, group)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        if self.weight is not None:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class Noise(nn.Module):
    """Additive Gaussian noise ``x + sigma * eps`` when enabled, identity
    otherwise (``ganode_tpu/nn/layers.py:22-37``). ``eps`` is given as
    ``noise`` or drawn from ``generator``; the JAX layer draws it from its
    'noise' stream, which no seed of this package reproduces."""

    def __init__(self, use_noise: bool = False, sigma: float | None = 0.2):
        super().__init__()
        self.use_noise = use_noise
        self.sigma = sigma

    def forward(self, x: torch.Tensor, *, noise=None,
                generator=None) -> torch.Tensor:
        if not self.use_noise or self.sigma is None:
            return x
        if noise is None:
            if generator is None:
                raise ValueError("Noise is on: pass a torch.Generator or the "
                                 "noise itself")
            noise = torch.randn(x.shape, generator=generator,
                                device=x.device, dtype=x.dtype)
        return x + self.sigma * noise


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's ``lecun_normal``: truncated normal (2 std) with variance 1/fan_in.
    0.8796... is the std of a unit normal truncated to [-2, 2]."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class GRUCell(nn.Module):
    """GRU cell with torch gate semantics and fused ``[r | z | n]`` projections:

        r = sigmoid(x wi_r + bi_r + h wh_r + bh_r)
        z = sigmoid(x wi_z + bi_z + h wh_z + bh_z)
        n = tanh(x wi_n + bi_n + r * (h wh_n + bh_n))
        h' = (1 - z) * n + z * h

    ``wi (D, 3D)``, ``wh (D, 3D)``, ``bi``, ``bh (3D,)`` keep the JAX names and
    layout, which is also the layout the fused GRU kernel takes. Input and
    hidden widths are equal, as in every motion sampler.
    """

    def __init__(self, features: int):
        super().__init__()
        d = features
        self.features = d
        self.wi = nn.Parameter(torch.empty(d, 3 * d))
        self.wh = nn.Parameter(torch.empty(d, 3 * d))
        self.bi = nn.Parameter(torch.empty(3 * d))
        self.bh = nn.Parameter(torch.empty(3 * d))

    def init_parameters(self, generator: torch.Generator):
        lecun_normal_(self.wi, self.wi.shape[0], generator)
        nn.init.orthogonal_(self.wh, generator=generator)
        nn.init.zeros_(self.bi)
        nn.init.zeros_(self.bh)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        gi = x @ self.wi + self.bi
        gh = h @ self.wh + self.bh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


def init_dense(layer: nn.Linear, generator: torch.Generator):
    """flax ``nn.Dense`` defaults: lecun_normal kernel, zero bias."""
    lecun_normal_(layer.weight, layer.in_features, generator)
    nn.init.zeros_(layer.bias)


class MLP(nn.Module):
    """Dense stack with ``activation`` between layers and, with
    ``activate_final``, after the last (``ganode_tpu/nn/layers.py:72-89``):
    ``MLP(d, (h, d))`` is the ODE vector field Linear->Tanh->Linear. Layers
    are named ``Dense_0, Dense_1, ...`` as in flax."""

    def __init__(self, in_features: int, features: Sequence[int],
                 activation: Callable[[torch.Tensor], torch.Tensor] = torch.tanh,
                 activate_final: bool = False):
        super().__init__()
        self.n_layers = len(features)
        self.activation = activation
        self.activate_final = activate_final
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}", nn.Linear(in_features, f))
            in_features = f

    def init_parameters(self, generator: torch.Generator):
        for i in range(self.n_layers):
            init_dense(getattr(self, f"Dense_{i}"), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1 or self.activate_final:
                x = self.activation(x)
        return x


class WarmupMLP(nn.Module):
    """The latent warm-up net every NDE motion sampler shares:
    Linear(d, 64) -> LeakyReLU(0.2) -> Linear(64, d) -> LeakyReLU(0.2)."""

    def __init__(self, dim: int, hidden: int = 64):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, hidden)
        self.Dense_1 = nn.Linear(hidden, dim)

    def init_parameters(self, generator: torch.Generator):
        init_dense(self.Dense_0, generator)
        init_dense(self.Dense_1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.Dense_1(leaky_relu(self.Dense_0(x))))
