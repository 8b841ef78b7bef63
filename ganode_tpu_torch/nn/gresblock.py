"""BigGAN/DVD-GAN-style residual blocks and their continuous-depth ODE variant
(twin of ``ganode_tpu/nn/gresblock.py``), channels-first.

``GResBlock``: CBN -> act -> upsample -> SN conv 3x3 -> CBN -> act -> SN conv
3x3 (-> avg pool), plus a skip: upsample -> SN conv 1x1 (-> avg pool). Time
is folded into the batch by the caller, so each frame runs on its own.

``ODEGResBlock``: CBN -> act -> upsample, then the channels zero-padded (in <
out) or projected down by a 1x1 SN conv (in > out), then the conv vector
field ``Conv2dODEField`` integrated over [0, 1] by ``ode.odeint_final``.

**The field's conditional norm uses the batch's statistics, in eval mode
too.** ``stateless_cbn`` has no running state, so an ``ODEGResBlock``'s
output for one sample depends on the other samples of its call: a served
``odegres64`` frame depends on which frames share its trunk call, as in
JAX. The generator decodes all ``n * T`` frames of ``sample_videos(n)`` (all
``n`` of ``sample_images(n)``) in one trunk call, as JAX's samplers do; do
not chunk the trunk or loop over clips, and compare with JAX at the same n.

Spectral norm of the field: its power-iteration state ``u0``, ``u1`` are
buffers of the block (JAX's ``spectral`` collection at the block level, not
inside an ``SNConv``). ``normalized_kernels`` runs once per block forward;
every evaluation of the solve reuses its kernels, and the state advances
once per train-mode forward, never per evaluation (and never at init, which
here is ``init_parameters``).

Memory: JAX's ``odeint_final`` recomputes each step in the backward pass
(``jax.checkpoint`` per step, its default). The port keeps every stage for
autograd: on one H100 at B=32, T=16 the ``ucf_odegres`` step peaks at 53.5
GiB of 80 that way (``PERF.md``), which leaves room, and recomputing would
cost 14-23 % of the step.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ode import odeint_final
from ..parallel import comm
from ..ode import tableaus as tb
from .layers import lecun_normal_
from .norm import ConditionalNorm
from .spectral import SNConv, _l2norm, spectral_normalize


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsampling of ``(N, C, H, W)`` by an integer
    factor: output row ``i`` reads input row ``i // factor``, as
    ``jax.image.resize(method="nearest")`` does."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def avg_pool(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Average pooling with window = stride = ``factor``, no padding (flax's
    ``avg_pool`` VALID)."""
    return F.avg_pool2d(x, factor, factor)


class GResBlock(nn.Module):
    """Up/down residual block with spectral norm and conditional BN.

    Input ``(B*T, C_in, H, W)``, condition ``(B*T, n_condition)``; the
    output is scaled by ``upsample_factor`` (or ``1 / downsample_factor``,
    which turns off the upsampling and the conditional norms) with
    ``out_channels`` channels. Train mode (``training``) normalises by the
    batch and advances every ``u``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Sequence[int] = (3, 3), n_condition: int = 96,
                 use_bn: bool = True,
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.relu,
                 upsample_factor: int = 2, downsample_factor: int = 1):
        super().__init__()
        self.up = upsample_factor if downsample_factor == 1 else 1
        self.down = downsample_factor
        self.bn = use_bn and downsample_factor == 1
        self.activation = activation
        if self.bn:
            self.ConditionalNorm_0 = ConditionalNorm(in_channels, n_condition)
        self.SNConv_0 = SNConv(in_channels, out_channels, kernel_size,
                               padding=1)
        if self.bn:
            self.ConditionalNorm_1 = ConditionalNorm(out_channels, n_condition)
        self.SNConv_1 = SNConv(out_channels, out_channels, kernel_size,
                               padding=1)
        self.SNConv_2 = SNConv(in_channels, out_channels, (1, 1))

    def init_parameters(self, generator: torch.Generator):
        for m in self.children():
            m.init_parameters(generator)

    def forward(self, x: torch.Tensor, condition=None) -> torch.Tensor:
        train = self.training
        out = self.ConditionalNorm_0(x, condition) if self.bn else x
        out = self.activation(out)
        if self.up != 1:
            out = upsample_nearest(out, self.up)
        out = self.SNConv_0(out, update_stats=train)
        if self.bn:
            out = self.ConditionalNorm_1(out, condition)
        out = self.SNConv_1(self.activation(out), update_stats=train)
        if self.down != 1:
            out = avg_pool(out, self.down)

        skip = upsample_nearest(x, self.up) if self.up != 1 else x
        skip = self.SNConv_2(skip, update_stats=train)
        if self.down != 1:
            skip = avg_pool(skip, self.down)
        return out + skip


def stateless_cbn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Conditional norm of ``(N, C, ...)`` by the batch's own statistics
    (biased variance, no running state), ``gamma``/``beta`` ``(N, C)``:
    what train-mode BatchNorm computes inside the ODE field."""
    dims = (0, *range(2, x.ndim))
    group = comm.batch_stats_group()
    if group is not None:  # a parallel step: the statistics of its batch
        mean, var = comm.global_moments(x, dims, group, keepdim=True)
    else:
        var, mean = torch.var_mean(x, dim=dims, keepdim=True, correction=0)
    h = (x - mean) * torch.rsqrt(var + eps)
    spatial = (1,) * (x.ndim - 2)
    return (gamma.view(gamma.shape[0], -1, *spatial) * h
            + beta.view(beta.shape[0], -1, *spatial))


class Conv2dODEField(nn.Module):
    """The vector field of the continuous-depth block, from raw parameters
    (JAX's names): ``f(t, y) = conv(t * act(CBN(conv(t * y, k0n) + b0)),
    k1n) + b1``, 3x3 convolutions padded by 1, the norm's ``gamma =
    condition @ embed_gamma + embed_gamma_b`` and ``beta = condition @
    embed_beta``. ``k0``/``k1`` are ``(C, C, 3, 3)``, torch's layout of
    JAX's HWIO kernels (correlations both, not flipped)."""

    def __init__(self, channels: int, n_condition: int = 96,
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.relu):
        super().__init__()
        c = self.channels = channels
        self.activation = activation
        self.k0 = nn.Parameter(torch.empty(c, c, 3, 3))
        self.b0 = nn.Parameter(torch.empty(c))
        self.k1 = nn.Parameter(torch.empty(c, c, 3, 3))
        self.b1 = nn.Parameter(torch.empty(c))
        self.embed_gamma = nn.Parameter(torch.empty(n_condition, c))
        self.embed_gamma_b = nn.Parameter(torch.empty(c))
        self.embed_beta = nn.Parameter(torch.empty(n_condition, c))

    def init_parameters(self, generator: torch.Generator):
        fan_in = 9 * self.channels
        lecun_normal_(self.k0, fan_in, generator)
        nn.init.zeros_(self.b0)
        lecun_normal_(self.k1, fan_in, generator)
        nn.init.zeros_(self.b1)
        nn.init.normal_(self.embed_gamma, 0.0, 0.02, generator=generator)
        nn.init.ones_(self.embed_gamma_b)
        nn.init.zeros_(self.embed_beta)

    def normalized_kernels(self, u0: torch.Tensor, u1: torch.Tensor,
                           n_iter: int = 1):
        """``(k0 / sigma0, k1 / sigma1, u0_new, u1_new)``. The matricization
        is torch's ``(C, Ci * 3 * 3)`` where JAX's is ``(C, 3 * 3 * Ci)``:
        the same rows with their columns permuted, so sigma and ``u`` agree
        up to rounding (only ``v``, which is not stored, permutes)."""
        c = self.channels
        s0, u0n, _ = spectral_normalize(self.k0.reshape(c, -1), u0, n_iter)
        s1, u1n, _ = spectral_normalize(self.k1.reshape(c, -1), u1, n_iter)
        return self.k0 / s0, self.k1 / s1, u0n, u1n

    def rhs(self, t, y: torch.Tensor, condition: torch.Tensor,
            k0n: torch.Tensor, k1n: torch.Tensor) -> torch.Tensor:
        out = F.conv2d(y * t, k0n, self.b0, padding=1)
        gamma = condition @ self.embed_gamma + self.embed_gamma_b
        beta = condition @ self.embed_beta
        out = self.activation(stateless_cbn(out, gamma, beta))
        return F.conv2d(out * t, k1n, self.b1, padding=1)


class ODEGResBlock(nn.Module):
    """Continuous-depth GResBlock: CBN -> act -> upsample -> channels to
    ``out_channels`` -> the conv field integrated over [0, 1] in
    ``num_steps`` steps of ``method``, ``stages * num_steps`` evaluations
    (``nfe``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 n_condition: int = 96, upsample_factor: int = 2,
                 method: str = "rk4", num_steps: int = 4,
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.relu):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.upsample_factor = upsample_factor
        self.method, self.num_steps = method, num_steps
        self.activation = activation
        self.ConditionalNorm_0 = ConditionalNorm(in_channels, n_condition)
        if in_channels > out_channels:
            # the reference block assumed in <= out; a channel-decreasing
            # stack projects down before the flow, as the JAX package does
            self.proj_down = SNConv(in_channels, out_channels, (1, 1))
        self.Conv2dODEField_0 = Conv2dODEField(out_channels, n_condition,
                                               activation)
        self.register_buffer("u0", torch.empty(out_channels))
        self.register_buffer("u1", torch.empty(out_channels))

    @property
    def nfe(self) -> int:
        return tb.FIXED_GRID[self.method].stages * self.num_steps

    def init_parameters(self, generator: torch.Generator):
        for m in self.children():
            m.init_parameters(generator)
        with torch.no_grad():
            for u in (self.u0, self.u1):
                u.copy_(_l2norm(torch.randn(u.shape, generator=generator)))

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        train = self.training
        out = self.activation(self.ConditionalNorm_0(x, condition))
        if self.upsample_factor != 1:
            out = upsample_nearest(out, self.upsample_factor)
        pad = self.out_channels - self.in_channels
        if pad > 0:  # ANODE-style zero augmentation
            out = torch.cat([out, out.new_zeros(
                (out.shape[0], pad) + out.shape[2:])], dim=1)
        elif pad < 0:
            out = self.proj_down(out, update_stats=train)

        field = self.Conv2dODEField_0
        k0n, k1n, u0n, u1n = field.normalized_kernels(self.u0, self.u1)
        if train:
            with torch.no_grad():
                self.u0.copy_(u0n)
                self.u1.copy_(u1n)
        return odeint_final(
            lambda t, y: field.rhs(t, y, condition, k0n, k1n), out, 0.0, 1.0,
            method=self.method, num_steps=self.num_steps)
