"""Spectral normalization with explicit power-iteration state (twin of
``ganode_tpu/nn/spectral.py``).

The weight is divided by its largest singular value, estimated by power
iteration on the ``(out, fan_in)`` matricization; the estimate ``u`` is a
buffer named ``u`` (the JAX ``'spectral'`` collection) that advances only
when the caller passes ``update_stats=True``, as JAX's ``update_stats=train``.
Every forward runs one iteration from the stored ``u``, stored or not, so an
eval-mode pass (the gradient penalty's) normalises by the iterate it did not
keep.

``torch.nn.utils.spectral_norm`` is not used: its eps is ``max(||v||, eps)``
(here ``||v|| + eps``), it ties the update to ``module.training`` and it keeps
a ``v`` buffer that JAX does not have.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3d_first
from .layers import lecun_normal_


def _l2norm(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``v / (||v|| + eps)``; not ``F.normalize``, which divides by
    ``max(||v||, eps)``."""
    return v / (torch.linalg.vector_norm(v) + eps)


def spectral_normalize(w2d: torch.Tensor, u: torch.Tensor, n_iter: int = 1):
    """``n_iter`` power-iteration refinements of ``w2d (out, fan_in)`` from
    ``u`` -> ``(sigma, u_new, v_new)``. The iterates are constants (computed
    without gradient, as the reference's ``.data`` updates); ``sigma = u @ (w2d
    @ v)`` keeps its gradient with respect to ``w2d``."""
    with torch.no_grad():
        w = w2d.detach()
        for _ in range(n_iter):
            v = _l2norm(w.t() @ u)
            u = _l2norm(w @ v)
    sigma = u @ (w2d @ v)
    return sigma, u, v


class _SNWeight(nn.Module):
    """A weight ``(out, ...)`` with its power-iteration state ``u (out,)``."""

    n_power_iterations: int

    def init_u(self, generator: torch.Generator):
        """``u`` from N(0, I), normalised, as JAX's initialiser draws it."""
        with torch.no_grad():
            self.u.copy_(_l2norm(torch.randn(self.u.shape,
                                             generator=generator)))

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        """``weight / sigma``, advancing ``u`` when ``update_stats``.

        The matricization is torch's ``(out, in * k...)``, where the JAX
        package's is ``(out, k... * in)``: the same rows with their columns
        permuted, which leaves ``u`` and ``sigma`` unchanged (only ``v``
        permutes with the columns)."""
        w2d = self.weight.reshape(self.weight.shape[0], -1)
        sigma, u_new, _ = spectral_normalize(w2d, self.u,
                                             self.n_power_iterations)
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u_new)
        return self.weight / sigma


class SNConv(_SNWeight):
    """Spectrally normalized 2-D or 3-D convolution over channels-first
    input, with flax's ``lecun_normal`` kernel init and zero bias. ``padding``
    is one symmetric pad per spatial axis. The video critic's first-layer
    geometry (4x4x4, stride (1, 2, 2), padding (0, 1, 1), at most 16 input
    channels) goes through ``ops.conv3d_first``, as in JAX."""

    def __init__(self, in_ch: int, features: int, kernel_size: Sequence[int],
                 strides: Sequence[int] | int = 1,
                 padding: Sequence[int] | int = 0, use_bias: bool = True,
                 n_power_iterations: int = 1):
        super().__init__()
        ksize = tuple(kernel_size)
        nd = len(ksize)
        if nd not in (2, 3):
            raise ValueError(f"SNConv is 2-D or 3-D, got kernel {ksize}")
        as_tuple = lambda v: tuple(v) if isinstance(v, (tuple, list)) else (v,) * nd
        self.strides: Tuple[int, ...] = as_tuple(strides)
        self.padding: Tuple[int, ...] = as_tuple(padding)
        self.n_power_iterations = n_power_iterations
        self.weight = nn.Parameter(torch.empty(features, in_ch, *ksize))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.register_buffer("u", torch.empty(features))
        self._conv = F.conv2d if nd == 2 else F.conv3d
        self._first_video = (ksize == (4, 4, 4) and self.strides == (1, 2, 2)
                             and self.padding == (0, 1, 1) and in_ch <= 16)

    def init_parameters(self, generator: torch.Generator):
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        self.init_u(generator)

    def forward(self, x: torch.Tensor, *, update_stats: bool) -> torch.Tensor:
        w = self.normalized_weight(update_stats)
        if self._first_video:
            y = conv3d_first(x.to(w.dtype), w)
        else:
            y = self._conv(x.to(w.dtype), w, stride=self.strides,
                           padding=self.padding)
        if self.bias is not None:
            y = y + self.bias.view(-1, *([1] * (y.ndim - 2)))
        return y


class SNDense(_SNWeight):
    """Spectrally normalized dense layer (``nn.Linear`` layout ``(out,
    in)``, the JAX kernel transposed)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 n_power_iterations: int = 1):
        super().__init__()
        self.n_power_iterations = n_power_iterations
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.register_buffer("u", torch.empty(features))

    def init_parameters(self, generator: torch.Generator):
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        self.init_u(generator)

    def forward(self, x: torch.Tensor, *, update_stats: bool) -> torch.Tensor:
        w = self.normalized_weight(update_stats)
        return F.linear(x.to(w.dtype), w, self.bias)
