"""Class-conditional batch normalization (twin of ``ganode_tpu/nn/norm.py``).

An affine-less flax-semantics BatchNorm (``nn.layers.BatchNorm(affine=
False)``: statistics only, momentum 0.9 in flax's terms, eps 1e-5) followed
by a per-sample ``(gamma, beta)`` made from a condition vector by two dense
layers, ``Dense_0`` (kernel N(0, 0.02), bias ones: gamma starts near 1) and
``Dense_1`` (zeros: beta starts at 0). Channels-first: ``x (N, C, ...)``.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import BatchNorm


class ConditionalNorm(nn.Module):
    """``gamma(condition) * BN(x) + beta(condition)``; train mode (the
    module's ``training``) normalises by batch statistics and advances the
    running ones, eval mode uses the running ones. ``condition`` is
    ``(N, n_condition)``, one row per sample of ``x``."""

    def __init__(self, features: int, n_condition: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.features = features
        self.BatchNorm_0 = BatchNorm(features, eps=eps, momentum=momentum,
                                     affine=False)
        self.Dense_0 = nn.Linear(n_condition, features)
        self.Dense_1 = nn.Linear(n_condition, features)

    def init_parameters(self, generator: torch.Generator):
        self.BatchNorm_0.reset_parameters()
        nn.init.normal_(self.Dense_0.weight, 0.0, 0.02, generator=generator)
        nn.init.ones_(self.Dense_0.bias)
        nn.init.zeros_(self.Dense_1.weight)
        nn.init.zeros_(self.Dense_1.bias)

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        h = self.BatchNorm_0(x)
        spatial = (1,) * (x.ndim - 2)
        gamma = self.Dense_0(condition).view(condition.shape[0], -1, *spatial)
        beta = self.Dense_1(condition).view(condition.shape[0], -1, *spatial)
        return gamma * h + beta
