"""Core layers: GRU cell and small MLPs (twins of ``ganode_tpu/nn/layers.py``).

Submodule and parameter names follow the flax tree (``Dense_0``, ``wi``...), so
``ganode_tpu_torch.bridge`` maps one onto the other by name. ``Noise`` belongs
to the discriminators and comes with them (ROADMAP M5).

Parameters are created uninitialised; ``init_parameters`` fills them from an
explicit ``torch.Generator`` with the JAX package's initialisers.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


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
    """Dense stack with tanh between layers: ``MLP(d, (h, d))`` is the ODE
    vector field Linear->Tanh->Linear. Layers are named ``Dense_0, Dense_1,
    ...`` as in flax. (The JAX MLP's other activations and ``activate_final``
    come with the samplers that use them, ROADMAP M10.)"""

    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        self.n_layers = len(features)
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}", nn.Linear(in_features, f))
            in_features = f

    def init_parameters(self, generator: torch.Generator):
        for i in range(self.n_layers):
            init_dense(getattr(self, f"Dense_{i}"), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1:
                x = torch.tanh(x)
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
