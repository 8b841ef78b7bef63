"""Mixture-of-experts ODE vector field (twin of ``ganode_tpu/nn/moe.py``):

    f(y) = sum_e softmax(gate(y))_e * f_e(y),
    f_e  = Linear(d, h) -> tanh -> Linear(h, d)

over ``(B, d)`` states, with the experts' parameters stacked on a leading
axis as flax lays them out (``expert_w1 (E, d, h)``, ``expert_b1 (E, h)``,
``expert_w2 (E, h, d)``, ``expert_b2 (E, d)``) and the ``gate`` a Linear.
Dense dispatch: every expert runs on the whole batch, three einsums over the
expert axis, as the JAX field computes them. ``top_k > 0`` keeps, per row,
the logits at or above the k-th largest (JAX's threshold rule: on ties more
than k experts stay) and masks the rest before the softmax.

Expert parallelism (``parallel/step.py::shard_state_ep``): a rank holds the
stacked parameters of experts ``[offset, offset + E_local)`` only; the gate
stays whole. ``ep=(group, offset)`` makes the field weight its experts'
outputs by their gates and all-reduce the partial combine over ``group``
(differentiable), which sums every expert's share.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import comm
from .layers import init_dense, lecun_normal_


def moe_field(y, w1, b1, w2, b2, gate_w, gate_b, top_k: int = 0, ep=None):
    """The field over explicit parameters (``gate_w (E, d)`` in Linear
    layout), as the solvers with their own adjoints take it; ``ep``: see
    the module docstring."""
    logits = F.linear(y, gate_w, gate_b)                      # (B, E)
    if top_k and top_k < logits.shape[-1]:
        kth = torch.sort(logits, dim=-1).values[..., -top_k, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    gates = torch.softmax(logits, dim=-1)
    if ep is not None:
        gates = gates[:, ep[1]:ep[1] + w1.shape[0]]
    hidden = torch.tanh(torch.einsum("bd,edh->ebh", y, w1) + b1[:, None, :])
    out = torch.einsum("ebh,ehd->ebd", hidden, w2) + b2[:, None, :]
    mixed = torch.einsum("ebd,be->bd", out, gates)
    return mixed if ep is None else comm.all_reduce_sum(mixed, ep[0])


class MoEField(nn.Module):
    """Gated mixture of ``n_experts`` tanh-MLP fields; ``top_k`` 0 is the
    dense softmax mixture (a smooth field), k > 0 the sparse one."""

    def __init__(self, dim: int, dim_hidden: int, n_experts: int = 4,
                 top_k: int = 0):
        super().__init__()
        e, d, h = n_experts, dim, dim_hidden
        self.top_k = top_k
        self.n_experts = n_experts
        self.ep = None  # (group, offset) under expert parallelism
        self.expert_w1 = nn.Parameter(torch.empty(e, d, h))
        self.expert_b1 = nn.Parameter(torch.empty(e, h))
        self.expert_w2 = nn.Parameter(torch.empty(e, h, d))
        self.expert_b2 = nn.Parameter(torch.empty(e, d))
        self.gate = nn.Linear(d, e)

    def init_parameters(self, generator: torch.Generator):
        """Per-expert fan-in truncated normal for the stacked kernels (flax's
        ``variance_scaling(1, "fan_in", "truncated_normal")`` with the expert
        axis as a batch axis), zero biases, a Dense gate."""
        lecun_normal_(self.expert_w1, self.expert_w1.shape[1], generator)
        lecun_normal_(self.expert_w2, self.expert_w2.shape[1], generator)
        nn.init.zeros_(self.expert_b1)
        nn.init.zeros_(self.expert_b2)
        init_dense(self.gate, generator)

    def field_params(self) -> tuple:
        return (self.expert_w1, self.expert_b1, self.expert_w2,
                self.expert_b2, self.gate.weight, self.gate.bias)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return moe_field(y, *self.field_params(), top_k=self.top_k,
                         ep=self.ep)
