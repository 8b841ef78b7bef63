"""The transport of the parallel layer: collectives over ``torch.distributed``
process groups, their differentiable forms, the byte tally, and the group
over which train-mode batch statistics are taken.

Transport rule. NCCL where each rank has a card of its own; gloo only where
the caller names it (the CPU, or several ranks on one card). Gloo runs
all-reduce, broadcast and all-gather on CUDA tensors itself (PyTorch 2.11,
NVIDIA H100 80GB HBM3, 700.00 W: each returned the right sums), but its
point-to-point ``send``/``recv`` of a CUDA tensor aborts the process
(``writev ... Bad address``): those messages are copied into pinned host
memory, sent, and copied back. The computation stays on the card; only
the message crosses the host.

``TALLY`` counts, per op, the calls, the payload bytes this rank sent or
received (an all-reduce counts its tensor once, an all-gather its output)
and the host seconds inside the call (a gloo op returns when it is done, an
NCCL op once it is enqueued on the card): ``chip_smoke.py`` reads it per
step.

``batch_stats_group()`` is the group over which a train-mode
``nn.layers.BatchNorm`` (and ``nn.gresblock.stateless_cbn``) takes its
statistics: None outside a parallel step, so the single-process path runs
exactly as before.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch
import torch.distributed as dist

TALLY: collections.Counter = collections.Counter()


def reset_tally():
    TALLY.clear()


@contextlib.contextmanager
def _tallied(op: str, t: torch.Tensor):
    """Count one call of ``op`` moving ``t``'s bytes, and its seconds."""
    TALLY[f"{op}_calls"] += 1
    TALLY[f"{op}_bytes"] += t.numel() * t.element_size()
    TALLY["bytes"] += t.numel() * t.element_size()
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    TALLY[f"{op}_s"] += dt
    TALLY["seconds"] += dt


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def _host_staged(t: torch.Tensor) -> bool:
    """A CUDA tensor sent or received over gloo."""
    return t.is_cuda and dist.get_backend() == "gloo"


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


# ------------------------------------------------------------- plain ops ----

def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over ``group``; every rank gets the same bits."""
    with _tallied("all_reduce", t):
        dist.all_reduce(t, group=group)
    return t


def all_reduce_max_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place max over ``group``."""
    with _tallied("all_reduce", t):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order."""
    n = group_size(group)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    with _tallied("all_gather", t.new_empty((n,) + t.shape)):
        dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """In place from global rank ``src``."""
    with _tallied("broadcast", t):
        dist.broadcast(t, src, group=group)
    return t


def send(t: torch.Tensor, dst: int):
    """To global rank ``dst`` (over gloo, a CUDA tensor through pinned host
    memory: gloo's point-to-point takes CPU tensors only)."""
    t = t.contiguous()
    with _tallied("send", t):
        if _host_staged(t):
            t = _pinned_like(t).copy_(t)
        dist.send(t, dst)


def recv(t: torch.Tensor, src: int) -> torch.Tensor:
    """Into ``t`` from global rank ``src`` (staged as ``send``)."""
    with _tallied("recv", t):
        if _host_staged(t):
            host = _pinned_like(t)
            dist.recv(host, src)
            return t.copy_(host)
        dist.recv(t, src)
    return t


# ------------------------------------------------------ differentiable ops ----

class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the adjoint is the same sum of the gradients
    (each rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    """Concatenation along ``dim``; the adjoint sums the gradients over the
    group and keeps this rank's slice (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce_(grad.contiguous().clone(), ctx.group)
        r = group_rank(ctx.group)
        return total.narrow(ctx.dim, r * ctx.n, ctx.n), None, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum over ``group``."""
    return _AllReduceSum.apply(x, group)


def all_gather_dim(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Differentiable all-gather along ``dim``."""
    return _AllGather.apply(x, group, dim)


# -------------------------------------------------- batch statistics group ----

_BATCH_GROUPS: list = []


def batch_stats_group():
    """The group train-mode batch statistics span (None: this process's
    batch alone)."""
    return _BATCH_GROUPS[-1] if _BATCH_GROUPS else None


@contextlib.contextmanager
def batch_stats_over(group):
    """Take train-mode batch statistics over ``group`` inside the block
    (None: locally)."""
    _BATCH_GROUPS.append(group)
    try:
        yield
    finally:
        _BATCH_GROUPS.pop()


def global_moments(x: torch.Tensor, dims, group, keepdim: bool = False):
    """-> (mean, biased variance) of ``x`` over ``dims`` and over the
    group's ranks, differentiable: each rank's two-pass ``var_mean``, then
    one all-gather of every rank's (mean, variance, count) and Chan's
    combination, ``var = sum_r w_r (var_r + (mean_r - mean)^2)`` with
    ``w_r = n_r / N``. No sum of squares cancels against a squared mean
    (flax's ``E[x^2] - E[x]^2``), a group of one returns its own
    statistics exactly, and every rank combines the same gathered values
    in the same order."""
    var, mean = torch.var_mean(x, dim=dims, keepdim=keepdim, correction=0)
    count = x.new_full(mean.shape, float(x.numel() // mean.numel()))
    rows = all_gather_dim(torch.stack([mean, var, count])[None], group, dim=0)
    means, variances, counts = rows[:, 0], rows[:, 1], rows[:, 2]
    w = counts / counts.sum(0)
    mean = (w * means).sum(0)
    var = (w * (variances + (means - mean) ** 2)).sum(0)
    return mean, var
