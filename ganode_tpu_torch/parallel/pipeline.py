"""Pipeline parallelism: a GPipe microbatch schedule over heterogeneous
stages (twin of ``ganode_tpu/parallel/pipeline.py``).

Rank i of the mesh's ``"pipe"`` axis owns stage i: it holds only that
stage's parameters and runs only its function. Microbatches flow forward by
point-to-point ``send``/``recv`` (the first microbatch carries a header with
its shape, since stages map shapes freely); the last stage's outputs are
broadcast over the pipe group, and, with ``data_axis``, gathered over the
data group, so every rank returns the whole result, as JAX's
``pipeline_apply`` returns the global array.

The schedule is differentiable. Each rank's part is one autograd function:
its forward keeps the stage's inputs, its backward runs the microbatches in
reverse order (receive the output's gradient from the next stage, recompute
the stage with autograd, send the input's gradient to the previous stage),
GPipe's rematerialisation. Every rank runs its sends and receives in the
same order in both passes, so blocking point-to-point cannot deadlock.

Gradient convention: the result is replicated, and the loss taken of it is
taken to be the same on every rank; a rank's backward reads the gradient of
its own rows only (the last stage's, of its data shard). Stage i's
parameter gradients then land on the ranks that own stage i; the input's
gradient on the first stage's ranks.

Gloo's point-to-point takes CPU tensors only, so on a card a gloo group
stages every message through pinned host memory (``comm.send``/``recv``);
NCCL sends from the card.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from . import comm
from .mesh import axis_index, axis_size

_HEADER = 8  # ndim, then up to 7 dims


def _send_header(shape, dst: int, device):
    h = torch.zeros(_HEADER, dtype=torch.int64, device=device)
    h[0] = len(shape)
    h[1:1 + len(shape)] = torch.tensor(shape, dtype=torch.int64)
    comm.send(h, dst)


def _recv_header(src: int, device) -> tuple:
    h = comm.recv(torch.zeros(_HEADER, dtype=torch.int64, device=device), src)
    h = h.tolist()
    return tuple(h[1:1 + h[0]])


class _Stage(torch.autograd.Function):
    """This rank's stage of the schedule: ``(x, *params) -> out``."""

    @staticmethod
    def forward(ctx, plan, x, *flat):
        ctx.plan, ctx.flat = plan, flat
        fn, spec, i, S = plan["fn"], plan["spec"], plan["i"], plan["S"]
        params = pytree.tree_unflatten(list(flat), spec)
        dev = x.device
        inputs, outs, in_shape = [], [], None
        for mb in plan["microbatches"](x):
            if i > 0:
                if in_shape is None:
                    in_shape = _recv_header(plan["prev"], dev)
                mb = comm.recv(torch.empty(in_shape, dtype=x.dtype, device=dev),
                               plan["prev"])
            inputs.append(mb)
            y = fn(params, mb)
            if i < S - 1:
                if not outs:
                    _send_header(y.shape, plan["next"], dev)
                comm.send(y, plan["next"])
            outs.append(y)
        ctx.save_for_backward(*inputs)
        ctx.out_shape = tuple(outs[0].shape)
        # (M, m_loc, ...) of the last stage, broadcast over the pipe group
        h = torch.zeros(_HEADER, dtype=torch.int64, device=dev)
        if i == S - 1:
            res = torch.stack(outs)
            h[0] = res.ndim
            h[1:1 + res.ndim] = torch.tensor(res.shape, dtype=torch.int64)
        h = comm.broadcast_(h, plan["last"], plan["group"]).tolist()
        if i < S - 1:
            res = torch.empty(h[1:1 + h[0]], dtype=x.dtype, device=dev)
        return comm.broadcast_(res.contiguous(), plan["last"], plan["group"])

    @staticmethod
    def backward(ctx, grad):
        plan, flat = ctx.plan, ctx.flat
        fn, spec, i, S = plan["fn"], plan["spec"], plan["i"], plan["S"]
        inputs = ctx.saved_tensors
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in flat]
        params = pytree.tree_unflatten(leaves, spec)
        want = [p for p in leaves if p.requires_grad]
        acc = [torch.zeros_like(p) for p in want]
        grad_in = [None] * len(inputs)
        dev = grad.device
        for m in reversed(range(len(inputs))):
            if i == S - 1:
                g = grad[m]
            else:
                g = comm.recv(torch.empty(ctx.out_shape, dtype=grad.dtype,
                                          device=dev), plan["next"])
            h = inputs[m].detach().requires_grad_(i > 0 or plan["x_grad"])
            with torch.enable_grad():
                y = fn(params, h)
                wrt = ([h] if h.requires_grad else []) + want
                gs = torch.autograd.grad(y, wrt, g, allow_unused=True)
            if h.requires_grad:
                gh, gs = gs[0], gs[1:]
                if i > 0:
                    comm.send(gh, plan["prev"])
                else:
                    grad_in[m] = gh
            for a, gp in zip(acc, gs):
                if gp is not None:
                    a.add_(gp)
        it = iter(acc)
        flat_grads = [next(it) if p.requires_grad else None for p in leaves]
        gx = plan["x_grad_from"](grad_in) if i == 0 and plan["x_grad"] else None
        return (None, gx, *flat_grads)


def pipeline_apply(stage_fns: Sequence[Callable[[Any, torch.Tensor], torch.Tensor]],
                   stage_params: Sequence[Any], x: torch.Tensor, mesh, *,
                   axis: str = "pipe", data_axis: Optional[str] = None,
                   n_microbatches: Optional[int] = None) -> torch.Tensor:
    """``x`` through ``stage_fns[0] ∘ ... ∘ stage_fns[S-1]``, stage i on
    rank i of ``axis``, GPipe-scheduled over ``n_microbatches`` (default
    S); with ``data_axis`` each microbatch is split over that axis too.

    ``x`` (the whole batch) is given on every rank; only the first stage
    reads it. ``stage_params[i]`` is read on stage i's ranks only (a tree
    of tensors). Equal to the sequential composition, differentiable (see
    the module docstring). Requires S == the axis' size, a batch divisible
    by the microbatches and each microbatch by the data axis, and one
    activation dtype."""
    S = len(stage_fns)
    if axis_size(mesh, axis) != S:
        raise ValueError(f"{S} stages need mesh axis {axis!r} of size {S}, "
                         f"got {axis_size(mesh, axis)}")
    M = n_microbatches or S
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    m = B // M
    dsize = axis_size(mesh, data_axis) if data_axis else 1
    if m % dsize:
        raise ValueError(f"microbatch {m} not divisible by data axis {dsize}")
    m_loc = m // dsize
    dj = axis_index(mesh, data_axis) if data_axis else 0
    i = axis_index(mesh, axis)
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)

    def microbatches(t):
        return [t[k * m + dj * m_loc: k * m + (dj + 1) * m_loc]
                for k in range(M)]

    def x_grad_from(parts):
        g = torch.zeros_like(x)
        for k, p in enumerate(parts):
            g[k * m + dj * m_loc: k * m + (dj + 1) * m_loc] = p
        return g

    leaves, spec = pytree.tree_flatten(stage_params[i])
    plan = {"fn": stage_fns[i], "spec": spec, "i": i, "S": S,
            "prev": ranks[i - 1] if i > 0 else None,
            "next": ranks[i + 1] if i < S - 1 else None,
            "last": ranks[S - 1], "group": group,
            "microbatches": microbatches, "x_grad_from": x_grad_from,
            "x_grad": x.requires_grad}
    out = _Stage.apply(plan, x, *leaves)                 # (M, m_loc, ...)
    if data_axis:
        out = _GatherRows.apply(out, mesh.get_group(data_axis))
    return out.reshape((B,) + tuple(out.shape[2:]))


class _GatherRows(torch.autograd.Function):
    """All-gather of dim 1 over the data group; the backward keeps this
    rank's rows of the (replicated) gradient, the convention above."""

    @staticmethod
    def forward(ctx, out, group):
        ctx.n, ctx.r = out.shape[1], comm.group_rank(group)
        return comm.all_gather(out, group, dim=1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, ctx.r * ctx.n, ctx.n), None
