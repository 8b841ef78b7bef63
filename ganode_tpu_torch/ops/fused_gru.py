"""K2: the full GRU motion recurrence in one CUDA kernel.

Port of ``ganode_tpu/ops/fused_gru.py`` (Pallas ``_gru_kernel``): T steps of
the torch-semantics GRU with gates in ``[r | z | n]`` blocks,

    r = sigmoid(gi_r + gh_r); z = sigmoid(gi_z + gh_z)
    n = tanh(gi_n + r * gh_n); h' = (1 - z) n + z h

with ``gi = e_t @ wi + bi`` and ``gh = h @ wh + bh`` both computed inside the
kernel (``csrc/motion_kernels.cu``): ``gru_warp_kernel``, one row per group of
16 or 32 lanes, when D <= 32 (every config), else ``gru_wide_kernel``,
shared-memory tiles (``_build.choose_variant``).

``fused_gru_motion`` takes tensors on either device. On the CPU it runs the
plain version, ``reference_gru_motion``; on a CUDA device it launches the
kernel or raises. Gradients differentiate the plain version, as the JAX
package's ``_bwd`` does (no backward kernel); a call that needs none launches
without ``torch.autograd.Function``.
"""
from __future__ import annotations

import torch

from . import _build

# Kernel launches since the last reset, in all and by variant; chip_smoke.py
# reads them to show the serving path went through the kernel.
launches = 0
launches_by_variant = {"warp": 0, "wide": 0}


def reference_gru_motion(h0, e, wi, wh, bi, bh):
    """Plain PyTorch ground truth: the torch-semantics GRU over noise
    ``e (T, B, D)``. Returns the trajectory ``(T, B, D)`` of ``h_1..h_T``."""
    h = h0
    hs = []
    for t in range(e.shape[0]):
        gi = e[t] @ wi + bi
        gh = h @ wh + bh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs)


def _launch(h0, e, wi, wh, bi, bh, variant=None):
    """Launch K2 on validated CUDA inputs. ``variant`` ("warp" or "wide")
    overrides ``_build.choose_variant``, for tests and timing."""
    global launches
    _build.check_current_device(e.device)
    lib = _build.load_library()
    t, b, d = e.shape
    chosen, lanes = _build.choose_variant(d)
    variant = variant or chosen
    out = torch.empty((t, b, d), dtype=torch.float32, device=e.device)
    stream = _build.raw_stream(e.device)
    ptrs = (h0.data_ptr(), e.data_ptr(), wi.data_ptr(), wh.data_ptr(),
            bi.data_ptr(), bh.data_ptr(), out.data_ptr())
    if variant == "warp":
        err = lib.ganode_gru_motion_warp(*ptrs, b, d, t, lanes, stream)
    elif variant == "wide":
        err = lib.ganode_gru_motion_wide(*ptrs, b, d, t, stream)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    _build.check(err, f"gru_motion ({variant})")
    launches += 1
    launches_by_variant[variant] += 1
    return out


class _FusedGRU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h0, e, wi, wh, bi, bh):
        ctx.save_for_backward(h0, e, wi, wh, bi, bh)
        return _launch(h0, e, wi, wh, bi, bh)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(need)
                      for a, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
            out = reference_gru_motion(*leaves)
            wrt = [a for a in leaves if a.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return tuple(next(grads) if a.requires_grad else None for a in leaves)


def fused_gru_motion(h0, e, wi, wh, bi, bh):
    """T-step GRU recurrence: ``h0 (B, D)``, ``e (T, B, D)``, ``wi, wh (D, 3D)``
    in ``[r | z | n]`` blocks, ``bi, bh (3D,)``, all float32 and contiguous
    -> ``(T, B, D)`` of ``h_1..h_T``.

    CUDA tensors launch the kernel (one launch, no synchronisation) on the
    current CUDA device, which must be theirs; CPU tensors run
    ``reference_gru_motion``. The variant follows from D
    (``_build.choose_variant``).
    """
    if e.ndim != 3:
        raise ValueError(f"e must be (T, B, D), got {tuple(e.shape)}")
    t, b, d = e.shape
    _build.check_inputs(
        dict(e=e, h0=h0, wi=wi, wh=wh, bi=bi, bh=bh),
        dict(e=(t, b, d), h0=(b, d), wi=(d, 3 * d), wh=(d, 3 * d),
             bi=(3 * d,), bh=(3 * d,)))
    if e.device.type == "cpu":
        return reference_gru_motion(h0, e, wi, wh, bi, bh)
    if e.device.type != "cuda":
        raise ValueError(f"fused_gru_motion runs on cuda or cpu, not {e.device}")
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (h0, e, wi, wh, bi, bh)):
        return _FusedGRU.apply(h0, e, wi, wh, bi, bh)
    return _launch(h0, e, wi, wh, bi, bh)
