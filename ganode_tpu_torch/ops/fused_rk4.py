"""K1: the whole RK4 motion-latent solve in one CUDA kernel.

Port of ``ganode_tpu/ops/fused_rk4.py`` (Pallas ``_rk4_kernel``): the
trajectory of ``f(y) = tanh(y @ w1 + b1) @ w2 + b2`` over a uniform grid, all
4 (T-1) right-hand-side evaluations and the output stack in one launch
(``csrc/motion_kernels.cu``): ``rk4_warp_kernel``, one row per group of 16 or
32 lanes with everything in registers, when max(D, H) <= 32 (every config),
else ``rk4_wide_kernel``, shared-memory tiles (``_build.choose_variant``).

``fused_rk4_motion`` takes tensors on either device. On the CPU it runs the
plain version, ``reference_rk4_motion``; on a CUDA device it launches the
kernel or raises. Gradients, as in the JAX package's ``_bwd``, differentiate
the plain version (no backward kernel); a call that needs none launches
without ``torch.autograd.Function``.
"""
from __future__ import annotations

import torch

from . import _build

# Kernel launches since the last reset, in all and by variant; chip_smoke.py
# reads them to show the serving path went through the kernel.
launches = 0
launches_by_variant = {"warp": 0, "wide": 0}


def reference_rk4_motion(x, w1, b1, w2, b2, ts):
    """Plain PyTorch ground truth: rk4 over the ``ts`` grid on
    ``f(y) = tanh(y @ w1 + b1) @ w2 + b2``. Returns ``(T, B, D)``."""
    # the spacings as Python floats (float32 values, as the JAX plain
    # version has them): a CPU ts then costs the card no copy and no sync
    steps = ts.to(x.dtype).diff().tolist()

    def rhs(y):
        return torch.tanh(y @ w1 + b1) @ w2 + b2

    ys = [x]
    y = x
    for h in steps:
        k1 = rhs(y)
        k2 = rhs(y + 0.5 * h * k1)
        k3 = rhs(y + 0.5 * h * k2)
        k4 = rhs(y + h * k3)
        y = y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        ys.append(y)
    return torch.stack(ys)


def uniform_step(ts: torch.Tensor) -> float:
    """``ts[1] - ts[0]`` in float32, after checking the grid is uniform.

    The kernel, like the TPU kernel (``fused_rk4.py:104``), steps by the first
    spacing only, so a non-uniform grid would silently differ from the plain
    version: it is refused. Reads ``ts`` on the host (a sync if it lies on the
    card; the motion sampler keeps it on the CPU) and checks it in Python
    floats, each spacing within ``1e-7 + 1e-5 |h|`` of ``h``.
    """
    if ts.ndim != 1 or ts.shape[0] < 2:
        raise ValueError(f"ts must be 1-D with at least 2 points, got {tuple(ts.shape)}")
    t = ts.tolist()
    h = t[1] - t[0]
    tol = 1e-7 + 1e-5 * abs(h)
    # `not <=` so that a NaN spacing is refused too
    if not all(abs((b - a) - h) <= tol for a, b in zip(t, t[1:])):
        raise ValueError(
            "fused_rk4_motion takes a uniform grid only (the kernel steps by "
            f"ts[1] - ts[0]); got spacings {[b - a for a, b in zip(t, t[1:])]}")
    return h


def _launch(x, w1, b1, w2, b2, n_out: int, h: float, variant=None):
    """Launch K1 on validated CUDA inputs. ``variant`` ("warp" or "wide")
    overrides ``_build.choose_variant``, for tests and timing."""
    global launches
    _build.check_current_device(x.device)
    lib = _build.load_library()
    b, d = x.shape
    hd = w1.shape[1]
    chosen, lanes = _build.choose_variant(d, hd)
    variant = variant or chosen
    out = torch.empty((n_out, b, d), dtype=torch.float32, device=x.device)
    stream = _build.raw_stream(x.device)
    ptrs = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr())
    if variant == "warp":
        err = lib.ganode_rk4_motion_warp(*ptrs, b, d, hd, n_out, h, lanes,
                                         stream)
    elif variant == "wide":
        err = lib.ganode_rk4_motion_wide(*ptrs, b, d, hd, n_out, h, stream)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    _build.check(err, f"rk4_motion ({variant})")
    launches += 1
    launches_by_variant[variant] += 1
    return out


class _FusedRK4(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ts, h):
        ctx.save_for_backward(x, w1, b1, w2, b2, ts)
        return _launch(x, w1, b1, w2, b2, ts.shape[0], h)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        ts = inputs[-1]
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(need)
                      for a, need in zip(inputs[:5], ctx.needs_input_grad[:5])]
            out = reference_rk4_motion(*leaves, ts)
            wrt = [a for a in leaves if a.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return (*(next(grads) if a.requires_grad else None for a in leaves),
                None, None)


def fused_rk4_motion(x, w1, b1, w2, b2, ts):
    """RK4 solve of ``f(y) = tanh(y @ w1 + b1) @ w2 + b2`` over the uniform grid
    ``ts``: ``x (B, D)``, ``w1 (D, H)``, ``b1 (H,)``, ``w2 (H, D)``, ``b2 (D,)``,
    all float32 and contiguous -> trajectory ``(T, B, D)`` with ``out[0] = x``.

    CUDA tensors launch the kernel (one launch, no synchronisation) on the
    current CUDA device, which must be theirs; CPU tensors run
    ``reference_rk4_motion``. ``ts`` may lie on either device. A one-point
    grid returns ``x[None]`` without a launch, as the JAX package's
    ``MotionODE(video_len=1)`` does. The variant follows from the widths
    (``_build.choose_variant``).
    """
    if x.ndim != 2 or w1.ndim != 2:
        raise ValueError(f"x and w1 must be 2-D, got {tuple(x.shape)} and "
                         f"{tuple(w1.shape)}")
    (b, d), hd = x.shape, w1.shape[1]
    _build.check_inputs(
        dict(x=x, w1=w1, b1=b1, w2=w2, b2=b2),
        dict(x=(b, d), w1=(d, hd), b1=(hd,), w2=(hd, d), b2=(d,)))
    if ts.ndim == 1 and ts.shape[0] == 1:
        return x[None]  # a one-point grid: the trajectory is x, no launch
    h = uniform_step(ts)
    if x.device.type == "cpu":
        return reference_rk4_motion(x, w1, b1, w2, b2, ts)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rk4_motion runs on cuda or cpu, not {x.device}")
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x, w1, b1, w2, b2)):
        return _FusedRK4.apply(x, w1, b1, w2, b2, ts, h)
    return _launch(x, w1, b1, w2, b2, ts.shape[0], h)
