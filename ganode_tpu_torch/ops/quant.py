"""Int8 post-training quantization of the deconv trunks for serving (twin of
``ganode_tpu/ops/quant.py``), with K3, the hand-written int8 transposed
convolution (``csrc/int8_deconv.cu``).

The recipe is the JAX package's: symmetric per-output-channel int8 weights,
folded once with eval-mode BatchNorm into one float32 multiply and bias per
channel; symmetric per-tensor int8 activations, dynamic (max-abs of the live
tensor) or static (``calibrate_act_scales``); exact int32 sums; the crop of
``mnist28`` and the final tanh in float32.

    qs = quantize_trunk("dcgan64", gen.main)       # once
    frames = int8_trunk_apply("dcgan64", qs, z)    # z (B', dim_z) -> (B', C, H, W)

Layouts. The int8 state is ``{"layers": [{"packed", "ci", "scale",
"bias"}, ...]}``, each layer's int8 kernel held once: ``packed`` ``(k, k,
Co, Ci4)`` int8, K3's layout, the input channels zero-padded to a multiple
of 32 (``Ci4``: TMA wants 16-byte strides and the tensor cores 32-byte
steps of K), ``ci`` the true input channel count; ``scale`` and ``bias``
``(Co,)`` float32. ``unpack_kernel`` derives from it the ``ConvTranspose2d``
layout ``(Ci, Co, k, k)`` (``mnist28``'s 1x1 ``Conv_0`` too, as the
transposed conv with k=1, s=1, p=0 it equals), which ``bridge`` maps to and
from JAX's ``kernel_q`` ``(k, k, Ci, Co)`` with the spatial flip. Between
layers the activations are NHWC, their int8 codes padded the same way.

Numerics kept from JAX, because a one-ulp change before a ``round`` flips an
int8 code: every division is an IEEE division, by a tensor on the same
device (PyTorch's CUDA ``tensor / python_float`` multiplies by the
reciprocal instead, which the CPU does not); ``torch.round`` rounds half to
even as ``jnp.round`` does; the dynamic scale stays a 0-d tensor on the
device (no host sync per layer); the epilogue keeps JAX's order,
``y * (a_scale * scale) + bias``, unfused. So the CPU, the card and JAX
give the same codes.

``deconv_i8`` launches K3 on CUDA tensors (or raises: there is no float
fallback) and runs ``reference_deconv_i8``, the plain version, on CPU
tensors: ``F.conv_transpose2d`` in float64, exact since every sum stays far
below 2^53. ``k3_plan`` is K3's tile plan for a shape, computed here and
passed to the kernel as ints, so that the CPU tests can check it.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import comm
from . import _build

__all__ = ["TRUNK_GEOMETRY", "calibrate_act_scales", "deconv_i8",
           "int8_trunk_apply", "k3_plan", "pack_kernel", "quantize_trunk",
           "reference_deconv_i8", "unpack_kernel"]

# (conv name, BatchNorm name or None, stride, torch padding) per layer, as
# in JAX (ganode_tpu/ops/quant.py:43); every conv has k = 4 but Conv_0 (k = 1).
TRUNK_GEOMETRY: Dict[str, List[Tuple[str, Optional[str], int, int]]] = {
    "dcgan64": [("ConvTranspose_0", "BatchNorm_0", 1, 0),
                ("ConvTranspose_1", "BatchNorm_1", 2, 1),
                ("ConvTranspose_2", "BatchNorm_2", 2, 1),
                ("ConvTranspose_3", "BatchNorm_3", 2, 1),
                ("ConvTranspose_4", None, 2, 1)],
    "dcgan128": [("ConvTranspose_0", "BatchNorm_0", 1, 0),
                 ("ConvTranspose_1", "BatchNorm_1", 2, 1),
                 ("ConvTranspose_2", "BatchNorm_2", 2, 1),
                 ("ConvTranspose_3", "BatchNorm_3", 2, 1),
                 ("ConvTranspose_4", "BatchNorm_4", 2, 1),
                 ("ConvTranspose_5", None, 2, 1)],
    # mnist28 ends in a 1x1 conv + 2px crop (the reference's k1s1p2 deconv)
    "mnist28": [("ConvTranspose_0", "BatchNorm_0", 1, 0),
                ("ConvTranspose_1", "BatchNorm_1", 2, 1),
                ("ConvTranspose_2", "BatchNorm_2", 2, 1),
                ("ConvTranspose_3", "BatchNorm_3", 2, 1),
                ("Conv_0", None, 1, 0)],
}

# K3 launches since the last reset; chip_smoke.py reads it to show the int8
# serving path went through the kernel.
launches = 0


def _state_dict(trunk) -> dict:
    return trunk.state_dict() if isinstance(trunk, torch.nn.Module) else trunk


def _deconv_weight(sd: dict, name: str) -> torch.Tensor:
    """A layer's float weight in the ``ConvTranspose2d`` layout ``(Ci, Co, k,
    k)``: ``Conv_0``'s ``(Co, Ci, 1, 1)`` transposed."""
    w = sd[f"{name}.weight"].float()
    return w.transpose(0, 1) if name.startswith("Conv_") else w


def _fold_bn(sd: dict, name: str, eps: float = 1e-5):
    """Eval-mode BatchNorm as ``(scale, bias)`` per channel, from the running
    statistics (eps 1e-5, as in JAX). The square root is the correctly
    rounded float32 one, as XLA's and the card's are, taken in float64:
    torch's float32 ``sqrt`` on the CPU is off by an ulp on some inputs, and
    the scale fixes every int8 code downstream."""
    root = torch.sqrt((sd[f"{name}.running_var"].float() + eps).double()).float()
    inv = sd[f"{name}.weight"].float() / root
    return inv, sd[f"{name}.bias"].float() - sd[f"{name}.running_mean"].float() * inv


def _over_127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as an IEEE division on any device, floored at 1e-12."""
    return torch.clamp_min(t / torch.full_like(t, 127.0), 1e-12)


def _quantize_kernel(w: torch.Tensor):
    """``(Ci, Co, k, k)`` float32 -> (int8 kernel, per-Co float32 scale)."""
    s = _over_127(w.abs().amax(dim=(0, 2, 3)))
    q = torch.clamp(torch.round(w / s[None, :, None, None]), -127, 127)
    return q.to(torch.int8), s


def _ci4(c: int) -> int:
    return -(-c // 32) * 32


def pack_kernel(kernel_q: torch.Tensor) -> torch.Tensor:
    """``kernel_q`` ``(Ci, Co, k, k)`` int8 -> K3's ``(k, k, Co, Ci4)``, the
    input channels zero-padded to a multiple of 32."""
    ci = kernel_q.shape[0]
    w = kernel_q.permute(2, 3, 1, 0)
    return F.pad(w, (0, _ci4(ci) - ci)).contiguous()


def unpack_kernel(layer: dict) -> torch.Tensor:
    """A layer's int8 kernel in the ``ConvTranspose2d`` layout ``(Ci, Co, k,
    k)``, a view of its ``packed`` copy without the channel padding."""
    return layer["packed"][..., :layer["ci"]].permute(3, 2, 0, 1)


def quantize_trunk(trunk_name: str, trunk) -> Dict[str, list]:
    """Fold a trunk's float32 weights (the module, in eval mode, or its
    ``state_dict``) into the int8 serving state, on their device.

    Per layer: the int8 kernel in K3's layout, one per-channel multiply
    (weight scale x folded BatchNorm scale) and a bias; the last layer's
    bias is zero."""
    if trunk_name not in TRUNK_GEOMETRY:
        raise ValueError(
            f"no int8 geometry for trunk {trunk_name!r} "
            f"(have {sorted(TRUNK_GEOMETRY)}); the GRes trunks are "
            "spectral-norm f32 by design")
    sd = _state_dict(trunk)
    layers = []
    for conv_name, bn_name, _, _ in TRUNK_GEOMETRY[trunk_name]:
        kq, ks = _quantize_kernel(_deconv_weight(sd, conv_name))
        if bn_name is not None:
            bn_scale, bias = _fold_bn(sd, bn_name)
            scale = ks * bn_scale
        else:
            scale, bias = ks, torch.zeros_like(ks)
        layers.append({"packed": pack_kernel(kq), "ci": kq.shape[0],
                       "scale": scale, "bias": bias})
    return {"layers": layers}


def _act_quantize(x: torch.Tensor, scale: Optional[torch.Tensor] = None):
    """Symmetric int8 activation quantization -> (codes, scale): ``scale``
    None is dynamic, the max-abs of ``x`` over 127 (a 0-d tensor on ``x``'s
    device; inside ``parallel.comm.batch_stats_over`` the max over the
    group's whole batch, as JAX's GSPMD takes it over the global array); a
    calibrated static scale clips what lies beyond it."""
    if scale is None:
        amax = x.abs().amax()
        group = comm.batch_stats_group()
        if group is not None:
            amax = comm.all_reduce_max_(amax.reshape(1), group)[0]
        s = _over_127(amax)
    else:
        s = scale
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


def calibrate_act_scales(trunk_name: str, trunk, z: torch.Tensor
                         ) -> List[torch.Tensor]:
    """Per-layer static activation scales from one latent batch ``z (B',
    dim_z)`` on the trunk's device: the eval-mode trunk replayed in float32
    with the folded BatchNorm (cuDNN's TF32 off on the card), recording each
    layer's input max-abs over 127 (0-d tensors on that device)."""
    sd = _state_dict(trunk)
    geometry = TRUNK_GEOMETRY[trunk_name]
    h = z.float()[:, :, None, None]
    scales = []
    cudnn = torch.backends.cudnn
    with torch.no_grad(), cudnn.flags(
            enabled=cudnn.enabled, benchmark=cudnn.benchmark,
            deterministic=cudnn.deterministic, allow_tf32=False):
        for i, (conv_name, bn_name, stride, pad) in enumerate(geometry):
            scales.append(_over_127(h.abs().amax()))
            y = F.conv_transpose2d(h, _deconv_weight(sd, conv_name),
                                   stride=stride, padding=pad)
            if bn_name is not None:
                bn_scale, bn_bias = _fold_bn(sd, bn_name)
                y = y * bn_scale[:, None, None] + bn_bias[:, None, None]
            h = F.relu(y) if i < len(geometry) - 1 else y
    return scales


def reference_deconv_i8(xq: torch.Tensor, packed: torch.Tensor, stride: int,
                        pad: int) -> torch.Tensor:
    """K3's plain version: ``xq (B, Hi, Wi, Ci4)`` int8 NHWC and ``packed (k,
    k, Co, Ci4)`` int8 -> the int32 sums ``(B, Ho, Wo, Co)`` of the
    transposed conv with torch's ``(k, s, p)``, computed by
    ``F.conv_transpose2d`` in float64 on the inputs' device and rounded:
    exact, every product and partial sum being an integer below 2^53."""
    x = xq.permute(0, 3, 1, 2).double()
    w = packed.permute(3, 2, 0, 1).double()
    y = F.conv_transpose2d(x, w, stride=stride, padding=pad)
    return torch.round(y).to(torch.int32).permute(0, 2, 3, 1).contiguous()


def _check_deconv(xq, packed, stride, pad, epilogue):
    if xq.dtype != torch.int8 or packed.dtype != torch.int8:
        raise TypeError(f"deconv_i8 takes int8 codes, got {xq.dtype} and "
                        f"{packed.dtype}")
    if xq.ndim != 4 or packed.ndim != 4:
        raise ValueError(f"xq must be (B, Hi, Wi, Ci4) and packed (k, k, Co, "
                         f"Ci4), got {tuple(xq.shape)} and {tuple(packed.shape)}")
    k, k2, co, ci4 = packed.shape
    if k != k2 or xq.shape[3] != ci4 or ci4 % 4 or min(xq.shape) < 1 or co < 1:
        raise ValueError(f"shapes {tuple(xq.shape)} and {tuple(packed.shape)} "
                         "do not make a deconv (square kernel, Ci4 a multiple "
                         "of 4 on both)")
    _, hi, wi, _ = xq.shape
    ho, wo = (hi - 1) * stride - 2 * pad + k, (wi - 1) * stride - 2 * pad + k
    if stride < 1 or pad < 0 or ho < 1 or wo < 1:
        raise ValueError(f"stride {stride}, padding {pad} give no output")
    for name, t in (("xq", xq), ("packed", packed), *epilogue.items()):
        if t is None:
            raise ValueError(f"the epilogue needs {name}")
        if t.device != xq.device:
            raise ValueError(f"{name} is on {t.device}, xq on {xq.device}")
    for name, t in epilogue.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if epilogue and (epilogue["a_scale"].numel() != 1
                     or epilogue["scale"].shape != (co,)
                     or epilogue["bias"].shape != (co,)):
        raise ValueError(f"a_scale must hold one value, scale and bias {co}")
    return ho, wo


# K3's tile plan. Tensor-core route: 128 output rows per tile (two warpgroups
# of 64), N tiles of 64 or 128 columns, K in chunks of BK channels (128 where
# it divides Ci4, else 32), each chunk's rows BK bytes, swizzled at that
# width. Bytes route: the last layers, at the two geometries and channel
# counts that kernel is compiled for, its whole kernel in at most 48 KB of
# shared memory; any other shape takes the tensor cores.
TC_ROWS = 128
TC_BN = (64, 128)
TC_BK = (128, 32)
BYTES_KERNELS = ((4, 2, 1, 3), (1, 1, 0, 1))     # (k, s, p, Co) compiled
BYTES_MAX_SMEM = 48 * 1024
# the fields of the plan as the C entry point reads them (csrc/int8_deconv.cu
# enum PlanField, same order); the TMA maps are encoded from the boxes,
# strides and swizzle given here
PLAN_FIELDS = ("route", "B", "Hi", "Wi", "Ci4", "N", "Ho", "Wo", "K", "s",
               "p", "Cs", "BN", "BK", "boxW", "boxH", "boxB", "tilesW",
               "tilesH", "tilesN", "gridX", "gridZ", "mapRows", "mapTaps",
               "swizzle", "xStrideW", "xStrideH", "xStrideB", "wStrideRow",
               "wStrideTap")


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def class_taps(k: int, s: int, p: int) -> tuple:
    """The transposed conv's parity classes ``(ry, rx, taps)``: the outputs
    ``(qy s + ry, qx s + rx)`` read, for each tap ``(ky, kx, dy, dx)``, the
    input pixel ``(qy + dy, qx + dx)``; ``ky = (ry + p) % s + j s`` at
    ``dy = (ry + p) // s - j`` (the kernel walks the same formula)."""
    def axis(r):
        k0 = (r + p) % s
        return [(k0 + j * s, (r + p) // s - j) for j in range(len(range(k0, k, s)))]
    return tuple((ry, rx, tuple((ky, kx, dy, dx) for ky, dy in axis(ry)
                                for kx, dx in axis(rx)))
                 for ry in range(s) for rx in range(s))


@dataclass(frozen=True)
class K3Plan:
    """How K3 runs one shape. ``route`` is ``"tensor_core"`` or ``"bytes"``;
    ``ci4`` the channels the kernel reads (the operands are zero-padded to
    it). On the tensor-core route ``gemm`` says a 1x1 input with p = 0 runs
    as one GEMM (one class, one tap, ``n = k^2 Co`` columns); ``k, s, p``,
    ``ho, wo`` are the geometry the kernel sees (1, 1, 0 and 1 x 1 in that
    case); ``classes`` its parity classes and taps; ``box`` the input's TMA
    box ``(BK, boxW, boxH, boxB)`` over ``(C, W, H, B)`` (the weights' box is
    ``(BK, BN, 1)`` over ``(Ci4, map_rows, map_taps)``), ``swizzle`` both
    maps' swizzle span in bytes; ``x_strides`` / ``w_strides`` their byte
    strides; ``tiles`` ``(tilesW, tilesH, tilesB, tilesN)``, ``grid``
    ``(tiles per class, classes)`` (the kernel is persistent: it launches at
    most as many blocks as the card holds at once, each walking tiles). The
    bytes route has its geometry and ``classes`` only: its window and shared
    memory are compiled for ``(k, s, p, Co)``. ``args`` is what the C entry
    point reads."""
    route: str
    b: int
    hi: int
    wi: int
    ci4: int
    co: int
    k: int
    s: int
    p: int
    ho: int
    wo: int
    n: int
    gemm: bool = False
    bn: int = 0
    bk: int = 0
    swizzle: int = 0
    classes: tuple = ()
    box: tuple = ()
    x_strides: tuple = ()
    w_strides: tuple = ()
    map_rows: int = 0
    map_taps: int = 0
    tiles: tuple = ()
    grid: tuple = ()

    @property
    def args(self) -> tuple:
        """The ints the C entry point reads, in ``PLAN_FIELDS`` order."""
        tc = self.route == "tensor_core"
        return (0 if tc else 1, self.b, self.hi, self.wi, self.ci4, self.n,
                self.ho, self.wo, self.k, self.s, self.p, self.co, self.bn,
                self.bk, *(self.box[1:] if tc else (0, 0, 0)),
                *(self.tiles[:2] + self.tiles[3:] if tc else (0, 0, 0)),
                *(self.grid if tc else (0, 0)), self.map_rows,
                self.map_taps, self.swizzle,
                *(self.x_strides + self.w_strides if tc else (0,) * 5))


@functools.lru_cache(maxsize=256)
def k3_plan(b: int, hi: int, wi: int, ci4: int, co: int, k: int, s: int,
            p: int) -> K3Plan:
    """K3's plan for ``x (b, hi, wi, ci4)`` and ``packed (k, k, co, ci4)``
    at stride ``s``, padding ``p`` (shapes ``_check_deconv`` accepts)."""
    ci4 = _ci4(ci4)
    ho, wo = (hi - 1) * s - 2 * p + k, (wi - 1) * s - 2 * p + k
    if (k, s, p, co) in BYTES_KERNELS and k * k * co * ci4 <= BYTES_MAX_SMEM:
        return K3Plan("bytes", b, hi, wi, ci4, co, k, s, p, ho, wo, co,
                      classes=class_taps(k, s, p))
    gemm = hi == wi == 1 and p == 0
    n, kk, ss, pp, hk, wk = ((k * k * co, 1, 1, 0, 1, 1) if gemm
                             else (co, k, s, p, ho, wo))
    bn = TC_BN[0] if n <= TC_BN[0] else TC_BN[1]
    bk = next(c for c in TC_BK if ci4 % c == 0)
    hq, wq = -(-hk // ss), -(-wk // ss)    # class (0, 0)'s, the largest
    box_w = min(_pow2_at_least(wq), TC_ROWS)
    box_h = min(_pow2_at_least(hq), TC_ROWS // box_w)
    box_b = TC_ROWS // (box_w * box_h)
    tiles = (-(-wq // box_w), -(-hq // box_h), -(-b // box_b), -(-n // bn))
    map_rows, map_taps = (n, 1) if gemm else (co, k * k)
    return K3Plan(
        "tensor_core", b, hi, wi, ci4, co, kk, ss, pp, hk, wk, n, gemm=gemm,
        bn=bn, bk=bk, swizzle=bk, classes=class_taps(kk, ss, pp),
        box=(bk, box_w, box_h, box_b),
        x_strides=(ci4, wi * ci4, hi * wi * ci4),
        w_strides=(ci4, map_rows * ci4), map_rows=map_rows,
        map_taps=map_taps, tiles=tiles,
        grid=(tiles[0] * tiles[1] * tiles[2] * tiles[3], ss * ss))


@functools.lru_cache(maxsize=256)
def _c_plan(*shape):
    plan = k3_plan(*shape)
    return plan, (ctypes.c_int * len(PLAN_FIELDS))(*plan.args)


def _operand(t: torch.Tensor, ci4: int) -> torch.Tensor:
    """``t`` with its last dimension zero-padded to ``ci4``, contiguous and
    16-byte aligned, as TMA and the 16-byte loads read it."""
    if t.shape[-1] != ci4:
        t = F.pad(t, (0, ci4 - t.shape[-1]))
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(xq, packed, stride, pad, ho, wo, epilogue, relu):
    """Launch K3 on validated CUDA inputs."""
    global launches
    _build.check_current_device(xq.device)
    lib = _build.load_library()
    b, hi, wi, ci4 = xq.shape
    k, _, co, _ = packed.shape
    plan, args = _c_plan(b, hi, wi, ci4, co, k, stride, pad)
    xq, packed = _operand(xq, plan.ci4), _operand(packed, plan.ci4)
    out = torch.empty((b, ho, wo, co), device=xq.device,
                      dtype=torch.float32 if epilogue else torch.int32)
    if max(xq.numel(), out.numel(), packed.numel()) >= 2 ** 31:
        raise ValueError("deconv_i8 takes tensors of fewer than 2^31 elements")
    e = [t.contiguous() for t in (epilogue["a_scale"], epilogue["scale"],
                                  epilogue["bias"])] if epilogue else []
    ptrs = [t.data_ptr() for t in e] or [None] * 3
    err = lib.ganode_deconv_i8(xq.data_ptr(), packed.data_ptr(), out.data_ptr(),
                               int(bool(epilogue)), *ptrs, int(relu), args,
                               _build.raw_stream(xq.device))
    _build.check(err, "deconv_i8")
    launches += 1
    return out


def deconv_i8(xq: torch.Tensor, packed: torch.Tensor, stride: int, pad: int,
              *, a_scale: Optional[torch.Tensor] = None,
              scale: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None,
              relu: bool = False) -> torch.Tensor:
    """The int8 transposed conv ``xq (B, Hi, Wi, Ci4)`` x ``packed (k, k, Co,
    Ci4)`` -> ``(B, Ho, Wo, Co)``, NHWC: the int32 sums, or with ``a_scale``
    (0-d), ``scale`` and ``bias`` (``(Co,)``, float32) the float32
    ``y * (a_scale * scale) + bias``, ReLU'd when ``relu``.

    CUDA tensors launch K3 (no synchronisation) on the current CUDA device,
    which must be theirs, or raise; CPU tensors run ``reference_deconv_i8``
    and the epilogue as plain float32 tensor ops, in JAX's order."""
    epilogue = {} if a_scale is None and scale is None and bias is None else \
        {"a_scale": a_scale, "scale": scale, "bias": bias}
    ho, wo = _check_deconv(xq, packed, stride, pad, epilogue)
    if xq.device.type == "cuda":
        return _launch(xq, packed, stride, pad, ho, wo, epilogue, relu)
    if xq.device.type != "cpu":
        raise ValueError(f"deconv_i8 runs on cuda or cpu, not {xq.device}")
    y = reference_deconv_i8(xq, packed, stride, pad)
    if not epilogue:
        return y
    h = y.float() * (a_scale * scale) + bias
    return F.relu(h) if relu else h


def int8_trunk_apply(trunk_name: str, qstate: Dict[str, list], z: torch.Tensor,
                     act_scales: Optional[List[torch.Tensor]] = None, *,
                     codes: Optional[list] = None) -> torch.Tensor:
    """``z (B', dim_z)`` -> frames ``(B', C, H, W)`` in [-1, 1] through the
    int8 trunk (a permuted view of channels-last memory, which the videos'
    ``(n, T, H, W, C)`` layout reads without a copy): per layer the
    activation codes (dynamic, or
    the static ``act_scales`` of ``calibrate_act_scales``), one ``deconv_i8``
    with the fused epilogue and ReLU but on the last layer; then the
    ``mnist28`` crop and tanh in float32. ``codes``, a list, receives each
    layer's int8 input, for counting codes that differ between two runs."""
    geometry = TRUNK_GEOMETRY[trunk_name]
    h = z.float()[:, None, None, :]
    n_layers = len(geometry)
    for i, ((_, _, stride, pad), layer) in enumerate(zip(geometry,
                                                         qstate["layers"])):
        hq, a_scale = _act_quantize(
            h, None if act_scales is None else act_scales[i])
        ci4 = layer["packed"].shape[-1]
        if hq.shape[-1] != ci4:
            hq = F.pad(hq, (0, ci4 - hq.shape[-1]))
        if codes is not None:
            codes.append(hq)
        h = deconv_i8(hq, layer["packed"], stride, pad, a_scale=a_scale,
                      scale=layer["scale"], bias=layer["bias"],
                      relu=i < n_layers - 1)
    if trunk_name == "mnist28":
        h = h[:, 2:-2, 2:-2, :]  # the k1s1p2 crop
    return torch.tanh(h).permute(0, 3, 1, 2)
