"""Hand-written CUDA kernels, each with its plain PyTorch version beside it:
the motion latent's (ports of ``ganode_tpu.ops``' two Pallas kernels), the
int8 serving trunk's transposed convolution (``quant.py``, which replaces no
TPU kernel), and the video discriminators' first convolution
(``conv3d_first``, no kernel: ``ganode_tpu/ops/conv3d_grad.py`` only
re-lowers an XLA gradient)."""
from .conv3d_grad import conv3d_first
from .fused_gru import fused_gru_motion, reference_gru_motion
from .fused_rk4 import fused_rk4_motion, reference_rk4_motion
from .quant import (calibrate_act_scales, deconv_i8, int8_trunk_apply,
                    quantize_trunk, reference_deconv_i8)

__all__ = [
    "calibrate_act_scales",
    "conv3d_first",
    "deconv_i8",
    "fused_gru_motion",
    "fused_rk4_motion",
    "int8_trunk_apply",
    "quantize_trunk",
    "reference_deconv_i8",
    "reference_gru_motion",
    "reference_rk4_motion",
]
