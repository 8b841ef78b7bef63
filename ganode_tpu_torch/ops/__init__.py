"""Hand-written CUDA kernels for the motion latent, each with its plain
PyTorch version beside it (ports of ``ganode_tpu.ops``' two Pallas kernels),
and the video discriminators' first convolution (``conv3d_first``, no kernel:
``ganode_tpu/ops/conv3d_grad.py`` only re-lowers an XLA gradient)."""
from .conv3d_grad import conv3d_first
from .fused_gru import fused_gru_motion, reference_gru_motion
from .fused_rk4 import fused_rk4_motion, reference_rk4_motion

__all__ = [
    "conv3d_first",
    "fused_gru_motion",
    "fused_rk4_motion",
    "reference_gru_motion",
    "reference_rk4_motion",
]
