"""Hand-written CUDA kernels for the motion latent, each with its plain
PyTorch version beside it (ports of ``ganode_tpu.ops``' two Pallas kernels)."""
from .fused_gru import fused_gru_motion, reference_gru_motion
from .fused_rk4 import fused_rk4_motion, reference_rk4_motion

__all__ = [
    "fused_gru_motion",
    "fused_rk4_motion",
    "reference_gru_motion",
    "reference_rk4_motion",
]
