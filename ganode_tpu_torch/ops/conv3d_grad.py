"""The video discriminators' first convolution (twin of
``ganode_tpu/ops/conv3d_grad.py::conv3d_first``): kernel 4x4x4, stride
(1, 2, 2), padding (0, 1, 1), no bias.

The JAX module is no Pallas kernel. It keeps XLA's forward and weight gradient
and re-lowers only the input gradient, whose GEMM has N = C_in = 3 output
features and wasted 125 of the TPU matrix unit's 128 lanes. The values are
those of the plain convolution, so here the convolution is ``F.conv3d``
(cuDNN on the card) with autograd's own gradients, double backward included.
Whether cuDNN's data gradient needs help at ``C_in = 3`` is a measurement for
the port's bench (ROADMAP M8), not an assumption.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

STRIDE = (1, 2, 2)
PADDING = (0, 1, 1)


def conv3d_first(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (N, C_in, T, H, W)``, ``w (C_out, C_in, 4, 4, 4)`` ->
    ``(N, C_out, T - 3, H', W')`` with ``H' = H // 2`` for even ``H``."""
    if w.shape[2:] != (4, 4, 4):
        raise ValueError(f"conv3d_first takes a 4x4x4 kernel, got {tuple(w.shape)}")
    return F.conv3d(x, w, stride=STRIDE, padding=PADDING)
