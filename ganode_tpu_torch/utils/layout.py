"""Layout converters between the JAX package's channels-last tensors and the
reference's torch channels-first contracts (twins of ``ganode_tpu.utils.layout``).

The port's public samplers keep the JAX layout (videos ``(B, T, H, W, C)``);
these converters give the reference layout at the API boundary. They return
views, as ``permute`` does.
"""
from __future__ import annotations

import torch


def video_to_torch(v: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, C, T, H, W)"""
    return v.permute(0, 4, 1, 2, 3)


def video_from_torch(v: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> (B, T, H, W, C)"""
    return v.permute(0, 2, 3, 4, 1)


def video_from_tchw(v: torch.Tensor) -> torch.Tensor:
    """(B, T, C, H, W) -> (B, T, H, W, C) — the dataset clip layout."""
    return v.permute(0, 1, 3, 4, 2)


def image_to_torch(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W)"""
    return x.permute(0, 3, 1, 2)


def image_from_torch(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H, W, C)"""
    return x.permute(0, 2, 3, 1)
