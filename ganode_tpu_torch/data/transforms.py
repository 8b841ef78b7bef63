"""Clip-consistent augmentation: one random draw shared by every frame of a
clip (twin of ``ganode_tpu/data/transforms.py``).

The reference implements this as a ``randomize_parameters()`` protocol on
torch transforms (reference dataset/transform/spatial_transforms.py:33-35,
249-253,336-340 and temporal_transforms.py): call it once per clip, then
apply the same parameters to all frames. Here each keyed transform takes its
drawn parameters as optional tensors (the flip, the crop offsets, the scale
and corner indices, the start frame) and draws the missing ones from an
explicit ``torch.Generator``. The JAX transforms draw the same quantities
from a key; the tests feed the port JAX's draws.

Every transform works on tensors on the input's device and takes and returns
channels-last clips: ``(..., H, W, C)``, videos ``(T, H, W, C)``. The
resizing ones compute in float32 (integer clips come back float32).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F


def _draw_int(high: int, generator: Optional[torch.Generator],
              what: str) -> torch.Tensor:
    """One integer in ``[0, high)`` from ``generator``."""
    if generator is None:
        raise ValueError(f"no {what} given and no torch.Generator to draw it")
    return torch.randint(0, high, (), generator=generator,
                         device=generator.device)


def _window(clip: torch.Tensor, y0, x0, size: int) -> torch.Tensor:
    """The ``size x size`` window at (y0, x0) of every frame; the offsets
    may be tensors, so the crop needs no host sync."""
    dev = clip.device
    ar = torch.arange(size, device=dev)
    rows = torch.as_tensor(y0, device=dev) + ar
    cols = torch.as_tensor(x0, device=dev) + ar
    return clip.index_select(-3, rows).index_select(-2, cols)


# ----------------------------------------------------------------- spatial ----

def random_horizontal_flip(clip: torch.Tensor, p: float = 0.5, *,
                           generator: Optional[torch.Generator] = None,
                           flip=None) -> torch.Tensor:
    """Flip all frames of the clip together with probability ``p``
    (reference spatial_transforms.py RandomHorizontalFlip). ``flip``: the
    draw, a bool (tensor), else ``U[0, 1) < p`` from ``generator``."""
    if flip is None:
        if generator is None:
            raise ValueError("no flip given and no torch.Generator to draw it")
        flip = torch.rand((), generator=generator, device=generator.device) < p
    flip = torch.as_tensor(flip, device=clip.device)
    return torch.where(flip, clip.flip(-2), clip)


def center_crop(clip: torch.Tensor, size: int) -> torch.Tensor:
    h, w = clip.shape[-3], clip.shape[-2]
    y0, x0 = (h - size) // 2, (w - size) // 2
    return clip[..., y0:y0 + size, x0:x0 + size, :]


def random_crop(clip: torch.Tensor, size: int, *,
                generator: Optional[torch.Generator] = None,
                offsets=None) -> torch.Tensor:
    """One ``size`` crop window for the whole clip. ``offsets``: ``(y0,
    x0)``, else each drawn uniformly from its valid range."""
    h, w = clip.shape[-3], clip.shape[-2]
    if offsets is None:
        offsets = (_draw_int(h - size + 1, generator, "offsets"),
                   _draw_int(w - size + 1, generator, "offsets"))
    return _window(clip, offsets[0], offsets[1], size)


_CORNER_POSITIONS = ("c", "tl", "tr", "bl", "br")


def corner_crop(clip: torch.Tensor, size: int, position: str) -> torch.Tensor:
    """Deterministic corner/center crop (reference CornerCrop)."""
    h, w = clip.shape[-3], clip.shape[-2]
    coords = {
        "c": ((h - size) // 2, (w - size) // 2),
        "tl": (0, 0),
        "tr": (0, w - size),
        "bl": (h - size, 0),
        "br": (h - size, w - size),
    }
    y0, x0 = coords[position]
    return clip[..., y0:y0 + size, x0:x0 + size, :]


def _resize(clip: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize of every frame to ``size x size`` in float32, with
    antialiasing when it shrinks: ``jax.image.resize(method="bilinear")``'s
    triangle filter, half-pixel centres."""
    lead, (h, w, c) = clip.shape[:-3], clip.shape[-3:]
    x = clip.reshape(-1, h, w, c).permute(0, 3, 1, 2).to(torch.float32)
    y = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, size, size, c)


def multi_scale_corner_crop(clip: torch.Tensor, size: int,
                            scales: Sequence[float] = (1.0, 0.84, 0.71, 0.59, 0.5),
                            positions: Sequence[str] = _CORNER_POSITIONS, *,
                            generator: Optional[torch.Generator] = None,
                            scale_idx=None, pos_idx=None) -> torch.Tensor:
    """Pick one (scale, corner) pair for the whole clip, crop, resize to
    ``size`` (reference MultiScaleCornerCrop, spatial_transforms.py:300-340).
    ``scale_idx``, ``pos_idx``: the draws (the scale's first)."""
    if scale_idx is None:
        scale_idx = _draw_int(len(scales), generator, "scale_idx")
    if pos_idx is None:
        pos_idx = _draw_int(len(positions), generator, "pos_idx")
    min_side = min(clip.shape[-3], clip.shape[-2])
    crop = int(min_side * scales[int(scale_idx)])
    return _resize(corner_crop(clip, crop, positions[int(pos_idx)]), size)


def multi_scale_random_crop(clip: torch.Tensor, size: int,
                            scales: Sequence[float] = (1.0, 0.84, 0.71, 0.59, 0.5),
                            *, generator: Optional[torch.Generator] = None,
                            scale_idx=None, offsets=None) -> torch.Tensor:
    """Pick one scale for the clip, crop a random window of that scale,
    resize to ``size`` (reference MultiScaleRandomCrop semantics,
    bilinear). ``scale_idx``, then the window's ``offsets``: the draws."""
    if scale_idx is None:
        scale_idx = _draw_int(len(scales), generator, "scale_idx")
    min_side = min(clip.shape[-3], clip.shape[-2])
    crop = int(min_side * scales[int(scale_idx)])
    cropped = random_crop(clip, crop, generator=generator, offsets=offsets)
    return _resize(cropped, size)


def normalize(clip: torch.Tensor, mean, std) -> torch.Tensor:
    shape = (1,) * (clip.ndim - 1) + (-1,)
    mean = torch.as_tensor(mean, dtype=clip.dtype, device=clip.device)
    std = torch.as_tensor(std, dtype=clip.dtype, device=clip.device)
    return (clip - mean.reshape(shape)) / std.reshape(shape)


# ---------------------------------------------------------------- temporal ----

def loop_padding(clip: torch.Tensor, size: int) -> torch.Tensor:
    """Tile the clip until it has ``size`` frames (reference LoopPadding)."""
    t = clip.shape[0]
    reps = -(-size // t)
    return clip.repeat((reps,) + (1,) * (clip.ndim - 1))[:size]


def temporal_begin_crop(clip: torch.Tensor, size: int) -> torch.Tensor:
    return loop_padding(clip[:size], size)


def temporal_center_crop(clip: torch.Tensor, size: int) -> torch.Tensor:
    t = clip.shape[0]
    start = max(0, t // 2 - size // 2)
    return loop_padding(clip[start:start + size], size)


def temporal_random_crop(clip: torch.Tensor, size: int, *,
                         generator: Optional[torch.Generator] = None,
                         start=None) -> torch.Tensor:
    """Random window with loop padding for short clips (reference
    TemporalRandomCrop, dataset/transform/temporal_transforms.py:84-112).
    ``start``: the draw, uniform in ``[0, max(0, T - size)]``."""
    t = clip.shape[0]
    if start is None:
        start = _draw_int(max(0, t - size) + 1, generator, "start")
    idx = torch.as_tensor(start, device=clip.device) + torch.arange(
        min(size, t), device=clip.device)
    return loop_padding(clip.index_select(0, idx), size)


# ---------------------------------------------------------------- pipeline ----

def per_clip(transform: Callable, batch: torch.Tensor, *,
             generator: Optional[torch.Generator] = None,
             draws: Optional[dict] = None) -> torch.Tensor:
    """Apply a keyed clip transform independently per batch element: the
    batch analog of 'randomize once per clip'. ``draws`` maps the
    transform's draw arguments to values with a leading batch axis (element
    i gets row i); the missing draws come from ``generator``, element by
    element."""
    draws = draws or {}
    out = [transform(batch[i], generator=generator,
                     **{k: v[i] for k, v in draws.items()})
           for i in range(batch.shape[0])]
    return torch.stack(out)


# ------------------------------------------------------------------ targets ----
# Target transforms select fields from a per-sample annotation dict: the
# reference's dataset/transform/target_transforms.py:17-27 verbatim.

def class_label(target: dict):
    """-> target['label'] (reference target_transforms.py ClassLabel)."""
    return target["label"]


def video_id(target: dict):
    """-> target['video_id'] (reference target_transforms.py VideoID)."""
    return target["video_id"]


def compose_targets(*transforms: Callable):
    """Apply several target transforms, returning a list of their results
    (reference target_transforms.py Compose)."""
    def apply(target):
        return [t(target) for t in transforms]
    return apply
