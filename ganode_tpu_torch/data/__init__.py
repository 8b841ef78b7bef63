"""Data: rotated-MNIST videos and packed UCF101, with samplers that draw from
an explicit ``numpy.random.Generator`` (twin of ``ganode_tpu.data``; the
offline dataset preparation, decoding, clip indexing, transforms and the
native loader wait for ROADMAP M15)."""
from .rotmnist import RotMNISTImages, RotMNISTVideos, load_rotmnist, rotate_videos
from .sampling import ArrayClips, ArrayImages, Sampler
from .shapes import synthetic_moving_shapes
from .ucf101 import (
    PackedVideoDataset,
    UCF101ClipSampler,
    UCF101ImageSampler,
    pack_arrays,
)

__all__ = [
    "ArrayClips",
    "ArrayImages",
    "PackedVideoDataset",
    "RotMNISTImages",
    "RotMNISTVideos",
    "Sampler",
    "UCF101ClipSampler",
    "UCF101ImageSampler",
    "load_rotmnist",
    "pack_arrays",
    "rotate_videos",
    "synthetic_moving_shapes",
]
