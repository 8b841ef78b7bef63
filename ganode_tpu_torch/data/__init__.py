"""Data: rotated-MNIST videos and packed UCF101 with its offline pack, with
samplers that draw from an explicit ``numpy.random.Generator``, and
``prefetch`` (twin of ``ganode_tpu.data``; the rotated-MNIST builders, clip
indexing, frame folders and transforms wait for ROADMAP M15b).

``data/video.py`` (OpenCV decoding, for the pack) is not imported here:
training from a pack needs no OpenCV."""
from .loader import prefetch
from .rotmnist import RotMNISTImages, RotMNISTVideos, load_rotmnist, rotate_videos
from .sampling import ArrayClips, ArrayImages, Sampler
from .shapes import synthetic_moving_shapes
from .synthetic import moving_square_video, write_corpus
from .ucf101 import (
    PackedVideoDataset,
    UCF101ClipSampler,
    UCF101ImageSampler,
    pack_arrays,
    pack_ucf101,
    parse_class_index,
    parse_split,
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
    "moving_square_video",
    "pack_arrays",
    "pack_ucf101",
    "parse_class_index",
    "parse_split",
    "prefetch",
    "rotate_videos",
    "synthetic_moving_shapes",
    "write_corpus",
]
