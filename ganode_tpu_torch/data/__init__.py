"""Data: rotated-MNIST videos with their builders, packed UCF101 with its
offline pack, clip indexing, frame folders, clip-consistent transforms,
samplers that draw from an explicit ``numpy.random.Generator``,
``prefetch`` and ``make_global_batch`` (twin of ``ganode_tpu.data``).

``data/video.py`` (OpenCV decoding, for the pack) imports OpenCV only inside
its decoding functions: training from a pack needs none."""
from . import transforms
from .clips import (
    ClipIndex,
    UCF101RandomClipSampler,
    UCF101SequentialClips,
    compute_clips_for_video,
    unfold,
)
from .frames import FrameFolderVideos, ImageFolderSampler, get_mean, get_std
from .loader import make_global_batch, prefetch
from .rotmnist import (
    RotMNISTImages,
    RotMNISTVideos,
    build_rotmnist,
    load_mnist_idx,
    load_rotmnist,
    load_sklearn_digits,
    rotate_videos,
)
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
    "ClipIndex",
    "FrameFolderVideos",
    "ImageFolderSampler",
    "PackedVideoDataset",
    "RotMNISTImages",
    "RotMNISTVideos",
    "Sampler",
    "UCF101ClipSampler",
    "UCF101ImageSampler",
    "UCF101RandomClipSampler",
    "UCF101SequentialClips",
    "build_rotmnist",
    "compute_clips_for_video",
    "get_mean",
    "get_std",
    "load_mnist_idx",
    "load_rotmnist",
    "load_sklearn_digits",
    "make_global_batch",
    "moving_square_video",
    "pack_arrays",
    "pack_ucf101",
    "parse_class_index",
    "parse_split",
    "prefetch",
    "rotate_videos",
    "synthetic_moving_shapes",
    "transforms",
    "unfold",
    "write_corpus",
]
