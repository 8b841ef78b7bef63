"""Frame-folder datasets: UCF101-style directories of extracted JPEGs, and
generic image-folder sampling (twin of ``ganode_tpu/data/frames.py``).

The reference's legacy loaders (SURVEY.md §2.3 #17, #20):

* ``FrameFolderVideos``: the first-generation UCF101 loader read
  ``image_{:05d}.jpg`` frames plus an ``n_frames`` count file per video
  directory (reference dataset/ucf101.py:45-56,102-185). Same directory
  contract, decoded with PIL, served as clip batches;
* ``ImageFolderSampler``: the generic LSUN/ImageNet/CelebA image loader
  (reference dataset/data_loader.py:28-69): a class-per-subdirectory image
  tree -> resized batches in [-1, 1].

Both follow the package's draw/gather split (``data/sampling.py``). PIL is
imported only where an image is decoded. Also the ActivityNet/Kinetics
normalization constants the reference kept in dataset/mean.py.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from .sampling import Sampler


def get_mean(norm_value: float = 255.0,
             dataset: str = "activitynet") -> List[float]:
    """Channel means (reference dataset/mean.py:1-14)."""
    if dataset == "activitynet":
        return [114.7748 / norm_value, 107.7354 / norm_value,
                99.4750 / norm_value]
    if dataset == "kinetics":
        return [110.63666788 / norm_value, 103.16065604 / norm_value,
                96.29023126 / norm_value]
    raise ValueError(f"unknown dataset {dataset!r}")


def get_std(norm_value: float = 255.0) -> List[float]:
    """Kinetics channel stds (reference dataset/mean.py:17-21)."""
    return [38.7568578 / norm_value, 37.88248729 / norm_value,
            40.02898126 / norm_value]


def _load_image(path: str, size: Optional[int] = None) -> np.ndarray:
    from PIL import Image

    im = Image.open(path).convert("RGB")
    if size is not None:
        im = im.resize((size, size), Image.BICUBIC)
    return np.asarray(im, np.uint8)


def _to_unit(x: np.ndarray) -> np.ndarray:
    return (x.astype(np.float32) - 128.0) / 128.0


class FrameFolderVideos(Sampler):
    """Video directories of ``image_{:05d}.jpg`` frames:

      root/<class>/<video_id>/image_00001.jpg ...
      root/<class>/<video_id>/n_frames            (one integer)

    (the reference's jpg-extraction layout, dataset/ucf101.py:102-135).
    """

    def __init__(self, root: str, batch_size: int, *, n_frame: int = 16,
                 image_size: Optional[int] = None,
                 frame_tmpl: str = "image_{:05d}.jpg"):
        self.root = root
        self.batch_size = batch_size
        self.n_frame = n_frame
        self.image_size = image_size
        self.frame_tmpl = frame_tmpl
        self.samples: List[Tuple[str, int, int]] = []  # (dir, n_frames, label)
        self.classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        for label, cls in enumerate(self.classes):
            cls_dir = os.path.join(root, cls)
            for vid in sorted(os.listdir(cls_dir)):
                vdir = os.path.join(cls_dir, vid)
                nf_file = os.path.join(vdir, "n_frames")
                if os.path.isfile(nf_file):
                    with open(nf_file) as f:
                        n = int(f.read().strip())
                else:
                    n = len([f for f in os.listdir(vdir)
                             if f.startswith("image_") and f.endswith(".jpg")])
                if n >= n_frame:
                    self.samples.append((vdir, n, label))
        if not self.samples:
            raise ValueError(
                f"no video dirs with >= {n_frame} frames under {root}")

    def _clip(self, vdir: str, start: int) -> np.ndarray:
        return np.stack([
            _load_image(os.path.join(vdir, self.frame_tmpl.format(start + 1 + i)),
                        self.image_size)
            for i in range(self.n_frame)])

    def draw(self, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """(a video pick, a uniform in [0, 1) for its start) per clip."""
        return (rng.integers(0, len(self.samples), self.batch_size),
                rng.random(self.batch_size))

    def gather(self, pick, u) -> Tuple[np.ndarray, np.ndarray]:
        """The clip of video ``pick`` starting at ``u`` of its possible
        starts, for each pair -> ((B, n_frame, H, W, 3) in [-1, 1], labels)."""
        clips, labels = [], []
        for p, uj in zip(np.asarray(pick), np.asarray(u)):
            vdir, n, label = self.samples[int(p)]
            clips.append(self._clip(vdir, int(uj * (n - self.n_frame + 1))))
            labels.append(label)
        return _to_unit(np.stack(clips)), np.asarray(labels)


class ImageFolderSampler(Sampler):
    """A class-per-subdirectory (or flat) image tree -> batches in [-1, 1]
    (reference dataset/data_loader.py served LSUN/ImageNet/CelebA so)."""

    EXTS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(self, root: str, batch_size: int, *, image_size: int = 64):
        self.batch_size = batch_size
        self.image_size = image_size
        self.paths: List[str] = []
        labels: List[int] = []
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        if classes:
            for label, cls in enumerate(classes):
                for f in sorted(os.listdir(os.path.join(root, cls))):
                    if f.lower().endswith(self.EXTS):
                        self.paths.append(os.path.join(root, cls, f))
                        labels.append(label)
        else:  # flat directory of images
            for f in sorted(os.listdir(root)):
                if f.lower().endswith(self.EXTS):
                    self.paths.append(os.path.join(root, f))
                    labels.append(0)
        if not self.paths:
            raise ValueError(f"no images under {root}")
        self.labels = np.asarray(labels)

    def draw(self, rng: np.random.Generator) -> Tuple[np.ndarray]:
        return (rng.integers(0, len(self.paths), self.batch_size),)

    def gather(self, pick) -> Tuple[np.ndarray, np.ndarray]:
        pick = np.asarray(pick)
        imgs = np.stack([_load_image(self.paths[int(p)], self.image_size)
                         for p in pick])
        return _to_unit(imgs), self.labels[pick]
