"""Rotated-MNIST videos: digits rotated into clips, the offline preparation
(``load_mnist_idx``, ``load_sklearn_digits``, ``build_rotmnist``), the
loader and the batch samplers (twin of ``ganode_tpu/data/rotmnist.py``).

The samplers are ``data/sampling.py``'s in-memory ones (a draw from a
``numpy.random.Generator``, then a gather) over the rescaled clips.

Loader semantics (reference dataset/mnist_rotation.py:18-23,57-63): the
train split is the first ``split`` videos, the test split the rest; the
video sampler yields whole clips, the image sampler one uniformly random
frame per clip; values stay in [0, 1] as the reference feeds them (real data
in [0, 1] against tanh fakes in [-1, 1]) unless ``value_range`` rescales them.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
from scipy import ndimage

from .sampling import ArrayClips, ArrayImages


def rotate_videos(
    images: np.ndarray,
    labels: np.ndarray,
    *,
    num_frames: int = 16,
    mode: str = "normal",
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """images: (N, 28, 28) float in [-0.5, 0.5] (MNIST rescaled); labels: (N,).

    Returns X (N, K, 784) in [0, 1], Y (N,). Modes (reference
    utils/images.py:107-136): 'normal' turns once clockwise, angles
    linspace(0, 359.99, K); 'rand-end' ends at a random angle in
    ±(90..360); 'rsre' starts at a random angle in ±90 and ends in ±270.
    Each frame is ``scipy.ndimage.rotate(reshape=False)`` on a -0.5
    background, then min-max renormalised to [0, 1].
    """
    if mode not in ("normal", "rand-end", "rsre"):
        raise ValueError(f"mode must be normal|rand-end|rsre, got {mode!r}")
    rng = np.random.RandomState(seed)
    n = len(images)
    K = num_frames
    X = np.zeros((n, K, 784), np.float32)
    bg = -0.5

    base_angles = np.linspace(0, 359.99, K)
    for i, img in enumerate(images):
        if mode == "rand-end":
            end = rng.uniform(-269.99, 269.99)
            end = end - 90 if end < 0 else end + 90
            angles = np.linspace(0, end, K)
        elif mode == "rsre":
            start = rng.uniform(-89.99, 89.99)
            end = rng.uniform(-269.99, 269.99)
            angles = np.linspace(start, end, K)
        else:
            angles = base_angles
        for k, angle in enumerate(angles):
            frame = ndimage.rotate(img, angle, reshape=False, cval=bg)
            X[i, k] = frame.reshape(784)

    # per-frame min-max renormalization to [0, 1] (utils/images.py:166-167)
    span = X.max(axis=2, keepdims=True) - X.min(axis=2, keepdims=True)
    X = X / np.maximum(span, 1e-12)
    X = X - X.min(axis=2, keepdims=True)
    return X, np.asarray(labels).reshape(-1)


def load_mnist_idx(data_dir: str, split: str = "train",
                   num: Optional[int] = None):
    """Read raw MNIST idx.gz files (the format the reference downloads,
    utils/images.py:64-94). Returns (images (N, 28, 28) in [-0.5, 0.5],
    labels)."""
    import gzip

    prefix = "train" if split == "train" else "t10k"
    img_path = os.path.join(data_dir, f"{prefix}-images-idx3-ubyte.gz")
    lbl_path = os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte.gz")
    with gzip.open(img_path) as f:
        f.read(16)
        data = np.frombuffer(f.read(), np.uint8).astype(np.float32)
    images = ((data - 127.5) / 255.0).reshape(-1, 28, 28)
    with gzip.open(lbl_path) as f:
        f.read(8)
        labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)
    if num is not None:
        images, labels = images[:num], labels[:num]
    return images, labels


def load_sklearn_digits(num: Optional[int] = None, seed: int = 0):
    """Real handwritten digits without network access: scikit-learn's bundled
    8x8 scans (1797 of them), bicubic-upscaled to MNIST's 28x28 geometry.
    Returns (images (N, 28, 28) float32 in [-0.5, 0.5], labels (N,) int64),
    shuffled by ``seed`` so that the classes mix as in MNIST. scikit-learn
    is imported only here."""
    from sklearn.datasets import load_digits

    d = load_digits()
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(d.images))
    if num is not None and num < len(order):
        order = order[:num]
    small = d.images[order] / 16.0  # (N, 8, 8) in [0, 1]
    labels = d.target[order].astype(np.int64)
    images = np.stack([
        ndimage.zoom(img, 28 / 8, order=3) for img in small
    ]).astype(np.float32)
    return np.clip(images, 0.0, 1.0) - 0.5, labels


def synthetic_digits(num: int, seed: int = 0):
    """Up to 1000 procedural 8x8 squares on a -0.5 background, with random
    labels: the ``--synthetic`` input of ``build_rotmnist``."""
    rng = np.random.RandomState(seed)
    n = min(num, 1000)
    images = np.full((n, 28, 28), -0.5, np.float32)
    for i in range(n):
        y, x = rng.randint(4, 18, 2)
        images[i, y:y + 8, x:x + 8] = 0.5
    return images, rng.randint(0, 10, n)


def build_rotmnist(out_path: str, images: np.ndarray, labels: np.ndarray, *,
                   num_frames: int = 16, mode: str = "normal", seed: int = 0,
                   digits: Optional[Tuple[int, ...]] = None) -> str:
    """Build and save a rotated-MNIST video dataset (``X (N, K, 784)``,
    ``Y (N,)`` in a compressed ``.npz``).

    ``digits`` filters to those classes (the reference's 3s-only variant,
    rot-mnist-3s.mat, mnist_moco_ode_wgan.py:30 == digits=(3,))."""
    labels = np.asarray(labels).reshape(-1)
    if digits is not None:
        keep = np.isin(labels, digits)
        images, labels = images[keep], labels[keep]
    X, Y = rotate_videos(images, labels, num_frames=num_frames, mode=mode,
                         seed=seed)
    np.savez_compressed(out_path, X=X, Y=Y)
    return out_path


def load_rotmnist(path: str, *, train: bool = True, split: int = 500,
                  num_frames: int = 16,
                  digits: Optional[Tuple[int, ...]] = None,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Load .npz (the JAX package's) or .mat (the reference's interchange
    format). Returns videos (N, T, 28, 28, 1) float32 and labels (N,).

    ``digits`` filters to those classes before the train/test split: a
    mixed-digit file with digits=(3,) behaves as the reference's
    pre-filtered rot-mnist-3s.mat (mnist_moco_ode_wgan.py:30)."""
    if path.endswith(".mat"):
        from scipy.io import loadmat
        data = loadmat(path)
        X = np.asarray(data["X"]).squeeze()
        Y = np.asarray(data["Y"]).squeeze()
    else:
        data = np.load(path)
        X, Y = data["X"], data["Y"]
    X = X.reshape(-1, num_frames, 28, 28, 1).astype(np.float32)
    Y = Y.reshape(-1).astype(np.int64)
    if digits is not None:
        keep = np.isin(Y, digits)
        X, Y = X[keep], Y[keep]
        if len(X) == 0:
            raise ValueError(f"no videos with digits {digits} in {path}")
    if train:
        return X[:split], Y[:split]
    return X[split:], Y[split:]


def _rescaled(videos: np.ndarray, value_range: Tuple[float, float]):
    videos = np.asarray(videos, np.float32)
    lo, hi = value_range
    return videos if (lo, hi) == (0.0, 1.0) else videos * (hi - lo) + lo


class RotMNISTVideos(ArrayClips):
    """Batch sampler of whole clips (B, T, 28, 28, 1)."""

    def __init__(self, videos: np.ndarray, labels: np.ndarray, batch_size: int,
                 *, value_range: Tuple[float, float] = (0.0, 1.0)):
        super().__init__(_rescaled(videos, value_range), labels, batch_size)


class RotMNISTImages(ArrayImages):
    """Batch sampler of one random frame per clip (B, 28, 28, 1)
    (reference dataset/mnist_rotation.py:57-63)."""

    def __init__(self, videos: np.ndarray, labels: np.ndarray, batch_size: int,
                 *, value_range: Tuple[float, float] = (0.0, 1.0)):
        super().__init__(_rescaled(videos, value_range), labels, batch_size)
