"""The draw/gather split every batch sampler of the package follows, and the
two samplers over an in-memory dataset ``videos (N, T, H, W, C)``.

``draw(rng)`` takes a batch's random picks from an explicit
``numpy.random.Generator``; ``gather(*draws)`` is a deterministic function of
them. The JAX samplers draw the same quantities with ``jax.random``; the two
frameworks give different numbers from one seed, so the gathers are what the
tests hold against JAX.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


class Sampler:
    def sample(self, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """``gather(*draw(rng))``: one batch and its labels."""
        return self.gather(*self.draw(rng))

    def iterate(self, rng: np.random.Generator
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """``sample(rng)`` forever, every batch drawn from the one ``rng``
        (the JAX samplers' ``iterate(key)`` folds a counter into the key)."""
        while True:
            yield self.sample(rng)


class ArrayImages(Sampler):
    """One random frame of each of ``batch_size`` random clips ->
    ``(B, H, W, C)``."""

    def __init__(self, videos: np.ndarray, labels: np.ndarray, batch_size: int):
        self.videos, self.labels = videos, np.asarray(labels)
        self.batch_size = batch_size

    def draw(self, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        return (rng.integers(0, len(self.videos), self.batch_size),
                rng.integers(0, self.videos.shape[1], self.batch_size))

    def gather(self, idx, frames) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.asarray(idx)
        return self.videos[idx, np.asarray(frames)], self.labels[idx]


class ArrayClips(Sampler):
    """Random ``n_frame`` windows of random clips -> ``(B, n_frame, H, W, C)``;
    ``n_frame=None`` takes whole clips."""

    def __init__(self, videos: np.ndarray, labels: np.ndarray, batch_size: int,
                 n_frame: Optional[int] = None):
        self.videos, self.labels = videos, np.asarray(labels)
        self.batch_size = batch_size
        self.n_frame = videos.shape[1] if n_frame is None else n_frame

    def draw(self, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        # whole clips have one start; numpy draws no bits for a range of one
        return (rng.integers(0, len(self.videos), self.batch_size),
                rng.integers(0, self.videos.shape[1] - self.n_frame + 1,
                             self.batch_size))

    def gather(self, idx, starts) -> Tuple[np.ndarray, np.ndarray]:
        """Clips ``idx``, each from its frame in ``starts``."""
        idx = np.asarray(idx)
        frames = np.asarray(starts)[:, None] + np.arange(self.n_frame)
        return self.videos[idx[:, None], frames], self.labels[idx]
