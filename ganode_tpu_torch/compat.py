"""Reference-style sampling sessions in torch layouts (twin of
``ganode_tpu/compat.py``).

The reference exposes ``gen.sample_videos(n) -> (videos (B, C, T, H, W),
labels)`` and ``gen.sample_images(n) -> ((B, C, H, W), None)``. A session owns
the generator module (in eval mode), a ``torch.Generator`` that advances with
every call, and the device, and returns channels-first tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import resolve_device
from .utils import layout


class GeneratorSession:
    """Stateful sampling facade over a generator module.

    >>> gen = make_generator("ode", n_channels=1, trunk="mnist28", device="cpu")
    >>> sess = GeneratorSession(gen, seed=0, device="cpu")
    >>> videos, labels = sess.sample_videos(32)     # (32, 1, 16, 28, 28)
    >>> images, _ = sess.sample_images(32)          # (32, 1, 28, 28)

    ``state_dict`` (a port ``state_dict``, e.g. from ``bridge.jax_to_torch``)
    replaces the module's weights when given. Sampling runs under
    ``torch.no_grad()`` with BatchNorm on its running statistics.
    """

    def __init__(self, gen, state_dict=None, *, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        if state_dict is not None:
            gen.load_state_dict(state_dict)
        self.gen = gen.to(self.device).eval()
        self.generator = torch.Generator(self.device).manual_seed(seed)

    @torch.no_grad()
    def sample_videos(self, num_samples: int, video_len: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (videos (B, C, T, H, W) in [-1, 1], category labels or None)."""
        videos, labels = self.gen.sample_videos(
            num_samples, video_len, generator=self.generator)
        return layout.video_to_torch(videos), labels

    @torch.no_grad()
    def sample_images(self, num_samples: int) -> Tuple[torch.Tensor, None]:
        """-> (images (B, C, H, W) in [-1, 1], None)."""
        images, _ = self.gen.sample_images(num_samples,
                                           generator=self.generator)
        return layout.image_to_torch(images), None
