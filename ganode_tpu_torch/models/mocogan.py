"""MoCoGAN video generator with a pluggable motion sampler (twin of the
generator half of ``ganode_tpu/models/mocogan.py``).

Layout: the public samplers keep the JAX package's channels-last layout,
images ``(B, H, W, C)`` and videos ``(B, T, H, W, C)``. Inside, the trunks are
PyTorch's NCHW: they take per-frame latents ``(B', dim_z)`` and return frames
``(B', C, H, W)`` in [-1, 1].

Latent contract: per frame ``z = [z_content (shared across the clip) ||
z_category (one-hot, optional) || z_motion (per frame)]``, decoded by a 2-D
deconv trunk applied to all ``n * T`` frames at once.

Submodules carry the flax names (``ConvTranspose_0``, ``BatchNorm_0``,
``Conv_0``, ``motion``, ``main``) so ``ganode_tpu_torch.bridge`` maps the JAX
variables onto ``state_dict`` keys by name. The discriminators wait for ROADMAP
M5; the dcgan128 trunk for M9; the gres64 and odegres64 trunks for M13.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .motion import draw_normal


def _deconv(in_ch: int, out_ch: int, kernel: int = 4, stride: int = 2,
            torch_padding: int = 1) -> nn.ConvTranspose2d:
    """ConvTranspose with torch (k, s, p) semantics: out = (in-1)*s - 2p + k."""
    return nn.ConvTranspose2d(in_ch, out_ch, kernel, stride, torch_padding,
                              bias=False)


def _bn(ch: int) -> nn.BatchNorm2d:
    # flax momentum 0.9 (weight of the old running value) == torch 0.1
    return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1)


class _DeconvPyramid(nn.Module):
    """z (B', dim_z) -> 1x1 -> 4 -> 8 -> 16 -> 32: four deconv+BN+ReLU stages
    with ngf*8, *4, *2, *1 channels, shared by both trunks."""

    def __init__(self, dim_z: int, ngf: int):
        super().__init__()
        chans = (dim_z, ngf * 8, ngf * 4, ngf * 2, ngf)
        for i in range(4):
            k, s, p = (4, 1, 0) if i == 0 else (4, 2, 1)
            self.add_module(f"ConvTranspose_{i}",
                            _deconv(chans[i], chans[i + 1], k, s, p))
            self.add_module(f"BatchNorm_{i}", _bn(chans[i + 1]))

    def init_parameters(self, generator: torch.Generator):
        """DCGAN init, as the JAX package has it: N(0, 0.02) convs (the
        subclass's last layer too); BatchNorm scale 1, bias 0, running stats
        reset."""
        for m in self.modules():
            if isinstance(m, (nn.ConvTranspose2d, nn.Conv2d)):
                nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.reset_running_stats()

    def pyramid(self, z: torch.Tensor) -> torch.Tensor:
        h = z[:, :, None, None]
        for i in range(4):
            h = getattr(self, f"ConvTranspose_{i}")(h)
            h = F.relu(getattr(self, f"BatchNorm_{i}")(h))
        return h


class DCGANTrunk64(_DeconvPyramid):
    """z (B', dim_z) -> frames (B', n_channels, 64, 64) in [-1, 1]."""

    def __init__(self, n_channels: int, ngf: int = 64, dim_z: int = 66):
        super().__init__(dim_z, ngf)
        self.ConvTranspose_4 = _deconv(ngf, n_channels)   # 32 -> 64

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.ConvTranspose_4(self.pyramid(z)))


class MNISTTrunk28(_DeconvPyramid):
    """z (B', dim_z) -> frames (B', n_channels, 28, 28) in [-1, 1].

    The pyramid to 32x32, then a 1x1 conv with a 2-pixel crop — the JAX
    package's equivalent of the reference's ConvTranspose2d(k=1, s=1, p=2).
    """

    def __init__(self, n_channels: int, ngf: int = 64, dim_z: int = 66):
        super().__init__(dim_z, ngf)
        self.Conv_0 = nn.Conv2d(ngf, n_channels, 1, bias=False)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(self.pyramid(z))
        return torch.tanh(h[:, :, 2:-2, 2:-2])            # 32 -> 28


TRUNKS = {"dcgan64": DCGANTrunk64, "mnist28": MNISTTrunk28}
TRUNKS_NOT_PORTED = {"dcgan128": "M9", "gres64": "M13", "odegres64": "M13"}


def make_trunk(name: str, n_channels: int, ngf: int, dim_z: int) -> nn.Module:
    if name in TRUNKS_NOT_PORTED:
        raise NotImplementedError(
            f"the {name!r} trunk waits for ROADMAP {TRUNKS_NOT_PORTED[name]}")
    if name not in TRUNKS:
        raise ValueError(f"unknown trunk {name!r}; choose from "
                         f"{sorted(TRUNKS) + sorted(TRUNKS_NOT_PORTED)}")
    return TRUNKS[name](n_channels, ngf, dim_z)


class VideoGenerator(nn.Module):
    """MoCoGAN generator: ``motion`` supplies the ``(n, T, dim_z_motion)``
    latent trajectory, ``main`` (the trunk) decodes each frame.

    Every sampler takes its noise as optional explicit tensors (``z_content``,
    ``labels``, ``frame_idx`` here; ``x0`` or ``h0``/``e`` passed on to the
    motion sampler) and draws the missing ones from ``generator``.
    """

    def __init__(self, motion: nn.Module, n_channels: int = 3,
                 dim_z_content: int = 50, dim_z_category: int = 0,
                 dim_z_motion: int = 16, video_length: int = 16,
                 ngf: int = 64, trunk: str = "dcgan64"):
        super().__init__()
        self.n_channels = n_channels
        self.dim_z_content = dim_z_content
        self.dim_z_category = dim_z_category
        self.dim_z_motion = dim_z_motion
        self.video_length = video_length
        self.motion = motion
        self.main = make_trunk(trunk, n_channels, ngf,
                               dim_z_content + dim_z_category + dim_z_motion)

    def init_parameters(self, generator: torch.Generator):
        self.motion.init_parameters(generator)
        self.main.init_parameters(generator)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _content(self, n, generator, z_content, labels):
        """-> (z_content (n, dim_z_content), one-hot categories or None, labels)."""
        dev = self.device
        if z_content is None:
            z_content = draw_normal((n, self.dim_z_content), generator, dev)
        one_hot = None
        if self.dim_z_category > 0:
            if labels is None:
                if generator is None:
                    raise ValueError("no torch.Generator given for the labels")
                labels = torch.randint(0, self.dim_z_category, (n,),
                                       generator=generator, device=dev)
            one_hot = F.one_hot(labels, self.dim_z_category).to(z_content.dtype)
        return z_content, one_hot, labels

    def sample_z_video(self, n: int, video_len: int, *, generator=None,
                       z_content=None, labels=None, **motion_noise):
        """Per-frame latents ``(n * video_len, dim_z)`` + category labels (or
        None). Rows are clip-major: row ``i * T + t`` is frame t of clip i."""
        z_content, one_hot, labels = self._content(n, generator, z_content,
                                                   labels)
        parts = [z_content.repeat_interleave(video_len, dim=0)]
        if one_hot is not None:
            parts.append(one_hot.repeat_interleave(video_len, dim=0))
        z_motion = self.motion(n, video_len, generator=generator,
                               **motion_noise)
        parts.append(z_motion.reshape(n * video_len, self.dim_z_motion))
        return torch.cat(parts, dim=1), labels

    def sample_videos(self, n: int, video_len: int | None = None, *,
                      generator=None, **noise):
        """-> (videos ``(n, T, H, W, C)`` in [-1, 1], category labels or None)."""
        video_len = video_len or self.video_length
        z, labels = self.sample_z_video(n, video_len, generator=generator,
                                        **noise)
        h = self.main(z)                                   # (n*T, C, H, W)
        h = h.reshape(n, video_len, *h.shape[1:])
        return h.permute(0, 1, 3, 4, 2), labels

    def sample_images(self, n: int, *, generator=None, z_content=None,
                      labels=None, frame_idx=None, **motion_noise):
        """-> (images ``(n, H, W, C)``, None): one uniformly random frame from
        each of n independent motion trajectories (the JAX package's sampler,
        ``ganode_tpu/models/mocogan.py:234-267``)."""
        video_len = self.video_length
        z_content, one_hot, _ = self._content(n, generator, z_content, labels)
        z_motion = self.motion(n, video_len, generator=generator,
                               **motion_noise)             # (n, T, dim)
        if frame_idx is None:
            if generator is None:
                raise ValueError("no torch.Generator given for the frame index")
            frame_idx = torch.randint(0, video_len, (n,), generator=generator,
                                      device=z_motion.device)
        z_motion = z_motion[torch.arange(n, device=z_motion.device), frame_idx]
        parts = [z_content] + ([one_hot] if one_hot is not None else [])
        z = torch.cat(parts + [z_motion], dim=1)
        return self.main(z).permute(0, 2, 3, 1), None

    def forward(self, n: int, **kwargs):
        """Default entry: ``sample_videos``."""
        return self.sample_videos(n, **kwargs)
