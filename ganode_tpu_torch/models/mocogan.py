"""MoCoGAN video generator with a pluggable motion sampler, and the BatchNorm
discriminators (twin of ``ganode_tpu/models/mocogan.py``).

Layout: the public samplers keep the JAX package's channels-last layout,
images ``(B, H, W, C)`` and videos ``(B, T, H, W, C)``. Inside, the trunks are
PyTorch's NCHW: they take per-frame latents ``(B', dim_z)`` and return frames
``(B', C, H, W)`` in [-1, 1].

Latent contract: per frame ``z = [z_content (shared across the clip) ||
z_category (one-hot, optional) || z_motion (per frame)]``, decoded by a 2-D
deconv trunk applied to all ``n * T`` frames at once.

Submodules carry the flax names (``ConvTranspose_0``, ``BatchNorm_0``,
``Conv_0``, ``FastGradConv3D_0``, ``motion``, ``main``) so
``ganode_tpu_torch.bridge`` maps the JAX variables onto ``state_dict`` keys by
name. BatchNorm has flax's semantics (``nn.layers.BatchNorm``): train mode
matches flax ``apply(train=True, mutable=["batch_stats"])``, running variance
included. The dcgan128 trunk and the spectral-norm discriminators wait for
ROADMAP M9; the gres64 and odegres64 trunks for M13.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import BatchNorm, Noise, leaky_relu
from ..ops import conv3d_first
from .motion import draw_normal


def _deconv(in_ch: int, out_ch: int, kernel: int = 4, stride: int = 2,
            torch_padding: int = 1) -> nn.ConvTranspose2d:
    """ConvTranspose with torch (k, s, p) semantics: out = (in-1)*s - 2p + k."""
    return nn.ConvTranspose2d(in_ch, out_ch, kernel, stride, torch_padding,
                              bias=False)


def _bn(ch: int) -> BatchNorm:
    # flax momentum 0.9 (weight of the old running value) == torch 0.1
    return BatchNorm(ch, eps=1e-5, momentum=0.1)


def _dcgan_init(module: nn.Module, generator: torch.Generator):
    """DCGAN init, as the JAX package has it: N(0, 0.02) conv kernels;
    BatchNorm scale 1, bias 0, running stats reset."""
    for m in module.modules():
        if isinstance(m, (nn.ConvTranspose2d, nn.Conv2d, nn.Conv3d,
                          FastGradConv3D)):
            nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
        elif isinstance(m, BatchNorm):
            m.reset_parameters()


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
        """``_dcgan_init``, the subclass's last layer included."""
        _dcgan_init(self, generator)

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

    def draw_noise(self, n: int, what: str, generator) -> dict:
        """The noise one ``sample_videos(n)`` (``what="videos"``) or
        ``sample_images(n)`` (``"images"``) consumes, drawn from
        ``generator`` on its device, as keyword arguments for that call: the
        motion sampler's, ``z_content``, ``labels`` with categories, and
        ``frame_idx`` for images. Drawn on the CPU, it replays one sample on
        any device."""
        if what not in ("videos", "images"):
            raise ValueError(f"what must be 'videos' or 'images', not {what!r}")
        dev = generator.device
        t = self.video_length
        noise = self.motion.draw_noise(n, t, generator)
        noise["z_content"] = draw_normal((n, self.dim_z_content), generator,
                                         dev)
        if self.dim_z_category > 0:
            noise["labels"] = torch.randint(0, self.dim_z_category, (n,),
                                            generator=generator, device=dev)
        if what == "images":
            noise["frame_idx"] = torch.randint(0, t, (n,),
                                               generator=generator, device=dev)
        return noise

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


# ---------------------------------------------------------------------------
# Discriminators (``ganode_tpu/models/mocogan.py:280-512``). Each takes the JAX
# layout, images ``(B, H, W, C)`` or videos ``(B, T, H, W, C)``, runs NCHW /
# NCDHW inside, and returns ``(logits, aux)``: the last layer's output moved
# to channels-last and squeezed of every size-1 axis, as ``jnp.squeeze`` does
# (a batch of one loses its batch axis too). Train mode normalises by batch
# statistics and advances the running ones, as the JAX modules' default
# ``train=True`` does. ``generator`` feeds the additive-noise layers, which no
# config turns on.
# ---------------------------------------------------------------------------


def _conv2d(in_ch: int, out_ch: int, k: int = 4, s: int = 2,
            p: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, k, s, p, bias=False)


def _conv3d(in_ch: int, out_ch: int, k, s, p) -> nn.Conv3d:
    return nn.Conv3d(in_ch, out_ch, k, s, p, bias=False)


def _squeeze(h: torch.Tensor) -> torch.Tensor:
    """NC... -> channels-last, then every size-1 axis dropped."""
    return h.movedim(1, -1).squeeze()


class FastGradConv3D(nn.Module):
    """First video-discriminator conv: kernel 4x4x4, stride (1, 2, 2),
    padding (0, 1, 1), no bias (``ops.conv3d_first``). Named as flax names it,
    so its weight is ``FastGradConv3D_0.weight``."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_ch, 4, 4, 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d_first(x, self.weight)


class _Discriminator(nn.Module):
    def __init__(self, use_noise: bool, noise_sigma: float | None):
        super().__init__()
        # one layer serves every call site: it holds no parameters
        self.noise = Noise(use_noise, noise_sigma or 0.0)

    def init_parameters(self, generator: torch.Generator):
        _dcgan_init(self, generator)


class ImageDiscriminator(_Discriminator):
    """64x64 image discriminator -> one logit per image."""

    def __init__(self, n_channels: int = 3, ndf: int = 64,
                 use_noise: bool = False, noise_sigma: float | None = None):
        super().__init__(use_noise, noise_sigma)
        chans = (n_channels, ndf, ndf * 2, ndf * 4, ndf * 8)
        for i in range(4):
            self.add_module(f"Conv_{i}", _conv2d(chans[i], chans[i + 1]))
        for i in range(3):
            self.add_module(f"BatchNorm_{i}", _bn(chans[i + 2]))
        self.Conv_4 = _conv2d(ndf * 8, 1, 4, 1, 0)

    def forward(self, x: torch.Tensor, *, generator=None):
        noise = lambda h: self.noise(h, generator=generator)
        h = leaky_relu(self.Conv_0(noise(x.permute(0, 3, 1, 2))))
        for i in range(3):
            h = getattr(self, f"Conv_{i + 1}")(noise(h))
            h = leaky_relu(getattr(self, f"BatchNorm_{i}")(h))
        return _squeeze(self.Conv_4(h)), None


class PatchImageDiscriminator(_Discriminator):
    """Patch image discriminator -> a logit map (4x4 at 64x64, one logit at
    28x28)."""

    def __init__(self, n_channels: int = 3, ndf: int = 64,
                 use_noise: bool = False, noise_sigma: float | None = None):
        super().__init__(use_noise, noise_sigma)
        chans = (n_channels, ndf, ndf * 2, ndf * 4, 1)
        for i in range(4):
            self.add_module(f"Conv_{i}", _conv2d(chans[i], chans[i + 1]))
        for i in range(2):
            self.add_module(f"BatchNorm_{i}", _bn(chans[i + 2]))

    def forward(self, x: torch.Tensor, *, generator=None):
        noise = lambda h: self.noise(h, generator=generator)
        h = leaky_relu(self.Conv_0(noise(x.permute(0, 3, 1, 2))))
        for i in range(2):
            h = getattr(self, f"Conv_{i + 1}")(noise(h))
            h = leaky_relu(getattr(self, f"BatchNorm_{i}")(h))
        return _squeeze(self.Conv_3(noise(h))), None


_K3, _S3, _P3 = (4, 4, 4), (1, 2, 2), (0, 1, 1)


class PatchVideoDiscriminator(_Discriminator):
    """3-D patch video discriminator, input ``(B, T, H, W, C)``."""

    def __init__(self, n_channels: int = 3, ndf: int = 64,
                 use_noise: bool = False, noise_sigma: float | None = None):
        super().__init__(use_noise, noise_sigma)
        self.FastGradConv3D_0 = FastGradConv3D(n_channels, ndf)
        chans = (ndf, ndf * 2, ndf * 4, 1)
        for i in range(3):
            self.add_module(f"Conv_{i}",
                            _conv3d(chans[i], chans[i + 1], _K3, _S3, _P3))
        for i in range(2):
            self.add_module(f"BatchNorm_{i}", _bn(chans[i + 1]))

    def forward(self, x: torch.Tensor, *, generator=None):
        noise = lambda h: self.noise(h, generator=generator)
        h = leaky_relu(self.FastGradConv3D_0(noise(x.permute(0, 4, 1, 2, 3))))
        for i in range(2):
            h = getattr(self, f"Conv_{i}")(noise(h))
            h = leaky_relu(getattr(self, f"BatchNorm_{i}")(h))
        return _squeeze(self.Conv_2(h)), None


class VideoDiscriminator(_Discriminator):
    """Full video discriminator with a cubic ``ksize`` kernel (2 for 28x28
    clips, 4 for 64x64), input ``(B, T, H, W, C)``. Five unpadded time convs
    each take ``ksize - 1`` frames: a clip shorter than ``5 * ksize - 4``
    frames is refused. At ``ksize=4`` the first conv is ``FastGradConv3D_0``
    and the others are ``Conv_0..3``; otherwise they are ``Conv_0..4``."""

    def __init__(self, n_channels: int = 3, n_output_neurons: int = 1,
                 ndf: int = 64, ksize: int = 4, use_noise: bool = False,
                 noise_sigma: float | None = None):
        super().__init__(use_noise, noise_sigma)
        self.ksize = ksize
        k = (ksize,) * 3
        if ksize == 4:
            self.FastGradConv3D_0 = FastGradConv3D(n_channels, ndf)
        else:
            self.Conv_0 = _conv3d(n_channels, ndf, k, _S3, _P3)
        j = 0 if ksize == 4 else 1  # index of the first BatchNorm'd conv
        self._names = (["FastGradConv3D_0" if ksize == 4 else "Conv_0"]
                       + [f"Conv_{j + i}" for i in range(4)])
        chans = (ndf, ndf * 2, ndf * 4, ndf * 8)
        for i in range(3):
            self.add_module(self._names[i + 1],
                            _conv3d(chans[i], chans[i + 1], k, _S3, _P3))
            self.add_module(f"BatchNorm_{i}", _bn(chans[i + 1]))
        self.add_module(self._names[4],
                        _conv3d(ndf * 8, n_output_neurons, k, 1, 0))

    def forward(self, x: torch.Tensor, *, generator=None):
        min_t = 5 * self.ksize - 4
        if x.shape[1] < min_t:
            raise ValueError(
                f"VideoDiscriminator(ksize={self.ksize}) needs clips with at "
                f"least {min_t} frames, got T={x.shape[1]}")
        noise = lambda h: self.noise(h, generator=generator)
        first, *body, last = (getattr(self, n) for n in self._names)
        h = leaky_relu(first(noise(x.permute(0, 4, 1, 2, 3))))
        for i, conv in enumerate(body):
            h = leaky_relu(getattr(self, f"BatchNorm_{i}")(conv(noise(h))))
        return _squeeze(last(h)), None


class CategoricalVideoDiscriminator(_Discriminator):
    """Video discriminator emitting ``(realness logits, category logits)``,
    split along the channel (last) axis of ``VideoDiscriminator_0``'s
    output."""

    def __init__(self, dim_categorical: int, n_channels: int = 3,
                 n_output_neurons: int = 1, ndf: int = 64, ksize: int = 4,
                 use_noise: bool = False, noise_sigma: float | None = None):
        super().__init__(use_noise, noise_sigma)
        self.dim_categorical = dim_categorical
        self.VideoDiscriminator_0 = VideoDiscriminator(
            n_channels, n_output_neurons + dim_categorical, ndf, ksize,
            use_noise, noise_sigma)

    def forward(self, x: torch.Tensor, *, generator=None):
        h, _ = self.VideoDiscriminator_0(x, generator=generator)
        split = h.shape[-1] - self.dim_categorical
        return h[..., :split], h[..., split:]


IMAGE_DISCRIMINATORS = {"patch": PatchImageDiscriminator,
                        "full": ImageDiscriminator}
VIDEO_DISCRIMINATORS = {"full": VideoDiscriminator,
                        "patch": PatchVideoDiscriminator}
# the spectral-norm critics (SNImageDiscriminator, SNVideoDiscriminator)
DISCRIMINATORS_NOT_PORTED = {"sn": "M9"}
