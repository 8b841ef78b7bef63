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
included. The spectral-norm critics keep their power-iteration state in
``u`` buffers (``nn.spectral``).

Trunks: ``dcgan64``, ``dcgan128`` and ``mnist28`` are deconv pyramids;
``gres64`` and ``odegres64`` (``GResTrunk64``) are the stage-1 GResBlock
trunks, whose blocks (``nn.gresblock``) hold spectral-norm ``u`` state of
their own, advanced by every train-mode sample, and whose continuous-depth
form normalises inside its ODE field by the batch's statistics in eval mode
too: a served frame depends on the frames decoded in the same call, as in
JAX, so the samplers decode all frames of a call at once.

Compute dtype (``dtype``, the JAX modules' ``dtype=``): given one
(``torch.bfloat16`` for ``compute_dtype="bfloat16"``), the trunks and the
BatchNorm discriminators cast their input and each convolution's weight to
it, as flax's ``dtype`` promotes both, and return float32 where JAX casts
back; the parameters stay float32, and BatchNorm computes its statistics in
float32 as flax does (``nn.layers.BatchNorm``). With none (``None``, the
float32 configs) nothing is cast: the modules compute in their parameters'
dtype, float32, or float64 for a float64 reference run. The spectral-norm
critics and the GRes trunks take no dtype and run float32, as in JAX
(``GResTrunk64`` never uses its ``dtype``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.gresblock import GResBlock, ODEGResBlock
from ..nn.layers import BatchNorm, Noise, leaky_relu
from ..nn.spectral import SNConv
from ..ops import conv3d_first
from .motion import draw_normal


def _deconv(in_ch: int, out_ch: int, kernel: int = 4, stride: int = 2,
            torch_padding: int = 1) -> nn.ConvTranspose2d:
    """ConvTranspose with torch (k, s, p) semantics: out = (in-1)*s - 2p + k."""
    return nn.ConvTranspose2d(in_ch, out_ch, kernel, stride, torch_padding,
                              bias=False)


def _cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` in the compute dtype, or as it is without one."""
    return x if dtype is None else x.to(dtype)


def _back(h: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """An output back in float32 where JAX casts it, under a compute dtype."""
    return h if dtype is None else h.float()


def _run(layer: nn.Module, x: torch.Tensor,
         dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A bias-free convolution or transposed convolution computed in
    ``dtype``: its input and its float32 weight cast, as flax's ``dtype``
    promotes both. Without a compute dtype it is the layer's own call."""
    if dtype is None or dtype == layer.weight.dtype:
        return layer(x)
    w = layer.weight.to(dtype)
    if isinstance(layer, nn.ConvTranspose2d):
        return F.conv_transpose2d(x.to(dtype), w, None, layer.stride,
                                  layer.padding, layer.output_padding,
                                  layer.groups, layer.dilation)
    return layer._conv_forward(x.to(dtype), w, None)


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
    """z (B', dim_z) -> 1x1 -> 4 -> 8 -> ...: one deconv+BN+ReLU stage per
    entry of ``mults``, with ``ngf * mult`` channels (8, 4, 2, 1: to 32x32),
    in the compute dtype ``dtype``."""

    def __init__(self, dim_z: int, ngf: int, dtype: Optional[torch.dtype],
                 mults=(8, 4, 2, 1)):
        super().__init__()
        self.dtype = dtype
        self.n_stages = len(mults)
        chans = (dim_z,) + tuple(ngf * m for m in mults)
        for i in range(self.n_stages):
            k, s, p = (4, 1, 0) if i == 0 else (4, 2, 1)
            self.add_module(f"ConvTranspose_{i}",
                            _deconv(chans[i], chans[i + 1], k, s, p))
            self.add_module(f"BatchNorm_{i}", _bn(chans[i + 1]))

    def init_parameters(self, generator: torch.Generator):
        """``_dcgan_init``, the subclass's last layer included."""
        _dcgan_init(self, generator)

    def pyramid(self, z: torch.Tensor) -> torch.Tensor:
        h = _cast(z[:, :, None, None], self.dtype)
        for i in range(self.n_stages):
            h = _run(getattr(self, f"ConvTranspose_{i}"), h, self.dtype)
            h = F.relu(getattr(self, f"BatchNorm_{i}")(h))
        return h


class DCGANTrunk64(_DeconvPyramid):
    """z (B', dim_z) -> frames (B', n_channels, 64, 64) in [-1, 1]."""

    frame_size = 64

    def __init__(self, n_channels: int, ngf: int = 64, dim_z: int = 66,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(dim_z, ngf, dtype)
        self.ConvTranspose_4 = _deconv(ngf, n_channels)   # 32 -> 64

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run(self.ConvTranspose_4, self.pyramid(z), self.dtype)
        return _back(torch.tanh(h), self.dtype)


class DCGANTrunk128(_DeconvPyramid):
    """z (B', dim_z) -> frames (B', n_channels, 128, 128) in [-1, 1]: the
    dcgan64 pyramid with one more doubling stage, ngf*16 channels first
    (``ganode_tpu/models/mocogan.py:105``)."""

    frame_size = 128

    def __init__(self, n_channels: int, ngf: int = 64, dim_z: int = 66,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(dim_z, ngf, dtype, mults=(16, 8, 4, 2, 1))
        self.ConvTranspose_5 = _deconv(ngf, n_channels)   # 64 -> 128

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run(self.ConvTranspose_5, self.pyramid(z), self.dtype)
        return _back(torch.tanh(h), self.dtype)


class MNISTTrunk28(_DeconvPyramid):
    """z (B', dim_z) -> frames (B', n_channels, 28, 28) in [-1, 1].

    The pyramid to 32x32, then a 1x1 conv with a 2-pixel crop — the JAX
    package's equivalent of the reference's ConvTranspose2d(k=1, s=1, p=2).
    """

    frame_size = 28

    def __init__(self, n_channels: int, ngf: int = 64, dim_z: int = 66,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(dim_z, ngf, dtype)
        self.Conv_0 = nn.Conv2d(ngf, n_channels, 1, bias=False)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run(self.Conv_0, self.pyramid(z), self.dtype)
        return _back(torch.tanh(h[:, :, 2:-2, 2:-2]), self.dtype)  # 32 -> 28


class GResTrunk64(nn.Module):
    """z (B', dim_z) -> frames (B', n_channels, 64, 64) in [-1, 1]: the
    DVD-GAN-class trunk from GResBlocks (``ganode_tpu/models/mocogan.py:
    133``). ``Dense_0`` to a 4x4 seed of ngf*8 channels, four up-sampling
    blocks ``block_0..3`` (ngf*8, 4, 2, 1 channels; conditioned on z
    itself), ``BatchNorm_0``, ReLU, a 3x3 ``SNConv_0``, tanh.

    ``continuous_depth`` makes each block an ``ODEGResBlock`` (rk4, in
    ``ode_steps`` steps): ``odegres64``. ``dtype`` is taken and not used:
    the blocks run in the parameters' dtype, float32, as in JAX. The ODE
    blocks keep their solve's stages for autograd (``nn.gresblock``)."""

    frame_size = 64

    def __init__(self, n_channels: int, ngf: int = 64, dim_z: int = 66,
                 dtype: Optional[torch.dtype] = None,
                 continuous_depth: bool = False, ode_steps: int = 2):
        super().__init__()
        del dtype
        self.ngf = ngf
        self.Dense_0 = nn.Linear(dim_z, 4 * 4 * ngf * 8)
        chans = (ngf * 8, ngf * 8, ngf * 4, ngf * 2, ngf)   # 4->8->...->64
        for i in range(4):
            block = (ODEGResBlock(chans[i], chans[i + 1], n_condition=dim_z,
                                  num_steps=ode_steps)
                     if continuous_depth else
                     GResBlock(chans[i], chans[i + 1], n_condition=dim_z))
            self.add_module(f"block_{i}", block)
        self.BatchNorm_0 = _bn(ngf)
        self.SNConv_0 = SNConv(ngf, n_channels, (3, 3), padding=1)

    def init_parameters(self, generator: torch.Generator):
        nn.init.normal_(self.Dense_0.weight, 0.0, 0.02, generator=generator)
        nn.init.zeros_(self.Dense_0.bias)
        for i in range(4):
            getattr(self, f"block_{i}").init_parameters(generator)
        self.BatchNorm_0.reset_parameters()
        self.SNConv_0.init_parameters(generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        # the dense output is NHWC in JAX: (B', 4, 4, C), then NCHW here
        h = self.Dense_0(z).view(z.shape[0], 4, 4, -1).permute(0, 3, 1, 2)
        for i in range(4):
            h = getattr(self, f"block_{i}")(h, z)
        h = F.relu(self.BatchNorm_0(h))
        return torch.tanh(self.SNConv_0(h, update_stats=self.training))


def _odegres64(n_channels: int, ngf: int = 64, dim_z: int = 66,
               dtype: Optional[torch.dtype] = None) -> GResTrunk64:
    return GResTrunk64(n_channels, ngf, dim_z, dtype, continuous_depth=True)


TRUNKS = {"dcgan64": DCGANTrunk64, "mnist28": MNISTTrunk28,
          "dcgan128": DCGANTrunk128, "gres64": GResTrunk64,
          "odegres64": _odegres64}


def make_trunk(name: str, n_channels: int, ngf: int, dim_z: int,
               dtype: Optional[torch.dtype] = None) -> nn.Module:
    if name not in TRUNKS:
        raise ValueError(f"unknown trunk {name!r}; choose from "
                         f"{sorted(TRUNKS)}")
    return TRUNKS[name](n_channels, ngf, dim_z, dtype)


class VideoGenerator(nn.Module):
    """MoCoGAN generator: ``motion`` supplies the ``(n, T, dim_z_motion)``
    latent trajectory, ``main`` (the trunk) decodes each frame.

    Every sampler takes its noise as optional explicit tensors (``z_content``,
    ``labels``, ``frame_idx`` here; ``x0`` or ``h0``/``e`` passed on to the
    motion sampler) and draws the missing ones from ``generator``. ``dtype``
    is the trunk's compute dtype; the motion runs float32, as in JAX.
    """

    def __init__(self, motion: nn.Module, n_channels: int = 3,
                 dim_z_content: int = 50, dim_z_category: int = 0,
                 dim_z_motion: int = 16, video_length: int = 16,
                 ngf: int = 64, trunk: str = "dcgan64",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_channels = n_channels
        self.dim_z_content = dim_z_content
        self.dim_z_category = dim_z_category
        self.dim_z_motion = dim_z_motion
        self.video_length = video_length
        self.motion = motion
        self.main = make_trunk(trunk, n_channels, ngf,
                               dim_z_content + dim_z_category + dim_z_motion,
                               dtype)

    def init_parameters(self, generator: torch.Generator):
        self.motion.init_parameters(generator)
        self.main.init_parameters(generator)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def frame_size(self) -> int:
        """The trunk's frame height and width."""
        return self.main.frame_size

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

    def forward(self, n: int, *, sample: str = "videos", **kwargs):
        """Default entry: ``sample_videos``; ``sample="images"`` calls
        ``sample_images`` (the entry ``torch.func.functional_call`` takes)."""
        if sample not in ("videos", "images"):
            raise ValueError(f"sample must be 'videos' or 'images', not {sample!r}")
        if sample == "images":
            return self.sample_images(n, **kwargs)
        return self.sample_videos(n, **kwargs)


# ---------------------------------------------------------------------------
# Discriminators (``ganode_tpu/models/mocogan.py:280-512``). Each takes the JAX
# layout, images ``(B, H, W, C)`` or videos ``(B, T, H, W, C)``, runs NCHW /
# NCDHW inside, and returns ``(logits, aux)``: the last layer's output moved
# to channels-last and squeezed of every size-1 axis, as ``jnp.squeeze`` does
# (a batch of one loses its batch axis too), in float32. Train mode is the
# JAX modules' default ``train=True``: BatchNorm normalises by batch
# statistics and advances the running ones, and the spectral-norm critics
# advance their ``u``; eval mode (``module.eval()``, JAX's ``train=False``)
# does neither. ``generator`` feeds the additive-noise layers, which no
# config turns on.
# ---------------------------------------------------------------------------


def _conv2d(in_ch: int, out_ch: int, k: int = 4, s: int = 2,
            p: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, k, s, p, bias=False)


def _conv3d(in_ch: int, out_ch: int, k, s, p) -> nn.Conv3d:
    return nn.Conv3d(in_ch, out_ch, k, s, p, bias=False)


def _squeeze(h: torch.Tensor,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """NC... -> channels-last, then every size-1 axis dropped; back in
    float32 under a compute dtype."""
    return _back(h.movedim(1, -1).squeeze(), dtype)


class FastGradConv3D(nn.Module):
    """First video-discriminator conv: kernel 4x4x4, stride (1, 2, 2),
    padding (0, 1, 1), no bias (``ops.conv3d_first``), computed in ``dtype``.
    Named as flax names it, so its weight is ``FastGradConv3D_0.weight``."""

    def __init__(self, in_ch: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_ch, 4, 4, 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d_first(_cast(x, self.dtype),
                            _cast(self.weight, self.dtype))


class _Discriminator(nn.Module):
    def __init__(self, use_noise: bool, noise_sigma: float | None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        # one layer serves every call site: it holds no parameters
        self.noise = Noise(use_noise, noise_sigma or 0.0)
        self.dtype = dtype

    def init_parameters(self, generator: torch.Generator):
        _dcgan_init(self, generator)


class ImageDiscriminator(_Discriminator):
    """64x64 image discriminator -> one logit per image."""

    def __init__(self, n_channels: int = 3, ndf: int = 64,
                 use_noise: bool = False, noise_sigma: float | None = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(use_noise, noise_sigma, dtype)
        chans = (n_channels, ndf, ndf * 2, ndf * 4, ndf * 8)
        for i in range(4):
            self.add_module(f"Conv_{i}", _conv2d(chans[i], chans[i + 1]))
        for i in range(3):
            self.add_module(f"BatchNorm_{i}", _bn(chans[i + 2]))
        self.Conv_4 = _conv2d(ndf * 8, 1, 4, 1, 0)

    def forward(self, x: torch.Tensor, *, generator=None):
        noise = lambda h: self.noise(h, generator=generator)
        dt = self.dtype
        h = noise(_cast(x.permute(0, 3, 1, 2), dt))
        h = leaky_relu(_run(self.Conv_0, h, dt))
        for i in range(3):
            h = _run(getattr(self, f"Conv_{i + 1}"), noise(h), dt)
            h = leaky_relu(getattr(self, f"BatchNorm_{i}")(h))
        return _squeeze(_run(self.Conv_4, h, dt), dt), None


class PatchImageDiscriminator(_Discriminator):
    """Patch image discriminator -> a logit map (4x4 at 64x64, one logit at
    28x28)."""

    def __init__(self, n_channels: int = 3, ndf: int = 64,
                 use_noise: bool = False, noise_sigma: float | None = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(use_noise, noise_sigma, dtype)
        chans = (n_channels, ndf, ndf * 2, ndf * 4, 1)
        for i in range(4):
            self.add_module(f"Conv_{i}", _conv2d(chans[i], chans[i + 1]))
        for i in range(2):
            self.add_module(f"BatchNorm_{i}", _bn(chans[i + 2]))

    def forward(self, x: torch.Tensor, *, generator=None):
        noise = lambda h: self.noise(h, generator=generator)
        dt = self.dtype
        h = noise(_cast(x.permute(0, 3, 1, 2), dt))
        h = leaky_relu(_run(self.Conv_0, h, dt))
        for i in range(2):
            h = _run(getattr(self, f"Conv_{i + 1}"), noise(h), dt)
            h = leaky_relu(getattr(self, f"BatchNorm_{i}")(h))
        return _squeeze(_run(self.Conv_3, noise(h), dt), dt), None


_K3, _S3, _P3 = (4, 4, 4), (1, 2, 2), (0, 1, 1)


class PatchVideoDiscriminator(_Discriminator):
    """3-D patch video discriminator, input ``(B, T, H, W, C)``."""

    def __init__(self, n_channels: int = 3, ndf: int = 64,
                 use_noise: bool = False, noise_sigma: float | None = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(use_noise, noise_sigma, dtype)
        self.FastGradConv3D_0 = FastGradConv3D(n_channels, ndf, dtype)
        chans = (ndf, ndf * 2, ndf * 4, 1)
        for i in range(3):
            self.add_module(f"Conv_{i}",
                            _conv3d(chans[i], chans[i + 1], _K3, _S3, _P3))
        for i in range(2):
            self.add_module(f"BatchNorm_{i}", _bn(chans[i + 1]))

    def forward(self, x: torch.Tensor, *, generator=None):
        noise = lambda h: self.noise(h, generator=generator)
        dt = self.dtype
        h = leaky_relu(self.FastGradConv3D_0(
            noise(_cast(x.permute(0, 4, 1, 2, 3), dt))))
        for i in range(2):
            h = _run(getattr(self, f"Conv_{i}"), noise(h), dt)
            h = leaky_relu(getattr(self, f"BatchNorm_{i}")(h))
        return _squeeze(_run(self.Conv_2, h, dt), dt), None


def _check_clip_length(name: str, ksize: int, t: int):
    """Five unpadded time convs each take ``ksize - 1`` frames: a shorter
    clip would give an empty tensor and NaN losses downstream."""
    min_t = 5 * ksize - 4
    if t < min_t:
        raise ValueError(f"{name}(ksize={ksize}) needs clips with at least "
                         f"{min_t} frames, got T={t}")


class VideoDiscriminator(_Discriminator):
    """Full video discriminator with a cubic ``ksize`` kernel (2 for 28x28
    clips, 4 for 64x64), input ``(B, T, H, W, C)``. Five unpadded time convs
    each take ``ksize - 1`` frames: a clip shorter than ``5 * ksize - 4``
    frames is refused. At ``ksize=4`` the first conv is ``FastGradConv3D_0``
    and the others are ``Conv_0..3``; otherwise they are ``Conv_0..4``."""

    def __init__(self, n_channels: int = 3, n_output_neurons: int = 1,
                 ndf: int = 64, ksize: int = 4, use_noise: bool = False,
                 noise_sigma: float | None = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(use_noise, noise_sigma, dtype)
        self.ksize = ksize
        k = (ksize,) * 3
        if ksize == 4:
            self.FastGradConv3D_0 = FastGradConv3D(n_channels, ndf, dtype)
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
        _check_clip_length("VideoDiscriminator", self.ksize, x.shape[1])
        noise = lambda h: self.noise(h, generator=generator)
        dt = self.dtype
        first, *body, last = (getattr(self, n) for n in self._names)
        h = noise(_cast(x.permute(0, 4, 1, 2, 3), dt))
        h = leaky_relu(first(h) if self.ksize == 4 else _run(first, h, dt))
        for i, conv in enumerate(body):
            h = leaky_relu(getattr(self, f"BatchNorm_{i}")(
                _run(conv, noise(h), dt)))
        return _squeeze(_run(last, h, dt), dt), None


class CategoricalVideoDiscriminator(_Discriminator):
    """Video discriminator emitting ``(realness logits, category logits)``,
    split along the channel (last) axis of ``VideoDiscriminator_0``'s
    output."""

    def __init__(self, dim_categorical: int, n_channels: int = 3,
                 n_output_neurons: int = 1, ndf: int = 64, ksize: int = 4,
                 use_noise: bool = False, noise_sigma: float | None = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(use_noise, noise_sigma, dtype)
        self.dim_categorical = dim_categorical
        self.VideoDiscriminator_0 = VideoDiscriminator(
            n_channels, n_output_neurons + dim_categorical, ndf, ksize,
            use_noise, noise_sigma, dtype)

    def forward(self, x: torch.Tensor, *, generator=None):
        h, _ = self.VideoDiscriminator_0(x, generator=generator)
        split = h.shape[-1] - self.dim_categorical
        return h[..., :split], h[..., split:]


class _SNCritic(_Discriminator):
    """A spectral-norm critic: no BatchNorm (it would correlate the samples
    of a batch and break the per-sample gradient penalty), every conv an
    ``SNConv`` named ``SNConv_i``, float32, ``u`` advancing in train mode."""

    def init_parameters(self, generator: torch.Generator):
        for m in self.modules():
            if isinstance(m, SNConv):
                m.init_parameters(generator)

    def _stack(self, h: torch.Tensor, generator) -> torch.Tensor:
        """Every layer but the last through noise, SNConv and leaky ReLU;
        the last without noise or activation."""
        train = self.training
        convs = [m for m in self.children() if isinstance(m, SNConv)]
        for conv in convs[:-1]:
            h = leaky_relu(conv(self.noise(h, generator=generator),
                                update_stats=train))
        return convs[-1](h, update_stats=train)


class SNImageDiscriminator(_SNCritic):
    """Spectrally normalized image critic (``ganode_tpu/models/mocogan.py:
    422``): four 4x4 stride-2 SNConvs (ndf, 2 ndf, 4 ndf, 1) -> a logit map
    (8x8 at 128x128)."""

    def __init__(self, n_channels: int = 3, ndf: int = 64,
                 use_noise: bool = False, noise_sigma: float | None = None):
        super().__init__(use_noise, noise_sigma)
        chans = (n_channels, ndf, ndf * 2, ndf * 4, 1)
        for i in range(4):
            self.add_module(f"SNConv_{i}", SNConv(
                chans[i], chans[i + 1], (4, 4), 2, 1, use_bias=False))

    def forward(self, x: torch.Tensor, *, generator=None):
        return _squeeze(self._stack(x.permute(0, 3, 1, 2), generator)), None


class SNVideoDiscriminator(_SNCritic):
    """Spectrally normalized video critic (``ganode_tpu/models/mocogan.py:
    448``): the ``VideoDiscriminator`` geometry (cubic ``ksize`` kernels,
    stride (1, 2, 2), unpadded time) with SNConvs and no BatchNorm; input
    ``(B, T, H, W, C)``, clips of at least ``5 * ksize - 4`` frames."""

    def __init__(self, n_channels: int = 3, n_output_neurons: int = 1,
                 ndf: int = 64, ksize: int = 4, use_noise: bool = False,
                 noise_sigma: float | None = None):
        super().__init__(use_noise, noise_sigma)
        self.ksize = ksize
        k = (ksize,) * 3
        chans = (n_channels, ndf, ndf * 2, ndf * 4, ndf * 8)
        for i in range(4):
            self.add_module(f"SNConv_{i}", SNConv(
                chans[i], chans[i + 1], k, _S3, _P3, use_bias=False))
        self.SNConv_4 = SNConv(ndf * 8, n_output_neurons, k, 1, 0,
                               use_bias=False)

    def forward(self, x: torch.Tensor, *, generator=None):
        _check_clip_length("SNVideoDiscriminator", self.ksize, x.shape[1])
        return _squeeze(self._stack(x.permute(0, 4, 1, 2, 3),
                                    generator)), None


IMAGE_DISCRIMINATORS = {"patch": PatchImageDiscriminator,
                        "full": ImageDiscriminator,
                        "sn": SNImageDiscriminator}
VIDEO_DISCRIMINATORS = {"full": VideoDiscriminator,
                        "patch": PatchVideoDiscriminator,
                        "sn": SNVideoDiscriminator}
