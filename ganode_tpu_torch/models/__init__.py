"""MoCoGAN generator with pluggable motion, the BatchNorm discriminators and
the spectral-norm critics (twin of ``ganode_tpu.models``)."""
from __future__ import annotations

import torch

from .. import resolve_device
from .mocogan import (
    IMAGE_DISCRIMINATORS,
    TRUNKS,
    VIDEO_DISCRIMINATORS,
    CategoricalVideoDiscriminator,
    DCGANTrunk64,
    DCGANTrunk128,
    FastGradConv3D,
    GResTrunk64,
    ImageDiscriminator,
    MNISTTrunk28,
    PatchImageDiscriminator,
    PatchVideoDiscriminator,
    SNImageDiscriminator,
    SNVideoDiscriminator,
    VideoDiscriminator,
    VideoGenerator,
)
from .motion import (
    MOTION_SAMPLERS,
    MotionCDE,
    MotionGRU,
    MotionMoEODE,
    MotionODE,
    MotionODERNN,
    MotionSDE,
    make_motion_sampler,
)


def make_generator(
    variant: str,
    *,
    n_channels: int,
    dim_z_content: int = 50,
    dim_z_category: int = 0,
    dim_z_motion: int = 16,
    video_length: int = 16,
    trunk: str = "dcgan64",
    ngf: int = 64,
    seed: int = 0,
    device="cuda",
    dtype: torch.dtype | None = None,
    **motion_kwargs,
) -> VideoGenerator:
    """Build the generator for a README variant (``gru``, ``ode``, ``sde``,
    ``cde``, ``ode_rnn`` or ``moe_ode``), with weights drawn from ``seed`` by the JAX package's initialisers and
    its trunk computing in ``dtype`` (None: its parameters' own, float32).

    The weights are drawn on the CPU from one ``torch.Generator`` and then
    moved to ``device``, so a seed gives the same weights on every device. The
    modules are built on the meta device first: no global RNG is touched.
    """
    return _on_device(lambda: VideoGenerator(
        make_motion_sampler(variant, dim_z_motion, **motion_kwargs),
        n_channels=n_channels, dim_z_content=dim_z_content,
        dim_z_category=dim_z_category, dim_z_motion=dim_z_motion,
        video_length=video_length, ngf=ngf, trunk=trunk, dtype=dtype), seed,
        device)


def _on_device(build, seed: int, device) -> torch.nn.Module:
    """Build a module on the meta device, draw its weights on the CPU from
    ``seed`` (``init_parameters``), then move it: a seed gives the same
    weights on every device, and no global RNG is touched."""
    dev = resolve_device(device)
    with torch.device("meta"):
        module = build()
    module = module.to_empty(device="cpu")
    module.init_parameters(torch.Generator().manual_seed(seed))
    return module.to(dev)


def make_discriminator(kind: str, video: bool, *, n_channels: int,
                       ndf: int = 64, ksize: int = 4, seed: int = 0,
                       device="cuda",
                       dtype: torch.dtype | None = None) -> torch.nn.Module:
    """The image (``video=False``: ``patch``, ``full`` or ``sn``) or video
    (``video=True``: ``full``, ``patch`` or ``sn``) discriminator of
    ``ganode_tpu/train/runner.py:67-83``, with weights drawn from ``seed``
    (N(0, 0.02) conv weights; the spectral-norm critics' ``lecun_normal``
    and their ``u``). ``ksize`` is the full and spectral-norm video
    critics' kernel; ``dtype`` the BatchNorm discriminators' compute dtype
    (the spectral-norm critics run float32, as in JAX)."""
    table = VIDEO_DISCRIMINATORS if video else IMAGE_DISCRIMINATORS
    if kind not in table:
        raise ValueError(f"unknown {'video' if video else 'image'} "
                         f"discriminator {kind!r}; choose from "
                         f"{sorted(table)}")
    cls = table[kind]
    kwargs = {}
    if cls in (VideoDiscriminator, SNVideoDiscriminator):
        kwargs["ksize"] = ksize
    if kind != "sn":
        kwargs["dtype"] = dtype
    return _on_device(lambda: cls(n_channels=n_channels, ndf=ndf, **kwargs),
                      seed, device)


# float32 is the parameters' own dtype: nothing is cast
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(config) -> torch.dtype | None:
    """``config.compute_dtype`` as the modules' ``dtype`` (JAX:
    runner.py:41): None for float32, where nothing is cast."""
    if config.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {config.compute_dtype!r}; "
                         f"choose from {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[config.compute_dtype]


def discriminators_for_config(config, *, device="cuda"):
    """``(dis_img, dis_vid)`` as ``ganode_tpu.train.runner.build_trainer``
    builds them for ``config``, their weights drawn from ``config.seed + 1``
    and ``config.seed + 2`` (the generator's from ``config.seed``)."""
    common = dict(n_channels=config.n_channels, ndf=config.ndf,
                  device=device, dtype=compute_dtype(config))
    return (make_discriminator(config.image_disc, False,
                               seed=config.seed + 1, **common),
            make_discriminator(config.video_disc, True,
                               ksize=config.video_disc_ksize,
                               seed=config.seed + 2, **common))


def generator_for_config(config, *, device="cuda") -> VideoGenerator:
    """The generator ``ganode_tpu.train.runner.build_trainer`` builds for
    ``config``, initialised from ``config.seed``, its motion options passed
    through as JAX passes them (``ganode_tpu/train/runner.py:41-53``): the
    method for every variant but ``gru`` (``dopri5`` for
    ``ucf_wgan_gp_128``, at the sampler's default tolerances), ``sde_dt``
    for ``sde``, the expert count and ``top_k`` for ``moe_ode``; the trunk
    in the compute dtype."""
    motion_kwargs = {}
    if config.motion_method is not None and config.variant != "gru":
        motion_kwargs["method"] = config.motion_method
    if config.variant == "sde" and config.sde_dt is not None:
        motion_kwargs["dt"] = config.sde_dt
    if config.variant == "moe_ode":
        motion_kwargs["n_experts"] = config.moe_experts
        motion_kwargs["top_k"] = config.moe_top_k
    return make_generator(
        config.variant, n_channels=config.n_channels, trunk=config.trunk,
        dim_z_content=config.dim_z_content,
        dim_z_category=config.dim_z_category,
        dim_z_motion=config.dim_z_motion, video_length=config.video_length,
        ngf=config.ngf, seed=config.seed, device=device,
        dtype=compute_dtype(config), **motion_kwargs)


__all__ = [
    "CategoricalVideoDiscriminator",
    "COMPUTE_DTYPES",
    "DCGANTrunk128",
    "DCGANTrunk64",
    "FastGradConv3D",
    "GResTrunk64",
    "ImageDiscriminator",
    "MNISTTrunk28",
    "MOTION_SAMPLERS",
    "MotionCDE",
    "MotionGRU",
    "MotionMoEODE",
    "MotionODE",
    "MotionODERNN",
    "MotionSDE",
    "PatchImageDiscriminator",
    "PatchVideoDiscriminator",
    "SNImageDiscriminator",
    "SNVideoDiscriminator",
    "TRUNKS",
    "VideoDiscriminator",
    "VideoGenerator",
    "compute_dtype",
    "discriminators_for_config",
    "generator_for_config",
    "make_discriminator",
    "make_generator",
    "make_motion_sampler",
]
