"""MoCoGAN generator with pluggable motion (the generator half of
``ganode_tpu.models``)."""
from __future__ import annotations

import torch

from .. import resolve_device
from .mocogan import TRUNKS, DCGANTrunk64, MNISTTrunk28, VideoGenerator
from .motion import MOTION_SAMPLERS, MotionGRU, MotionODE, make_motion_sampler


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
    **motion_kwargs,
) -> VideoGenerator:
    """Build the generator for a README variant (``ode`` or ``gru`` so far),
    with weights drawn from ``seed`` by the JAX package's initialisers.

    The weights are drawn on the CPU from one ``torch.Generator`` and then
    moved to ``device``, so a seed gives the same weights on every device. The
    modules are built on the meta device first: no global RNG is touched.
    """
    dev = resolve_device(device)
    with torch.device("meta"):
        motion = make_motion_sampler(variant, dim_z_motion, **motion_kwargs)
        gen = VideoGenerator(
            motion, n_channels=n_channels, dim_z_content=dim_z_content,
            dim_z_category=dim_z_category, dim_z_motion=dim_z_motion,
            video_length=video_length, ngf=ngf, trunk=trunk)
    gen = gen.to_empty(device="cpu")
    gen.init_parameters(torch.Generator().manual_seed(seed))
    return gen.to(dev)


def generator_for_config(config, *, device="cuda") -> VideoGenerator:
    """The generator ``ganode_tpu.train.runner.build_trainer`` builds for
    ``config``, initialised from ``config.seed``."""
    if config.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={config.compute_dtype!r}: the port runs float32; "
            "bf16 autocast waits for ROADMAP M4")
    motion_kwargs = {}
    if config.motion_method is not None and config.variant != "gru":
        motion_kwargs["method"] = config.motion_method
    return make_generator(
        config.variant, n_channels=config.n_channels, trunk=config.trunk,
        dim_z_content=config.dim_z_content,
        dim_z_category=config.dim_z_category,
        dim_z_motion=config.dim_z_motion, video_length=config.video_length,
        ngf=config.ngf, seed=config.seed, device=device, **motion_kwargs)


__all__ = [
    "DCGANTrunk64",
    "MNISTTrunk28",
    "MOTION_SAMPLERS",
    "MotionGRU",
    "MotionODE",
    "TRUNKS",
    "VideoGenerator",
    "generator_for_config",
    "make_generator",
    "make_motion_sampler",
]
