"""Config -> trainer assembly (``build_trainer`` of
``ganode_tpu/train/runner.py:38-100``). The rest of the runner (data,
logging, checkpointing, the training loop) waits for ROADMAP M7."""
from __future__ import annotations

from ..models import discriminators_for_config, generator_for_config
from ..utils.config import ExperimentConfig
from .gan import GANTrainer


def build_trainer(config: ExperimentConfig, *, device="cuda") -> GANTrainer:
    """The trainer ``config`` describes, its three nets on ``device`` with
    weights drawn from ``config.seed``. Configs whose pieces are not ported
    raise ``NotImplementedError`` naming their ROADMAP item."""
    if config.gp_weight > 0 or config.r1_weight > 0:
        raise NotImplementedError(
            "the gradient penalties (gp_weight, r1_weight) wait for ROADMAP M9")
    if config.diffaug or config.ada_target > 0:
        raise NotImplementedError(
            "DiffAugment and ADA (diffaug, ada_target) wait for ROADMAP M11")
    gen = generator_for_config(config, device=device)
    dis_img, dis_vid = discriminators_for_config(config, device=device)
    return GANTrainer(
        gen=gen, dis_img=dis_img, dis_vid=dis_vid,
        batch_size=config.batch_size, d_iters=config.d_iters,
        loss=config.loss, lr=config.lr, betas=config.betas,
        weight_decay=config.weight_decay,
        param_noise_sigma=config.param_noise_sigma,
        ema_decay=config.ema_decay, fused_real_fake=config.fused_real_fake)
