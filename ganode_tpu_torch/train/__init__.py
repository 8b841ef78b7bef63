"""Training: the alternating-Adam GAN step and the run around it (twins of
``ganode_tpu.train``'s ``GANTrainer`` and ``runner``; ``python -m
ganode_tpu_torch.train`` is the command line), and DiffAugment with the ADA
controller. The ODE-GAN trainer waits for ROADMAP M12."""
from .diffaug import (
    ada_update,
    diff_augment,
    diffaug_draws,
    parse_policy,
    translate2d,
)
from .gan import GANTrainer, reference_adam
from .losses import (
    LOSSES,
    bce_logits,
    d_loss_bce,
    d_loss_hinge,
    d_loss_wasserstein,
    g_loss_bce,
    g_loss_hinge,
    g_loss_wasserstein,
    gradient_penalty,
    r1_penalty,
)
from .runner import (
    GracefulStop,
    build_data,
    build_trainer,
    make_device_data_step,
    run_training,
)
from .state import GANState, NetState

__all__ = [
    "GANState",
    "GANTrainer",
    "GracefulStop",
    "LOSSES",
    "NetState",
    "bce_logits",
    "build_data",
    "ada_update",
    "build_trainer",
    "d_loss_bce",
    "d_loss_hinge",
    "d_loss_wasserstein",
    "diff_augment",
    "diffaug_draws",
    "g_loss_bce",
    "g_loss_hinge",
    "g_loss_wasserstein",
    "gradient_penalty",
    "make_device_data_step",
    "parse_policy",
    "r1_penalty",
    "reference_adam",
    "run_training",
    "translate2d",
]
