"""Training: the alternating-Adam GAN step and the run around it (twins of
``ganode_tpu.train``'s ``GANTrainer`` and ``runner``; ``python -m
ganode_tpu_torch.train`` is the command line), DiffAugment with the ADA
controller, and the functional ODE-GAN (optimizer-as-ODE) trainer
(``python -m ganode_tpu_torch.train_odegan``)."""
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
from .odegan import (
    ODEGANTrainer,
    discriminator_regularizer,
    euler_step,
    make_mocogan_losses,
    module_params,
    rk2_step,
    rk4_step,
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
    "ODEGANTrainer",
    "bce_logits",
    "build_data",
    "ada_update",
    "build_trainer",
    "d_loss_bce",
    "d_loss_hinge",
    "d_loss_wasserstein",
    "diff_augment",
    "diffaug_draws",
    "discriminator_regularizer",
    "euler_step",
    "g_loss_bce",
    "g_loss_hinge",
    "g_loss_wasserstein",
    "gradient_penalty",
    "make_device_data_step",
    "make_mocogan_losses",
    "module_params",
    "parse_policy",
    "r1_penalty",
    "reference_adam",
    "rk2_step",
    "rk4_step",
    "run_training",
    "translate2d",
]
