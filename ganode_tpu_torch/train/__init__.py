"""Training: the alternating-Adam GAN loop (twin of ``ganode_tpu.train``'s
``GANTrainer``). The ODE-GAN trainer waits for ROADMAP M12, DiffAugment for
M11."""
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
)
from .runner import build_trainer
from .state import GANState, NetState

__all__ = [
    "GANState",
    "GANTrainer",
    "LOSSES",
    "NetState",
    "bce_logits",
    "build_trainer",
    "d_loss_bce",
    "d_loss_hinge",
    "d_loss_wasserstein",
    "g_loss_bce",
    "g_loss_hinge",
    "g_loss_wasserstein",
    "reference_adam",
]
