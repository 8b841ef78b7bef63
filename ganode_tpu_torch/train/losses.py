"""GAN losses (twin of ``ganode_tpu/train/losses.py``): BCE with logits (the
reference's default), Wasserstein and hinge. The gradient penalties
(``gradient_penalty``, ``r1_penalty``) wait for ROADMAP M9."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean binary cross-entropy with logits against a constant target, in
    the stable form ``max(x, 0) - x z + log(1 + exp(-|x|))``."""
    x = logits
    return torch.mean(torch.clamp(x, min=0) - x * target
                      + torch.log1p(torch.exp(-torch.abs(x))))


def d_loss_bce(real_logits, fake_logits):
    """BCE(pr, 1) + BCE(pf, 0): the reference discriminator loss."""
    return bce_logits(real_logits, 1.0) + bce_logits(fake_logits, 0.0)


def g_loss_bce(fake_logits):
    """BCE(pf, 1): the reference generator loss."""
    return bce_logits(fake_logits, 1.0)


def d_loss_wasserstein(real_logits, fake_logits):
    """mean(fake) - mean(real) (torchgan's WassersteinDiscriminatorLoss)."""
    return torch.mean(fake_logits) - torch.mean(real_logits)


def g_loss_wasserstein(fake_logits):
    """-mean(fake) (torchgan's WassersteinGeneratorLoss)."""
    return -torch.mean(fake_logits)


def d_loss_hinge(real_logits, fake_logits):
    return (torch.mean(F.relu(1.0 - real_logits))
            + torch.mean(F.relu(1.0 + fake_logits)))


def g_loss_hinge(fake_logits):
    return -torch.mean(fake_logits)


LOSSES = {
    "bce": (d_loss_bce, g_loss_bce),
    "wasserstein": (d_loss_wasserstein, g_loss_wasserstein),
    "hinge": (d_loss_hinge, g_loss_hinge),
}
