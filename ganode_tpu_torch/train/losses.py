"""GAN losses (twin of ``ganode_tpu/train/losses.py``): BCE with logits (the
reference's default), Wasserstein and hinge, and the two gradient penalties,
WGAN-GP's ``gradient_penalty`` and ``r1_penalty``. A penalty differentiates
the critic's input gradient again, so each runs ``torch.autograd.grad`` with
``create_graph=True`` (double backward)."""
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


def _input_grads(d_apply, x: torch.Tensor) -> torch.Tensor:
    """``grad_x sum(d_apply(x))``, one row per sample, kept in the graph so
    that a loss of it differentiates with respect to the critic. ``x`` is a
    constant: the samples are not differentiated through."""
    x = x.detach().requires_grad_()
    (g,) = torch.autograd.grad(d_apply(x).sum(), x, create_graph=True)
    return g.reshape(x.shape[0], -1)


def gradient_penalty(d_apply, real, fake, eps) -> torch.Tensor:
    """WGAN-GP penalty ``E[(||grad_x D(x_hat)||_2 - 1)^2]`` on the
    interpolates ``x_hat = eps * real + (1 - eps) * fake``. ``eps`` is given,
    one uniform draw per sample shaped ``(B, 1, ...)`` (JAX draws it inside
    from its key)."""
    grads = _input_grads(d_apply, eps * real + (1.0 - eps) * fake)
    norms = torch.sqrt(torch.sum(torch.square(grads), dim=1) + 1e-12)
    return torch.mean((norms - 1.0) ** 2)


def r1_penalty(d_apply, real) -> torch.Tensor:
    """R1 regularization ``(1/2) E[||grad_x D(x)||^2]`` on real samples only
    (Mescheder et al., ICML 2018)."""
    grads = _input_grads(d_apply, real)
    return 0.5 * torch.mean(torch.sum(torch.square(grads), dim=1))


LOSSES = {
    "bce": (d_loss_bce, g_loss_bce),
    "wasserstein": (d_loss_wasserstein, g_loss_wasserstein),
    "hinge": (d_loss_hinge, g_loss_hinge),
}
