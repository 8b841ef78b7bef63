"""Alternating-Adam GAN training (twin of ``ganode_tpu/train/gan.py``).

Per step, ``d_iters`` updates of the image and the video discriminator on
real batches against generator samples taken under ``no_grad``, then one
generator update through both discriminators:

    train_step(state, images, videos, *, generator, noise=None) -> metrics

with images ``(d_iters, B, H, W, C)`` and videos ``(d_iters, B, T, H, W, C)``.
The modules and optimizers in ``state`` change in place. The semantics are
those of ``ganode_tpu/train/gan.py:10-23``:

* the generator samples in train mode also under ``no_grad``, so its
  BatchNorm running statistics advance in the D updates too;
* a discriminator's running statistics advance on the real batch, then on the
  fake one, and again in the G update, where both discriminators run in train
  mode; the G update samples videos then images and runs D_vid then D_img, the
  order that fixes the statistics' sequence;
* each update differentiates only its own net's parameters
  (``torch.autograd.grad``), so the G update computes no discriminator weight
  gradient; no ``.grad`` is left behind on any net;
* Adam is ``torch.optim.Adam(lr, betas, weight_decay)``: the decay is added to
  the gradient before the moments, which is what the JAX package's
  ``chain(add_decayed_weights, adam)`` mimics;
* a spectral-norm critic's ``u`` advances once per train-mode forward: twice
  per D loss (once with ``fused_real_fake``) and once per critic in the G
  update;
* the gradient penalties (``gp_weight``, ``r1_weight``) run one more D pass
  on the state the real and fake passes left, in eval mode: BatchNorm on its
  running statistics, spectral norm from one power iteration that is not
  stored (JAX's ``train=False`` apply on ``ex2``, ``gan.py:207-257``).

Randomness comes from one ``torch.Generator`` on the training device, or, for
the generator's samples, from ``noise``: a tape of ``2 * d_iters + 2`` dicts of
keyword noise (``x0`` or ``h0``/``e``, ``z_content``, and ``frame_idx`` for
images), one per sample in the step's order: image and video fakes of each D
iteration, then the G update's video and image. With the gradient penalty on,
each D iteration's dict also holds its interpolation weights ``gp_eps``. The
step reads nothing back to the host: the metrics are device tensors (the
adaptive motion solver syncs inside, ``ode.adaptive``).

Not ported yet: DiffAugment / ADA (ROADMAP M11); ``runner.build_trainer``
refuses configs that ask for them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from .losses import LOSSES, gradient_penalty, r1_penalty
from .state import GANState, NetState


def reference_adam(params, lr: float = 2e-4, b1: float = 0.5,
                   b2: float = 0.999,
                   weight_decay: float = 1e-5) -> torch.optim.Adam:
    """The reference's optimizer: ``torch.optim.Adam(lr, betas,
    weight_decay)``, additive (not decoupled) decay."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2),
                            weight_decay=weight_decay)


@torch.no_grad()
def _add_param_noise(params, sigma: float, generator: torch.Generator):
    """``p += sigma * N(0, I)`` for each parameter, drawn from
    ``generator`` (reference mnist_moco_ode_noise.py:31-35)."""
    if generator is None:
        raise ValueError("parameter noise needs a torch.Generator")
    for p in params:
        p.add_(torch.randn(p.shape, generator=generator, device=p.device,
                           dtype=p.dtype), alpha=sigma)


@dataclasses.dataclass
class GANTrainer:
    """The alternating GAN loop over three modules: ``gen`` (a
    ``VideoGenerator``), ``dis_img`` and ``dis_vid`` (discriminators taking
    the channels-last layout). ``init_state`` wraps them, as they stand,
    with their optimizers."""

    gen: nn.Module
    dis_img: nn.Module
    dis_vid: nn.Module
    batch_size: int = 32
    d_iters: int = 2
    loss: str = "bce"
    lr: float = 2e-4
    betas: Tuple[float, float] = (0.5, 0.999)
    weight_decay: float = 1e-5
    param_noise_sigma: float = 0.0
    # WGAN-GP's gradient penalty and R1's, weights (0 = off)
    gp_weight: float = 0.0
    r1_weight: float = 0.0
    # EMA of the generator's parameters (0 = off); eval_gen_variables
    # prefers it
    ema_decay: float = 0.0
    # one D pass over real and fake concatenated (batch 2B), whose BatchNorm
    # statistics then span both; False = the reference's two passes
    fused_real_fake: bool = False

    def __post_init__(self):
        if self.loss not in LOSSES:
            raise ValueError(f"unknown loss {self.loss!r}; choose from "
                             f"{sorted(LOSSES)}")
        self.d_loss_fn, self.g_loss_fn = LOSSES[self.loss]

    # ------------------------------------------------------------------ state
    def init_state(self) -> GANState:
        def net(module):
            return NetState(module, reference_adam(
                module.parameters(), self.lr, *self.betas, self.weight_decay))

        return GANState(
            gen=net(self.gen), dis_img=net(self.dis_img),
            dis_vid=net(self.dis_vid), step=0,
            ema_params=({k: p.detach().clone()
                         for k, p in self.gen.named_parameters()}
                        if self.ema_decay > 0 else None))

    def eval_gen_variables(self, state: GANState) -> dict:
        """The generator's ``state_dict`` for eval-mode sampling, with the
        EMA parameters in place of the raw ones when EMA is on. Shares
        storage with the live tensors."""
        sd = dict(state.gen.module.state_dict())
        if state.ema_params is not None:
            sd.update(state.ema_params)
        return sd

    # -------------------------------------------------------------- internals
    def _sample(self, what: str, noise: dict, generator):
        """A generator sample in train mode (BatchNorm on batch statistics,
        running statistics advancing), under the caller's grad mode."""
        self.gen.train()
        out, _ = getattr(self.gen, what)(self.batch_size, generator=generator,
                                          **noise)
        return out

    @staticmethod
    def _d_forward(mod: nn.Module, x, generator):
        mod.train()
        return mod(x, generator=generator)[0]

    def _apply(self, net: NetState, params, grads, generator):
        """One Adam step of ``net`` with these gradients, then the optional
        parameter noise. The gradients are attached only for the step."""
        for p, g in zip(params, grads):
            p.grad = g
        net.opt.step()
        for p in params:
            p.grad = None
        if self.param_noise_sigma > 0:
            _add_param_noise(params, self.param_noise_sigma, generator)

    def _gp_eps(self, real, generator) -> torch.Tensor:
        """The gradient penalty's interpolation weights, ``U[0, 1)`` shaped
        ``(B, 1, ...)``, from ``generator``."""
        if generator is None:
            raise ValueError("no torch.Generator given for the gradient "
                             "penalty's gp_eps: pass one, or a noise tape")
        return torch.rand((real.shape[0],) + (1,) * (real.ndim - 1),
                          generator=generator, device=real.device,
                          dtype=real.dtype)

    def _d_update(self, net: NetState, real, fake, generator, gp_eps=None):
        """One discriminator update on a real and a fake batch -> loss.
        ``gp_eps`` feeds the gradient penalty (drawn from ``generator`` when
        absent)."""
        mod = net.module
        if self.fused_real_fake:
            both = self._d_forward(mod, torch.cat([real, fake]), generator)
            pr, pf = both[:real.shape[0]], both[real.shape[0]:]
        else:
            pr = self._d_forward(mod, real, generator)
            pf = self._d_forward(mod, fake, generator)
        loss = self.d_loss_fn(pr, pf)
        if self.gp_weight > 0 or self.r1_weight > 0:
            mod.eval()
            try:
                d_apply = lambda x: mod(x, generator=generator)[0]
                if self.gp_weight > 0:
                    if gp_eps is None:
                        gp_eps = self._gp_eps(real, generator)
                    loss = loss + self.gp_weight * gradient_penalty(
                        d_apply, real, fake, gp_eps)
                if self.r1_weight > 0:
                    loss = loss + self.r1_weight * r1_penalty(d_apply, real)
            finally:
                mod.train()
        params = list(mod.parameters())
        self._apply(net, params, torch.autograd.grad(loss, params), generator)
        return loss.detach()

    def _d_phase(self, state: GANState, which: str, real, noise: dict,
                 generator):
        """Sample fakes under ``no_grad`` and update one discriminator:
        ``which`` is ``"image"`` or ``"video"``; ``noise`` is the sample's
        and, with the gradient penalty, ``gp_eps``."""
        noise = dict(noise)
        gp_eps = noise.pop("gp_eps", None)
        with torch.no_grad():
            fake = self._sample(f"sample_{which}s", noise, generator)
        net = state.dis_img if which == "image" else state.dis_vid
        return self._d_update(net, real, fake, generator, gp_eps)

    def _g_grads(self, state: GANState, noise_vid: dict, noise_img: dict,
                 generator):
        """The G loss through both discriminators and its gradients with
        respect to G's parameters only -> (loss, grads)."""
        fake_vid = self._sample("sample_videos", noise_vid, generator)
        fake_img = self._sample("sample_images", noise_img, generator)
        pf_vid = self._d_forward(state.dis_vid.module, fake_vid, generator)
        pf_img = self._d_forward(state.dis_img.module, fake_img, generator)
        loss = self.g_loss_fn(pf_vid) + self.g_loss_fn(pf_img)
        params = list(state.gen.module.parameters())
        return loss, torch.autograd.grad(loss, params)

    def _g_update(self, state: GANState, noise_vid: dict, noise_img: dict,
                  generator):
        loss, grads = self._g_grads(state, noise_vid, noise_img, generator)
        self._apply(state.gen, list(state.gen.module.parameters()), grads,
                    generator)
        return loss.detach()

    # ------------------------------------------------------------------- step
    def noise_tape(self, generator: torch.Generator, device) -> list:
        """One step's noise tape, drawn from ``generator`` (a CPU one gives
        the same tape for every device) and moved to ``device``."""
        order = ["images", "videos"] * self.d_iters + ["videos", "images"]
        tape = []
        for i, what in enumerate(order):
            noise = self.gen.draw_noise(self.batch_size, what, generator)
            if self.gp_weight > 0 and i < 2 * self.d_iters:
                ndim = 4 if what == "images" else 5
                noise["gp_eps"] = torch.rand(
                    (self.batch_size,) + (1,) * (ndim - 1),
                    generator=generator, device=generator.device)
            tape.append({k: v.to(device) for k, v in noise.items()})
        return tape

    def train_step(self, state: GANState, images, videos, *, generator=None,
                   noise=None) -> dict:
        """One full alternating step -> ``{"dis_img_loss", "dis_vid_loss",
        "gen_loss"}`` (device tensors; the discriminators' from the last D
        iteration)."""
        slots = 2 * self.d_iters + 2
        if noise is None:
            noise = [{}] * slots
        if len(noise) != slots:
            raise ValueError(f"a noise tape holds {slots} samples, got "
                             f"{len(noise)}")
        tape = iter(noise)
        dis_img_loss = dis_vid_loss = images.new_zeros(())
        for i in range(self.d_iters):
            dis_img_loss = self._d_phase(state, "image", images[i],
                                         next(tape), generator)
            dis_vid_loss = self._d_phase(state, "video", videos[i],
                                         next(tape), generator)
        gen_loss = self._g_update(state, next(tape), next(tape), generator)
        if state.ema_params is not None:
            d = self.ema_decay
            with torch.no_grad():
                for k, p in state.gen.module.named_parameters():
                    state.ema_params[k].mul_(d).add_(p, alpha=1.0 - d)
        state.step += 1
        return {"dis_img_loss": dis_img_loss, "dis_vid_loss": dis_vid_loss,
                "gen_loss": gen_loss}
