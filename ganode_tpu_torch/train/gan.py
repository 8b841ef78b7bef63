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
  stored (JAX's ``train=False`` apply on ``ex2``, ``gan.py:207-257``);
* with a DiffAugment policy (``diffaug``, ``train/diffaug.py``) every
  discriminator input passes through it: real and fake before the D passes,
  so the penalties see the augmented inputs too, and G's fakes inside the G
  loss, so the augmentation's gradient reaches G;
* with ADA (``ada_target > 0``) each discriminator has its own augmentation
  probability, ``state.ada["p_img"]`` and ``["p_vid"]`` (0-d float32 on the
  device), moved by ``ada_update`` after each of its D updates on ``rt =
  mean(sign(D(aug(real))))`` and committed before the G update, which gates
  each branch with its discriminator's ``p``.

Randomness comes from one ``torch.Generator`` on the training device, or, for
the generator's samples, from ``noise``: a tape of ``2 * d_iters + 2`` dicts of
keyword noise (``x0`` or ``h0``/``e``, ``z_content``, and ``frame_idx`` for
images), one per sample in the step's order: image and video fakes of each D
iteration, then the G update's video and image. With the gradient penalty on,
each D iteration's dict also holds its interpolation weights ``gp_eps``; with
DiffAugment, the augmentation's draws (``diffaug_draws``): ``aug_real`` and
``aug_fake`` in a D iteration's dict, ``aug`` in a G sample's. The step reads
nothing back to the host: the metrics are device tensors (the adaptive motion
solver syncs inside, ``ode.adaptive``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from .diffaug import ada_update, diff_augment, diffaug_draws, parse_policy
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
    # DiffAugment policy, e.g. "color,translation,cutout" ("" = off)
    diffaug: str = ""
    # ADA: > 0 gates the policy per sample with a learned p per
    # discriminator, driven toward E[sign(D(aug(real)))] = ada_target; it
    # needs a policy. ada_step per D update, p in [0, ada_p_max].
    ada_target: float = 0.0
    ada_step: float = 5e-4
    ada_p_max: float = 0.8

    def __post_init__(self):
        if self.loss not in LOSSES:
            raise ValueError(f"unknown loss {self.loss!r}; choose from "
                             f"{sorted(LOSSES)}")
        self.d_loss_fn, self.g_loss_fn = LOSSES[self.loss]
        self._diffaug_ops = parse_policy(self.diffaug)
        if self.ada_target > 0 and not self._diffaug_ops:
            raise ValueError("ada_target > 0 needs a non-empty diffaug policy")

    # ------------------------------------------------------------------ state
    def init_state(self) -> GANState:
        def net(module):
            return NetState(module, reference_adam(
                module.parameters(), self.lr, *self.betas, self.weight_decay))

        zero = lambda: torch.zeros((), dtype=torch.float32,
                                   device=self.gen.device)
        return GANState(
            gen=net(self.gen), dis_img=net(self.dis_img),
            dis_vid=net(self.dis_vid), step=0,
            ema_params=({k: p.detach().clone()
                         for k, p in self.gen.named_parameters()}
                        if self.ema_decay > 0 else None),
            ada=({"p_img": zero(), "p_vid": zero()}
                 if self.ada_target > 0 else None))

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

    def _augment(self, x, p, draws, generator):
        """``x`` through the DiffAugment policy (unchanged without one)."""
        if not self._diffaug_ops:
            return x
        return diff_augment(x, self._diffaug_ops, p, draws=draws,
                            generator=generator)

    def _d_update(self, net: NetState, real, fake, generator, gp_eps=None, *,
                  p=None, aug_real=None, aug_fake=None):
        """One discriminator update on a real and a fake batch -> (loss,
        ``rt``, the mean sign of D's logits on the reals it judged).
        ``gp_eps`` feeds the gradient penalty; ``aug_real`` / ``aug_fake``
        are the augmentation's draws, ``p`` its ADA probability (each drawn
        from ``generator`` when absent)."""
        mod = net.module
        real = self._augment(real, p, aug_real, generator)
        fake = self._augment(fake, p, aug_fake, generator)
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
        return loss.detach(), torch.sign(pr.detach()).mean()

    def _d_phase(self, state: GANState, which: str, real, noise: dict,
                 generator, p=None):
        """Sample fakes under ``no_grad`` and update one discriminator:
        ``which`` is ``"image"`` or ``"video"``; ``noise`` is the sample's
        and, with the gradient penalty, ``gp_eps``, with DiffAugment
        ``aug_real`` and ``aug_fake``; ``p`` the ADA probability -> (loss,
        rt)."""
        noise = dict(noise)
        extra = {k: noise.pop(k, None) for k in ("gp_eps", "aug_real",
                                                  "aug_fake")}
        with torch.no_grad():
            fake = self._sample(f"sample_{which}s", noise, generator)
        net = state.dis_img if which == "image" else state.dis_vid
        return self._d_update(net, real, fake, generator, extra["gp_eps"],
                              p=p, aug_real=extra["aug_real"],
                              aug_fake=extra["aug_fake"])

    def _g_grads(self, state: GANState, noise_vid: dict, noise_img: dict,
                 generator):
        """The G loss through both discriminators and its gradients with
        respect to G's parameters only -> (loss, grads). With DiffAugment
        each fake is augmented inside the loss (draws ``aug`` in its noise),
        gated by its discriminator's committed ADA ``p``."""
        noise_vid, noise_img = dict(noise_vid), dict(noise_img)
        aug_vid, aug_img = noise_vid.pop("aug", None), noise_img.pop("aug", None)
        fake_vid = self._sample("sample_videos", noise_vid, generator)
        fake_img = self._sample("sample_images", noise_img, generator)
        ada = state.ada or {}
        fake_vid = self._augment(fake_vid, ada.get("p_vid"), aug_vid, generator)
        fake_img = self._augment(fake_img, ada.get("p_img"), aug_img, generator)
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
        # the augmentation's draws need only the batch and the frame size
        s = self.gen.frame_size
        frames = (self.batch_size, s, s, 1)
        gated = self.ada_target > 0
        aug = lambda: diffaug_draws(self._diffaug_ops, frames, gated, generator)
        tape = []
        for i, what in enumerate(order):
            noise = self.gen.draw_noise(self.batch_size, what, generator)
            if i < 2 * self.d_iters:
                if self.gp_weight > 0:
                    ndim = 4 if what == "images" else 5
                    noise["gp_eps"] = torch.rand(
                        (self.batch_size,) + (1,) * (ndim - 1),
                        generator=generator, device=generator.device)
                if self._diffaug_ops:
                    noise["aug_real"], noise["aug_fake"] = aug(), aug()
            elif self._diffaug_ops:
                noise["aug"] = aug()
            tape.append(_moved(noise, device))
        return tape

    def train_step(self, state: GANState, images, videos, *, generator=None,
                   noise=None) -> dict:
        """One full alternating step -> ``{"dis_img_loss", "dis_vid_loss",
        "gen_loss"}`` (device tensors; the discriminators' from the last D
        iteration), with ADA also ``rt_img``, ``rt_vid`` (the last D
        iteration's) and ``ada_p_img``, ``ada_p_vid`` (``state.ada``)."""
        slots = 2 * self.d_iters + 2
        if noise is None:
            noise = [{}] * slots
        if len(noise) != slots:
            raise ValueError(f"a noise tape holds {slots} samples, got "
                             f"{len(noise)}")
        tape = iter(noise)
        dis_img_loss = dis_vid_loss = images.new_zeros(())
        ada = state.ada
        ada_p = lambda key: None if ada is None else ada[key]
        for i in range(self.d_iters):
            dis_img_loss, rt_img = self._d_phase(
                state, "image", images[i], next(tape), generator, ada_p("p_img"))
            if ada is not None:
                ada = {**ada, "p_img": self._ada_update(ada["p_img"], rt_img)}
            dis_vid_loss, rt_vid = self._d_phase(
                state, "video", videos[i], next(tape), generator, ada_p("p_vid"))
            if ada is not None:
                ada = {**ada, "p_vid": self._ada_update(ada["p_vid"], rt_vid)}
        if ada is not None:
            # committed before the G update, which gates G's fakes with it
            state.ada = ada
        gen_loss = self._g_update(state, next(tape), next(tape), generator)
        if state.ema_params is not None:
            d = self.ema_decay
            with torch.no_grad():
                for k, p in state.gen.module.named_parameters():
                    state.ema_params[k].mul_(d).add_(p, alpha=1.0 - d)
        state.step += 1
        metrics = {"dis_img_loss": dis_img_loss, "dis_vid_loss": dis_vid_loss,
                   "gen_loss": gen_loss}
        if ada is not None:
            # rt of the last D iteration, and the committed probabilities
            metrics.update(rt_img=rt_img, rt_vid=rt_vid,
                           ada_p_img=ada["p_img"], ada_p_vid=ada["p_vid"])
        return metrics

    def _ada_update(self, p, rt):
        return ada_update(p, rt, target=self.ada_target, step=self.ada_step,
                          p_max=self.ada_p_max)


def _moved(noise: dict, device) -> dict:
    """A noise dict (nested for the augmentation's draws) on ``device``."""
    return {k: _moved(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in noise.items()}
