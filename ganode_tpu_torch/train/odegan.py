"""ODE-GAN: integrating GAN training dynamics as an ODE in parameter space
(twin of ``ganode_tpu/train/odegan.py``; after Qin et al., "Training GANs by
solving ODEs", the reference's ``GANODETrainer``, stage2/ode_training.py).

Each step is a pure function over one network's parameters, a dict of name ->
tensor as ``named_parameters`` gives them:

    new_params = step(params, loss_fn, lr, noise, batch, penalty_grad, reg)

    euler:  p - lr * g1
    rk2:    p - lr/2 * (g1 + g2),        g2 at p - lr*g1
    rk4:    p - lr/6 * (g1+2g2+2g3+g4),  classic stages

with each ``g`` a ``torch.autograd.grad`` of ``loss_fn(params, noise, batch)``
at a displaced point (``tree_axpy``), recombined in JAX's order
(``tree_lincomb``). The discriminator regularizer is
``grad_{theta_d} ||grad_{theta_g} L_G||^2``: a gradient taken with
``create_graph=True`` and differentiated again, through the generator's
motion kernel too (its ``Function`` is twice differentiable).

The reference's quirks, kept as the JAX package keeps them:

* the penalty is taken once, at the undisplaced parameters, and applied at
  the end;
* euler applies ``- reg * gp`` (no lr factor) while rk2 and rk4 apply
  ``- reg * lr * gp``;
* a loss that samples draws fresh noise at every stage (JAX: ``fold_in(key,
  stage)``, stages 0-3), the penalty's generator loss under its own (JAX's
  stage 99).

Randomness is explicit, as everywhere in the port. ``noise`` is either a
``torch.Generator``, which every stage's loss draws from in turn, or a dict
of each stage's draws keyed by the stage (0-3) and ``"penalty"``: what the
loss takes as its ``noise`` (``make_mocogan_losses``: ``{"videos": ...,
"images": ...}``, the samplers' keyword noise). A loss that needs noise and
gets neither raises. A parameter that the loss does not reach gets a zero
gradient, as ``jax.grad`` gives it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch.func import functional_call

from ..ode.tree import tree_axpy, tree_lincomb, tree_sq_norm

Params = Dict[str, torch.Tensor]
# loss_fn(params, noise, batch) -> scalar tensor
LossFn = Callable[[Any, Any, Any], torch.Tensor]

__all__ = [
    "ODEGANTrainer",
    "discriminator_regularizer",
    "euler_step",
    "make_mocogan_losses",
    "module_params",
    "rk2_step",
    "rk4_step",
]


def module_params(module: torch.nn.Module) -> Params:
    """A module's parameters as a tree for the steppers: detached copies,
    by ``named_parameters`` name."""
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def _stage_noise(noise, stage):
    """What stage ``stage`` (0-3, or ``"penalty"``) of a step draws from: the
    generator itself, that stage's entry of a dict, or None."""
    if isinstance(noise, dict):
        return noise[stage]
    return noise


def _grads(out: torch.Tensor, leaves: Params, **kwargs) -> Params:
    """``torch.autograd.grad`` over a dict of leaves, zeros where ``out``
    does not reach a leaf (``jax.grad``'s answer)."""
    got = torch.autograd.grad(out, list(leaves.values()), allow_unused=True,
                              **kwargs)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(leaves.items(), got)}


def _leaves(params: Params) -> Params:
    return {k: v.detach().requires_grad_() for k, v in params.items()}


def _grad(loss_fn: LossFn, params: Params, noise, batch) -> Params:
    with torch.enable_grad():
        leaves = _leaves(params)
        return _grads(loss_fn(leaves, noise, batch), leaves)


def euler_step(params: Params, loss_fn: LossFn, lr: float, noise=None,
               batch=None, penalty_grad: Optional[Params] = None,
               reg: float = 0.0) -> Params:
    g1 = _grad(loss_fn, params, _stage_noise(noise, 0), batch)
    new = tree_axpy(-lr, g1, params)
    if penalty_grad is not None:
        # reference euler: param += lr*(-grad) + reg*(-gp): NO lr on the penalty
        new = tree_axpy(-reg, penalty_grad, new)
    return new


def rk2_step(params: Params, loss_fn: LossFn, lr: float, noise=None,
             batch=None, penalty_grad: Optional[Params] = None,
             reg: float = 0.0) -> Params:
    g1 = _grad(loss_fn, params, _stage_noise(noise, 0), batch)
    p1 = tree_axpy(-lr, g1, params)
    g2 = _grad(loss_fn, p1, _stage_noise(noise, 1), batch)
    new = tree_lincomb([-lr / 2, -lr / 2], [g1, g2], base=params)
    if penalty_grad is not None:
        new = tree_axpy(-reg * lr, penalty_grad, new)
    return new


def rk4_step(params: Params, loss_fn: LossFn, lr: float, noise=None,
             batch=None, penalty_grad: Optional[Params] = None,
             reg: float = 0.0) -> Params:
    g1 = _grad(loss_fn, params, _stage_noise(noise, 0), batch)
    g2 = _grad(loss_fn, tree_axpy(-lr / 2, g1, params),
               _stage_noise(noise, 1), batch)
    g3 = _grad(loss_fn, tree_axpy(-lr / 2, g2, params),
               _stage_noise(noise, 2), batch)
    g4 = _grad(loss_fn, tree_axpy(-lr, g3, params),
               _stage_noise(noise, 3), batch)
    new = tree_lincomb([-lr / 6, -lr / 3, -lr / 3, -lr / 6], [g1, g2, g3, g4],
                       base=params)
    if penalty_grad is not None:
        new = tree_axpy(-reg * lr, penalty_grad, new)
    return new


_STEPPERS = {"euler": euler_step, "rk2": rk2_step, "rk4": rk4_step}


def discriminator_regularizer(g_loss_fn: Callable[[Params, Params],
                                                  torch.Tensor],
                              g_params: Params, d_params: Params) -> Params:
    """``grad_{theta_d} || grad_{theta_g} L_G(theta_g, theta_d) ||^2``: the
    inner gradient with ``create_graph=True``, its squared norm summed in
    JAX's leaf order, then the outer gradient. ``g_loss_fn(g_params,
    d_params)`` holds its noise itself."""
    with torch.enable_grad():
        g, d = _leaves(g_params), _leaves(d_params)
        g_grad = _grads(g_loss_fn(g, d), g, create_graph=True)
        magnitude = tree_sq_norm(g_grad)
        if not magnitude.requires_grad:   # L_G does not reach theta_d
            return {k: torch.zeros_like(v) for k, v in d.items()}
        return _grads(magnitude, d)


@contextlib.contextmanager
def _eval_mode(*modules):
    """The modules in eval mode for the block, their modes restored after."""
    modes = [m.training for m in modules]
    for m in modules:
        m.eval()
    try:
        yield
    finally:
        for m, mode in zip(modules, modes):
            m.train(mode)


def make_mocogan_losses(gen, dis_img, dis_vid, batch_size: int, *,
                        loss: str = "bce"):
    """Loss closures wiring the MoCoGAN triple into ``ODEGANTrainer`` (JAX:
    ``make_mocogan_losses``, ``ganode_tpu/train/odegan.py:103-155``).

    Each module runs in eval mode under ``functional_call`` on the params
    given: BatchNorm normalises by its running statistics and changes none,
    since mutating statistics at the RK stages' displaced parameters has no
    reference semantics. The modules' own batch statistics stand for JAX's
    ``gen_stats``/``img_stats``/``vid_stats``.

    Returns ``(g_loss, d_img_loss, d_vid_loss)``, each ``loss(all_params,
    noise, batch) -> scalar``: ``noise`` a ``torch.Generator`` or the
    stage's draws, ``{"videos": ..., "images": ...}`` (``g_loss``), ``{"images":
    ...}`` (``d_img_loss``) or ``{"videos": ...}`` (``d_vid_loss``), each the
    keyword noise of one ``sample_videos`` / ``sample_images`` call
    (``VideoGenerator.draw_noise``). The D losses take real batches (images
    ``(B, H, W, C)``, videos ``(B, T, H, W, C)``); ``g_loss`` takes None.
    """
    from .losses import LOSSES

    d_loss_fn, g_loss_fn = LOSSES[loss]

    def _sample(params, noise, what):
        draws, generator = ((noise[what], None) if isinstance(noise, dict)
                            else ({}, noise))
        with _eval_mode(gen):
            out, _ = functional_call(gen, params["gen"], (batch_size,),
                                     {"sample": what, "generator": generator,
                                      **draws})
        return out

    def _disc(mod, key, params, x):
        with _eval_mode(mod):
            logits, _ = functional_call(mod, params[key], (x,))
        return logits

    def g_loss(params, noise, batch):
        fake_vid = _sample(params, noise, "videos")
        fake_img = _sample(params, noise, "images")
        pf_vid = _disc(dis_vid, "dis_vid", params, fake_vid)
        pf_img = _disc(dis_img, "dis_img", params, fake_img)
        return g_loss_fn(pf_vid) + g_loss_fn(pf_img)

    def d_img_loss(params, noise, batch):
        fake = _sample(params, noise, "images")
        pr = _disc(dis_img, "dis_img", params, batch)
        pf = _disc(dis_img, "dis_img", params, fake)
        return d_loss_fn(pr, pf)

    def d_vid_loss(params, noise, batch):
        fake = _sample(params, noise, "videos")
        pr = _disc(dis_vid, "dis_vid", params, batch)
        pf = _disc(dis_vid, "dis_vid", params, fake)
        return d_loss_fn(pr, pf)

    return g_loss, d_img_loss, d_vid_loss


@dataclasses.dataclass
class ODEGANTrainer:
    """The functional equivalent of the reference's ``GANODETrainer`` (JAX:
    ``ODEGANTrainer``, ``ganode_tpu/train/odegan.py:158-221``).

    Loss closures take ``(all_params, noise, batch)`` where ``all_params`` is
    ``{"gen": ..., "dis_img": ..., "dis_vid": ...}``, each a dict of name ->
    tensor; each step updates exactly one entry, holding the others fixed,
    and returns new dicts (the reference's per-network ``step(x,
    model=...)``, stage2/ode_training.py:37-46). A discriminator step with
    ``reg > 0`` adds the regularizer of the generator loss at the step's
    undisplaced parameters.
    """

    g_loss: LossFn
    d_img_loss: LossFn
    d_vid_loss: Optional[LossFn] = None
    lr: float = 0.02
    reg: float = 0.01
    method: str = "rk4"
    d_iter: int = 2
    g_iter: int = 1

    def __post_init__(self):
        if self.method not in _STEPPERS:
            raise ValueError(
                f"Choose method between 'euler', 'rk2' and 'rk4', not {self.method!r}")
        self._stepper = _STEPPERS[self.method]
        self.penalty = self.reg > 0

    def _sub_step(self, all_params, net: str, loss_fn: LossFn, noise, batch,
                  with_penalty: bool):
        def net_loss(p, n, b):
            return loss_fn({**all_params, net: p}, n, b)

        penalty_grad = None
        if with_penalty and self.penalty:
            pen_noise = _stage_noise(noise, "penalty")

            def g_of(g_p, d_p):
                return self.g_loss({**all_params, "gen": g_p, net: d_p},
                                   pen_noise, None)
            penalty_grad = discriminator_regularizer(
                g_of, all_params["gen"], all_params[net])

        new_params = self._stepper(all_params[net], net_loss, self.lr, noise,
                                   batch, penalty_grad, self.reg)
        return {**all_params, net: new_params}

    def step(self, all_params, noise=None, batch=None, model: str = "gen"):
        """One RK step for the chosen network (``"gen"`` | ``"dis_img"`` |
        ``"dis_vid"``); ``noise`` a ``torch.Generator`` or each stage's
        draws (module docstring)."""
        if model == "gen":
            return self._sub_step(all_params, "gen", self.g_loss, noise, batch,
                                  False)
        if model == "dis_img":
            return self._sub_step(all_params, "dis_img", self.d_img_loss,
                                  noise, batch, True)
        if model == "dis_vid":
            if self.d_vid_loss is None:
                raise ValueError("trainer built without a video discriminator loss")
            return self._sub_step(all_params, "dis_vid", self.d_vid_loss,
                                  noise, batch, True)
        raise ValueError(f"model must be gen|dis_img|dis_vid, got {model!r}")
