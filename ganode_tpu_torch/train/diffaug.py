"""Differentiable augmentation of discriminator inputs: DiffAugment and the
ADA gate (twin of ``ganode_tpu/train/diffaug.py``).

DiffAugment (Zhao et al., arXiv:2006.10738) passes every discriminator input,
real and fake, through the same randomly drawn differentiable transform, so
the discriminator cannot memorise the finite real set and the augmentation's
gradient reaches the generator. ADA (Karras et al., arXiv:2006.06676 §C)
applies each op to each sample with a probability ``p`` that an integral
controller (``ada_update``) moves toward a target of
``E[sign(D(aug(real)))]``.

Inputs are channels-last batches, images ``(B, H, W, C)`` or videos
``(B, T, H, W, C)``, the layout the port's discriminators take. Every draw
is made per clip and shared across its frames. The work runs at
``promote_types(dtype, float32)`` and is cast back, so a float64 input stays
float64 and a sample the ADA gate rejects comes back bit for bit.

Randomness as in the rest of the port: the JAX function draws inside from
``fold_in(key, i)`` (op ``i``) and ``fold_in(key, 1000 + i)`` (its gate).
Here ``diff_augment`` takes its draws as an explicit dict of tensors, keyed
``"<i>:<op>"`` and ``"<i>:gate"``, and draws the missing ones from a
``torch.Generator``; with neither it raises. ``diffaug_draws`` makes the
whole dict, which the trainer's noise tape holds. The draws per op:

* ``brightness``, ``saturation``, ``contrast``: ``u ~ U[0, 1)``, ``(B,)``
  float32; the op adds ``u - 0.5``, scales by ``2u``, scales by ``u + 0.5``;
* ``translation``: ``(2, B)`` integer shifts (rows, columns) in
  ``[-m, m]``, ``m = max(int(extent * 0.125), 1)``;
* ``cutout``: ``(2, B)`` integer top and left of a ``(H/2, W/2)`` block, in
  ``[-c // 2, extent - c // 2]``;
* a gate: ``u ~ U[0, 1)``, ``(B,)`` float32; the op applies where ``u < p``.

Plain PyTorch tensor code: the JAX function is plain ``jnp`` that XLA fuses
into the step, with no Pallas kernel behind it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["diff_augment", "parse_policy", "translate2d", "POLICY_OPS",
           "ada_update"]

_TRANSLATION_RATIO = 0.125
_CUTOUT_RATIO = 0.5


def _per_sample(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``(B,)`` draw shaped to broadcast per sample over ``x``."""
    return v.reshape((x.shape[0],) + (1,) * (x.ndim - 1)).to(x.dtype)


# ---------------------------------------------------------------------- color
def _brightness(x, u):
    """``x + (u - 0.5)`` per sample (the paper's rand_brightness)."""
    return x + _per_sample(u - 0.5, x)


def _saturation(x, u):
    """The distance from the per-pixel channel mean scaled by ``2u``."""
    m = x.mean(dim=-1, keepdim=True)
    return (x - m) * _per_sample(u * 2.0, x) + m


def _contrast(x, u):
    """The distance from the per-sample mean scaled by ``u + 0.5``."""
    m = x.mean(dim=tuple(range(1, x.ndim)), keepdim=True)
    return (x - m) * _per_sample(u + 0.5, x) + m


# ---------------------------------------------------------------- translation
def translate2d(x: torch.Tensor, shift_h: torch.Tensor,
                shift_w: torch.Tensor) -> torch.Tensor:
    """Per-sample integer translation with zero fill.

    ``x (B, ..., H, W, C)``; ``shift_h``, ``shift_w`` ``(B,)`` integers.
    Output pixel ``(i, j)`` reads input ``(i - sh, j - sw)``: positive
    shifts move content down and right. Reads out of range clamp into a
    1-pixel zero border, so one pad serves every shift.
    """
    h, w = x.shape[-3], x.shape[-2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    dev = x.device
    rows = (torch.arange(h, device=dev) - shift_h.to(dev)[:, None] + 1
            ).clamp(0, h + 1)                                     # (B, H)
    cols = (torch.arange(w, device=dev) - shift_w.to(dev)[:, None] + 1
            ).clamp(0, w + 1)                                     # (B, W)
    b = torch.arange(x.shape[0], device=dev)
    # the spatial axes beside the batch axis: (B, H+2, W+2, ..., C)
    xp = xp.movedim((-3, -2), (1, 2))
    out = xp[b[:, None, None], rows[:, :, None], cols[:, None, :]]
    return out.movedim((1, 2), (-3, -2))


def _translation(x, shifts):
    return translate2d(x, shifts[0], shifts[1])


# --------------------------------------------------------------------- cutout
def _cutout_size(h: int, w: int):
    return max(int(h * _CUTOUT_RATIO), 1), max(int(w * _CUTOUT_RATIO), 1)


def _cutout(x, offsets):
    """Zero a ``(H/2, W/2)`` block per clip at ``offsets`` (top, left); the
    block may hang off the edges."""
    b, h, w = x.shape[0], x.shape[-3], x.shape[-2]
    ch, cw = _cutout_size(h, w)
    top, left = offsets[0].to(x.device), offsets[1].to(x.device)
    rows = torch.arange(h, device=x.device)[None, :]
    cols = torch.arange(w, device=x.device)[None, :]
    row_in = (rows >= top[:, None]) & (rows < top[:, None] + ch)    # (B, H)
    col_in = (cols >= left[:, None]) & (cols < left[:, None] + cw)  # (B, W)
    keep = ~(row_in[:, :, None] & col_in[:, None, :])               # (B, H, W)
    keep = keep.reshape((b,) + (1,) * (x.ndim - 4) + (h, w, 1))
    return x * keep.to(x.dtype)


POLICY_OPS = {
    "brightness": _brightness,
    "saturation": _saturation,
    "contrast": _contrast,
    "translation": _translation,
    "cutout": _cutout,
}

# 'color' is the paper's composite of the three photometric ops, in its order
_COLOR = ("brightness", "saturation", "contrast")


def parse_policy(policy: str):
    """``'color,translation,cutout'`` -> a tuple of op names; raises on an
    unknown name."""
    ops = []
    for name in (p.strip() for p in policy.split(",") if p.strip()):
        if name == "color":
            ops.extend(_COLOR)
        elif name in POLICY_OPS:
            ops.append(name)
        else:
            raise ValueError(
                f"unknown diffaug op {name!r}; choose from "
                f"{sorted(POLICY_OPS) + ['color']}")
    return tuple(ops)


# ---------------------------------------------------------------------- draws
def _uniform(shape, generator):
    return torch.rand((shape[0],), generator=generator,
                      device=generator.device)


def _integers(generator, b, lows, highs):
    """``(2, B)`` integers, row k in ``[lows[k], highs[k]]``."""
    return torch.stack([
        torch.randint(lo, hi + 1, (b,), generator=generator,
                      device=generator.device)
        for lo, hi in zip(lows, highs)])


def _translation_draw(shape, generator):
    h, w = shape[-3], shape[-2]
    mh = max(int(h * _TRANSLATION_RATIO), 1)
    mw = max(int(w * _TRANSLATION_RATIO), 1)
    return _integers(generator, shape[0], (-mh, -mw), (mh, mw))


def _cutout_draw(shape, generator):
    h, w = shape[-3], shape[-2]
    ch, cw = _cutout_size(h, w)
    return _integers(generator, shape[0], (-(ch // 2), -(cw // 2)),
                     (h - ch // 2, w - cw // 2))


_DRAWS = {"brightness": _uniform, "saturation": _uniform,
          "contrast": _uniform, "translation": _translation_draw,
          "cutout": _cutout_draw}


def _ops(policy):
    return parse_policy(policy) if isinstance(policy, str) else tuple(policy)


def _keys(ops, gated: bool):
    """The draws' keys with their draw functions, in drawing order."""
    for i, name in enumerate(ops):
        yield f"{i}:{name}", _DRAWS[name]
        if gated:
            yield f"{i}:gate", _uniform


def _complete(ops, shape, gated: bool, draws: Optional[dict], generator):
    """``draws`` with every missing key drawn from ``generator``, in
    ``_keys`` order."""
    out = dict(draws or {})
    for key, draw in _keys(ops, gated):
        if key not in out:
            if generator is None:
                raise ValueError(
                    f"no draw {key!r} and no torch.Generator for diffaug: "
                    "pass draws or a generator")
            out[key] = draw(shape, generator)
    return out


def diffaug_draws(policy, shape, gated: bool,
                  generator: torch.Generator) -> dict:
    """Every draw one ``diff_augment`` call on a batch of ``shape``
    (``(B, ..., H, W, C)``) consumes, from ``generator`` on its device:
    the ops' and, when ``gated`` (ADA), the gates'. Drawn on the CPU, it
    replays one call on any device."""
    return _complete(_ops(policy), shape, gated, None, generator)


def diff_augment(x: torch.Tensor, policy, p=None, *, draws=None,
                 generator=None) -> torch.Tensor:
    """Apply the DiffAugment ``policy`` to ``x``.

    ``x``: ``(B, H, W, C)`` images or ``(B, T, H, W, C)`` videos, any float
    dtype. ``policy``: a comma-separated op string (``parse_policy``) or a
    parsed tuple; an empty one returns ``x``. Differentiable in ``x``.

    ``p``: the ADA probability (a float or a 0-d tensor, on ``x``'s device
    for the step to stay on the card), or None. With ``p`` each op applies
    to each sample where its gate ``u < p`` (``torch.where``, a per-sample
    choice, not a blend); ``p=None`` draws no gates. ``draws``: see the
    module docstring; the missing ones come from ``generator``.
    """
    ops = _ops(policy)
    if not ops:
        return x
    if x.ndim not in (4, 5):
        raise ValueError(f"expected (B,H,W,C) or (B,T,H,W,C), got "
                         f"{tuple(x.shape)}")
    draws = _complete(ops, x.shape, p is not None, draws, generator)
    dtype = x.dtype
    x = x.to(torch.promote_types(dtype, torch.float32))
    for i, name in enumerate(ops):
        aug = POLICY_OPS[name](x, draws[f"{i}:{name}"].to(x.device))
        if p is None:
            x = aug
        else:
            u = draws[f"{i}:gate"].to(x.device)
            keep = (u < p).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
            x = torch.where(keep, aug, x)
    return x.to(dtype)


def ada_update(p: torch.Tensor, rt: torch.Tensor, *, target: float,
               step: float, p_max: float = 0.8) -> torch.Tensor:
    """One integral-controller update of the ADA probability:
    ``clip(p + step * sign(rt - target), 0, p_max)``, in ``p``'s dtype, on
    its device, with no host sync. ``rt = E[sign(D(aug(real)))]`` above the
    target means the discriminator separates the reals too confidently, so
    augmentation rises."""
    return torch.clamp(p + step * torch.sign(rt - target).to(p.dtype),
                       0.0, p_max)
