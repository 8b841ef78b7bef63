"""Feature extractors for IS / FVD: a small image classifier and a 3-D video
embedder, trained in-package (twin of ``ganode_tpu/eval/embedder.py``).

The nets keep flax's submodule names (``Conv_0``, ``Dense_0``, ...; the video
classifier's ``embedder`` and ``head``), so ``bridge.jax_to_torch`` maps the
JAX package's params onto their ``state_dict``s, and ``load_params`` /
``save_params`` read and write flax's msgpack files (``utils/flax_msgpack``):
both packages share one set of ``eval_assets/``.

As in JAX, a model and its params travel apart: ``params`` is a ``state_dict``
(name -> tensor) and the nets are applied with ``apply`` (a
``functional_call``). Inputs are channels-last, ``(B, H, W, C)`` images and
``(B, T, H, W, C)`` videos, numpy or tensors; each batch goes to the model's
device. Every conv pads by XLA's ``SAME`` rule (``same_padding``), which at
stride 2 on an even size pads one row after and none before.

Weights are drawn from ``seed`` by flax's initialisers on the CPU, then moved
(``models._on_device``); the trainers train in the data's floating dtype
(float64 data: float64 weights, as JAX computes in float64 on float64
inputs); the training loops draw their batch indices from a
CPU ``torch.Generator`` seeded with ``seed`` or take them as an explicit
``(steps, batch_size)`` array (JAX draws ``randint(fold_in(key, i))``; the
two frameworks' streams differ, so parity tests hand JAX's indices over).
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from .. import bridge, resolve_device
from ..models import _on_device
from ..nn.layers import init_dense, lecun_normal_
from ..utils import flax_msgpack


def same_padding(n: int, k: int, s: int) -> tuple:
    """(before, after) padding of XLA's ``SAME`` rule for size ``n``,
    kernel ``k``, stride ``s``: the output has ceil(n / s) positions and the
    odd pixel of the total goes after."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv_same(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (padding 0) on channels-first ``x``, padded as flax's
    default ``padding="SAME"``."""
    pads = []
    for n, k, s in zip(reversed(x.shape[2:]), reversed(conv.kernel_size),
                       reversed(conv.stride)):
        pads += same_padding(n, k, s)
    return conv(F.pad(x, pads))


def _init_conv(conv: nn.Module, generator: torch.Generator):
    """flax ``nn.Conv`` defaults: lecun_normal kernel, zero bias."""
    lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
    nn.init.zeros_(conv.bias)


class ImageClassifier(nn.Module):
    """Small conv net -> class logits; the IS backbone. ``image_shape``
    (H, W, C) fixes ``Dense_0``'s width, which flax infers on first call."""

    def __init__(self, n_classes: int = 10, image_shape: Sequence[int] = (28, 28, 1)):
        super().__init__()
        h, w, c = image_shape
        self.Conv_0 = nn.Conv2d(c, 32, 3, stride=2)
        self.Conv_1 = nn.Conv2d(32, 64, 3, stride=2)
        for _ in range(2):
            h, w = math.ceil(h / 2), math.ceil(w / 2)
        self.Dense_0 = nn.Linear(h * w * 64, 128)
        self.Dense_1 = nn.Linear(128, n_classes)

    def init_parameters(self, generator: torch.Generator):
        for conv in (self.Conv_0, self.Conv_1):
            _init_conv(conv, generator)
        for dense in (self.Dense_0, self.Dense_1):
            init_dense(dense, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for conv in (self.Conv_0, self.Conv_1):
            h = F.relu(_conv_same(conv, h))
        # flax flattens channels-last: Dense_0's rows run (h, w, c)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self.Dense_1(F.relu(self.Dense_0(h)))


class VideoEmbedder(nn.Module):
    """3-D conv tower -> (B, feature_dim) embeddings; the FVD feature
    function. Input (B, T, H, W, C)."""

    def __init__(self, feature_dim: int = 128, in_channels: int = 3):
        super().__init__()
        chans = (in_channels, 32, 64, 128)
        for i in range(3):
            setattr(self, f"Conv_{i}", nn.Conv3d(chans[i], chans[i + 1], 3,
                                                 stride=(1, 2, 2)))
        self.Dense_0 = nn.Linear(128, feature_dim)

    def init_parameters(self, generator: torch.Generator):
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            _init_conv(conv, generator)
        init_dense(self.Dense_0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 4, 1, 2, 3)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            h = F.relu(_conv_same(conv, h))
        return self.Dense_0(h.mean(dim=(2, 3, 4)))  # average over T, H, W


class _VideoClassifierHead(nn.Module):
    """VideoEmbedder + linear classification head: the harness that makes
    the embedder's features discriminative."""

    def __init__(self, feature_dim: int, n_classes: int, in_channels: int = 3):
        super().__init__()
        self.embedder = VideoEmbedder(feature_dim, in_channels)
        self.head = nn.Linear(feature_dim, n_classes)

    def init_parameters(self, generator: torch.Generator):
        self.embedder.init_parameters(generator)
        init_dense(self.head, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.embedder(x))


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def params_of(model: nn.Module) -> dict:
    """The model's current weights as a params dict (detached tensors that
    share the module's storage)."""
    return {k: v.detach() for k, v in model.state_dict().items()}


@torch.no_grad()
def apply(model: nn.Module, params: dict, x) -> torch.Tensor:
    """``model`` with ``params`` on ``x`` (moved to the model's device)."""
    x = torch.as_tensor(x).to(_device_of(model))
    return functional_call(model, params, (x,))


def _batch_indices(indices, steps: int, batch_size: int, n: int, seed: int):
    """Each training step's batch indices: the rows of ``indices`` when
    given, else draws from a CPU generator seeded with ``seed``."""
    if indices is not None:
        indices = torch.as_tensor(np.asarray(indices), dtype=torch.long)
        if tuple(indices.shape) != (steps, batch_size):
            raise ValueError(f"indices of shape {tuple(indices.shape)}, "
                             f"want ({steps}, {batch_size})")
        yield from indices
        return
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        yield torch.randint(0, n, (batch_size,), generator=g)


def _fit(model, data, labels, steps, batch_size, lr, seed, indices):
    """``steps`` Adam steps of the mean softmax cross-entropy, in place."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    model.train()
    for idx in _batch_indices(indices, steps, batch_size, len(data), seed):
        idx = idx.to(data.device)
        loss = F.cross_entropy(model(data[idx]), labels[idx])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    model.eval()


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def _float_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the nets train in: the data's own floating dtype."""
    return x.dtype if x.is_floating_point() else torch.float32


def train_classifier(images, labels, *, n_classes: int = 10, steps: int = 500,
                     batch_size: int = 64, lr: float = 1e-3, seed: int = 0,
                     device="cuda", params: Optional[dict] = None,
                     indices=None):
    """Quick supervised fit of an ``ImageClassifier`` on ``images (N, H, W,
    C)``; returns (model, params, accuracy on the first 512 images).
    ``params`` (a ``state_dict``) replaces the seeded initial weights.
    ``steps=0`` returns the untrained template and nan without touching the
    data (its callers load persisted params into it)."""
    dev = resolve_device(device)
    model = _on_device(lambda: ImageClassifier(n_classes, images.shape[1:]),
                       seed, dev)
    if params is not None:
        model.load_state_dict(params)
    if steps == 0:
        return model.eval(), params_of(model), float("nan")
    images, labels = _on(images, dev), _on(labels, dev).long()
    model.to(_float_dtype(images))
    _fit(model, images, labels, steps, batch_size, lr, seed, indices)
    with torch.no_grad():
        pred = model(images[:512]).argmax(-1)
    acc = float((pred == labels[:512]).float().mean())
    return model, params_of(model), acc


def embed_videos(model: VideoEmbedder, params: dict, videos,
                 batch_size: int = 32) -> torch.Tensor:
    """(N, T, H, W, C) videos -> (N, feature_dim) features on the model's
    device, ``batch_size`` clips per call."""
    return torch.cat([apply(model, params, videos[i:i + batch_size])
                      for i in range(0, len(videos), batch_size)])


def train_video_embedder(videos, labels, *, n_classes: int,
                         feature_dim: int = 128, steps: int = 300,
                         batch_size: int = 16, lr: float = 1e-3,
                         seed: int = 0, device="cuda",
                         params: Optional[dict] = None, indices=None):
    """Fit the FVD feature function by classifying real videos; returns
    (embedder, embedder params, accuracy over the first min(256, N) clips,
    in batches of ``batch_size``). The classification head is discarded.
    ``params`` (a ``_VideoClassifierHead`` ``state_dict``: ``embedder.*``,
    ``head.*``) replaces the seeded initial weights; ``steps=0`` returns the
    untrained embedder and nan."""
    dev = resolve_device(device)
    model = _on_device(lambda: _VideoClassifierHead(
        feature_dim, n_classes, videos.shape[-1]), seed, dev)
    if params is not None:
        model.load_state_dict(params)
    embedder = model.embedder
    if steps == 0:
        return embedder.eval(), params_of(embedder), float("nan")
    videos, labels = _on(videos, dev), _on(labels, dev).long()
    model.to(_float_dtype(videos))
    _fit(model, videos, labels, steps, batch_size, lr, seed, indices)
    n_eval = min(256, len(videos))
    hits = 0
    with torch.no_grad():
        for i in range(0, n_eval, batch_size):
            stop = min(i + batch_size, n_eval)
            pred = model(videos[i:stop]).argmax(-1)
            hits += int((pred == labels[i:stop]).sum())
    return embedder, params_of(embedder), hits / n_eval


def save_params(path: str, params: dict) -> str:
    """Write a params ``state_dict`` as flax's msgpack (the JAX package's
    ``save_params`` format: the flax params tree, keys sorted)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tree = bridge.torch_to_jax(params)["params"]
    flax_msgpack.write(path, flax_msgpack.sort_keys(tree))
    return path


def load_params(path: str, template: dict) -> dict:
    """Read a flax msgpack params file into a ``state_dict`` shaped like
    ``template`` (its keys, shapes, dtypes and devices); raises ValueError
    when the file's tree does not match."""
    sd = bridge.jax_to_torch({"params": flax_msgpack.read(path)})
    if sorted(sd) != sorted(template):
        raise ValueError(f"{path}: leaves {sorted(set(sd) ^ set(template))} "
                         "differ from the template's")
    for k, t in template.items():
        if sd[k].shape != t.shape:
            raise ValueError(f"{path}: {k} has shape {tuple(sd[k].shape)}, "
                             f"the template {tuple(t.shape)}")
    return {k: sd[k].to(t.device, t.dtype) for k, t in template.items()}
