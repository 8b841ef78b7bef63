"""Train state (twin of ``ganode_tpu/train/state.py``) in PyTorch's idiom:
each net is its module, whose parameters and BatchNorm buffers change in
place, with one ``torch.optim.Adam`` of its own. ``ganode_tpu_torch.bridge``
maps a flax ``GANState`` onto it and back."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass
class NetState:
    module: nn.Module
    opt: torch.optim.Adam


@dataclasses.dataclass
class GANState:
    gen: NetState
    dis_img: NetState
    dis_vid: NetState
    step: int = 0
    # EMA of the generator's parameters, by parameter name (None when off)
    ema_params: Optional[dict] = None
    # the ADA controller's state, {"p_img", "p_vid"} as 0-d float32 tensors
    # on the device (None when ADA is off)
    ada: Optional[dict] = None
