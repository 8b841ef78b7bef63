"""PyTorch + CUDA port of ``ganode_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its module and
function names so each counterpart can be found by name. It imports torch and
numpy only, never jax or anything of ``ganode_tpu``.

Every entry point takes ``device`` (default ``"cuda"``). Asking for the card
when none is present raises; the CPU is used only when asked for by name.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"``/``"cpu"`` (or a ``torch.device``) -> ``torch.device``.

    Raises RuntimeError when a CUDA device is asked for and none is present:
    the port never moves to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch finds no CUDA card; "
            "pass device='cpu' (--cpu on the command line) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev
