"""JAX generator variables <-> the port generator's ``state_dict``.

The JAX side is a nested dict of numpy arrays, as
``jax.tree_util.tree_map(np.asarray, variables)`` gives it:
``{"params": {...}, "batch_stats": {...}}``. The port's modules carry the flax
names, so a flax path ``params/main/ConvTranspose_0/kernel`` becomes the key
``main.ConvTranspose_0.weight``. The layout rules are those written down, in
the other direction, in ``ganode_tpu/compat_torch.py``:

* Dense ``kernel (in, out)``             <-> Linear ``weight (out, in)`` = kernel.T
* Conv ``kernel (kh, kw, Ci, Co)``       <-> Conv2d ``weight (Co, Ci, kh, kw)``
* ConvTranspose ``kernel (kh, kw, Ci, Co)`` <-> ConvTranspose2d ``weight
  (Ci, Co, kh, kw)``, **spatially flipped** as well: torch's transposed conv
  convolves with the flipped kernel, flax's runs an un-flipped correlation
* BatchNorm ``scale``/``bias`` and batch_stats ``mean``/``var`` <->
  ``weight``/``bias``/``running_mean``/``running_var``
* GRU ``wi``/``wh``/``bi``/``bh`` keep their names and layout.

``num_batches_tracked`` has no JAX counterpart: it is set to 0 on the way in
and dropped on the way out.
"""
from __future__ import annotations

import numpy as np
import torch

_PARAM_TO_TORCH = {"scale": "weight", "bias": "bias", "kernel": "weight",
                   "wi": "wi", "wh": "wh", "bi": "bi", "bh": "bh"}
_STAT_TO_TORCH = {"mean": "running_mean", "var": "running_var"}


def _kernel_to_torch(module: str, k: np.ndarray) -> np.ndarray:
    if module.startswith("ConvTranspose"):
        return k[::-1, ::-1].transpose(2, 3, 0, 1)
    if module.startswith("Conv"):
        return k.transpose(3, 2, 0, 1)
    if module.startswith("Dense"):
        return k.T
    raise ValueError(f"no layout rule for a kernel of module {module!r}")


def _kernel_from_torch(module: str, w: np.ndarray) -> np.ndarray:
    if module.startswith("ConvTranspose"):
        return w.transpose(2, 3, 0, 1)[::-1, ::-1]
    if module.startswith("Conv"):
        return w.transpose(2, 3, 1, 0)
    if module.startswith("Dense"):
        return w.T
    raise ValueError(f"no layout rule for the weight of module {module!r}")


def _leaves(tree: dict, prefix=()):
    for name, sub in tree.items():
        if isinstance(sub, dict):
            yield from _leaves(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def jax_to_torch(variables: dict) -> dict:
    """JAX generator variables -> a ``state_dict`` for ``load_state_dict``."""
    sd = {}
    for path, value in _leaves(variables.get("params", {})):
        *mods, leaf = path
        a = np.asarray(value, np.float32)
        if leaf == "kernel":
            a = _kernel_to_torch(mods[-1], a)
        elif leaf not in _PARAM_TO_TORCH:
            raise ValueError(f"unknown parameter {'/'.join(path)}")
        sd[".".join(mods + [_PARAM_TO_TORCH[leaf]])] = torch.tensor(a.copy())
    for path, value in _leaves(variables.get("batch_stats", {})):
        *mods, leaf = path
        if leaf not in _STAT_TO_TORCH:
            raise ValueError(f"unknown batch statistic {'/'.join(path)}")
        sd[".".join(mods + [_STAT_TO_TORCH[leaf]])] = torch.tensor(
            np.asarray(value, np.float32))
        if leaf == "mean":
            sd[".".join(mods + ["num_batches_tracked"])] = torch.tensor(0)
    return sd


def torch_to_jax(state_dict: dict) -> dict:
    """A port ``state_dict`` -> JAX generator variables (numpy leaves)."""
    out = {"params": {}, "batch_stats": {}}
    stat_names = {v: k for k, v in _STAT_TO_TORCH.items()}
    for key, value in state_dict.items():
        *mods, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        a = value.detach().cpu().numpy().astype(np.float32)
        if leaf in stat_names:
            collection, name = "batch_stats", stat_names[leaf]
        elif leaf == "weight" and mods[-1].startswith("BatchNorm"):
            collection, name = "params", "scale"
        elif leaf == "weight":
            collection, name = "params", "kernel"
            a = _kernel_from_torch(mods[-1], a)
        elif leaf in _PARAM_TO_TORCH.values():
            collection, name = "params", leaf
        else:
            raise ValueError(f"unknown state_dict entry {key!r}")
        node = out[collection]
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out
