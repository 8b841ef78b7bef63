"""JAX variables <-> the port's ``state_dict``s, and a whole flax ``GANState``
<-> the port's trainer state.

The JAX side is a nested dict of numpy arrays, as
``jax.tree_util.tree_map(np.asarray, variables)`` gives it:
``{"params": {...}, "batch_stats": {...}, "spectral": {...}}``. The port's modules carry the flax
names, so a flax path ``params/main/ConvTranspose_0/kernel`` becomes the key
``main.ConvTranspose_0.weight``. The layout rules are those written down, in
the other direction, in ``ganode_tpu/compat_torch.py``:

* Dense ``kernel (in, out)``             <-> Linear ``weight (out, in)`` = kernel.T
* Conv ``kernel (kh, kw, Ci, Co)``       <-> Conv2d ``weight (Co, Ci, kh, kw)``;
  3-D Conv and ``FastGradConv3D`` ``kernel (kt, kh, kw, Ci, Co)`` <->
  Conv3d ``weight (Co, Ci, kt, kh, kw)``
* ConvTranspose ``kernel (kh, kw, Ci, Co)`` <-> ConvTranspose2d ``weight
  (Ci, Co, kh, kw)``, **spatially flipped** as well: torch's transposed conv
  convolves with the flipped kernel, flax's runs an un-flipped correlation
* BatchNorm ``scale``/``bias`` and batch_stats ``mean``/``var`` <->
  ``weight``/``bias``/``running_mean``/``running_var``; GroupNorm
  ``scale``/``bias`` <-> ``weight``/``bias``
* GRU ``wi``/``wh``/``bi``/``bh`` and the mixture-of-experts field's stacked
  ``expert_w1``/``expert_b1``/``expert_w2``/``expert_b2`` keep their names
  and layout; its ``gate`` is a Dense.
* The eval nets (``eval/embedder.py``): 2-D and 3-D ``Conv`` and ``Dense``
  by the rules above, the video classifier's ``head`` a Dense;
  ``ImageClassifier`` flattens channels-last, as flax does, so its
  ``Dense_0`` needs no permutation of its rows.
* ``SNConv`` (``proj_down`` included) and ``SNDense`` kernels follow the
  conv and dense rules; their ``spectral`` collection's ``u`` <-> the
  buffer ``u``.
* The continuous-depth block's field (``Conv2dODEField``): ``k0``/``k1``
  ``(3, 3, Ci, Co)`` <-> ``(Co, Ci, 3, 3)`` (correlations both: not
  flipped); ``b0``, ``b1`` and ``embed_*`` keep their names and layout; the
  block's ``spectral`` ``u0``/``u1`` <-> buffers of the same names.

``num_batches_tracked`` has no JAX counterpart: it is set to 0 on the way in
and dropped on the way out. Leaves cross as float32, float64 ones as float64.

The int8 serving state (JAX's ``{"layers": [{"kernel_q", "scale",
"bias"}]}``; the port's ``{"layers": [{"packed", "ci", "scale", "bias"}]}``,
``ops/quant.py``) crosses with ``int8_state_to_torch`` /
``int8_state_to_jax``: ``kernel_q`` by the ConvTranspose rule above, flip
included, int8 kept (``mnist28``'s 1x1 ``Conv_0`` too: K3 runs it as the
transposed conv with k=1, s=1, p=0, whose ``(Ci, Co, 1, 1)`` layout that
rule gives), packed into K3's layout on the way in and unpacked from it on
the way out (the port holds each kernel once); ``scale`` and ``bias`` as
they are.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.quant import pack_kernel, unpack_kernel

_PARAM_TO_TORCH = {"scale": "weight", "bias": "bias", "kernel": "weight",
                   "wi": "wi", "wh": "wh", "bi": "bi", "bh": "bh",
                   "expert_w1": "expert_w1", "expert_b1": "expert_b1",
                   "expert_w2": "expert_w2", "expert_b2": "expert_b2",
                   "k0": "k0", "k1": "k1", "b0": "b0", "b1": "b1",
                   "embed_gamma": "embed_gamma",
                   "embed_gamma_b": "embed_gamma_b",
                   "embed_beta": "embed_beta"}
# the ODE field's raw HWIO kernels
_FIELD_KERNELS = ("k0", "k1")
_SPECTRAL = ("u", "u0", "u1")
# modules whose 2-D kernel is a Dense's (``head``: the video embedder's
# classification layer, ``ganode_tpu/eval/embedder.py:117``)
_DENSE = ("Dense", "SNDense", "gate", "head")
_STAT_TO_TORCH = {"mean": "running_mean", "var": "running_var"}


def _is_conv(module: str, rank: int) -> bool:
    """A forward convolution's kernel: 2-D or 3-D ``Conv`` or ``SNConv``
    (the continuous-depth block's ``proj_down`` is one), or the 3-D
    ``FastGradConv3D``."""
    return ((module.startswith(("Conv", "SNConv", "proj_down"))
             and rank in (4, 5))
            or (module.startswith("FastGradConv3D") and rank == 5))


def _kernel_to_torch(module: str, k: np.ndarray) -> np.ndarray:
    if module.startswith("ConvTranspose") and k.ndim == 4:
        return k[::-1, ::-1].transpose(2, 3, 0, 1)
    if _is_conv(module, k.ndim):  # (*spatial, Ci, Co) -> (Co, Ci, *spatial)
        return k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))
    if module.startswith(_DENSE) and k.ndim == 2:
        return k.T
    raise ValueError(f"no layout rule for a {k.ndim}-D kernel of module "
                     f"{module!r}")


def _kernel_from_torch(module: str, w: np.ndarray) -> np.ndarray:
    if module.startswith("ConvTranspose") and w.ndim == 4:
        return w.transpose(2, 3, 0, 1)[::-1, ::-1]
    if _is_conv(module, w.ndim):  # (Co, Ci, *spatial) -> (*spatial, Ci, Co)
        return w.transpose(*range(2, w.ndim), 1, 0)
    if module.startswith(_DENSE) and w.ndim == 2:
        return w.T
    raise ValueError(f"no layout rule for the {w.ndim}-D weight of module "
                     f"{module!r}")


def _real(a) -> np.ndarray:
    """A leaf as float32, or as float64 where it is float64 (a float64
    reference run's state crosses without rounding)."""
    a = np.asarray(a)
    return a.astype(np.float64 if a.dtype == np.float64 else np.float32)


def _leaves(tree: dict, prefix=()):
    for name, sub in tree.items():
        if isinstance(sub, dict):
            yield from _leaves(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def jax_to_torch(variables: dict) -> dict:
    """JAX module variables -> a ``state_dict`` for ``load_state_dict``."""
    sd = {}
    for path, value in _leaves(variables.get("params", {})):
        *mods, leaf = path
        a = _real(value)
        if leaf == "kernel":
            a = _kernel_to_torch(mods[-1], a)
        elif leaf in _FIELD_KERNELS:
            a = a.transpose(3, 2, 0, 1)
        elif leaf not in _PARAM_TO_TORCH:
            raise ValueError(f"unknown parameter {'/'.join(path)}")
        sd[".".join(mods + [_PARAM_TO_TORCH[leaf]])] = torch.tensor(a.copy())
    for path, value in _leaves(variables.get("batch_stats", {})):
        *mods, leaf = path
        if leaf not in _STAT_TO_TORCH:
            raise ValueError(f"unknown batch statistic {'/'.join(path)}")
        sd[".".join(mods + [_STAT_TO_TORCH[leaf]])] = torch.tensor(
            _real(value))
        if leaf == "mean":
            sd[".".join(mods + ["num_batches_tracked"])] = torch.tensor(0)
    for path, value in _leaves(variables.get("spectral") or {}):
        if path[-1] not in _SPECTRAL:
            raise ValueError(f"unknown spectral variable {'/'.join(path)}")
        sd[".".join(path)] = torch.tensor(_real(value))
    return sd


def torch_to_jax(state_dict: dict) -> dict:
    """A port ``state_dict`` -> JAX module variables (numpy leaves)."""
    out = {"params": {}, "batch_stats": {}, "spectral": {}}
    stat_names = {v: k for k, v in _STAT_TO_TORCH.items()}
    for key, value in state_dict.items():
        *mods, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        a = _real(value.detach().cpu().numpy())
        if leaf in stat_names:
            collection, name = "batch_stats", stat_names[leaf]
        elif leaf in _SPECTRAL:
            collection, name = "spectral", leaf
        elif leaf == "weight" and mods[-1].startswith(("BatchNorm",
                                                       "GroupNorm")):
            collection, name = "params", "scale"
        elif leaf == "weight":
            collection, name = "params", "kernel"
            a = _kernel_from_torch(mods[-1], a)
        elif leaf in _FIELD_KERNELS:
            collection, name = "params", leaf
            a = a.transpose(2, 3, 1, 0)
        elif leaf in _PARAM_TO_TORCH.values():
            collection, name = "params", leaf
        else:
            raise ValueError(f"unknown state_dict entry {key!r}")
        node = out[collection]
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    for collection in ("batch_stats", "spectral"):
        if not out[collection]:
            del out[collection]
    return out


# ---------------------------------------------------------------------------
# Whole train states. The JAX side is a flax ``GANState`` with numpy leaves
# (``jax.tree_util.tree_map(np.asarray, state)``), read by attribute, so this
# module imports nothing of flax or optax. Each net's optax state is
# ``chain(add_decayed_weights, adam)``'s, somewhere inside which sits one
# ``ScaleByAdamState(count, mu, nu)``; its moments are trees shaped like the
# params and cross with the params' layout rules onto ``torch.optim.Adam``'s
# ``exp_avg`` / ``exp_avg_sq``, and ``count`` onto its ``step``. The other
# way, the state comes back as nested dicts:
#
#     {"gen" | "dis_img" | "dis_vid": {"params", "batch_stats",
#                                      "spectral" (or None),
#                                      "opt_state": {"count", "mu", "nu"}},
#      "step", "ema_params" (or None),
#      "ada" (None, or {"p_img", "p_vid"}: 0-d float32 arrays)}
# ---------------------------------------------------------------------------

NETS = ("gen", "dis_img", "dis_vid")


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` inside an optax state (tuples all the way)."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def _params_to_torch(tree: dict, module) -> dict:
    """A params-shaped JAX tree -> ``{parameter name: tensor}`` of
    ``module``'s parameters, on their devices."""
    sd = jax_to_torch({"params": tree})
    named = dict(module.named_parameters())
    if sorted(sd) != sorted(named):
        raise ValueError(f"the tree's leaves {sorted(set(sd) ^ set(named))} "
                         "do not match the module's parameters")
    return {k: sd[k].to(named[k].device, named[k].dtype) for k in named}


def gan_state_to_torch(jax_state, state) -> None:
    """Load a flax ``GANState`` (numpy leaves) into the port's ``GANState``
    in place: each net's params, batch stats and spectral-norm ``u``, its
    Adam step and moments, the step count, the EMA params and the ADA
    controller's probabilities. A JAX state without ``ada`` leaves the
    port state's own, as a checkpoint without one does
    (``utils/checkpoint.py``)."""
    for name in NETS:
        src, net = getattr(jax_state, name), getattr(state, name)
        device = next(net.module.parameters()).device
        sd = jax_to_torch({"params": src.params,
                           "batch_stats": src.batch_stats,
                           "spectral": getattr(src, "spectral", None)})
        net.module.load_state_dict({k: v.to(device) for k, v in sd.items()},
                                   strict=True)
        adam = _adam_state(src.opt_state)
        if adam is None:
            raise ValueError(f"no Adam state (count, mu, nu) in {name}'s "
                             "optimizer state")
        mu = _params_to_torch(adam.mu, net.module)
        nu = _params_to_torch(adam.nu, net.module)
        count = float(np.asarray(adam.count))
        for key, p in net.module.named_parameters():
            net.opt.state[p] = {"step": torch.tensor(count),
                                "exp_avg": mu[key], "exp_avg_sq": nu[key]}
    state.step = int(np.asarray(jax_state.step))
    state.ema_params = (None if jax_state.ema_params is None else
                        _params_to_torch(jax_state.ema_params,
                                         state.gen.module))
    ada = getattr(jax_state, "ada", None)
    if ada is not None:
        device = next(state.gen.module.parameters()).device
        state.ada = {k: torch.tensor(np.asarray(ada[k]), dtype=torch.float32,
                                     device=device)
                     for k in ("p_img", "p_vid")}


def torch_gan_state_to_jax(state) -> dict:
    """The port's ``GANState`` -> the nested-dict form above (numpy
    leaves)."""
    out = {}
    for name in NETS:
        net = getattr(state, name)
        named = dict(net.module.named_parameters())
        variables = torch_to_jax(net.module.state_dict())
        adam = [net.opt.state.get(p, {}) for p in named.values()]
        steps = {float(a["step"]) for a in adam if a}
        if len(steps) > 1:
            raise ValueError(f"{name}'s parameters have taken different "
                             f"numbers of Adam steps: {sorted(steps)}")
        moment = lambda key: torch_to_jax({
            k: a[key] if a else torch.zeros_like(p)
            for (k, p), a in zip(named.items(), adam)})["params"]
        out[name] = {
            "params": variables["params"],
            "batch_stats": variables.get("batch_stats", {}),
            "spectral": variables.get("spectral"),
            "opt_state": {"count": np.int32(steps.pop() if steps else 0),
                          "mu": moment("exp_avg"),
                          "nu": moment("exp_avg_sq")}}
    out["step"] = np.int32(state.step)
    out["ema_params"] = (None if state.ema_params is None
                         else torch_to_jax(state.ema_params)["params"])
    out["ada"] = (None if state.ada is None else
                  {k: np.asarray(v.detach().cpu(), np.float32)
                   for k, v in state.ada.items()})
    return out


def odegan_params_to_torch(all_params: dict, modules: dict) -> dict:
    """The JAX ODE-GAN trainer's ``all_params`` (``{"gen", "dis_img",
    "dis_vid"}``, each a params tree with numpy leaves, or None) -> the
    port's (each a ``{parameter name: tensor}`` dict of the module of that
    name in ``modules``, on its device), as ``train.ODEGANTrainer`` takes it."""
    return {name: None if tree is None else
            _params_to_torch(tree, modules[name])
            for name, tree in all_params.items()}


def odegan_params_to_jax(all_params: dict) -> dict:
    """The port's ODE-GAN ``all_params`` -> JAX params trees (numpy leaves),
    None kept."""
    return {name: None if p is None else torch_to_jax(p)["params"]
            for name, p in all_params.items()}


def int8_state_to_torch(qstate: dict) -> dict:
    """JAX's int8 serving state (numpy leaves) -> the port's, on the CPU."""
    layers = []
    for layer in qstate["layers"]:
        k = np.asarray(layer["kernel_q"])
        kq = torch.tensor(k[::-1, ::-1].transpose(2, 3, 0, 1).copy())
        layers.append({"packed": pack_kernel(kq), "ci": kq.shape[0],
                       "scale": torch.tensor(_real(layer["scale"])),
                       "bias": torch.tensor(_real(layer["bias"]))})
    return {"layers": layers}


def int8_state_to_jax(qstate: dict) -> dict:
    """The port's int8 serving state -> JAX's (numpy leaves)."""
    return {"layers": [{
        "kernel_q": unpack_kernel(layer).cpu().numpy().transpose(
            2, 3, 0, 1)[::-1, ::-1].copy(),
        "scale": _real(layer["scale"].cpu().numpy()),
        "bias": _real(layer["bias"].cpu().numpy())}
        for layer in qstate["layers"]]}
