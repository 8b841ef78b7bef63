"""Import reference (chechaohp/gan-ode) torch checkpoints into the port (twin
of ``ganode_tpu/compat_torch.py``).

The reference trains in PyTorch and saves ``torch.save({'epoch',
'model_state_dict': [gen, disVid, disImg], 'optimizer_state_dict': [...]})``
every 1000 G-steps (reference mnist_moco_ode.py:175-190). This module maps
those state_dicts onto the port's modules, whose parameters carry the flax
names, so a reference user can serve, score or keep training reference
weights here.

Both sides are torch, so the mapping is names; the layouts carry over as they
are, which is what the JAX importer followed by ``bridge.jax_to_torch`` gives:

* ``nn.Linear``, ``nn.Conv2d``, ``nn.Conv3d``, BatchNorm weights and running
  statistics: as they are;
* ``nn.ConvTranspose2d`` ``(Ci, Co, kh, kw)``: as it is (the JAX importer's
  spatial flip and the bridge's cancel);
* ``nn.GRUCell`` ``weight_ih`` / ``weight_hh`` ``(3h, in)``: transposed, the
  port's GRU keeping flax's ``wi = weight_ih.T`` (gates [r, z, n]);
* ``mnist28``'s last layer, ``main.12``, a ``ConvTranspose2d(k=1, s=1, p=2)``
  with weight ``(Ci, Co, 1, 1)``: the port's ``Conv_0``, an ``nn.Conv2d``
  ``(Co, Ci, 1, 1)`` with a 2-pixel crop, so its two first axes swap.

Each rule is its own inverse. Reference module names per variant
(state_dict key prefixes): ``main.{0,3,6,9,12}`` deconv trunk + ``main.{1,4,
7,10}`` BatchNorm (models/mocogan.py:200-215, mocogan_ode.py:66-84),
``recurrent`` GRU (mocogan.py:198), ``linear.{0,2}`` warm-up MLP and
``ode_fn.fn.{0,2}`` field (mocogan_ode.py:10-14,30-35),
``ode_fn.drift_fn/diffusion_fn.{0,2}`` (mocogan_sde.py:10-19),
``ode_fn.linear1/linear2`` + ``f.{0,2}`` (mocogan_cde.py:20-21,52-57).
Unused inherited submodules (every ODE variant still carries a ``recurrent``
GRU it never calls) are ignored.

The BatchNorm ``num_batches_tracked`` counters are set to 0, as the bridge
sets them (the port's BatchNorm never reads them).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

__all__ = [
    "load_reference_checkpoint",
    "import_generator",
    "import_image_discriminator",
    "import_video_discriminator",
    "import_gan_state",
]

# port key -> (reference key, layout rule, its own inverse)
Mapping = Dict[str, Tuple[str, Callable[[torch.Tensor], torch.Tensor]]]


def _same(t):
    return t


def _transposed(t):
    return t.t()


def _swap01(t):
    return t.transpose(0, 1)


def _linear(port: str, ref: str) -> Mapping:
    return {f"{port}.weight": (f"{ref}.weight", _same),
            f"{port}.bias": (f"{ref}.bias", _same)}


def _mlp2(port: str, ref0: str, ref1: str) -> Mapping:
    return {**_linear(f"{port}.Dense_0", ref0),
            **_linear(f"{port}.Dense_1", ref1)}


def _bn(port: str, ref: str) -> Mapping:
    return {f"{port}.{leaf}": (f"{ref}.{leaf}", _same)
            for leaf in ("weight", "bias", "running_mean", "running_var")}


def _gru(port: str, ref: str) -> Mapping:
    return {f"{port}.wi": (f"{ref}.weight_ih", _transposed),
            f"{port}.wh": (f"{ref}.weight_hh", _transposed),
            f"{port}.bi": (f"{ref}.bias_ih", _same),
            f"{port}.bh": (f"{ref}.bias_hh", _same)}


def _motion(variant: str) -> Mapping:
    if variant == "gru":
        return _gru("motion.gru", "recurrent")
    if variant == "ode":
        return {**_mlp2("motion.WarmupMLP_0", "linear.0", "linear.2"),
                **_mlp2("motion.ode_fn", "ode_fn.fn.0", "ode_fn.fn.2")}
    if variant == "sde":
        return {**_mlp2("motion.WarmupMLP_0", "linear.0", "linear.2"),
                **_mlp2("motion.drift_fn", "ode_fn.drift_fn.0",
                        "ode_fn.drift_fn.2"),
                **_mlp2("motion.diffusion_fn", "ode_fn.diffusion_fn.0",
                        "ode_fn.diffusion_fn.2")}
    if variant == "cde":
        return {**_mlp2("motion.init_net", "f.0", "f.2"),
                **_mlp2("motion.cde_fn", "ode_fn.linear1", "ode_fn.linear2")}
    if variant == "ode_rnn":
        return {**_gru("motion.gru", "recurrent"),
                **_mlp2("motion.ode_fn", "ode_fn.fn.0", "ode_fn.fn.2")}
    raise ValueError(f"unknown motion variant {variant!r}")


def generator_mapping(variant: str, trunk: str) -> Mapping:
    """The port generator's keys -> reference VideoGenerator* keys and rules.

    ``trunk``: 'mnist28' (reference mocogan_ode.py:66-84: the final k1s1p2
    deconv becomes the port's 1x1 ``Conv_0``, same weights) or 'dcgan64'
    (mocogan.py:200-215: the final layer is a k4s2p1 deconv)."""
    out = _motion(variant)
    # four deconv+BN stages shared by both trunks: main.{0,3,6,9}/{1,4,7,10}
    for i, (conv, bn) in enumerate(((0, 1), (3, 4), (6, 7), (9, 10))):
        out[f"main.ConvTranspose_{i}.weight"] = (f"main.{conv}.weight", _same)
        out.update(_bn(f"main.BatchNorm_{i}", f"main.{bn}"))
    if trunk == "mnist28":
        out["main.Conv_0.weight"] = ("main.12.weight", _swap01)
    elif trunk == "dcgan64":
        out["main.ConvTranspose_4.weight"] = ("main.12.weight", _same)
    else:
        raise ValueError(f"unsupported trunk {trunk!r} for reference import")
    return out


def image_discriminator_mapping(kind: str = "patch") -> Mapping:
    """PatchImageDiscriminator (mocogan.py:66-93) or ImageDiscriminator
    (:32-63): the torch Sequential indices skip the parameter-less
    Noise/LeakyReLU layers."""
    if kind == "patch":
        convs, bns = (1, 4, 8, 12), (5, 9)
    elif kind == "full":
        convs, bns = (1, 4, 8, 12, 15), (5, 9, 13)
    else:
        raise ValueError(f"unknown image discriminator kind {kind!r}")
    out = {f"Conv_{i}.weight": (f"main.{c}.weight", _same)
           for i, c in enumerate(convs)}
    for i, b in enumerate(bns):
        out.update(_bn(f"BatchNorm_{i}", f"main.{b}"))
    return out


def video_discriminator_mapping(kind: str = "full", ksize: int = 4) -> Mapping:
    """VideoDiscriminator / CategoricalVideoDiscriminator (mocogan.py:
    129-182) or PatchVideoDiscriminator (:96-126). The ksize-4 and patch
    discriminators' first conv is ``FastGradConv3D_0`` and the others
    renumber from ``Conv_0``; the categorical one nests its body under
    ``VideoDiscriminator_0``."""
    if kind in ("full", "categorical"):
        convs, bns = (1, 4, 8, 12, 15), (5, 9, 13)
        fast_first = ksize == 4
    elif kind == "patch":
        convs, bns = (1, 4, 8, 11), (5, 9)
        fast_first = True
    else:
        raise ValueError(f"unknown video discriminator kind {kind!r}")
    names = ([f"Conv_{i}" for i in range(len(convs))] if not fast_first else
             ["FastGradConv3D_0"] + [f"Conv_{i}" for i in range(len(convs) - 1)])
    out = {f"{name}.weight": (f"main.{c}.weight", _same)
           for name, c in zip(names, convs)}
    for i, b in enumerate(bns):
        out.update(_bn(f"BatchNorm_{i}", f"main.{b}"))
    if kind == "categorical":
        out = {f"VideoDiscriminator_0.{k}": v for k, v in out.items()}
    return out


def _convert(sd: Dict[str, Any], mapping: Mapping) -> Dict[str, torch.Tensor]:
    """A reference state_dict -> the port's keys: new contiguous float32
    tensors on the CPU (sharing no storage with ``sd`` or each other)."""
    return {port: rule(torch.as_tensor(sd[ref]).detach().to(
                "cpu", torch.float32, copy=True)).contiguous()
            for port, (ref, rule) in mapping.items()}


def import_generator(sd: Dict[str, Any], *, variant: str = "ode",
                     trunk: str = "mnist28") -> Dict[str, torch.Tensor]:
    """Reference VideoGenerator* state_dict -> the port generator's
    parameters and BatchNorm running statistics by key (float32, CPU)."""
    return _convert(sd, generator_mapping(variant, trunk))


def import_image_discriminator(sd: Dict[str, Any], *, kind: str = "patch"
                               ) -> Dict[str, torch.Tensor]:
    """Reference image discriminator state_dict -> the port's keys."""
    return _convert(sd, image_discriminator_mapping(kind))


def import_video_discriminator(sd: Dict[str, Any], *, kind: str = "full",
                               ksize: int = 4) -> Dict[str, torch.Tensor]:
    """Reference video discriminator state_dict -> the port's keys."""
    return _convert(sd, video_discriminator_mapping(kind, ksize))


def load_reference_checkpoint(path: str) -> Dict[str, Any]:
    """Unpickle a reference ``state_normal{epoch}.ckpt``."""
    return torch.load(path, map_location="cpu", weights_only=True)


_BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def _moment_sds(model_sd: Dict[str, Any], opt_sd: Dict[str, Any]):
    """torch Adam state -> two fake state_dicts valued with exp_avg /
    exp_avg_sq, and the largest step taken.

    torch's ``state_dict()`` emits each submodule's parameters before its
    buffers, in registration order — the same traversal ``parameters()``
    uses — so the state_dict keys minus the BatchNorm buffers ARE the
    optimizer's parameter order (the reference passes ``model.parameters()``
    straight to Adam, mnist_moco_ode.py:86-88). Valuing a copy of the model
    state_dict with the moments lets the same mappings convert them (moments
    are elementwise with their parameters, so every layout rule applies
    unchanged). A parameter without Adam state (torch's state is lazy: the
    ODE variants' unused inherited GRU never gets a gradient) has zero
    moments, as optax's init has them."""
    names = [k for k in model_sd if not k.endswith(_BUFFER_SUFFIXES)]
    order = [i for g in opt_sd["param_groups"] for i in g["params"]]
    state = opt_sd["state"]
    if len(order) != len(names):
        raise ValueError(
            f"optimizer has {len(order)} params, model has {len(names)}")
    avg_sd, sq_sd = dict(model_sd), dict(model_sd)
    count = 0
    for name, idx in zip(names, order):
        s = state.get(idx)
        if s is None:
            z = torch.zeros_like(torch.as_tensor(model_sd[name]))
            avg_sd[name], sq_sd[name] = z, z
            continue
        avg_sd[name] = s["exp_avg"]
        sq_sd[name] = s["exp_avg_sq"]
        count = max(count, int(s["step"]))
    return avg_sd, sq_sd, count


def _aligned(imported: Dict[str, torch.Tensor], like: Dict[str, torch.Tensor],
             what: str) -> Dict[str, torch.Tensor]:
    """``imported`` checked against the port module's ``like`` (the same keys
    and shapes) and cast to its dtypes and devices."""
    missing = sorted(set(like) - set(imported))
    if missing:
        raise KeyError(f"import missing parameter {what}.{missing[0]}")
    extra = set(imported) - set(like)
    if extra:
        raise KeyError(f"imported parameters our model lacks: {sorted(extra)}")
    out = {}
    for key, ref in like.items():
        got = imported[key]
        if got.shape != ref.shape:
            raise ValueError(f"{what}.{key}: reference shape "
                             f"{tuple(got.shape)} != ours {tuple(ref.shape)}")
        out[key] = got.to(ref.device, ref.dtype)
    return out


def _module_entries(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def import_gan_state(ckpt: Dict[str, Any], state, config, *,
                     import_optimizer: bool = True):
    """Reference checkpoint dict -> the port's ``GANState``, in place.

    ``ckpt`` is the dict the reference saves ({'epoch', 'model_state_dict':
    [gen, disVid, disImg], 'optimizer_state_dict': [genOpt, disVidOpt,
    disImgOpt]}); ``state`` the port's state of the matching config
    (``build_trainer(config).init_state()``), whose modules take the weights
    and BatchNorm statistics. When the checkpoint carries torch Adam state
    and ``import_optimizer`` is true, every parameter of that net gets
    ``exp_avg`` / ``exp_avg_sq`` (zeros where the reference has none) and one
    ``step``, the largest of the checkpoint's, as optax's single count; a net
    without it keeps its optimizer as it is. ``state.step`` becomes the
    reference 'epoch' (one reference "epoch" == one G-step,
    mnist_moco_ode.py:113), and the EMA, when on, starts at the imported
    generator weights. Returns ``state``.
    """
    if config.video_disc not in ("full", "patch") or \
            config.image_disc not in ("full", "patch"):
        raise ValueError(
            "reference checkpoints only exist for the BN discriminators "
            f"(got video_disc={config.video_disc!r}, "
            f"image_disc={config.image_disc!r}); the SN critics are this "
            "framework's addition and have no reference counterpart")
    mappings = {"gen": generator_mapping(config.variant, config.trunk),
                "dis_vid": video_discriminator_mapping(
                    config.video_disc, config.video_disc_ksize),
                "dis_img": image_discriminator_mapping(config.image_disc)}
    model_sds = dict(zip(("gen", "dis_vid", "dis_img"),
                         ckpt["model_state_dict"]))
    # convert and check all three before touching the state
    loaded = {name: _aligned(_convert(model_sds[name], mapping),
                             _module_entries(getattr(state, name).module),
                             name)
              for name, mapping in mappings.items()}
    for name, entries in loaded.items():
        module = getattr(state, name).module
        sd = module.state_dict()
        sd.update(entries)
        sd.update({k: torch.zeros_like(v) for k, v in sd.items()
                   if k.endswith("num_batches_tracked")})
        module.load_state_dict(sd, strict=True)

    opt_sds = ckpt.get("optimizer_state_dict") or [None] * 3
    if import_optimizer:
        for name, opt_sd in zip(("gen", "dis_vid", "dis_img"), opt_sds):
            if not opt_sd or not opt_sd.get("state"):
                continue  # fresh / absent optimizer in the checkpoint
            net = getattr(state, name)
            avg_sd, sq_sd, count = _moment_sds(model_sds[name], opt_sd)
            params = dict(net.module.named_parameters())
            mu = _aligned({k: v for k, v in _convert(avg_sd, mappings[name]).items()
                           if k in params}, params, name)
            nu = _aligned({k: v for k, v in _convert(sq_sd, mappings[name]).items()
                           if k in params}, params, name)
            for key, p in params.items():
                net.opt.state[p] = {"step": torch.tensor(float(count)),
                                    "exp_avg": mu[key], "exp_avg_sq": nu[key]}
    if state.ema_params is not None:
        # the EMA (the port's addition) has no reference history: it starts
        # at the imported weights, so eval sampling starts from them
        state.ema_params = {k: p.detach().clone()
                            for k, p in state.gen.module.named_parameters()}
    state.step = int(ckpt.get("epoch", 0))
    return state
