"""Synthetic reference (chechaohp/gan-ode) checkpoints for the port's importer
tests (``test_torch_compat_torch.py``, ``test_torch_int8_cli.py``).

``synthetic_reference(name, seed, **overrides)`` draws seeded random values
for every leaf of a tiny JAX ``GANState`` of the config (its structure from
``jax.eval_shape``: nothing is compiled), Adam moments for each parameter
included, and writes them in the reference's ``torch.save`` format: the
layout rules of ``ganode_tpu/compat_torch.py:16-40`` run backwards, under
the reference's key names (``main.{0,3,6,9,12}``, ``recurrent``,
``linear.{0,2}``, ``ode_fn...``, ``f.{0,2}``), each net's keys in the
reference's registration order (the ODE variants' unused inherited
``recurrent`` GRU first, with no Adam state, as torch's lazy state leaves
it). ``check_with_jax`` holds the helper to JAX's own importer: importing
the checkpoint with ``ganode_tpu.compat_torch.import_gan_state`` must give
back every drawn value.
"""
from __future__ import annotations

import jax
import numpy as np
import torch

from ganode_tpu.compat_torch import import_gan_state as jax_import_gan_state
from ganode_tpu.train.runner import build_trainer as jax_build_trainer
from ganode_tpu.utils import config as jax_config
from ganode_tpu_torch.bridge import _adam_state

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
EPOCH = 41000
STEP = 41   # torch Adam's step of most parameters; main.1's and main.4's one less


def _dense(p):
    return {"weight": p["kernel"].T, "bias": p["bias"]}


def _conv(p):  # (*spatial, Ci, Co) -> (Co, Ci, *spatial)
    k = p["kernel"]
    return {"weight": k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))}


def _deconv(p):  # flax (kh, kw, Ci, Co), un-flipped -> torch (Ci, Co, kh, kw)
    return {"weight": p["kernel"][::-1, ::-1].transpose(2, 3, 0, 1)}


def _bn(p, s):
    return {"weight": p["scale"], "bias": p["bias"], "running_mean": s["mean"],
            "running_var": s["var"], "num_batches_tracked": np.int64(7)}


def _gru(p):
    return {"weight_ih": p["wi"].T, "weight_hh": p["wh"].T,
            "bias_ih": p["bi"], "bias_hh": p["bh"]}


def _sd(entries):
    return {f"{prefix}.{leaf}": torch.tensor(np.ascontiguousarray(v))
            for prefix, leaves in entries for leaf, v in leaves.items()}


def generator_sd(params, stats, variant, trunk, unused_gru):
    """The reference generator's state_dict; ``unused_gru`` fills the ODE
    variants' inherited ``recurrent`` GRU."""
    m, main_p, main_s = params["motion"], params["main"], stats["main"]
    entries = [("recurrent", _gru(m["gru"]) if "gru" in m else unused_gru)]
    for i, (c, b) in enumerate(((0, 1), (3, 4), (6, 7), (9, 10))):
        entries += [(f"main.{c}", _deconv(main_p[f"ConvTranspose_{i}"])),
                    (f"main.{b}", _bn(main_p[f"BatchNorm_{i}"],
                                      main_s[f"BatchNorm_{i}"]))]
    if trunk == "mnist28":  # k1s1p2 ConvTranspose2d (Ci, Co, 1, 1)
        entries.append(("main.12", {"weight": main_p["Conv_0"]["kernel"]
                                    .transpose(2, 3, 0, 1)}))
    else:
        entries.append(("main.12", _deconv(main_p["ConvTranspose_4"])))
    mlp = lambda prefix, tree, a, b: [(f"{prefix}{a}", _dense(tree["Dense_0"])),
                                      (f"{prefix}{b}", _dense(tree["Dense_1"]))]
    if variant in ("ode", "sde"):
        entries += mlp("linear.", m["WarmupMLP_0"], 0, 2)
    if variant in ("ode", "ode_rnn"):
        entries += mlp("ode_fn.fn.", m["ode_fn"], 0, 2)
    if variant == "sde":
        entries += mlp("ode_fn.drift_fn.", m["drift_fn"], 0, 2)
        entries += mlp("ode_fn.diffusion_fn.", m["diffusion_fn"], 0, 2)
    if variant == "cde":
        entries += mlp("f.", m["init_net"], 0, 2)
        entries += mlp("ode_fn.linear", m["cde_fn"], 1, 2)
    return _sd(entries)


def _disc_sd(params, stats, convs, bns, names):
    entries = [(c, f"main.{c}", _conv(params[n])) for c, n in zip(convs, names)]
    entries += [(b, f"main.{b}", _bn(params[f"BatchNorm_{i}"],
                                     stats[f"BatchNorm_{i}"]))
                for i, b in enumerate(bns)]
    return _sd([(prefix, leaves) for _, prefix, leaves in sorted(
        entries, key=lambda e: e[0])])


def image_disc_sd(params, stats, kind):
    convs, bns = ((1, 4, 8, 12), (5, 9)) if kind == "patch" else \
        ((1, 4, 8, 12, 15), (5, 9, 13))
    return _disc_sd(params, stats, convs, bns,
                    [f"Conv_{i}" for i in range(len(convs))])


def video_disc_sd(params, stats, kind, ksize):
    convs, bns = ((1, 4, 8, 11), (5, 9)) if kind == "patch" else \
        ((1, 4, 8, 12, 15), (5, 9, 13))
    n = len(convs)
    names = ([f"Conv_{i}" for i in range(n)] if kind == "full" and ksize != 4
             else ["FastGradConv3D_0"] + [f"Conv_{i}" for i in range(n - 1)])
    return _disc_sd(params, stats, convs, bns, names)


def _adam_sd(model_sd, mu_sd, nu_sd, lazy=()):
    names = [k for k in model_sd if not k.endswith(BUFFERS)]
    state = {i: {"step": torch.tensor(float(STEP - ("main.1." in k
                                                     or "main.4." in k))),
                 "exp_avg": mu_sd[k], "exp_avg_sq": nu_sd[k]}
             for i, k in enumerate(names) if not k.startswith(lazy)}
    return {"state": state, "param_groups": [{
        "lr": 2e-4, "betas": (0.5, 0.999), "eps": 1e-8, "weight_decay": 1e-5,
        "amsgrad": False, "params": list(range(len(names)))}]}


def jax_template(name, **overrides):
    """A tiny config's JAX ``GANState`` of zeros (structure only)."""
    cfg = jax_config.get_config(name, **overrides)
    shapes = jax.eval_shape(jax_build_trainer(cfg).init_state,
                            jax.random.PRNGKey(0))
    return cfg, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                       shapes)


def _random_like(tree, rng, positive=False):
    def leaf(a):
        v = rng.standard_normal(a.shape).astype(np.float32)
        return np.abs(v) + 0.5 if positive else v
    return jax.tree_util.tree_map(leaf, tree)


def synthetic_reference(name, seed=0, **overrides):
    """-> (ckpt dict, drawn values, JAX config, JAX template state).

    ``drawn``: ``{net: {"params", "batch_stats", "mu", "nu"}}`` in the JAX
    layout."""
    cfg, template = jax_template(name, **overrides)
    rng = np.random.default_rng(seed)
    drawn = {}
    for net in ("gen", "dis_vid", "dis_img"):
        t = getattr(template, net)
        drawn[net] = {"params": _random_like(t.params, rng),
                      "batch_stats": _random_like(t.batch_stats, rng, True),
                      "mu": _random_like(t.params, rng),
                      "nu": _random_like(t.params, rng, True)}
    d = cfg.dim_z_motion
    unused = {"weight_ih": rng.standard_normal((3 * d, d)).astype(np.float32),
              "weight_hh": rng.standard_normal((3 * d, d)).astype(np.float32),
              "bias_ih": np.zeros(3 * d, np.float32),
              "bias_hh": np.zeros(3 * d, np.float32)}
    builders = {
        "gen": lambda p, s: generator_sd(p, s, cfg.variant, cfg.trunk, unused),
        "dis_vid": lambda p, s: video_disc_sd(p, s, cfg.video_disc,
                                              cfg.video_disc_ksize),
        "dis_img": lambda p, s: image_disc_sd(p, s, cfg.image_disc)}
    models, opts = [], []
    for net in ("gen", "dis_vid", "dis_img"):
        v, build = drawn[net], builders[net]
        model = build(v["params"], v["batch_stats"])
        lazy = ("recurrent.",) if net == "gen" and cfg.variant in (
            "ode", "sde", "cde") else ()
        opts.append(_adam_sd(model, build(v["mu"], v["batch_stats"]),
                             build(v["nu"], v["batch_stats"]), lazy))
        models.append(model)
    ckpt = {"epoch": EPOCH, "model_state_dict": models,
            "optimizer_state_dict": opts}
    return ckpt, drawn, cfg, template


def check_with_jax(ckpt, drawn, cfg, template, import_optimizer=True):
    """JAX's importer on ``ckpt`` must give back the drawn values; returns
    its state (numpy leaves)."""
    state = jax_import_gan_state(ckpt, template, cfg,
                                 import_optimizer=import_optimizer)
    state = jax.tree_util.tree_map(np.asarray, state)
    eq = lambda a, b: jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, a, b))
    for net in ("gen", "dis_vid", "dis_img"):
        got, want = getattr(state, net), drawn[net]
        assert eq(got.params, want["params"]), net
        assert eq(got.batch_stats, want["batch_stats"]), net
        adam = _adam_state(got.opt_state)
        if not import_optimizer:
            assert int(adam.count) == 0
            continue
        assert int(adam.count) == STEP, net
        assert eq(adam.mu, want["mu"]) and eq(adam.nu, want["nu"]), net
    assert int(state.step) == EPOCH
    return state
