"""How far one float32 ``ucf_gres`` / ``ucf_odegres`` training step lands
from float64, in JAX and in the port, over several seeds, on the CPU at the
tiny widths of ``gres_step_parity.py``; and how many of the generator
trunk's ReLU inputs change sign between float32 and float64 in one call.

    PYTHONPATH=. python tests/gres_float32_drift.py ucf_gres 0 1 2 3 4 5 6
    PYTHONPATH=. python tests/gres_float32_drift.py ucf_odegres 0 \
        --perturb 1e-12 [--two-pass-variance]

Per seed (the JAX init key, both batches and both step keys derive from
it) JAX takes a float32 step to make the carried-across state; from there
it takes the step under test in float32 and under x64. JAX draws other noise
under x64, so the float64 reference of the float32 steps is the port's
float64 step on JAX's float32 noise, and the port's float64 step on JAX's
x64 noise is held against JAX's x64 step. Printed per net and part
(``params``, Adam's ``mu`` and ``nu``, ``batch_stats``, ``spectral``):
max |diff| over the part's largest magnitude, and for the generator the
leaf of the largest difference. ``--perturb E`` also takes both float64
steps on real batches scaled by ``1 + E``: a distance that jumps far above
E marks an input at a kink (a ReLU at 0) in that float64 step.
``--two-pass-variance`` runs JAX's BatchNorms with the two-pass variance
``E[(x - E[x])^2]``, as the port's, instead of flax's default one-pass
``E[x^2] - E[x]^2`` (``flax.linen.normalization._compute_stats``'s
``use_fast_variance``, wrapped here; the JAX package is not edited).
"""
import argparse
import functools
import sys

import flax.linen.normalization as flax_norm
import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

import ganode_tpu_torch.models.motion as motion_mod
from ganode_tpu_torch import bridge
from ganode_tpu_torch.ops import reference_rk4_motion
from ganode_tpu_torch.utils.config import get_config
from gres_step_parity import B, DZC, DZM, S, T, _jax_trainer, _port_trainer
from torch_parity import (NoiseRecorder, f64_tree, net_dict, rgb_batches,
                          to_torch)

PARTS = ("params", "mu", "nu", "batch_stats", "spectral")


def parts(d):
    return {"params": d["params"], "mu": d["opt_state"]["mu"],
            "nu": d["opt_state"]["nu"], "batch_stats": d["batch_stats"],
            "spectral": d["spectral"]}


def distance(a, b):
    """(max |a - b| over max |b| across the part, the leaf of the max)."""
    la = dict(jax.tree_util.tree_leaves_with_path(a))
    lb = jax.tree_util.tree_leaves_with_path(b)
    if not lb:
        return 0.0, ""
    scale = max(float(np.abs(np.asarray(v, np.float64)).max()) for _, v in lb)
    diffs = [(float(np.abs(np.asarray(la[p], np.float64)
                           - np.asarray(v, np.float64)).max()), p)
             for p, v in lb]
    d, p = max(diffs, key=lambda x: x[0])
    return d / scale, jax.tree_util.keystr(p)


def carried(cfg, state1, dtype):
    """The port's trainer and state in ``dtype`` with the carried-across
    JAX state."""
    tr, state = _port_trainer(cfg)
    if dtype == torch.float64:
        for name in bridge.NETS:
            getattr(state, name).module.double()
        state1 = f64_tree(state1)
    bridge.gan_state_to_torch(state1, state)
    return tr, state


def port_step(cfg, state1, noise, batches, dtype):
    """The port's step from the carried-across state, in ``dtype``, on a
    noise tape and real batches -> its state in the bridge's form."""
    tr, state = carried(cfg, state1, dtype)
    tape = [{k: v.to(dtype) if v.is_floating_point() else v
             for k, v in d.items()} for d in to_torch(noise)]
    tr.train_step(state, *(torch.from_numpy(np.asarray(x)).to(dtype)
                           for x in batches), noise=tape)
    return bridge.torch_gan_state_to_jax(state)


def relu_flips(cfg, state1, z):
    """ReLU inputs of one train-mode trunk call on ``z``, from the
    carried-across state, whose sign differs between the float32 and the
    float64 trunk -> (flips, inputs)."""
    seen = {}
    for key, dtype in (("32", torch.float32), ("64", torch.float64)):
        tr, _ = carried(cfg, state1, dtype)
        acts = seen[key] = []

        def act(x, acts=acts):
            acts.append(x.detach().double())
            return torch.relu(x)
        for m in tr.gen.main.modules():
            if hasattr(m, "activation"):
                m.activation = act
        with pytest.MonkeyPatch.context() as mp, torch.no_grad():
            mp.setattr("ganode_tpu_torch.models.mocogan.F.relu", act)
            tr.gen.main.train()(z.to(next(tr.gen.parameters()).dtype))
    flips = sum(int(((a > 0) != (b > 0)).sum())
                for a, b in zip(seen["32"], seen["64"]))
    return flips, sum(a.numel() for a in seen["64"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", choices=("ucf_gres", "ucf_odegres"))
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--perturb", type=float, default=0.0)
    ap.add_argument("--two-pass-variance", action="store_true")
    args = ap.parse_args(argv)
    if args.two_pass_variance:
        stats = flax_norm._compute_stats
        flax_norm._compute_stats = functools.wraps(stats)(
            lambda *a, **kw: stats(*a, **{**kw, "use_fast_variance": False}))
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    motion_mod.fused_rk4_motion = reference_rk4_motion  # float32 only
    cfg = get_config(args.config)
    jtr = _jax_trainer(cfg)
    with jax.enable_x64(False):
        init, step32 = jax.jit(jtr.init_state), jax.jit(jtr.train_step)
    with jax.enable_x64(True):
        step64 = jax.jit(jtr.train_step)
    # the recorder of a trace takes the noise of every later call: one each
    rec32, rec64 = NoiseRecorder(), NoiseRecorder()
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    for seed in args.seeds:
        b1 = rgb_batches(100 + seed, B, T, S)
        b2 = rgb_batches(200 + seed, B, T, S)
        k1 = jax.random.PRNGKey(1000 + seed)
        k2 = jax.random.PRNGKey(2000 + seed)
        with jax.enable_x64(False), nn.intercept_methods(rec32):
            s1, _ = step32(init(jax.random.PRNGKey(seed)), *b1, k1)
            jax.effects_barrier()
            rec32.log.clear()
            j32, _ = step32(s1, *b2, k2)
            jax.effects_barrier()
        s1 = as_np(s1)
        runs = {"jax_x64": f64_tree(b2)}
        if args.perturb:
            runs["jax_x64_perturbed"] = [x * (1 + args.perturb)
                                         for x in f64_tree(b2)]
        j64, noise64 = {}, None
        for key, batches in runs.items():
            rec64.log.clear()
            with jax.enable_x64(True), nn.intercept_methods(rec64):
                j64[key] = as_np(step64(f64_tree(s1), *batches, k2)[0])
                jax.effects_barrier()
            noise64 = noise64 or rec64.samples(B, T, DZC)
        noise32 = rec32.samples(B, T, DZC)
        j32 = as_np(j32)
        p32 = port_step(cfg, s1, noise32, b2, torch.float32)
        p64 = port_step(cfg, s1, noise32, b2, torch.float64)
        p64n = port_step(cfg, s1, noise64, b2, torch.float64)
        pairs = {"jax f32 vs f64": (j32, p64), "port f32 vs f64": (p32, p64),
                 "port f32 vs jax f32": (p32, j32),
                 "port f64 vs jax x64": (p64n, j64["jax_x64"])}
        if args.perturb:
            p64p = port_step(cfg, s1, noise64,
                                [x * (1 + args.perturb)
                                 for x in f64_tree(b2)], torch.float64)
            pairs["port f64 perturbed"] = (p64p, p64n)
            pairs["jax x64 perturbed"] = (j64["jax_x64_perturbed"],
                                          j64["jax_x64"])
        z = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (B * T + B, DZC + cfg.dim_z_category + DZM)))
        flips, n = relu_flips(cfg, s1, z)
        print(f"== {args.config} seed {seed}: {flips} of {n} trunk ReLU "
              "inputs change sign between float32 and float64")
        for net in bridge.NETS:
            for label, (a, b) in pairs.items():
                pa = parts(a[net] if isinstance(a, dict) else
                           net_dict(getattr(a, net)))
                pb = parts(b[net] if isinstance(b, dict) else
                           net_dict(getattr(b, net)))
                ds = {k: distance(pa[k], pb[k]) for k in PARTS}
                worst = (f"  (mu worst at {ds['mu'][1]})" if net == "gen"
                         else "")
                print(f"  {net:8s} {label:20s} " + "  ".join(
                    f"{k} {ds[k][0]:.2e}" for k in PARTS) + worst)
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
