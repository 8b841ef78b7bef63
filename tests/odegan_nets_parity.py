"""Helpers of the stage-2 nets' parity tests (``test_torch_odegan_nets.py``,
MLP; ``test_torch_odegan_dcgan.py``, DCGAN): the port's
``ganode_tpu_torch.train_odegan`` against flax twins of
``scripts/train_odegan.py``'s nets and steps, on the CPU.

The script's nets are classes local to its ``main()``, so the twins below
are copied literally from ``scripts/train_odegan.py:59-96``, and its losses
from :139-150. Weights cross through the bridge (Dense ``weight.T``, Conv
``(Co, Ci, kh, kw)``, ConvTranspose also flipped, GroupNorm ``scale`` ->
``weight``). The draws are JAX's own: a loss called with key ``k`` draws
``z = normal(fold_in(k, 1))`` (G) or ``fold_in(k, 2)`` (D), and the trainer
calls stage ``s`` with ``fold_in(key, s)`` and the penalty's G loss with
``fold_in(key, 99)``; the port takes those ``z`` as its noise.

Tolerances: the forward passes in float64 (the float32 init cast up) at
rtol 1e-5, atol 1e-6, and in float32 at rtol 1e-5, atol ``FLOAT32_ATOL``;
the parameters after one discriminator step (with the penalty) and one
generator step of each method, and of the Adam baseline, in float64 on
both sides (JAX under x64), rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from flax import linen as nn

from ganode_tpu.train import ODEGANTrainer as JaxTrainer
from ganode_tpu.train import bce_logits
from ganode_tpu_torch import bridge
from ganode_tpu_torch.train import ODEGANTrainer, reference_adam
from ganode_tpu_torch.train_odegan import (ARCHS, adam_update, build_nets,
                                           make_losses)
from torch_parity import f64_tree

B = 4
# float32 forwards: rounding, measured up to 1.0e-6 abs on one element of
# the DCGAN generator's 12,288 (three transposed convs and two GroupNorms)
FLOAT32_ATOL = 2e-6
METHODS = ("euler", "rk2", "rk4", "adam")
STAGES = {"euler": 1, "rk2": 2, "rk4": 4}


# --- copied from scripts/train_odegan.py:59-96 ------------------------------
class MLPGen(nn.Module):
    @nn.compact
    def __call__(self, z):
        for w in (256, 512, 1024):
            z = nn.leaky_relu(nn.Dense(w)(z), 0.2)
        return jnp.tanh(nn.Dense(784)(z))

class MLPDisc(nn.Module):
    @nn.compact
    def __call__(self, x):
        for w in (512, 256):
            x = nn.leaky_relu(nn.Dense(w)(x), 0.2)
        return nn.Dense(1)(x).squeeze(-1)

class DCGANGen(nn.Module):
    """32x32x3 conv generator (the CIFAR notebook's stage-2 G)."""

    @nn.compact
    def __call__(self, z):
        h = nn.Dense(4 * 4 * 256)(z).reshape(-1, 4, 4, 256)
        # torch ConvTranspose(k=4, s=2, p=1) doubling == flax padding (2, 2)
        for feats in (128, 64):
            h = nn.relu(nn.GroupNorm(num_groups=8)(
                nn.ConvTranspose(feats, (4, 4), strides=(2, 2),
                                 padding=((2, 2), (2, 2)))(h)))
        h = nn.ConvTranspose(3, (4, 4), strides=(2, 2),
                             padding=((2, 2), (2, 2)))(h)
        return jnp.tanh(h)

class DCGANDisc(nn.Module):
    @nn.compact
    def __call__(self, x):
        h = x
        for feats in (64, 128, 256):
            h = nn.leaky_relu(
                nn.Conv(feats, (4, 4), strides=(2, 2),
                        padding=((1, 1), (1, 1)))(h), 0.2)
        return nn.Dense(1)(h.reshape(h.shape[0], -1)).squeeze(-1)
# ------------------------------------------------------------------------------

FLAX = {"mlp": (MLPGen(), MLPDisc()), "dcgan": (DCGANGen(), DCGANDisc())}


def jax_losses(gen, disc):
    """scripts/train_odegan.py:139-150."""
    def g_loss(params, key_, batch):
        z = jax.random.normal(jax.random.fold_in(key_, 1), (B, 100))
        fake = gen.apply({"params": params["gen"]}, z)
        logits = disc.apply({"params": params["dis_img"]}, fake)
        return bce_logits(logits, 1.0)

    def d_loss(params, key_, batch):
        z = jax.random.normal(jax.random.fold_in(key_, 2), (B, 100))
        fake = gen.apply({"params": params["gen"]}, z)
        pf = disc.apply({"params": params["dis_img"]}, fake)
        pr = disc.apply({"params": params["dis_img"]}, batch)
        return bce_logits(pr, 1.0) + bce_logits(pf, 0.0)
    return g_loss, d_loss


def z_of(key, stage, which):
    """The z that loss ``which`` (1: G, 2: D) draws at trainer stage
    ``stage`` (None: called with ``key`` itself), under x64."""
    k = key if stage is None else jax.random.fold_in(key, stage)
    z = jax.random.normal(jax.random.fold_in(k, which), (B, 100))
    return {"z": torch.from_numpy(np.array(z))}


def port_noise(method, key, which):
    noise = {s: z_of(key, s, which) for s in range(STAGES[method])}
    if which == 2:
        noise["penalty"] = z_of(key, 99, 1)
    return noise


def jax_run(arch):
    """The JAX side for ``arch``: its float32 init, a forward of each net
    in float64 (the init cast up) and in float32, then from the float64
    params one D step and one G step of each method (and Adam); with the
    port's noise for each."""
    gen, disc = FLAX[arch]
    shape = ARCHS[arch][2]
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(1)
    z = rng.standard_normal((B, 100)).astype(np.float32)
    real = rng.uniform(-1, 1, (B,) + shape)
    with jax.enable_x64(False):
        g_params = jax.jit(gen.init)(key, jnp.zeros((1, 100)))["params"]
        d_params = jax.jit(disc.init)(jax.random.fold_in(key, 1),
                                      jnp.zeros((1,) + shape))["params"]
        fwd32 = (np.asarray(gen.apply({"params": g_params}, z)),
                 np.asarray(disc.apply({"params": d_params},
                                       real.astype(np.float32))))
    params = {"gen": f64_tree(g_params), "dis_img": f64_tree(d_params),
              "dis_vid": None}
    with jax.enable_x64(True):
        fwd64 = (np.asarray(gen.apply({"params": params["gen"]},
                                      z.astype(np.float64))),
                 np.asarray(disc.apply({"params": params["dis_img"]}, real)))
    g_loss, d_loss = jax_losses(gen, disc)
    kd, kg = jax.random.PRNGKey(5), jax.random.PRNGKey(6)
    steps = {}
    with jax.enable_x64(True):
        for method in METHODS:
            if method == "adam":
                tx = optax.adam(2e-4, b1=0.5, b2=0.999)

                def both(p, b, tx=tx):
                    for net, loss, k, bb in (("dis_img", d_loss, kd, b),
                                             ("gen", g_loss, kg, None)):
                        grads = jax.grad(lambda q: loss({**p, net: q}, k, bb))(
                            p[net])
                        upd, _ = tx.update(grads, tx.init(p[net]))
                        p = {**p, net: optax.apply_updates(p[net], upd)}
                    return p
            else:
                tr = JaxTrainer(g_loss=g_loss, d_img_loss=d_loss, lr=0.02,
                                reg=0.01, method=method)

                def both(p, b, tr=tr):
                    p = tr.step(p, kd, b, model="dis_img")
                    return tr.step(p, kg, model="gen")
            # XLA's default options: float64 convolutions run ~30x slower
            # without its backend optimisations
            compiled = jax.jit(both).lower(params, real).compile()
            steps[method] = jax.tree_util.tree_map(
                np.asarray, compiled(params, real))
        noise = {m: (port_noise(m, kd, 2), port_noise(m, kg, 1))
                 for m in STAGES}
        noise["adam"] = (z_of(kd, None, 2), z_of(kg, None, 1))
    return (arch, {"gen": g_params, "dis_img": d_params}, z, real,
            (fwd64, fwd32), params, steps, noise)


def _port(arch, params, dtype):
    gen, disc, _ = build_nets(arch, 0, "cpu")
    mods = {"gen": gen.to(dtype), "dis_img": disc.to(dtype)}
    return mods, bridge.odegan_params_to_torch(params, mods)


def check_forward(jax_run):
    arch, params, z, real = jax_run[:4]
    for dtype in (torch.float64, torch.float32):
        mods, p = _port(arch, jax.tree_util.tree_map(np.asarray, params),
                        dtype)
        with torch.no_grad():
            got_g = torch.func.functional_call(
                mods["gen"], p["gen"], (torch.from_numpy(z).to(dtype),))
            got_d = torch.func.functional_call(
                mods["dis_img"], p["dis_img"],
                (torch.from_numpy(real).to(dtype),))
        want_g, want_d = jax_run[4][dtype == torch.float32]
        atol = 1e-6 if dtype == torch.float64 else FLOAT32_ATOL
        np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-5, atol=atol)
        np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-5, atol=atol)
    # and the bridge takes the params back unchanged
    back = bridge.odegan_params_to_jax({**p, "dis_vid": None})
    for net in ("gen", "dis_img"):
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(back[net]),
                jax.tree_util.tree_leaves_with_path(params[net])):
            np.testing.assert_array_equal(a, np.asarray(b), str(path))


def check_step(jax_run, method):
    arch, params, real = jax_run[0], jax_run[5], jax_run[3]
    want, (d_noise, g_noise) = jax_run[6][method], jax_run[7][method]
    mods, p = _port(arch, params, torch.float64)
    g_loss, d_loss = make_losses(mods["gen"], mods["dis_img"], B)
    batch = torch.from_numpy(real)
    if method == "adam":
        for net, loss, noise, b in (("dis_img", d_loss, d_noise, batch),
                                    ("gen", g_loss, g_noise, None)):
            opt = reference_adam(list(p[net].values()), lr=2e-4, b1=0.5,
                                 b2=0.999, weight_decay=0.0)
            adam_update(opt, p, net, loss, noise, b)
    else:
        tr = ODEGANTrainer(g_loss=g_loss, d_img_loss=d_loss, lr=0.02,
                           reg=0.01, method=method)
        p = tr.step(p, d_noise, batch, model="dis_img")
        p = tr.step(p, g_noise, model="gen")
    got = bridge.odegan_params_to_jax(p)
    for net in ("gen", "dis_img"):
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(got[net]),
                jax.tree_util.tree_leaves_with_path(want[net])):
            np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=f"{net}{path}")
