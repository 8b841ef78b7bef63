"""Helpers of the ODE-GAN MoCoGAN parity tests (``test_torch_odegan_
mocogan.py``, ``test_torch_odegan_methods.py``): the JAX package's
integration problem (``tests/test_odegan.py::TestMoCoGANIntegration``:
``ode`` motion, ``mnist28`` trunk, ngf = ndf = 8, B = 2, T = 8,
``PatchImageDiscriminator``, ``VideoDiscriminator(ksize=2)``, BCE,
lr = 0.01, reg = 0.01) built on both sides, in float64.

JAX runs under x64 from its float32 init cast up, with running statistics
drawn from a seed (eval-mode BatchNorm on the init's zeros and ones would
not show which statistics a side uses). Each JAX step is compiled once with
the noise recorder on (``torch_parity.NoiseRecorder``): a step's samples in
program order are the penalty's video and image (a discriminator step
with ``reg > 0``), then stage 0-3's, as ``ODEGANTrainer._sub_step`` runs
them. The port takes the same draws as its noise dict, with its nets in
float64 and the plain rk4 motion (K1's wrapper takes float32 only).

Tolerances: each net's parameters after a step rtol 1e-4 with an absolute
floor of 1e-5 times the part's largest magnitude (``assert_close_part``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as nn

from ganode_tpu.models import PatchImageDiscriminator as JaxPatchImage
from ganode_tpu.models import VideoDiscriminator as JaxVideoD
from ganode_tpu.models import make_generator as jax_make_generator
from ganode_tpu.train import ODEGANTrainer as JaxTrainer
from ganode_tpu.train import make_mocogan_losses as jax_losses
import ganode_tpu_torch.models.motion as motion_mod
from ganode_tpu_torch import bridge
from ganode_tpu_torch.models import (PatchImageDiscriminator,
                                     VideoDiscriminator, make_generator)
from ganode_tpu_torch.ops import reference_rk4_motion
from ganode_tpu_torch.train import make_mocogan_losses
from torch_parity import (FAST_COMPILE, NoiseRecorder, assert_close_part,
                          f64_tree, to_torch)

B, T, NGF, NDF, DZC, DZM, S = 2, 8, 8, 8, 8, 4, 28
LR, REG = 0.01, 0.01
RTOL, FLOOR = 1e-4, 1e-5
NETS = ("gen", "dis_img", "dis_vid")


def _with_stats(variables, seed):
    """The variables with every BatchNorm's running mean ~ 0.1 N(0, 1) and
    variance ~ U(0.5, 1.5), drawn from ``seed``."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if name == "mean":
            return 0.1 * rng.standard_normal(a.shape)
        return rng.uniform(0.5, 1.5, a.shape)
    stats = jax.tree_util.tree_map_with_path(draw, variables["batch_stats"])
    return {**variables, "batch_stats": stats}


def jax_problem():
    """-> (the JAX modules, their float64 variables by net, real images
    ``(B, S, S, 1)`` and videos ``(B, T, S, S, 1)``)."""
    mods = {"gen": jax_make_generator("ode", n_channels=1, trunk="mnist28",
                                      ngf=NGF, dim_z_content=DZC,
                                      dim_z_motion=DZM, video_length=T),
            "dis_img": JaxPatchImage(ndf=NDF),
            "dis_vid": JaxVideoD(ksize=2, ndf=NDF)}
    k = jax.random.PRNGKey(0)
    with jax.enable_x64(False):
        init = {"gen": jax.jit(lambda: mods["gen"].init(
                    {"params": k, "sample": k}, B)),
                "dis_img": jax.jit(lambda: mods["dis_img"].init(
                    k, jnp.zeros((B, S, S, 1)))),
                "dis_vid": jax.jit(lambda: mods["dis_vid"].init(
                    k, jnp.zeros((B, T, S, S, 1))))}
        variables = {n: f64_tree(f()) for n, f in init.items()}
    variables = {n: _with_stats(v, i) for i, (n, v) in
                 enumerate(variables.items())}
    rng = np.random.RandomState(0)
    real = (rng.uniform(-1, 1, (B, S, S, 1)),
            rng.uniform(-1, 1, (B, T, S, S, 1)))
    return mods, variables, real


def jax_trainer(mods, variables, method):
    losses = jax_losses(mods["gen"], mods["dis_img"], mods["dis_vid"],
                        *(variables[n]["batch_stats"] for n in NETS),
                        batch_size=B)
    return JaxTrainer(*losses, lr=LR, reg=REG, method=method)


def jax_step(trainer, params, seed, batch, model):
    """One JAX step, compiled with the recorder on -> (the new params with
    numpy leaves, the noise of each sample in order)."""
    rec = NoiseRecorder()
    key = jax.random.PRNGKey(seed)
    with jax.enable_x64(True), nn.intercept_methods(rec):
        step = jax.jit(lambda p, k, b: trainer.step(p, k, b, model=model))
        compiled = step.lower(params, key, batch).compile(
            compiler_options=FAST_COMPILE)
        out = jax.block_until_ready(compiled(params, key, batch))
        jax.effects_barrier()
    return jax.tree_util.tree_map(np.asarray, out), rec.samples(B, T, DZC)


def noise_dict(samples, model, penalty: bool):
    """The recorded samples in order -> the port's noise dict: the
    penalty's video and image, then each stage's (a G stage: a video and an
    image; a D stage: its own kind)."""
    tape = [{k: v.double() if v.is_floating_point() else v
             for k, v in d.items()} for d in to_torch(samples)]
    it = iter(tape)
    noise = {}
    if penalty:
        noise["penalty"] = {"videos": next(it), "images": next(it)}
    per_stage = {"gen": ("videos", "images"), "dis_img": ("images",),
                 "dis_vid": ("videos",)}[model]
    for stage in range(4):
        try:
            noise[stage] = {what: next(it) for what in per_stage}
        except StopIteration:
            break
    assert next(it, None) is None
    for d in noise.values():
        for what, draws in d.items():
            assert ("frame_idx" in draws) == (what == "images"), what
    return noise


def port_problem(variables, monkeypatch):
    """The port's triple in float64 with JAX's variables (its running
    statistics included), the plain rk4 motion -> (modules, losses)."""
    monkeypatch.setattr(motion_mod, "fused_rk4_motion", reference_rk4_motion)
    mods = {"gen": make_generator("ode", n_channels=1, trunk="mnist28",
                                  ngf=NGF, dim_z_content=DZC, dim_z_motion=DZM,
                                  video_length=T, device="cpu"),
            "dis_img": PatchImageDiscriminator(n_channels=1, ndf=NDF),
            "dis_vid": VideoDiscriminator(n_channels=1, ndf=NDF, ksize=2)}
    for n, m in mods.items():
        m.double().load_state_dict(bridge.jax_to_torch(variables[n]))
        m.train()   # the losses must run them in eval mode all the same
    losses = make_mocogan_losses(mods["gen"], mods["dis_img"], mods["dis_vid"],
                                 B)
    return mods, losses


def assert_params(got, want, nets=NETS):
    back = bridge.odegan_params_to_jax(got)
    for n in nets:
        assert_close_part(back[n], want[n], RTOL, FLOOR, n)


def changed(a, b) -> bool:
    return any(not torch.equal(a[k], b[k]) for k in a)
