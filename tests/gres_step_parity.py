"""Helpers of the ``ucf_gres`` / ``ucf_odegres`` training-step parity tests
(``test_torch_gres_step.py``, ``test_torch_odegres_step.py``), which hold
one step of the port against the JAX step on the CPU at tiny widths: one
config per file, so the two JAX compiles run on two test workers.

The trainers are the configs' (``gres64`` / ``odegres64`` trunk with rk4
motion, ``SNImageDiscriminator``, ``SNVideoDiscriminator(ksize=4)``, hinge
loss) at ngf = ndf = 4, B = 2, T = 16, d_iters = 1. As in
``test_torch_wgan_step.py``, the JAX side takes one step from its init
(Adam moments non-zero, every ``u`` moved) and that state is carried across
by the bridge (the generator's ``spectral`` collection now included: the
blocks' ``SNConv`` ``u``, the ODE blocks' ``u0``/``u1``); then each side
takes one whole ``train_step`` on the noise the JAX step drew.

The generator's spectral state advances once per train-mode sample, in the
D updates too (``ganode_tpu/train/gan.py:177-188``): 2 * d_iters + 2 = 4
times per step here, counted on the port's side and held to JAX's values.

Both sides run float64: JAX under x64 from its float32 init cast up (its
trainer still draws the noise in float32 and casts the trunk's frames and
the critics' logits to float32, as it does under x64), the port with its
nets in float64 and the plain rk4 motion (K1's wrapper takes float32 only).
In float32 this step is not comparable element by element, on either side
(``gres_float32_drift.py``, 7 seeds of ``ucf_gres`` and 6 of
``ucf_odegres``; the float64 reference is the port's float64 step on the
float32 run's noise): 1-6 of the ~2.1e6 ``gres64`` trunk's ReLU inputs per
call (5-9 of ~9.4e6 in ``odegres64``) change sign between float32 and
float64, each switching its element's gradient on or off, so the
generator's Adam moments land up to 3.8e-2 of their largest magnitude from
float64 in JAX's own float32 step and up to 1.9e-2 in the port's (the
largest in ``Dense_0`` on every seed; the critics' up to 3.4e-3 and
2.5e-3); and Adam turns the rounding noise of exactly-zero gradients (the
bias of every conv that feeds a batch-statistics norm) into parameter
steps of up to ``lr`` in either direction (1.5e-4 to 3.5e-4 of the largest
parameter on both sides). In float64 the two steps agree to 1.2e-7 of each
part's scale on 12 of those 13 seeds; on ``ucf_odegres`` seed 0 the
generator's ``Dense_0`` moments differ by 3.9e-4 (every other leaf within
2e-6): flax's BatchNorm variance is one-pass, ``E[x^2] - E[x]^2``, the
port's two-pass; with JAX's made two-pass too (``gres_float32_drift.py
--two-pass-variance``) the two agree to 5.4e-8 there.

Tolerances: losses rtol 1e-4; every part of every net (parameters,
BatchNorm statistics, every ``u``, both Adam moments) rtol 1e-4 with an
absolute floor of 1e-5 times the part's largest magnitude over the whole net
(the zero-gradient leaves are noise at the net's scale, not their own).
Measured on ``ucf_gres``: losses 1.6e-7, every part within 1e-7 of its
net's scale. That is tighter than ``test_torch_wgan_step.py``'s bars, which
hold its float32 generator to a quarter of an Adam step per element.
"""
import jax
import numpy as np
import torch
from flax import linen as nn

from ganode_tpu.models import SNImageDiscriminator as JaxSNImage
from ganode_tpu.models import SNVideoDiscriminator as JaxSNVideo
from ganode_tpu.models import make_generator as jax_make_generator
from ganode_tpu.train import GANTrainer as JaxTrainer
import ganode_tpu_torch.models.motion as motion_mod
from ganode_tpu_torch import bridge
from ganode_tpu_torch.models import (SNImageDiscriminator,
                                     SNVideoDiscriminator, make_generator)
from ganode_tpu_torch.nn import ODEGResBlock, SNConv
from ganode_tpu_torch.ops import reference_rk4_motion
from ganode_tpu_torch.train import GANTrainer
from ganode_tpu_torch.utils.config import get_config
from torch_parity import (FAST_COMPILE, NoiseRecorder, assert_close_part,
                          assert_close_tree, f64_tree, net_dict, rgb_batches,
                          to_torch)

B, T, NGF, NDF, DZC, DZM, S = 2, 16, 4, 4, 10, 4, 64
LOSS_RTOL = 1e-4
RTOL, FLOOR = 1e-4, 1e-5


def _common(cfg):
    return dict(batch_size=B, d_iters=1, loss=cfg.loss)


def _jax_trainer(cfg):
    gen = jax_make_generator("ode", n_channels=3, trunk=cfg.trunk,
                             video_length=T, dim_z_content=DZC,
                             dim_z_motion=DZM, ngf=NGF)
    return JaxTrainer(gen=gen, dis_img=JaxSNImage(ndf=NDF),
                      dis_vid=JaxSNVideo(ksize=cfg.video_disc_ksize, ndf=NDF),
                      **_common(cfg))


def _port_trainer(cfg):
    gen = make_generator("ode", n_channels=3, trunk=cfg.trunk, video_length=T,
                         dim_z_content=DZC, dim_z_motion=DZM, ngf=NGF,
                         device="cpu")
    tr = GANTrainer(gen=gen,
                    dis_img=SNImageDiscriminator(n_channels=3, ndf=NDF),
                    dis_vid=SNVideoDiscriminator(
                        n_channels=3, ndf=NDF, ksize=cfg.video_disc_ksize),
                    **_common(cfg))
    return tr, tr.init_state()


def jax_steps(name):
    """Two float64 JAX steps (x64, the float32 init cast up) through one
    compiled function with the recorder on: the first makes the
    carried-across state, the second is the step under test -> (config,
    state1, state2, metrics2, its noise tape, batches)."""
    cfg = get_config(name)
    tr = _jax_trainer(cfg)
    batches = [f64_tree(rgb_batches(1, B, T, S)),
               f64_tree(rgb_batches(2, B, T, S))]
    rec = NoiseRecorder()
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(False):
        init = jax.jit(tr.init_state).lower(key).compile(
            compiler_options=FAST_COMPILE)
        state0 = f64_tree(init(key))
    with jax.enable_x64(True), nn.intercept_methods(rec):
        step = jax.jit(tr.train_step)
        state1, _ = jax.block_until_ready(
            step(state0, *batches[0], jax.random.PRNGKey(1)))
        jax.effects_barrier()
        rec.log.clear()
        state2, metrics = jax.block_until_ready(
            step(state1, *batches[1], jax.random.PRNGKey(2)))
        jax.effects_barrier()
    noise = rec.samples(B, T, DZC)
    assert len(noise) == 4
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return (cfg, as_np(state1), as_np(state2), as_np(metrics), noise,
            batches[1])


def _port_from(cfg, state1, monkeypatch):
    """The port's trainer in float64 with the carried-across state; the
    motion through the plain rk4 (K1's wrapper takes float32 only)."""
    monkeypatch.setattr(motion_mod, "fused_rk4_motion", reference_rk4_motion)
    tr, state = _port_trainer(cfg)
    for name in bridge.NETS:
        getattr(state, name).module.double()
    bridge.gan_state_to_torch(state1, state)
    return tr, state


def _assert_net(got, want, name):
    for part in ("params", "batch_stats", "spectral"):
        if want[part]:
            assert_close_part(got[part], want[part], RTOL, FLOOR,
                              f"{name}/{part}")
    assert int(got["opt_state"]["count"]) == int(want["opt_state"]["count"])
    for m in ("mu", "nu"):
        assert_close_part(got["opt_state"][m], want["opt_state"][m], RTOL,
                          FLOOR, f"{name}/{m}")


def _advance_counter(gen):
    """Counts the generator's train-mode block forwards: each advances the
    block's spectral state once (forward pre-hooks on every block)."""
    count = {"n": 0}
    blocks = [getattr(gen.main, f"block_{i}") for i in range(4)]

    def hook(module, args):
        count["n"] += module.training
    for b in blocks:
        b.register_forward_pre_hook(hook)
    return count, len(blocks)


def check_train_step(jax_run, monkeypatch):
    cfg, state1, want_state, want_metrics, noise, (images, videos) = jax_run
    tr, state = _port_from(cfg, state1, monkeypatch)
    count, n_blocks = _advance_counter(tr.gen)
    u_before = {k: v.clone() for k, v in tr.gen.state_dict().items()
                if k.split(".")[-1] in ("u", "u0", "u1")}
    tape = [{k: v.double() if v.is_floating_point() else v
             for k, v in d.items()} for d in to_torch(noise)]
    metrics = tr.train_step(state, torch.from_numpy(images),
                            torch.from_numpy(videos), noise=tape)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    got = bridge.torch_gan_state_to_jax(state)
    assert got["step"] == int(want_state.step) == 2
    for name in bridge.NETS:
        _assert_net(got[name], net_dict(getattr(want_state, name)), name)
    # every block advanced its state once per train-mode sample: 4 samples
    assert count["n"] == (2 * tr.d_iters + 2) * n_blocks
    moved = [k for k, v in tr.gen.state_dict().items()
             if k in u_before and not torch.equal(v, u_before[k])]
    assert sorted(moved) == sorted(k for k, v in u_before.items()
                                   if v.numel() > 1)
    odes = [m for m in tr.gen.modules() if isinstance(m, ODEGResBlock)]
    assert len(odes) == (4 if cfg.trunk == "odegres64" else 0)
    assert all(p.grad is None for n in bridge.NETS
               for p in getattr(state, n).module.parameters())


def check_round_trip(jax_run, monkeypatch):
    cfg, state1 = jax_run[0], jax_run[1]
    _, state = _port_from(cfg, state1, monkeypatch)
    back = bridge.torch_gan_state_to_jax(state)["gen"]
    want = net_dict(state1.gen)
    for part in ("params", "batch_stats", "spectral", "opt_state"):
        assert_close_tree(back[part], want[part], 0.0, 0.0, f"gen/{part}")
    spectral = back["spectral"]["main"]
    if cfg.trunk == "odegres64":
        assert sorted(spectral["block_0"]) == ["u0", "u1"]
        assert sorted(spectral["block_1"]) == ["proj_down", "u0", "u1"]
    else:
        assert sorted(spectral["block_0"]) == ["SNConv_0", "SNConv_1",
                                               "SNConv_2"]
    n_sn = sum(isinstance(m, SNConv) for m in state.gen.module.modules())
    assert n_sn == (4 if cfg.trunk == "odegres64" else 13)
