"""The port's ``GANTrainer`` held against the JAX ``GANTrainer`` on the CPU.

A tiny trainer (``ode`` motion, ``mnist28`` trunk, ngf = ndf = 4, B = 2,
T = 6, ``PatchImageDiscriminator`` and ``VideoDiscriminator(ksize=2)``,
d_iters = 2) is built on both sides. The JAX side takes one step from its
init, so the Adam moments are non-zero, and that state is carried across
(``bridge.gan_state_to_torch``). From there each side runs one
``_d_update``, one ``_g_update`` and one whole ``train_step``; the noise the
JAX step drew is recorded (``torch_parity.record_noise``) and fed to the port
as its noise tape.

Tolerances: losses rtol 1e-5; gradients, updated parameters, BatchNorm
running statistics and Adam moments rtol 1e-4 with an absolute floor of 1e-5
(1e-4 for the second moments, squares of gradients) times the leaf's largest
magnitude, for the elements of sums that cancel to near zero. Both sides run
float32 (JAX with x64 off).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganode_tpu.models import PatchImageDiscriminator as JaxPatchImage
from ganode_tpu.models import VideoDiscriminator as JaxVideoD
from ganode_tpu.models import make_generator as jax_make_generator
from ganode_tpu.train import GANTrainer as JaxTrainer
from ganode_tpu.train import bce_logits as jax_bce
from ganode_tpu_torch import bridge
from ganode_tpu_torch.models import (PatchImageDiscriminator,
                                     VideoDiscriminator, make_generator)
from ganode_tpu_torch.train import GANTrainer
from torch_parity import assert_close_tree, np_tree, record_noise, to_torch, uniform

B, T, NGF, NDF, DZC, DZM = 2, 6, 4, 4, 10, 4
LOSS_RTOL = 1e-5
RTOL, FLOOR, FLOOR_NU = 1e-4, 1e-5, 1e-4


def _jax_trainer():
    gen = jax_make_generator("ode", n_channels=1, trunk="mnist28",
                             video_length=T, dim_z_content=DZC,
                             dim_z_motion=DZM, ngf=NGF)
    return JaxTrainer(gen=gen, dis_img=JaxPatchImage(ndf=NDF),
                      dis_vid=JaxVideoD(ksize=2, ndf=NDF), batch_size=B,
                      d_iters=2)


def _port_trainer():
    gen = make_generator("ode", n_channels=1, trunk="mnist28", video_length=T,
                         dim_z_content=DZC, dim_z_motion=DZM, ngf=NGF,
                         device="cpu")
    tr = GANTrainer(gen=gen,
                    dis_img=PatchImageDiscriminator(n_channels=1, ndf=NDF),
                    dis_vid=VideoDiscriminator(n_channels=1, ndf=NDF, ksize=2),
                    batch_size=B, d_iters=2)
    return tr, tr.init_state()


def _batches(seed):
    rng = np.random.default_rng(seed)
    return uniform(rng, 2, B, 28, 28, 1), uniform(rng, 2, B, T, 28, 28, 1)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side, computed once: the carried-across state (after one
    step), then from it a D update, a G update and a whole step, each with
    the noise it drew."""
    tr = _jax_trainer()
    out = {}
    with jax.enable_x64(False):
        state0 = jax.jit(tr.init_state)(jax.random.PRNGKey(0))
        step = jax.jit(tr.train_step)
        images, videos = _batches(1)
        state1, _ = step(state0, images, videos, jax.random.PRNGKey(1))
        state1 = jax.block_until_ready(state1)
    out["state1"] = np_tree(state1)
    images, videos = _batches(2)
    out["batches"] = images, videos
    # a fresh trace, so that the recorder's callbacks are compiled in
    (state2, metrics), rec = record_noise(
        jax.jit(lambda *a: tr.train_step(*a)), state1, images, videos,
        jax.random.PRNGKey(2))
    out["step"] = np_tree(state2), np_tree(metrics), rec.samples(B, T, DZC)
    (g_state, g_loss), rec = record_noise(
        jax.jit(tr._g_update), state1, jax.random.PRNGKey(3))
    out["g"] = np_tree(g_state), float(g_loss), rec.samples(B, T, DZC)
    real, fake = images[0], uniform(np.random.default_rng(4), B, 28, 28, 1)
    with jax.enable_x64(False):
        new_di, d_loss, _ = jax.jit(
            lambda s, r, f, k: tr._d_update(tr.dis_img, s, r, f, k))(
            state1.dis_img, real, fake, jax.random.PRNGKey(5))

        def d_loss_fn(params):
            variables = {"params": params,
                         "batch_stats": state1.dis_img.batch_stats}
            (pr, _), mut = tr.dis_img.apply(variables, real,
                                            mutable=["batch_stats"])
            (pf, _), _ = tr.dis_img.apply(
                {"params": params, **mut}, fake, mutable=["batch_stats"])
            return jax_bce(pr, 1.0) + jax_bce(pf, 0.0)

        d_grads = jax.jit(jax.grad(d_loss_fn))(state1.dis_img.params)
    out["d"] = (real, fake, np_tree(new_di), float(d_loss), np_tree(d_grads))
    return out


def _port_from(state1):
    tr, state = _port_trainer()
    bridge.gan_state_to_torch(state1, state)
    return tr, state


def _net_dict(net):
    """A flax NetState in the bridge's nested-dict form."""
    adam = bridge._adam_state(net.opt_state)
    return {"params": net.params, "batch_stats": net.batch_stats,
            "opt_state": {"count": adam.count, "mu": adam.mu, "nu": adam.nu}}


def _as_jax_dict(jax_state):
    return {name: _net_dict(getattr(jax_state, name)) for name in bridge.NETS}


def _assert_net(got, want, name, what=("params", "batch_stats", "opt_state")):
    if "params" in what:
        assert_close_tree(got["params"], want["params"], RTOL, FLOOR,
                          f"{name}/params")
    if "batch_stats" in what:
        assert_close_tree(got["batch_stats"], want["batch_stats"], RTOL,
                          FLOOR, f"{name}/batch_stats")
    if "opt_state" in what:
        assert int(got["opt_state"]["count"]) == int(want["opt_state"]["count"])
        assert_close_tree(got["opt_state"]["mu"], want["opt_state"]["mu"],
                          RTOL, FLOOR, f"{name}/mu")
        assert_close_tree(got["opt_state"]["nu"], want["opt_state"]["nu"],
                          RTOL, FLOOR_NU, f"{name}/nu")


def test_carried_state_is_mid_training(jax_run):
    """The starting point has taken a step: non-zero moments, one Adam step
    of G and d_iters = 2 of each D."""
    s1 = jax_run["state1"]
    assert int(s1.step) == 1
    for name, count in zip(bridge.NETS, (1, 2, 2)):
        adam = bridge._adam_state(getattr(s1, name).opt_state)
        assert int(adam.count) == count
        assert all(np.abs(a).max() > 0 for a in jax.tree_util.tree_leaves(adam.mu))


def test_d_update_matches_jax(jax_run):
    real, fake, want_net, want_loss, want_grads = jax_run["d"]
    tr, state = _port_from(jax_run["state1"])
    real_t, fake_t = torch.from_numpy(real), torch.from_numpy(fake)
    # gradients of the same loss on the carried-across weights; the BN
    # statistics this pass moves are restored before the update
    mod = state.dis_img.module
    stats = {k: v.clone() for k, v in mod.state_dict().items()}
    mod.train()
    loss = tr.d_loss_fn(mod(real_t)[0], mod(fake_t)[0])
    grads = dict(zip([k for k, _ in mod.named_parameters()],
                     torch.autograd.grad(loss, list(mod.parameters()))))
    assert_close_tree(bridge.torch_to_jax(grads)["params"], want_grads, RTOL,
                      FLOOR, "d grads")
    mod.load_state_dict(stats)
    got_loss, _ = tr._d_update(state.dis_img, real_t, fake_t, None)
    np.testing.assert_allclose(float(got_loss), want_loss, rtol=LOSS_RTOL)
    got = bridge.torch_gan_state_to_jax(state)["dis_img"]
    _assert_net(got, _net_dict(want_net), "dis_img")


def test_g_update_matches_jax(jax_run):
    want_state, want_loss, noise = jax_run["g"]
    assert len(noise) == 2 and "frame_idx" in noise[1]
    tr, state = _port_from(jax_run["state1"])
    vid, img = to_torch(noise)
    got_loss = tr._g_update(state, vid, img, None)
    np.testing.assert_allclose(float(got_loss), want_loss, rtol=LOSS_RTOL)
    got, want = bridge.torch_gan_state_to_jax(state), _as_jax_dict(want_state)
    _assert_net(got["gen"], want["gen"], "gen")
    # the G update moves the discriminators' statistics, not their weights
    for name in ("dis_img", "dis_vid"):
        _assert_net(got[name], want[name], name, ("params", "batch_stats"))
    assert all(p.grad is None for n in bridge.NETS
               for p in getattr(state, n).module.parameters())


def test_whole_train_step_matches_jax(jax_run):
    want_state, want_metrics, noise = jax_run["step"]
    assert len(noise) == 6
    assert ["frame_idx" in d for d in noise] == [True, False] * 2 + [False, True]
    images, videos = jax_run["batches"]
    tr, state = _port_from(jax_run["state1"])
    metrics = tr.train_step(state, torch.from_numpy(images),
                            torch.from_numpy(videos), noise=to_torch(noise))
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    got, want = bridge.torch_gan_state_to_jax(state), _as_jax_dict(want_state)
    assert got["step"] == int(want_state.step) == 2
    for name in bridge.NETS:
        _assert_net(got[name], want[name], name)


def test_state_round_trips_through_the_bridge(jax_run):
    s1 = jax_run["state1"]
    _, state = _port_from(s1)
    back = bridge.torch_gan_state_to_jax(state)
    want = _as_jax_dict(s1)
    for name in bridge.NETS:
        for part in ("params", "batch_stats"):
            assert_close_tree(back[name][part], want[name][part], 0.0, 0.0,
                              f"{name}/{part}")
        for part in ("mu", "nu"):
            assert_close_tree(back[name]["opt_state"][part],
                              want[name]["opt_state"][part], 0.0, 0.0,
                              f"{name}/{part}")
        assert back[name]["opt_state"]["count"] == (1 if name == "gen" else 2)
    assert back["step"] == 1 and back["ema_params"] is None
