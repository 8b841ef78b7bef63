"""The pieces of the port's training path held against the JAX package on the
CPU: losses, Adam, flax-semantics BatchNorm, the additive-noise layer, the
generator in train mode, the bridge over a whole ``GANState``, and the
trainer's assembly from a config.

Tolerances: rtol 1e-5, atol 1e-6 on losses, Adam and BatchNorm (a few float32
operations each); rtol 1e-4, atol 1e-5 on trunk outputs and statistics after
conv stacks (``tests/test_torch_models.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from ganode_tpu import ops as jops
from ganode_tpu.models import make_generator as jax_make_generator
from ganode_tpu.nn import layers as jl
from ganode_tpu.train import losses as jlosses
from ganode_tpu.train import reference_adam as jax_adam
from ganode_tpu.train.runner import build_trainer as jax_build_trainer
from ganode_tpu.utils import config as jax_config
from ganode_tpu_torch import bridge
from ganode_tpu_torch.models import make_generator
from ganode_tpu_torch.models import mocogan as tm
from ganode_tpu_torch.nn import BatchNorm, Noise
from ganode_tpu_torch.train import (LOSSES, GANTrainer, bce_logits,
                                    build_trainer, reference_adam)
from ganode_tpu_torch.train.gan import _add_param_noise
from ganode_tpu_torch.utils import config
from torch_parity import assert_close_tree, normal, np_tree, uniform

RTOL, ATOL = 1e-5, 1e-6
TRUNK_RTOL, TRUNK_ATOL = 1e-4, 1e-5


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_losses_and_their_gradients_match_jax(loss):
    rng = np.random.default_rng(0)
    pr, pf = 3 * normal(rng, 4, 3, 3), 3 * normal(rng, 4, 3, 3)
    jd, jg = jlosses.LOSSES[loss]
    td, tg = LOSSES[loss]
    want_d, (wr, wf) = jax.value_and_grad(jd, argnums=(0, 1))(pr, pf)
    want_g, wg = jax.value_and_grad(jg)(pf)
    tr, tf = (torch.from_numpy(a).requires_grad_() for a in (pr, pf))
    got_d = td(tr, tf)
    gr, gf = torch.autograd.grad(got_d, [tr, tf])
    tf2 = torch.from_numpy(pf).requires_grad_()
    got_g = tg(tf2)
    (gg,) = torch.autograd.grad(got_g, [tf2])
    np.testing.assert_allclose(got_d.item(), float(want_d), rtol=RTOL)
    np.testing.assert_allclose(got_g.item(), float(want_g), rtol=RTOL)
    for got, want in ((gr, wr), (gf, wf), (gg, wg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_bce_logits_is_torch_bce_and_stable():
    x = torch.tensor([-200.0, -3.0, 0.0, 0.5, 200.0])
    for target in (0.0, 1.0):
        want = torch.nn.BCEWithLogitsLoss()(x, torch.full_like(x, target))
        torch.testing.assert_close(bce_logits(x, target), want)
    assert torch.isfinite(bce_logits(torch.tensor([1e4, -1e4]), 1.0))


# -------------------------------------------------------------------- Adam
def test_adam_matches_reference_adam_over_three_steps():
    """torch.optim.Adam with additive decay against optax's
    chain(add_decayed_weights, adam), the same gradients each step."""
    rng = np.random.default_rng(1)
    params = {"a": normal(rng, 5, 3), "b": 0.1 * normal(rng, 7)}
    grads = [{k: normal(rng, *v.shape) for k, v in params.items()}
             for _ in range(3)]
    tx = jax_adam(lr=1e-2, weight_decay=1e-2)
    jp, opt = jax.tree_util.tree_map(jnp.asarray, params), None
    opt = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    topt = reference_adam(tp.values(), lr=1e-2, weight_decay=1e-2)
    for g in grads:
        updates, opt = tx.update(g, opt, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    adam = bridge._adam_state(opt)
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=RTOL, atol=ATOL)
        st = topt.state[p]
        assert float(st["step"]) == int(adam.count) == 3
        np.testing.assert_allclose(st["exp_avg"].numpy(), adam.mu[k],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), adam.nu[k],
                                   rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("shape", [(4, 3, 3, 5), (2, 3, 4, 2, 5)],
                         ids=["2d", "3d"])
def test_batchnorm_has_flax_semantics(shape):
    """Train mode: batch statistics and a biased running variance, as flax;
    torch's own BatchNorm keeps the unbiased one. Eval: running stats."""
    rng = np.random.default_rng(2)
    x = 2.0 + 1.5 * normal(rng, *shape)           # channels-last, as flax
    c = shape[-1]
    flax_bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    v = np_tree(flax_bn.init(jax.random.PRNGKey(0), x,
                             use_running_average=False))
    v["params"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    v["params"]["bias"] = normal(rng, c)
    v["batch_stats"]["mean"] = normal(rng, c)
    v["batch_stats"]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    with jax.enable_x64(False):
        want, mut = flax_bn.apply(v, x, use_running_average=False,
                                  mutable=["batch_stats"])
        want_eval = flax_bn.apply(v, x, use_running_average=True)
    bn = BatchNorm(c)
    sd = bridge.jax_to_torch({"params": {"BatchNorm_0": v["params"]},
                              "batch_stats": {"BatchNorm_0": v["batch_stats"]}})
    bn.load_state_dict({k.removeprefix("BatchNorm_0."): t
                        for k, t in sd.items()})
    xt = torch.from_numpy(x).movedim(-1, 1)
    with torch.no_grad():
        got_eval = bn.eval()(xt).movedim(1, -1)
        got = bn.train()(xt).movedim(1, -1)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-5)
    for key, name in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, key).numpy(),
                                   np.asarray(mut["batch_stats"][name]),
                                   rtol=RTOL, atol=ATOL)
    assert int(bn.num_batches_tracked) == 1
    # the trap: torch.nn.BatchNorm's running variance is the unbiased one
    tbn = torch.nn.BatchNorm2d(c) if len(shape) == 4 else torch.nn.BatchNorm3d(c)
    tbn.load_state_dict(bn.state_dict())
    tbn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
    tbn.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    with torch.no_grad():
        tbn.train()(xt)
    n = x.size // c
    gap = tbn.running_var - bn.running_var
    want_gap = 0.1 * torch.var(xt.movedim(1, 0).reshape(c, -1), dim=1,
                               correction=0) / (n - 1)
    torch.testing.assert_close(gap, want_gap, rtol=1e-3, atol=1e-7)


def test_noise_layer():
    x = torch.randn(2, 3)
    eps = torch.randn(2, 3)
    assert Noise(use_noise=False)(x) is x
    assert Noise(use_noise=True, sigma=None)(x) is x
    torch.testing.assert_close(Noise(True, 0.2)(x, noise=eps), x + 0.2 * eps)
    a = Noise(True, 0.2)(x, generator=torch.Generator().manual_seed(1))
    b = Noise(True, 0.2)(x, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, x)
    with pytest.raises(ValueError, match="Generator"):
        Noise(True, 0.2)(x)


def test_discriminator_noise_is_drawn_from_the_generator():
    d = tm.PatchImageDiscriminator(1, ndf=2, use_noise=True, noise_sigma=0.1)
    d.init_parameters(torch.Generator().manual_seed(0))
    x = torch.zeros(2, 28, 28, 1)
    with pytest.raises(ValueError, match="Generator"):
        d(x)
    a = d.eval()(x, generator=torch.Generator().manual_seed(5))[0]
    b = d(x, generator=torch.Generator().manual_seed(5))[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    quiet = tm.PatchImageDiscriminator(1, ndf=2)
    quiet.load_state_dict(d.state_dict())
    assert not torch.allclose(quiet.eval()(x)[0], a)


# ------------------------------------------------- generator in train mode
def _jax_motion(params, x0, t):
    x = jl.WarmupMLP(16).apply({"params": params["WarmupMLP_0"]}, x0)
    f = params["ode_fn"]
    zs = jops.reference_rk4_motion(
        x, f["Dense_0"]["kernel"], f["Dense_0"]["bias"], f["Dense_1"]["kernel"],
        f["Dense_1"]["bias"], jnp.linspace(0.0, 1.0, t, dtype=jnp.float32))
    return np.asarray(zs).transpose(1, 0, 2)


@pytest.mark.parametrize("trunk,n_channels", [("dcgan64", 3), ("mnist28", 1)])
def test_generator_train_mode_matches_flax_mutable_apply(trunk, n_channels):
    """sample_videos then sample_images in train mode: frames from batch
    statistics, and the trunk's running statistics after both passes, against
    flax ``apply(train=True, mutable=["batch_stats"])`` on the same latents."""
    n, t = 3, 6
    rng = np.random.default_rng(3)
    jgen = jax_make_generator("ode", n_channels=n_channels, trunk=trunk,
                              ngf=8, video_length=t)
    k = jax.random.PRNGKey(3)
    with jax.enable_x64(False):
        v = np_tree(jgen.init({"params": k, "sample": k}, 2))
    v["batch_stats"]["main"] = {
        name: {"mean": 0.1 * normal(rng, *bn["mean"].shape),
               "var": rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)}
        for name, bn in v["batch_stats"]["main"].items()}
    zc, x0 = normal(rng, n, 50), normal(rng, n, 16)
    zc_i, x0_i = normal(rng, n, 50), normal(rng, n, 16)
    frame_idx = np.array([0, 5, 2])
    zm = _jax_motion(v["params"]["motion"], x0, t)
    z_vid = np.concatenate([np.repeat(zc, t, 0), zm.reshape(n * t, 16)], 1)
    zm_i = _jax_motion(v["params"]["motion"], x0_i, t)[np.arange(n), frame_idx]
    z_img = np.concatenate([zc_i, zm_i], 1)
    trunk_apply = lambda m, z: m.main(z[:, None, None, :], train=True)
    with jax.enable_x64(False):
        want_vid, mut = jgen.apply(v, z_vid, method=trunk_apply,
                                   mutable=["batch_stats"])
        want_img, mut = jgen.apply({**v, **mut}, z_img, method=trunk_apply,
                                   mutable=["batch_stats"])
    gen = make_generator("ode", n_channels=n_channels, trunk=trunk, ngf=8,
                         video_length=t, device="cpu")
    gen.load_state_dict(bridge.jax_to_torch(v), strict=True)
    gen.train()
    with torch.no_grad():
        got_vid, _ = gen.sample_videos(n, z_content=torch.from_numpy(zc),
                                       x0=torch.from_numpy(x0))
        got_img, _ = gen.sample_images(n, z_content=torch.from_numpy(zc_i),
                                       x0=torch.from_numpy(x0_i),
                                       frame_idx=torch.from_numpy(frame_idx))
    np.testing.assert_allclose(got_vid.reshape(n * t, *got_vid.shape[2:]).numpy(),
                               np.asarray(want_vid), rtol=TRUNK_RTOL,
                               atol=TRUNK_ATOL)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               rtol=TRUNK_RTOL, atol=TRUNK_ATOL)
    got_stats = bridge.torch_to_jax(gen.state_dict())["batch_stats"]
    assert_close_tree(got_stats, np_tree(mut["batch_stats"]), TRUNK_RTOL, 0.0)


# ------------------------------------------------------- bridge, GANState
def _jax_tiny_trainer(**kw):
    cfg = jax_config.get_config("mnist_ode", ngf=4, ndf=4, batch_size=2,
                                video_length=6, **kw)
    return jax_build_trainer(cfg), cfg


def test_gan_state_round_trips_with_adam_moments_and_ema():
    jtr, cfg = _jax_tiny_trainer(ema_decay=0.9)
    with jax.enable_x64(False):
        js = np_tree(jax.jit(jtr.init_state)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    nets = {}
    for name in bridge.NETS:
        net = getattr(js, name)
        adam = bridge._adam_state(net.opt_state)
        adam = adam._replace(
            count=np.int32(3),
            mu=jax.tree_util.tree_map(lambda a: normal(rng, *a.shape), adam.mu),
            nu=jax.tree_util.tree_map(lambda a: rng.uniform(0, 1, a.shape)
                                      .astype(np.float32), adam.nu))
        nets[name] = net.replace(opt_state=(optax.EmptyState(),
                                            (adam, optax.EmptyState())))
    ema = jax.tree_util.tree_map(lambda a: normal(rng, *a.shape),
                                 js.gen.params)
    js = js.replace(step=np.int32(7), ema_params=ema, **nets)
    port_cfg = config.get_config("mnist_ode", ngf=4, ndf=4, batch_size=2,
                                 video_length=6, ema_decay=0.9)
    tr = build_trainer(port_cfg, device="cpu")
    state = tr.init_state()
    bridge.gan_state_to_torch(js, state)
    back = bridge.torch_gan_state_to_jax(state)
    for name in bridge.NETS:
        net = getattr(js, name)
        adam = bridge._adam_state(net.opt_state)
        assert_close_tree(back[name]["params"], net.params, 0.0, 0.0)
        assert_close_tree(back[name]["batch_stats"], net.batch_stats, 0.0, 0.0)
        assert_close_tree(back[name]["opt_state"]["mu"], adam.mu, 0.0, 0.0)
        assert_close_tree(back[name]["opt_state"]["nu"], adam.nu, 0.0, 0.0)
        assert back[name]["opt_state"]["count"] == 3
    assert back["step"] == 7
    assert_close_tree(back["ema_params"], ema, 0.0, 0.0)
    # and the EMA weights are what eval sampling serves
    sd = tr.eval_gen_variables(state)
    ema_t = bridge.jax_to_torch({"params": ema})
    torch.testing.assert_close(sd["main.ConvTranspose_0.weight"],
                               ema_t["main.ConvTranspose_0.weight"])


def test_bridge_conv3d_rule_runs_the_same_layer():
    rng = np.random.default_rng(5)
    x = normal(rng, 2, 5, 6, 6, 3)
    conv = fnn.Conv(4, (2, 3, 3), strides=(1, 2, 2),
                    padding=((0, 0), (1, 1), (1, 1)), use_bias=False)
    with jax.enable_x64(False):
        v = np_tree(conv.init(jax.random.PRNGKey(5), x))
        want = np.asarray(conv.apply(v, x))
    layer = torch.nn.Conv3d(3, 4, (2, 3, 3), (1, 2, 2), (0, 1, 1), bias=False)
    sd = bridge.jax_to_torch({"params": {"Conv_0": v["params"]}})
    layer.weight.data.copy_(sd["Conv_0.weight"])
    with torch.no_grad():
        got = layer(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    back = bridge.torch_to_jax({"Conv_0.weight": layer.weight,
                                "FastGradConv3D_0.weight": layer.weight})
    np.testing.assert_array_equal(back["params"]["Conv_0"]["kernel"],
                                  v["params"]["kernel"])
    np.testing.assert_array_equal(back["params"]["FastGradConv3D_0"]["kernel"],
                                  v["params"]["kernel"])


# ------------------------------------------------------- trainer assembly
PORTED = ["ucf_ode", "mnist_ode", "mnist_gru", "mnist_ode_wgan",
          "mnist_ode_noise"]


@pytest.mark.parametrize("name", PORTED)
def test_build_trainer_mirrors_jax(name):
    """The same hyperparameters, discriminator kinds and parameter trees
    (shapes, in flax layout) as the JAX build_trainer, at small widths."""
    over = dict(ngf=4, ndf=4, batch_size=2)
    jtr = jax_build_trainer(jax_config.get_config(name, **over))
    tr = build_trainer(config.get_config(name, **over), device="cpu")
    for f in ("batch_size", "d_iters", "loss", "lr", "betas", "weight_decay",
              "param_noise_sigma", "ema_decay", "fused_real_fake"):
        assert getattr(tr, f) == getattr(jtr, f), f
    assert type(tr.dis_img).__name__ == type(jtr.dis_img).__name__
    assert type(tr.dis_vid).__name__ == type(jtr.dis_vid).__name__
    with jax.enable_x64(False):
        shapes = jax.eval_shape(jtr.init_state, jax.random.PRNGKey(0))
    for net in bridge.NETS:
        want = jax.tree_util.tree_map(lambda a: a.shape,
                                      getattr(shapes, net).params)
        got = jax.tree_util.tree_map(
            lambda a: a.shape,
            bridge.torch_to_jax(getattr(tr, net).state_dict())["params"])
        assert got == want, net


def test_trainer_refuses_an_unknown_loss():
    gen = make_generator("gru", n_channels=1, trunk="mnist28", ngf=4,
                         device="cpu")
    ds = (tm.PatchImageDiscriminator(1, 4), tm.VideoDiscriminator(1, ndf=4,
                                                                  ksize=2))
    with pytest.raises(ValueError, match="unknown loss"):
        GANTrainer(gen, *ds, loss="l2")


def _tiny_port(**kw):
    tr = build_trainer(config.get_config("mnist_gru", ngf=4, ndf=4,
                                         batch_size=2, video_length=6, **kw),
                       device="cpu")
    rng = np.random.default_rng(6)
    images = torch.from_numpy(uniform(rng, 2, 2, 28, 28, 1))
    videos = torch.from_numpy(uniform(rng, 2, 2, 6, 28, 28, 1))
    return tr, tr.init_state(), images, videos


def test_train_step_updates_everything_and_leaves_no_grad():
    tr, state, images, videos = _tiny_port()
    before = {n: {k: v.clone() for k, v in getattr(tr, n).state_dict().items()}
              for n in bridge.NETS}
    with pytest.raises(ValueError, match="noise tape holds 6"):
        tr.train_step(state, images, videos, noise=[{}] * 5)
    metrics = tr.train_step(state, images, videos,
                            generator=torch.Generator().manual_seed(0))
    assert sorted(metrics) == ["dis_img_loss", "dis_vid_loss", "gen_loss"]
    assert all(torch.isfinite(v) and v.ndim == 0 for v in metrics.values())
    assert state.step == 1
    for n in bridge.NETS:
        after = getattr(tr, n).state_dict()
        moved = [k for k in after if not torch.equal(after[k], before[n][k])]
        assert any(k.endswith("weight") for k in moved), n
        assert any(k.endswith("running_var") for k in moved), n
        assert all(p.grad is None for p in getattr(tr, n).parameters())
    steps = {float(s["step"]) for s in state.dis_img.opt.state.values()}
    assert steps == {2.0}          # d_iters D updates, one G update
    assert {float(s["step"]) for s in state.gen.opt.state.values()} == {1.0}


def test_ema_follows_the_generator():
    tr, state, images, videos = _tiny_port(ema_decay=0.5)
    e0 = {k: v.clone() for k, v in state.ema_params.items()}
    tr.train_step(state, images, videos,
                  generator=torch.Generator().manual_seed(0))
    for k, p in tr.gen.named_parameters():
        torch.testing.assert_close(state.ema_params[k], 0.5 * e0[k] + 0.5 * p.detach())
    assert tr.eval_gen_variables(state)["motion.gru.wi"] is state.ema_params["motion.gru.wi"]


def test_param_noise_and_wasserstein_config_trains():
    params = [torch.nn.Parameter(torch.zeros(4000))]
    _add_param_noise(params, 1e-2, torch.Generator().manual_seed(0))
    assert abs(params[0].std().item() - 1e-2) < 1e-3
    tr = build_trainer(config.get_config("mnist_ode_wgan", ngf=4, ndf=4,
                                         batch_size=2, video_length=6),
                       device="cpu")
    assert tr.loss == "wasserstein" and tr.param_noise_sigma == 1e-4
    state = tr.init_state()
    rng = np.random.default_rng(7)
    metrics = tr.train_step(state, torch.from_numpy(uniform(rng, 2, 2, 28, 28, 1)),
                            torch.from_numpy(uniform(rng, 2, 2, 6, 28, 28, 1)),
                            generator=torch.Generator().manual_seed(1))
    assert all(torch.isfinite(v) for v in metrics.values())


def test_fused_real_fake_is_one_pass_over_both():
    tr, state, images, videos = _tiny_port(fused_real_fake=True)
    seen = []
    tr.dis_img.register_forward_hook(lambda m, a, o: seen.append(a[0].shape[0]))
    tr.train_step(state, images, videos,
                  generator=torch.Generator().manual_seed(0))
    assert seen == [4, 4, 2]       # two fused D passes, then the G update's


def test_a_noise_tape_replays_a_step():
    """Two trainers built from one config and fed one tape take the same
    step, bit for bit; the tape holds what each sampler consumes."""
    runs = []
    for _ in range(2):
        tr, state, images, videos = _tiny_port()
        tape = tr.noise_tape(torch.Generator().manual_seed(3), "cpu")
        assert [sorted(d) for d in tape] == (
            [["e", "frame_idx", "h0", "z_content"], ["e", "h0", "z_content"]] * 2
            + [["e", "h0", "z_content"], ["e", "frame_idx", "h0", "z_content"]])
        metrics = tr.train_step(state, images, videos, noise=tape)
        runs.append((metrics, tr.gen.state_dict()))
    (m1, g1), (m2, g2) = runs
    for k in m1:
        assert torch.equal(m1[k], m2[k])
    assert all(torch.equal(g1[k], g2[k]) for k in g1)
