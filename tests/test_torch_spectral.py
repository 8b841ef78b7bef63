"""The port's spectral normalization, spectral-norm critics, ``DCGANTrunk128``,
gradient penalties and bfloat16 compute held against the JAX package on the
CPU.

Weights and ``u`` come from the JAX modules' own init and cross through the
bridge; inputs are made with numpy from a seed. JAX runs float32 (x64 off).
Tolerances: forward rtol 1e-5, atol 1e-6 on the power iteration and dense
layers; rtol 1e-4 with an absolute floor of 1e-5 times the tensor's largest
magnitude on conv outputs, gradients and penalties (sums of products in
another order on each side, and a double backward for the penalties).

bfloat16 (8 significant bits): both sides round every convolution's output,
every BatchNorm's output and every activation to bfloat16, but each side's
float32 accumulations inside a convolution differ in order, so a value near
a rounding boundary lands one bfloat16 step (2^-8 relative) apart, and that
step travels through the later layers. The outputs are held to BF16_ATOL =
3e-2 absolute (about four bfloat16 steps at magnitude 1) and their mean
difference to BF16_MEAN = 2^-7 (one step at magnitude 2: most elements
round alike or one step apart). That the port really computed in bfloat16
is checked apart: its float32 outputs are bfloat16 values cast up, where
the float32 model's are not. (XLA on the CPU may keep excess precision
across a bfloat16 round trip, as in the trunk's last tanh, which is one more
half step between the two sides.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganode_tpu.models import mocogan as jm
from ganode_tpu.nn import spectral as jsn
from ganode_tpu.train import losses as jlosses
from ganode_tpu_torch import bridge
from ganode_tpu_torch.models import mocogan as tm
from ganode_tpu_torch.nn import SNConv, SNDense, spectral_normalize
from ganode_tpu_torch.nn.spectral import _l2norm
from ganode_tpu_torch.train import gradient_penalty, r1_penalty
from torch_parity import assert_close_tree, normal, np_tree, uniform

RTOL, ATOL = 1e-5, 1e-6
CONV_RTOL, FLOOR = 1e-4, 1e-5
BF16_ATOL, BF16_MEAN = 3e-2, 2.0 ** -7
B, NDF, NGF, DZ = 2, 4, 4, 10
# (name, JAX module, port module, input shape (channels-last))
LAYERS = {
    "conv2d": (lambda: jsn.SNConv(5, (3, 3), strides=(2, 2),
                                  padding=((1, 1), (1, 1))),
               lambda: SNConv(3, 5, (3, 3), 2, 1), (B, 9, 9, 3)),
    "conv3d_first": (lambda: jsn.SNConv(6, (4, 4, 4), strides=(1, 2, 2),
                                        padding=((0, 0), (1, 1), (1, 1)),
                                        use_bias=False),
                     lambda: SNConv(3, 6, (4, 4, 4), (1, 2, 2), (0, 1, 1),
                                    use_bias=False), (B, 6, 8, 8, 3)),
    "conv3d": (lambda: jsn.SNConv(4, (2, 2, 2), padding=((0, 0),) * 3),
               lambda: SNConv(3, 4, (2, 2, 2)), (B, 3, 5, 5, 3)),
    "dense": (lambda: jsn.SNDense(7), lambda: SNDense(5, 7), (B, 5)),
}
CRITICS = {
    "image": (lambda: jm.SNImageDiscriminator(ndf=NDF),
              lambda: tm.SNImageDiscriminator(n_channels=3, ndf=NDF),
              (B, 64, 64, 3)),
    "video": (lambda: jm.SNVideoDiscriminator(ksize=4, ndf=NDF),
              lambda: tm.SNVideoDiscriminator(n_channels=3, ndf=NDF, ksize=4),
              (B, 16, 64, 64, 3)),
}
BF16 = {
    "trunk": (lambda dt: jm.DCGANTrunk64(3, NGF, dtype=dt),
              lambda dt: tm.DCGANTrunk64(3, NGF, DZ, dtype=dt), (6, DZ)),
    "image_disc": (lambda dt: jm.ImageDiscriminator(ndf=NDF, dtype=dt),
                   lambda dt: tm.ImageDiscriminator(3, NDF, dtype=dt),
                   (4, 64, 64, 3)),
    "video_disc": (lambda dt: jm.VideoDiscriminator(ksize=4, ndf=NDF,
                                                    dtype=dt),
                   lambda dt: tm.VideoDiscriminator(3, ndf=NDF, ksize=4,
                                                    dtype=dt),
                   (B, 16, 64, 64, 3)),
}


def _nchw(x):
    """Channels-last numpy -> channels-first torch (an SNConv's layout)."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _wrap(variables, name):
    """A lone layer's JAX variables under ``name`` (the bridge maps module
    paths), and back as the layer's own ``state_dict``."""
    nested = {c: {name: v} for c, v in variables.items()}
    return {k.split(".", 1)[1]: v
            for k, v in bridge.jax_to_torch(nested).items()}


def _load(module, variables):
    module.load_state_dict(bridge.jax_to_torch(variables), strict=True)
    return module


def _trunk_in(x):
    return jnp.asarray(x)[:, None, None, :] if x.ndim == 2 else jnp.asarray(x)


@pytest.fixture(scope="module")
def jax_run():
    rng = np.random.default_rng(0)
    out = {}
    with jax.enable_x64(False):
        w2d, u = normal(rng, 6, 10), normal(rng, 6)
        u = u / np.linalg.norm(u)
        sigma, u1, v1 = jsn.spectral_normalize(jnp.asarray(w2d), jnp.asarray(u))
        gw = jax.grad(lambda w: jsn.spectral_normalize(w, jnp.asarray(u))[0])(
            jnp.asarray(w2d))
        out["power"] = (w2d, u, float(sigma), np.asarray(u1), np.asarray(v1),
                        np.asarray(gw))
        for i, (name, (jmod, _, shape)) in enumerate(LAYERS.items()):
            mod = jmod()
            x = normal(rng, *shape)
            v = np_tree(mod.init(jax.random.PRNGKey(i), jnp.asarray(x)))
            y, mut = mod.apply(v, jnp.asarray(x), mutable=["spectral"])
            w = normal(rng, *y.shape)
            grads = jax.grad(lambda p: jnp.sum(mod.apply(
                {"params": p, "spectral": v["spectral"]}, jnp.asarray(x),
                update_stats=False) * w))(v["params"])
            out[name] = (v, x, np.asarray(y), np_tree(mut["spectral"]), w,
                         np_tree(grads))
        for i, (name, (jmod, _, shape)) in enumerate(CRITICS.items()):
            mod = jmod()
            x, fake = uniform(rng, *shape), uniform(rng, *shape)
            v = np_tree(jax.jit(mod.init)(jax.random.PRNGKey(10 + i),
                                          jnp.asarray(x)))
            (lt, _), mut = jax.jit(lambda vv, xx: mod.apply(
                vv, xx, mutable=["spectral"]))(v, jnp.asarray(x))
            le, _ = jax.jit(lambda vv, xx: mod.apply(vv, xx, train=False))(
                v, jnp.asarray(x))
            w = normal(rng, *lt.shape)
            grads = jax.jit(jax.grad(lambda p, xx: jnp.sum(mod.apply(
                {"params": p, "spectral": v["spectral"]}, xx,
                mutable=["spectral"])[0][0] * w), (0, 1)))(
                v["params"], jnp.asarray(x))
            key = jax.random.PRNGKey(20 + i)
            eps = jax.random.uniform(key, (B,) + (1,) * (len(shape) - 1))

            def penalties(p):
                d = lambda xx: mod.apply({"params": p,
                                          "spectral": v["spectral"]}, xx,
                                         train=False)[0]
                return (jlosses.gradient_penalty(d, jnp.asarray(x),
                                                 jnp.asarray(fake), key),
                        jlosses.r1_penalty(d, jnp.asarray(x)))
            (gp, r1), (g_gp, g_r1) = jax.jit(lambda p: (
                penalties(p), (jax.grad(lambda q: penalties(q)[0])(p),
                               jax.grad(lambda q: penalties(q)[1])(p))))(
                v["params"])
            out[f"critic_{name}"] = dict(
                v=v, x=x, fake=fake, train=np.asarray(lt), eval=np.asarray(le),
                u=np_tree(mut["spectral"]), w=w, grads=np_tree(grads),
                eps=np.asarray(eps), gp=float(gp), r1=float(r1),
                g_gp=np_tree(g_gp), g_r1=np_tree(g_r1))
        trunk = jm.DCGANTrunk128(3, NGF)
        z = normal(rng, 3, DZ)
        v = np_tree(jax.jit(trunk.init)(jax.random.PRNGKey(30), _trunk_in(z)))
        y, mut = jax.jit(lambda vv, zz: trunk.apply(
            vv, zz, mutable=["batch_stats"]))(v, _trunk_in(z))
        ye = jax.jit(lambda vv, zz: trunk.apply(vv, zz, train=False))(
            {**v, **np_tree(mut)}, _trunk_in(z))
        out["trunk128"] = (v, z, np.asarray(y), np_tree(mut["batch_stats"]),
                           np.asarray(ye))
        for i, (name, (jmod, _, shape)) in enumerate(BF16.items()):
            x = (normal if name == "trunk" else uniform)(rng, *shape)
            v = np_tree(jax.jit(jmod(jnp.float32).init)(
                jax.random.PRNGKey(40 + i), _trunk_in(x)))
            mod = jmod(jnp.bfloat16)
            y, mut = jax.jit(lambda vv, xx: mod.apply(
                vv, xx, mutable=["batch_stats"]))(v, _trunk_in(x))
            ye = jax.jit(lambda vv, xx: mod.apply(vv, xx, train=False))(
                {**v, **mut}, _trunk_in(x))
            first = lambda o: o[0] if isinstance(o, tuple) else o
            out[f"bf16_{name}"] = (v, x, np.asarray(first(y), np.float32),
                                   np_tree(mut["batch_stats"]),
                                   np.asarray(first(ye), np.float32))
    return out


def test_spectral_normalize_matches_jax(jax_run):
    w2d, u, sigma, u1, v1, gw = jax_run["power"]
    w = torch.from_numpy(w2d).requires_grad_()
    got_sigma, got_u, got_v = spectral_normalize(w, torch.from_numpy(u))
    np.testing.assert_allclose(got_sigma.item(), sigma, rtol=RTOL)
    np.testing.assert_allclose(got_u.numpy(), u1, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_v.numpy(), v1, rtol=RTOL, atol=ATOL)
    assert not got_u.requires_grad and not got_v.requires_grad
    (g,) = torch.autograd.grad(got_sigma, w)
    np.testing.assert_allclose(g.numpy(), gw, rtol=CONV_RTOL, atol=ATOL)
    # v / (||v|| + eps), not F.normalize's v / max(||v||, eps)
    tiny = np.array([3e-13, -4e-13], np.float32)
    np.testing.assert_allclose(_l2norm(torch.from_numpy(tiny)).numpy(),
                               np.asarray(jsn._l2norm(jnp.asarray(tiny))),
                               rtol=RTOL)


@pytest.mark.parametrize("name", LAYERS)
def test_sn_layers_match_jax(jax_run, name):
    v, x, want, want_u, w, want_grads = jax_run[name]
    layer = LAYERS[name][1]()
    flax_name = "SNDense_0" if name == "dense" else "SNConv_0"
    layer.load_state_dict(_wrap(v, flax_name), strict=True)
    xt = torch.from_numpy(x) if x.ndim == 2 else _nchw(x)
    u0 = layer.u.clone()
    with torch.no_grad():
        layer(xt, update_stats=False)
    assert torch.equal(layer.u, u0)
    y = layer(xt, update_stats=True)
    y = y if x.ndim == 2 else y.movedim(1, -1)
    assert_close_tree(y.detach().numpy(), want, CONV_RTOL, FLOOR, name)
    np.testing.assert_allclose(layer.u.numpy(), want_u["u"], rtol=RTOL,
                               atol=ATOL)
    layer.u.copy_(u0)
    y = layer(xt, update_stats=False)
    y = y if x.ndim == 2 else y.movedim(1, -1)
    names, params = zip(*layer.named_parameters())
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(), params)
    got = bridge.torch_to_jax({f"{flax_name}.{k}": g for k, g in zip(
        names, grads)})["params"][flax_name]
    assert_close_tree(got, want_grads, CONV_RTOL, FLOOR, f"{name} grads")


@pytest.mark.parametrize("name", CRITICS)
def test_sn_critics_and_their_penalties_match_jax(jax_run, name):
    r = jax_run[f"critic_{name}"]
    critic = _load(CRITICS[name][1](), r["v"])
    x, fake = torch.from_numpy(r["x"]), torch.from_numpy(r["fake"])
    u0 = {k: b.clone() for k, b in critic.named_buffers()}
    critic.eval()
    with torch.no_grad():
        le, _ = critic(x)
    assert all(torch.equal(b, u0[k]) for k, b in critic.named_buffers())
    assert_close_tree(le.numpy(), r["eval"], CONV_RTOL, FLOOR, "eval logits")

    # the penalties' pass: eval mode, u as the JAX state had it
    d_apply = lambda xx: critic(xx)[0]
    eps = torch.from_numpy(np.array(r["eps"]))
    names, params = zip(*critic.named_parameters())
    for which, value, want_grads in (
            ("gp", gradient_penalty(d_apply, x, fake, eps), r["g_gp"]),
            ("r1", r1_penalty(d_apply, x), r["g_r1"])):
        np.testing.assert_allclose(value.item(), r[which], rtol=CONV_RTOL)
        grads = torch.autograd.grad(value, params)
        got = bridge.torch_to_jax(dict(zip(names, grads)))["params"]
        assert_close_tree(got, want_grads, CONV_RTOL, FLOOR, which)

    critic.train()
    xg = x.clone().requires_grad_()
    lt, _ = critic(xg)
    assert_close_tree(lt.detach().numpy(), r["train"], CONV_RTOL, FLOOR,
                      "train logits")
    got_u = bridge.torch_to_jax(dict(critic.named_buffers()))["spectral"]
    assert_close_tree(got_u, r["u"], RTOL, ATOL, "u")
    grads = torch.autograd.grad((lt * torch.from_numpy(r["w"])).sum(),
                                [xg, *params])
    got = bridge.torch_to_jax(dict(zip(names, grads[1:])))["params"]
    want_p, want_x = r["grads"]
    assert_close_tree(got, want_p, CONV_RTOL, FLOOR, "params")
    assert_close_tree(grads[0].numpy(), want_x, CONV_RTOL, FLOOR, "input")


def test_sn_video_critic_refuses_short_clips():
    critic = tm.SNVideoDiscriminator(n_channels=3, ndf=2, ksize=4)
    with pytest.raises(ValueError, match="at least 16 frames"):
        critic(torch.zeros(1, 15, 64, 64, 3))


def test_dcgan128_trunk_matches_jax(jax_run):
    v, z, want, want_stats, want_eval = jax_run["trunk128"]
    trunk = _load(tm.DCGANTrunk128(3, NGF, DZ), v).train()
    with torch.no_grad():
        y = trunk(torch.from_numpy(z))
        assert y.shape == (3, 3, 128, 128)
        assert_close_tree(y.permute(0, 2, 3, 1).numpy(), want, CONV_RTOL,
                          FLOOR, "train")
        stats = bridge.torch_to_jax(trunk.state_dict())["batch_stats"]
        assert_close_tree(stats, want_stats, CONV_RTOL, FLOOR, "batch_stats")
        ye = trunk.eval()(torch.from_numpy(z))
    assert_close_tree(ye.permute(0, 2, 3, 1).numpy(), want_eval, CONV_RTOL,
                      FLOOR, "eval")


@pytest.mark.parametrize("name", BF16)
def test_bfloat16_compute_matches_jax(jax_run, name):
    v, x, want, want_stats, want_eval = jax_run[f"bf16_{name}"]

    def run(dtype):
        mod = _load(BF16[name][1](dtype), v).train()
        assert all(p.dtype == torch.float32 for p in mod.parameters())
        first = lambda o: o[0] if isinstance(o, tuple) else o
        with torch.no_grad():
            y = first(mod(torch.from_numpy(x)))
            ye = first(mod.eval()(torch.from_numpy(x)))
        if name == "trunk":
            y, ye = y.permute(0, 2, 3, 1), ye.permute(0, 2, 3, 1)
        return mod, y, ye

    f32_train = run(torch.float32)[1]
    mod, y, ye = run(torch.bfloat16)
    assert y.dtype == ye.dtype == torch.float32
    for got, ref in ((y.numpy(), want), (ye.numpy(), want_eval)):
        diff = np.abs(got - ref)
        assert diff.max() <= BF16_ATOL and diff.mean() <= BF16_MEAN, (
            diff.max(), diff.mean())
    as_bf16 = lambda t: torch.equal(t, t.to(torch.bfloat16).float())
    assert as_bf16(y) and as_bf16(ye) and not as_bf16(f32_train)
    stats = bridge.torch_to_jax(mod.state_dict())["batch_stats"]
    assert_close_tree(stats, want_stats, 0.0, BF16_ATOL, "batch_stats")
