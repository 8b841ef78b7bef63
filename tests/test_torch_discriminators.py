"""The port's BatchNorm discriminators and ``conv3d_first`` held against the
JAX package's on the CPU.

Weights come from the flax modules' own init, with BatchNorm scale, bias and
running statistics made non-trivial, and cross through the bridge (the 3-D
conv rule included); inputs are made with numpy from a seed. Train mode is
compared on logits and on the running statistics it leaves (flax's biased
variance), eval mode on logits. JAX runs float32 (x64 off).

Tolerances, those of ``tests/test_ops.py``: rtol 1e-4, atol 1e-5 on logits and
statistics after conv stacks; rtol 1e-5, atol 1e-5 on one convolution's
output; gradients rtol 1e-4 with an absolute floor of 1e-5 times the leaf's
largest magnitude (a weight gradient sums thousands of products, in another
order on each side, and some cancel to near zero); the double backward rtol
1e-4, atol 1e-4 as in ``tests/test_ops.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganode_tpu import models as jm
from ganode_tpu.ops import conv3d_first as jax_conv3d_first
from ganode_tpu_torch import bridge
from ganode_tpu_torch.models import make_discriminator
from ganode_tpu_torch.models import mocogan as tm
from ganode_tpu_torch.ops import conv3d_first
from torch_parity import assert_close_tree, normal, np_tree, uniform

RTOL, ATOL = 1e-4, 1e-5


def _perturb_bn(variables, rng):
    """Non-trivial BatchNorm scale/bias and running statistics, wherever the
    BatchNorm layers sit in the tree."""
    def walk(params, stats):
        for name, sub in stats.items():
            if "mean" in sub:
                sub["mean"] = 0.1 * normal(rng, *sub["mean"].shape)
                sub["var"] = rng.uniform(0.5, 2.0, sub["var"].shape).astype(np.float32)
                params[name]["scale"] = rng.uniform(0.5, 1.5, sub["mean"].shape).astype(np.float32)
                params[name]["bias"] = 0.1 * normal(rng, *sub["mean"].shape)
            else:
                walk(params[name], sub)
    walk(variables["params"], variables["batch_stats"])
    return variables


# (id, JAX module, port module, input shape)
CASES = [
    ("image_full_64", jm.ImageDiscriminator(ndf=4),
     lambda: tm.ImageDiscriminator(n_channels=3, ndf=4), (3, 64, 64, 3)),
    ("image_patch_28", jm.PatchImageDiscriminator(ndf=4),
     lambda: tm.PatchImageDiscriminator(n_channels=1, ndf=4), (3, 28, 28, 1)),
    ("image_patch_64", jm.PatchImageDiscriminator(ndf=4),
     lambda: tm.PatchImageDiscriminator(n_channels=3, ndf=4), (2, 64, 64, 3)),
    ("video_patch", jm.PatchVideoDiscriminator(ndf=4),
     lambda: tm.PatchVideoDiscriminator(n_channels=3, ndf=4), (2, 16, 32, 32, 3)),
    ("video_k2", jm.VideoDiscriminator(ndf=4, ksize=2),
     lambda: tm.VideoDiscriminator(n_channels=1, ndf=4, ksize=2), (3, 8, 28, 28, 1)),
    ("video_k4", jm.VideoDiscriminator(ndf=4, ksize=4),
     lambda: tm.VideoDiscriminator(n_channels=3, ndf=4, ksize=4), (2, 16, 64, 64, 3)),
    ("video_categorical", jm.CategoricalVideoDiscriminator(
        dim_categorical=3, ndf=4, ksize=2),
     lambda: tm.CategoricalVideoDiscriminator(3, n_channels=1, ndf=4, ksize=2),
     (2, 6, 28, 28, 1)),
]


def _pair(jmod, tmod, shape, seed=0):
    rng = np.random.default_rng(seed)
    x = uniform(rng, *shape)
    with jax.enable_x64(False):
        v = _perturb_bn(np_tree(jmod.init(jax.random.PRNGKey(seed), x)), rng)
    port = tmod()
    port.load_state_dict(bridge.jax_to_torch(v), strict=True)
    return v, port, x


def _outputs(out):
    return [np.asarray(a) for a in out if a is not None]


@pytest.mark.parametrize("name,jmod,tmod,shape", CASES, ids=[c[0] for c in CASES])
def test_train_mode_logits_and_running_stats_match_flax(name, jmod, tmod, shape):
    v, port, x = _pair(jmod, tmod, shape)
    with jax.enable_x64(False):
        want, mut = jmod.apply(v, x, mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w in zip(_outputs(got), _outputs(want)):
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    got_stats = bridge.torch_to_jax(port.state_dict())["batch_stats"]
    assert_close_tree(got_stats, np_tree(mut["batch_stats"]), RTOL, 0.0)
    # and the pass did move them
    assert not np.allclose(jax.tree_util.tree_leaves(got_stats)[1],
                           jax.tree_util.tree_leaves(v["batch_stats"])[1])


@pytest.mark.parametrize("name,jmod,tmod,shape", CASES, ids=[c[0] for c in CASES])
def test_eval_mode_logits_match_flax(name, jmod, tmod, shape):
    v, port, x = _pair(jmod, tmod, shape, seed=1)
    with jax.enable_x64(False):
        want = jmod.apply(v, x, train=False)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert (got[1] is None) == (want[1] is None)
    for g, w in zip(_outputs(got), _outputs(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("idx", [2, 5], ids=["image_patch_64", "video_k4"])
def test_gradients_through_a_discriminator_match_jax(idx):
    """d sum(logits^2) / d (params, input), train mode."""
    _, jmod, tmod, shape = CASES[idx]
    v, port, x = _pair(jmod, tmod, shape, seed=2)

    def loss(params, x):
        (h, _), _ = jmod.apply({"params": params,
                                "batch_stats": v["batch_stats"]}, x,
                               mutable=["batch_stats"])
        return jnp.sum(jnp.square(h))

    with jax.enable_x64(False):
        gp, gx = jax.grad(loss, argnums=(0, 1))(v["params"], x)
    xt = torch.from_numpy(x).requires_grad_()
    params = dict(port.train().named_parameters())
    out = (port(xt)[0] ** 2).sum()
    grads = torch.autograd.grad(out, [xt, *params.values()])
    got = bridge.torch_to_jax(dict(zip(params, grads[1:])))["params"]
    assert_close_tree(got, np_tree(gp), RTOL, 1e-5, "params")
    assert_close_tree(grads[0].numpy(), np.asarray(gx), RTOL, 1e-5, "input")


def test_short_clips_are_refused():
    for ksize, t in ((2, 5), (4, 15)):
        port = tm.VideoDiscriminator(n_channels=1, ndf=2, ksize=ksize)
        with pytest.raises(ValueError, match=f"at least {5 * ksize - 4} frames"):
            port(torch.zeros(1, t, 28, 28, 1))


def test_unported_and_unknown_discriminators():
    """The spectral-norm critics, once refused, build at tiny widths and
    give finite logits; an unknown kind is refused."""
    g = torch.Generator().manual_seed(0)
    img = make_discriminator("sn", False, n_channels=3, ndf=4, device="cpu")
    logits, _ = img(torch.rand((2, 64, 64, 3), generator=g))
    assert logits.shape == (2, 4, 4) and bool(torch.isfinite(logits).all())
    vid = make_discriminator("sn", True, n_channels=3, ndf=4, ksize=4,
                             device="cpu")
    logits, _ = vid(torch.rand((2, 16, 64, 64, 3), generator=g))
    assert logits.shape == (2,) and bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="unknown video"):
        make_discriminator("odd", True, n_channels=3, device="cpu")


def test_make_discriminator_draws_dcgan_weights_from_the_seed():
    a = make_discriminator("full", True, n_channels=1, ndf=4, ksize=2, seed=3,
                           device="cpu").state_dict()
    b = make_discriminator("full", True, n_channels=1, ndf=4, ksize=2, seed=3,
                           device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["Conv_1.weight"]
    assert abs(float(w.std()) - 0.02) < 0.005 and abs(float(w.mean())) < 0.005
    assert torch.equal(a["BatchNorm_0.weight"], torch.ones(8))
    assert torch.equal(a["BatchNorm_0.running_var"], torch.ones(8))


# ----------------------------------------------------------- conv3d_first
# tests/test_ops.py::TestConv3DFoldedGrad's checks, against the JAX op.

def _conv_inputs(b=2, t=12, h=32, w=32, ci=3, co=16, seed=0):
    rng = np.random.default_rng(seed)
    return normal(rng, b, t, h, w, ci), 0.1 * normal(rng, 4, 4, 4, ci, co)


def _to_torch(x, w):
    """JAX layouts (NTHWC, THWIO) -> torch's (NCTHW, OITHW)."""
    return (torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous(),
            torch.from_numpy(w).permute(4, 3, 0, 1, 2).contiguous())


def _sq_loss_grads(x, w):
    """Gradients of sum(conv3d_first(x, w)^2) on both sides, in JAX layouts."""
    with jax.enable_x64(False):
        gx, gw = jax.grad(lambda x, w: jnp.sum(jnp.square(jax_conv3d_first(x, w))),
                          argnums=(0, 1))(x, w)
    xt, wt = (a.requires_grad_() for a in _to_torch(x, w))
    tx, tw = torch.autograd.grad((conv3d_first(xt, wt) ** 2).sum(), [xt, wt])
    return ((tx.permute(0, 2, 3, 4, 1).numpy(), np.asarray(gx)),
            (tw.permute(2, 3, 4, 1, 0).numpy(), np.asarray(gw)))


def test_conv3d_first_forward_matches_jax():
    x, w = _conv_inputs()
    with jax.enable_x64(False):
        want = np.asarray(jax_conv3d_first(x, w))
    got = conv3d_first(*_to_torch(x, w)).permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape == (2, 9, 16, 16, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conv3d_first_gradients_match_jax():
    for got, want in _sq_loss_grads(*_conv_inputs()):
        assert_close_tree(got, want, RTOL, 1e-5)


@pytest.mark.parametrize("h,w", [(31, 31), (32, 30), (33, 32)])
def test_conv3d_first_odd_and_nonsquare_spatial(h, w):
    x, k = _conv_inputs(t=8, h=h, w=w, co=8, seed=4)
    with jax.enable_x64(False):
        want = np.asarray(jax_conv3d_first(x, k))
    got = conv3d_first(*_to_torch(x, k)).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for got, want in _sq_loss_grads(x, k):
        assert_close_tree(got, want, RTOL, 1e-5)


def test_conv3d_first_double_backward_matches_jax():
    """The gradient penalty's grad-of-grad through the conv."""
    x, w = _conv_inputs(b=1, t=8, h=16, w=16, co=8)

    def gp(w_):
        g = jax.grad(lambda x_: jnp.sum(jnp.square(jax_conv3d_first(x_, w_))))(x)
        return jnp.sum(jnp.square(g))

    with jax.enable_x64(False):
        want = np.asarray(jax.grad(gp)(w))
    xt, wt = _to_torch(x, w)
    xt.requires_grad_()
    wt.requires_grad_()
    (gx,) = torch.autograd.grad((conv3d_first(xt, wt) ** 2).sum(), [xt],
                                create_graph=True)
    (gw,) = torch.autograd.grad((gx ** 2).sum(), [wt])
    np.testing.assert_allclose(gw.permute(2, 3, 4, 1, 0).numpy(), want,
                               rtol=1e-4, atol=1e-4)
