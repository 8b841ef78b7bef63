"""The port's ODE-GAN trainer (``ganode_tpu_torch.train.odegan``) held against
the JAX one on the toy problems of ``tests/test_odegan.py``, and the motion
kernels' ``Function``s differentiated twice, which its regularizer needs.

Float64 on both sides (JAX under ``enable_x64``), rtol 1e-10: the bar the
JAX package's own golden tests hold its trainer to. The toy losses take no
noise. The double-backward tests run the kernels' ``Function``s with their
launch patched to the plain recurrence (pytest ``MonkeyPatch``; nothing in
the package changes for it), since no kernel runs on the CPU: the forward
is then the plain recurrence, so every derivative, the second included, must
equal the plain recurrence's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganode_tpu.ode.tree import tree_axpy as jax_axpy
from ganode_tpu.ode.tree import tree_lincomb as jax_lincomb
from ganode_tpu.ode.tree import tree_sq_norm as jax_sq_norm
from ganode_tpu.train import ODEGANTrainer as JaxTrainer
from ganode_tpu.train import discriminator_regularizer as jax_regularizer
from ganode_tpu.train import euler_step as jax_euler
from ganode_tpu.train import rk2_step as jax_rk2
from ganode_tpu.train import rk4_step as jax_rk4
from ganode_tpu_torch.ode.tree import tree_axpy, tree_lincomb, tree_sq_norm
from ganode_tpu_torch.ops import fused_gru, fused_rk4
from ganode_tpu_torch.ops.fused_gru import _FusedGRU, reference_gru_motion
from ganode_tpu_torch.ops.fused_rk4 import _FusedRK4, reference_rk4_motion
from ganode_tpu_torch.train import (ODEGANTrainer, discriminator_regularizer,
                                    euler_step, rk2_step, rk4_step)

RTOL = 1e-10
METHODS = ["euler", "rk2", "rk4"]
JAX_STEPPERS = {"euler": jax_euler, "rk2": jax_rk2, "rk4": jax_rk4}
STEPPERS = {"euler": euler_step, "rk2": rk2_step, "rk4": rk4_step}


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(autouse=True)
def x64():
    with jax.enable_x64(True):
        yield


def test_tree_helpers_match_jax_on_dicts():
    rng = np.random.default_rng(0)
    x = {"b": rng.standard_normal(3), "a": rng.standard_normal((2, 2))}
    y = {"b": rng.standard_normal(3), "a": rng.standard_normal((2, 2))}
    tx = {k: t64(v) for k, v in x.items()}
    ty = {k: t64(v) for k, v in y.items()}
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    jy = {k: jnp.asarray(v) for k, v in y.items()}
    for got, want in ((tree_axpy(-0.3, tx, ty), jax_axpy(-0.3, jx, jy)),
                      (tree_lincomb([0.5, -2.0], [tx, ty], base=ty),
                       jax_lincomb([0.5, -2.0], [jx, jy], base=jy)),
                      (tree_lincomb([0.5, -2.0], [tx, ty]),
                       jax_lincomb([0.5, -2.0], [jx, jy]))):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=RTOL)
    np.testing.assert_allclose(float(tree_sq_norm(tx)), float(jax_sq_norm(jx)),
                               rtol=RTOL)
    # tuples, as the solvers use them, are unchanged
    got = tree_lincomb([2.0], [(tx["a"],)], base=(ty["a"],))
    np.testing.assert_allclose(got[0].numpy(), y["a"] + 2.0 * x["a"], rtol=RTOL)


@pytest.mark.parametrize("method", METHODS)
def test_each_stepper_matches_jax(method):
    """loss = sum(a * w^2) + sum(w) (``tests/test_odegan.py``'s golden toy)."""
    w0 = np.asarray([0.7, -1.3, 2.1])
    a = np.asarray([1.5, 0.5, -0.8])
    want = JAX_STEPPERS[method](
        {"w": jnp.asarray(w0)},
        lambda p, k, b: jnp.sum(jnp.asarray(a) * p["w"] ** 2) + jnp.sum(p["w"]),
        0.05, jax.random.PRNGKey(0))
    ta = t64(a)
    got = STEPPERS[method]({"w": t64(w0)},
                           lambda p, n, b: torch.sum(ta * p["w"] ** 2)
                           + torch.sum(p["w"]), 0.05)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=RTOL)


def _bilinear(framework):
    g0, d0 = np.asarray([0.4, -0.6]), np.asarray([1.1, 0.3])
    m = np.asarray([[0.5, -0.2], [0.8, 0.1]])
    if framework == "jax":
        wrap, jm = jnp.asarray, jnp.asarray(m)
    else:
        wrap, jm = t64, t64(m)
    params = {"gen": {"w": wrap(g0)}, "dis_img": {"w": wrap(d0)},
              "dis_vid": None}
    g_loss = lambda p, k, b: p["gen"]["w"] @ jm @ p["dis_img"]["w"]
    d_loss = lambda p, k, b: -(p["gen"]["w"] @ jm @ p["dis_img"]["w"])
    return params, g_loss, d_loss


@pytest.mark.parametrize("method", METHODS)
def test_a_discriminator_step_with_the_penalty_matches_jax(method):
    """The bilinear min-max toy, g_loss = g^T M d, with the regularizer
    (euler's penalty without its lr factor included)."""
    params, g_loss, d_loss = _bilinear("jax")
    want = JaxTrainer(g_loss=g_loss, d_img_loss=d_loss, lr=0.05, reg=0.01,
                      method=method).step(params, jax.random.PRNGKey(0),
                                          model="dis_img")
    params, g_loss, d_loss = _bilinear("torch")
    got = ODEGANTrainer(g_loss=g_loss, d_img_loss=d_loss, lr=0.05, reg=0.01,
                        method=method).step(params, model="dis_img")
    np.testing.assert_allclose(got["dis_img"]["w"].numpy(),
                               np.asarray(want["dis_img"]["w"]), rtol=RTOL)
    assert got["gen"] is params["gen"]          # G untouched by a D step
    # and without the penalty the step is the stepper's alone
    plain = ODEGANTrainer(g_loss=g_loss, d_img_loss=d_loss, lr=0.05, reg=0.0,
                          method=method).step(params, model="dis_img")
    want_plain = STEPPERS[method](params["dis_img"],
                                  lambda p, n, b: d_loss({**params, "dis_img": p},
                                                         n, b), 0.05)
    np.testing.assert_allclose(plain["dis_img"]["w"].numpy(),
                               want_plain["w"].numpy(), rtol=RTOL)
    assert not np.allclose(plain["dis_img"]["w"].numpy(),
                           got["dis_img"]["w"].numpy())


def test_the_regularizer_has_its_closed_form():
    # L_G = g^T M d -> grad_g = M d -> ||.||^2 = d^T M^T M d -> 2 M^T M d
    m = np.asarray([[1.0, 2.0], [0.0, 1.0]])
    g, d = np.asarray([0.3, -0.4]), np.asarray([0.5, 0.7])
    got = discriminator_regularizer(
        lambda g_, d_: g_["w"] @ t64(m) @ d_["w"], {"w": t64(g)}, {"w": t64(d)})
    np.testing.assert_allclose(got["w"].numpy(), 2.0 * (m.T @ m) @ d,
                               rtol=RTOL)
    want = jax_regularizer(lambda g_, d_: g_ @ jnp.asarray(m) @ d_,
                           jnp.asarray(g), jnp.asarray(d),
                           jax.random.PRNGKey(0))
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want), rtol=RTOL)


def test_parameters_the_loss_does_not_reach_get_zero_gradients():
    """``jax.grad`` gives zeros for a leaf the loss does not use; so does the
    port (``allow_unused``), in a stage's gradient and in the penalty."""
    loss = lambda p, n, b: 0.5 * torch.sum(p["w"] ** 2)
    p = {"w": t64([1.0, -2.0]), "unused": t64([3.0])}
    got = euler_step(p, loss, 0.1)
    np.testing.assert_array_equal(got["unused"].numpy(), [3.0])
    np.testing.assert_allclose(got["w"].numpy(), [0.9, -1.8], rtol=RTOL)
    gp = discriminator_regularizer(lambda g_, d_: torch.sum(g_["w"] ** 2),
                                   {"w": t64([1.0])}, {"v": t64([2.0])})
    np.testing.assert_array_equal(gp["v"].numpy(), [0.0])


def test_dispatch_and_its_errors():
    quad = lambda p, n, b: 0.5 * torch.sum(p["gen"]["w"] ** 2)
    with pytest.raises(ValueError, match="euler"):
        ODEGANTrainer(g_loss=quad, d_img_loss=quad, method="rk5")
    params = {"gen": {"w": torch.ones(2, dtype=torch.float64)},
              "dis_img": {"w": torch.ones(2, dtype=torch.float64)},
              "dis_vid": {"w": torch.ones(2, dtype=torch.float64)}}
    tr = ODEGANTrainer(g_loss=quad, d_img_loss=quad, reg=0.0, method="euler",
                       lr=0.1)
    out = tr.step(params, model="gen")
    np.testing.assert_allclose(out["gen"]["w"].numpy(), [0.9, 0.9], rtol=RTOL)
    assert out["dis_img"] is params["dis_img"]
    assert out["dis_vid"] is params["dis_vid"]
    np.testing.assert_array_equal(params["gen"]["w"].numpy(), [1.0, 1.0])
    with pytest.raises(ValueError, match="without a video discriminator"):
        tr.step(params, model="dis_vid")
    with pytest.raises(ValueError, match="gen\\|dis_img\\|dis_vid"):
        tr.step(params, model="critic")


def test_each_stage_takes_its_own_noise():
    """A dict of draws gives stage s its entry s and the penalty its
    ``"penalty"`` entry, as JAX folds stage s and 99 into the key."""
    seen = []

    def g_loss(p, n, b):
        seen.append(("g", n))
        return p["gen"]["w"].sum() * p["dis_img"]["w"].sum()

    def d_loss(p, n, b):
        seen.append(("d", n))
        return (p["dis_img"]["w"] ** 2).sum()

    params = {"gen": {"w": t64([1.0])}, "dis_img": {"w": t64([2.0])},
              "dis_vid": None}
    noise = {0: "n0", 1: "n1", 2: "n2", 3: "n3", "penalty": "np"}
    ODEGANTrainer(g_loss=g_loss, d_img_loss=d_loss, method="rk4").step(
        params, noise, model="dis_img")
    assert seen == [("g", "np"), ("d", "n0"), ("d", "n1"), ("d", "n2"),
                    ("d", "n3")]


# ---------------------------------------------------------------------------
# The kernels' Functions, twice differentiable
# ---------------------------------------------------------------------------

B, D, H, T = 3, 4, 5, 6


@pytest.fixture
def plain_launches(monkeypatch):
    """The kernels' launches replaced by their plain recurrences."""
    def rk4(x, w1, b1, w2, b2, n_out, h, variant=None):
        ts = torch.arange(n_out, dtype=x.dtype) * h
        return reference_rk4_motion(x, w1, b1, w2, b2, ts)

    monkeypatch.setattr(fused_rk4, "_launch", rk4)
    monkeypatch.setattr(fused_gru, "_launch",
                        lambda *a, variant=None: reference_gru_motion(*a))


def _rk4_inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g,
                                          dtype=torch.float64) * scale
    ts = torch.linspace(0.0, 1.0, T, dtype=torch.float64)
    return ([r(B, D), r(D, H, scale=0.5), r(H, scale=0.1), r(H, D, scale=0.5),
             r(D, scale=0.1)], ts)


def _gru_inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g,
                                          dtype=torch.float64) * scale
    return [r(B, D), r(T, B, D), r(D, 3 * D, scale=0.5),
            r(D, 3 * D, scale=0.5), r(3 * D, scale=0.1), r(3 * D, scale=0.1)]


def _rk4_function(ts):
    h = fused_rk4.uniform_step(ts)
    return lambda *a: _FusedRK4.apply(*a, ts, h)


def test_the_rk4_function_passes_gradgradcheck(plain_launches):
    inputs, ts = _rk4_inputs()
    assert torch.autograd.gradgradcheck(
        _rk4_function(ts), [a.requires_grad_() for a in inputs])


def test_the_gru_function_passes_gradgradcheck(plain_launches):
    assert torch.autograd.gradgradcheck(
        _FusedGRU.apply, [a.requires_grad_() for a in _gru_inputs()])


@pytest.mark.parametrize("kernel", ["rk4", "gru"])
def test_a_penalty_through_the_function_matches_the_plain_recurrence(
        plain_launches, kernel):
    """d/da ||grad_{inputs, c} L||^2 for L = sum(a * sin(out)) + (a . c)^2:
    the outer derivative reaches ``a`` through the cotangent of the kernel's
    VJP, and through the ``c`` term, which keeps the outer graph alive when
    the VJP drops its graph."""
    if kernel == "rk4":
        inputs, ts = _rk4_inputs(1)
        fused, plain = _rk4_function(ts), lambda *a: reference_rk4_motion(*a, ts)
    else:
        inputs = _gru_inputs(1)
        fused, plain = _FusedGRU.apply, reference_gru_motion
    g = torch.Generator().manual_seed(2)
    a0 = torch.randn((T, B, D), generator=g, dtype=torch.float64)
    c0 = torch.randn((T, B, D), generator=g, dtype=torch.float64)

    def penalty_grad(fn):
        leaves = [x.detach().clone().requires_grad_() for x in inputs]
        a, c = a0.clone().requires_grad_(), c0.clone().requires_grad_()
        loss = (a * torch.sin(fn(*leaves))).sum() + (a * c).sum() ** 2
        grads = torch.autograd.grad(loss, leaves + [c], create_graph=True)
        (da,) = torch.autograd.grad(sum((x * x).sum() for x in grads), a)
        return da

    want = penalty_grad(plain)
    torch.testing.assert_close(penalty_grad(fused), want, rtol=1e-10,
                               atol=1e-10 * want.abs().max().item())
