"""The port's stage-1 GResBlock modules (``nn/norm.py``, ``nn/gresblock.py``)
held against the JAX package on the CPU: ``ConditionalNorm``, ``GResBlock``
(up, down, no norm), the ODE block in its three channel cases, the field's
pieces, the resampling helpers, and the served ``odegres64`` generator. The
trunks are in ``test_torch_gres_trunk.py``; the method and tolerances in
``gres_module_parity.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganode_tpu.models import make_generator as jax_make_generator
from ganode_tpu.nn import gresblock as jg
import ganode_tpu_torch.models.motion as motion_mod
from ganode_tpu_torch import bridge
from ganode_tpu_torch.models import make_generator
from ganode_tpu_torch.nn import Conv2dODEField
from ganode_tpu_torch.nn.gresblock import (avg_pool, stateless_cbn,
                                           upsample_nearest)
from ganode_tpu_torch.ops import reference_rk4_motion
from gres_module_parity import (ATOL, BLOCKS, N, NC, NGF, RTOL,
                                check_eval_mode, check_round_trip,
                                check_train_mode, jax_cases, lone_state_dict,
                                nchw, nhwc, port_inputs, port_module)
from torch_parity import f64_tree, normal, np_tree, record_noise


@pytest.fixture(scope="module")
def jax_run():
    return jax_cases(BLOCKS)


@pytest.mark.parametrize("name", BLOCKS)
def test_train_mode_matches_jax(jax_run, name):
    check_train_mode(jax_run[name], name)


@pytest.mark.parametrize("name", BLOCKS)
def test_eval_mode_matches_jax(jax_run, name):
    check_eval_mode(jax_run[name], name)


@pytest.mark.parametrize("name", BLOCKS)
def test_bridge_round_trips_the_block(jax_run, name):
    check_round_trip(jax_run[name], name)


@pytest.mark.parametrize("name", ["ode_pad", "ode_equal", "ode_proj_down"])
def test_ode_block_advances_u_once_per_train_forward(jax_run, name):
    """``u0``/``u1`` advance once per train-mode block forward (8 field
    evaluations reuse one normalisation), not at all in eval mode; JAX's
    init left them where it drew them."""
    r = jax_run[name]
    block = port_module(name, r["v"])
    u = lambda: (block.u0.clone(), block.u1.clone())
    x, c = port_inputs(r, False)
    start = u()
    with torch.no_grad():
        block.eval()(x, c)
        assert all(torch.equal(a, b) for a, b in zip(u(), start))
        block.train()(x, c)
    once = u()
    assert not any(torch.equal(a, b) for a, b in zip(once, start))
    want = r["after"]["spectral"]
    for key, got in zip(("u0", "u1"), once):
        np.testing.assert_allclose(got.numpy(), want[key], rtol=RTOL,
                                   atol=ATOL)
    assert block.nfe == 8

def test_stateless_cbn_and_field_rhs_match_jax():
    rng = np.random.default_rng(1)
    x, g, b = normal(rng, N, 3, 3, 6), normal(rng, N, 6), normal(rng, N, 6)
    with jax.enable_x64(False):
        want = np.asarray(jg._stateless_cbn(jnp.asarray(x), jnp.asarray(g),
                                            jnp.asarray(b)))
    got = stateless_cbn(nchw(x), torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL, atol=ATOL)

    field = jg.Conv2dODEField(6, NC)
    y, c = normal(rng, N, 4, 4, 6), normal(rng, N, NC)
    u0, u1 = normal(rng, 6), normal(rng, 6)
    with jax.enable_x64(False):
        def rhs(m, t, y_, c_):
            k0n, k1n, _, _ = m.normalized_kernels(jnp.asarray(u0),
                                                  jnp.asarray(u1))
            return m.rhs(t, y_, c_, k0n, k1n)

        v = field.init(jax.random.PRNGKey(3), 0.5, jnp.asarray(y),
                       jnp.asarray(c), method=rhs)
        want = np.asarray(field.apply(v, np.float32(0.75), jnp.asarray(y),
                                      jnp.asarray(c), method=rhs))
        _, _, wu0, wu1 = field.apply(v, jnp.asarray(u0), jnp.asarray(u1),
                                     method=field.normalized_kernels)
    port = Conv2dODEField(6, NC)
    port.load_state_dict(lone_state_dict(np_tree(v)), strict=True)
    k0n, k1n, pu0, pu1 = port.normalized_kernels(torch.from_numpy(u0),
                                                 torch.from_numpy(u1))
    got = port.rhs(np.float32(0.75), nchw(y), torch.from_numpy(c), k0n, k1n)
    np.testing.assert_allclose(nhwc(got.detach()), want, rtol=RTOL,
                               atol=ATOL)
    for a, b in ((pu0, wu0), (pu1, wu1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)

@pytest.mark.parametrize("factor", [2, 3])
def test_upsample_and_pool_match_jax(factor):
    """Nearest upsampling (row ``i`` reads ``i // factor``) and VALID
    average pooling (window = stride, a ragged edge dropped)."""
    x = normal(np.random.default_rng(3), 2, 7, 5, 3)
    with jax.enable_x64(False):
        up = np.asarray(jg._upsample_nearest(jnp.asarray(x), factor))
        down = np.asarray(jg._avg_pool(jnp.asarray(x), factor))
    assert up.shape == (2, 7 * factor, 5 * factor, 3)
    assert down.shape == (2, 7 // factor, 5 // factor, 3)
    np.testing.assert_array_equal(nhwc(upsample_nearest(nchw(x), factor)), up)
    np.testing.assert_allclose(nhwc(avg_pool(nchw(x), factor)), down,
                               rtol=1e-6, atol=1e-7)


def test_odegres64_serving_matches_jax_at_the_same_n(monkeypatch):
    """``sample_videos(n)`` in eval mode, the noise JAX drew fed to the
    port: all ``n * T`` frames of the call go through one trunk call, as in
    JAX. In float64 on both sides (JAX x64, its float32 init cast up; the
    port's plain rk4 motion, since the K1 wrapper takes float32 only): in
    float32 this freshly initialised generator's frames are only good to
    ~1.5e-5 on either side (measured: the port's float32 frames 1.50e-5 and
    JAX's 1.17e-5 from the float64 ones), above the 1e-5 bar."""
    kw = dict(n_channels=3, trunk="odegres64", video_length=4,
              dim_z_content=6, dim_z_motion=4, ngf=NGF)
    jgen = jax_make_generator("ode", **kw)
    with jax.enable_x64(False):
        v = np_tree(jax.jit(lambda k: jgen.init(
            {"params": k, "sample": k}, 3, method="sample_videos",
            train=False))(jax.random.PRNGKey(5)))
    # eager: a jitted sampler here computed in float32 under x64
    want, rec = record_noise(lambda k: jgen.apply(
        f64_tree(v), 3, method="sample_videos", train=False,
        rngs={"sample": k})[0], jax.random.PRNGKey(6), x64=True)
    noise = rec.samples(3, 4, 6)[0]
    assert noise["x0"].dtype == noise["z_content"].dtype == np.float64
    monkeypatch.setattr(motion_mod, "fused_rk4_motion", reference_rk4_motion)
    gen = make_generator("ode", device="cpu", **kw).eval()
    gen.load_state_dict(bridge.jax_to_torch(v), strict=True)
    gen.double()
    with torch.no_grad():
        got, _ = gen.sample_videos(3, **{k: torch.from_numpy(np.array(a))
                                         for k, a in noise.items()})
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
