"""The port's layers, trunks, motion samplers and generator held against the
JAX package's modules on the CPU.

Weights come from the JAX modules' own init (with BatchNorm parameters and
running statistics made non-trivial) and cross through the bridge; inputs and
noise are made with numpy from a seed and fed to both sides in float32. The
JAX samplers draw their own noise, so the JAX side of a sampler test is the
composition of its modules: WarmupMLP.apply -> reference_rk4_motion (or
reference_gru_motion) -> concat -> the trunk's apply(train=False).

Tolerances: rtol 1e-5, atol 1e-6 on layers, solver and recurrence outputs;
rtol 1e-4, atol 1e-5 on trunk outputs, which sum up to ngf*8*16 products per
output in float32, in another order on each side.
"""
import jax
from flax import linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganode_tpu import ops as jops
from ganode_tpu.models import make_generator as jax_make_generator
from ganode_tpu.models.mocogan import DCGANTrunk64 as JaxDCGAN64
from ganode_tpu.models.mocogan import MNISTTrunk28 as JaxMNIST28
from ganode_tpu.models.motion import MotionGRU as JaxMotionGRU
from ganode_tpu.models.motion import MotionODE as JaxMotionODE
from ganode_tpu.nn import layers as jl
from ganode_tpu.ode import odeint as jax_odeint
from ganode_tpu_torch import bridge
from ganode_tpu_torch.models import make_generator
from ganode_tpu_torch.models.mocogan import DCGANTrunk64, MNISTTrunk28
from ganode_tpu_torch.models.motion import MotionGRU, MotionODE
from ganode_tpu_torch.nn import GRUCell, MLP, WarmupMLP

RTOL, ATOL = 1e-5, 1e-6
TRUNK_RTOL, TRUNK_ATOL = 1e-4, 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), dict(tree))


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _load(module, variables):
    module.load_state_dict(bridge.jax_to_torch(variables), strict=True)
    return module.eval()


def _perturb_bn(variables, rng, prefix=()):
    """Non-trivial BatchNorm scale/bias and running statistics."""
    params, stats = variables["params"], variables["batch_stats"]
    for k in prefix:
        params, stats = params[k], stats[k]
    for name, bn in stats.items():
        bn["mean"] = (0.1 * _normal(rng, *bn["mean"].shape))
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
        params[name]["scale"] = rng.uniform(0.5, 1.5, bn["mean"].shape).astype(np.float32)
        params[name]["bias"] = 0.1 * _normal(rng, *bn["mean"].shape)
    return variables


def test_warmup_mlp_and_mlp_match_jax():
    rng = np.random.default_rng(0)
    x = _normal(rng, 4, 16)
    cases = [
        (jl.WarmupMLP(16), WarmupMLP(16)),
        (jl.MLP((24, 16), activation=jnp.tanh), MLP(16, (24, 16))),
        (jl.MLP((8, 12, 5), activation=jnp.tanh), MLP(16, (8, 12, 5))),
    ]
    for jmod, tmod in cases:
        v = _np_tree(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        want = np.asarray(jmod.apply(v, jnp.asarray(x)))
        with torch.no_grad():
            got = _load(tmod, v)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_gru_cell_matches_jax():
    rng = np.random.default_rng(1)
    h, x = _normal(rng, 3, 16), _normal(rng, 3, 16)
    jcell = jl.GRUCell(16)
    v = _np_tree(jcell.init(jax.random.PRNGKey(1), jnp.asarray(h), jnp.asarray(x)))
    # non-zero biases so the [r | z | n] bias blocks are exercised
    v["params"]["bi"] = 0.1 * _normal(rng, 48)
    v["params"]["bh"] = 0.1 * _normal(rng, 48)
    want = np.asarray(jcell.apply(v, jnp.asarray(h), jnp.asarray(x)))
    with torch.no_grad():
        got = _load(GRUCell(16), v)(torch.from_numpy(h), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("jcls,tcls,n_channels,size", [
    (JaxDCGAN64, DCGANTrunk64, 3, 64), (JaxMNIST28, MNISTTrunk28, 1, 28)])
def test_trunks_match_flax_eval(jcls, tcls, n_channels, size):
    rng = np.random.default_rng(2)
    z = _normal(rng, 3, 66)
    jtrunk = jcls(n_channels, 8)
    v = _np_tree(jtrunk.init(jax.random.PRNGKey(2), jnp.asarray(z)[:, None, None, :]))
    v = _perturb_bn(v, rng)
    want = np.asarray(jtrunk.apply(v, jnp.asarray(z)[:, None, None, :], train=False))
    with torch.no_grad():
        got = _load(tcls(n_channels, 8, 66), v)(torch.from_numpy(z))
    assert got.shape == (3, n_channels, size, size)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=TRUNK_RTOL, atol=TRUNK_ATOL)


def _jax_motion_ode(params, x0, video_len, method="rk4"):
    """The JAX MotionODE with its noise given: warm-up MLP, then the solve."""
    x = jl.WarmupMLP(16).apply({"params": params["WarmupMLP_0"]}, jnp.asarray(x0))
    ts = jnp.linspace(0.0, 1.0, video_len, dtype=jnp.float32)
    f = params["ode_fn"]
    if method == "rk4":
        zs = jops.reference_rk4_motion(
            x, f["Dense_0"]["kernel"], f["Dense_0"]["bias"],
            f["Dense_1"]["kernel"], f["Dense_1"]["bias"], ts)
    else:
        field = jl.MLP((16, 16), activation=jnp.tanh)
        zs = jax_odeint(lambda t, y, p: field.apply({"params": p}, y), x, ts,
                        f, method=method)
    return np.asarray(zs).transpose(1, 0, 2)


def _jax_motion_gru(params, h0, e):
    g = params["gru"]
    hs = jops.reference_gru_motion(jnp.asarray(h0), jnp.asarray(e), g["wi"],
                                   g["wh"], g["bi"], g["bh"])
    return np.asarray(hs).transpose(1, 0, 2)


@pytest.mark.parametrize("method", ["rk4", "midpoint"])
def test_motion_ode_matches_jax_composition(method):
    rng = np.random.default_rng(3)
    x0 = _normal(rng, 4, 16)
    k = jax.random.PRNGKey(3)
    v = _np_tree(JaxMotionODE(dim=16, method=method).init(
        {"params": k, "sample": k}, 4, 8))
    want = _jax_motion_ode(v["params"], x0, 8, method)
    with torch.no_grad():
        got = _load(MotionODE(16, method=method), v)(4, 8, x0=torch.from_numpy(x0))
    assert got.shape == (4, 8, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_motion_gru_matches_jax_composition():
    rng = np.random.default_rng(4)
    h0, e = _normal(rng, 4, 16), _normal(rng, 8, 4, 16)
    k = jax.random.PRNGKey(4)
    v = _np_tree(JaxMotionGRU(dim=16).init({"params": k, "sample": k}, 4, 8))
    v["params"]["gru"]["bi"] = 0.1 * _normal(rng, 48)
    want = _jax_motion_gru(v["params"], h0, e)
    with torch.no_grad():
        got = _load(MotionGRU(16), v)(4, 8, h0=torch.from_numpy(h0),
                                      e=torch.from_numpy(e))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_samplers_draw_from_the_generator_only():
    mo = MotionODE(16)
    with pytest.raises(ValueError, match="Generator"):
        mo(2, 4)
    a = mo(2, 4, generator=torch.Generator().manual_seed(7))
    b = mo(2, 4, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


GEN_CASES = [("ode", "dcgan64", 3, 0), ("gru", "mnist28", 1, 0),
             ("ode", "mnist28", 1, 3)]


def _generators(variant, trunk, n_channels, n_cat, seed=5):
    rng = np.random.default_rng(seed)
    jgen = jax_make_generator(variant, n_channels=n_channels, trunk=trunk,
                              ngf=8, dim_z_category=n_cat, video_length=6)
    k = jax.random.PRNGKey(seed)
    v = _perturb_bn(_np_tree(jgen.init({"params": k, "sample": k}, 2)), rng,
                    ("main",))
    tgen = _load(make_generator(variant, n_channels=n_channels, trunk=trunk,
                                ngf=8, dim_z_category=n_cat, video_length=6,
                                device="cpu"), v)
    return jgen, v, tgen, rng


def _motion_noise(variant, rng, n, t):
    if variant == "ode":
        return {"x0": _normal(rng, n, 16)}
    return {"h0": _normal(rng, n, 16), "e": _normal(rng, t, n, 16)}


def _jax_motion(variant, params, noise, t):
    if variant == "ode":
        return _jax_motion_ode(params, noise["x0"], t)
    return _jax_motion_gru(params, noise["h0"], noise["e"])


def _jax_trunk(jgen, v, z):
    return np.asarray(jgen.apply(v, jnp.asarray(z)[:, None, None, :],
                                 method=lambda m, z: m.main(z, train=False)))


@pytest.mark.parametrize("variant,trunk,n_channels,n_cat", GEN_CASES)
def test_sample_videos_matches_jax_composition(variant, trunk, n_channels, n_cat):
    n, t = 3, 6
    jgen, v, tgen, rng = _generators(variant, trunk, n_channels, n_cat)
    zc = _normal(rng, n, 50)
    labels = np.array([2, 0, 1])
    noise = _motion_noise(variant, rng, n, t)
    zm = _jax_motion(variant, v["params"]["motion"], noise, t)
    parts = [np.repeat(zc, t, axis=0)]
    if n_cat:
        parts.append(np.repeat(np.eye(n_cat, dtype=np.float32)[labels], t, axis=0))
    z = np.concatenate(parts + [zm.reshape(n * t, 16)], axis=1)
    frames = _jax_trunk(jgen, v, z)
    want = frames.reshape(n, t, *frames.shape[1:])
    with torch.no_grad():
        got, got_labels = tgen.sample_videos(
            n, z_content=torch.from_numpy(zc),
            labels=torch.from_numpy(labels) if n_cat else None,
            **{k: torch.from_numpy(a) for k, a in noise.items()})
    size = 64 if trunk == "dcgan64" else 28
    assert got.shape == (n, t, size, size, n_channels)
    assert (got_labels is None) == (n_cat == 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=TRUNK_RTOL, atol=TRUNK_ATOL)


@pytest.mark.parametrize("variant,trunk,n_channels,n_cat", GEN_CASES[:2])
def test_sample_images_matches_jax_composition(variant, trunk, n_channels, n_cat):
    n, t = 4, 6
    jgen, v, tgen, rng = _generators(variant, trunk, n_channels, n_cat)
    zc = _normal(rng, n, 50)
    frame_idx = np.array([0, 5, 2, 3])
    noise = _motion_noise(variant, rng, n, t)
    zm = _jax_motion(variant, v["params"]["motion"], noise, t)[np.arange(n), frame_idx]
    want = _jax_trunk(jgen, v, np.concatenate([zc, zm], axis=1))
    with torch.no_grad():
        got, none = tgen.sample_images(
            n, z_content=torch.from_numpy(zc),
            frame_idx=torch.from_numpy(frame_idx),
            **{k: torch.from_numpy(a) for k, a in noise.items()})
    assert none is None and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TRUNK_RTOL, atol=TRUNK_ATOL)


def test_same_seed_same_weights():
    a = make_generator("gru", n_channels=1, trunk="mnist28", ngf=8, seed=3,
                       device="cpu").state_dict()
    b = make_generator("gru", n_channels=1, trunk="mnist28", ngf=8, seed=3,
                       device="cpu").state_dict()
    c = make_generator("gru", n_channels=1, trunk="mnist28", ngf=8, seed=4,
                       device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["motion.gru.wi"], c["motion.gru.wi"])
    assert torch.equal(a["main.BatchNorm_0.running_var"], torch.ones(64))


@pytest.mark.parametrize("variant,method", [("ode", "rk4"), ("ode", "euler"),
                                            ("gru", None)])
def test_one_frame_clip_matches_the_jax_module(variant, method):
    """video_len=1: the JAX modules return (n, 1, dim); the port too, with no
    kernel launch for the ODE (a one-point grid is the initial state). The
    noise the JAX module drew is read where it is consumed: the WarmupMLP's
    input (x0), the GRU cell's first call (h0, e_1)."""
    n, k = 4, jax.random.PRNGKey(6)
    jmod = (JaxMotionODE(dim=16, method=method) if variant == "ode"
            else JaxMotionGRU(dim=16))
    seen = {}

    def keep(name, value):
        jax.debug.callback(lambda a: seen.setdefault(name, np.array(a, np.float32)),
                           value)

    def intercept(next_fun, args, kwargs, context):
        if context.method_name == "__call__":
            if isinstance(context.module, jl.WarmupMLP):
                keep("x0", args[0])
            elif isinstance(context.module, jl.GRUCell):
                keep("h0", args[0])
                keep("e", args[1])
        return next_fun(*args, **kwargs)

    with jax.enable_x64(False):
        v = _np_tree(jmod.init({"params": k, "sample": k}, n, 2))
        with nn.intercept_methods(intercept):
            want = np.asarray(jmod.apply(v, n, 1, rngs={"sample": k}))
        jax.effects_barrier()
    assert want.shape == (n, 1, 16)
    if variant == "ode":
        port, noise = MotionODE(16, method=method), {"x0": seen["x0"]}
    else:
        port, noise = MotionGRU(16), {"h0": seen["h0"], "e": seen["e"][None]}
    with torch.no_grad():
        got = _load(port, v)(n, 1, **{a: torch.from_numpy(b)
                                      for a, b in noise.items()})
    assert got.shape == (n, 1, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    gen = make_generator(variant, n_channels=1, trunk="mnist28", ngf=4,
                         device="cpu")
    videos, _ = gen.sample_videos(2, 1, generator=torch.Generator().manual_seed(0))
    assert videos.shape == (2, 1, 28, 28, 1)
