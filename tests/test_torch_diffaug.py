"""The port's DiffAugment and ADA controller (``ganode_tpu_torch.train.
diffaug``) held against the JAX package's (``ganode_tpu/train/diffaug.py``)
on the CPU.

JAX draws inside ``diff_augment`` from ``fold_in(key, i)``; the port takes
its draws as tensors. Each comparison rebuilds JAX's draws from the same key
(``torch_parity.jax_aug_draws``) and feeds them to the port. Translation and
cutout move or zero values and must agree exactly; the colour ops agree at
the forward bar of ``tests/test_ops.py`` (rtol 1e-5, atol 1e-6), gradients
with respect to the input at rtol 1e-4. JAX runs with x64 off. The JAX
tests' properties (``tests/test_diffaug.py``) are checked again on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganode_tpu.train import diffaug as jda
from ganode_tpu_torch.train import diffaug as da
from torch_parity import jax_aug_draws

POLICY = "color,translation,cutout"
IMAGE, VIDEO = (4, 12, 10, 3), (3, 5, 16, 16, 3)
FWD = dict(rtol=1e-5, atol=1e-6)
EXACT_OPS = ("translation", "cutout")


def _x(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _jax(x, key, policy, p=None):
    with jax.enable_x64(False):
        return np.asarray(jda.diff_augment(
            jnp.asarray(x), key, policy,
            None if p is None else jnp.asarray(p, jnp.float32)))


def _port(x, key, policy, p=None):
    ops = jda.parse_policy(policy)
    draws = {k: torch.from_numpy(v) for k, v in
             jax_aug_draws(key, x.shape, ops, p is not None).items()}
    return da.diff_augment(torch.from_numpy(x), ops,
                           None if p is None else torch.tensor(p),
                           draws=draws).numpy()


@pytest.mark.parametrize("shape", [IMAGE, VIDEO], ids=["image", "video"])
@pytest.mark.parametrize("op", sorted(da.POLICY_OPS))
def test_each_op_matches_jax(op, shape):
    x = _x(shape)
    key = jax.random.PRNGKey(11)
    got, want = _port(x, key, op), _jax(x, key, op)
    if op in EXACT_OPS:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **FWD)
    assert not np.array_equal(got, x)


@pytest.mark.parametrize("shape", [(4, 5, 6, 3), (4, 2, 5, 6, 1)],
                         ids=["image", "video"])
def test_translate2d_matches_jax(shape):
    x = _x(shape, 1)
    sh = np.array([0, 2, -3, 10])   # a shift past the extent too
    sw = np.array([1, -2, 0, -10])
    with jax.enable_x64(False):
        want = np.asarray(jda.translate2d(jnp.asarray(x), jnp.asarray(sh),
                                          jnp.asarray(sw)))
    got = da.translate2d(torch.from_numpy(x), torch.from_numpy(sh),
                         torch.from_numpy(sw)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("policy", ["", "color", POLICY, " cutout , brightness",
                                    "translation,color,translation"])
def test_parse_policy_matches_jax(policy):
    assert da.parse_policy(policy) == jda.parse_policy(policy)


def test_unknown_op_raises():
    with pytest.raises(ValueError, match="unknown diffaug op 'flip'"):
        da.parse_policy("color,flip")


@pytest.mark.parametrize("p", [None, 0.0, 0.5, 1.0])
@pytest.mark.parametrize("shape", [IMAGE, VIDEO], ids=["image", "video"])
def test_diff_augment_matches_jax(shape, p):
    x = _x(shape, 2)
    key = jax.random.PRNGKey(5)
    np.testing.assert_allclose(_port(x, key, POLICY, p),
                               _jax(x, key, POLICY, p), **FWD)


@pytest.mark.parametrize("p", [None, 0.5])
def test_input_gradients_match_jax(p):
    x = _x(VIDEO, 3)
    w = _x(VIDEO, 4)
    key = jax.random.PRNGKey(9)
    ops = jda.parse_policy(POLICY)
    with jax.enable_x64(False):
        pj = None if p is None else jnp.asarray(p, jnp.float32)
        want = np.asarray(jax.grad(lambda v: jnp.sum(
            jda.diff_augment(v, key, ops, pj) ** 2 * w))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    draws = {k: torch.from_numpy(v)
             for k, v in jax_aug_draws(key, x.shape, ops, p is not None).items()}
    y = da.diff_augment(xt, ops, None if p is None else torch.tensor(p),
                        draws=draws)
    (got,) = torch.autograd.grad((y ** 2 * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())
    assert np.abs(want).max() > 0


def test_p1_is_the_ungated_result_and_p0_the_identity():
    x = torch.from_numpy(_x(VIDEO, 6))
    draws = da.diffaug_draws(POLICY, x.shape, True,
                             torch.Generator().manual_seed(1))
    plain = da.diff_augment(x, POLICY, draws=draws)
    assert torch.equal(da.diff_augment(x, POLICY, torch.tensor(1.0),
                                       draws=draws), plain)
    assert torch.equal(da.diff_augment(x, POLICY, torch.tensor(0.0),
                                       draws=draws), x)


def test_intermediate_p_gates_each_sample_whole():
    x = torch.from_numpy(_x((64, 6, 6, 1), 7))
    draws = da.diffaug_draws("brightness", x.shape, True,
                             torch.Generator().manual_seed(2))
    aug = da.diff_augment(x, "brightness", draws=draws)
    got = da.diff_augment(x, "brightness", torch.tensor(0.5), draws=draws)
    is_aug = (got == aug).flatten(1).all(1)
    is_raw = (got == x).flatten(1).all(1)
    assert bool((is_aug | is_raw).all())
    assert torch.equal(is_aug, draws["0:gate"] < 0.5)
    assert bool(is_aug.any()) and bool(is_raw.any())


@pytest.mark.parametrize("p,rt,want", [(0.5, 0.9, 0.51), (0.5, 0.1, 0.49),
                                       (0.0, 0.1, 0.0), (0.8, 0.9, 0.8)])
def test_ada_update_signs_and_clip_match_jax(p, rt, want):
    kw = dict(target=0.6, step=0.01, p_max=0.8)
    got = da.ada_update(torch.tensor(p), torch.tensor(rt), **kw)
    with jax.enable_x64(False):
        ref = jda.ada_update(jnp.asarray(p, jnp.float32),
                             jnp.asarray(rt, jnp.float32), **kw)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == float(ref)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_ada_update_settles_at_its_fixed_point():
    p = torch.tensor(0.0)
    for _ in range(200):
        p = da.ada_update(p, 1.0 - p, target=0.6, step=0.01, p_max=0.8)
    assert abs(float(p) - 0.4) < 0.02


def test_a_static_clip_stays_static():
    frame = torch.from_numpy(_x((4, 1, 12, 12, 3), 8))
    video = frame.repeat(1, 6, 1, 1, 1)
    y = da.diff_augment(video, POLICY, generator=torch.Generator().manual_seed(3))
    assert torch.equal(y, y[:, :1].repeat(1, 6, 1, 1, 1))


def test_saturation_keeps_the_channel_mean_and_contrast_the_sample_mean():
    x = torch.from_numpy(_x((4, 8, 8, 3), 9))
    g = torch.Generator().manual_seed(4)
    y = da.diff_augment(x, "saturation", generator=g)
    torch.testing.assert_close(y.mean(-1), x.mean(-1), rtol=0, atol=1e-5)
    y = da.diff_augment(x, "contrast", generator=g)
    torch.testing.assert_close(y.mean((1, 2, 3)), x.mean((1, 2, 3)), rtol=0,
                               atol=1e-5)


def test_cutout_zeroes_one_block():
    y = da.diff_augment(torch.ones((8, 1, 16, 16, 1)), "cutout",
                        generator=torch.Generator().manual_seed(5)).numpy()
    for b in range(8):
        zeros = y[b, 0, :, :, 0] == 0
        n = zeros.sum()
        assert 0 < n <= 64
        rows = np.where(zeros.any(axis=1))[0]
        cols = np.where(zeros.any(axis=0))[0]
        assert np.array_equal(rows, np.arange(rows[0], rows[-1] + 1))
        assert np.array_equal(cols, np.arange(cols[0], cols[-1] + 1))
        assert n == len(rows) * len(cols)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("shape", [(3, 8, 8, 3), (3, 4, 8, 8, 3)],
                         ids=["image", "video"])
def test_shape_and_dtype_are_kept(shape, dtype):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(6)).to(dtype)
    y = da.diff_augment(x, POLICY, torch.tensor(0.5),
                        generator=torch.Generator().manual_seed(7))
    assert y.shape == x.shape and y.dtype == dtype


def test_draws_from_a_generator_replay_through_diffaug_draws():
    x = torch.from_numpy(_x(VIDEO, 10))
    for gated in (False, True):
        p = torch.tensor(0.5) if gated else None
        drawn = da.diff_augment(x, POLICY, p,
                                generator=torch.Generator().manual_seed(8))
        draws = da.diffaug_draws(POLICY, x.shape, gated,
                                 torch.Generator().manual_seed(8))
        assert sorted(draws) == sorted(
            [f"{i}:{n}" for i, n in enumerate(da.parse_policy(POLICY))]
            + ([f"{i}:gate" for i in range(5)] if gated else []))
        assert torch.equal(da.diff_augment(x, POLICY, p, draws=draws), drawn)


def test_missing_draws_need_a_generator_and_bad_ranks_raise():
    x = torch.zeros((2, 8, 8, 3))
    assert da.diff_augment(x, "") is x
    with pytest.raises(ValueError, match="no torch.Generator"):
        da.diff_augment(x, "brightness")
    with pytest.raises(ValueError, match="no draw '0:gate'"):
        da.diff_augment(x, "brightness", 0.5,
                        draws={"0:brightness": torch.zeros(2)})
    with pytest.raises(ValueError, match="B,H,W,C"):
        da.diff_augment(torch.zeros((2, 8, 8)), "brightness",
                        generator=torch.Generator())
