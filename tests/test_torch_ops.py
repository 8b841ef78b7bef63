"""The port's motion kernels' plain versions and the fixed-grid solver, held
against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as tests/test_ops.py
does. Inputs are made with numpy from a seed and cast to float32 on both sides
(every test process may run with jax_enable_x64 on). Tolerances: rtol 1e-5,
atol 1e-6 on trajectories (float32 sums in another order); rtol 1e-4 on
gradients, the bar of tests/test_ops.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganode_tpu import ops as jops
from ganode_tpu.ode import odeint as jax_odeint
from ganode_tpu_torch.ode import odeint
from ganode_tpu_torch.ops import (
    fused_gru,
    fused_gru_motion,
    fused_rk4,
    fused_rk4_motion,
    reference_gru_motion,
    reference_rk4_motion,
)

RTOL, ATOL = 1e-5, 1e-6


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rk4_np(b, d, h, t, seed=0):
    rng = np.random.default_rng(seed)
    return (_normal(rng, b, d), _normal(rng, d, h, scale=0.4),
            _normal(rng, h, scale=0.1), _normal(rng, h, d, scale=0.4),
            _normal(rng, d, scale=0.1), np.linspace(0, 1, t, dtype=np.float32))


def _gru_np(b, d, t, seed=0):
    rng = np.random.default_rng(seed)
    return (_normal(rng, b, d), _normal(rng, t, b, d),
            _normal(rng, d, 3 * d, scale=0.3), _normal(rng, d, 3 * d, scale=0.3),
            _normal(rng, 3 * d, scale=0.1), _normal(rng, 3 * d, scale=0.1))


def _jax(args):
    return [jnp.asarray(a) for a in args]


def _torch(args):
    return [torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("b,d,h,t", [(32, 16, 16, 16), (5, 10, 10, 6),
                                     (4, 10, 24, 6)])
def test_rk4_matches_jax_reference_and_kernel(b, d, h, t):
    args = _rk4_np(b, d, h, t)
    got = fused_rk4_motion(*_torch(args)).numpy()
    assert got.shape == (t, b, d)
    want = np.asarray(jops.reference_rk4_motion(*_jax(args)))
    pallas = np.asarray(jops.fused_rk4_motion(*_jax(args), True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,d,t", [(16, 16, 8), (7, 12, 4), (3, 16, 5)])
def test_gru_matches_jax_reference_and_kernel(b, d, t):
    args = _gru_np(b, d, t)
    got = fused_gru_motion(*_torch(args)).numpy()
    assert got.shape == (t, b, d)
    want = np.asarray(jops.reference_gru_motion(*_jax(args)))
    pallas = np.asarray(jops.fused_gru_motion(*_jax(args), True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)


def test_rk4_gradients_match_jax():
    x, w1, b1, w2, b2, ts = _rk4_np(4, 16, 16, 8)
    jx, jb1, jb2, jts = _jax((x, b1, b2, ts))
    gj = jax.grad(lambda a, c: jnp.sum(jops.fused_rk4_motion(
        jx, a, jb1, c, jb2, jts, True) ** 2), argnums=(0, 1))(
            jnp.asarray(w1), jnp.asarray(w2))
    tw1, tw2 = (torch.from_numpy(a).requires_grad_() for a in (w1, w2))
    out = fused_rk4_motion(torch.from_numpy(x), tw1, torch.from_numpy(b1), tw2,
                           torch.from_numpy(b2), torch.from_numpy(ts))
    (out ** 2).sum().backward()
    for got, want in zip((tw1.grad, tw2.grad), gj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=ATOL)


def test_gru_gradients_match_jax():
    h0, e, wi, wh, bi, bh = _gru_np(4, 16, 4)
    gj = jax.grad(lambda w: jnp.sum(jops.fused_gru_motion(
        *_jax((h0, e)), w, *_jax((wh, bi, bh)), True) ** 2))(jnp.asarray(wi))
    twi = torch.from_numpy(wi).requires_grad_()
    out = fused_gru_motion(*_torch((h0, e)), twi, *_torch((wh, bi, bh)))
    (out ** 2).sum().backward()
    np.testing.assert_allclose(twi.grad.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=ATOL)


def test_cpu_wrappers_take_the_plain_path():
    rk4 = _torch(_rk4_np(5, 10, 24, 6))
    gru = _torch(_gru_np(7, 12, 4))
    before = fused_rk4.launches, fused_gru.launches
    got_rk4, got_gru = fused_rk4_motion(*rk4), fused_gru_motion(*gru)
    assert (fused_rk4.launches, fused_gru.launches) == before
    torch.testing.assert_close(got_rk4, reference_rk4_motion(*rk4), rtol=0, atol=0)
    torch.testing.assert_close(got_gru, reference_gru_motion(*gru), rtol=0, atol=0)


def test_rk4_refuses_a_non_uniform_grid():
    x, w1, b1, w2, b2, _ = _torch(_rk4_np(4, 16, 16, 4))
    ts = torch.tensor([0.0, 0.1, 0.5, 1.0])
    with pytest.raises(ValueError, match="uniform"):
        fused_rk4_motion(x, w1, b1, w2, b2, ts)


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "shape"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    rk4 = _torch(_rk4_np(4, 16, 16, 4))
    gru = _torch(_gru_np(4, 8, 3))
    if bad == "dtype":
        rk4[1], gru[2] = rk4[1].double(), gru[2].double()
        err = TypeError
    elif bad == "contiguous":
        rk4[1], gru[2] = rk4[1].t().contiguous().t(), gru[2].t().contiguous().t()
        err = ValueError
    else:
        rk4[4], gru[4] = rk4[4][:-1], gru[4][:-1]
        err = ValueError
    with pytest.raises(err):
        fused_rk4_motion(*rk4)
    with pytest.raises(err):
        fused_gru_motion(*gru)


@pytest.mark.parametrize("method,spi", [("rk4", 1), ("euler", 1),
                                        ("midpoint", 2), ("rk3", 1),
                                        ("rk38", 3), ("heun", 1)])
def test_odeint_matches_jax_odeint(method, spi):
    x, w1, b1, w2, b2, ts = _rk4_np(4, 16, 16, 8)
    want = jax_odeint(lambda t, y, p: jnp.tanh(y @ p[0] + p[1]) @ p[2] + p[3],
                      jnp.asarray(x), jnp.asarray(ts), _jax((w1, b1, w2, b2)),
                      method=method, steps_per_interval=spi)
    got = odeint(lambda t, y, p: torch.tanh(y @ p[0] + p[1]) @ p[2] + p[3],
                 torch.from_numpy(x), torch.from_numpy(ts),
                 _torch((w1, b1, w2, b2)), method=method,
                 steps_per_interval=spi)
    assert got.shape == (8, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_odeint_time_dependent_field_and_contract():
    # dy/dt = -t y: ys[0] == y0 exactly, and the stage times t0 + c_i h reach f
    y0 = torch.ones(3, dtype=torch.float64)
    ts = torch.linspace(0.0, 1.0, 11, dtype=torch.float64)
    ys = odeint(lambda t, y: -t * y, y0, ts, method="rk4")
    assert torch.equal(ys[0], y0)
    np.testing.assert_allclose(ys[-1].numpy(), np.exp(-0.5), rtol=1e-6)
    with pytest.raises(ValueError, match="fixed-grid"):
        odeint(lambda t, y: y, y0, ts, method="dopri5")
