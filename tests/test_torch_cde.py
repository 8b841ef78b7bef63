"""The port's splines, ``cdeint`` and ``MotionCDE`` held against the JAX
package's on the CPU.

Paths ``(batch 3, T 8, channels 2)`` from a numpy seed, on ``arange(T)``
and on an uneven grid. Tolerances: coefficients, values and derivatives
rtol 1e-5, atol 1e-6 (float32 on both sides, JAX with x64 off); the CDE
trajectory the same, its gradients rtol 1e-4 with an absolute floor of 1e-6
times the tensor's largest value (as ``torch_parity.assert_close_tree``),
and again in float64 at rtol 1e-10, where the two sides agree to ~1e-15.
The ``cdeint`` field's weights are small enough for float32 to be good to
1e-4 on both sides: at twice these weights JAX's own float32 midpoint
gradients are 1.3e-3 from its float64 ones (the port's 4.8e-4), and there a
float32 comparison holds neither side to 1e-4. The spline is only
C^1 at a knot, so the interval a knot falls in is checked exactly: the one
to its right, as JAX's ``searchsorted(side="right")`` takes it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ganode_tpu.ode as jax_ode
from ganode_tpu.models.motion import MotionCDE as JaxMotionCDE
from ganode_tpu_torch import bridge
from ganode_tpu_torch import ode
from ganode_tpu_torch.models import MotionCDE
from torch_parity import normal, np_tree, record_noise

N, T, C = 3, 8, 2
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
BUILDERS = ["hermite_cubic_coefficients", "linear_coefficients",
            "natural_cubic_coefficients"]
UNEVEN = np.array([0.0, 0.5, 1.25, 2.0, 2.5, 3.5, 4.0, 5.0], np.float32)
# knots, midpoints, and times outside [t0, tT]
PROBES = [0.0, 1.0, 2.0, 4.0, 7.0, 0.5, 2.5, 6.5, 5.25, -0.75, 7.5, 9.0]


def _path(seed=0):
    return normal(np.random.default_rng(seed), N, T, C)


@pytest.mark.parametrize("grid", ["arange", "uneven"])
@pytest.mark.parametrize("builder", BUILDERS)
def test_spline_matches_jax(builder, grid):
    x = _path()
    t = None if grid == "arange" else UNEVEN
    with jax.enable_x64(False):
        want = getattr(jax_ode, builder)(jnp.asarray(x), t)
        want_v = [np.asarray(want.evaluate(jnp.float32(s))) for s in PROBES]
        want_d = [np.asarray(want.derivative(jnp.float32(s))) for s in PROBES]
        want_b = np.asarray(want.evaluate_batch(jnp.asarray(PROBES, jnp.float32)))
    got = getattr(ode, builder)(torch.from_numpy(x), t)
    for name in ("knots", "a", "b", "c", "d"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **FWD,
                                   err_msg=name)
    for s, v, d in zip(PROBES, want_v, want_d):
        np.testing.assert_allclose(got.evaluate(s).numpy(), v, **FWD)
        np.testing.assert_allclose(got.derivative(s).numpy(), d, **FWD)
        # a time given as a tensor takes the device path: the same numbers
        st = torch.tensor(s, dtype=torch.float32)
        np.testing.assert_allclose(got.evaluate(st).numpy(), v, **FWD)
        np.testing.assert_allclose(got.derivative(st).numpy(), d, **FWD)
    np.testing.assert_allclose(got.evaluate_batch(PROBES).numpy(), want_b, **FWD)


def test_a_knot_takes_the_interval_to_its_right():
    x = torch.from_numpy(_path())
    s = ode.hermite_cubic_coefficients(x)
    for k in range(T - 1):
        assert s._locate(float(k)) == (k, 0.0)
        idx, u = s._locate(torch.tensor(float(k)))
        assert int(idx) == k and float(u) == 0.0
        # left of the knot the derivative is the previous interval's end
        assert not torch.allclose(s.derivative(float(k) + 1e-3),
                                  s.derivative(float(k) - 1e-3)) or k == 0
    assert s._locate(float(T - 1)) == (T - 2, 1.0)
    assert s._locate(-2.0) == (0, -2.0)


def _cde_field(tanh, z, w1, b1, w2, b2, hidden):
    out = tanh(tanh(z @ w1 + b1) @ w2 + b2)
    return out.reshape(z.shape[:-1] + (hidden, C))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("method,spi", [("rk4", 1), ("euler", 2),
                                        ("midpoint", 1)])
def test_cdeint_matches_jax(method, spi, dtype):
    rng = np.random.default_rng(5)
    hid = 4
    x, z0 = _path(1).astype(dtype), normal(rng, N, hid).astype(dtype)
    p = tuple(a.astype(dtype) for a in (
        normal(rng, hid, 8) * 0.25, normal(rng, 8) * 0.1,
        normal(rng, 8, hid * C) * 0.15, normal(rng, hid * C) * 0.1))
    w = normal(rng, T, N, hid).astype(dtype)
    ts = np.arange(T, dtype=dtype)

    def jax_loss(z, q):
        spline = jax_ode.hermite_cubic_coefficients(jnp.asarray(x), ts)
        zs = jax_ode.cdeint(
            spline, z, lambda t, y, a: _cde_field(jnp.tanh, y, *a, hid), ts,
            args=q, method=method, steps_per_interval=spi)
        return jnp.sum(zs * w), zs

    with jax.enable_x64(dtype == np.float64):
        (_, want), (gz, gp) = jax.value_and_grad(
            jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(z0), p)
    z = torch.tensor(z0, requires_grad=True)
    q = tuple(torch.tensor(a, requires_grad=True) for a in p)
    spline = ode.hermite_cubic_coefficients(torch.from_numpy(x), ts)
    zs, st = ode.cdeint(
        spline, z, lambda t, y, a: _cde_field(torch.tanh, y, *a, hid), ts,
        args=q, method=method, steps_per_interval=spi, return_stats=True)
    tol = FWD if dtype == np.float32 else dict(rtol=1e-10, atol=0)
    np.testing.assert_allclose(zs.detach().numpy(), np.asarray(want), **tol)
    grads = torch.autograd.grad((zs * torch.from_numpy(w)).sum(), (z, *q))
    for got, want_g in zip(grads, (gz, *gp)):
        want_g = np.asarray(want_g)
        floor = 1e-6 * np.abs(want_g).max() if dtype == np.float32 else 0.0
        np.testing.assert_allclose(got.numpy(), want_g, atol=floor,
                                   rtol=GRAD["rtol"] if dtype == np.float32
                                   else 1e-10)
    stages = ode.FIXED_GRID[method].stages
    assert (st.nfe, st.n_steps) == (stages * (T - 1) * spi, (T - 1) * spi)


@pytest.fixture(scope="module")
def jax_motion():
    """A JAX ``MotionCDE`` (dim 4), its parameters, one sample and the path
    noise it drew, and the gradients of ``sum(traj * w)``."""
    m = JaxMotionCDE(dim=4)
    with jax.enable_x64(False):
        variables = jax.jit(lambda k: m.init({"params": k, "sample": k}, N, T))(
            jax.random.PRNGKey(0))
    rngs = {"sample": jax.random.PRNGKey(1)}
    traj, rec = record_noise(lambda v: m.apply(v, N, T, rngs=rngs), variables)
    (noise,) = [v for tag, v, _ in rec.log if tag == "noise"]
    w = normal(np.random.default_rng(2), N, T, 4)
    with jax.enable_x64(False):
        grads = jax.grad(lambda p: jnp.sum(
            m.apply({"params": p}, N, T, rngs=rngs) * w))(variables["params"])
    return (np_tree(variables), np.asarray(traj), noise, w,
            np_tree({"params": grads}))


def test_motion_cde_matches_jax(jax_motion):
    variables, traj, noise, w, grads = jax_motion
    m = MotionCDE(dim=4)
    m.load_state_dict(bridge.jax_to_torch(variables))
    assert noise.shape == (N, T)
    got = m(N, T, noise=torch.from_numpy(noise))
    assert got.shape == (N, T, 4)
    np.testing.assert_allclose(got.detach().numpy(), traj, **FWD)
    names = [k for k, _ in m.named_parameters()]
    g = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                            list(m.parameters()))
    got_g = bridge.torch_to_jax(dict(zip(names, g)))["params"]
    want_g = grads["params"]
    for mod in want_g:
        for layer in want_g[mod]:
            for leaf in want_g[mod][layer]:
                np.testing.assert_allclose(got_g[mod][layer][leaf],
                                           want_g[mod][layer][leaf], **GRAD,
                                           err_msg=f"{mod}/{layer}/{leaf}")


def test_motion_cde_draws_its_noise():
    m = MotionCDE(dim=4)
    m.init_parameters(torch.Generator().manual_seed(0))
    noise = m.draw_noise(N, T, torch.Generator().manual_seed(1))
    assert sorted(noise) == ["noise"] and noise["noise"].shape == (N, T)
    a = m(N, T, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, m(N, T, **noise), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown CDE motion method"):
        MotionCDE(dim=4, method="dopri5")
