"""The port's SDE solvers (``ganode_tpu_torch/ode/sde.py``) held against the
JAX package's on the CPU.

The drift and diffusion are tanh MLPs (dim 4, width 8, batch 3) over the
reference grid ``linspace(0, 1, 16)`` at dt 2.5e-2: 3 substeps per interval,
45 in all. The JAX solvers draw their Brownian increments inside from a key;
the port takes them as ``dW``, here JAX's own (``torch_parity.
jax_increments`` calls ``ganode_tpu.ode.sde._draw_dW`` for each substep).

Tolerances: trajectories rtol 1e-5, atol 1e-6; gradients in ``y0`` and in
the parameters (of ``sum(ys * w)`` for a fixed ``w``) rtol 1e-4, atol 1e-6.
Both sides run float32 (JAX with x64 off). The reversible adjoint's
gradients equal autograd through ``sdeint(method="reversible_heun")`` in
the port itself, float64, rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganode_tpu.ode import sde as jax_sde
from ganode_tpu_torch.ode import brownian_increments, sde, sdeint, sdeint_reversible_adjoint
from torch_parity import jax_increments, normal

B, D, H, T, DT = 3, 4, 8, 16, 2.5e-2
TS = np.linspace(0.0, 1.0, T)
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
METHODS = ["euler", "milstein", "reversible_heun"]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    p = (normal(rng, D, H) * 0.5, normal(rng, H) * 0.1,
         normal(rng, H, D) * 0.3, normal(rng, D) * 0.1,
         normal(rng, D, H) * 0.5, normal(rng, H) * 0.1,
         normal(rng, H, D) * 0.2, normal(rng, D) * 0.1)
    return normal(rng, B, D), p, normal(rng, T, B, D)


def _mlp(tanh, y, w1, b1, w2, b2):
    return tanh(y @ w1 + b1) @ w2 + b2


def _jax_fields():
    return (lambda t, y, p: _mlp(jnp.tanh, y, *p[:4]),
            lambda t, y, p: _mlp(jnp.tanh, y, *p[4:]))


def _torch_fields():
    return (lambda t, y, p: _mlp(torch.tanh, y, *p[:4]),
            lambda t, y, p: _mlp(torch.tanh, y, *p[4:]))


@pytest.fixture(scope="module")
def jax_run():
    """JAX's trajectories, stats and gradients for each method and the
    reversible adjoint, and the increments its solvers drew."""
    y0, p, w = _inputs()
    key = jax.random.PRNGKey(3)
    f, g = _jax_fields()
    out = {"dW": jax_increments(key, TS, DT, (B, D))}
    with jax.enable_x64(False):
        def loss(solve):
            return lambda y, q: jnp.sum(solve(y, q) * w)

        solves = {m: (lambda y, q, m=m: jax_sde.sdeint(
            f, g, y, TS, key, q, dt=DT, method=m)) for m in METHODS}
        solves["adjoint"] = lambda y, q: jax_sde.sdeint_reversible_adjoint(
            f, g, y, TS, key, q, dt=DT)
        for name, solve in solves.items():
            ys = np.asarray(solve(jnp.asarray(y0), p))
            gy, gp = jax.grad(loss(solve), argnums=(0, 1))(jnp.asarray(y0), p)
            out[name] = (ys, np.asarray(gy), [np.asarray(a) for a in gp])
        for m in METHODS:
            _, st = jax_sde.sdeint(f, g, jnp.asarray(y0), TS, key, p, dt=DT,
                                   method=m, return_stats=True)
            out[f"stats {m}"] = (int(st.nfe), int(st.n_steps))
        _, st = jax_sde.sdeint_reversible_adjoint(
            f, g, jnp.asarray(y0), TS, key, p, dt=DT, return_stats=True)
        out["stats adjoint"] = (int(st.nfe), int(st.n_steps))
    return out


@pytest.mark.parametrize("ts,dt", [
    (TS, DT), (TS, None), (np.linspace(0, 1, 8), 0.1), (np.arange(5.0), 0.3),
    (np.linspace(0, 2, 3), 1.0), (np.linspace(0, 1, 11), 0.1)])
def test_substeps_match_jax(ts, dt):
    assert sde._substeps(ts, dt) == jax_sde._substeps(ts, dt)
    assert sde._substeps(torch.as_tensor(ts), dt) == jax_sde._substeps(ts, dt)
    assert sde._substeps(TS, DT) == 3


def _port(name, y0, p, dW, dtype=torch.float32):
    y = torch.tensor(y0, dtype=dtype, requires_grad=True)
    q = tuple(torch.tensor(a, dtype=dtype, requires_grad=True) for a in p)
    f, g = _torch_fields()
    dW = torch.as_tensor(dW, dtype=dtype)
    if name == "adjoint":
        ys, st = sdeint_reversible_adjoint(f, g, y, TS, dW, q, dt=DT,
                                           return_stats=True)
    else:
        ys, st = sdeint(f, g, y, TS, dW, q, dt=DT, method=name,
                        return_stats=True)
    return ys, st, y, q


@pytest.mark.parametrize("name", METHODS + ["adjoint"])
def test_sdeint_matches_jax(jax_run, name):
    y0, p, w = _inputs()
    ys, st, y, q = _port(name, y0, p, jax_run["dW"])
    want_ys, want_gy, want_gp = jax_run[name]
    assert ys.shape == (T, B, D)
    np.testing.assert_allclose(ys.detach().numpy(), want_ys, **FWD)
    grads = torch.autograd.grad((ys * torch.from_numpy(w)).sum(), (y, *q))
    np.testing.assert_allclose(grads[0].numpy(), want_gy, **GRAD)
    for got, want in zip(grads[1:], want_gp):
        np.testing.assert_allclose(got.numpy(), want, **GRAD)
    assert (st.nfe, st.n_steps) == jax_run[f"stats {name}"]


def test_stats_at_the_reference_grid(jax_run):
    """45 substeps; euler 2 evaluations each, reversible Heun 2 per substep
    plus the first pair, Milstein 2 + 2 per feature (one JVP each)."""
    assert jax_run["stats euler"] == (90, 45)
    assert jax_run["stats reversible_heun"] == jax_run["stats adjoint"] == (92, 45)
    assert jax_run["stats milstein"] == ((2 + 2 * D) * 45, 45)


def test_reversible_adjoint_equals_autograd_float64():
    """The backward rebuilds each step from its output; in float64 that is
    exact to rounding, so its gradients are autograd's through the same
    scheme (rtol 1e-6)."""
    y0, p, w = _inputs(1)
    dW = brownian_increments(TS, DT, (B, D), torch.Generator().manual_seed(0),
                             dtype=torch.float64)
    ys_a, _, y_a, q_a = _port("adjoint", y0, p, dW, torch.float64)
    ys_r, _, y_r, q_r = _port("reversible_heun", y0, p, dW, torch.float64)
    torch.testing.assert_close(ys_a, ys_r, rtol=1e-12, atol=1e-12)
    wt = torch.from_numpy(w).double()
    ga = torch.autograd.grad((ys_a * wt).sum(), (y_a, *q_a))
    gr = torch.autograd.grad((ys_r * wt).sum(), (y_r, *q_r))
    for a, b in zip(ga, gr):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-12)


def test_diag_jacobian_is_the_jacobians_diagonal():
    y0, p, _ = _inputs(2)
    f, g = _torch_fields()
    y = torch.from_numpy(y0).double()
    q = tuple(torch.from_numpy(a).double() for a in p)
    got = sde._diag_jacobian(lambda t, y_: g(t, y_, q), 0.0, y)
    for b in range(B):
        jac = torch.autograd.functional.jacobian(lambda r: g(0.0, r, q), y[b])
        torch.testing.assert_close(got[b], torch.diagonal(jac), rtol=1e-12,
                                   atol=1e-12)


def test_brownian_increments_scale_and_replay():
    ts = np.linspace(0.0, 1.0, 6)
    dW = brownian_increments(ts, 0.07, (2, 3), torch.Generator().manual_seed(4))
    spi = sde._substeps(ts, 0.07)
    assert spi == 3 and dW.shape == (15, 2, 3) and dW.dtype == torch.float32
    z = torch.randn((15, 2, 3), generator=torch.Generator().manual_seed(4))
    h = np.float32(np.float32(0.2) / np.float32(3))
    torch.testing.assert_close(dW, z * float(np.sqrt(h)), rtol=1e-6, atol=0)
    again = brownian_increments(ts, 0.07, (2, 3), torch.Generator().manual_seed(4))
    assert torch.equal(dW, again)


def test_sdeint_refuses_what_it_does_not_take():
    f, g = _torch_fields()
    y0, p, _ = _inputs()
    y = torch.from_numpy(y0)
    q = tuple(torch.from_numpy(a) for a in p)
    dW = torch.zeros(45, B, D)
    with pytest.raises(ValueError, match="unknown SDE method"):
        sdeint(f, g, y, TS, dW, q, dt=DT, method="heun")
    with pytest.raises(ValueError, match="dW must have shape"):
        sdeint(f, g, y, TS, dW[:-1], q, dt=DT)
    with pytest.raises(NotImplementedError, match="diagonal"):
        sdeint(f, g, y, TS, dW, q, dt=DT, noise_type="general")
