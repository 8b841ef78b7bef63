"""The port's adaptive dopri5 solver, its continuous adjoint, the fixed-grid
backsolve adjoint, ``odeint_final``, ``nfe_fixed_grid`` and ``MotionODE``'s
options held against the JAX package on the CPU.

The field is the motion sampler's ``Linear -> tanh -> Linear`` with weights
made from a numpy seed (large enough that dopri5 rejects steps); both sides
run float32 (JAX under ``enable_x64(False)``, its time grid float32), so the
two controllers take the same steps: the statistics are compared for
equality. The adaptive adjoint's gradients are compared with both sides in
float64 (JAX under ``enable_x64(True)``, the port on float64 tensors, the
inputs cast up exactly): its forward and reverse solves each accept or
reject steps on an error norm near 1, and in float32 the two frameworks'
roundings of that norm can fall on either side of 1 on some hosts, which
changes every later step; in float64 they are ~1e-16 apart. Tolerances:
outputs rtol 1e-5, atol 1e-6; gradients rtol 1e-4 with an absolute floor
of 1e-5 times the largest magnitude of the tensor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ganode_tpu import ode as jode
from ganode_tpu.models.motion import MotionODE as JaxMotionODE
from ganode_tpu.nn.layers import WarmupMLP as JaxWarmup
from ganode_tpu_torch import bridge
from ganode_tpu_torch import ode
from ganode_tpu_torch.models.motion import MotionODE
from torch_parity import assert_close_tree, f64_tree, normal, np_tree

B, D, H, T = 3, 4, 8, 6
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, FLOOR = 1e-4, 1e-5
MAX_STEPS = 3          # attempts per interval for the exhaustion case
TRUNC_ATOL = 1e-3      # truncated outputs (see the exhaustion test)
FIXED = [("rk4", 2), ("midpoint", 1)]
# MotionODE option sets held against the flax module, dopri5 first
MOTION = [dict(method="dopri5"),
          dict(method="dopri5", use_warmup=False, dim_hidden=8),
          dict(method="rk4", steps_per_interval=2),
          dict(method="rk4", adjoint="backsolve"),
          dict(method="midpoint", dim_hidden=8)]


def _inputs():
    rng = np.random.default_rng(0)
    y0 = normal(rng, B, D)
    # kernel layout (in, out); scaled so that the first steps are rejected
    p = (normal(rng, D, H) * 3.0, normal(rng, H) * 0.1,
         normal(rng, H, D) * 3.0, normal(rng, D) * 0.1)
    w_out = normal(rng, T, B, D)
    return y0, p, w_out


def _jax_field(t, y, p):
    return jnp.tanh(y @ p[0] + p[1]) @ p[2] + p[3]


def _torch_params(p):
    w1, b1, w2, b2 = (torch.from_numpy(np.ascontiguousarray(a)) for a in p)
    return (w1.t().contiguous(), b1, w2.t().contiguous(), b2)


def _torch_field(t, y, p):
    return torch.tanh(y @ p[0].t() + p[1]) @ p[2].t() + p[3]


def _capture_x0(module, variables, rngs):
    """The noise the flax MotionODE drew: its warm-up MLP's input, or, with
    no warm-up, the ``ode_fn`` input at the first evaluation."""
    seen = {}

    def spy(next_fun, args, kwargs, context):
        m = context.module
        if context.method_name == "__call__" and "x0" not in seen and (
                isinstance(m, JaxWarmup) or m.name == "ode_fn"):
            seen["x0"] = np.asarray(args[0])
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(spy):
        module.apply(variables, B, T, rngs=rngs)
    return seen["x0"]


@pytest.fixture(scope="module")
def jax_run():
    y0, p, w_out = _inputs()
    out = {"inputs": (y0, p, w_out)}
    with jax.enable_x64(False):
        ts = jnp.linspace(0.0, 1.0, T, dtype=jnp.float32)
        jp = tuple(jnp.asarray(a) for a in p)
        ys, st = jode.odeint_adaptive(_jax_field, jnp.asarray(y0), ts, jp,
                                      return_stats=True)
        out["adaptive"] = np.asarray(ys), st
        ys, st = jode.odeint_adaptive(_jax_field, jnp.asarray(y0), ts, jp,
                                      max_steps=MAX_STEPS, return_stats=True)
        out["exhausted"] = np.asarray(ys), st

        for method, spi in FIXED:
            def bs_loss(y, q):
                return jnp.sum(jode.odeint_backsolve(_jax_field, y, ts, q,
                                                     method, spi) * w_out)
            ys = jode.odeint_backsolve(_jax_field, jnp.asarray(y0), ts, jp,
                                       method, spi)
            grads = jax.grad(bs_loss, (0, 1))(jnp.asarray(y0), jp)
            final = jode.odeint_final(_jax_field, jnp.asarray(y0), 0.25, 1.0,
                                      jp, method=method, num_steps=spi + 1)
            out[method] = np.asarray(ys), np_tree(grads), np.asarray(final)
        for i, opts in enumerate(MOTION):
            mod = JaxMotionODE(dim=D, **opts)
            k = jax.random.PRNGKey(i)
            variables = np_tree(mod.init({"params": k, "sample": k}, B, T))
            rngs = {"sample": jax.random.PRNGKey(10 + i)}
            x0 = _capture_x0(mod, variables, rngs)
            w = w_out.transpose(1, 0, 2)

            def m_loss(params):
                zs = mod.apply({"params": params}, B, T, rngs=rngs)
                return jnp.sum(zs * w), zs
            (_, zs), grads = jax.value_and_grad(m_loss, has_aux=True)(
                variables["params"])
            out[f"motion{i}"] = (variables, x0, np.asarray(zs), np_tree(grads))
    with jax.enable_x64(True):
        ts = jnp.linspace(0.0, 1.0, T, dtype=jnp.float64)
        y, q = f64_tree((y0, p))
        w64 = f64_tree(w_out)

        def adj64(y, q):
            ys = jode.odeint_adaptive_adjoint(_jax_field, y, ts, q)
            return jnp.sum(ys * w64), ys
        (_, ys), grads = jax.value_and_grad(adj64, (0, 1), has_aux=True)(
            jnp.asarray(y), tuple(jnp.asarray(a) for a in q))
        out["adjoint64"] = np.asarray(ys), f64_tree(grads)
    return out


def _run_adaptive(**kw):
    y0, p, _ = _inputs()
    return ode.odeint_adaptive(_torch_field, torch.from_numpy(y0),
                               torch.linspace(0.0, 1.0, T), _torch_params(p),
                               return_stats=True, **kw)


def test_dopri5_outputs_and_stats_match_jax(jax_run):
    want, want_st = jax_run["adaptive"]
    got, st = _run_adaptive()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert (st.nfe, st.n_steps, st.n_rejected) == (
        int(want_st.nfe), int(want_st.n_steps), int(want_st.n_rejected))
    assert st.n_rejected > 0 and not st.steps_exhausted
    assert not bool(want_st.steps_exhausted)
    # two syncs for the first step's size, then one per attempt
    assert st.syncs == 2 + st.n_steps + st.n_rejected
    assert st.nfe == 2 + 6 * (st.n_steps + st.n_rejected)
    assert torch.equal(got[0], torch.from_numpy(_inputs()[0]))


def test_dopri5_flags_exhausted_steps_like_jax(jax_run):
    """A truncated trajectory ends wherever its steps stopped, not on the
    output time, so it carries the first step's size further than a full
    solve does. That size comes from ``f(t0 + h0) - f(t0)``, a float32
    difference that cancels, and the two frameworks' products round
    differently (3e-6 relative in the step here): the truncated outputs are
    held to TRUNC_ATOL, the statistics to equality."""
    want, want_st = jax_run["exhausted"]
    got, st = _run_adaptive(max_steps=MAX_STEPS)
    assert st.steps_exhausted and bool(want_st.steps_exhausted)
    assert (st.nfe, st.n_steps, st.n_rejected) == (
        int(want_st.nfe), int(want_st.n_steps), int(want_st.n_rejected))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TRUNC_ATOL)
    full, _ = _run_adaptive()
    assert (got[-1] - full[-1]).abs().max() > 100 * TRUNC_ATOL


def test_dopri5_solves_a_tuple_state_and_counts_its_solves():
    y0 = torch.ones(2, dtype=torch.float64)
    ode.adaptive.tally.clear()
    (ya, yb), st = ode.odeint_adaptive(
        lambda t, y: (-y[0], 2.0 * y[1]), (y0, y0), [0.0, 0.5, 1.0],
        return_stats=True)
    assert ya.shape == yb.shape == (3, 2)
    np.testing.assert_allclose(ya[-1].numpy(), np.exp(-1.0), rtol=1e-5)
    np.testing.assert_allclose(yb[-1].numpy(), np.exp(2.0), rtol=1e-5)
    assert dict(ode.adaptive.tally) == {
        "forward_calls": 1, "forward_nfe": st.nfe,
        "forward_accepted": st.n_steps, "forward_rejected": st.n_rejected,
        "forward_syncs": st.syncs, "forward_exhausted": 0}


def test_adaptive_adjoint_gradients_match_jax(jax_run):
    y0, p, w_out = f64_tree(jax_run["inputs"])
    want_ys, (want_y, want_p) = jax_run["adjoint64"]
    y = torch.from_numpy(y0).requires_grad_()
    params = tuple(q.requires_grad_() for q in _torch_params(p))
    assert y.dtype == params[0].dtype == torch.float64
    ode.adaptive.tally.clear()
    ys = ode.odeint_adaptive_adjoint(
        _torch_field, y, torch.linspace(0.0, 1.0, T, dtype=torch.float64),
        params)
    np.testing.assert_allclose(ys.detach().numpy(), want_ys, rtol=RTOL,
                               atol=ATOL)
    grads = torch.autograd.grad((ys * torch.from_numpy(w_out)).sum(),
                                (y, *params))
    got_p = [grads[1].t(), grads[2], grads[3].t(), grads[4]]
    assert_close_tree(grads[0].numpy(), want_y, GRAD_RTOL, FLOOR, "y0")
    for i, (g, w) in enumerate(zip(got_p, want_p)):
        assert_close_tree(g.numpy(), w, GRAD_RTOL, FLOOR, f"param {i}")
    tally = ode.adaptive.tally
    assert tally["forward_calls"] == tally["backward_calls"] == 1
    assert tally["backward_syncs"] == 2 * (T - 1) + tally[
        "backward_accepted"] + tally["backward_rejected"]
    assert tally["backward_exhausted"] == 0


@pytest.mark.parametrize("method,spi", FIXED)
def test_backsolve_and_odeint_final_match_jax(jax_run, method, spi):
    y0, p, w_out = jax_run["inputs"]
    want_ys, (want_y, want_p), want_final = jax_run[method]
    y = torch.from_numpy(y0).requires_grad_()
    params = tuple(q.requires_grad_() for q in _torch_params(p))
    ts = torch.linspace(0.0, 1.0, T)
    ys = ode.odeint_backsolve(_torch_field, y, ts, params, method, spi)
    np.testing.assert_allclose(ys.detach().numpy(), want_ys, rtol=RTOL,
                               atol=ATOL)
    grads = torch.autograd.grad((ys * torch.from_numpy(w_out)).sum(),
                                (y, *params))
    assert_close_tree(grads[0].numpy(), want_y, GRAD_RTOL, FLOOR, "y0")
    for i, (g, w) in enumerate(zip(
            [grads[1].t(), grads[2], grads[3].t(), grads[4]], want_p)):
        assert_close_tree(g.numpy(), w, GRAD_RTOL, FLOOR, f"param {i}")
    with torch.no_grad():
        final = ode.odeint_final(_torch_field, torch.from_numpy(y0), 0.25,
                                 1.0, params, method=method,
                                 num_steps=spi + 1)
    np.testing.assert_allclose(final.numpy(), want_final, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("method,n,spi", [("rk4", 16, 1), ("euler", 8, 3),
                                          ("rk38", 5, 2), ("midpoint", 2, 1)])
def test_nfe_fixed_grid_and_odeint_stats_match_jax(method, n, spi):
    want = jode.nfe_fixed_grid(method, n, spi)
    assert ode.nfe_fixed_grid(method, n, spi) == want
    _, st = ode.odeint(lambda t, y: -y, torch.ones(2), torch.linspace(0, 1, n),
                       method=method, steps_per_interval=spi,
                       return_stats=True)
    assert (st.nfe, st.n_steps) == (want, (n - 1) * spi)
    assert ode.nfe_fixed_grid("rk4", 16) == 60


@pytest.mark.parametrize("i", range(len(MOTION)),
                         ids=["-".join(f"{k}={v}" for k, v in o.items())
                              for o in MOTION])
def test_motion_ode_options_match_the_flax_module(jax_run, i):
    variables, x0, want, want_grads = jax_run[f"motion{i}"]
    mod = MotionODE(D, **MOTION[i])
    mod.load_state_dict(bridge.jax_to_torch(variables), strict=True)
    assert not mod.uses_kernel
    zs = mod(B, T, x0=torch.from_numpy(np.array(x0)))
    np.testing.assert_allclose(zs.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    w = torch.from_numpy(np.ascontiguousarray(
        jax_run["inputs"][2].transpose(1, 0, 2)))
    names, params = zip(*mod.named_parameters())
    grads = torch.autograd.grad((zs * w).sum(), params)
    got = bridge.torch_to_jax(dict(zip(names, grads)))["params"]
    assert_close_tree(got, want_grads, GRAD_RTOL, FLOOR, "params")


def test_motion_ode_refuses_unknown_options():
    with pytest.raises(ValueError, match="unknown motion method"):
        MotionODE(4, method="dopri8")
    with pytest.raises(ValueError, match="unknown adjoint"):
        MotionODE(4, adjoint="direct")
    assert MotionODE(4).uses_kernel
    assert not MotionODE(4, steps_per_interval=2).uses_kernel
