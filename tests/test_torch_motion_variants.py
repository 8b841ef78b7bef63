"""The port's ``MoEField`` and its SDE, MoE-ODE and ODE-RNN motion samplers
held against the JAX package's on the CPU.

Each JAX module is initialised from a key and run once; the noise it drew
is recorded (``torch_parity.record_noise``: the ``WarmupMLP`` input ``x0``,
the SDE's Brownian key turned into ``dW``; for the ODE-RNN ``h0`` from the
first ``odeint_final`` call and ``e_t`` from each GRU cell call) and fed to
the port's module, whose weights are JAX's through ``bridge.jax_to_torch``.
Sizes: dim 4, width 8, batch 3, T 8 (the SDE at dt 2.5e-2: 6 substeps per
interval).

Tolerances: trajectories and field values rtol 1e-5, atol 1e-6; gradients
of ``sum(out * w)`` for a fixed ``w`` in every parameter (and the field's
input) rtol 1e-4 with an absolute floor of 1e-6 times the leaf's largest
value (``torch_parity.assert_close_tree``). Both sides run float32 (JAX
with x64 off).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import ganode_tpu.ode as jax_ode
from ganode_tpu.models.motion import MotionMoEODE as JaxMotionMoEODE
from ganode_tpu.models.motion import MotionODERNN as JaxMotionODERNN
from ganode_tpu.models.motion import MotionSDE as JaxMotionSDE
from ganode_tpu.nn.layers import GRUCell as JaxGRUCell
from ganode_tpu.nn.moe import MoEField as JaxMoEField
from ganode_tpu_torch import bridge
from ganode_tpu_torch.models import MotionMoEODE, MotionODERNN, MotionSDE
from ganode_tpu_torch.nn import MoEField
from torch_parity import (assert_close_tree, jax_increments, normal, np_tree,
                          record_noise)

N, D, H, T = 3, 4, 8, 8
FWD = dict(rtol=1e-5, atol=1e-6)
RTOL, FLOOR = 1e-4, 1e-6


def _params_grads(module, out, w):
    """Gradients of ``sum(out * w)`` in ``module``'s parameters, as a JAX
    params tree."""
    names = [k for k, _ in module.named_parameters()]
    g = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                            list(module.parameters()))
    return bridge.torch_to_jax(dict(zip(names, g)))["params"]


def _jax_init(m, *args):
    with jax.enable_x64(False):
        return np_tree(jax.jit(lambda k: m.init(
            {"params": k, "sample": k}, *args))(jax.random.PRNGKey(0)))


# ------------------------------------------------------------------ MoEField
def _tied(variables):
    """Gate columns 0 and 1 equal and well above the rest: every row's top
    two logits tie."""
    p = variables["params"]["gate"]
    p["kernel"][:, 1] = p["kernel"][:, 0]
    p["bias"][:] = np.array([5.0, 5.0, 0.0, 0.0], np.float32)
    return variables


@pytest.mark.parametrize("top_k,tie", [(0, False), (1, False), (2, False),
                                       (1, True)])
def test_moe_field_matches_jax(top_k, tie):
    m = JaxMoEField(dim=D, dim_hidden=H, n_experts=4, top_k=top_k)
    rng = np.random.default_rng(top_k)
    y, w = normal(rng, 5, D), normal(rng, 5, D)
    variables = _jax_init(m, jnp.zeros((5, D)))
    if tie:
        variables = _tied(variables)
    with jax.enable_x64(False):
        want = np.asarray(m.apply(variables, y))
        gp, gy = jax.grad(lambda p, x: jnp.sum(
            m.apply({"params": p}, x) * w), argnums=(0, 1))(
            variables["params"], jnp.asarray(y))
    port = MoEField(D, H, 4, top_k)
    port.load_state_dict(bridge.jax_to_torch(variables))
    yt = torch.tensor(y, requires_grad=True)
    out = port(yt)
    np.testing.assert_allclose(out.detach().numpy(), want, **FWD)
    names = [k for k, _ in port.named_parameters()]
    g = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                            [yt, *port.parameters()])
    assert_close_tree(bridge.torch_to_jax(dict(zip(names, g[1:])))["params"],
                      np_tree(gp), RTOL, FLOOR)
    assert_close_tree(g[0].numpy(), np.asarray(gy), RTOL, FLOOR)
    if tie:  # JAX's threshold rule keeps both tied experts
        logits = port.gate(yt)
        kth = torch.sort(logits, dim=-1).values[..., -1, None]
        assert bool(((logits >= kth).sum(-1) == 2).all())


def test_moe_field_initialisation_distribution():
    """Per-expert fan-in truncated normal, as flax's variance scaling with the
    expert axis as a batch axis: std 1/sqrt(fan_in), cut at 2 std of the
    untruncated normal."""
    port = MoEField(64, 32, 8)
    port.init_parameters(torch.Generator().manual_seed(0))
    for w, fan_in in ((port.expert_w1, 64), (port.expert_w2, 32)):
        std = 1.0 / np.sqrt(fan_in)
        assert abs(float(w.std()) / std - 1.0) < 0.05
        assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6
    assert float(port.expert_b1.abs().max()) == 0.0
    jax_w = _jax_init(JaxMoEField(dim=64, dim_hidden=32, n_experts=8),
                      jnp.zeros((1, 64)))["params"]["expert_w1"]
    assert abs(jax_w.std() / float(port.expert_w1.std()) - 1.0) < 0.05


# ------------------------------------------------------------------ samplers
def _jax_sample(m, variables, w, record=record_noise):
    """JAX's trajectory, the log of the noise it drew, and its gradients."""
    rngs = {"sample": jax.random.PRNGKey(1)}
    traj, rec = record(lambda v: m.apply(v, N, T, rngs=rngs), variables)
    with jax.enable_x64(False):
        grads = jax.grad(lambda p: jnp.sum(
            m.apply({"params": p}, N, T, rngs=rngs) * w))(variables["params"])
    return np.asarray(traj), rec, np_tree(grads)


def _check(port, variables, traj, noise, w, grads):
    port.load_state_dict(bridge.jax_to_torch(variables))
    got = port(N, T, **{k: torch.from_numpy(v) for k, v in noise.items()})
    assert got.shape == (N, T, D)
    np.testing.assert_allclose(got.detach().numpy(), traj, **FWD)
    assert_close_tree(_params_grads(port, got, w), grads, RTOL, FLOOR)


@pytest.mark.parametrize("method", ["euler", "milstein", "reversible_heun",
                                    "reversible_heun_adjoint"])
def test_motion_sde_matches_jax(method):
    m = JaxMotionSDE(dim=D, dim_hidden=H, method=method)
    variables = _jax_init(m, N, T)
    w = normal(np.random.default_rng(3), N, T, D)
    traj, rec, grads = _jax_sample(m, variables, w)
    # the warm-up net's input, then the solver's key; the trajectory last
    assert [tag for tag, _, _ in rec.log] == ["x0", "dW", "traj"]
    noise = {"x0": rec.log[0][1],
             "dW": jax_increments(rec.log[1][1], *rec.log[1][2])}
    assert noise["dW"].shape == ((T - 1) * 6, N, D)
    _check(MotionSDE(D, H, method=method), variables, traj, noise, w, grads)


@pytest.mark.parametrize("options", [
    {}, {"adjoint": "backsolve"}, {"method": "dopri5"},
    {"method": "midpoint", "steps_per_interval": 2}, {"top_k": 1}])
def test_motion_moe_ode_matches_jax(options):
    m = JaxMotionMoEODE(dim=D, dim_hidden=H, n_experts=3, **options)
    variables = _jax_init(m, N, T)
    w = normal(np.random.default_rng(4), N, T, D)
    traj, rec, grads = _jax_sample(m, variables, w)
    assert [tag for tag, _, _ in rec.log] == ["x0", "traj"]
    noise = {"x0": rec.log[0][1]}
    port = MotionMoEODE(D, H, n_experts=3, **options)
    _check(port, variables, traj, noise, w, grads)


class _RNNRecorder:
    """``h0`` (the first ``odeint_final`` state) and each step's ``e_t`` (a
    GRU cell's input) of a JAX ``MotionODERNN``, in program order."""

    def __init__(self):
        self.log = []

    def _keep(self, tag, value):
        jax.debug.callback(lambda a: self.log.append((tag, np.asarray(a))),
                           value, ordered=True)

    def __call__(self, next_fun, args, kwargs, context):
        if isinstance(context.module, JaxGRUCell):
            self._keep("e", args[1])
        return next_fun(*args, **kwargs)

    def noise(self):
        h = [v for tag, v in self.log if tag == "h"]
        e = [v for tag, v in self.log if tag == "e"]
        return {"h0": h[0], "e": np.stack(e)}


def _record_rnn(fn, *args):
    rec = _RNNRecorder()

    def final(func, y0, *a, _f=jax_ode.odeint_final, **kw):
        rec._keep("h", y0)
        return _f(func, y0, *a, **kw)

    with pytest.MonkeyPatch.context() as mp, nn.intercept_methods(rec), \
            jax.enable_x64(False):
        mp.setattr(jax_ode, "odeint_final", final)
        out = jax.block_until_ready(fn(*args))
        jax.effects_barrier()
    return out, rec


@pytest.mark.parametrize("method,steps", [("rk4", 1), ("midpoint", 2)])
def test_motion_ode_rnn_matches_jax(method, steps):
    m = JaxMotionODERNN(dim=D, dim_hidden=H, method=method, solve_steps=steps)
    variables = _jax_init(m, N, T)
    w = normal(np.random.default_rng(5), N, T, D)
    traj, rec, grads = _jax_sample(m, variables, w, record=_record_rnn)
    noise = rec.noise()
    assert noise["h0"].shape == (N, D) and noise["e"].shape == (T, N, D)
    port = MotionODERNN(D, H, method=method, solve_steps=steps)
    _check(port, variables, traj, noise, w, grads)


@pytest.mark.parametrize("cls,options,keys", [
    (MotionSDE, {}, ["dW", "x0"]),
    (MotionSDE, {"method": "reversible_heun_adjoint", "dt": 0.1}, ["dW", "x0"]),
    (MotionMoEODE, {"top_k": 2}, ["x0"]),
    (MotionODERNN, {}, ["e", "h0"])])
def test_samplers_replay_their_drawn_noise(cls, options, keys):
    """``draw_noise`` returns what one call consumes: a call drawing from a
    generator equals the call given what ``draw_noise`` drew from the same
    seed."""
    port = cls(D, **options)
    port.init_parameters(torch.Generator().manual_seed(0))
    noise = port.draw_noise(N, T, torch.Generator().manual_seed(1))
    assert sorted(noise) == keys
    drawn = port(N, T, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(drawn, port(N, T, **noise), rtol=0, atol=0)


def test_samplers_refuse_unknown_options():
    with pytest.raises(ValueError, match="unknown SDE motion method"):
        MotionSDE(D, method="heun")
    with pytest.raises(ValueError, match="unknown motion method"):
        MotionMoEODE(D, method="rk5")
    with pytest.raises(ValueError, match="unknown adjoint"):
        MotionMoEODE(D, adjoint="discrete")
    with pytest.raises(ValueError, match="unknown ODE-RNN motion method"):
        MotionODERNN(D, method="dopri5")
