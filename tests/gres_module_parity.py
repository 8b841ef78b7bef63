"""Helpers of the GResBlock module parity tests (``test_torch_gres.py``
for the blocks, ``test_torch_gres_trunk.py`` for the ``gres64`` /
``odegres64`` trunks): the modules, their JAX side compiled once per file,
and the checks both files run.

Each JAX module is initialised by its own init and its variables cross
through the bridge; inputs are made with numpy from a seed; JAX runs float32
(x64 off). A train-mode case compares the output, the advanced running
statistics and ``u`` state, and the gradients of ``sum(out * w)`` with
respect to the parameters, the input and the condition; an eval-mode case
runs on the state the train-mode call left. Tolerances: forward rtol 1e-4
with atol 1e-5 (conv sums in another order on each side), statistics and
``u`` the same, gradients rtol 1e-4 with an absolute floor of 1e-5 times the
largest magnitude of the tensor (inputs) or of all the module's parameter
gradients (BatchNorm's backward removes the per-channel mean of the gradient
it passes on, so the bias of a conv before it has a gradient that cancels to
rounding noise on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from ganode_tpu.models import mocogan as jm
from ganode_tpu.nn import gresblock as jg
from ganode_tpu.nn import norm as jn
from ganode_tpu_torch import bridge
from ganode_tpu_torch.models import mocogan as tm
from ganode_tpu_torch.nn import (ConditionalNorm, GResBlock, ODEGResBlock)
from torch_parity import (FAST_COMPILE, assert_close_tree, f64_tree, normal,
                          np_tree)

RTOL, ATOL, FLOOR = 1e-4, 1e-5, 1e-5
N, NC, NGF, DZ = 6, 5, 4, 10


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def lone_state_dict(variables, name="m"):
    """A lone module's JAX variables -> its own ``state_dict`` (the bridge
    maps module paths, so the variables go in under ``name``)."""
    nested = {c: {name: v} for c, v in variables.items()}
    return {k.split(".", 1)[1]: v
            for k, v in bridge.jax_to_torch(nested).items()}


def jax_tree(state, name="m"):
    """A lone module's port tensors (a ``state_dict`` or gradients by
    parameter name) -> JAX variables."""
    out = bridge.torch_to_jax({f"{name}.{k}": v for k, v in state.items()})
    return {c: v[name] for c, v in out.items()}


# name -> (JAX module, port module, input (N, H, W, C), call with a condition)
MODULES = {
    "cbn": (lambda: jn.ConditionalNorm(6), lambda: ConditionalNorm(6, NC),
            (N, 4, 4, 6), True),
    "gres_up": (lambda: jg.GResBlock(5, n_condition=NC),
                lambda: GResBlock(6, 5, n_condition=NC), (N, 4, 4, 6), True),
    "gres_down": (lambda: jg.GResBlock(5, n_condition=NC, upsample_factor=1,
                                       downsample_factor=2),
                  lambda: GResBlock(6, 5, n_condition=NC, upsample_factor=1,
                                    downsample_factor=2), (N, 8, 8, 6), True),
    "gres_no_bn": (lambda: jg.GResBlock(5, use_bn=False),
                   lambda: GResBlock(6, 5, use_bn=False), (N, 4, 4, 6), False),
    "ode_pad": (lambda: jg.ODEGResBlock(4, 6, NC, num_steps=2),
                lambda: ODEGResBlock(4, 6, NC, num_steps=2), (N, 4, 4, 4),
                True),
    "ode_equal": (lambda: jg.ODEGResBlock(6, 6, NC, num_steps=2),
                  lambda: ODEGResBlock(6, 6, NC, num_steps=2), (N, 4, 4, 6),
                  True),
    "ode_proj_down": (lambda: jg.ODEGResBlock(8, 4, NC, num_steps=2),
                      lambda: ODEGResBlock(8, 4, NC, num_steps=2),
                      (N, 4, 4, 8), True),
    "gres64": (lambda: jm.GResTrunk64(3, NGF),
               lambda: tm.GResTrunk64(3, NGF, DZ), (N, DZ), False),
    "odegres64": (lambda: jm.TRUNKS["odegres64"](3, NGF),
                  lambda: tm.TRUNKS["odegres64"](3, NGF, DZ), (N, DZ), False),
}


def _args(x, c, trunk):
    return (x[:, None, None, :],) if trunk else (x,) + ((c,) if c is not None
                                                       else ())


def _jax_train(mod, v, w, *args):
    """A train-mode call on ``v`` -> (output, the state it left, the
    gradients of ``sum(out * w)`` with respect to the params and ``args``)."""
    extras = {k: a for k, a in v.items() if k != "params"}

    def loss(p, *a):
        y, mut = mod.apply({"params": p, **extras}, *a, train=True,
                           mutable=list(extras))
        return jnp.sum(y * w), (y, mut)

    (_, (y, mut)), grads = jax.value_and_grad(
        loss, argnums=tuple(range(1 + len(args))), has_aux=True)(
            v["params"], *args)
    return y, {"params": v["params"], **mut}, grads


def _jax_case(mod, key, w, *args):
    """One module's whole JAX side, in one compiled function: init, a
    train-mode call with its gradients, then eval mode on the state it
    left."""
    v = mod.init(key, *args, train=False)
    y, after, grads = _jax_train(mod, v, w, *args)
    return v, y, after, grads, mod.apply(after, *args, train=False)


BLOCKS = [n for n, m in MODULES.items() if len(m[2]) == 4]
TRUNKS = [n for n, m in MODULES.items() if len(m[2]) == 2]


def jax_cases(names):
    """Per module of ``names``: variables, inputs, the train-mode output,
    the variables after it, the gradients, and the eval-mode output on those
    variables; for the ``odegres64`` trunk also the gradients in float64
    (JAX x64, the same float32 variables and inputs cast up). Every module's
    inputs are drawn, in ``MODULES``' order from one seed, whichever are
    compiled."""
    rng = np.random.default_rng(0)
    out = {}
    for i, (name, (jmod, _, shape, cond)) in enumerate(MODULES.items()):
        mod, trunk = jmod(), len(shape) == 2
        x = normal(rng, *shape)
        c = normal(rng, N, NC) if cond else None
        with jax.enable_x64(False):
            args = _args(jnp.asarray(x), None if c is None else
                         jnp.asarray(c), trunk)
            key = jax.random.PRNGKey(i)
            y_shape = jax.eval_shape(
                lambda k, *a: mod.init_with_output(k, *a, train=False)[0],
                key, *args).shape
            w = normal(rng, *y_shape)
            if name not in names:
                continue
            compiled = jax.jit(
                lambda k, w_, *a: _jax_case(mod, k, w_, *a)).lower(
                    key, w, *args).compile(compiler_options=FAST_COMPILE)
            v, y, after, grads, y_eval = np_tree(compiled(key, w, *args))
        out[name] = dict(v=v, x=x, c=c, w=w, y=y, after=after, grads=grads,
                         y_eval=y_eval)
        if name == "odegres64":
            with jax.enable_x64(True):
                grads64 = jax.jit(
                    lambda v_, w_, *a: _jax_train(mod, v_, w_, *a)[2]).lower(
                        f64_tree(v), f64_tree(w), *f64_tree(args)).compile(
                            compiler_options=FAST_COMPILE)(
                                f64_tree(v), f64_tree(w), *f64_tree(args))
            out[name]["grads"] = f64_tree(grads64)
    return out


def port_module(name, variables):
    mod = MODULES[name][1]()
    mod.load_state_dict(lone_state_dict(variables), strict=True)
    return mod


def port_inputs(r, trunk):
    x = (torch.from_numpy(r["x"]) if trunk else nchw(r["x"])).requires_grad_()
    c = None if r["c"] is None else torch.from_numpy(r["c"]).requires_grad_()
    return x, c


def _assert_grads(got, want):
    """Parameter gradients leaf by leaf, rtol RTOL, with an absolute floor
    of FLOOR times the largest gradient of the whole module: the bias of a
    conv that feeds a BatchNorm has a gradient of exactly zero in exact
    arithmetic, so both sides give rounding noise there, whose scale is
    that of the module's gradients, not of the leaf's."""
    scale = max(float(np.abs(a).max()) for a in jax.tree_util.tree_leaves(want))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(flat_got[path], w, rtol=RTOL,
                                   atol=FLOOR * scale,
                                   err_msg=jax.tree_util.keystr(path))
    assert len(flat_got) == len(jax.tree_util.tree_leaves(want))


def _call(mod, x, c, trunk):
    y = mod(x) if trunk or c is None else mod(x, c)
    return nhwc(y), y


def check_train_mode(r, name):
    """Output, advanced statistics and ``u``, and gradients in train mode."""
    trunk = name in TRUNKS
    mod = port_module(name, r["v"]).train()
    x, c = port_inputs(r, trunk)
    y_np, y = _call(mod, x, c, trunk)
    np.testing.assert_allclose(y_np, r["y"], rtol=RTOL, atol=ATOL)
    after = jax_tree(mod.state_dict())
    for part in ("batch_stats", "spectral"):
        if part in r["after"]:
            assert_close_tree(after[part], r["after"][part], RTOL, FLOOR, part)
    params = dict(mod.named_parameters())
    inputs = [x] + ([c] if c is not None else [])
    # the down block takes the condition and uses none of it: zeros in JAX
    got = [torch.zeros_like(t) if g is None else g for g, t in zip(
        torch.autograd.grad((y * nchw(r["w"])).sum(),
                            list(params.values()) + inputs, allow_unused=True),
        list(params.values()) + inputs)]
    g_params = jax_tree(dict(zip(params, got[:len(params)])))["params"]
    _assert_grads(g_params, r["grads"][0])
    g_x = got[len(params)].numpy() if trunk else nhwc(got[len(params)])
    want_x = r["grads"][1].reshape(g_x.shape)
    assert_close_tree(g_x, want_x, RTOL, FLOOR, "x")
    if c is not None:
        assert_close_tree(got[-1].numpy(), r["grads"][2], RTOL, FLOOR, "c")


def check_eval_mode(r, name):
    """Eval mode on the state the train-mode call left: running statistics
    in the conditional norms, ``u`` not advanced (the ODE field's norm still
    on batch statistics)."""
    trunk = name in TRUNKS
    mod = port_module(name, r["after"]).eval()
    before = {k: v.clone() for k, v in mod.state_dict().items()}
    x, c = port_inputs(r, trunk)
    with torch.no_grad():
        y_np, _ = _call(mod, x, c, trunk)
    np.testing.assert_allclose(y_np, r["y_eval"], rtol=RTOL, atol=ATOL)
    for k, v in mod.state_dict().items():
        assert torch.equal(v, before[k]), k


def check_round_trip(r, name):
    """The module's JAX variables through the bridge and back, unchanged."""
    back = jax_tree(port_module(name, r["v"]).state_dict())
    assert_close_tree(back, r["v"], 0.0, 0.0, name)
