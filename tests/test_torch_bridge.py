"""The parameter bridge between JAX generator variables and the port's
state_dict: exact round trips of full generator trees, and the layout rules
pinned by running one flax layer and its port on the same input.

Layer outputs are float32 convolution sums taken in another order on each
side: rtol 1e-5, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ganode_tpu.models import make_generator as jax_make_generator
from ganode_tpu.models.mocogan import _deconv as jax_deconv
from ganode_tpu_torch import bridge
from ganode_tpu_torch.models import make_generator
from ganode_tpu_torch.models.mocogan import _deconv


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), dict(tree))


def _jax_generator_variables(variant, trunk, n_channels, seed=0):
    gen = jax_make_generator(variant, n_channels=n_channels, trunk=trunk, ngf=8)
    key = jax.random.PRNGKey(seed)
    variables = _np_tree(gen.init({"params": key, "sample": key}, 2))
    # non-trivial running statistics, so the round trip carries real numbers
    rng = np.random.default_rng(seed)
    for bn in variables["batch_stats"]["main"].values():
        bn["mean"] = rng.standard_normal(bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return variables


def _assert_trees_equal(a, b, path=""):
    assert sorted(a) == sorted(b), path
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            assert a[k].shape == b[k].shape, f"{path}/{k}"
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{path}/{k}")


@pytest.mark.parametrize("variant,trunk,n_channels", [
    ("ode", "dcgan64", 3), ("gru", "mnist28", 1), ("sde", "mnist28", 1),
    ("cde", "mnist28", 1), ("ode_rnn", "mnist28", 1), ("moe_ode", "mnist28", 1)])
def test_full_generator_tree_round_trips(variant, trunk, n_channels):
    variables = _jax_generator_variables(variant, trunk, n_channels)
    gen = make_generator(variant, n_channels=n_channels, trunk=trunk, ngf=8,
                         device="cpu")
    gen.load_state_dict(bridge.jax_to_torch(variables), strict=True)
    back = bridge.torch_to_jax(gen.state_dict())
    _assert_trees_equal(variables, back)


MOTION_CHILDREN = {
    "sde": ["WarmupMLP_0", "diffusion_fn", "drift_fn"],
    "cde": ["cde_fn", "init_net"], "ode_rnn": ["gru", "ode_fn"],
    "moe_ode": ["WarmupMLP_0", "moe_fn"]}


@pytest.mark.parametrize("variant", sorted(MOTION_CHILDREN))
def test_motion_variant_trees_and_moe_layout(variant):
    """Each new sampler's children carry flax's names; the MoE field's
    stacked expert leaves keep their layout, its gate is a Dense."""
    variables = _jax_generator_variables(variant, "mnist28", 1)
    motion = variables["params"]["motion"]
    assert sorted(motion) == MOTION_CHILDREN[variant]
    sd = bridge.jax_to_torch(variables)
    if variant == "moe_ode":
        moe = motion["moe_fn"]
        assert moe["expert_w1"].shape == (4, 16, 16)
        for leaf in ("expert_w1", "expert_b1", "expert_w2", "expert_b2"):
            np.testing.assert_array_equal(
                sd[f"motion.moe_fn.{leaf}"].numpy(), moe[leaf])
        np.testing.assert_array_equal(sd["motion.moe_fn.gate.weight"].numpy(),
                                      moe["gate"]["kernel"].T)


def _random_moments(tree, rng):
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), tree)


@pytest.mark.parametrize("variant", ["ode_rnn", "moe_ode"])
def test_gan_state_round_trips_with_adam_moments(variant):
    """A whole JAX GANState of the ODE-RNN and MoE variants (tiny widths),
    its Adam moments replaced by random numbers, crosses into the port's
    state and back exactly (the SDE's and CDE's, after a step, in
    ``test_torch_variant_step.py``)."""
    from ganode_tpu.models import PatchImageDiscriminator as JaxPatchImage
    from ganode_tpu.models import VideoDiscriminator as JaxVideoD
    from ganode_tpu.train import GANTrainer as JaxTrainer
    from ganode_tpu_torch.models import (PatchImageDiscriminator,
                                         VideoDiscriminator)
    from ganode_tpu_torch.train import GANTrainer

    kw = dict(n_channels=1, trunk="mnist28", video_length=6, ngf=4,
              dim_z_content=4, dim_z_motion=4)
    tr = JaxTrainer(gen=jax_make_generator(variant, **kw),
                    dis_img=JaxPatchImage(ndf=4), dis_vid=JaxVideoD(ksize=2,
                                                                   ndf=4),
                    batch_size=2)
    with jax.enable_x64(False):
        state = jax.jit(tr.init_state)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    nets = {}
    for name in bridge.NETS:
        net = getattr(state, name)
        adam = bridge._adam_state(net.opt_state)
        mu, nu = (_random_moments(m, rng) for m in (adam.mu, adam.nu))
        opt = type(adam)(count=np.int32(3), mu=mu, nu=nu)
        nets[name] = net.replace(opt_state=(opt,), params=_np_tree(net.params))
    state = state.replace(**nets)
    port = GANTrainer(gen=make_generator(variant, device="cpu", **kw),
                      dis_img=PatchImageDiscriminator(n_channels=1, ndf=4),
                      dis_vid=VideoDiscriminator(n_channels=1, ndf=4, ksize=2),
                      batch_size=2)
    pstate = port.init_state()
    bridge.gan_state_to_torch(state, pstate)
    back = bridge.torch_gan_state_to_jax(pstate)
    for name in bridge.NETS:
        adam = bridge._adam_state(getattr(state, name).opt_state)
        _assert_trees_equal(_np_tree(getattr(state, name).params),
                            back[name]["params"], name)
        _assert_trees_equal(dict(adam.mu), back[name]["opt_state"]["mu"], name)
        _assert_trees_equal(dict(adam.nu), back[name]["opt_state"]["nu"], name)
        assert int(back[name]["opt_state"]["count"]) == 3


def test_full_width_tree_shapes():
    """ucf_ode at full width: the port's state_dict carries the JAX shapes."""
    gen = make_generator("ode", n_channels=3, trunk="dcgan64", ngf=64,
                         dim_z_content=50, dim_z_motion=16, device="cpu")
    tree = bridge.torch_to_jax(gen.state_dict())
    kernels = [tree["params"]["main"][f"ConvTranspose_{i}"]["kernel"].shape
               for i in range(5)]
    assert kernels == [(4, 4, 66, 512), (4, 4, 512, 256), (4, 4, 256, 128),
                       (4, 4, 128, 64), (4, 4, 64, 3)]
    assert sorted(tree["params"]["motion"]) == ["WarmupMLP_0", "ode_fn"]
    assert sorted(tree["batch_stats"]["main"]) == [f"BatchNorm_{i}"
                                                   for i in range(4)]


class _FlaxDeconv(nn.Module):
    features: int
    k: int
    s: int
    p: int

    @nn.compact
    def __call__(self, x):
        return jax_deconv(x, self.features, self.k, self.s, self.p)


@pytest.mark.parametrize("k,s,p", [(4, 2, 1), (4, 1, 0)])
def test_conv_transpose_kernel_flip(k, s, p):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 5, 6)).astype(np.float32)
    mod = _FlaxDeconv(features=4, k=k, s=s, p=p)
    variables = _np_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    kernel = variables["params"]["ConvTranspose_0"]["kernel"]
    assert not np.allclose(kernel, kernel[::-1, ::-1])  # the flip is visible
    want = np.asarray(mod.apply(variables, jnp.asarray(x)))
    layer = _deconv(6, 4, k, s, p)
    sd = bridge.jax_to_torch(variables)
    layer.weight.data.copy_(sd["ConvTranspose_0.weight"])
    with torch.no_grad():
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_conv_and_dense_layouts():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 3, 6)).astype(np.float32)
    conv = nn.Conv(4, (1, 1), use_bias=False)
    cv = _np_tree(conv.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    tconv = torch.nn.Conv2d(6, 4, 1, bias=False)
    tconv.weight.data.copy_(bridge.jax_to_torch(
        {"params": {"Conv_0": cv["params"]}})["Conv_0.weight"])
    dense = nn.Dense(5)
    dv = _np_tree(dense.init(jax.random.PRNGKey(2), jnp.asarray(x[:, 0, 0])))
    sd = bridge.jax_to_torch({"params": {"Dense_0": dv["params"]}})
    tdense = torch.nn.Linear(6, 5)
    tdense.load_state_dict({"weight": sd["Dense_0.weight"],
                            "bias": sd["Dense_0.bias"]})
    with torch.no_grad():
        got_c = tconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got_d = tdense(torch.from_numpy(x[:, 0, 0]))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(conv.apply(cv, x)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(dense.apply(dv, x[:, 0, 0])),
                               rtol=1e-5, atol=1e-5)


def test_unknown_entries_are_refused():
    with pytest.raises(ValueError):
        bridge.jax_to_torch({"params": {"Odd_0": {"kernel": np.zeros((2, 2))}}})
    with pytest.raises(ValueError):
        bridge.torch_to_jax({"main.Odd_0.gamma": torch.zeros(2)})
