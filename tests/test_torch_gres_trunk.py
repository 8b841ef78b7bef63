"""The port's ``gres64`` / ``odegres64`` trunks (``models/mocogan.py``
``GResTrunk64``) held against the JAX package on the CPU, in train and
eval mode, with their batch dependence, the bridge's new leaves and the
bf16 configs. The blocks are in ``test_torch_gres.py``; the method and
tolerances in ``gres_module_parity.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganode_tpu.models import mocogan as jm
from ganode_tpu_torch import bridge
from ganode_tpu_torch.models import generator_for_config
from ganode_tpu_torch.utils.config import get_config
from gres_module_parity import (ATOL, N, NGF, RTOL, TRUNKS, check_eval_mode,
                                check_round_trip, check_train_mode, jax_cases,
                                nhwc, port_module)
from torch_parity import FAST_COMPILE, normal


@pytest.fixture(scope="module")
def jax_run():
    return jax_cases(TRUNKS)


@pytest.mark.parametrize("name", TRUNKS)
def test_train_mode_matches_jax(jax_run, name):
    check_train_mode(jax_run[name], name)


@pytest.mark.parametrize("name", TRUNKS)
def test_eval_mode_matches_jax(jax_run, name):
    check_eval_mode(jax_run[name], name)


def test_odegres64_eval_output_depends_on_the_batch_as_jax(jax_run):
    """The ODE field normalises by the batch's statistics in eval mode too:
    the first three frames decoded alone differ from the same frames decoded
    among six, in JAX and in the port alike, and the port matches JAX at
    each n."""
    r = jax_run["odegres64"]
    mod = jm.TRUNKS["odegres64"](3, NGF)
    z = jnp.asarray(r["x"][:3])[:, None, None, :]
    with jax.enable_x64(False):
        alone = np.asarray(jax.jit(
            lambda v, z_: mod.apply(v, z_, train=False)).lower(
                r["after"], z).compile(compiler_options=FAST_COMPILE)(
                    r["after"], z))
    assert np.abs(alone - r["y_eval"][:3]).max() > 1e-3
    port = port_module("odegres64", r["after"]).eval()
    with torch.no_grad():
        got = nhwc(port(torch.from_numpy(r["x"][:3])))
    np.testing.assert_allclose(got, alone, rtol=RTOL, atol=ATOL)

@pytest.mark.parametrize("name", TRUNKS)
def test_bridge_round_trips_every_new_leaf(jax_run, name):
    check_round_trip(jax_run[name], name)
    if name == "odegres64":
        leaves = {path[-1] for path, _ in bridge._leaves(jax_run[name]["v"])}
        assert {"k0", "k1", "b0", "b1", "embed_gamma", "embed_gamma_b",
                "embed_beta", "u0", "u1", "u", "mean", "var"} <= leaves


@pytest.mark.parametrize("name", ["ucf_gres", "ucf_odegres"])
def test_bfloat16_config_runs_the_trunk_in_float32(name):
    """``GResTrunk64`` never uses its dtype: under compute_dtype=bfloat16
    the trunk's frames equal the float32 config's."""
    small = dict(ngf=NGF, dim_z_content=6, dim_z_motion=4)
    z = torch.from_numpy(normal(np.random.default_rng(2), N, 10))
    frames = []
    for dtype in ("float32", "bfloat16"):
        gen = generator_for_config(get_config(name, compute_dtype=dtype,
                                              **small), device="cpu")
        with torch.no_grad():
            frames.append(gen.main(z))
    assert frames[0].dtype == frames[1].dtype == torch.float32
    assert torch.equal(frames[0], frames[1])
