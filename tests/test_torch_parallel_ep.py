"""The port's expert-parallel step (``parallel/step.py``, mesh ``data=2,
expert=2``: 4 gloo ranks on the CPU) held against the JAX package's
single-device step, which ``tests/test_infra.py::TestParallel::
test_ep_step_matches_single_device`` equates with its EP mesh step.

A tiny ``moe_ode`` trainer (4 experts, ``mnist28``, ngf = ndf = 4, B = 8,
T = 6, d_iters = 1) from a carried-across JAX state
(``torch_parallel.jax_two_steps``). Each rank holds 2 of the 4 experts'
stacked parameters, their Adam moments and nothing of the other two; it
computes its experts' share of the gated combine and all-reduces it over
the 'expert' group. The test gathers the expert slices back and holds the
whole state against JAX's.

Bars: those of ``tests/test_torch_parallel_dp.py`` (losses rtol 1e-5;
parameters, statistics and first moments rtol 1e-4 with a floor of 1e-5 of
the leaf's largest magnitude, second moments 1e-4); ranks equal bit for bit
in everything they replicate.
"""
import pytest
import torch

import test_torch_parallel_dp as dp
import torch_parallel as tp

SPEC = dict(dp.BASE, motion="moe_ode", n_experts=4, kw=dict(d_iters=1))


@pytest.fixture(scope="module")
def ep_run(tmp_path_factory):
    s1, s2, metrics, tape, (images, videos) = tp.jax_two_steps(SPEC)
    payload = {"spec": SPEC, "state": tp.port_payload(SPEC, s1),
               "axes": ("data", "expert"), "shape": (2, 2),
               "steps": [(images, videos, tape, None)]}
    return s2, metrics, tp.run_ranks("step", 4, payload,
                                     tmp_path_factory.mktemp("ep"))


def test_each_rank_holds_only_its_experts(ep_run):
    dzm = SPEC["dzm"]
    for res in ep_run[2]:
        assert res["local_expert_w1"] == (2, dzm, dzm)
    # ranks 0 and 1 share data stripe 0 and own experts {0, 1} and {2, 3}:
    # their gathered tensors agree, and the batch splits over 'data' only
    a, b = ep_run[2][0], ep_run[2][1]
    assert a["local_shapes"] == b["local_shapes"]
    assert a["local_shapes"][1][1] == SPEC["B"] // 2


def test_ep_step_matches_jax(ep_run):
    want_state, want_metrics, results = ep_run
    dp._check(SPEC, want_state, want_metrics, results)


def test_expert_moments_are_sharded(ep_run):
    """The gathered first moment of ``expert_w1`` is whole: each half came
    from the rank that owns those experts, none is zero."""
    key = "gen.adam.motion.moe_fn.expert_w1.exp_avg"
    m = ep_run[2][0]["state"][key]
    assert m.shape[0] == 4
    assert all(torch.any(m[i] != 0) for i in range(4))
