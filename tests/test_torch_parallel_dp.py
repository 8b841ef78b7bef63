"""The port's data-parallel step (``parallel/step.py``) held against the JAX
package's single-device step, which ``tests/test_infra.py::TestParallel``
equates with its mesh step, on the CPU over gloo.

Each case builds a tiny trainer on both sides (``mnist28`` trunk, ngf = ndf
= 4, B = 8, T = 6). JAX takes one step from its init, so that the Adam
moments are non-zero, and its state is carried across
(``bridge.gan_state_to_torch``); then JAX takes a second step with its
recorders on (``torch_parallel.jax_two_steps``) and 2 port ranks take the
same step on their stripes of the same global batch, each slicing the
recorded global noise tape. Cases: the ``ode`` motion with BatchNorm
discriminators (K1's plain version on the CPU, d_iters = 2) and the ``gru``
motion (K2's plain version) fed through ``make_global_batch`` from each
rank's stripe; ``tests/test_torch_parallel_dp_wgan.py`` runs the WGAN-GP
step with spectral-norm critics, DiffAugment, ADA and EMA with these
helpers (a file of its own, so that each stays under a minute on one
worker).

Bars (``tests/test_torch_train_step.py``'s): losses rtol 1e-5 (1e-4 with a
penalty, whose double backward sums in another order); parameters,
BatchNorm statistics, spectral ``u`` and EMA rtol 1e-4 with an absolute
floor of 1e-5 times the leaf's largest magnitude (5e-5 with a penalty, as
``tests/test_torch_wgan_step.py`` measured), Adam's second moments 1e-4.
ADA's state is exact. Across ranks every metric and every tensor of the
state is equal bit for bit. The int8 serving trunk over a 'data' mesh
(``tests/test_ops.py::test_int8_trunk_shards_over_dp_mesh``'s case, dynamic
scales taken over the whole batch) equals one device bit for bit. Each rank run has a time limit of its own
(``torch_parallel.TIMEOUT_S``).
"""
import numpy as np
import pytest
import torch

import torch_parallel as tp
from torch_parity import assert_close_tree

BASE = dict(T=6, B=8, ngf=4, ndf=4, dzc=10, dzm=4)
SPECS = {
    "ode": dict(BASE, motion="ode", kw=dict(d_iters=2)),
    "wgan": dict(BASE, motion="ode", disc="sn", kw=dict(
        d_iters=2, loss="wasserstein", gp_weight=10.0, ema_decay=0.999,
        diffaug="color,translation,cutout", ada_target=0.6, ada_step=0.1)),
    "gru": dict(BASE, motion="gru", kw=dict(d_iters=1)),
}
CARRIED_P = {"p_img": 0.5, "p_vid": 0.3}
RTOL, FLOOR, FLOOR_GP, FLOOR_NU = 1e-4, 1e-5, 5e-5, 1e-4


def _run(name, tmp_path, world=2, **extra):
    spec = SPECS[name]
    ada = CARRIED_P if spec["kw"].get("ada_target") else None
    s1, s2, metrics, tape, (images, videos) = tp.jax_two_steps(spec, ada)
    payload = {"spec": spec, "state": tp.port_payload(spec, s1),
               "axes": ("data",), "shape": (world,),
               "steps": [(images, videos, tape, None)], **extra}
    return spec, s2, metrics, tp.run_ranks("step", world, payload, tmp_path)


def _check(spec, want_state, want_metrics, results):
    penalised = spec["kw"].get("gp_weight", 0) > 0
    loss_rtol = 1e-4 if penalised else 1e-5
    floor = FLOOR_GP if penalised else FLOOR
    got_metrics = results[0]["metrics"][0]
    for k, v in want_metrics.items():
        if k in ("rt_img", "rt_vid", "ada_p_img", "ada_p_vid"):
            np.testing.assert_array_equal(float(got_metrics[k]), float(v), k)
        else:
            np.testing.assert_allclose(float(got_metrics[k]), float(v),
                                       rtol=loss_rtol, err_msg=k)
    got = tp.as_jax_dict(spec, results[0]["state"])
    want = tp.net_dicts(want_state)
    assert got["step"] == int(want_state.step)
    for name, w in want.items():
        g = got[name]
        assert int(g["opt_state"]["count"]) == int(w["opt_state"]["count"])
        for part in ("params", "batch_stats", "spectral"):
            if part in w and w[part]:
                assert_close_tree(g[part], w[part], RTOL, floor,
                                  f"{name}/{part}")
        assert_close_tree(g["opt_state"]["mu"], w["opt_state"]["mu"], RTOL,
                          floor, f"{name}/mu")
        assert_close_tree(g["opt_state"]["nu"], w["opt_state"]["nu"], RTOL,
                          FLOOR_NU, f"{name}/nu")
    if want_state.ema_params is not None:
        assert_close_tree(got["ema_params"], want_state.ema_params, RTOL,
                          floor, "ema")
    if want_state.ada is not None:
        for k, v in want_state.ada.items():
            np.testing.assert_array_equal(np.asarray(got["ada"][k]),
                                          np.asarray(v), k)
    tp.assert_ranks_bitwise(results)
    tp.assert_metrics_bitwise(results)


@pytest.fixture(scope="module")
def ode_run(tmp_path_factory):
    return _run("ode", tmp_path_factory.mktemp("dp_ode"))


def test_dp_ode_step_matches_jax(ode_run):
    spec, want_state, want_metrics, results = ode_run
    _check(spec, want_state, want_metrics, results)


def test_two_ranks_report_bit_identical_metrics(ode_run):
    """The metrics are reduced over the group: both ranks print the same
    bits, and each rank moved the gradients once per update over one flat
    buffer (d_iters = 2: 2 + 2 + 1 updates, one all-reduce each, besides
    the BatchNorm sums and the metrics)."""
    results = ode_run[3]
    tp.assert_metrics_bitwise(results)
    assert sorted(results[0]["metrics"][0]) == [
        "dis_img_loss", "dis_vid_loss", "gen_loss"]
    tally = results[0]["tally"][0]
    assert tally["all_reduce_calls"] > 5 and tally["bytes"] > 0
    moved = lambda t: {k: v for k, v in t.items()
                       if k.endswith(("_calls", "bytes"))}
    assert moved(tally) == moved(results[1]["tally"][0])
    assert tally["seconds"] > 0



def test_make_global_batch_feeds_the_dp_gru_step(tmp_path):
    """Each rank's stripe, assembled with ``make_global_batch`` into its
    shard of the global batch (a DTensor split over 'data'), feeds the
    step; the ``gru`` motion runs K2's plain version."""
    spec, want_state, want_metrics, results = _run(
        "gru", tmp_path, make_global_batch=True)
    B, T = spec["B"], spec["T"]
    assert results[0]["global_shape"] == (1, B, T, 28, 28, 1)
    assert "Shard(dim=1)" in results[0]["placements"]
    _check(spec, want_state, want_metrics, results)


def test_mesh_and_placements(tmp_path):
    """``make_mesh`` over the group (and its refusals), and the placements
    of ``tests/test_infra.py``'s TestParallel: the batch over 'data', clips
    over 'data' and 'seq', TP on the last dim of large parameters, EP on
    stacked experts, replication."""
    results = tp.run_ranks("placements", 4, {}, tmp_path)
    for r, res in enumerate(results):
        assert res["batch"] == ("[Shard(dim=1)]", (2, 4, 4, 4, 1))
        assert res["seq"] == ("[Shard(dim=1), Shard(dim=2)]",
                              (2, 8, 4, 4, 4, 1))
        assert res["tp_big"] == ("[Replicate(), Shard(dim=3)]",
                                 (4, 4, 64, 64))
        assert res["tp_small"][0] == "[Replicate(), Replicate()]"
        assert res["ep"] == ("[Replicate(), Shard(dim=0)]", (2, 16, 16))
        assert res["ep_gate"][0] == "[Replicate(), Replicate()]"
        assert res["replicated"] == 0.0   # rank 0's value everywhere
        assert "a mesh of 8 ranks" in res["mismatch"]
        assert "'tensor'" in res["bad_axis"]


def test_make_mesh_without_a_process_group_raises():
    from ganode_tpu_torch.parallel import make_mesh

    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh(2)


def test_int8_trunk_over_a_data_mesh_equals_one_device(tmp_path):
    from ganode_tpu_torch.models.mocogan import DCGANTrunk64
    from ganode_tpu_torch.ops import quant

    trunk = DCGANTrunk64(n_channels=3, ngf=8, dim_z=14)
    trunk.init_parameters(torch.Generator().manual_seed(1))
    qstate = quant.quantize_trunk("dcgan64", trunk.eval())
    z = torch.randn((16, 14), generator=torch.Generator().manual_seed(0))
    single = quant.int8_trunk_apply("dcgan64", qstate, z)
    payload = {"z": z.numpy(), "qstate": {"layers": [
        {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in l.items()}
        for l in qstate["layers"]]}}
    for res in tp.run_ranks("int8_dp", 4, payload, tmp_path):
        assert torch.equal(res["frames"], single)
