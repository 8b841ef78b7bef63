"""The port's reference-checkpoint importer (``ganode_tpu_torch.compat_torch``)
against the JAX package's (``ganode_tpu.compat_torch``) followed by the
bridge (``bridge.gan_state_to_torch``).

The reference repository is not needed: ``tests/reference_ckpt.py`` writes a
synthetic reference checkpoint (seeded values in the reference's layouts and
key names, Adam moments included, the ODE variants' unused ``recurrent`` GRU
without Adam state) and holds it to JAX's importer first. Then the port's
``import_gan_state`` must equal JAX's import carried across by the bridge
exactly: every parameter, BatchNorm buffer, Adam moment and step,
``state.step`` and the EMA. These are the port's counterparts of
``tests/test_compat_torch.py``'s ``TestImportGANState`` and
``TestOptimizerImport``, which execute the reference repository.
"""
import numpy as np
import pytest
import torch

from ganode_tpu_torch import bridge
from ganode_tpu_torch.compat_torch import (import_gan_state,
                                           load_reference_checkpoint)
from ganode_tpu_torch.train import build_trainer
from ganode_tpu_torch.utils.config import get_config
from reference_ckpt import check_with_jax, synthetic_reference

TINY = dict(ngf=8, ndf=8, batch_size=2)
CONFIGS = ["mnist_ode", "mnist_gru", "mnist_sde", "mnist_cde",
           "mnist_ode_rnn", "ucf_ode"]


def _port_state(name, **overrides):
    cfg = get_config(name, **{**TINY, **overrides})
    return cfg, build_trainer(cfg, device="cpu").init_state()


def _adam(net):
    """Per parameter (step, exp_avg, exp_avg_sq); a parameter without Adam
    state has torch's initial one, step 0 and zero moments."""
    out = {}
    for key, p in net.module.named_parameters():
        s = net.opt.state.get(p)
        out[key] = ((float(s["step"]), s["exp_avg"], s["exp_avg_sq"]) if s
                    else (0.0, torch.zeros_like(p), torch.zeros_like(p)))
    return out


def assert_states_equal(got, want):
    for name in ("gen", "dis_img", "dis_vid"):
        g, w = getattr(got, name), getattr(want, name)
        gs, ws = g.module.state_dict(), w.module.state_dict()
        assert gs.keys() == ws.keys()
        for k in gs:
            assert gs[k].dtype == ws[k].dtype and torch.equal(gs[k], ws[k]), \
                f"{name}.{k}"
        ga, wa = _adam(g), _adam(w)
        for k in ga:
            assert ga[k][0] == wa[k][0], f"{name}.{k} step"
            assert torch.equal(ga[k][1], wa[k][1]), f"{name}.{k} exp_avg"
            assert torch.equal(ga[k][2], wa[k][2]), f"{name}.{k} exp_avg_sq"
    assert got.step == want.step
    assert (got.ema_params is None) == (want.ema_params is None)
    if got.ema_params is not None:
        assert got.ema_params.keys() == want.ema_params.keys()
        for k in got.ema_params:
            assert torch.equal(got.ema_params[k], want.ema_params[k]), k


def _expected(jax_state, name, **overrides):
    """JAX's imported state carried across to a fresh port state."""
    _, want = _port_state(name, **overrides)
    bridge.gan_state_to_torch(jax_state, want)
    return want


@pytest.mark.parametrize("name", CONFIGS)
def test_import_equals_jax_import_and_bridge(name, tmp_path):
    extra = {"ema_decay": 0.999} if name in ("mnist_ode", "ucf_ode") else {}
    ckpt, drawn, jcfg, template = synthetic_reference(
        name, seed=CONFIGS.index(name), **TINY, **extra)
    jax_state = check_with_jax(ckpt, drawn, jcfg, template)
    path = tmp_path / f"state_normal{ckpt['epoch']}.ckpt"
    torch.save(ckpt, path)
    cfg, state = _port_state(name, **extra)
    got = import_gan_state(load_reference_checkpoint(str(path)), state, cfg)
    assert got is state and got.step == ckpt["epoch"]
    assert_states_equal(got, _expected(jax_state, name, **extra))
    # Adam moments are the port's own tensors, one per parameter and moment
    ptrs = [t.data_ptr() for s in got.gen.opt.state.values()
            for t in (s["exp_avg"], s["exp_avg_sq"])]
    assert len(set(ptrs)) == len(ptrs)
    if name == "mnist_ode":  # the unused GRU's lazy state -> nothing imported
        assert not any(k.startswith("motion.gru") for k in got.gen.module.state_dict())
        assert got.ema_params is not None


def test_fresh_optimizer_keeps_the_ports_adam(tmp_path):
    ckpt, drawn, jcfg, template = synthetic_reference("mnist_gru", seed=9, **TINY)
    jax_state = check_with_jax(ckpt, drawn, jcfg, template,
                               import_optimizer=False)
    cfg, state = _port_state("mnist_gru")
    got = import_gan_state(ckpt, state, cfg, import_optimizer=False)
    assert all(not getattr(got, n).opt.state for n in ("gen", "dis_img",
                                                       "dis_vid"))
    assert_states_equal(got, _expected(jax_state, "mnist_gru"))


def test_an_imported_state_trains(tmp_path):
    """One CPU train_step from the imported state moves every net."""
    ckpt, *_ = synthetic_reference("mnist_ode", seed=3, **TINY)
    cfg, state = _port_state("mnist_ode")
    tr = build_trainer(cfg, device="cpu")
    state = import_gan_state(ckpt, tr.init_state(), cfg)
    before = {k: v.clone() for k, v in state.gen.module.state_dict().items()}
    rng = np.random.default_rng(0)
    images = torch.tensor(rng.uniform(-1, 1, (2, 2, 28, 28, 1)), dtype=torch.float32)
    videos = torch.tensor(rng.uniform(-1, 1, (2, 2, 16, 28, 28, 1)), dtype=torch.float32)
    metrics = tr.train_step(state, images, videos,
                            generator=torch.Generator().manual_seed(0))
    assert state.step == ckpt["epoch"] + 1
    assert all(np.isfinite(float(v)) for v in metrics.values())
    moved = state.gen.module.state_dict()["main.ConvTranspose_1.weight"]
    assert not torch.equal(moved, before["main.ConvTranspose_1.weight"])


def test_shape_mismatch_is_loud():
    ckpt, *_ = synthetic_reference("mnist_ode", **TINY)
    cfg, state = _port_state("mnist_ode", ngf=16)   # ngf mismatch
    with pytest.raises(ValueError, match="reference shape"):
        import_gan_state(ckpt, state, cfg)


def test_sn_configs_are_rejected():
    ckpt, *_ = synthetic_reference("mnist_ode", **TINY)
    cfg, state = _port_state("mnist_ode", video_disc="sn")
    with pytest.raises(ValueError, match="SN critics"):
        import_gan_state(ckpt, state, cfg)


@pytest.mark.parametrize("case", ["variant", "trunk", "missing", "extra"])
def test_unknown_or_incomplete_checkpoints_are_refused(case):
    ckpt, *_ = synthetic_reference("mnist_ode", **TINY)
    if case == "variant":
        cfg, state = _port_state("mnist_moe_ode")
        with pytest.raises(ValueError, match="unknown motion variant"):
            import_gan_state(ckpt, state, cfg)
    elif case == "trunk":
        cfg, state = _port_state("ucf_ode", trunk="dcgan128")
        with pytest.raises(ValueError, match="unsupported trunk"):
            import_gan_state(ckpt, state, cfg)
    elif case == "missing":
        del ckpt["model_state_dict"][0]["main.12.weight"]
        cfg, state = _port_state("mnist_ode")
        with pytest.raises(KeyError, match="main.12.weight"):
            import_gan_state(ckpt, state, cfg)
        # ... and a port generator with a layer the import does not give
        ckpt, *_ = synthetic_reference("mnist_ode", **TINY)
        cfg, state = _port_state("mnist_ode_rnn")
        with pytest.raises(KeyError, match="import missing parameter"):
            import_gan_state(ckpt, state, get_config("mnist_ode", **TINY))
    else:  # a port generator without the ODE field the checkpoint holds
        cfg, state = _port_state("mnist_ode")
        del state.gen.module.motion.ode_fn
        with pytest.raises(KeyError, match="our model lacks"):
            import_gan_state(ckpt, state, cfg)
