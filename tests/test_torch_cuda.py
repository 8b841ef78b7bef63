"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips without a card (decided in the fixture, so
every worker collects the same tests). Run on a machine with a card, without
the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each kernel has two variants: "warp" (one row per group of 16 or 32 lanes,
state in registers; every config's widths) and "wide" (shared-memory tiles;
larger widths). The shapes below take each variant at each lane count, and
``_launch(..., variant="wide")`` forces the wide one at the serving shape.

Float32 with TF32 off for matrix products (and for cuDNN's convolutions in
the training tests). Tolerances: 1e-5 abs on trajectories; rtol 1e-4 on
gradients, whose backward differentiates the plain version on the card; 1e-4
abs on losses and parameters after a whole training step, card against CPU
(every convolution sums in another order on each device). A resumed run must
equal an uninterrupted one bit for bit, under deterministic algorithms; for
cuBLAS those need ``CUBLAS_WORKSPACE_CONFIG``, set here before cuBLAS starts.
Differentiated twice (the ODE-GAN regularizer), each kernel's ``Function``
is held against the plain recurrence at 1e-5 of each tensor's largest
value. The GResBlock trunks (plain convolutions, as in JAX) are held, float32 on
the card against float64 on the CPU at 1e-4 of each tensor's largest value,
their gradients in float64 on both at 1e-8 of the largest gradient.
The SDE, CDE, ODE-RNN and MoE-ODE samplers (no kernel, as in JAX) are held,
float32 on the card against float64 on the CPU, at 1e-4. The spectral-norm
critics and the gradient penalty (no kernel of their own:
cuDNN's convolutions and their double backward) are held, float32 on the
card with TF32 off and cuDNN deterministic, against float64 on the CPU at
1e-4 of each tensor's largest value. DiffAugment (plain tensor code, no
kernel) is held against its CPU run given the same draws: translation and
cutout exactly, the colour ops at 1e-6; an ADA step as the training step
above.
"""
import copy
import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import pytest
import torch

from ganode_tpu_torch.ops import (
    fused_gru,
    fused_gru_motion,
    fused_rk4,
    fused_rk4_motion,
    reference_gru_motion,
    reference_rk4_motion,
)
from ganode_tpu_torch.train import build_trainer, run_training, runner
from ganode_tpu_torch.utils.config import get_config

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# Weights scale as 1/sqrt(fan_in), as the model's initialisers have them, so
# the trajectories stay O(1) at every width and 1e-5 abs is a float32 bar.
def _rk4(dev, b, d, h, t, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).to(dev)
    return [r(b, d), r(d, h, scale=1.6 / d ** 0.5), r(h, scale=0.1),
            r(h, d, scale=1.6 / h ** 0.5), r(d, scale=0.1),
            torch.linspace(0.0, 1.0, t)]


def _gru(dev, b, d, t, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).to(dev)
    return [r(b, d), r(t, b, d), r(d, 3 * d, scale=1.2 / d ** 0.5),
            r(d, 3 * d, scale=1.2 / d ** 0.5), r(3 * d, scale=0.1),
            r(3 * d, scale=0.1)]


def _variant_counts(module):
    return module.launches, dict(module.launches_by_variant)


@pytest.mark.parametrize("b,d,h,t,variant", [
    (64, 16, 16, 16, "warp"), (5, 10, 24, 6, "warp"), (1, 1, 1, 2, "warp"),
    (1000, 16, 16, 16, "warp"), (63, 16, 16, 16, "warp"),
    (5, 10, 16, 6, "warp"), (7, 20, 32, 5, "warp"), (3, 32, 32, 4, "warp"),
    (33, 64, 200, 9, "wide")])
def test_rk4_kernel_matches_plain(cuda, b, d, h, t, variant):
    args = _rk4(cuda, b, d, h, t)
    total, by_variant = _variant_counts(fused_rk4)
    got = fused_rk4_motion(*args)
    torch.cuda.synchronize()
    assert fused_rk4.launches == total + 1
    by_variant[variant] += 1
    assert fused_rk4.launches_by_variant == by_variant
    torch.testing.assert_close(got, reference_rk4_motion(*args), rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,d,t,variant", [
    (64, 16, 16, "warp"), (5, 10, 6, "warp"), (1, 1, 1, "warp"),
    (1000, 16, 16, "warp"), (63, 16, 16, "warp"), (9, 24, 5, "warp"),
    (4, 32, 3, "warp"), (9, 80, 5, "wide")])
def test_gru_kernel_matches_plain(cuda, b, d, t, variant):
    args = _gru(cuda, b, d, t)
    total, by_variant = _variant_counts(fused_gru)
    got = fused_gru_motion(*args)
    torch.cuda.synchronize()
    assert fused_gru.launches == total + 1
    by_variant[variant] += 1
    assert fused_gru.launches_by_variant == by_variant
    torch.testing.assert_close(got, reference_gru_motion(*args), rtol=0, atol=1e-5)


@pytest.mark.parametrize("variant", ["warp", "wide"])
def test_each_variant_at_the_serving_shape(cuda, variant):
    rk4 = _rk4(cuda, 64, 16, 16, 16)
    gru = _gru(cuda, 64, 16, 16)
    with torch.no_grad():
        got_rk4 = fused_rk4._launch(*rk4[:5], 16, fused_rk4.uniform_step(rk4[5]),
                                    variant=variant)
        got_gru = fused_gru._launch(*gru, variant=variant)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_rk4, reference_rk4_motion(*rk4), rtol=0, atol=1e-5)
    torch.testing.assert_close(got_gru, reference_gru_motion(*gru), rtol=0, atol=1e-5)


def test_gradients_through_the_kernels(cuda):
    # The gradient of sum(out ** 2) through the kernel path against the plain
    # version's vector-Jacobian product at the same cotangent, 2 * out of the
    # kernel: the kernel's float32 forward noise (held to 1e-5 above) stays
    # out of the comparison, which is of the backward alone.
    rk4 = _rk4(cuda, 8, 16, 16, 8)
    gru = _gru(cuda, 8, 16, 6)
    for fused, plain, args in ((fused_rk4_motion, reference_rk4_motion, rk4),
                               (fused_gru_motion, reference_gru_motion, gru)):
        leaves = [a.clone().requires_grad_() for a in args[:5]]
        want_leaves = [a.clone().requires_grad_() for a in args[:5]]
        out = fused(*leaves, *args[5:])
        (out ** 2).sum().backward()
        plain(*want_leaves, *args[5:]).backward(2 * out.detach())
        for a, b in zip(leaves, want_leaves):
            torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("variant", ["warp", "wide"])
def test_the_kernels_differentiate_twice_as_the_plain_version(cuda,
                                                              monkeypatch,
                                                              variant):
    # d/d(inputs, g) <VJP(g), v> through each kernel's Function (its launch
    # forced to the variant) against the plain recurrence on the same
    # float32 inputs: the ODE-GAN regularizer differentiates a gradient
    # through the motion. Within 1e-5 of each tensor's largest magnitude.
    import functools

    for module, fused, plain, args in (
            (fused_rk4, fused_rk4_motion, reference_rk4_motion,
             _rk4(cuda, 32, 16, 16, 16)),
            (fused_gru, fused_gru_motion, reference_gru_motion,
             _gru(cuda, 32, 16, 16))):
        n_in = 5 if module is fused_rk4 else 6
        inputs, consts = args[:n_in], args[n_in:]
        monkeypatch.setattr(module, "_launch",
                            functools.partial(module._launch, variant=variant))
        g = torch.Generator(cuda).manual_seed(1)
        cot0 = torch.randn(plain(*inputs, *consts).shape, generator=g,
                           device=cuda)
        vs = [torch.randn(a.shape, generator=g, device=cuda) for a in inputs]
        before = module.launches_by_variant[variant]
        results = []
        for fn in (fused, plain):
            leaves = [a.clone().requires_grad_() for a in inputs]
            cot = cot0.clone().requires_grad_()
            vjp = torch.autograd.grad(fn(*leaves, *consts), leaves, cot,
                                      create_graph=True)
            s = sum((a * b).sum() for a, b in zip(vjp, vs))
            results.append(torch.autograd.grad(s, leaves + [cot]))
        assert module.launches_by_variant[variant] == before + 1
        for got, want in zip(*results):
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-5 * want.abs().max().item())


def test_kernels_refuse_what_they_do_not_take(cuda):
    x, w1, b1, w2, b2, ts = _rk4(cuda, 4, 16, 16, 4)
    with pytest.raises(ValueError, match="contiguous"):
        fused_rk4_motion(x, w1.t().contiguous().t(), b1, w2, b2, ts)
    with pytest.raises(ValueError):
        fused_rk4_motion(x, w1.cpu(), b1, w2, b2, ts)
    with pytest.raises(ValueError, match="uniform"):
        fused_rk4_motion(x, w1, b1, w2, b2, torch.tensor([0.0, 0.1, 0.5, 1.0]))
    # D = H = 200 needs 2*200*200 floats of weights alone: more shared memory
    # than a block may have, so the launcher refuses before launching
    big = _rk4(cuda, 2, 200, 200, 3)
    with pytest.raises(RuntimeError, match="shared memory"):
        fused_rk4_motion(*big)
    with pytest.raises(RuntimeError, match="shared memory"):
        fused_gru_motion(*_gru(cuda, 2, 120, 2))
    # the warp variant refuses widths above its 32 lanes
    with pytest.raises(RuntimeError, match="lane count"):
        fused_rk4._launch(*_rk4(cuda, 2, 33, 16, 3)[:5], 3, 0.5, variant="warp")


def test_one_point_grid_launches_nothing(cuda):
    x, w1, b1, w2, b2, _ = _rk4(cuda, 4, 16, 16, 2)
    before = fused_rk4.launches
    out = fused_rk4_motion(x, w1, b1, w2, b2, torch.zeros(1))
    assert fused_rk4.launches == before
    assert out.shape == (1, 4, 16) and torch.equal(out[0], x)


def test_kernels_refuse_a_tensor_off_the_current_device(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards")
    other = torch.device("cuda", 1 - torch.cuda.current_device())
    with pytest.raises(ValueError, match="current CUDA device"):
        fused_rk4_motion(*[a.to(other) for a in _rk4(cuda, 4, 16, 16, 3)[:5]],
                         torch.linspace(0.0, 1.0, 3))
    with pytest.raises(ValueError, match="current CUDA device"):
        fused_gru_motion(*[a.to(other) for a in _gru(cuda, 4, 16, 3)])


def _trainer(name, device, seed=0):
    """A reduced-width trainer of ``name`` on ``device`` and a batch drawn on
    the CPU."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(name, ngf=8, ndf=8, batch_size=4)
    tr = build_trainer(cfg, device=device)
    g = torch.Generator().manual_seed(seed)
    size, c = (28, 1) if cfg.trunk == "mnist28" else (64, 3)
    images = torch.rand((2, 4, size, size, c), generator=g) * 2 - 1
    videos = torch.rand((2, 4, cfg.video_length, size, size, c),
                        generator=g) * 2 - 1
    return tr, tr.init_state(), images, videos


NETS = ("gen", "dis_img", "dis_vid")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a_training_step_on_the_card_matches_the_cpu(cuda, monkeypatch, seed):
    """One step on the card (float32, cuDNN deterministic) and on the CPU in
    float64, from one state carried across after a CPU step (Adam's first
    step from zero moments, lr * sign(g), would turn the rounding of
    near-zero gradients into 2 * lr) and one noise tape. float64, as a
    float32 CPU step is no closer to it than the card's: with torch 2.11 on
    the H100 host's CPU, oneDNN's float32 path has left G's gradients further
    from their float64 values than the card's. cuDNN's deterministic
    algorithms, as its default ones have moved the card's step further from
    float64 than 1e-4."""
    import ganode_tpu_torch.models.motion as motion_mod

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    tr_c, st_c, images, videos = _trainer("ucf_ode", "cpu", seed)
    tr_c.train_step(st_c, images, videos, noise=tr_c.noise_tape(
        torch.Generator().manual_seed(seed + 10), "cpu"))
    runs = []
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        if dtype == torch.float64:  # the wrappers take float32 only
            monkeypatch.setattr(motion_mod, "fused_rk4_motion",
                                reference_rk4_motion)
        tr, st, _, _ = _trainer("ucf_ode", device)
        for n in NETS:
            getattr(tr, n).to(dtype=dtype).load_state_dict(
                getattr(tr_c, n).state_dict())
            getattr(st, n).opt.load_state_dict(
                copy.deepcopy(getattr(st_c, n).opt.state_dict()))
        tape = [{k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in d.items()}
                for d in tr.noise_tape(torch.Generator().manual_seed(seed + 20),
                                       device)]
        metrics = tr.train_step(st, images.to(device, dtype),
                                videos.to(device, dtype), noise=tape)
        runs.append(({k: v.item() for k, v in metrics.items()},
                     {f"{n}.{k}": v.detach().cpu().double() for n in NETS
                      for k, v in getattr(tr, n).state_dict().items()}))
    (got, got_sd), (want, want_sd) = runs
    for k in want:
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])
    worst = max((got_sd[k] - v).abs().max().item() for k, v in want_sd.items())
    print(f"seed {seed}: card vs float64 CPU, parameters and statistics "
          f"max|diff| {worst:.3e}")
    for k, v in want_sd.items():
        torch.testing.assert_close(got_sd[k], v, rtol=0, atol=1e-4,
                                   msg=lambda m: f"{k}: {m}")


@pytest.mark.parametrize("name,module", [("ucf_ode", fused_rk4),
                                         ("mnist_gru", fused_gru),
                                         ("ucf_gres", fused_rk4)])
def test_a_training_step_launches_its_kernel_six_times(cuda, name, module):
    """Four no-grad samples in the D updates, two in the G update; the
    backward differentiates the plain version and launches nothing. The
    GResBlock trunk keeps the rk4 motion, so K1 as on ``ucf_ode``."""
    tr, state, images, videos = _trainer(name, cuda)
    module.launches = 0
    module.launches_by_variant.update(warp=0, wide=0)
    tr.train_step(state, images.to(cuda), videos.to(cuda),
                  generator=torch.Generator(cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert module.launches_by_variant == {"warp": 6, "wide": 0}


def test_the_device_data_step_launches_k2_six_times(cuda):
    """mnist_gru with its dataset resident on the card: indices drawn there,
    one K2 launch per generator sample."""
    cfg = get_config("mnist_gru", ngf=8, ndf=8, batch_size=4)
    tr = build_trainer(cfg, device=cuda)
    state = tr.init_state()
    videos, _ = runner.synthetic_rotmnist(cfg, n_videos=8)
    videos = torch.from_numpy(videos).to(cuda)
    step = runner.make_device_data_step(tr, cfg.d_iters, cfg.video_length)
    fused_gru.launches = 0
    fused_gru.launches_by_variant.update(warp=0, wide=0)
    metrics = step(state, videos, torch.Generator(cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert fused_gru.launches_by_variant == {"warp": 6, "wide": 0}
    assert all(torch.isfinite(v) for v in metrics.values())


@pytest.fixture
def deterministic(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    torch.use_deterministic_algorithms(True)
    yield cuda
    torch.use_deterministic_algorithms(False)


def test_a_resumed_run_on_the_card_equals_an_uninterrupted_one(deterministic,
                                                               tmp_path):
    cfg = get_config("ucf_ode", ngf=8, ndf=8, batch_size=4, log_every=1,
                     sample_every=0, checkpoint_every=0)
    straight, _ = run_training(cfg, str(tmp_path / "straight"), steps=2,
                               synthetic=True, device=deterministic)
    wd = str(tmp_path / "resumed")
    half, _ = run_training(cfg, wd, steps=1, synthetic=True,
                           device=deterministic)
    assert half.step == 1
    resumed, _ = run_training(cfg, wd, steps=2, synthetic=True, resume=True,
                              device=deterministic)
    assert resumed.step == 2
    nets = ("gen", "dis_img", "dis_vid")
    for n in nets:
        a, b = getattr(resumed, n), getattr(straight, n)
        for k, v in b.module.state_dict().items():
            assert torch.equal(a.module.state_dict()[k], v), (n, k)
        for pa, pb in zip(a.module.parameters(), b.module.parameters()):
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(a.opt.state[pa][k], b.opt.state[pb][k]), (n, k)


@pytest.mark.parametrize("trunk", ["gres64", "odegres64"])
def test_a_gres_trunk_on_the_card_matches_the_cpu(card_f32, trunk):
    """A GResBlock trunk at reduced width (ngf 8, 32 frames): train- and
    eval-mode frames and the state the train-mode call advanced (running
    statistics, every ``u``/``u0``/``u1``), float32 on the card against
    float64 on the CPU, each tensor's max |diff| over its max |value| <
    1e-4; and the gradients of the parameters and the latents in float64 on
    both (a float32 ReLU input within rounding of 0 may take the other side
    on either device, and moves a cancelling gradient sum by far more than
    its own rounding), < 1e-8."""
    from ganode_tpu_torch.models.mocogan import TRUNKS

    g = torch.Generator().manual_seed(0)
    base = TRUNKS[trunk](3, 8, 24)
    base.init_parameters(torch.Generator().manual_seed(1))
    z = torch.randn((32, 24), generator=g)
    w = torch.randn((32, 3, 64, 64), generator=g)

    def run(device, dtype, grads):
        m = copy.deepcopy(base).to(device, dtype).train()
        zz = z.to(device, dtype).requires_grad_(grads)
        y = m(zz)
        out = [y]
        if grads:
            out += torch.autograd.grad((y * w.to(device, dtype)).sum(),
                                       [zz, *m.parameters()])
        out += [b for _, b in m.named_buffers() if b.is_floating_point()]
        with torch.no_grad():
            out.append(m.eval()(zz))
        return [t.detach().double().cpu() for t in out]

    rel = lambda a, b, scale: ((a - b).abs().max() / scale).item()
    want = run("cpu", torch.float64, False)
    for a, b in zip(run(card_f32, torch.float32, False), want):
        assert rel(a, b, b.abs().max()) < 1e-4
    want = run("cpu", torch.float64, True)
    n_grads = 1 + len(list(base.parameters()))
    # a conv bias that feeds a batch-statistics norm has a gradient of
    # exactly 0: both devices give noise there, at the gradients' scale
    scale = max(g.abs().max() for g in want[1:1 + n_grads])
    for i, (a, b) in enumerate(zip(run(card_f32, torch.float64, True), want)):
        grad = 1 <= i <= n_grads
        assert rel(a, b, scale if grad else b.abs().max()) < 1e-8, i


@pytest.fixture
def card_f32(cuda, monkeypatch):
    """cuDNN deterministic with TF32 off: the card's float32 against the
    CPU's float64, as chip_smoke.py's card-vs-CPU phases run."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return cuda


def _sn_critic(kind, device, dtype):
    from ganode_tpu_torch.models import make_discriminator

    video = kind == "video"
    return make_discriminator("sn", video, n_channels=3, ndf=8, ksize=4,
                              seed=1, device="cpu").to(device, dtype), video


def _critic_input(video, seed):
    g = torch.Generator().manual_seed(seed)
    shape = (4, 16, 64, 64, 3) if video else (4, 128, 128, 3)
    return torch.rand(shape, generator=g) * 2 - 1


@pytest.mark.parametrize("kind", ["image", "video"])
def test_an_sn_critic_on_the_card_matches_the_cpu_in_float64(card_f32, kind):
    """Train-mode logits, the advanced ``u`` of every layer, and the
    gradients of the parameters and the input: card (float32) against the
    CPU (float64), each tensor's max |diff| over its max |value| < 1e-4."""
    out = {}
    for side, device, dtype in (("card", card_f32, torch.float32),
                                ("cpu", "cpu", torch.float64)):
        critic, video = _sn_critic(kind, device, dtype)
        x = _critic_input(video, 0).to(device, dtype).requires_grad_()
        logits, _ = critic.train()(x)
        names, params = zip(*critic.named_parameters())
        grads = torch.autograd.grad((logits ** 2).sum(), [x, *params])
        out[side] = [logits, *grads] + [b for _, b in critic.named_buffers()]
    for got, want in zip(out["card"], out["cpu"]):
        err = (got.double().cpu() - want).abs().max() / want.abs().max()
        assert err < 1e-4, err


@pytest.mark.parametrize("kind", ["image", "video"])
def test_a_gradient_penalty_on_the_card_matches_the_cpu_in_float64(card_f32,
                                                                   kind):
    """The WGAN-GP term in eval mode (as the trainer's penalty pass runs it)
    and its gradients with respect to the critic (double backward): card
    (float32) against the CPU (float64), relative 1e-4."""
    from ganode_tpu_torch.train import gradient_penalty

    out = {}
    for side, device, dtype in (("card", card_f32, torch.float32),
                                ("cpu", "cpu", torch.float64)):
        critic, video = _sn_critic(kind, device, dtype)
        critic.eval()
        real = _critic_input(video, 1).to(device, dtype)
        fake = _critic_input(video, 2).to(device, dtype)
        eps = torch.rand((4,) + (1,) * (real.ndim - 1),
                         generator=torch.Generator().manual_seed(3))
        gp = gradient_penalty(lambda x: critic(x)[0], real, fake,
                              eps.to(device, dtype))
        grads = torch.autograd.grad(gp, list(critic.parameters()))
        out[side] = [gp, *grads]
    for got, want in zip(out["card"], out["cpu"]):
        err = (got.double().cpu() - want).abs().max() / want.abs().max()
        assert err < 1e-4, err


# ---------------------------------------------------------------------------
# The SDE, CDE, ODE-RNN and MoE-ODE motions run no kernel (as in JAX): their
# samplers on the card against the CPU in float64, the reversible adjoint
# against autograd, and their training steps launching neither kernel.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,options", [
    ("sde", {}), ("sde", {"method": "milstein"}),
    ("sde", {"method": "reversible_heun"}),
    ("sde", {"method": "reversible_heun_adjoint"}), ("cde", {}),
    ("ode_rnn", {}), ("moe_ode", {}), ("moe_ode", {"top_k": 2}),
    ("moe_ode", {"adjoint": "backsolve"})])
def test_a_motion_sampler_on_the_card_matches_the_cpu(cuda, kind, options):
    """The full-width sampler (B=32, dim 16, T=16) on the card in float32
    against the CPU in float64 from the same weights and noise: the
    trajectory within 1e-4 abs, the gradients of ``sum(traj * w)`` in every
    parameter within 1e-4 of each tensor's largest value."""
    from ganode_tpu_torch.models import make_motion_sampler

    base = make_motion_sampler(kind, 16, **options)
    base.init_parameters(torch.Generator().manual_seed(0))
    noise = base.draw_noise(32, 16, torch.Generator().manual_seed(1))
    w = torch.randn((32, 16, 16), generator=torch.Generator().manual_seed(2))
    runs = []
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        m = copy.deepcopy(base).to(device, dtype)
        zs = m(32, 16, **{k: v.to(device, dtype) for k, v in noise.items()})
        grads = torch.autograd.grad((zs * w.to(device, dtype)).sum(),
                                    list(m.parameters()))
        runs.append((zs.detach().cpu().double(),
                     [g.cpu().double() for g in grads]))
    (z, g), (z_ref, g_ref) = runs
    assert bool(torch.isfinite(z).all())
    torch.testing.assert_close(z, z_ref, rtol=0, atol=1e-4)
    for a, b in zip(g, g_ref):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def test_the_reversible_adjoint_on_the_card_matches_autograd(cuda):
    """``sdeint_reversible_adjoint``'s gradients (in ``y0`` and the fields'
    parameters, a cotangent at every output time) against autograd through
    ``sdeint(method="reversible_heun")``, both on the card in float32,
    within 1e-4 of each tensor's largest value."""
    from ganode_tpu_torch.models import MotionSDE

    m = MotionSDE(16).to(cuda)
    m.init_parameters(torch.Generator(cuda).manual_seed(0))
    noise = m.draw_noise(32, 16, torch.Generator(cuda).manual_seed(1))
    w = torch.randn((32, 16, 16), device=cuda)
    out = []
    for method in ("reversible_heun_adjoint", "reversible_heun"):
        m.method = method
        x0 = noise["x0"].clone().requires_grad_()
        zs = m(32, 16, x0=x0, dW=noise["dW"])
        out.append((zs.detach(), torch.autograd.grad(
            (zs * w).sum(), [x0, *m.drift_fn.parameters(),
                             *m.diffusion_fn.parameters()])))
    (za, ga), (zr, gr) = out
    torch.testing.assert_close(za, zr, rtol=0, atol=1e-6)
    for a, b in zip(ga, gr):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


@pytest.mark.parametrize("name", ["mnist_sde", "mnist_cde", "mnist_ode_rnn",
                                  "mnist_moe_ode"])
def test_the_new_motions_launch_no_kernel(cuda, name):
    cfg = get_config(name, ngf=8, ndf=8, batch_size=4)
    tr = build_trainer(cfg, device=cuda)
    g = torch.Generator(cuda).manual_seed(0)
    images = torch.rand((2, 4, 28, 28, 1), generator=g, device=cuda) * 2 - 1
    videos = torch.rand((2, 4, 16, 28, 28, 1), generator=g, device=cuda) * 2 - 1
    for module in (fused_rk4, fused_gru):
        module.launches = 0
    metrics = tr.train_step(tr.init_state(), images, videos, generator=g)
    torch.cuda.synchronize()
    assert fused_rk4.launches == 0 and fused_gru.launches == 0
    assert all(torch.isfinite(v) for v in metrics.values())


DIFFAUG = "color,translation,cutout"


@pytest.mark.parametrize("p", [None, 0.0, 0.5, 1.0])
@pytest.mark.parametrize("op", ["brightness", "saturation", "contrast",
                                "translation", "cutout", DIFFAUG])
def test_diff_augment_on_the_card_matches_the_cpu(cuda, op, p):
    """DiffAugment given the same draws (made on the CPU) on a batch in
    [-1, 1), the range of the data and of the generator's tanh: translation
    and cutout exact, the colour ops within 1e-6 (a few float32 ulps of the
    values, which the colour ops take up to |4|, with the means summed in
    another order); ``p=1`` the ungated result bit for bit, ``p=0`` the
    identity."""
    from ganode_tpu_torch.train.diffaug import diff_augment, diffaug_draws

    x = torch.rand((32, 16, 64, 64, 3), generator=torch.Generator()
                   .manual_seed(0)) * 2 - 1
    draws = diffaug_draws(op, x.shape, p is not None,
                          torch.Generator().manual_seed(1))
    pt = None if p is None else torch.tensor(p)
    want = diff_augment(x, op, pt, draws=draws)
    got = diff_augment(x.to(cuda), op, None if pt is None else pt.to(cuda),
                       draws=draws)
    assert got.device.type == "cuda"
    if op in ("translation", "cutout"):
        assert torch.equal(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)
    if p == 1.0:
        assert torch.equal(got, diff_augment(x.to(cuda), op, draws=draws))
    if p == 0.0:
        assert torch.equal(got, x.to(cuda))


def test_an_ada_step_on_the_card_matches_the_cpu_in_float64(cuda,
                                                            monkeypatch):
    """One ``mnist_ode`` step with DiffAugment, ADA and R1 (the rotated-MNIST
    ADA runs' options) on the card and on the CPU in float64, from one state
    carried across after a CPU step with ``p`` set to 0.5 and 0.3, and one
    noise tape: losses, ``rt``, ``p`` and every parameter and statistic
    within 1e-4."""
    import ganode_tpu_torch.models.motion as motion_mod

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("mnist_ode", ngf=8, ndf=8, batch_size=4, diffaug=DIFFAUG,
                     ada_target=0.6, ada_step=0.05, r1_weight=0.1)
    g = torch.Generator().manual_seed(0)
    images = torch.rand((2, 4, 28, 28, 1), generator=g) * 2 - 1
    videos = torch.rand((2, 4, 16, 28, 28, 1), generator=g) * 2 - 1
    tr_c = build_trainer(cfg, device="cpu")
    st_c = tr_c.init_state()
    tr_c.train_step(st_c, images, videos, noise=tr_c.noise_tape(
        torch.Generator().manual_seed(10), "cpu"))

    def cast(d, dtype):
        return {k: cast(v, dtype) if isinstance(v, dict) else
                v.to(dtype) if v.is_floating_point() else v
                for k, v in d.items()}

    runs = []
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        if dtype == torch.float64:  # the wrappers take float32 only
            monkeypatch.setattr(motion_mod, "fused_rk4_motion",
                                reference_rk4_motion)
        tr = build_trainer(cfg, device=device)
        st = tr.init_state()
        for n in NETS:
            getattr(tr, n).to(dtype=dtype).load_state_dict(
                getattr(tr_c, n).state_dict())
            getattr(st, n).opt.load_state_dict(
                copy.deepcopy(getattr(st_c, n).opt.state_dict()))
        st.ada = {"p_img": torch.tensor(0.5, device=device),
                  "p_vid": torch.tensor(0.3, device=device)}
        tape = [cast(d, dtype) for d in tr.noise_tape(
            torch.Generator().manual_seed(20), device)]
        metrics = tr.train_step(st, images.to(device, dtype),
                                videos.to(device, dtype), noise=tape)
        runs.append(({k: v.item() for k, v in metrics.items()},
                     {f"{n}.{k}": v.detach().cpu().double() for n in NETS
                      for k, v in getattr(tr, n).state_dict().items()}))
    (got, got_sd), (want, want_sd) = runs
    assert sorted(got) == sorted(want) and "ada_p_img" in want
    for k in want:
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])
    for k, v in want_sd.items():
        torch.testing.assert_close(got_sd[k], v, rtol=0, atol=1e-4,
                                   msg=lambda m: f"{k}: {m}")
