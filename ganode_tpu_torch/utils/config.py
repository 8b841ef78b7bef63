"""Experiment configs: the port's own copy of ``ganode_tpu.utils.config``.

One frozen dataclass per README variant, the same 12 named configs, and the
same ``--set FIELD=VALUE`` parser. The one field dropped is ``use_pallas``:
the port runs its CUDA kernels wherever the JAX package's dispatch conditions
hold (rk4, one step per interval, checkpoint adjoint; ``ganode_tpu/models/
motion.py:112-115``), so ``--set use_pallas=...`` is an unknown field and is
rejected. Configs that need modules not yet ported are registered; building
their generator raises NotImplementedError naming the ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    # model
    # gru | ode | sde | cde | ode_rnn (reference variants) | moe_ode
    # (mixture-of-experts ODE field — expert-parallel new capability)
    variant: str = "ode"
    # Output trunk geometry: mnist28 | dcgan64 | dcgan128 (deconv stacks), or
    # the stage-1 DVD-GAN-class trunks the reference built blocks for but
    # never assembled — gres64 (SN+CBN GResBlocks) and odegres64 (continuous-
    # depth: each block an ODE flow in channel-augmented space).
    trunk: str = "mnist28"
    n_channels: int = 1
    dim_z_content: int = 50
    dim_z_category: int = 0
    dim_z_motion: int = 16
    video_length: int = 16
    ngf: int = 64
    ndf: int = 64
    video_disc_ksize: int = 2
    image_disc: str = "patch"         # patch | full | sn (spectral-norm critic)
    video_disc: str = "full"          # full | patch | sn (spectral-norm critic)
    # conv/deconv compute dtype: 'float32' | 'bfloat16' (params stay f32)
    compute_dtype: str = "float32"
    # Motion solver method. Per variant: ode = any fixed-grid method or
    # 'dopri5' (adaptive); sde = 'euler' | 'milstein' | 'reversible_heun' |
    # 'reversible_heun_adjoint' (O(1)-memory exact adjoint, arXiv:2105.13493);
    # cde/ode_rnn = any fixed-grid method. None keeps the variant's reference
    # default (rk4 / euler / rk4 / rk4).
    motion_method: Optional[str] = None
    # SDE max internal step (reference models/mocogan_sde.py:59 dt=2.5e-2);
    # None keeps the default.
    sde_dt: Optional[float] = None
    # moe_ode variant: expert count and routing (0 = dense softmax mixture,
    # k>0 = sparse top-k — fixed-grid solvers only; see nn/moe.py)
    moe_experts: int = 4
    moe_top_k: int = 0
    # training (reference mnist_moco_ode.py:13-14,86-89,111)
    steps: int = 100_000
    batch_size: int = 32
    d_iters: int = 2
    lr: float = 2e-4
    betas: Tuple[float, float] = (0.5, 0.999)
    weight_decay: float = 1e-5
    loss: str = "bce"                 # bce | wasserstein | hinge
    param_noise_sigma: float = 0.0
    gp_weight: float = 0.0
    # R1 zero-centered gradient penalty on reals (Mescheder et al. 2018);
    # 0 = off. The bce/hinge-compatible D regularizer (train/losses.py).
    r1_weight: float = 0.0
    # EMA of generator params for eval-mode sampling (0 = off; 0.999 is a
    # good default when enabled). Beyond-reference stabilizer.
    ema_decay: float = 0.0
    # One concatenated real+fake D pass (batch 2B) instead of two B passes:
    # measured TPU throughput option; BN stats then span the combined batch
    # (reference semantics = False; see GANTrainer.fused_real_fake).
    fused_real_fake: bool = False
    # DiffAugment policy for discriminator inputs (arXiv:2006.10738), e.g.
    # "color,translation,cutout". Keyed, differentiable, per-clip-consistent;
    # "" = off (reference semantics). Beyond-reference stabilizer against
    # D overfitting at small dataset scale. See train/diffaug.py.
    diffaug: str = ""
    # Adaptive DiffAugment (ADA, arXiv:2006.06676): > 0 turns the fixed-p
    # diffaug policy into a per-discriminator adaptive one — an integral
    # controller drives p toward E[sign(D(aug(real)))] = ada_target (paper
    # default 0.6). Requires a non-empty diffaug policy. 0 = off (fixed p=1).
    ada_target: float = 0.0
    # controller increment per D update (paper's 500k-image constant)
    ada_step: float = 5e-4
    ada_p_max: float = 0.8
    # data
    dataset: str = "rotmnist"         # rotmnist | ucf101
    data_path: str = "data/rot-mnist.npz"
    digits: Optional[Tuple[int, ...]] = None
    # batch feeding backend for packed ucf101: 'python' gathers windows in a
    # per-batch Python loop (data/ucf101.py), 'native' serves prefetched
    # batches from the C++ thread ring (runtime/clip_loader.cc) — same
    # normalization, bit-reproducible from (seed, batch index).
    data_loader: str = "python"       # python | native
    # worker threads for the native ring (ignored by the python loader)
    data_loader_threads: int = 4
    # Device mesh for the training step: "" = single device; "data=8" = DP
    # over 8 chips; "data=4,seq=2" = DP x sequence-parallel (clips sharded
    # over batch AND frame axes). Parameters are replicated; GSPMD inserts
    # the gradient psums. TP/EP placements are model-specific and stay at the
    # library level (parallel.shard_params_tp / shard_params_ep).
    mesh: str = ""
    # io cadence (reference mnist_moco_ode.py:164-182)
    tensorboard: bool = True          # mirror metrics to <workdir>/tb events
    log_every: int = 100
    sample_every: int = 1000
    checkpoint_every: int = 1000
    seed: int = 0


def mnist_ode(**kw) -> ExperimentConfig:
    """mnist_moco_ode.py: VideoGeneratorMNIST(1, 50, 0, 16, 16), d_iters=2, BCE."""
    return ExperimentConfig(name="mnist_ode", variant="ode", **kw)


def mnist_sde(**kw) -> ExperimentConfig:
    return ExperimentConfig(name="mnist_sde", variant="sde", **kw)


def mnist_cde(**kw) -> ExperimentConfig:
    return ExperimentConfig(name="mnist_cde", variant="cde", **kw)


def mnist_ode_rnn(**kw) -> ExperimentConfig:
    return ExperimentConfig(name="mnist_ode_rnn", variant="ode_rnn", **kw)


def mnist_gru(**kw) -> ExperimentConfig:
    return ExperimentConfig(name="mnist_gru", variant="gru", **kw)


def mnist_moe_ode(**kw) -> ExperimentConfig:
    """Mixture-of-experts ODE motion (new capability): the mnist_ode protocol
    with the RHS a smooth gated mixture of 4 expert fields — the expert-
    parallel configuration (parallel.shard_params_ep over an 'expert' axis)."""
    return ExperimentConfig(name="mnist_moe_ode", variant="moe_ode", **kw)


def mnist_ode_wgan(**kw) -> ExperimentConfig:
    """mnist_moco_ode_wgan.py: Wasserstein losses + param noise 1e-4 on the
    3s-only dataset — the reference's documented failure case."""
    kw.setdefault("loss", "wasserstein")
    kw.setdefault("param_noise_sigma", 1e-4)
    kw.setdefault("digits", (3,))
    return ExperimentConfig(name="mnist_ode_wgan", variant="ode", **kw)


def mnist_ode_noise(**kw) -> ExperimentConfig:
    """mnist_moco_ode_noise.py: BCE + param noise 1e-5, 3s-only."""
    kw.setdefault("param_noise_sigma", 1e-5)
    kw.setdefault("digits", (3,))
    return ExperimentConfig(name="mnist_ode_noise", variant="ode", **kw)


def ucf_ode(**kw) -> ExperimentConfig:
    """ucf_moco_ode.py: 3-channel 64x64 clips, full VideoDiscriminator ksize=4."""
    kw.setdefault("trunk", "dcgan64")
    kw.setdefault("n_channels", 3)
    kw.setdefault("video_disc_ksize", 4)
    kw.setdefault("dataset", "ucf101")
    kw.setdefault("data_path", "data/ucf101-pack")
    kw.setdefault("sample_every", 100)
    kw.setdefault("checkpoint_every", 100)
    return ExperimentConfig(name="ucf_ode", variant="ode", **kw)


def ucf_gres(**kw) -> ExperimentConfig:
    """Stage-1 GResBlock trunk assembled into a trainable 64x64 video GAN —
    the model the reference's stage 1 built blocks for but never assembled
    (reference stage1/GResBlock.py:90-167). SN critics pair with the SN+CBN
    generator."""
    kw.setdefault("trunk", "gres64")
    kw.setdefault("n_channels", 3)
    kw.setdefault("video_disc_ksize", 4)
    kw.setdefault("image_disc", "sn")
    kw.setdefault("video_disc", "sn")
    kw.setdefault("loss", "hinge")     # the DVD-GAN/SN-GAN pairing
    kw.setdefault("dataset", "ucf101")
    kw.setdefault("data_path", "data/ucf101-pack")
    return ExperimentConfig(name="ucf_gres", variant="ode", **kw)


def ucf_odegres(**kw) -> ExperimentConfig:
    """Continuous-depth trunk: gres64 with each block an ODE flow in channel-
    augmented space (reference stage1/stage_1_ODE_block.ipynb cells 6-9)."""
    kw.setdefault("trunk", "odegres64")
    return dataclasses.replace(ucf_gres(**kw), name="ucf_odegres")


def ucf_wgan_gp_128(**kw) -> ExperimentConfig:
    """North-star new config: WGAN-GP at 128x128 / 32 frames — the stabilized
    version of the variant the reference could not train (BASELINE.md)."""
    kw.setdefault("trunk", "dcgan128")
    kw.setdefault("n_channels", 3)
    kw.setdefault("video_length", 32)
    kw.setdefault("video_disc_ksize", 4)
    # WGAN-GP needs batch-norm-free critics (BN correlates samples inside the
    # batch and breaks the per-sample gradient penalty): spectral-norm critics.
    kw.setdefault("image_disc", "sn")
    kw.setdefault("video_disc", "sn")
    kw.setdefault("loss", "wasserstein")
    kw.setdefault("gp_weight", 10.0)
    kw.setdefault("d_iters", 5)
    kw.setdefault("motion_method", "dopri5")
    kw.setdefault("dataset", "ucf101")
    kw.setdefault("data_path", "data/ucf101-pack-128")
    return ExperimentConfig(name="ucf_wgan_gp_128", variant="ode", **kw)


CONFIGS = {
    "mnist_ode": mnist_ode,
    "mnist_sde": mnist_sde,
    "mnist_cde": mnist_cde,
    "mnist_ode_rnn": mnist_ode_rnn,
    "mnist_gru": mnist_gru,
    "mnist_moe_ode": mnist_moe_ode,
    "mnist_ode_wgan": mnist_ode_wgan,
    "mnist_ode_noise": mnist_ode_noise,
    "ucf_ode": ucf_ode,
    "ucf_gres": ucf_gres,
    "ucf_odegres": ucf_odegres,
    "ucf_wgan_gp_128": ucf_wgan_gp_128,
}


def get_config(name: str, **overrides) -> ExperimentConfig:
    if name not in CONFIGS:
        raise ValueError(f"unknown config {name!r}; choose from {sorted(CONFIGS)}")
    return CONFIGS[name](**overrides)


def overrides_from_strings(items) -> dict:
    """Parse 'field=value' strings into typed ExperimentConfig overrides.

    The value is coerced from the dataclass field's annotation: bools accept
    1/true/yes (case-insensitive), tuples are comma-separated numbers,
    Optional fields map ''/'none' to None. Backs `scripts/train.py --set`.
    Raises ValueError for unknown fields or missing '='.
    """
    fields = {f.name: f for f in dataclasses.fields(ExperimentConfig)}
    out = {}
    for item in items:
        name, sep, raw = item.partition("=")
        if not sep or name not in fields:
            raise ValueError(
                f"{item!r}: expected FIELD=VALUE with FIELD one of "
                f"{sorted(fields)}")
        ftype = str(fields[name].type)
        if ftype == "bool":
            low = raw.lower()
            if low in ("1", "true", "yes"):
                out[name] = True
            elif low in ("0", "false", "no"):
                out[name] = False
            else:
                # reject rather than coerce: a typo like 'ture' or an
                # unsupported spelling like 'on' must not silently flip the
                # flag off (the run would then record the wrong config)
                raise ValueError(
                    f"{item!r}: boolean field {name} takes "
                    "1/true/yes or 0/false/no")
        elif ftype == "int":
            out[name] = int(raw)
        elif ftype == "float":
            out[name] = float(raw)
        elif "Tuple" in ftype or "tuple" in ftype:
            parts = [x for x in raw.split(",") if x and x not in ("none", "None")]
            if not parts and "Optional" in ftype:
                out[name] = None
            else:
                out[name] = tuple(
                    int(x) if x.lstrip("-").isdigit() else float(x)
                    for x in parts)
        elif raw in ("", "none", "None") and "Optional" in ftype:
            out[name] = None
        elif "str" in ftype:
            out[name] = raw
        else:  # Optional[int] / Optional[float]
            # int when the literal is integral, else float — accepting
            # scientific notation ('1e-3', the spelling sde_dt's own
            # docstring uses), which a '.'-sniff would reject
            try:
                out[name] = int(raw)
            except ValueError:
                out[name] = float(raw)
    return out
