"""Pipelined trunk serving: the deconv trunks split into pure eval-mode
stages for ``parallel.pipeline_apply`` (twin of
``ganode_tpu/models/pipeline.py``).

The pipeline's object in this model family is the generator trunk's
activation pyramid: a latency-bound serving step (small batch, deep trunk)
can spread its stages over ranks that each hold one stage's weights and one
microbatch in flight. Stages run the eval-mode forward, BatchNorm on its
running statistics, the same calls as the trunk's own ``forward`` in eval
mode, so the pipelined decode equals ``sample_videos`` in eval mode.

Supports the three deconv trunks (``DCGANTrunk64``, ``DCGANTrunk128``,
``MNISTTrunk28``) in float32, as JAX does; the GRes trunks carry
spectral-norm state whose update runs through the whole trunk, and serve
through data parallelism instead.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .mocogan import DCGANTrunk64, DCGANTrunk128, MNISTTrunk28


def _trunk_units(trunk) -> list:
    """The trunk's layers in order: ``(conv name, BatchNorm name or None,
    activation, crop)``."""
    if not isinstance(trunk, (DCGANTrunk64, DCGANTrunk128, MNISTTrunk28)):
        raise ValueError(f"{type(trunk).__name__} has no pipeline staging "
                         "(deconv trunks only)")
    if trunk.dtype is not None:
        raise ValueError("pipeline stages run float32 trunks only")
    units = [(f"ConvTranspose_{i}", f"BatchNorm_{i}", "relu", False)
             for i in range(trunk.n_stages)]
    if isinstance(trunk, MNISTTrunk28):
        # 1x1 conv, 2-pixel crop, tanh (reference mocogan_ode.py:82)
        units.append(("Conv_0", None, "tanh", True))
    else:
        units.append((f"ConvTranspose_{trunk.n_stages}", None, "tanh", False))
    return units


def _apply_unit(trunk, unit, params: dict, x: torch.Tensor) -> torch.Tensor:
    conv, bn, act, crop = unit
    layer = getattr(trunk, conv)
    w = params[f"{conv}.weight"]
    if isinstance(layer, torch.nn.ConvTranspose2d):
        x = F.conv_transpose2d(x, w, None, layer.stride, layer.padding,
                               layer.output_padding, layer.groups,
                               layer.dilation)
    else:
        x = layer._conv_forward(x, w, None)
    if crop:
        x = x[:, :, 2:-2, 2:-2]
    if bn is not None:
        eps = getattr(trunk, bn).eps
        x = F.batch_norm(x, params[f"{bn}.running_mean"],
                         params[f"{bn}.running_var"], params[f"{bn}.weight"],
                         params[f"{bn}.bias"], False, 0.0, eps)
    return F.relu(x) if act == "relu" else torch.tanh(x)


def trunk_stage_fns(trunk, trunk_params: dict, n_stages: int):
    """Split a deconv trunk into ``n_stages`` contiguous stages.

    ``trunk_params``: the trunk's ``state_dict`` (or the same keys from
    other variables). -> (stage_fns, stage_params): pure ``fn(params, h)``
    whose composition equals the trunk's eval-mode forward on ``z (B',
    dim_z, 1, 1)`` (NCHW out), and each stage's own tensors (a stage holds
    only its layers' weights and statistics: what the pipeline shards)."""
    units = _trunk_units(trunk)
    if not 1 <= n_stages <= len(units):
        raise ValueError(f"n_stages must be in [1, {len(units)}]")
    groups = np.array_split(np.arange(len(units)), n_stages)
    stage_fns, stage_params = [], []
    for idx in groups:
        sub = [units[i] for i in idx]
        names = [c for c, _, _, _ in sub] + [b for _, b, _, _ in sub if b]
        stage_params.append({k: v for k, v in trunk_params.items()
                             if k.split(".")[0] in names
                             and not k.endswith("num_batches_tracked")})

        def fn(params, x, sub=sub):
            for u in sub:
                x = _apply_unit(trunk, u, params, x)
            return x

        stage_fns.append(fn)
    return stage_fns, stage_params


def generator_trunk_stages(gen, variables: dict, n_stages: int):
    """Stage the trunk of a ``VideoGenerator`` from its variables (a
    ``state_dict``, e.g. ``GANTrainer.eval_gen_variables``)."""
    params = {k[len("main."):]: v for k, v in variables.items()
              if k.startswith("main.")}
    return trunk_stage_fns(gen.main, params, n_stages)


def pipelined_sample_videos(gen, variables: dict, n: int, mesh, *,
                            axis: str = "pipe", data_axis=None,
                            n_microbatches=None, generator=None, **noise):
    """Eval-mode ``sample_videos`` with the trunk decoded through the
    pipeline: the latents (KB-sized) on every rank from the same
    ``generator`` (or ``noise``), then the ``n * T`` frames stream through
    the staged trunk. Equals ``functional_call(gen, variables, (n,), ...)``
    in eval mode with the same noise -> (videos (n, T, H, W, C), labels)."""
    from ..parallel.pipeline import pipeline_apply

    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage_fns, stage_params = generator_trunk_stages(gen, variables, n_stages)
    was_training = gen.training
    gen.eval()
    try:
        with torch.no_grad():
            z, labels = torch.func.functional_call(
                gen, variables, (n,),
                {"sample": "z_video", "generator": generator, **noise})
            h = pipeline_apply(stage_fns, stage_params, z[:, :, None, None],
                               mesh, axis=axis, data_axis=data_axis,
                               n_microbatches=n_microbatches)
    finally:
        gen.train(was_training)
    T = gen.video_length
    return h.reshape(n, T, *h.shape[1:]).permute(0, 1, 3, 4, 2), labels
