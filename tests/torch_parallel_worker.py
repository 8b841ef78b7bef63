"""One rank of a multi-process test of the port's parallel layer.

    python tests/torch_parallel_worker.py SCENARIO RANK WORLD INIT_URL IN OUT

Joins a gloo process group of WORLD ranks at INIT_URL (a ``file://`` path
under the test's ``tmp_path``), runs SCENARIO on the payload ``torch.save``d
at IN (on the CPU, or on the card where the payload's ``device`` names it),
and ``torch.save``s this rank's results to OUT. Imports torch and
the port only (no JAX), one torch thread. ``torch_parallel.run_ranks``
starts the ranks and collects their results; the test files share the
trainer factories here, and bridge JAX's states into port trainers built
the same way.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ganode_tpu_torch.models import (  # noqa: E402
    PatchImageDiscriminator, SNImageDiscriminator, SNVideoDiscriminator,
    VideoDiscriminator, make_generator)
from ganode_tpu_torch.train import GANTrainer  # noqa: E402

DISCRIMINATORS = {"bn": (PatchImageDiscriminator, VideoDiscriminator),
                  "sn": (SNImageDiscriminator, SNVideoDiscriminator)}


def build_trainer(spec: dict):
    """A tiny port trainer on the CPU, its weights uninitialised (a test
    loads them): ``spec`` holds ``motion``, ``T``, ``B``, ``ngf``, ``ndf``,
    ``dzc``, ``dzm``, ``disc`` ("bn" or "sn"), optional ``n_experts`` and
    the trainer's keyword arguments under ``kw``."""
    extra = {"n_experts": spec["n_experts"]} if spec.get("n_experts") else {}
    gen = make_generator(spec["motion"], n_channels=1, trunk="mnist28",
                         video_length=spec["T"], dim_z_content=spec["dzc"],
                         dim_z_motion=spec["dzm"], ngf=spec["ngf"],
                         device="cpu", **extra)
    img_cls, vid_cls = DISCRIMINATORS[spec.get("disc", "bn")]
    tr = GANTrainer(gen=gen, dis_img=img_cls(n_channels=1, ndf=spec["ndf"]),
                    dis_vid=vid_cls(n_channels=1, ndf=spec["ndf"], ksize=2),
                    batch_size=spec["B"], **spec.get("kw", {}))
    return tr, tr.init_state()


def flat_state(state) -> dict:
    """Every tensor of a state by name: modules, Adam moments, EMA, ADA."""
    out = {"step": torch.tensor(state.step)}
    for name in ("gen", "dis_img", "dis_vid"):
        net = getattr(state, name)
        out.update({f"{name}.{k}": v for k, v in
                    net.module.state_dict().items()})
        names = {p: k for k, p in net.module.named_parameters()}
        for p, s in net.opt.state.items():
            out.update({f"{name}.adam.{names[p]}.{k}": v
                        for k, v in s.items()})
    for k, v in (state.ema_params or {}).items():
        out[f"ema.{k}"] = v
    for k, v in (state.ada or {}).items():
        out[f"ada.{k}"] = v
    return {k: v.detach().clone() for k, v in out.items()}


def load_flat_state(state, flat: dict):
    """The inverse of ``flat_state``, into a fresh ``init_state()``."""
    state.step = int(flat["step"])
    for name in ("gen", "dis_img", "dis_vid"):
        net = getattr(state, name)
        sd = {k[len(name) + 1:]: v for k, v in flat.items()
              if k.startswith(name + ".") and ".adam." not in k}
        net.module.load_state_dict(sd)
        for pname, p in net.module.named_parameters():
            pre = f"{name}.adam.{pname}."
            st = {k[len(pre):]: v.clone() for k, v in flat.items()
                  if k.startswith(pre)}
            if st:
                net.opt.state[p] = st
    if state.ema_params is not None:
        for k in state.ema_params:
            state.ema_params[k].copy_(flat[f"ema.{k}"])
    if state.ada is not None:
        for k in state.ada:
            state.ada[k].copy_(flat[f"ada.{k}"])
    return state


def _gather_experts(state, tr):
    """Every expert slice gathered back over the 'expert' group, so the
    test compares whole tensors."""
    from ganode_tpu_torch.parallel import comm

    flat = flat_state(state)
    group = tr.expert_group
    for k, v in list(flat.items()):
        if k.rsplit(".", 1)[-1].startswith("expert_") or (
                ".adam." in k and ".expert_" in k and not k.endswith("step")):
            flat[k] = comm.all_gather(v.contiguous(), group, dim=0)
    return flat


def tensors(tree):
    """numpy leaves of a (nested) noise tape -> tensors; None stays."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tensors(v) for v in tree]
    return torch.as_tensor(np.ascontiguousarray(tree))


# ------------------------------------------------------------- scenarios
def scenario_step(p: dict, rank: int):
    """One N-way step (or several) from a carried state."""
    from ganode_tpu_torch.parallel import comm
    from ganode_tpu_torch.parallel.mesh import make_mesh
    from ganode_tpu_torch.parallel.step import make_parallel_step

    tr, state = build_trainer(p["spec"])
    load_flat_state(state, p["state"])
    mesh = make_mesh(None, p["axes"], shape=p["shape"])
    step, place_state, place_batch = make_parallel_step(tr, mesh)
    state = place_state(state)
    ptr = step.__self__
    out = {"metrics": [], "tally": []}
    for images, videos, tape, seed in p["steps"]:
        images, videos = place_batch(images, videos)
        out["local_shapes"] = (tuple(images.shape), tuple(videos.shape))
        if p.get("make_global_batch"):
            from ganode_tpu_torch.data import make_global_batch
            from ganode_tpu_torch.parallel import data_sharding

            # this rank's stripe, assembled into its shard of the global batch
            images = make_global_batch(images.contiguous(),
                                       data_sharding(mesh, 1, images.ndim))
            videos = make_global_batch(videos.contiguous(),
                                       data_sharding(mesh, 1, videos.ndim))
            out["global_shape"] = tuple(videos.shape)
            out["placements"] = str(videos.placements)
        comm.reset_tally()
        g = None if seed is None else torch.Generator().manual_seed(seed)
        metrics = step(state, images, videos, generator=g,
                       noise=tensors(tape))
        out["metrics"].append({k: v.detach().clone() for k, v in
                               metrics.items()})
        out["tally"].append(dict(comm.TALLY))
    out["state"] = (_gather_experts(state, ptr) if ptr.expert_group
                    else flat_state(state))
    out["local_expert_w1"] = tuple(
        state.gen.module.motion.moe_fn.expert_w1.shape) if ptr.expert_group \
        else None
    return out


def _dense_fns(n):
    return [lambda prm, x: torch.tanh(x @ prm["kernel"] + prm["bias"])
            for _ in range(n)]


def scenario_pipe(p: dict, rank: int):
    """``pipeline_apply`` over toy dense stages: the forward at
    ``n_microbatches=4``, the gradient of sum(out^2) at 2."""
    from ganode_tpu_torch.parallel import pipeline_apply
    from ganode_tpu_torch.parallel.mesh import make_mesh

    dev = p.get("device", "cpu")
    mesh = make_mesh(None, ("pipe",))
    params = [{k: torch.as_tensor(v).to(dev).requires_grad_()
               for k, v in d.items()} for d in p["params"]]
    fns = _dense_fns(len(params))
    x = torch.as_tensor(p["x"]).to(dev)
    out = pipeline_apply(fns, params, x, mesh, n_microbatches=4)
    y = pipeline_apply(fns, params, x, mesh, n_microbatches=2)
    (y ** 2).sum().backward()
    return {"out": out.detach().cpu(),
            "grads": {k: v.grad.cpu() for k, v in params[rank].items()}}


def scenario_pipe_trunk(p: dict, rank: int):
    """``pipelined_sample_videos`` over a (data, pipe) mesh."""
    from ganode_tpu_torch.models.pipeline import pipelined_sample_videos
    from ganode_tpu_torch.parallel.mesh import make_mesh

    s = p["gen"]
    gen = make_generator("ode", n_channels=3, trunk="dcgan64",
                         video_length=s["T"], dim_z_content=s["dzc"],
                         dim_z_motion=s["dzm"], ngf=s["ngf"], device="cpu")
    mesh = make_mesh(None, ("data", "pipe"), shape=p["shape"])
    variables = {k: torch.as_tensor(v) for k, v in p["variables"].items()}
    noise = {k: torch.as_tensor(v) for k, v in p["noise"].items()}
    videos, _ = pipelined_sample_videos(gen, variables, s["n"], mesh,
                                        data_axis="data",
                                        n_microbatches=p["microbatches"],
                                        **noise)
    return {"videos": videos}


def scenario_runner(p: dict, rank: int):
    """``run_training`` over a mesh (or without one, in one process)."""
    from ganode_tpu_torch.train import runner
    from ganode_tpu_torch.utils.config import get_config

    config = get_config(p["config"], **p["overrides"])
    state, metrics = runner.run_training(config, p["workdir"], steps=p["steps"],
                                         synthetic=True, resume=p["resume"],
                                         device=p.get("device", "cpu"))
    return {"metrics": metrics,
            "state": {k: v.cpu() for k, v in flat_state(state).items()}}


def scenario_loop_body(p: dict, rank: int):
    """The runner's N-way loop body from a carried state, fed the JAX
    runner's batches and noise."""
    from ganode_tpu_torch.train import runner
    from ganode_tpu_torch.utils.config import get_config

    config = get_config(p["config"], **p["overrides"])
    trainer = runner.build_trainer(config, device="cpu")
    state = load_flat_state(trainer.init_state(), p["state"])
    mesh, _ = runner._mesh_for(config, torch.device("cpu"))
    step, place_batch, state = runner.make_mesh_data_step(trainer, state,
                                                          mesh)
    out = {"metrics": []}
    for images, videos, tape in p["steps"]:
        metrics = step(state, *place_batch(images, videos), None,
                       noise=tensors(tape))
        out["metrics"].append({k: v.detach().clone()
                               for k, v in metrics.items()})
    out["state"] = flat_state(state)
    return out


def scenario_placements(p: dict, rank: int):
    """Meshes over 4 ranks and the placements on them -> (placements,
    local shape) per case, and the refusals' messages."""
    from ganode_tpu_torch import parallel as par

    def desc(dt):
        return str(list(dt.placements)), tuple(dt.to_local().shape)

    out = {}
    mesh = par.make_mesh(4, ("data",))
    out["batch"] = desc(par.shard_batch(np.zeros((2, 16, 4, 4, 1), np.float32),
                                        mesh, batch_axis=1))
    out["replicated"] = float(par.replicate(
        {"x": torch.full((3,), float(rank))}, mesh)["x"].to_local().max())
    ds = par.make_mesh(None, ("data", "seq"), shape=(2, 2))
    out["seq"] = desc(par.shard_batch_seq(
        np.zeros((2, 16, 8, 4, 4, 1), np.float32), ds))
    dm = par.make_mesh(None, ("data", "model"), shape=(2, 2))
    tp = par.shard_params_tp({"big": np.zeros((4, 4, 64, 128), np.float32),
                              "small": np.zeros((3,), np.float32)}, dm,
                             min_elements=1 << 10)
    out["tp_big"], out["tp_small"] = desc(tp["big"]), desc(tp["small"])
    de = par.make_mesh(None, ("data", "expert"), shape=(2, 2))
    ep = par.shard_params_ep({"moe_fn": {
        "expert_w1": np.zeros((4, 16, 16), np.float32),
        "gate": np.zeros((16, 4), np.float32)}}, de)["moe_fn"]
    out["ep"], out["ep_gate"] = desc(ep["expert_w1"]), desc(ep["gate"])
    for key, call in (("mismatch", lambda: par.make_mesh(
            None, ("data", "seq"), shape=(4, 2))),
            ("bad_axis", lambda: par.make_mesh(None, ("tensor",)))):
        try:
            call()
            out[key] = "no error"
        except ValueError as e:
            out[key] = str(e)
    return out


def scenario_int8_dp(p: dict, rank: int):
    """The int8 serving trunk over a 'data' mesh (dynamic scales)."""
    from ganode_tpu_torch.ops.quant import int8_trunk_apply
    from ganode_tpu_torch.parallel import data_parallel_apply
    from ganode_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(None, ("data",))
    qstate = tensors(p["qstate"])
    out = data_parallel_apply(
        lambda z: int8_trunk_apply("dcgan64", qstate, z), tensors(p["z"]),
        mesh)
    return {"frames": out}


SCENARIOS = {"step": scenario_step, "int8_dp": scenario_int8_dp, "placements": scenario_placements, "pipe": scenario_pipe,
             "pipe_trunk": scenario_pipe_trunk, "runner": scenario_runner,
             "loop_body": scenario_loop_body}


def main():
    name, rank, world, url, src, dst = sys.argv[1:7]
    rank, world = int(rank), int(world)
    payload = torch.load(src, weights_only=False)
    from ganode_tpu_torch.parallel import init_distributed
    import torch.distributed as dist

    # the card tests (tests/test_torch_cuda.py) put the ranks on the card
    init_distributed("gloo", payload.get("device", "cpu"), init_method=url,
                     rank=rank, world_size=world)
    try:
        result = SCENARIOS[name](payload, rank)
        torch.save(result, dst)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
