"""The N-way training step: the single-device step on the global batch,
computed by ranks that each hold a stripe of it (twin of
``ganode_tpu/parallel/mesh.py::make_parallel_step``).

In JAX the mesh step comes free: GSPMD runs one program over the global
arrays. Here each rank runs ``GANTrainer``'s step on its shards, and
``ParallelGANTrainer`` makes global what the single step computes over the
whole batch:

* **Batch statistics.** Train-mode BatchNorm (G's trunk over its frames,
  D_img, D_vid) takes its statistics over the global batch: one
  differentiable all-gather of each rank's mean and variance per layer,
  combined (``comm.global_moments``). Running statistics end equal on every
  rank.
* **Noise.** Every rank draws the global batch's noise from the same
  ``torch.Generator``, in the order the single step draws it, and keeps its
  slice (``_RankTape``): ``z_content``, the motion's ``x0``/``h0``/``e``,
  ``frame_idx``, the augmentation's draws, ``gp_eps``. A given noise tape
  (global, as the single step takes it) is sliced the same way.
* **Reductions.** A rank's loss is the mean over its stripe; the global
  loss is the mean of the ranks' losses, and the gradient of every
  parameter is all-reduced once per update over one flat buffer, then
  divided by the world size. The penalties (a per-sample norm, then a
  mean) follow. ADA's ``rt`` is averaged before the controller moves, and
  every logged metric is averaged, so every rank reports the same bits.
* **Replicated state** (parameters, spectral-norm ``u``, Adam moments, EMA,
  ADA's ``p``) stays bit-equal across ranks: every rank applies the same
  reduced gradients to the same values.

Layouts:

* ``data=d``: rank i holds clips and images ``[i B/d, (i+1) B/d)``.
* ``data=d, seq=s``: rank (i, j) holds ``B/d`` clips x frames ``[j T/s,
  (j+1) T/s)`` of the real videos and ``B/(d s)`` images. The generator's
  motion runs for the rank's ``B/d`` clips (it is sequential in time) and
  its trunk decodes only the rank's frames. D_vid's temporal convolutions
  need whole clips: its input is all-gathered over the 'seq' group (no halo
  exchange), so D_vid runs replicated within each 'seq' group and saves no
  activation memory. Its statistics span the 'data' group.
* ``data=d, expert=e``: the batch splits over 'data' and is replicated over
  'expert'; each rank holds ``E/e`` experts of ``mnist_moe_ode``'s field
  (and only their Adam moments and EMA), computes their share of the gated
  combine, and all-reduces it over the 'expert' group
  (``nn.moe.moe_field``). Expert gradients reduce over the 'data' group.

Work replicated over a group (D_vid over 'seq', all but the experts over
'expert') yields the same gradient on each of its ranks, so summing over
all ranks and dividing by the world size is the global mean in every
layout.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from ..train.gan import GANTrainer, _moved
from ..train.diffaug import diffaug_draws
from . import comm
from .mesh import axis_index, axis_size, is_expert_leaf

# noise keys whose batch axis is dim 1: the GRU's (T, B, D) noise, the SDE's
# (K, B, D) increments, the augmentation's (2, B) integer draws
_BATCH_DIM_1 = ("e", "dW", "translation", "cutout")


def _batch_dim(key: str) -> int:
    return 1 if str(key).rsplit(":", 1)[-1] in _BATCH_DIM_1 else 0


def _slice_noise(noise: dict, lo: int, n: int) -> dict:
    """Rows ``[lo, lo + n)`` of every draw of a (nested) noise dict."""
    out = {}
    for k, v in noise.items():
        if isinstance(v, dict):
            out[k] = _slice_noise(v, lo, n)
        else:
            out[k] = v.narrow(_batch_dim(k), lo, n)
    return out


def _local(x) -> torch.Tensor:
    return x.to_local() if hasattr(x, "to_local") else x


@dataclasses.dataclass
class ParallelGANTrainer(GANTrainer):
    """``GANTrainer`` on one rank of ``mesh``: ``batch_size`` is the global
    batch, the nets are this rank's replicas (module docstring)."""

    mesh: object = None

    def __post_init__(self):
        super().__post_init__()
        names = self.mesh.mesh_dim_names
        if "data" not in names or not set(names) <= {"data", "seq", "expert"}:
            raise ValueError(f"a training mesh has a 'data' axis and at most "
                             f"'seq' or 'expert' beside it, not {names}")
        self.world = dist.get_world_size()
        self.d = axis_size(self.mesh, "data")
        self.s = axis_size(self.mesh, "seq") if "seq" in names else 1
        self.data_group = self.mesh.get_group("data")
        self.seq_group = self.mesh.get_group("seq") if "seq" in names else None
        self.expert_group = (self.mesh.get_group("expert")
                             if "expert" in names else None)
        di = axis_index(self.mesh, "data")
        sj = axis_index(self.mesh, "seq") if "seq" in names else 0
        self.seq_index = sj
        # videos split over 'data'; images over 'data' x 'seq'
        self.n_vid, self.vid_lo = self._split(self.d, di)
        self.n_img, self.img_lo = self._split(self.d * self.s, di * self.s + sj)
        # distinct batch elements live on this group: the world, or the
        # 'data' group where 'expert' replicates the batch
        self.frame_group = (self.data_group if self.expert_group
                            else dist.group.WORLD)
        # D_vid sees whole clips, gathered over 'seq'
        self.clip_group = self.data_group
        T = self.gen.video_length
        if T % self.s:
            raise ValueError(f"video_length {T} does not split over seq={self.s}")

    def _split(self, parts: int, index: int):
        if self.batch_size % parts:
            raise ValueError(f"batch {self.batch_size} does not split over "
                             f"{parts} ranks")
        n = self.batch_size // parts
        return n, index * n

    # ------------------------------------------------------------ placement
    def place_batch(self, images, videos):
        """Global batches ``(d_iters, B, ...)`` -> this rank's stripes:
        images over 'data' (x 'seq'), videos over 'data' and frames over
        'seq'."""
        images = _local(images)
        videos = _local(videos)
        if not isinstance(images, torch.Tensor):
            images, videos = torch.as_tensor(images), torch.as_tensor(videos)
        images = images.narrow(1, self.img_lo, self.n_img)
        videos = videos.narrow(1, self.vid_lo, self.n_vid)
        if self.s > 1:
            t = videos.shape[2] // self.s
            videos = videos.narrow(2, self.seq_index * t, t)
        return images, videos

    # -------------------------------------------------------------- samples
    def _sample(self, what: str, noise: dict, generator):
        self.gen.train()
        if what == "sample_images":
            return self.gen.sample_images(self.n_img, generator=generator,
                                          **noise)[0]
        if self.s == 1:
            return self.gen.sample_videos(self.n_vid, generator=generator,
                                          **noise)[0]
        # the motion for the rank's clips, the trunk for its frames, then
        # whole clips gathered over 'seq' (differentiable)
        n, T = self.n_vid, self.gen.video_length
        t = T // self.s
        z, _ = self.gen.sample_z_video(n, T, generator=generator, **noise)
        z = z.reshape(n, T, -1)[:, self.seq_index * t:(self.seq_index + 1) * t]
        h = self.gen.main(z.reshape(n * t, -1))
        h = h.reshape(n, t, *h.shape[1:]).permute(0, 1, 3, 4, 2)
        return comm.all_gather_dim(h, self.seq_group, dim=1)

    def _d_forward(self, mod: nn.Module, x, generator):
        group = self.clip_group if mod is self.dis_vid else self.frame_group
        with comm.batch_stats_over(group):
            return GANTrainer._d_forward(mod, x, generator)

    def _d_phase(self, state, which, real, noise, generator, p=None):
        if which == "video" and self.s > 1:
            real = comm.all_gather(real, self.seq_group, dim=1)
        return super()._d_phase(state, which, real, noise, generator, p)

    # ----------------------------------------------------------- reductions
    def _apply(self, net, params, grads, generator):
        super()._apply(net, params, self._reduce_grads(params, grads),
                       generator)

    def _reduce_grads(self, params, grads):
        """Sum over the ranks, one flat buffer per group, then / world."""
        expert = [getattr(p, "_ep_expert", False) for p in params]
        out = list(grads)
        for flag, group in ((False, None), (True, self.data_group)):
            idx = [i for i, e in enumerate(expert) if e == flag]
            if not idx:
                continue
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            comm.all_reduce_(flat, group)
            flat = flat / self.world
            off = 0
            for i in idx:
                n = grads[i].numel()
                out[i] = flat[off:off + n].view_as(grads[i])
                off += n
        return out

    def _ada_update(self, p, rt):
        rt = comm.all_reduce_(rt.detach().clone().reshape(1), None)[0]
        return super()._ada_update(p, rt / self.world)

    def train_step(self, state, images, videos, *, generator=None,
                   noise=None) -> dict:
        """One step on this rank's stripes (``place_batch``) -> the global
        step's metrics, equal on every rank. ``noise``: the global step's
        tape, or None to draw it from ``generator`` as the single step
        would."""
        tape = _RankTape(self, generator, noise)
        with comm.batch_stats_over(self.frame_group):
            metrics = super().train_step(state, _local(images), _local(videos),
                                         generator=generator, noise=tape)
        keys = [k for k in metrics if not k.startswith("ada_p")]
        vec = torch.stack([metrics[k].float().reshape(()) for k in keys])
        vec = comm.all_reduce_(vec, None) / self.world
        return {**metrics, **{k: vec[i] for i, k in enumerate(keys)}}


class _RankTape:
    """The noise of one global step, sliced to this rank, slot by slot.

    From a global tape, each slot's draws are sliced. From a generator, each
    slot is drawn for the global batch when the step asks for it, in the
    single step's order: the sample's (``z_content``, ``labels``, the
    motion's, ``frame_idx``), then a D update's ``aug_real``, ``aug_fake``
    and ``gp_eps``; the G update's two samples are drawn together (videos'
    then images' noise, then their augmentations), as the single step's
    loss draws them. Parameter noise, drawn after each update, keeps its
    place between slots."""

    def __init__(self, tr: ParallelGANTrainer, generator, tape):
        self.tr, self.generator, self.tape = tr, generator, tape
        self.order = ["images", "videos"] * tr.d_iters + ["videos", "images"]
        if tape is not None and len(tape) != len(self.order):
            raise ValueError(f"a noise tape holds {len(self.order)} samples, "
                             f"got {len(tape)}")

    def __len__(self):
        return len(self.order)

    def _cut(self, what: str, noise: dict) -> dict:
        tr = self.tr
        if what == "images":
            return _slice_noise(noise, tr.img_lo, tr.n_img)
        return _slice_noise(noise, tr.vid_lo, tr.n_vid)

    def _sample_noise(self, what: str) -> dict:
        """A sample's global noise, in the order its sampler draws it."""
        gen, g, B = self.tr.gen, self.generator, self.tr.batch_size
        dev = g.device
        noise = {"z_content": torch.randn((B, gen.dim_z_content), generator=g,
                                          device=dev)}
        if gen.dim_z_category > 0:
            noise["labels"] = torch.randint(0, gen.dim_z_category, (B,),
                                            generator=g, device=dev)
        noise.update(gen.motion.draw_noise(B, gen.video_length, g))
        if what == "images":
            noise["frame_idx"] = torch.randint(0, gen.video_length, (B,),
                                               generator=g, device=dev)
        return noise

    def _aug(self):
        tr, s = self.tr, self.tr.gen.frame_size
        return diffaug_draws(tr._diffaug_ops, (tr.batch_size, s, s, 1),
                             tr.ada_target > 0, self.generator)

    def _draw_d(self, what: str) -> dict:
        tr = self.tr
        noise = self._sample_noise(what)
        if tr._diffaug_ops:
            noise["aug_real"], noise["aug_fake"] = self._aug(), self._aug()
        if tr.gp_weight > 0:
            ndim = 4 if what == "images" else 5
            noise["gp_eps"] = torch.rand(
                (tr.batch_size,) + (1,) * (ndim - 1), generator=self.generator,
                device=self.generator.device)
        return noise

    def _draw_g(self):
        vid, img = self._sample_noise("videos"), self._sample_noise("images")
        if self.tr._diffaug_ops:
            vid["aug"], img["aug"] = self._aug(), self._aug()
        return vid, img

    def __iter__(self):
        device = self.tr.gen.device
        n_d = 2 * self.tr.d_iters
        if self.tape is not None:
            for what, noise in zip(self.order, self.tape):
                yield _moved(self._cut(what, noise), device)
            return
        if self.generator is None:
            raise ValueError("the parallel step draws its noise from a "
                             "torch.Generator or takes a global tape")
        for what in self.order[:n_d]:
            yield self._cut(what, self._draw_d(what))
        vid, img = self._draw_g()
        yield self._cut("videos", vid)
        yield self._cut("images", img)


# ---------------------------------------------------------------- the state

def replicate_state(state, group=None):
    """Make every replicated tensor of a ``GANState`` equal to global rank
    0's, in place: parameters, buffers, Adam moments, EMA, ADA."""
    tensors = []
    for name in ("gen", "dis_img", "dis_vid"):
        net = getattr(state, name)
        tensors += list(net.module.parameters()) + list(net.module.buffers())
        for st in net.opt.state.values():
            tensors += [v for k, v in st.items() if k != "step"]
    tensors += list((state.ema_params or {}).values())
    tensors += list((state.ada or {}).values())
    with torch.no_grad():
        for t in tensors:
            comm.broadcast_(t.data, 0, group)
    return state


def shard_state_ep(state, mesh, axis: str = "expert"):
    """Keep only this rank's experts: every ``expert_*`` parameter of the
    generator (leading axis E) becomes its ``E/e`` slice, with its Adam
    moments and EMA; the MoE fields learn their slice and group. Call after
    ``replicate_state``."""
    e = axis_size(mesh, axis)
    j = axis_index(mesh, axis)
    group = mesh.get_group(axis)
    gen = state.gen.module
    opt = state.gen.opt
    swapped = {}
    for mod_name, mod in gen.named_modules():
        if not hasattr(mod, "ep"):
            continue
        for pname, p in list(mod.named_parameters(recurse=False)):
            if not is_expert_leaf(pname):
                continue
            if p.shape[0] % e:
                raise ValueError(f"{p.shape[0]} experts over {axis}={e}")
            k = p.shape[0] // e
            q = nn.Parameter(p.detach()[j * k:(j + 1) * k].clone())
            q._ep_expert = True
            setattr(mod, pname, q)
            swapped[p] = (q, j * k, k)
            full = f"{mod_name}.{pname}" if mod_name else pname
            if state.ema_params is not None:
                state.ema_params[full] = state.ema_params[full][
                    j * k:(j + 1) * k].clone()
        mod.ep = (group, j * (mod.n_experts // e))
    new_opt = type(opt)(list(gen.parameters()), **opt.defaults)
    for old, st in opt.state.items():
        new, lo, k = swapped.get(old, (old, None, None))
        if lo is not None:
            st = {n: (v if n == "step" else v[lo:lo + k].clone())
                  for n, v in st.items()}
        new_opt.state[new] = st
    state.gen.opt = new_opt
    return state


def make_parallel_step(trainer: GANTrainer, mesh):
    """-> ``(step_fn, place_state, place_batch)`` for ``mesh``:
    ``step_fn(state, images, videos, generator=None, noise=None)`` returns
    the global step's metrics; ``place_state`` makes the state replicated
    (and the experts sharded on an 'expert' mesh); ``place_batch`` cuts the
    global batches to this rank's stripes."""
    fields = {f.name: getattr(trainer, f.name)
              for f in dataclasses.fields(GANTrainer)}
    tr = ParallelGANTrainer(**fields, mesh=mesh)

    def place_state(state):
        replicate_state(state)
        if tr.expert_group is not None:
            shard_state_ep(state, mesh)
        return state

    return tr.train_step, place_state, tr.place_batch
