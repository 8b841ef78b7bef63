"""Config -> trainer and data, and the training loop (twin of
``ganode_tpu/train/runner.py``).

``run_training`` is the reference's train() loop, config-driven: real
batches from the config's dataset, the alternating step, JSONL and
TensorBoard logs, GIF samples and checkpoints at the config's cadences, a
graceful stop on SIGTERM/SIGINT or a ``<workdir>/STOP`` file, and resume.

Every random draw of a step comes from ``(config.seed, step, stream)``: the
host's ``numpy`` generator for the image and the video batches
(``step_rng``), the device's ``torch.Generator`` for the step's noise
(``step_generator``). Where the JAX loop folds the step into its key, the
port seeds a generator from the three numbers. The native loader's streams
(``data_loader="native"``) are counter-based instead: each step takes the
next ``d_iters`` batches of each, and a resume opens them at batch
``start_step * d_iters``. So a resume needs no saved random state, and an
interrupted and resumed run equals an uninterrupted one bit for bit,
wherever the device's kernels are deterministic (on the card:
``torch.use_deterministic_algorithms(True)``, cuDNN deterministic and
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before cuBLAS starts).

The loop takes each step's batches from ``data/loader.py::prefetch``: a
background thread draws the batches of the steps ahead (``step_batches``)
while the device runs the current one, and on the card stages them in
pinned memory and copies them on a side stream.

``config.mesh`` (``"data=N"`` or ``"data=N,seq=M"``) runs the same loop in
every rank of an initialised process group (``parallel.init_distributed``;
under ``torch.distributed.run`` the CLI does it) through the N-way step of
``parallel/step.py``: each rank draws the batch the single-process run
draws at that step and keeps its stripe, and the step computes the global
step's result on every rank. Rank 0 alone writes metrics, GIFs and
checkpoints; a resume restores on every rank.
"""
from __future__ import annotations

import os
import signal
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..data import (
    ArrayClips,
    ArrayImages,
    RotMNISTImages,
    RotMNISTVideos,
    UCF101ClipSampler,
    UCF101ImageSampler,
    load_rotmnist,
    rotate_videos,
)
from ..data.loader import prefetch
from ..models import discriminators_for_config, generator_for_config
from ..utils.checkpoint import CheckpointManager
from ..utils.config import ExperimentConfig
from ..utils.gifs import save_sample_grid
from ..utils.metrics import MetricsLogger, Throughput
from ..utils.tb import EventWriter
from .gan import GANTrainer
from .state import GANState

# The random streams of one step (the third number of the seed).
IMAGES, VIDEOS, TRAIN, SAMPLES = range(4)
# Steps whose batches run_training keeps staged ahead of the running one
PREFETCH_STEPS = 2


def build_trainer(config: ExperimentConfig, *, device="cuda") -> GANTrainer:
    """The trainer ``config`` describes, its three nets on ``device`` with
    weights drawn from ``config.seed``. Configs whose pieces are not ported
    raise ``NotImplementedError`` naming their ROADMAP item."""
    gen = generator_for_config(config, device=device)
    dis_img, dis_vid = discriminators_for_config(config, device=device)
    return GANTrainer(
        gen=gen, dis_img=dis_img, dis_vid=dis_vid,
        batch_size=config.batch_size, d_iters=config.d_iters,
        loss=config.loss, lr=config.lr, betas=config.betas,
        weight_decay=config.weight_decay,
        param_noise_sigma=config.param_noise_sigma,
        gp_weight=config.gp_weight, r1_weight=config.r1_weight,
        ema_decay=config.ema_decay, fused_real_fake=config.fused_real_fake,
        diffaug=config.diffaug, ada_target=config.ada_target,
        ada_step=config.ada_step, ada_p_max=config.ada_p_max)


def step_rng(seed: int, step: int, stream: int) -> np.random.Generator:
    """The host generator of one step's stream."""
    return np.random.default_rng([seed, step, stream])


def step_generator(seed: int, step: int, stream: int,
                   device) -> torch.Generator:
    """The ``torch.Generator`` on ``device`` of one step's stream."""
    s = np.random.SeedSequence([seed, step, stream]).generate_state(1, np.uint64)
    return torch.Generator(device).manual_seed(int(s[0]))


def synthetic_rotmnist(config: ExperimentConfig, n_videos: int = 64,
                       seed: int = 0):
    """Synthetic rotated-square videos with the real dataset's geometry, for
    dry runs when no dataset file is present."""
    rng = np.random.RandomState(seed)
    imgs = np.full((n_videos, 28, 28), -0.5, np.float32)
    for i in range(n_videos):
        y, x = rng.randint(4, 18, 2)
        imgs[i, y:y + 8, x:x + 8] = 0.5
    if config.digits:  # synthetic labels honor the class filter too
        labels = np.asarray(config.digits)[rng.randint(0, len(config.digits),
                                                       n_videos)]
    else:
        labels = rng.randint(0, 10, n_videos)
    X, Y = rotate_videos(imgs, labels, num_frames=config.video_length)
    return X.reshape(-1, config.video_length, 28, 28, 1), Y


def synthetic_ucf(config: ExperimentConfig, n_videos: int = 16, seed: int = 0):
    size = 128 if config.trunk == "dcgan128" else 64
    rng = np.random.RandomState(seed)
    videos = rng.randint(0, 255, (n_videos, config.video_length + 8, size, size,
                                  config.n_channels), dtype=np.uint8)
    videos = (videos.astype(np.float32) - 128.0) / 128.0
    return videos, rng.randint(0, 101, n_videos)


def build_data(config: ExperimentConfig, *, synthetic: bool = False,
               value_range=None, start_step: int = 0):
    """Returns (image_sampler, video_sampler), each with ``sample(rng)``.

    ``value_range`` (rotmnist only) rescales the served values; training keeps
    the reference's [0, 1] quirk (reference dataset/mnist_rotation.py:28-32),
    but evaluation must compare reals and tanh fakes on the same [-1, 1] scale.

    ``start_step`` (native loader only) opens the C++ batch streams where a
    run restored at that step continues them, at batch ``start_step *
    d_iters``; the python samplers draw each step's batch from the step
    alone. The native samplers own threads and a memory map: ``close()``
    them.
    """
    if config.dataset == "rotmnist":
        if synthetic or not os.path.exists(config.data_path):
            if not synthetic:
                raise FileNotFoundError(
                    f"dataset not found at {config.data_path}; build it with "
                    "python -m ganode_tpu_torch.build_rotmnist or pass "
                    "synthetic=True")
            videos, labels = synthetic_rotmnist(config)
        else:
            videos, labels = load_rotmnist(
                config.data_path, train=True, num_frames=config.video_length,
                digits=config.digits)
        kw = {"value_range": value_range} if value_range is not None else {}
        return (RotMNISTImages(videos, labels, config.batch_size, **kw),
                RotMNISTVideos(videos, labels, config.batch_size, **kw))
    if config.dataset == "ucf101":
        if synthetic or not os.path.exists(config.data_path):
            if not synthetic:
                raise FileNotFoundError(
                    f"packed UCF101 not found at {config.data_path}; pack it "
                    "with python -m ganode_tpu_torch.pack_ucf101 or pass "
                    "synthetic=True")
            videos, labels = synthetic_ucf(config)
            return (ArrayImages(videos, labels, config.batch_size),
                    ArrayClips(videos, labels, config.batch_size,
                               config.video_length))
        if config.data_loader == "native":
            # the C++ thread ring (runtime/clip_loader.cc); a step takes
            # d_iters batches of each stream
            from ..runtime import NativeClipSampler, NativeImageSampler

            start = start_step * config.d_iters
            images = NativeImageSampler(
                config.data_path, config.batch_size,
                n_threads=max(1, config.data_loader_threads // 2),
                seed=config.seed + 1, start_batch=start)
            try:
                clips = NativeClipSampler(
                    config.data_path, config.batch_size,
                    n_frame=config.video_length,
                    n_threads=config.data_loader_threads, seed=config.seed,
                    start_batch=start)
            except BaseException:
                images.close()
                raise
            return images, clips
        if config.data_loader != "python":
            raise ValueError(
                f"unknown data_loader {config.data_loader!r}; "
                "choose 'python' or 'native'")
        return (UCF101ImageSampler(config.data_path, config.batch_size),
                UCF101ClipSampler(config.data_path, config.batch_size,
                                  n_frame=config.video_length))
    raise ValueError(f"unknown dataset {config.dataset!r}")


def _stack_d_batches(sampler, rng: np.random.Generator, d_iters: int):
    """``d_iters`` batches of one sampler, drawn in turn from ``rng``."""
    return np.stack([sampler.sample(rng)[0] for _ in range(d_iters)])


def step_batches(img_sampler, vid_sampler, config: ExperimentConfig,
                 start_step: int, steps: int):
    """Each step's real batches, ``(images (d_iters, B, H, W, C), videos
    (d_iters, B, T, H, W, C))`` as numpy arrays, for the steps
    ``start_step .. steps - 1`` in order: the python samplers draw from the
    step's ``IMAGES`` and ``VIDEOS`` streams, the native ones take their
    next ``d_iters`` batches."""
    for step in range(start_step, steps):
        yield (_stack_d_batches(img_sampler,
                                step_rng(config.seed, step, IMAGES),
                                config.d_iters),
               _stack_d_batches(vid_sampler,
                                step_rng(config.seed, step, VIDEOS),
                                config.d_iters))


def make_host_data_step(trainer: GANTrainer):
    """The loop body of ``run_training``: ``step(state, images, videos,
    generator, noise=None) -> metrics``, with batches ``(d_iters, B, ...)``
    (numpy arrays or tensors) moved to the trainer's device, and the step's
    noise from ``generator`` or the ``noise`` tape
    (``GANTrainer.train_step``)."""
    device = trainer.gen.device

    def on_device(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def step(state, images, videos, generator, noise=None, *,
             train_step=trainer.train_step):
        return train_step(state, on_device(images), on_device(videos),
                          generator=generator, noise=noise)

    return step


def make_mesh_data_step(trainer: GANTrainer, state: GANState, mesh):
    """The loop body of ``run_training`` over ``mesh`` (``parallel/step.py``)
    -> ``(step, place_batch, state)``: ``place_batch(images, videos)`` cuts
    the global batches ``(d_iters, B, ...)`` to this rank's stripes (on the
    host, ahead of the loop), ``step(state, images, videos, generator,
    noise=None) -> metrics`` runs the N-way step on them, and ``state`` is
    made replicated across the ranks."""
    from ..parallel.mesh import make_parallel_step

    par_step, place_state, place_batch = make_parallel_step(trainer, mesh)
    host_step = make_host_data_step(trainer)

    def step(state, images, videos, generator, noise=None):
        return host_step(state, images, videos, generator, noise,
                         train_step=par_step)

    return step, place_batch, place_state(state)


def gather_device_batches(videos: torch.Tensor, vid_idx, img_vid_idx,
                          frame_idx):
    """-> (images ``(d, B, H, W, C)``, clips ``(d, B, T, H, W, C)``) of a
    dataset ``videos (N, T, H, W, C)`` on the device: clips ``vid_idx``, and
    frame ``frame_idx`` of clips ``img_vid_idx`` (all ``(d, B)``)."""
    return videos[img_vid_idx, frame_idx], videos[vid_idx]


def make_device_data_step(trainer: GANTrainer, d_iters: int, video_length: int):
    """A step whose real batches are gathered on the device from a resident
    dataset: ``step(state, videos, generator) -> metrics``.

    For datasets that fit in device memory (rotated-MNIST is ~6 MB),
    ``videos (N, T, H, W, C)`` is copied to the card once; each step draws
    its clips and frames with ``generator`` (a ``torch.Generator`` on the
    same device), which then feeds the step's noise. Nothing crosses from the
    host per step.
    """
    B = trainer.batch_size

    def step(state, videos, generator):
        def draw(high):
            return torch.randint(0, high, (d_iters, B), generator=generator,
                                 device=videos.device)

        n = videos.shape[0]
        vid_idx, img_vid_idx, frame_idx = draw(n), draw(n), draw(video_length)
        images, clips = gather_device_batches(videos, vid_idx, img_vid_idx,
                                              frame_idx)
        return trainer.train_step(state, images, clips, generator=generator)

    return step


def _parse_mesh(spec: str):
    """'data=4,seq=2' -> (('data', 'seq'), (4, 2))."""
    names, sizes = [], []
    for part in spec.split(","):
        name, _, size = part.partition("=")
        names.append(name.strip())
        sizes.append(int(size))
    allowed = {("data",), ("data", "seq")}
    if tuple(names) not in allowed:
        raise ValueError(
            f"mesh axes {names} unsupported by the runner; use 'data=N' or "
            "'data=N,seq=M' (TP/EP placements are model-specific — use "
            "ganode_tpu_torch.parallel directly)")
    return tuple(names), tuple(sizes)


def _mesh_for(config: ExperimentConfig, device):
    """-> (mesh, the rank's device) for ``config.mesh``: raises without an
    initialised process group, or when the mesh's size is not the group's,
    or when the rank's device is not of ``device``'s type."""
    from ..parallel.mesh import current_device, make_mesh

    axis_names, shape = _parse_mesh(config.mesh)
    mesh = make_mesh(int(np.prod(shape)), axis_names, shape=shape)
    dev = current_device()
    if dev.type != device.type:
        raise ValueError(f"mesh {config.mesh!r}: this rank runs on {dev}, "
                         f"not on {device.type}")
    return mesh, dev


def _agree(flag: bool, device) -> bool:
    """True on every rank when it is on any (one small all-reduce), so
    that the ranks stop at the same step."""
    from ..parallel import comm

    t = torch.tensor([float(flag)], device=device)
    return bool(comm.all_reduce_(t, None)[0] > 0)


class GracefulStop:
    """Preemption-safe stop request: SIGTERM/SIGINT (the notice a preempted
    worker gets) or a ``<workdir>/STOP`` file end the run gracefully: the
    in-flight step completes, the state is checkpointed, and
    ``run_training`` returns, so re-issuing the same command with
    ``resume=True`` continues bit for bit. The handlers are installed from
    the main thread only; elsewhere the STOP file is the only request.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._signals = signals
        self._saved = {}

    def _handle(self, signum, frame):
        self.requested = True

    def __enter__(self):
        try:
            for s in self._signals:
                self._saved[s] = signal.signal(s, self._handle)
        except ValueError:  # not the main thread: STOP-file polling only
            self._saved = {}
        return self

    def __exit__(self, *exc):
        for s, h in self._saved.items():
            signal.signal(s, h)
        return False


def run_training(
    config: ExperimentConfig,
    workdir: str,
    *,
    steps: Optional[int] = None,
    synthetic: bool = False,
    resume: bool = False,
    device="cuda",
) -> Tuple[GANState, dict]:
    """The reference's train() loop (mnist_moco_ode.py:51-195), config-driven,
    on ``device`` -> (state, the last step's losses).

    Writes ``<workdir>/metrics.jsonl`` and, with ``config.tensorboard``,
    ``<workdir>/tb/events.out.tfevents.*`` every ``log_every`` steps;
    ``<workdir>/samples/gensamples_id<step>.gif`` every ``sample_every``;
    ``<workdir>/checkpoints/<step>/`` every ``checkpoint_every`` and at the
    end. A non-finite loss at a log boundary checkpoints the last state and
    raises FloatingPointError.

    Preemption-safe: SIGTERM/SIGINT, or ``<workdir>/STOP`` (checked every
    ``log_every`` steps, then deleted), finish the current step, checkpoint,
    and return with ``"preempted"`` (the step reached) in the metrics dict;
    rerunning with ``resume=True`` continues from the latest checkpoint.

    ``config.mesh``: the N-way loop in every rank of the process group (the
    module docstring); ``device`` names the rank device's type. The ranks
    agree on a stop at every step.

    The batches come through ``prefetch`` (``PREFETCH_STEPS`` steps ahead),
    built after the restore so that the native streams start at the
    restored step. However the loop ends (its last step, a stop, a raise),
    the prefetch worker is stopped and joined, then the samplers closed.
    """
    dev = resolve_device(device)
    mesh = None
    if config.mesh:
        mesh, dev = _mesh_for(config, dev)
    lead = mesh is None or dist.get_rank() == 0  # writes the run's files
    os.makedirs(workdir, exist_ok=True)
    steps = steps if steps is not None else config.steps
    trainer = build_trainer(config, device=dev)
    state = trainer.init_state()

    ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"))
    start_step = 0
    if resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start_step = state.step
    if mesh is None:
        step_fn = make_host_data_step(trainer)
    else:
        step_fn, place_batch, state = make_mesh_data_step(trainer, state, mesh)
    img_sampler, vid_sampler = build_data(config, synthetic=synthetic,
                                          start_step=start_step)
    batch_iter = step_batches(img_sampler, vid_sampler, config, start_step,
                              steps)
    if mesh is not None:  # this rank's stripes, cut on the host
        batch_iter = (tuple(x.contiguous() for x in place_batch(*b))
                      for b in batch_iter)
    batches = prefetch(batch_iter, size=PREFETCH_STEPS, device=dev)
    logger = tb = None
    metrics = {}
    preempted = False
    stop_path = os.path.join(workdir, "STOP")
    try:
        if lead:
            logger = MetricsLogger(os.path.join(workdir, "metrics.jsonl"),
                                   print_every=config.log_every)
            if config.tensorboard:
                tb = EventWriter(os.path.join(workdir, "tb"))
        throughput = Throughput(config.batch_size,
                                1 if mesh is None else dist.get_world_size())
        throughput.start()
        with GracefulStop() as stop:
            for step in range(start_step, steps):
                images, videos = next(batches)
                metrics = step_fn(state, images, videos, step_generator(
                    config.seed, step, TRAIN, dev))
                throughput.update()

                if step % config.log_every == 0:
                    # float() waits for the step: the one host sync per log
                    # boundary, after which Throughput reads true
                    # (equal on every rank of a mesh: a raise is common)
                    vals = {k: float(v) for k, v in metrics.items()}
                    if not all(np.isfinite(v) for v in vals.values()):
                        if lead:
                            logger.log(step, vals,
                                       extra={"event": "non_finite_loss"})
                            ckpt.save(step, state)
                        raise FloatingPointError(
                            f"non-finite loss at step {step}: {vals}; "
                            f"last state checkpointed to {workdir}/checkpoints")
                    clips_per_sec = throughput.clips_per_sec_per_chip()
                    if lead:
                        logger.log(step, vals,
                                   extra={"clips_per_sec": clips_per_sec})
                    if tb is not None:
                        tb.add_scalars(
                            {f"train/{k}": v for k, v in vals.items()}
                            | {"perf/clips_per_sec": clips_per_sec}, step)
                        tb.flush()
                if (lead and config.sample_every
                        and step % config.sample_every == 0):
                    _write_samples(trainer, state, os.path.join(
                        workdir, "samples", f"gensamples_id{step}.gif"), config)
                if (lead and config.checkpoint_every
                        and step % config.checkpoint_every == 0):
                    ckpt.save(step, state)
                halt = stop.requested or (step % config.log_every == 0
                                          and os.path.exists(stop_path))
                if mesh is not None:
                    halt = _agree(halt, dev)
                if halt:
                    preempted = True
                    if lead:
                        logger.log(step, metrics, extra={"event": "preempted"})
                        if os.path.exists(stop_path):
                            os.remove(stop_path)  # honored; --resume goes on
                    break

        final_step = state.step
        if lead:
            ckpt.save(final_step, state)
        if mesh is not None:
            dist.barrier()  # the checkpoint is on disk before any rank returns
    finally:
        # the worker first: it may be inside a sampler
        batches.close()
        for s in (img_sampler, vid_sampler):  # native ones own C++ threads
            if hasattr(s, "close"):
                s.close()
        if logger is not None:
            logger.close()
        if tb is not None:
            tb.close()
    out = {k: float(v) for k, v in metrics.items()}
    if preempted:
        out["preempted"] = float(final_step)
    return state, out


def _write_samples(trainer: GANTrainer, state: GANState, path: str,
                   config: ExperimentConfig, n: int = 8):
    """An n x n grid GIF of ``sample_videos(n * n)`` in eval mode (the
    reference flips g.eval()/g.train() around sampling,
    mnist_moco_ode.py:32-35), with ``eval_gen_variables`` (the EMA weights
    when EMA is on) and noise from the step's ``SAMPLES`` stream."""
    gen = trainer.gen
    variables = trainer.eval_gen_variables(state)
    generator = step_generator(config.seed, state.step, SAMPLES, gen.device)
    gen.eval()
    try:
        with torch.no_grad():
            videos, _ = torch.func.functional_call(
                gen, variables, (n * n,), {"generator": generator})
    finally:
        gen.train()
    save_sample_grid(path, videos.float().cpu().numpy(), n=n)
    return path
