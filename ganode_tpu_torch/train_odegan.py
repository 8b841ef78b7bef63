"""Stage-2 experiment: train a small image GAN with the ODE-GAN trainer
(optimizer-as-ODE, euler/rk2/rk4 in parameter space); twin of
``scripts/train_odegan.py``.

  python -m ganode_tpu_torch.train_odegan --method rk4 --steps 200 [--cpu]

The reference's stage-2 notebook protocol (MLP generator 100 -> 256 -> 512
-> 1024 -> 784 tanh, MLP discriminator with a leaky-ReLU trunk, the
notebook's seed, euler/rk2/rk4 against alternating Adam). ``--arch dcgan``
switches to the conv pair of the reference's CIFAR notebook on 32x32x3
images; ``--dry-run`` caps training at one step. The data are synthetic
blobs (``--synthetic``, or with ``--arch dcgan``, or when ``--data`` does not
exist), drawn as the JAX script draws them, or rotated-MNIST frames.

Writes ``<workdir>/losses_<method>.json`` (a list of ``{"step", "g_loss",
"d_loss"}`` every 20 steps, as the JAX script writes it) and TensorBoard
scalars under ``<workdir>/tb``. Runs on the CUDA card unless ``--cpu`` is
given; with no card and no ``--cpu`` it exits with an error. Randomness
comes from one ``torch.Generator`` on the device, seeded with ``--seed``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from . import resolve_device
from .nn.layers import init_dense, leaky_relu, lecun_normal_
from .train import ODEGANTrainer, bce_logits, module_params, reference_adam

Z_DIM = 100


def _init_conv(conv: nn.Module, fan_in: int, generator: torch.Generator):
    """flax ``nn.Conv`` / ``nn.ConvTranspose`` defaults: lecun_normal
    kernel over the kernel's ``kh * kw * C_in`` inputs, zero bias."""
    lecun_normal_(conv.weight, fan_in, generator)
    nn.init.zeros_(conv.bias)


class MLPGen(nn.Module):
    """100 -> 256 -> 512 -> 1024 -> 784, leaky ReLU 0.2, tanh
    (``scripts/train_odegan.py:59-64``)."""

    def __init__(self):
        super().__init__()
        for i, (a, b) in enumerate(zip((Z_DIM, 256, 512, 1024),
                                       (256, 512, 1024, 784))):
            self.add_module(f"Dense_{i}", nn.Linear(a, b))

    def init_parameters(self, generator: torch.Generator):
        for i in range(4):
            init_dense(getattr(self, f"Dense_{i}"), generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            z = leaky_relu(getattr(self, f"Dense_{i}")(z), 0.2)
        return torch.tanh(self.Dense_3(z))


class MLPDisc(nn.Module):
    """784 -> 512 -> 256 -> 1, leaky ReLU 0.2, one logit per row
    (``scripts/train_odegan.py:66-71``)."""

    def __init__(self):
        super().__init__()
        for i, (a, b) in enumerate(zip((784, 512, 256), (512, 256, 1))):
            self.add_module(f"Dense_{i}", nn.Linear(a, b))

    def init_parameters(self, generator: torch.Generator):
        for i in range(3):
            init_dense(getattr(self, f"Dense_{i}"), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            x = leaky_relu(getattr(self, f"Dense_{i}")(x), 0.2)
        return self.Dense_2(x).squeeze(-1)


class DCGANGen(nn.Module):
    """32x32x3 conv generator (the CIFAR notebook's stage-2 G,
    ``scripts/train_odegan.py:73-86``): Dense to 4x4x256, two (transposed
    conv 4, stride 2 -> GroupNorm(8) -> ReLU), a transposed conv to 3
    channels, tanh. Returns NHWC images. flax's ``ConvTranspose(4, s2,
    padding 2)`` is ``ConvTranspose2d(4, 2, 1)`` with the kernel flipped
    (``bridge``); flax's GroupNorm epsilon is 1e-6."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(Z_DIM, 4 * 4 * 256)
        chans = (256, 128, 64, 3)
        for i in range(3):
            self.add_module(f"ConvTranspose_{i}",
                            nn.ConvTranspose2d(chans[i], chans[i + 1], 4, 2, 1))
        for i in range(2):
            self.add_module(f"GroupNorm_{i}",
                            nn.GroupNorm(8, chans[i + 1], eps=1e-6))

    def init_parameters(self, generator: torch.Generator):
        init_dense(self.Dense_0, generator)
        for i in range(3):
            conv = getattr(self, f"ConvTranspose_{i}")
            _init_conv(conv, 16 * conv.in_channels, generator)
        for i in range(2):
            gn = getattr(self, f"GroupNorm_{i}")
            nn.init.ones_(gn.weight)
            nn.init.zeros_(gn.bias)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.Dense_0(z).reshape(-1, 4, 4, 256).permute(0, 3, 1, 2)
        for i in range(2):
            h = F.relu(getattr(self, f"GroupNorm_{i}")(
                getattr(self, f"ConvTranspose_{i}")(h)))
        return torch.tanh(self.ConvTranspose_2(h)).permute(0, 2, 3, 1)


class DCGANDisc(nn.Module):
    """Three (conv 4, stride 2, padding 1 -> leaky ReLU 0.2), then a Dense
    over the features flattened in NHWC order, as flax flattens them
    (``scripts/train_odegan.py:88-96``). Takes NHWC images."""

    def __init__(self):
        super().__init__()
        chans = (3, 64, 128, 256)
        for i in range(3):
            self.add_module(f"Conv_{i}", nn.Conv2d(chans[i], chans[i + 1], 4, 2, 1))
        self.Dense_0 = nn.Linear(4 * 4 * 256, 1)

    def init_parameters(self, generator: torch.Generator):
        for i in range(3):
            conv = getattr(self, f"Conv_{i}")
            _init_conv(conv, 16 * conv.in_channels, generator)
        init_dense(self.Dense_0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for i in range(3):
            h = leaky_relu(getattr(self, f"Conv_{i}")(h), 0.2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self.Dense_0(h).squeeze(-1)


ARCHS = {"mlp": (MLPGen, MLPDisc, (784,)), "dcgan": (DCGANGen, DCGANDisc,
                                                    (32, 32, 3))}


def build_nets(arch: str, seed: int, device):
    """-> (gen, disc, data_shape): the pair of ``arch``, weights drawn on the
    CPU from ``seed`` and ``seed + 1`` by flax's default initialisers, then
    moved to ``device``."""
    gen_cls, disc_cls, data_shape = ARCHS[arch]
    nets = []
    for cls, s in ((gen_cls, seed), (disc_cls, seed + 1)):
        net = cls()
        net.init_parameters(torch.Generator().manual_seed(s))
        nets.append(net.to(device))
    return (*nets, data_shape)


def make_losses(gen: nn.Module, disc: nn.Module, batch_size: int):
    """-> (g_loss, d_loss), each ``loss(all_params, noise, batch)`` over
    ``{"gen", "dis_img"}`` params (``scripts/train_odegan.py:139-150``):
    BCE with logits, fakes from ``z ~ N(0, I) (B, 100)``. ``noise`` is the
    draw, ``{"z": z}``, or a ``torch.Generator`` to draw it from."""

    def fake(params, noise):
        if isinstance(noise, dict):
            z = noise["z"]
        elif noise is None:
            raise ValueError("no noise and no torch.Generator for z")
        else:
            z = torch.randn((batch_size, Z_DIM), generator=noise,
                            device=noise.device)
        return functional_call(gen, params["gen"], (z,))

    def g_loss(params, noise, batch):
        logits = functional_call(disc, params["dis_img"], (fake(params, noise),))
        return bce_logits(logits, 1.0)

    def d_loss(params, noise, batch):
        pf = functional_call(disc, params["dis_img"], (fake(params, noise),))
        pr = functional_call(disc, params["dis_img"], (batch,))
        return bce_logits(pr, 1.0) + bce_logits(pf, 0.0)

    return g_loss, d_loss


def adam_update(opt: torch.optim.Optimizer, all_params, net: str, loss_fn,
                noise, batch=None):
    """One Adam step of ``all_params[net]`` (the tensors ``opt`` holds, in
    place) on ``loss_fn``'s gradient; the notebook's baseline."""
    params = list(all_params[net].values())
    with torch.enable_grad():
        for p in params:
            p.requires_grad_()
        grads = torch.autograd.grad(loss_fn(all_params, noise, batch), params,
                                    allow_unused=True)
    for p, g in zip(params, grads):
        p.requires_grad_(False)
        p.grad = torch.zeros_like(p) if g is None else g
    opt.step()
    opt.zero_grad(set_to_none=True)


def synthetic_data(arch: str, data_shape) -> np.ndarray:
    """2048 samples in [-1, 1]: an 8x8 square of 1 on -1, at a position drawn
    from ``RandomState(0)``, as the JAX script draws them."""
    rng = np.random.RandomState(0)
    n = 2048
    data = np.full((n,) + tuple(data_shape), -1.0, np.float32)
    for i in range(n):
        y, x = rng.randint(0, data_shape[0] - 8 if arch == "dcgan" else 20, 2)
        if arch == "dcgan":
            data[i, y:y + 8, x:x + 8, :] = 1.0
        else:
            img = data[i].reshape(28, 28)
            img[y:y + 8, x:x + 8] = 1.0
    return data


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m ganode_tpu_torch.train_odegan")
    p.add_argument("--method", default="rk4",
                   choices=["adam", "euler", "rk2", "rk4"],
                   help="'adam' is the notebook's baseline alternating-Adam "
                        "loop; the rest integrate the training ODE")
    p.add_argument("--arch", default="mlp", choices=["mlp", "dcgan"])
    p.add_argument("--dry-run", action="store_true",
                   help="one-batch smoke mode (the CIFAR notebook's dry_run)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--reg", type=float, default=0.01)
    p.add_argument("--d-iter", type=int, default=1)
    p.add_argument("--seed", type=int, default=97382)  # the notebook's seed
    p.add_argument("--workdir", default="runs/odegan")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic blobs instead of rotated-MNIST frames")
    p.add_argument("--data", default="data/rot-mnist.npz")
    args = p.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else "cuda")
    gen, disc, data_shape = build_nets(args.arch, args.seed, device)
    all_params = {"gen": module_params(gen), "dis_img": module_params(disc),
                  "dis_vid": None}

    if args.synthetic or not os.path.exists(args.data) or args.arch == "dcgan":
        data = synthetic_data(args.arch, data_shape)
    else:
        from .data.rotmnist import load_rotmnist
        videos, _ = load_rotmnist(args.data, train=True)
        data = videos.reshape(-1, 784) * 2.0 - 1.0
    data = torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(device)

    if args.dry_run:
        args.steps = 1
    B = args.batch_size
    g_loss, d_loss = make_losses(gen, disc, B)

    if args.method == "adam":
        # the notebook's baseline: alternating Adam(2e-4, betas=(0.5, 0.999))
        opt = {net: reference_adam(list(all_params[net].values()), lr=2e-4,
                                   b1=0.5, b2=0.999, weight_decay=0.0)
               for net in ("gen", "dis_img")}

        def d_step(p_, rng, b):
            adam_update(opt["dis_img"], p_, "dis_img", d_loss, rng, b)
            return p_

        def g_step(p_, rng):
            adam_update(opt["gen"], p_, "gen", g_loss, rng)
            return p_
    else:
        trainer = ODEGANTrainer(g_loss=g_loss, d_img_loss=d_loss, lr=args.lr,
                                reg=args.reg, method=args.method,
                                d_iter=args.d_iter)

        def d_step(p_, rng, b):
            return trainer.step(p_, rng, b, model="dis_img")

        def g_step(p_, rng):
            return trainer.step(p_, rng, model="gen")

    rng = torch.Generator(device).manual_seed(args.seed)
    losses = []
    os.makedirs(args.workdir, exist_ok=True)
    # TensorBoard scalars, as the reference's CIFAR notebook wrote them
    from .utils.tb import EventWriter
    tb = EventWriter(os.path.join(args.workdir, "tb"))
    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    t0 = t1 = clock()
    for step in range(args.steps):
        idx = torch.randint(0, len(data), (B,), generator=rng, device=device)
        batch = data[idx]
        for _ in range(args.d_iter):
            all_params = d_step(all_params, rng, batch)
        all_params = g_step(all_params, rng)
        if step % 20 == 0:
            with torch.no_grad():
                gl = float(g_loss(all_params, rng, None))
                dl = float(d_loss(all_params, rng, batch))
            losses.append({"step": step, "g_loss": gl, "d_loss": dl})
            tb.add_scalars({f"{args.method}/g_loss": gl,
                            f"{args.method}/d_loss": dl}, step)
            print(f"step {step}: G {gl:.4f} D {dl:.4f}", flush=True)
        if step == 0:
            t1 = clock()
    t2 = clock()
    tb.close()
    path = os.path.join(args.workdir, f"losses_{args.method}.json")
    with open(path, "w") as f:
        json.dump(losses, f)
    later = (f"; the {args.steps - 1} after the first "
             f"{(t2 - t1) / (args.steps - 1) * 1e3:.2f} ms/step"
             if args.steps > 1 else "")
    print(f"{args.steps} steps in {t2 - t0:.3f} s (the first, with its "
          f"one-time set-up, {(t1 - t0) * 1e3:.2f} ms{later}; the logged "
          "steps' losses included)")
    print(f"done; losses -> {path}")


if __name__ == "__main__":
    main()
