#!/usr/bin/env python
"""Import a JAX training run's orbax checkpoint into a workdir of the
PyTorch port (``ganode_tpu_torch``).

  python scripts/import_jax_checkpoint.py --config ucf_wgan_gp_128 \
      --ckpt ckpt/wgan128_r4/checkpoints --out runs/wgan128_r4_torch \
      --set batch_size=32 --set compute_dtype=bfloat16 \
      --set ema_decay=0.999 --set diffaug=color,translation,cutout \
      [--step 5551]

(the flags the north-star run trained with, as ``scripts/diag_raw_vs_ema.py``
builds its config). It builds the JAX trainer for the config, restores the
checkpoint (the latest, or ``--step``) into the abstract shape of its state
(``jax.eval_shape``: nothing is initialised or compiled at full size),
carries every net's params, batch statistics, spectral-norm ``u`` and Adam
state, the step and the EMA params across with
``ganode_tpu_torch.bridge.gan_state_to_torch`` into the port's trainer state
for the same config, built on the CPU, and saves that as
``<out>/checkpoints/<step>/state.pt``. The port then serves and scores it
with no further code:

  python -m ganode_tpu_torch.generate --config ucf_wgan_gp_128 \
      --workdir OUT --cpu --num 4 --out v.npz
  python -m ganode_tpu_torch.evaluate --config ucf_wgan_gp_128 \
      --workdir OUT --cpu --synthetic

It prints the dtypes of the checkpoint's leaves: the north star's are all
float32 (142 leaves; its bfloat16 is a compute dtype, not a storage one)
but for the int32 Adam counts and step, which cross as the port's Adam step
and step count, and the uint32 PRNG key, which the port has no use for (it
draws every step's randomness from ``(seed, step)``). Reading orbax needs
jax, so this script sits beside the JAX scripts and runs JAX on the CPU; the
port package imports none of it.
"""
import argparse
import collections
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def restore_jax_state(name: str, sets, ckpt_dir: str, step=None):
    """The JAX trainer state of config ``name`` with the ``--set`` strings
    ``sets`` at ``step`` (default: the latest) of the orbax checkpoints in
    ``ckpt_dir`` -> (state with numpy leaves, step)."""
    import jax
    import numpy as np

    from ganode_tpu.train.runner import build_trainer
    from ganode_tpu.utils.checkpoint import CheckpointManager
    from ganode_tpu.utils.config import get_config, overrides_from_strings

    jax.config.update("jax_platforms", "cpu")
    config = get_config(name, **overrides_from_strings(sets))
    trainer = build_trainer(config)
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    mgr = CheckpointManager(ckpt_dir)
    # the template in the dtypes a training run saves (x64 off): orbax
    # casts each leaf to its template's dtype, and under x64 the optimizer
    # state would come back float64
    with jax.enable_x64(False):
        template = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=cpu),
            jax.eval_shape(trainer.init_state,
                           jax.random.PRNGKey(config.seed)))
        try:
            step = mgr.latest_step() if step is None else step
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
            state = mgr.restore(template, step)
        finally:
            mgr.close()
    return jax.tree.map(np.asarray, state), int(step)


def leaf_dtypes(jax_state) -> dict:
    """{dtype name: number of leaves} of a state."""
    import jax
    return dict(collections.Counter(
        str(a.dtype) for a in jax.tree_util.tree_leaves(jax_state)))


def import_checkpoint(name: str, sets, ckpt_dir: str, step=None):
    """-> (the port's ``GANState`` on the CPU holding the JAX checkpoint of
    config ``name`` with the ``--set`` strings ``sets``, the step, the JAX
    state with numpy leaves)."""
    from ganode_tpu_torch.bridge import gan_state_to_torch
    from ganode_tpu_torch.train import build_trainer
    from ganode_tpu_torch.utils.config import get_config, overrides_from_strings

    jax_state, step = restore_jax_state(name, sets, ckpt_dir, step)
    config = get_config(name, **overrides_from_strings(sets))
    state = build_trainer(config, device="cpu").init_state()
    gan_state_to_torch(jax_state, state)
    return state, step, jax_state


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", required=True,
                   help="the JAX run's checkpoint directory "
                        "(<workdir>/checkpoints)")
    p.add_argument("--out", required=True, help="the port workdir to write")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--set", dest="sets", action="append", default=[],
                   metavar="FIELD=VALUE",
                   help="config overrides: the trained run's sizes")
    args = p.parse_args(argv)

    from ganode_tpu_torch.utils.checkpoint import CheckpointManager
    from ganode_tpu_torch.utils.config import overrides_from_strings

    try:
        overrides_from_strings(args.sets)
    except ValueError as e:
        p.error(f"--set {e}")
    mgr = CheckpointManager(os.path.join(args.out, "checkpoints"))
    if mgr.latest_step() is not None:
        sys.exit(f"error: {args.out} already holds a checkpoint (step "
                 f"{mgr.latest_step()})")
    state, step, jax_state = import_checkpoint(args.config, args.sets,
                                               args.ckpt, args.step)
    print(f"restored JAX step {step}: leaves by dtype {leaf_dtypes(jax_state)}"
          f"; EMA {'present' if jax_state.ema_params is not None else 'absent'}"
          f", ADA {'present' if jax_state.ada is not None else 'absent'}")
    mgr.save(step, state)
    print(f"wrote {os.path.join(mgr.directory, str(step), 'state.pt')}")
    return step


if __name__ == "__main__":
    main()
