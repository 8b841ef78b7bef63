"""Checkpoints of a whole ``GANState`` (twin of
``ganode_tpu/utils/checkpoint.py``, which uses orbax).

One ``torch.save`` blob per step, ``<directory>/<step>/state.pt``, holding
each net's module ``state_dict`` (parameters and BatchNorm running
statistics) and ``torch.optim.Adam`` ``state_dict``, the step, the EMA
parameters and the ADA controller's probabilities. The blob names no path, so a step directory copied elsewhere
restores bit for bit. A save writes a temporary file and moves it into place
with ``os.replace``, so a reader never sees half a checkpoint. Saves are
synchronous, so there is no ``wait`` flag and nothing to ``close``, as the
JAX manager's asynchronous orbax saves have.

The step is the only random state a resume needs: the runner derives every
batch and every noise draw from ``(config.seed, step)``.
"""
from __future__ import annotations

import os
import shutil
from typing import List, Optional

import torch

NETS = ("gen", "dis_img", "dis_vid")
_BLOB = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), _BLOB)

    def save(self, step: int, state) -> bool:
        """Write ``state`` as step ``step`` -> True; False (nothing written)
        when a checkpoint at this step or a later one exists, as orbax
        does. Keeps the newest ``max_to_keep`` steps."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        blob = {name: {"module": getattr(state, name).module.state_dict(),
                       "opt": getattr(state, name).opt.state_dict()}
                for name in NETS}
        blob["step"] = int(state.step)
        blob["ema_params"] = state.ema_params
        blob["ada"] = state.ada
        path = self._path(step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(blob, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, state, step: Optional[int] = None):
        """Load step ``step`` (default: the latest) into ``state`` in place
        and return it. Raises FileNotFoundError when there is none.

        The optional slots follow the JAX manager's
        ``_reconcile_optional_slots``. The EMA slot follows the checkpoint
        both ways: a state built without EMA gets the saved EMA parameters,
        and one built with EMA loses its slot when the checkpoint has none.
        A saved ``ada`` is loaded whatever the state was built with; a
        checkpoint without one (written with ADA off, or before ADA was
        ported) leaves the state's own, so an ADA run resumed from it starts
        its controller afresh at the caller's ``p``.
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        device = next(state.gen.module.parameters()).device
        blob = torch.load(self._path(step), map_location=device,
                          weights_only=True)
        for name in NETS:
            net = getattr(state, name)
            net.module.load_state_dict(blob[name]["module"])
            opt = blob[name]["opt"]
            # a non-capturable Adam keeps its step counts on the host;
            # map_location moved them with the rest
            for s in opt["state"].values():
                s["step"] = s["step"].cpu()
            net.opt.load_state_dict(opt)
        state.step = int(blob["step"])
        state.ema_params = blob["ema_params"]
        if blob.get("ada") is not None:
            state.ada = blob["ada"]
        return state

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(self._path(int(d))))
