"""Checkpoints with the JAX package's retention semantics, stored with torch.save.

Counterpart of speaker_diarization_tpu/train/checkpoints.py: step-indexed
checkpoints (`step_<10 digits>.pt`, holding the Trainer's state: model,
optimizer, averaged weights, counters, dropout generator), `max_to_keep` of
the newest plus the `best_k` best by the validation metric (kept in
metrics.json), `latest_step`/`best_step`, and uniform averaging of the
parameters of several checkpoints.

The JAX trainer's Orbax directories (`step_<10 digits>/`, written by
`ocp.StandardCheckpointer`) in the same directory are listed and restored
too, through utils/orbax.py (no orbax or tensorstore): `restore` gives the
saved TrainState tree of such a step, and `average_orbax_params` the mean of
their `params` trees. They share metrics.json and `best_step`, and are
read-only: `save` and the pruning touch only the `.pt` files.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..parallel.mesh import is_main_process
from ..utils import orbax


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5, best_k: int = 3, metric_mode: str = "min"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep, self.best_k, self.metric_mode = max_to_keep, best_k, metric_mode
        self._metrics_path = os.path.join(self.directory, "metrics.json")
        self._metrics: Dict[str, float] = {}
        if os.path.exists(self._metrics_path):
            with open(self._metrics_path) as f:
                self._metrics = json.load(f)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}.pt")

    def save(self, trainer, metric: Optional[float] = None) -> str:
        """Write the trainer's state (rank 0 of a process group only: the
        ranks hold the same replicated state)."""
        path = self._path(trainer.step)
        if os.path.exists(path) or not is_main_process():
            return path
        tmp = path + ".tmp"
        torch.save(trainer.state_dict(), tmp)
        os.replace(tmp, path)
        if metric is not None:
            self._metrics[str(trainer.step)] = float(metric)
            with open(self._metrics_path, "w") as f:
                json.dump(self._metrics, f)
        self._prune()
        return path

    def _orbax_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def is_orbax(self, step: int) -> bool:
        """Whether `step` is a JAX Orbax directory (and no `.pt` of the port)."""
        return not os.path.exists(self._path(step)) and orbax.is_orbax_step(self._orbax_path(step))

    def restore(self, step: Optional[int] = None, map_location="cpu", select: Optional[Sequence[str]] = None):
        """The saved Trainer state of `step` (default: the latest); for a JAX
        Orbax step, its TrainState tree as numpy (only the top-level keys in
        `select`, e.g. ('params', 'mutable'), if given)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        if self.is_orbax(step):
            return orbax.restore(self._orbax_path(step), select)
        return torch.load(self._path(step), map_location=map_location, weights_only=False)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        steps = set()
        for n in os.listdir(self.directory):
            if n.startswith("step_") and n.endswith(".pt") and n[5:-3].isdigit():
                steps.add(int(n[5:-3]))
            elif len(n) == 15 and n.startswith("step_") and n[5:].isdigit() and orbax.is_orbax_step(
                    os.path.join(self.directory, n)):
                steps.add(int(n[5:]))
        return sorted(steps)

    def best_step(self) -> Optional[int]:
        if not self._metrics:
            return None
        key = min if self.metric_mode == "min" else max
        return int(key(self._metrics.items(), key=lambda kv: kv[1])[0])

    def _prune(self) -> None:
        protected = set()
        if self._metrics:
            order = sorted(self._metrics.items(), key=lambda kv: kv[1], reverse=self.metric_mode == "max")
            protected = {int(s) for s, _ in order[: self.best_k]}
        removable = [s for s in self.all_steps() if s not in protected and not self.is_orbax(s)]
        for s in removable[: max(0, len(removable) - self.max_to_keep)]:
            os.remove(self._path(s))
            self._metrics.pop(str(s), None)


def average_checkpoints(manager: CheckpointManager, steps: List[int], param_names) -> Dict[str, torch.Tensor]:
    """Uniform average of the parameters `param_names` over the checkpoints
    `steps` (float64 sums, float32 result), as a partial model state dict;
    buffers such as BatchNorm statistics are not averaged."""
    acc: Dict[str, torch.Tensor] = {}
    for s in steps:
        model = manager.restore(s)["model"]
        for k in param_names:
            acc[k] = acc.get(k, 0) + model[k].double()
    return {k: (v / len(steps)).float() for k, v in acc.items()}


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def average_orbax_params(manager: CheckpointManager, steps: List[int]) -> dict:
    """Uniform average of the `params` trees of the JAX Orbax checkpoints
    `steps` (float64 sums, float32 result), as the JAX package's
    average_checkpoints; statistics are not averaged."""
    acc = None
    for s in steps:
        p = manager.restore(s, select=("params",))["params"]
        acc = _tree_map(lambda x: np.asarray(x, np.float64), p) if acc is None else _tree_map(
            lambda a, x: a + np.asarray(x, np.float64), acc, p)
    return _tree_map(lambda a: (a / float(len(steps))).astype(np.float32), acc)
