"""Checkpoints with the JAX package's retention semantics, stored with torch.save.

Counterpart of speaker_diarization_tpu/train/checkpoints.py: step-indexed
checkpoints (`step_<10 digits>.pt`, holding the Trainer's state: model,
optimizer, averaged weights, counters, dropout generator), `max_to_keep` of
the newest plus the `best_k` best by the validation metric (kept in
metrics.json), `latest_step`/`best_step`, and uniform averaging of the
parameters of several checkpoints. The JAX trainer's Orbax directories are
not read: that needs orbax, which the port does not import.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import torch

from ..parallel.mesh import is_main_process


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

    def restore(self, step: Optional[int] = None, map_location="cpu") -> dict:
        """The saved Trainer state of `step` (default: the latest)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self._path(step), map_location=map_location, weights_only=False)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(n[5:-3]) for n in os.listdir(self.directory) if n.startswith("step_") and n.endswith(".pt"))

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
        removable = [s for s in self.all_steps() if s not in protected]
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
