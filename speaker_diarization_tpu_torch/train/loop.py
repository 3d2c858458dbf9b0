"""The training loop: epochs, periodic validation, checkpoints, logs.

Counterpart of speaker_diarization_tpu/train/loop.py. The log line and the
`metrics.jsonl` train records carry:

- `steps_per_s`: train steps per wall second over the log interval;
- `device_step_ms`: one step timed on the host clock with the device
  drained before and after (the first step of each interval, the probe
  step), i.e. the device time of a step plus its launch overhead;
- from the probe step, which runs under the tracer (`utils/profiling`):
  `syncs`, the blocking host-device synchronisations the step made (None
  off CUDA); `forward_host_ms`, `backward_host_ms` and `update_host_ms`,
  the host time of the step's three phases (`Trainer.train_step`); and
  `update_device_ms`, the update's length on the device clock (None off
  CUDA).

The JAX package logs `device_util` (device_step_ms × steps / wall time)
where the port logs the probe step's phases: when the host paces the step,
the synced probe lasts as long as any other step and the ratio reads about
1 on a device that idles, so the port dropped it.

Losses stay on the device between log boundaries, so steps are not
serialised by host reads. `profile_dir` records a torch.profiler trace of
steps [profile_start, profile_start + profile_steps) as a Chrome trace
(`profiling.trace`), which holds the tracer's spans as user annotations.

In a process group every rank runs the loop on the same batches (the
Trainer keeps its rows of each), and rank 0 alone writes `metrics.jsonl`,
the checkpoints and the trace.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..parallel.mesh import is_main_process
from ..utils import profiling
from .checkpoints import CheckpointManager
from .trainer import Trainer

log = logging.getLogger(__name__)


def prefetch_iterator(it: Iterator[dict], depth: int = 6) -> Iterator[dict]:
    """Run a host batch iterator in a background thread with a bounded queue,
    overlapping wav reads and augmentation with the device step."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def worker():
        try:
            for item in it:
                if stop.is_set():
                    return
                q.put(item)
            q.put(end)
        except BaseException as e:  # handed to the consumer, which raises it
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while t.is_alive():  # unblock a worker waiting on a full queue
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True) for k, v in batch.items()}


def _probe_fields(spans: list) -> dict:
    """The log fields of one traced train step from the tracer's spans."""
    by_name = {s["name"]: s for s in spans}

    def ms(name, clock):
        v = by_name.get(name, {}).get(clock)
        return None if v is None else round(v, 2)

    counted = "syncs" in by_name.get("trainer.step", {}).get("counts", {})
    return dict(syncs=sum(s["counts"].get("syncs", 0) for s in spans) if counted else None,
                forward_host_ms=ms("trainer.forward", "host_ms"), backward_host_ms=ms("trainer.backward", "host_ms"),
                update_host_ms=ms("trainer.update", "host_ms"), update_device_ms=ms("trainer.update", "device_ms"))


def run_training(
    trainer: Trainer,
    make_train_iter: Callable[[int], Iterator[dict]],
    num_steps: int,
    make_valid_iter: Optional[Callable[[], Iterator[dict]]] = None,
    ckpt_manager: Optional[CheckpointManager] = None,
    log_every: int = 50,
    valid_every: int = 500,
    save_every: Optional[int] = None,
    metrics_path: Optional[str] = None,
    early_stop_patience: Optional[int] = None,
    early_stop_min_delta: float = 0.0,
    profile_dir: Optional[str] = None,
    profile_start: int = 10,
    profile_steps: int = 5,
) -> Trainer:
    """Train until `num_steps` (counting from trainer.step, so a resumed run
    continues), validating every `valid_every` steps and stopping early after
    `early_stop_patience` validations without improvement."""
    save_every = save_every or valid_every
    dev = trainer.device
    main = is_main_process()
    mf = open(metrics_path, "a") if metrics_path and main else None
    if not main:
        profile_dir = None
    epoch, t0, window = 0, time.time(), []
    best_vloss, bad_validations, stop = float("inf"), 0, False
    probe_next, device_probe_ms, probe = True, None, {}
    prof = None
    try:
        while trainer.step < num_steps and not stop:
            start_step = trainer.step
            for batch in prefetch_iterator(make_train_iter(epoch)):
                if profile_dir is not None and trainer.step == profile_start:
                    prof = profiling.trace(profile_dir)
                    prof.__enter__()
                batch = _to_device(batch, dev)
                if probe_next:
                    _sync(dev)
                    profiling.reset()
                    tp = time.perf_counter()
                    with profiling.tracing():
                        aux = trainer.train_step(batch)
                    _sync(dev)
                    device_probe_ms = (time.perf_counter() - tp) * 1e3
                    probe = _probe_fields(profiling.snapshot()["spans"])
                    probe_next = False
                else:
                    aux = trainer.train_step(batch)
                step = trainer.step
                if prof is not None and step == profile_start + profile_steps:
                    prof.__exit__(None, None, None)
                    log.info("profiler trace for steps [%d, %d) → %s", profile_start, step, profile_dir)
                    prof, profile_dir = None, None
                window.append(aux["loss"])
                if step % log_every == 0:
                    losses = [float(x) for x in window]  # drains the device queue
                    dt = time.time() - t0
                    msg = {
                        "step": step,
                        "epoch": epoch,
                        "loss": round(float(np.mean(losses)), 5),
                        "lr": round(float(aux["lr"]), 7),
                        "grad_norm": round(float(aux["grad_norm"]), 4),
                        "steps_per_s": round(len(losses) / max(dt, 1e-9), 3),
                        "device_step_ms": round(device_probe_ms or 0.0, 2),
                        **probe,
                    }
                    for k, v in aux.items():
                        if k not in ("loss", "lr", "grad_norm"):
                            msg[k] = round(float(v), 5)
                    log.info("train %s", msg)
                    probe_next = True
                    if mf:
                        mf.write(json.dumps({"kind": "train", **msg}) + "\n")
                        mf.flush()
                    window = []
                    t0 = time.time()
                if make_valid_iter is not None and step % valid_every == 0:
                    vloss = validate(trainer, make_valid_iter())
                    log.info("valid step=%d loss=%.5f", step, vloss)
                    if mf:
                        mf.write(json.dumps({"kind": "valid", "step": step, "loss": vloss}) + "\n")
                        mf.flush()
                    if ckpt_manager is not None:
                        ckpt_manager.save(trainer, metric=vloss)
                    if vloss < best_vloss - early_stop_min_delta:
                        best_vloss, bad_validations = vloss, 0
                    else:
                        bad_validations += 1
                        if early_stop_patience is not None and bad_validations >= early_stop_patience:
                            log.info("early stop at step %d: %d validations without improvement", step, bad_validations)
                            stop = True
                            break
                elif ckpt_manager is not None and step % save_every == 0:
                    ckpt_manager.save(trainer)
                if step >= num_steps:
                    break
            if trainer.step == start_step and not stop:
                raise RuntimeError(f"epoch {epoch} yielded no training batch (dataset smaller than the batch size?)")
            epoch += 1
    finally:
        if mf:
            mf.close()
        if prof is not None:
            prof.__exit__(None, None, None)
    if ckpt_manager is not None:
        ckpt_manager.save(trainer)
    return trainer


def validate(trainer: Trainer, batches: Iterator[dict]) -> float:
    losses = [float(trainer.eval_step(_to_device(b, trainer.device))["loss"]) for b in batches]
    if not losses:
        log.warning("validation iterator yielded no batches (dataset smaller than batch size?)")
        return float("nan")
    return float(np.mean(losses))
