"""The training loop: epochs, periodic validation, checkpoints, logs.

Counterpart of speaker_diarization_tpu/train/loop.py, with the same log
fields and `metrics.jsonl` records:

- `steps_per_s`: train steps per wall second over the log interval;
- `device_step_ms`: one step timed with the device drained before and after
  (the first step of each interval), i.e. the device time of a step plus
  its launch overhead;
- `device_util`: device_step_ms × steps / wall time of the interval, capped
  at 1; 1 − util is the time the input pipeline stalls the device.

Losses stay on the device between log boundaries, so steps are not
serialised by host reads. `profile_dir` records a torch.profiler trace of
steps [profile_start, profile_start + profile_steps) as a Chrome trace.

In a process group every rank runs the loop on the same batches (the
Trainer keeps its rows of each), and rank 0 alone writes `metrics.jsonl`,
the checkpoints and the trace.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..parallel.mesh import is_main_process
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
    probe_next, device_probe_ms = True, None
    prof = None
    try:
        while trainer.step < num_steps and not stop:
            start_step = trainer.step
            for batch in prefetch_iterator(make_train_iter(epoch)):
                if profile_dir is not None and trainer.step == profile_start:
                    from torch.profiler import ProfilerActivity, profile

                    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
                    prof = profile(activities=acts)
                    prof.__enter__()
                batch = _to_device(batch, dev)
                if probe_next:
                    _sync(dev)
                    tp = time.perf_counter()
                    aux = trainer.train_step(batch)
                    _sync(dev)
                    device_probe_ms = (time.perf_counter() - tp) * 1e3
                    probe_next = False
                else:
                    aux = trainer.train_step(batch)
                step = trainer.step
                if prof is not None and step == profile_start + profile_steps:
                    _sync(dev)
                    prof.__exit__(None, None, None)
                    os.makedirs(profile_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
                    log.info("profiler trace for steps [%d, %d) → %s", profile_start, step, profile_dir)
                    prof, profile_dir = None, None
                window.append(aux["loss"])
                if step % log_every == 0:
                    losses = [float(x) for x in window]  # drains the device queue
                    dt = time.time() - t0
                    dev_s = (device_probe_ms or 0.0) * 1e-3 * len(losses)
                    msg = {
                        "step": step,
                        "epoch": epoch,
                        "loss": round(float(np.mean(losses)), 5),
                        "lr": round(float(aux["lr"]), 7),
                        "grad_norm": round(float(aux["grad_norm"]), 4),
                        "steps_per_s": round(len(losses) / max(dt, 1e-9), 3),
                        "device_step_ms": round(device_probe_ms or 0.0, 2),
                        "device_util": round(min(1.0, dev_s / max(dt, 1e-9)), 3),
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
