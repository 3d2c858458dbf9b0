"""Profiling and tracing over torch.profiler.

Counterpart of speaker_diarization_tpu/utils/profiling.py: `trace(log_dir)`
records a torch.profiler trace of the enclosed region (CPU, and CUDA where
the device is a GPU) and writes it as a Chrome trace, `log_dir/trace.json`
(chrome://tracing, Perfetto); `StepTimer` times steps on the host clock
with the device drained before the clock stops; `profile_fn` times a
function over a few warm calls and can trace one more.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the enclosed region; on exit write `log_dir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _drain(result) -> None:
    """Wait for the device work behind every CUDA tensor in `result`."""
    items = list(result.values()) if isinstance(result, dict) else (
        list(result) if isinstance(result, (list, tuple)) else [result])
    devices = {t.device for t in items if getattr(getattr(t, "device", None), "type", None) == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Host-clock step times; `stop(result)` waits for the device work
    behind `result` (a tensor, or a dict, list or tuple of them) first."""

    def __init__(self):
        self.times: list = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> None:
        if result is not None:
            _drain(result)
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return dict(mean_ms=float(a.mean() * 1e3), p50_ms=float(np.percentile(a, 50) * 1e3),
                    p95_ms=float(np.percentile(a, 95) * 1e3), steps=len(a))


def profile_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2, log_dir: Optional[str] = None) -> dict:
    """Time fn(*args) over `iters` calls after `warmup`; with `log_dir`,
    trace one more call there."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if out is not None:
        _drain(out)
    timer = StepTimer()
    for _ in range(iters):
        timer.start()
        timer.stop(fn(*args))
    if log_dir:
        with trace(log_dir):
            fn(*args)
    return timer.summary()
