"""Profiling and tracing over torch.profiler, and the port's in-memory tracer.

Counterpart of speaker_diarization_tpu/utils/profiling.py: `trace(log_dir)`
records a torch.profiler trace of the enclosed region (CPU, and CUDA where
the device is a GPU) and writes it as a Chrome trace, `log_dir/trace.json`
(chrome://tracing, Perfetto).

The tracer records spans and counts at the program's layer boundaries and
keeps them in memory; it writes nothing itself.

- `span(name)` records the name, the enclosing span of the same thread, the
  start and end on the host clock (`perf_counter_ns`) and, once CUDA is
  initialised, a timing event pair on the current stream, which gives the
  span's length on the device clock. The events are resolved when read
  (`snapshot`), so a span adds no synchronisation to the path it times.
- `count(name, n)` adds `n` to a counter of the innermost open span.
- `snapshot()` reads what was recorded, `reset()` clears it. At most
  `MAX_SPANS` spans are kept; later ones are counted as `dropped`.

The tracer is off by default: then a span is one check of a module flag and
of `torch.autograd.profiler._is_profiler_enabled`, records nothing and
touches no CUDA state. It is on inside `tracing()` and while a torch
profiler records. Under a profiler every span also opens
`torch.profiler.record_function(name)`, so it sits in the exported Chrome
trace as a user annotation, on the clock of the kernels it launched.

While on, with CUDA initialised, the outermost span of a thread counts
`syncs`: each blocking host-device synchronisation that thread makes,
under the innermost span open when it was made. It sets
`torch.cuda.set_sync_debug_mode("warn")` while it is open, and catches
PyTorch's "called a synchronizing CUDA operation" warnings instead of
printing them. The mode covers what PyTorch marks as synchronising
(copies between host and device memory that block, `.item()`, stream and
event waits); torch.distributed and torch.sparse are not covered. Only the
warnings of the thread that opened the outermost span are counted: a sync
made in the autograd engine's device threads during a backward is seen
only if the engine hands its warning back to the thread that ran the
backward, and then counts under that thread's innermost span.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from typing import Dict, List

import torch
import torch.autograd.profiler as _autograd_profiler

TRACE_FILE = "trace.json"
MAX_SPANS = 1 << 16
SYNC_WARNING = "called a synchronizing CUDA operation"


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


# ---------------------------------------------------------------------------
# the tracer

_depth = 0  # open tracing() regions
_spans: List["_Span"] = []  # recorded spans, in the order they opened
_counts: Dict[str, int] = {}  # counts made outside every span
_dropped = 0
_next_id = 0
_local = threading.local()  # .stack: this thread's open spans, innermost last


def _cuda() -> bool:
    return torch.cuda.is_initialized()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _add(name: str, n: int) -> None:
    stack = _stack()
    counts = stack[-1].counts if stack else _counts
    counts[name] = counts.get(name, 0) + n


class _SyncCounter:
    """Counts the sync warnings of the thread that opened it under that
    thread's innermost open span, for as long as it is open."""

    def __init__(self):
        self.thread = threading.get_ident()
        self.mode = torch.cuda.get_sync_debug_mode()
        self.caught = warnings.catch_warnings()

    def __enter__(self):
        self.caught.__enter__()
        self.show = warnings.showwarning
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.showwarning = self._on_warning
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self.mode)
        self.caught.__exit__(*exc)
        return False

    def _on_warning(self, message, category, filename, lineno, file=None, line=None):
        if not str(message).startswith(SYNC_WARNING):
            self.show(message, category, filename, lineno, file, line)
        elif threading.get_ident() == self.thread:
            _add("syncs", 1)


class _Span:
    __slots__ = ("id", "name", "parent", "start_ns", "end_ns", "events", "device_ms", "counts", "_annotation",
                 "_syncs")

    def __init__(self, name: str):
        self.name = name
        self.end_ns = self.device_ms = self.events = self._annotation = self._syncs = None
        self.counts: Dict[str, int] = {}

    def __enter__(self):
        global _next_id, _dropped
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.id, _next_id = _next_id, _next_id + 1
        if len(_spans) < MAX_SPANS:
            _spans.append(self)
        else:
            _dropped += 1
        on_cuda = _cuda()
        if not stack and on_cuda:
            self._syncs = _SyncCounter().__enter__()
            self.counts["syncs"] = 0
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        if on_cuda:
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        _stack().pop()
        if self._syncs is not None:
            self._syncs.__exit__(*exc)
            self._syncs = None
        return False

    def as_dict(self) -> dict:
        if self.events is not None and self.end_ns is not None:
            self.events[1].synchronize()
            self.device_ms = self.events[0].elapsed_time(self.events[1])
            self.events = None
        host_ms = None if self.end_ns is None else (self.end_ns - self.start_ns) * 1e-6
        return dict(id=self.id, name=self.name, parent=self.parent, start_ns=self.start_ns, end_ns=self.end_ns,
                    host_ms=host_ms, device_ms=self.device_ms, counts=dict(self.counts))


class _Off:
    """What `span` returns while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager that records the enclosed region as span `name`
    while the tracer is on, and does nothing while it is off."""
    if not (_depth or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` of the innermost open span while the tracer is on."""
    if _depth or _autograd_profiler._is_profiler_enabled:
        _add(name, n)


@contextlib.contextmanager
def tracing():
    """Turn the tracer on for the enclosed region, with or without a profiler."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def snapshot() -> dict:
    """What the tracer recorded since the last `reset`: `spans`, a list of
    dicts (id, name, parent id or None, start_ns and end_ns on the host
    clock, host_ms, device_ms or None, counts) in the order they opened, an
    open span with end_ns None; `counts` made outside every span; `dropped`,
    the spans past MAX_SPANS. Resolving a span's device time waits for its
    end event, so read after the traced work has been synchronised."""
    return dict(spans=[s.as_dict() for s in list(_spans)], counts=dict(_counts), dropped=_dropped)


def reset() -> None:
    """Forget every recorded span and count (spans still open keep counting)."""
    global _dropped
    _spans.clear()
    _counts.clear()
    _dropped = 0

