"""A profiled stretch of a run's own calls, reduced to what the readers need.

`profile_stretch` runs `n` further calls of the loop, as the window runs
them (pipelined, one synchronise at the end), under torch.profiler with
host and device activity and the benchmark's spans (`bench.window`, one
span a call, `bench.sync`). From the trace it keeps:

- `kernels`: device time by kernel name (seconds), summed over the stretch;
- `busy_s`: the union of device activity (kernels, copies, sets) inside
  the `bench.window` span, and `window_s` that span's length;
- `breakdown`: the ten device operations that took most time, and the
  longest idle stretches of the device summed by the innermost benchmark
  span the host was in when each began.

The trace is written under TMPDIR and deleted once read.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce_events(events: List[dict], n_calls: int) -> Dict:
    """The stretch's numbers from chrome-trace events (times in µs)."""
    spans = [e for e in events if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("bench.")]
    win = next(e for e in spans if e["name"] == "bench.window")
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    kernels: Dict[str, float] = defaultdict(float)
    for e in dev:
        kernels[e["name"]] += e["dur"] * 1e-6
    busy = _union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev
                   if e["ts"] < w1 and e["ts"] + e["dur"] > w0])
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    inner = sorted((s for s in spans if s["name"] != "bench.window"), key=lambda s: s["dur"])
    by_span: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        name = next((s["name"] for s in inner if s["ts"] <= a < s["ts"] + s["dur"]), "bench.window")
        by_span[name] += (b - a) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        kernels=dict(kernels), calls=n_calls, busy_s=sum(b - a for a, b in busy) * 1e-6, window_s=win["dur"] * 1e-6,
        breakdown=dict(device_ops=[[k, v] for k, v in top],
                       idle_gaps=[[k, v] for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])[:10]]))


def profile_stretch(ctx, call, start: int, n: int, span: str) -> Dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    ctx.sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            for i in range(n):
                with record_function(span):
                    call(start + i, timed=False)
            with record_function("bench.sync"):
                ctx.sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce_events(events, n)
