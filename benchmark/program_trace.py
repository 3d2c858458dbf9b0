"""The program's own spans and counters, as its tracer
(`speaker_diarization_tpu_torch/utils/profiling.py`) recorded them in the
profiled stretch of a `--trace 1` run.

The tracer records while a torch profiler does, so it holds the stretch's
calls and nothing of the window, which runs with the profiler off. A call
is one top-level span (`trainer.step`, `tsvad.forward`) with every span
under it. A program without the tracer, or a tracer that recorded nothing,
gives no calls, and the readers None.
"""

import statistics


def calls(top: str) -> list:
    """One list of spans a call: a closed top-level span `top` first, then each span under it."""
    try:
        from speaker_diarization_tpu_torch.utils import profiling
    except ImportError:
        return []
    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None:
        return []
    root, out = {}, {}
    for s in snapshot()["spans"]:
        if s["parent"] is None:
            if s["name"] == top and s["end_ns"] is not None:
                root[s["id"]] = s["id"]
                out[s["id"]] = [s]
        elif s["parent"] in root:
            root[s["id"]] = root[s["parent"]]
            out[root[s["id"]]].append(s)
    return list(out.values())


def span_ms(top: str, name: str, clock: str):
    """Median over calls of the ms of the call's spans `name` on `clock`
    (`host_ms`: host clock; `device_ms`: the span's events on the device)."""
    per_call = []
    for c in calls(top):
        ms = [s[clock] for s in c if s["name"] == name and s[clock] is not None]
        if ms:
            per_call.append(sum(ms))
    return statistics.median(per_call) if per_call else None


def counter(top: str, name: str):
    """Counter `name` a call, summed over the call's spans; None where the top span did not count it."""
    counted = [c for c in calls(top) if name in c[0]["counts"]]
    if not counted:
        return None
    return sum(s["counts"].get(name, 0) for c in counted for s in c) / len(counted)
