"""The trace reduction: device busy time as a union, idle gaps named by the
innermost benchmark span, the top device operations."""

import pytest

from benchmark.trace import reduce_events


def ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def test_reduce_events():
    events = [
        ev("bench.window", "user_annotation", 0.0, 100.0),
        ev("bench.forward", "user_annotation", 0.0, 40.0),
        ev("bench.forward", "user_annotation", 40.0, 40.0),
        ev("bench.sync", "user_annotation", 80.0, 20.0),
        ev("k_a", "kernel", 10.0, 20.0),
        ev("k_b", "kernel", 25.0, 10.0),  # overlaps k_a: busy is a union
        ev("Memcpy DtoH", "gpu_memcpy", 50.0, 5.0),
        ev("k_a", "kernel", 60.0, 30.0),
        ev("aten::add", "cpu_op", 0.0, 100.0),
    ]
    r = reduce_events(events, 2)
    assert r["busy_s"] == pytest.approx(60e-6)  # [10, 35] + [50, 55] + [60, 90]
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["kernels"]["k_a"] == pytest.approx(50e-6)
    assert r["breakdown"]["device_ops"][0] == ["k_a", pytest.approx(50e-6)]
    gaps = dict(r["breakdown"]["idle_gaps"])
    # gaps: [0, 10] and [35, 40] in the first forward, [40, 50] and [55, 60] in the second, [90, 100] in the sync
    assert gaps["bench.forward"] == pytest.approx(30e-6)
    assert gaps["bench.sync"] == pytest.approx(10e-6)
