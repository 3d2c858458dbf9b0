"""The control, the reference with float8 operands put in the program's
place, fails at least one of each cell's limits (CPU, tiny sizes)."""

import pytest

from benchmark import calibrate, harness

MAN = harness.manifest()


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_control_fails_a_limit(workload, tiny_overrides):
    limits = harness.load_json(f"{harness.BENCH}/limits/{workload}.json")
    got = calibrate.reading(workload, 2**31 + 3, "control", 0.0, "cpu", tiny_overrides(workload))
    assert any(got[k] > limits[k] for k in limits), (got, limits)
