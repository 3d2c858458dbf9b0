"""The reference against the port's plain twins (CPU, float32, CAM++ (1, 1, 1)
at the published widths): forwards and three followed train steps agree
to float32 rounding, dropout masks included."""

import pytest

from benchmark import harness

TIGHT = {
    # float32 rounding carried through CAM++ and a 100-step recurrence
    "infer": {"prob_max_abs": 2e-4, "prob_mean_abs": 2e-5},
    # a leaf's Adam change flips sign on gradient entries near zero, so it is looser
    "train": {"loss_rel": 1e-5, "grad_gap": 5e-3, "change_gap": 2e-2},
}


@pytest.mark.parametrize("workload", ["tsvad_tf.infer_windows", "tsvad_mamba.infer_windows", "tsvad_tf.train_8s",
                                      "tsvad_mamba.train_8s"])
def test_reference_matches_the_port_in_fp32(workload, tiny_overrides):
    loop = "train" if "train" in workload else "infer"
    over = tiny_overrides(workload, config={"dtype": "float32"}, limits=TIGHT[loop])
    r = harness.run_cell(workload, 2**31 + 7, 0.05, False, "cpu", overrides=over)
    assert r["correct"], r["checks"]
