"""A configuration, a traffic mix, a metric and a cell added as files and
manifest entries alone are found and run (CPU, tiny sizes)."""

import json
import shutil

from benchmark import harness


def test_new_files_are_picked_up(tmp_path):
    for sub in ("configs", "traffic", "limits", "metrics"):
        (tmp_path / sub).mkdir()
    cfg = harness.load_json(f"{harness.BENCH}/configs/tsvad_tf.json")
    cfg["tsvad"]["encoder_block_layers"] = [1, 1, 1]
    (tmp_path / "configs" / "tiny_tf.json").write_text(json.dumps(cfg))
    traffic = dict(harness.load_json(f"{harness.BENCH}/traffic/infer_windows.json"), batch=3, ring=2, meeting_s=6.0)
    (tmp_path / "traffic" / "three_windows.json").write_text(json.dumps(traffic))
    (tmp_path / "limits" / "tiny_tf.three_windows.json").write_text(
        json.dumps({"prob_max_abs": 0.5, "prob_mean_abs": 0.5}))
    shutil.copy(f"{harness.BENCH}/metrics/setup_s.py", tmp_path / "metrics" / "setup_s.py")
    (tmp_path / "metrics" / "calls_in_window.py").write_text("def read(ctx):\n    return float(ctx.calls)\n")
    man = {
        "configs": [{"name": "tiny_tf", "file": "x", "source": "x", "reduced": [], "why": "x"}],
        "workloads": [{"name": "tiny_tf.three_windows", "config": "tiny_tf", "traffic": "three_windows", "chips": 1,
                       "why": "x"}],
        "end_to_end": [{"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"},
                       {"name": "calls_in_window", "unit": "calls", "better": "higher", "bound": 0.1,
                        "source": "host_clock"}],
        "per_layer": [],
    }
    r = harness.run_cell("tiny_tf.three_windows", 5, 0.05, False, "cpu", man=man, bench_dir=str(tmp_path))
    assert set(r["metrics"]) == {"setup_s", "calls_in_window"}
    assert r["metrics"]["calls_in_window"]["value"] == r["attempted"] >= 1
    assert r["correct"], r["checks"]
