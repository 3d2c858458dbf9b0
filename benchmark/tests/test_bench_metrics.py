"""Each reader reads its number where there is one and nothing where there is none."""

import types

import pytest

from benchmark import costs, harness

MAN = harness.manifest()


def ctx(loop, profile=None, **kw):
    t = harness.load_json(f"{harness.BENCH}/traffic/{'infer_windows' if loop == 'infer' else 'train_8s'}.json")
    m = harness.load_json(f"{harness.BENCH}/configs/tsvad_mamba.json")["tsvad"]
    c = types.SimpleNamespace(loop=loop, traffic=t, model_cfg=m, batch=t["batch"], calls=10, window_s=2.0,
                              setup_s=30.0, profile=profile, dispatch_s=[0.010, 0.012, 0.011], peaks=costs.PEAKS,
                              audio_s_per_call=t["batch"] * t["window_s"],
                              n_label=int(t["window_s"] * 25), flops_per_call=lambda: 1e12,
                              frames50=lambda: 199 if loop == "infer" else 399)
    c.__dict__.update(kw)
    return c


PROFILE = {"kernels": {"cam_block_tc_kernel": 0.004, "scan_bwd_kernel<64>": 0.02, "sum_rows_kernel": 0.001,
                       "gemm": 0.05}, "calls": 2, "busy_s": 0.08, "window_s": 0.1}


@pytest.mark.parametrize("m", MAN["end_to_end"] + MAN["per_layer"], ids=lambda m: m["name"])
def test_reader(m):
    read = harness.load_reader(m["name"])
    loops = {"infer", "train"} & set(m["name"].replace(".", "_").split("_")) or {"infer", "train"}
    for loop in loops:
        v = read(ctx(loop, PROFILE))
        assert v is not None and v > 0, (m["name"], loop)
        if m["unit"] == "%" and m["name"] != "idle_share." + loop:
            assert v < 100
    if m["source"] == "device_trace":
        assert read(ctx(next(iter(loops)), None)) is None
    other = {"infer", "train"} - loops
    for loop in other:
        assert read(ctx(loop, PROFILE)) is None


def test_rates():
    c = ctx("infer")
    assert harness.load_reader("infer_audio_s_per_s")(c) == pytest.approx(10 * 512 * 4.0 / 2.0)
    c = ctx("train")
    assert harness.load_reader("train_audio_s_per_s")(c) == pytest.approx(10 * 128 * 8.0 / 2.0)
    assert harness.load_reader("dispatch_ms.train")(c) == pytest.approx(11.0)
