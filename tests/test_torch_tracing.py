"""The port's in-memory tracer (`utils/profiling.py`) and its spans in
`Trainer.train_step` and `TSVADModel.forward`, at tiny sizes on the CPU.

Off, it records nothing and touches no CUDA state; under torch.profiler its
spans nest as the code does and sit in the Chrome trace around the ops they
launched; counts go to the innermost open span; a fake CUDA stands in for
the card's events and sync warnings; the training numbers are bitwise the
same with the tracer on and off; `run_training` logs the probe step's
phases."""

import json
import threading
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
from speaker_diarization_tpu_torch.train.loop import run_training
from speaker_diarization_tpu_torch.train.tasks import make_tsvad_loss
from speaker_diarization_tpu_torch.train.trainer import Trainer, TrainerConfig
from speaker_diarization_tpu_torch.utils import profiling

torch.set_num_threads(1)

TINY = dict(encoder_block_layers=(1, 1), transformer_embed_dim=32, transformer_ffn_embed_dim=64,
            num_attention_head=2, speaker_embed_dim=16, num_transformer_layer=1)
N_LABEL = 50  # 25 Hz labels of 2 s
STEP_SPANS = ["trainer.step", "trainer.forward", "tsvad.forward", "tsvad.encode", "tsvad.backends",
              "trainer.backward", "trainer.update"]
PARENT = {"trainer.forward": "trainer.step", "tsvad.forward": "trainer.forward", "tsvad.encode": "tsvad.forward",
          "tsvad.backends": "tsvad.forward", "trainer.backward": "trainer.step", "trainer.update": "trainer.step"}


@pytest.fixture(autouse=True)
def empty_tracer():
    profiling.reset()
    yield
    profiling.reset()


def _batch(seed=0, B=2):
    rng = np.random.default_rng(seed)
    return dict(audio=rng.standard_normal((B, 32000)).astype(np.float32),
                target_embs=rng.standard_normal((B, 4, 16)).astype(np.float32),
                labels=(rng.random((B, N_LABEL, 4)) < 0.3).astype(np.float32))


def _trainer():
    model = TSVADModel(TSVADConfig(**TINY), device="cpu", seed=1)
    return Trainer(model, make_tsvad_loss(N_LABEL), TrainerConfig(schedule="const", learning_rate=1e-3, seed=3))


def _torch_batch(seed=0):
    return {k: torch.from_numpy(v) for k, v in _batch(seed).items()}


class FakeEvent:
    """A CUDA timing event on a counter clock: each record is 1 ms later."""

    clock = 0.0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        FakeEvent.clock += 1.0
        self.t = FakeEvent.clock

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA initialised as the tracer sees it: fake events and sync debug mode."""
    modes = [0]
    monkeypatch.setattr(profiling, "_cuda", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda m: modes.append({"warn": 1}.get(m, m)))
    return modes


def _sync_warning():
    """What PyTorch raises at a synchronising CUDA call in sync debug mode "warn"."""
    warnings.warn(profiling.SYNC_WARNING + " (Triggered internally at c10/cuda/CUDAFunctions.h:120.)")


def test_off_records_nothing_and_touches_no_cuda_state(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the tracer touched CUDA or the profiler while off")

    monkeypatch.setattr(profiling, "_cuda", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tr = _trainer()
    tr.train_step(_torch_batch())
    with torch.no_grad():
        tr.model.eval()
        tr.model(_torch_batch()["audio"], _torch_batch()["target_embs"], N_LABEL)
    profiling.count("syncs", 5)
    assert profiling.snapshot() == dict(spans=[], counts={}, dropped=0)
    assert profiling.span("x") is profiling.span("y")  # the one shared no-op


def test_train_step_spans_nest_on_the_profiler_clock(tmp_path):
    tr = _trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_step(_torch_batch())
    spans = profiling.snapshot()["spans"]
    assert [s["name"] for s in spans] == STEP_SPANS
    by_name = {s["name"]: s for s in spans}
    step = by_name["trainer.step"]
    assert step["parent"] is None and all(s["device_ms"] is None and s["counts"] == {} for s in spans)
    for child, parent in PARENT.items():
        c, p = by_name[child], by_name[parent]
        assert c["parent"] == p["id"]
        assert p["start_ns"] <= c["start_ns"] < c["end_ns"] <= p["end_ns"]
        assert c["host_ms"] == pytest.approx((c["end_ns"] - c["start_ns"]) * 1e-6)
    phases = sum(by_name[n]["host_ms"] for n in ("trainer.forward", "trainer.backward", "trainer.update"))
    assert phases <= step["host_ms"]

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    notes = {e["name"]: e for e in events if e.get("cat") == "user_annotation" and e["name"] in by_name}
    assert sorted(notes) == sorted(STEP_SPANS)
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("ph") == "X"]

    def inside(e, outer):
        return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]

    for name, note in notes.items():
        assert any(inside(op, note) for op in ops), name
    for child, parent in PARENT.items():
        assert inside(notes[child], notes[parent])
    assert any(inside(op, notes["tsvad.encode"]) and op["name"].startswith("aten::conv") for op in ops)
    assert any(inside(op, notes["trainer.update"]) and "Adam" in op["name"] for op in
               [e for e in events if e.get("ph") == "X"])


def test_tracing_without_a_profiler_records_and_opens_no_annotation(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function opened without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    model = TSVADModel(TSVADConfig(**TINY), device="cpu", seed=1).eval()
    b = _torch_batch()
    with profiling.tracing(), torch.no_grad():
        model(b["audio"], b["target_embs"], N_LABEL)
    assert [s["name"] for s in profiling.snapshot()["spans"]] == ["tsvad.forward", "tsvad.encode", "tsvad.backends"]
    assert profiling.span("after") is profiling.span("off again")


def test_count_goes_to_the_innermost_open_span():
    with profiling.tracing():
        profiling.count("items", 2)
        with profiling.span("outer"):
            profiling.count("items")
            with profiling.span("inner"):
                profiling.count("items", 3)
                profiling.count("bytes", 10)
            profiling.count("items", 4)
    snap = profiling.snapshot()
    assert snap["counts"] == {"items": 2}
    outer, inner = snap["spans"]
    assert outer["counts"] == {"items": 5} and inner["counts"] == {"items": 3, "bytes": 10}
    assert inner["parent"] == outer["id"]
    profiling.reset()
    assert profiling.snapshot() == dict(spans=[], counts={}, dropped=0)


def test_syncs_count_under_the_innermost_span_on_cuda(fake_cuda):
    """With CUDA initialised the outermost span turns sync warnings on, counts
    each under the innermost span of its thread and restores the mode;
    events give each span's device ms."""
    with profiling.tracing():
        with profiling.span("step"):
            assert fake_cuda[-1] == 1
            _sync_warning()
            with profiling.span("forward"):
                _sync_warning()
                _sync_warning()
                t = threading.Thread(target=_sync_warning)  # another thread's sync is not this step's
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
            assert fake_cuda[-1] == 1
        assert fake_cuda[-1] == 0
    step, forward = profiling.snapshot()["spans"]
    assert step["counts"] == {"syncs": 1} and forward["counts"] == {"syncs": 2}
    assert forward["device_ms"] == 1.0  # its two records, one fake ms apart
    assert step["device_ms"] == 3.0


def test_sync_warnings_are_caught_and_others_passed_on(fake_cuda, recwarn):
    with profiling.tracing(), profiling.span("step"):
        _sync_warning()
        warnings.warn("not a sync")
    assert [str(w.message) for w in recwarn] == ["not a sync"]
    assert profiling.snapshot()["spans"][0]["counts"] == {"syncs": 1}


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.tracing():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    snap = profiling.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["s0", "s1", "s2"] and snap["dropped"] == 2


@pytest.mark.parametrize("on", ["tracing", "profiler"])
def test_training_is_bitwise_equal_with_the_tracer_on(on):
    ref, got = _trainer(), _trainer()
    a = [ref.train_step(_torch_batch(k))["loss"] for k in range(2)]
    ctx = profiling.tracing() if on == "tracing" else profile(activities=[ProfilerActivity.CPU])
    with ctx:
        b = [got.train_step(_torch_batch(k))["loss"] for k in range(2)]
    assert len(profiling.snapshot()["spans"]) == 2 * len(STEP_SPANS)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for (n, p), q in zip(ref.named, got.params):
        assert torch.equal(p, q), n
        assert torch.equal(ref.opt.state[p]["exp_avg"], got.opt.state[q]["exp_avg"]), n
    for (n, x), y in zip(ref.model.named_buffers(), got.model.buffers()):
        assert torch.equal(x, y), n


def test_run_training_logs_the_probe_step_phases(tmp_path):
    tr = _trainer()
    metrics = tmp_path / "metrics.jsonl"
    run_training(tr, lambda epoch: iter([_batch(k) for k in range(3)]), num_steps=3, log_every=1,
                 metrics_path=str(metrics), profile_dir=str(tmp_path / "prof"), profile_start=1, profile_steps=1)
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3]
    for r in rows:
        assert "device_util" not in r
        assert r["syncs"] is None and r["update_device_ms"] is None  # no CUDA: nothing counted on a device
        assert all(r[k] > 0 for k in ("forward_host_ms", "backward_host_ms", "update_host_ms", "device_step_ms"))
        assert r["forward_host_ms"] + r["backward_host_ms"] + r["update_host_ms"] <= r["device_step_ms"]
    events = json.loads((tmp_path / "prof" / profiling.TRACE_FILE).read_text())["traceEvents"]
    notes = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert notes.count("trainer.step") == 1 and set(STEP_SPANS) <= set(notes)
