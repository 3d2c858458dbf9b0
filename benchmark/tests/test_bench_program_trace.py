"""The readers of the program's own spans and counter read a number from a
tracer filled by real tiny train steps and forwards under torch.profiler
(as the profiled stretch runs them), and None from an empty tracer (CPU).

The CPU has no device clock and no sync debug mode: fake CUDA events stand
in for the card's, and a sync warning raised inside the speech encoder
stands in for the blocking copies the card reports there."""

import types
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
from speaker_diarization_tpu_torch.train.tasks import make_tsvad_loss
from speaker_diarization_tpu_torch.train.trainer import Trainer, TrainerConfig
from speaker_diarization_tpu_torch.utils import profiling

MAN = harness.manifest()
READERS = [m for m in MAN["per_layer"] if m["source"] in ("program_span", "program_counter")]
TINY = dict(encoder_block_layers=(1, 1), transformer_embed_dim=32, transformer_ffn_embed_dim=64,
            num_attention_head=2, speaker_embed_dim=16, num_transformer_layer=1)
N_LABEL = 50


class FakeEvent:
    clock = 0.0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        FakeEvent.clock += 1.0
        self.t = FakeEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture(scope="module")
def filled():
    """The tracer's snapshot after 2 tiny train steps and 3 tiny forwards, each under the profiler."""
    mp = pytest.MonkeyPatch()
    mp.setattr(profiling, "_cuda", lambda: True)
    mp.setattr(torch.cuda, "Event", FakeEvent)
    mp.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    mp.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    encode = TSVADModel.encode_speech

    def encode_with_a_sync(self, *a, **k):
        warnings.warn(profiling.SYNC_WARNING)
        return encode(self, *a, **k)

    mp.setattr(TSVADModel, "encode_speech", encode_with_a_sync)
    g = torch.Generator().manual_seed(0)
    batch = dict(audio=torch.randn(2, 32000, generator=g), target_embs=torch.randn(2, 4, 16, generator=g),
                 labels=(torch.rand(2, N_LABEL, 4, generator=g) < 0.3).float())
    model = TSVADModel(TSVADConfig(**TINY), device="cpu", seed=1)
    trainer = Trainer(model, make_tsvad_loss(N_LABEL), TrainerConfig(schedule="const", learning_rate=1e-3))
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                trainer.train_step(batch)
        train = profiling.snapshot()
        profiling.reset()
        model.eval()
        with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
            for _ in range(3):
                model(batch["audio"], batch["target_embs"], N_LABEL)
        infer = profiling.snapshot()
    finally:
        profiling.reset()
        mp.undo()
    return dict(train=train, infer=infer)


@pytest.mark.parametrize("m", READERS, ids=lambda m: m["name"])
def test_reader_reads_the_tracer(m, filled, monkeypatch):
    read = harness.load_reader(m["name"])
    loop = m["name"].rsplit(".", 1)[1]
    ctx = types.SimpleNamespace(loop=loop)
    assert read(ctx) is None  # an empty tracer
    monkeypatch.setattr(profiling, "snapshot", lambda: filled[loop])
    v = read(ctx)
    assert v is not None and v > 0, m["name"]
    if m["source"] == "program_counter":
        assert v == 1.0  # one sync a call, counted once under the call's top span
    other = {"train": "infer", "infer": "train"}[loop]
    monkeypatch.setattr(profiling, "snapshot", lambda: filled[other])
    assert read(ctx) is None


def test_a_program_without_the_tracer_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "snapshot")
    for m in READERS:
        assert harness.load_reader(m["name"])(types.SimpleNamespace(loop="train")) is None


def test_phase_and_device_readings(filled, monkeypatch):
    monkeypatch.setattr(profiling, "snapshot", lambda: filled["train"])
    steps = [s for s in filled["train"]["spans"] if s["name"] == "trainer.step"]
    fwd = sorted(s["host_ms"] for s in filled["train"]["spans"] if s["name"] == "trainer.forward")
    assert len(steps) == 2
    assert harness.load_reader("forward_host_ms.train")(None) == pytest.approx(sum(fwd) / 2)
    monkeypatch.setattr(profiling, "snapshot", lambda: filled["infer"])
    enc = harness.load_reader("encode_device_ms.infer")(None)
    back = harness.load_reader("backend_device_ms.infer")(None)
    # the fake clock moves 1 ms a record; no span opens inside either, so their two records are adjacent
    assert enc == 1.0 and back == 1.0
