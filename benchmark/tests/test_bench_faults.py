"""A run whose timed path is broken underneath comes out not correct, at the
cells' own limits (CPU, tiny sizes): a window's answer altered where it is
made, half of a batch left out, a step that leaves its state unchanged."""

import pytest
import torch

from benchmark import calibrate, harness
from speaker_diarization_tpu_torch.models.tsvad import TSVADModel
from speaker_diarization_tpu_torch.train.trainer import Trainer


def _altered(monkeypatch):
    orig = TSVADModel.forward

    def forward(self, *a, **k):
        out = orig(self, *a, **k).clone()
        out[0] += 4.0  # the first window's answer
        return out

    monkeypatch.setattr(TSVADModel, "forward", forward)


def _half_rows(monkeypatch):
    orig = TSVADModel.forward

    def forward(self, audio, embs, *a, **k):
        h = audio.shape[0] // 2
        out = orig(self, audio[:h], embs[:h], *a, **k)
        return torch.cat([out, out[: audio.shape[0] - h]])

    monkeypatch.setattr(TSVADModel, "forward", forward)


def _unchanged(monkeypatch):
    monkeypatch.setattr(Trainer, "_apply", lambda self, grads: None)


def _half_loss(monkeypatch):
    import speaker_diarization_tpu_torch.train.tasks as tasks

    monkeypatch.setattr(tasks, "make_tsvad_loss", tasks.make_tsvad_loss)
    calibrate.half_batch_loss()


FAULTS = [("infer_windows", _altered), ("infer_windows", _half_rows), ("train_8s", _unchanged),
          ("train_8s", _half_loss)]


@pytest.mark.parametrize("config", ["tsvad_tf", "tsvad_mamba"])
@pytest.mark.parametrize("traffic,fault", FAULTS, ids=lambda x: getattr(x, "__name__", x).strip("_"))
def test_fault_is_not_correct(config, traffic, fault, monkeypatch, tiny_overrides):
    workload = f"{config}.{traffic}"
    fault(monkeypatch)
    r = harness.run_cell(workload, 2**31 + 11, 0.05, False, "cpu", overrides=tiny_overrides(workload))
    assert not r["correct"], r["checks"]
