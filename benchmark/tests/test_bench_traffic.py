"""The traffic generator repeats exactly from its seed and keeps every seed's sizes."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.traffic import meetings

MODEL = harness.load_json(str(harness.BENCH + "/configs/tsvad_tf.json"))["tsvad"]


def _small(name):
    t = harness.load_json(f"{harness.BENCH}/traffic/{name}.json")
    return dict(t, batch=6, ring=2, meeting_s=2 * t["window_s"] + t["shift_s"])


@pytest.mark.parametrize("name", ["infer_windows", "train_8s"])
def test_same_seed_same_batches(name):
    t = _small(name)
    a = meetings.make(t, MODEL, 2**31 + 977, "cpu")
    b = meetings.make(t, MODEL, 2**31 + 977, "cpu")
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k]), k


@pytest.mark.parametrize("name", ["infer_windows", "train_8s"])
def test_seeds_move_content_not_sizes(name):
    t = _small(name)
    a, b = meetings.make(t, MODEL, 1, "cpu"), meetings.make(t, MODEL, 2, "cpu")
    n = int(t["window_s"] * MODEL["sample_rate"])
    T = int(t["window_s"] * MODEL["label_rate"])
    for x, y in zip(a, b):
        assert x["audio"].shape == y["audio"].shape == (t["batch"], n)
        assert x["labels"].shape == (t["batch"], T, MODEL["max_num_speaker"])
        assert x["target_embs"].shape == (t["batch"], MODEL["max_num_speaker"], MODEL["speaker_embed_dim"])
        assert not torch.equal(x["audio"], y["audio"])
    labels = torch.cat([x["labels"] for x in a])
    assert set(labels.unique().tolist()) <= {0.0, 1.0}
    # absent slots carry zero embeddings and no speech
    absent = a[0]["target_embs"].abs().sum(-1) == 0
    assert a[0]["labels"].transpose(1, 2)[absent].sum() == 0


def test_windows_cut_at_the_shift():
    t = _small("infer_windows")
    b = meetings.make(dict(t, ring=1), MODEL, 3, "cpu")[0]
    hop = int(t["shift_s"] * MODEL["sample_rate"])
    assert torch.equal(b["audio"][0, hop:], b["audio"][1, :-hop])
    f = int(t["shift_s"] * MODEL["label_rate"])
    assert torch.equal(b["labels"][0, f:], b["labels"][1, :-f])


def test_turns_overlap_and_alternate():
    rng = np.random.default_rng(0)
    t = harness.load_json(f"{harness.BENCH}/traffic/infer_windows.json")
    act = meetings._turns(rng, 3, 25 * 600, 25, t)
    assert (act.sum(0) >= 2).any() and (act.sum(0) == 1).any() and act.any(1).all()
