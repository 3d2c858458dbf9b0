"""Overlapped-window TS-VAD inference with per-frame probability voting.

Counterpart of speaker_diarization_tpu/infer/chunked.py
(`tsvad_infer_dataset`); reference ts_vad2/model.py:957-968 (res_dict
accumulation) + infer.py:86-94 (mean over overlap votes). `make_tsvad_predict`
wraps a TSVADModel as the predictor it calls.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def tsvad_infer_dataset(
    predict_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    dataset,
    batch_size: int = 16,
    emb_key: str = "target_embs",
) -> Dict[str, np.ndarray]:
    """Overlap-voted probabilities over every recording of `dataset`.

    `dataset` is a TSVADChunkDataset (eval path, canonical speaker order)
    with a small segment_shift so windows overlap.
    predict_fn: (audio (B, N), target_embs (B, S, D)) → probs (B, T25, S).
    The last batch is zero-padded to `batch_size`, so every call has one
    shape. Returns {rec: (n_frames, n_speakers_rec) mean probabilities}.
    """
    sums: Dict[str, np.ndarray] = {}
    counts: Dict[str, np.ndarray] = {}
    for rec, spks in dataset.rec_speakers.items():
        n = dataset.n_frames(rec)
        sums[rec] = np.zeros((n, len(spks)), np.float64)
        counts[rec] = np.zeros((n, 1), np.float64)

    n_items = len(dataset)
    for i in range(0, n_items, batch_size):
        items = [dataset[j] for j in range(i, min(i + batch_size, n_items))]
        audio = np.stack([it["audio"] for it in items])
        embs = np.stack([it[emb_key] for it in items])
        if len(items) < batch_size:
            pad = batch_size - len(items)
            audio = np.concatenate([audio, np.zeros((pad,) + audio.shape[1:], np.float32)])
            embs = np.concatenate([embs, np.zeros((pad,) + embs.shape[1:], np.float32)])
        probs = np.asarray(predict_fn(audio, embs))[: len(items)]
        for it, p in zip(items, probs):
            rec = it["rec"]
            st = it["start_frame"]
            n_spk = len(it["speakers"])
            en = min(st + p.shape[0], sums[rec].shape[0])
            sums[rec][st:en, :n_spk] += p[: en - st, :n_spk]
            counts[rec][st:en] += 1.0
    return {rec: (sums[rec] / np.maximum(counts[rec], 1.0)).astype(np.float32) for rec in sums}


def make_tsvad_predict(model, n_label_frames: int) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """(audio, embs) numpy → sigmoid probabilities numpy, on the model's device."""
    dev = model.device

    @torch.no_grad()
    def predict(audio: np.ndarray, embs: np.ndarray) -> np.ndarray:
        a = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(dev)
        e = torch.from_numpy(np.ascontiguousarray(embs, np.float32)).to(dev)
        return torch.sigmoid(model(a, e, n_label_frames)).cpu().numpy()

    return predict
