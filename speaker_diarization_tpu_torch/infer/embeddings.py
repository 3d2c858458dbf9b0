"""Target-speaker embedding extraction (offline stage of the TS-VAD recipe).

Reference: `egs/alimeeting/ts_vad2/generate_chunk_speaker_embedding_from_
modelscope_for_diarization.py` — per (meeting, speaker) target audio, slide
6 s windows with 1 s hop through the speaker encoder and save the per-window
embedding matrix; the dataset later picks a random row (train) or the mean
(eval). Store format here: one .npz per corpus, key "rec/spk" → (n, D).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np


def chunk_embeddings(
    embed_fn: Callable[[np.ndarray], np.ndarray],
    audio: np.ndarray,
    rate: int,
    window_s: float = 6.0,
    hop_s: float = 1.0,
    batch_size: int = 32,
    min_window_s: float = 1.0,
) -> np.ndarray:
    """Slide windows over `audio`, embed each: → (n_windows, D).

    embed_fn: (B, window_samples) float32 → (B, D). Short recordings yield a
    single zero-padded window.
    """
    win = int(window_s * rate)
    hop = int(hop_s * rate)
    if len(audio) < int(min_window_s * rate):
        return np.zeros((0, 0), np.float32)
    if len(audio) <= win:
        windows = [np.pad(audio, (0, win - len(audio)))]
    else:
        starts = list(range(0, len(audio) - win + 1, hop))
        windows = [audio[s : s + win] for s in starts]
    outs = []
    for i in range(0, len(windows), batch_size):
        b = np.stack(windows[i : i + batch_size]).astype(np.float32)
        outs.append(np.asarray(embed_fn(b)))
    return np.concatenate(outs, axis=0)


class EmbeddingStore:
    """Per-(recording, speaker) embedding matrices with npz persistence."""

    def __init__(self, data: Optional[Dict[str, np.ndarray]] = None):
        self.data = data or {}

    @staticmethod
    def key(rec: str, spk: str) -> str:
        return f"{rec}/{spk}"

    def put(self, rec: str, spk: str, emb: np.ndarray):
        self.data[self.key(rec, spk)] = np.asarray(emb, np.float32)

    def get(self, rec: str, spk: str) -> np.ndarray:
        return self.data[self.key(rec, spk)]

    def has(self, rec: str, spk: str) -> bool:
        return self.key(rec, spk) in self.data

    def speakers(self) -> Dict[str, list]:
        out: Dict[str, list] = {}
        for k in self.data:
            rec, spk = k.split("/", 1)
            out.setdefault(rec, []).append(spk)
        return out

    def save(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez_compressed(path, **self.data)

    @classmethod
    def load(cls, path: str) -> "EmbeddingStore":
        """Load a store; a comma-separated path list merges several stores
        (train+valid splits are stored separately but consumed jointly).

        Comma is therefore reserved as a separator — a single filename
        containing a comma cannot be loaded through this interface. Key
        collisions across merged stores are logged (last store wins)."""
        import logging

        data = {}
        for p in str(path).split(","):
            p = p.strip()
            if not p:
                continue
            z = np.load(p)
            clashes = [k for k in z.files if k in data]
            if clashes:
                logging.getLogger(__name__).warning(
                    "EmbeddingStore.load: %d duplicate keys while merging %s "
                    "(last store wins), e.g. %s", len(clashes), p, clashes[:3]
                )
            data.update({k: z[k] for k in z.files})
        return cls(data)

    @property
    def dim(self) -> int:
        for v in self.data.values():
            return v.shape[-1]
        raise ValueError("empty store")
