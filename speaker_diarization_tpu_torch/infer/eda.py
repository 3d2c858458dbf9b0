"""EEND-EDA variable-speaker inference.

Counterpart of speaker_diarization_tpu/infer/eda.py (reference
eend_eda/infer_eda.py:21-125 + attractor selection at
eend_eda/models.py:639-651): decode up to max_attractors per chunk, keep
attractors until the first whose existence probability drops below the
threshold, concatenate chunk posteriors over the recording.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.kaldi_io import KaldiData
from ..models.eend import FrontendConfig
from .chunked import _chunks


def select_speakers(exist_probs: np.ndarray, threshold: float = 0.5, max_speakers: Optional[int] = None) -> int:
    """Number of active attractors: index of first prob < threshold."""
    below = np.nonzero(exist_probs < threshold)[0]
    n = int(below[0]) if len(below) else len(exist_probs)
    if max_speakers is not None:
        n = min(n, max_speakers)
    return n


def eda_infer_recording(
    predict_fn: Callable[[np.ndarray, np.ndarray], tuple],
    audio: np.ndarray,
    frontend: FrontendConfig,
    chunk_frames: int = 500,
    threshold: float = 0.5,
    max_speakers: Optional[int] = None,
) -> np.ndarray:
    """Chunked EDA inference → (n_sub_frames, n_spk_max_over_chunks) probs.

    predict_fn: (audio (1, chunk_samples), frame_mask (1, T)) →
    (probs (1, T, A), exist_probs (1, A)). Chunk speaker orders are
    concatenated as they are (the reference does the same; EEND-VC adds
    cross-chunk alignment).
    """
    n_sub, chunks, masks = _chunks(audio, frontend, chunk_frames)
    chunk_probs, n_spks = [], []
    for a, m in zip(chunks, masks):
        probs, exist = predict_fn(a[None], m[None])
        probs, exist = np.asarray(probs)[0], np.asarray(exist)[0]
        n = select_speakers(exist, threshold, max_speakers)
        chunk_probs.append(probs[: int(m.sum()), :n])
        n_spks.append(n)
    out = np.zeros((n_sub, max(max(n_spks, default=0), 1)), np.float32)
    pos = 0
    for p in chunk_probs:
        out[pos : pos + p.shape[0], : p.shape[1]] = p
        pos += p.shape[0]
    return out


def eda_infer_dataset(
    predict_fn, data_dir: str, frontend: FrontendConfig, chunk_frames: int = 500, threshold: float = 0.5,
    max_speakers: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    kd = KaldiData(data_dir)
    out = {}
    for rec in sorted(kd.wavs):
        audio, rate = kd.load_wav(rec)
        if rate != frontend.sample_rate:
            raise ValueError(f"{rec}: {rate} Hz audio, the model's front-end wants {frontend.sample_rate} Hz")
        out[rec] = eda_infer_recording(predict_fn, audio, frontend, chunk_frames, threshold, max_speakers)
    return out


def make_eda_predict(model) -> Callable[[np.ndarray, np.ndarray], tuple]:
    """(audio, frame_mask) numpy → (masked sigmoid probabilities, existence
    probabilities) numpy, through `EendEdaModel.infer` on the model's device."""
    dev = model.device

    @torch.no_grad()
    def predict(audio: np.ndarray, mask: np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(dev)
        m = torch.from_numpy(np.ascontiguousarray(mask, np.float32)).to(dev)
        logits, exist = model.infer(a, m)
        return (torch.sigmoid(logits) * m[..., None]).cpu().numpy(), exist.cpu().numpy()

    return predict
