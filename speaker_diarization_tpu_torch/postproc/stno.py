"""STNO masks: diarization → per-speaker ASR-conditioning masks.

The port's own copy of speaker_diarization_tpu/postproc/stno.py (NumPy only),
unchanged below this paragraph; tests/test_torch_dicow.py holds the
two copies to the same output.

Reference: `egs/mlc_slm/dicow/dicow_pipeline.py:20-39` (DiCoW,
diarization-conditioned Whisper). For each target speaker s, every frame
is classified as Silence / Target-only / Non-target / Overlap from the
multi-speaker diarization mask — the conditioning interface between the
diarization stack and a downstream ASR encoder.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..data.rttm import Turn


def diarization_mask(turns: Sequence[Turn], speakers: Sequence[str], n_frames: int, frame_rate: float = 50.0) -> np.ndarray:
    """Speaker turns → (n_speakers, n_frames) binary activity at frame_rate."""
    idx = {s: i for i, s in enumerate(speakers)}
    M = np.zeros((len(speakers), n_frames), np.float32)
    for t in turns:
        if t.speaker in idx:
            a, b = round(t.start * frame_rate), round(t.end * frame_rate)
            M[idx[t.speaker], max(a, 0) : min(b, n_frames)] = 1.0
    return M


def stno_mask(diar_mask: np.ndarray, s_index: int) -> np.ndarray:
    """(S, T) activity + target index → (4, T) [silence, target-only,
    non-target, overlap] soft masks (rows sum to 1 for binary input)."""
    S, T = diar_mask.shape
    others = np.ones(S, bool)
    others[s_index] = False
    sil = np.prod(1 - diar_mask, axis=0)
    anyone_else_silent = np.prod(1 - diar_mask[others], axis=0) if others.any() else np.ones(T, np.float32)
    target_only = diar_mask[s_index] * anyone_else_silent
    non_target = (1 - diar_mask[s_index]) * (1 - anyone_else_silent)
    overlap = diar_mask[s_index] - target_only
    return np.stack([sil, target_only, non_target, overlap], axis=0).astype(np.float32)


def stno_masks_for_all(diar_mask: np.ndarray) -> np.ndarray:
    """(S, T) → (S, 4, T): one STNO mask per target speaker."""
    return np.stack([stno_mask(diar_mask, s) for s in range(diar_mask.shape[0])], axis=0)
