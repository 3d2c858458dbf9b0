"""Probability → RTTM post-processing.

Reference semantics:
- threshold → median filter → turn extraction
  (reference `bin/make_rttm.py:29-42`);
- TS-VAD double hysteresis: fill sub-threshold gaps shorter than `fill_gap`
  frames, then cut speech runs shorter than `min_dur` frames
  (`egs/alimeeting/ts_vad2/infer.py:27-69` change_zeros_to_ones /
  change_ones_to_zeros).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
from scipy.signal import medfilt

from ..data.rttm import Turn, turns_from_frames


def median_filter(binary: np.ndarray, kernel: int) -> np.ndarray:
    """(T, S) binary activity → median-filtered along time (odd kernel)."""
    if kernel <= 1:
        return binary
    return medfilt(binary.astype(np.float64), (kernel, 1)).astype(binary.dtype)


def hysteresis_smooth(frames: np.ndarray, fill_gap: int, min_dur: int) -> np.ndarray:
    """Per-speaker run smoothing: bridge short silences, drop short speech.

    frames: (T,) in {0,1}. Mirrors ts_vad2/infer.py change_zeros_to_ones
    (gaps < fill_gap become speech) then change_ones_to_zeros (speech runs
    < min_dur become silence).
    """
    x = frames.astype(np.int8).copy()
    # bridge short zero-gaps between speech
    d = np.diff(x, prepend=0, append=0)
    on = np.nonzero(d == 1)[0]
    off = np.nonzero(d == -1)[0]
    for prev_off, nxt_on in zip(off[:-1], on[1:]):
        if 0 < nxt_on - prev_off < fill_gap:
            x[prev_off:nxt_on] = 1
    # drop short speech runs
    d = np.diff(x, prepend=0, append=0)
    on = np.nonzero(d == 1)[0]
    off = np.nonzero(d == -1)[0]
    for s, e in zip(on, off):
        if e - s < min_dur:
            x[s:e] = 0
    return x


def probs_to_turns(
    probs: np.ndarray,
    rec: str,
    frame_shift_s: float,
    threshold: float = 0.5,
    median: int = 11,
    speakers: Optional[Sequence[str]] = None,
    fill_gap: int = 0,
    min_dur: int = 0,
    offset_s: float = 0.0,
) -> List[Turn]:
    """(T, S) per-frame speech probabilities → speaker turns.

    Pipeline: threshold → median filter → optional hysteresis → turns.
    """
    a = (probs > threshold).astype(np.int8)
    a = median_filter(a, median)
    if fill_gap > 0 or min_dur > 0:
        a = np.stack([hysteresis_smooth(a[:, s], fill_gap, min_dur) for s in range(a.shape[1])], axis=1)
    if speakers is None:
        speakers = [f"{rec}_{i}" for i in range(probs.shape[1])]
    return turns_from_frames(a, rec, list(speakers), frame_shift_s, offset_s)
