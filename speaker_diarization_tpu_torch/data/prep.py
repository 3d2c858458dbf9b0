"""Target-speaker prep from a (system or oracle) RTTM.

A copy of speaker_diarization_tpu/data/prep.py.

Reference: `egs/alimeeting/ts_vad2/system_rttm_to_generate_target_speaker_
wav_and_label_for_ts_vad.py` — the bridge from a clustering-produced RTTM
to TS-VAD inputs (the run_ts_vad2_based_on_system_sad.sh composition):

- per recording and speaker, subtract every other speaker's intervals
  (`remove_overlap`, :23-57) and concatenate the remaining single-speaker
  audio into an enrollment target wav (:139-152);
- per speaker, 25 Hz activity labels from the FULL intervals, overlap
  included (:157-169);
- a JSON-lines manifest {filename, speaker_key, speaker_id, labels}.

Here the labels manifest is optional plumbing (our TSVADChunkDataset reads
activity straight from the RTTM); the essential output is the target-audio
Kaldi dir keyed `rec-spk` that `extract-embeddings` consumes.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import kaldi_io
from .rttm import read_rttm_by_rec
from .wav import load_wav_maybe_piped, write_wav

Interval = Tuple[float, float]


def subtract_intervals(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """Set-difference a \\ b on sorted interval lists (reference
    remove_overlap semantics, but via a boundary sweep instead of the
    mutating two-pointer walk)."""
    if not a:
        return []
    if not b:
        return sorted(a)
    out: List[Interval] = []
    b = sorted(b)
    for s, e in sorted(a):
        cur = s
        for bs, be in b:
            if be <= cur:
                continue
            if bs >= e:
                break
            if bs > cur:
                out.append((cur, min(bs, e)))
            cur = max(cur, be)
            if cur >= e:
                break
        if cur < e:
            out.append((cur, e))
    return out


def merge_intervals(iv: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def prepare_targets_from_rttm(
    rttm_path: str,
    data_dir: str,
    out_dir: str,
    label_rate: int = 25,
    min_target_s: float = 0.0,
    write_manifest: bool = True,
) -> str:
    """system RTTM + mixture Kaldi dir → target-audio Kaldi dir.

    Writes out_dir/target_audio/<rec>/<spk>.wav (overlap-free enrollment
    audio), a wav.scp keyed `<rec>-<spk>`, a copy of the RTTM, and
    labels.jsonl (25 Hz per-speaker activity from the full intervals).
    Returns out_dir.
    """
    kd = kaldi_io.KaldiData(data_dir)
    turns_by_rec = read_rttm_by_rec(rttm_path)
    os.makedirs(out_dir, exist_ok=True)
    audio_root = os.path.join(out_dir, "target_audio")
    wavs: Dict[str, str] = {}
    manifest = []
    for rec in sorted(turns_by_rec):
        if rec not in kd.wavs:
            continue
        audio, rate = load_wav_maybe_piped(kd.wavs[rec])
        if audio.ndim > 1:
            audio = audio[:, 0]
        n_frames = int(len(audio) / rate * label_rate)
        intervals: Dict[str, List[Interval]] = defaultdict(list)
        for t in turns_by_rec[rec]:
            intervals[t.speaker].append((t.start, t.end))
        os.makedirs(os.path.join(audio_root, rec), exist_ok=True)
        for si, spk in enumerate(sorted(intervals)):
            clean = merge_intervals(intervals[spk])
            for other, iv in intervals.items():
                if other != spk:
                    clean = subtract_intervals(clean, iv)
            if sum(e - s for s, e in clean) < min_target_s:
                continue
            pieces = [audio[int(s * rate): int(e * rate)] for s, e in clean]
            target = (
                np.concatenate([p for p in pieces if len(p)])
                if any(len(p) for p in pieces)
                else np.zeros(1, np.float32)
            )
            path = os.path.join(audio_root, rec, f"{spk}.wav")
            write_wav(path, target, rate)
            wavs[f"{rec}-{spk}"] = os.path.abspath(path)
            if write_manifest:
                labels = np.zeros(n_frames, np.int64)
                for s, e in intervals[spk]:
                    labels[int(s * label_rate): min(int(e * label_rate) + 1, n_frames)] = 1
                manifest.append(
                    dict(filename=rec, speaker_key=si, speaker_id=spk, labels=labels.tolist())
                )
    kaldi_io.save_data_dir(out_dir, wavs=wavs)
    import shutil

    shutil.copyfile(rttm_path, os.path.join(out_dir, "rttm"))
    if write_manifest:
        with open(os.path.join(out_dir, "labels.jsonl"), "w") as f:
            for m in manifest:
                f.write(json.dumps(m) + "\n")
    return out_dir
