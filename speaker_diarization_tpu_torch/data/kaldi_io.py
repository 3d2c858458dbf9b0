"""Kaldi-style data-directory reader.

Loads `wav.scp`, `segments`, `utt2spk`, `spk2utt`, `reco2dur`, `rttm` from a
data dir, with lazy per-recording wav access (partial reads) — the same
contract as the reference `KaldiData` (kaldi_data.py:146-163) so existing
Kaldi-prepared corpora drop in unchanged.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import wav as wavio


def load_scp(path) -> Dict[str, str]:
    """key → rest-of-line (first-space split)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            k, v = line.split(None, 1)
            out[k] = v
    return out


def load_segments(path) -> List[dict]:
    segs = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 4:
                segs.append(dict(utt=parts[0], rec=parts[1], st=float(parts[2]), et=float(parts[3])))
    return segs


def load_utt2spk(path) -> Dict[str, str]:
    return load_scp(path)


def load_spk2utt(path) -> Dict[str, List[str]]:
    return {k: v.split() for k, v in load_scp(path).items()}


def load_reco2dur(path) -> Dict[str, float]:
    return {k: float(v) for k, v in load_scp(path).items()}


class KaldiData:
    """Kaldi data-dir accessor with per-recording segment index.

    Attributes mirror the reference class: .wavs, .segments (dict
    rec → list of {utt, rec, st, et}), .utt2spk, .spk2utt, .reco2dur, .rttm.
    """

    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        self.wavs = load_scp(os.path.join(data_dir, "wav.scp"))
        seg_path = os.path.join(data_dir, "segments")
        self.segments: Dict[str, List[dict]] = {}
        if os.path.exists(seg_path):
            for seg in load_segments(seg_path):
                self.segments.setdefault(seg["rec"], []).append(seg)
            for rec in self.segments:
                self.segments[rec].sort(key=lambda s: s["st"])
        self.utt2spk = (
            load_utt2spk(os.path.join(data_dir, "utt2spk"))
            if os.path.exists(os.path.join(data_dir, "utt2spk"))
            else {}
        )
        self.spk2utt = (
            load_spk2utt(os.path.join(data_dir, "spk2utt"))
            if os.path.exists(os.path.join(data_dir, "spk2utt"))
            else None
        )
        self.reco2dur = (
            load_reco2dur(os.path.join(data_dir, "reco2dur"))
            if os.path.exists(os.path.join(data_dir, "reco2dur"))
            else None
        )
        rttm_path = os.path.join(data_dir, "rttm")
        self.rttm_path = rttm_path if os.path.exists(rttm_path) else None

    def load_wav(self, recid: str, start: int = 0, end: Optional[int] = None) -> Tuple[np.ndarray, int]:
        """Load (a slice of) a recording; start/end are sample indices."""
        return wavio.load_wav_maybe_piped(self.wavs[recid], start, end)

    @functools.lru_cache(maxsize=1)
    def all_speakers(self) -> List[str]:
        return sorted(set(self.utt2spk.values()))

    def extract_segments(self, utt: str) -> Tuple[np.ndarray, int]:
        """Load the audio of a single `segments` entry."""
        for rec, segs in self.segments.items():
            for seg in segs:
                if seg["utt"] == utt:
                    info = None
                    data, rate = self.load_wav(rec)
                    st, et = int(seg["st"] * rate), int(seg["et"] * rate)
                    return data[st:et], rate
        raise KeyError(utt)


def save_data_dir(
    data_dir: str,
    wavs: Dict[str, str],
    segments: Optional[List[dict]] = None,
    utt2spk: Optional[Dict[str, str]] = None,
    reco2dur: Optional[Dict[str, float]] = None,
) -> None:
    """Write a Kaldi data dir (wav.scp/segments/utt2spk/spk2utt/reco2dur)."""
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, "wav.scp"), "w") as f:
        for k in sorted(wavs):
            f.write(f"{k} {wavs[k]}\n")
    if segments is not None:
        with open(os.path.join(data_dir, "segments"), "w") as f:
            for s in sorted(segments, key=lambda s: s["utt"]):
                f.write(f"{s['utt']} {s['rec']} {s['st']:.3f} {s['et']:.3f}\n")
    if utt2spk is not None:
        with open(os.path.join(data_dir, "utt2spk"), "w") as f:
            for k in sorted(utt2spk):
                f.write(f"{k} {utt2spk[k]}\n")
        spk2utt: Dict[str, List[str]] = {}
        for u, s in utt2spk.items():
            spk2utt.setdefault(s, []).append(u)
        with open(os.path.join(data_dir, "spk2utt"), "w") as f:
            for s in sorted(spk2utt):
                f.write(f"{s} {' '.join(sorted(spk2utt[s]))}\n")
    if reco2dur is not None:
        with open(os.path.join(data_dir, "reco2dur"), "w") as f:
            for k in sorted(reco2dur):
                f.write(f"{k} {reco2dur[k]:.3f}\n")
