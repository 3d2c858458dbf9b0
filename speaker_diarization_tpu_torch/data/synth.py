"""A small seeded synthetic diarization corpus in Kaldi layout.

`write_synthetic_corpus` writes wav.scp, reco2dur, an RTTM of random speaker
turns (overlaps included), the same turns as `segments` + `utt2spk` (one
utterance per turn; the EEND dataset reads these), 16-bit wavs at `rate`
(8 or 16 kHz) where each speaker is a distinct harmonic voice gated by its
turns, and an embedding store with a few embedding rows per (recording,
speaker) for TS-VAD. It exists so that the CLI and the smoke run can be
driven end to end without any outside data.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .kaldi_io import save_data_dir
from .rttm import Turn, write_rttm
from .wav import write_wav


def _turns(rng: np.random.Generator, rec: str, spks, seconds: float):
    turns = []
    for spk in spks:
        t = float(rng.uniform(0.0, 2.0))
        while t < seconds - 0.5:
            dur = float(min(rng.uniform(1.0, 4.0), seconds - t))
            turns.append(Turn(rec, round(t, 2), round(dur, 2), spk))
            t += dur + float(rng.uniform(0.5, 4.0))
    return sorted(turns, key=lambda x: (x.start, x.speaker))


def write_synthetic_corpus(
    out_dir: str,
    n_recs: int = 3,
    seconds: float = 30.0,
    rate: int = 16000,
    n_speakers: int = 3,
    emb_dim: int = 192,
    seed: int = 0,
    prefix: str = "rec",
) -> Dict[str, str]:
    """Write the corpus; returns paths {data_dir, rttm, emb_store}.
    Recordings are named <prefix>00, <prefix>01, ..."""
    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(out_dir, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    wavs, durs, all_turns, embs = {}, {}, [], {}
    t = np.arange(int(seconds * rate)) / rate
    for r in range(n_recs):
        rec = f"{prefix}{r:02d}"
        spks = [f"{rec}_spk{i}" for i in range(n_speakers)]
        turns = _turns(rng, rec, spks, seconds)
        audio = 0.01 * rng.standard_normal(len(t))
        for i, spk in enumerate(spks):
            f0 = 110.0 + 60.0 * i + 10.0 * r
            voice = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 2 * np.pi)) / k for k in range(1, 6))
            gate = np.zeros(len(t))
            for tu in turns:
                if tu.speaker == spk:
                    gate[int(tu.start * rate) : int(tu.end * rate)] = 1.0
            audio += 0.1 * voice * gate
            center = rng.standard_normal(emb_dim)
            embs[f"{rec}/{spk}"] = (center + 0.1 * rng.standard_normal((4, emb_dim))).astype(np.float32)
        path = os.path.join(wav_dir, f"{rec}.wav")
        write_wav(path, np.clip(audio, -1.0, 1.0).astype(np.float32), rate)
        wavs[rec], durs[rec] = path, seconds
        all_turns += turns
    utts = [f"{tu.speaker}-{int(round(tu.start * 100)):07d}" for tu in all_turns]
    segments = [dict(utt=u, rec=tu.rec, st=tu.start, et=tu.end) for u, tu in zip(utts, all_turns)]
    utt2spk = {u: tu.speaker for u, tu in zip(utts, all_turns)}
    save_data_dir(out_dir, wavs, segments=segments, utt2spk=utt2spk, reco2dur=durs)
    rttm = os.path.join(out_dir, "rttm")
    write_rttm(rttm, all_turns)
    emb_path = os.path.join(out_dir, "embeddings.npz")
    np.savez(emb_path, **embs)
    return dict(data_dir=out_dir, rttm=rttm, emb_store=emb_path)
