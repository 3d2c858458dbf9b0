"""Praat TextGrid parsing + AliMeeting-style corpus preparation.

The port's own copy of speaker_diarization_tpu/data/textgrid.py (NumPy only),
unchanged below this paragraph; tests/test_torch_dicow.py holds the
two copies to the same output.

Reference: `source_md/prepare_alimeeting_format_data_and_generate_target_
audio.py` + `make_textgrid_rttm.py` — AliMeeting annotations are TextGrid
files with one interval tier per speaker; prep turns them into RTTM, a
Kaldi data dir, and per-speaker target-audio lists for TS-VAD.

Supports both long ("ooTextFile") and short TextGrid formats, without the
external `textgrid` package.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

from .rttm import Turn, write_rttm


def parse_textgrid(path_or_text: str) -> Dict[str, List[Tuple[float, float, str]]]:
    """TextGrid → {tier_name: [(xmin, xmax, text), ...]} (non-empty texts)."""
    if os.path.exists(path_or_text):
        with open(path_or_text, encoding="utf-8", errors="replace") as f:
            text = f.read()
    else:
        text = path_or_text

    tiers: Dict[str, List[Tuple[float, float, str]]] = {}
    # long format: item [n]: ... name = "spk" ... intervals [k]: xmin= xmax= text=
    item_blocks = re.split(r"item\s*\[\d+\]\s*:", text)[1:]
    if item_blocks:
        for block in item_blocks:
            m = re.search(r'name\s*=\s*"([^"]*)"', block)
            name = m.group(1) if m else f"tier{len(tiers)}"
            ivs = []
            for im in re.finditer(
                r"intervals\s*\[\d+\]\s*:?\s*xmin\s*=\s*([\d.eE+-]+)\s*xmax\s*=\s*([\d.eE+-]+)\s*text\s*=\s*\"((?:[^\"]|\"\")*)\"",
                block,
            ):
                xmin, xmax, t = float(im.group(1)), float(im.group(2)), im.group(3).strip()
                if t:
                    ivs.append((xmin, xmax, t))
            tiers[name] = ivs
        return tiers

    # short format fallback: "IntervalTier" name xmin xmax n then triples
    lines = [l.strip().strip('"') for l in text.splitlines() if l.strip()]
    i = 0
    while i < len(lines):
        if lines[i] == "IntervalTier":
            name = lines[i + 1]
            n = int(float(lines[i + 4]))
            ivs = []
            j = i + 5
            for _ in range(n):
                xmin, xmax, t = float(lines[j]), float(lines[j + 1]), lines[j + 2]
                if t.strip():
                    ivs.append((xmin, xmax, t.strip()))
                j += 3
            tiers[name] = ivs
            i = j
        else:
            i += 1
    return tiers


def textgrid_to_turns(path: str, rec: str, min_dur: float = 0.0) -> List[Turn]:
    """One TextGrid → speaker turns (tier name = speaker id)."""
    turns = []
    for spk, ivs in parse_textgrid(path).items():
        for xmin, xmax, _ in ivs:
            if xmax - xmin > min_dur:
                turns.append(Turn(rec, xmin, xmax - xmin, spk))
    turns.sort(key=lambda t: (t.start, t.speaker))
    return turns


def prepare_alimeeting_dir(
    textgrid_dir: str,
    wav_dir: str,
    out_dir: str,
    wav_suffix: str = ".wav",
    textgrid_suffix: str = ".TextGrid",
    label_rate: int = 25,
) -> str:
    """TextGrids + wavs → Kaldi data dir with rttm + per-speaker labels JSON.

    Mirrors the reference prep outputs: wav.scp / segments / utt2spk /
    rttm, plus a per-recording labels manifest (speaker, 25 Hz activity)
    that the TS-VAD dataset consumes.
    """
    import json

    from . import kaldi_io
    from .rttm import frames_from_turns
    from .wav import wav_info

    os.makedirs(out_dir, exist_ok=True)
    wavs, segments, utt2spk, reco2dur = {}, [], {}, {}
    all_turns: List[Turn] = []
    manifest = []
    for fname in sorted(os.listdir(textgrid_dir)):
        if not fname.endswith(textgrid_suffix):
            continue
        rec = fname[: -len(textgrid_suffix)]
        wav_path = os.path.join(wav_dir, rec + wav_suffix)
        if not os.path.exists(wav_path):
            continue
        turns = textgrid_to_turns(os.path.join(textgrid_dir, fname), rec)
        all_turns += turns
        wavs[rec] = os.path.abspath(wav_path)
        info = wav_info(wav_path)
        reco2dur[rec] = info["duration"]
        speakers = sorted({t.speaker for t in turns})
        n_frames = int(info["duration"] * label_rate)
        act = frames_from_turns(turns, speakers, 1.0 / label_rate, n_frames)
        for si, spk in enumerate(speakers):
            manifest.append(
                dict(filename=rec, speaker_key=si, speaker_id=spk, labels=act[:, si].astype(int).tolist())
            )
        for i, t in enumerate(turns):
            utt = f"{t.speaker}-{rec}-{int(t.start * 100):07d}"
            segments.append(dict(utt=utt, rec=rec, st=t.start, et=t.end))
            utt2spk[utt] = t.speaker

    kaldi_io.save_data_dir(out_dir, wavs=wavs, segments=segments, utt2spk=utt2spk, reco2dur=reco2dur)
    write_rttm(os.path.join(out_dir, "rttm"), all_turns)
    with open(os.path.join(out_dir, "labels.jsonl"), "w") as f:
        for m in manifest:
            f.write(json.dumps(m) + "\n")
    return out_dir
