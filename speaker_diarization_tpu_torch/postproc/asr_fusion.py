"""Speaker-attributed ASR fusion: word timestamps × diarization → STM.

The port's own copy of speaker_diarization_tpu/postproc/asr_fusion.py (NumPy only),
unchanged below this paragraph; tests/test_torch_dicow.py holds the
two copies to the same output.

Reference: `egs/mlc_slm/fusion/asr_speaker_fusion.py` (word→speaker
assignment: biggest temporal overlap, falling back to smallest temporal
distance when a word overlaps no speaker segment) and
`generate_hyp_stm_from_whisperx_output.py` (STM emission). This is the
final stage of the mlc_slm speaker-attributed-ASR pipeline: TS-VAD RTTM +
ASR word list in, `<rec> <chan> <speaker> <start> <end> <text>` STM out
for tcpWER scoring.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..data.rttm import Turn


@dataclass
class Word:
    word: str
    start: float
    end: float
    confidence: Optional[float] = None


@dataclass
class FusedWord:
    word: str
    start: float
    end: float
    speaker: str
    method: str  # 'overlap' | 'distance'
    confidence: Optional[float] = None


@dataclass
class StmSegment:
    rec: str
    channel: str
    speaker: str
    start: float
    end: float
    text: str


def fuse_words(words: Sequence[Word], turns: Sequence[Turn]) -> List[FusedWord]:
    """Assign each ASR word to a diarization speaker
    (asr_speaker_fusion.py:159-189): max-overlap first, min-distance
    fallback. Vectorized over the (words × turns) grid."""
    if not turns:
        raise ValueError("no speaker turns to fuse against")
    ws = np.array([w.start for w in words])
    we = np.array([w.end for w in words])
    ts = np.array([t.start for t in turns])
    te = np.array([t.end for t in turns])
    ov = np.maximum(0.0, np.minimum(we[:, None], te[None, :]) - np.maximum(ws[:, None], ts[None, :]))
    # temporal distance between disjoint intervals (0 when overlapping)
    dist = np.maximum(0.0, np.maximum(ts[None, :] - we[:, None], ws[:, None] - te[None, :]))
    best_ov = ov.argmax(axis=1)
    best_dist = dist.argmin(axis=1)
    out = []
    for i, w in enumerate(words):
        if ov[i, best_ov[i]] > 0:
            out.append(FusedWord(w.word, w.start, w.end, turns[best_ov[i]].speaker, "overlap", w.confidence))
        else:
            out.append(FusedWord(w.word, w.start, w.end, turns[best_dist[i]].speaker, "distance", w.confidence))
    return out


def fused_words_to_stm(
    fused: Sequence[FusedWord], rec: str, channel: str = "1", max_gap: float = 1.0
) -> List[StmSegment]:
    """Group time-ordered fused words into STM utterances: a new segment
    starts on speaker change or a silence gap > max_gap seconds."""
    segs: List[StmSegment] = []
    for w in sorted(fused, key=lambda w: w.start):
        if segs and segs[-1].speaker == w.speaker and w.start - segs[-1].end <= max_gap:
            last = segs[-1]
            segs[-1] = StmSegment(rec, channel, last.speaker, last.start, max(last.end, w.end),
                                  f"{last.text} {w.word}")
        else:
            segs.append(StmSegment(rec, channel, w.speaker, w.start, w.end, w.word))
    return segs


def write_stm(path: str, segments: Sequence[StmSegment]) -> None:
    with open(path, "w") as f:
        for s in segments:
            f.write(f"{s.rec} {s.channel} {s.speaker} {s.start:.3f} {s.end:.3f} {s.text}\n")


def read_stm(path: str) -> List[StmSegment]:
    out = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split(" ", 5)
            if len(parts) < 6:
                continue
            rec, ch, spk, st, en, text = parts
            out.append(StmSegment(rec, ch, spk, float(st), float(en), text))
    return out


# --- tcpWER prep: text normalization + subtitle parsing --------------------

_PUNCT = '!"#$%&()*+,./:;<=>?@[\\]^_`{|}~。、？！・¿¡，'


def normalize_text(text: str) -> str:
    """Lowercase, strip punctuation (Latin + CJK marks), squeeze spaces —
    the tcpWER normalization of `fusion/text_normalization.py:5-16`."""
    import re

    out = re.sub(f"[{re.escape(_PUNCT)}]", "", text.strip().lower())
    return re.sub(r" +", " ", out).strip()


def normalize_text_file(input_path: str, output_path: str) -> None:
    """Normalize a kaldi-style `<uttid> <text...>` file in place-compatible
    form (`fusion/text_normalization.py:4-18`)."""
    with open(input_path, encoding="utf-8") as fin, open(output_path, "w", encoding="utf-8") as fout:
        for line in fin:
            parts = line.strip().split()
            if not parts:
                continue
            fout.write(f"{parts[0]} {normalize_text(' '.join(parts[1:]))}\n")


def _srt_time_to_seconds(ts: str) -> float:
    """'00:18:48,533' → 1128.533 (generate_hyp_stm_from_whisperx_output.py:7-13)."""
    h, m, rest = ts.strip().split(":")
    s, _, ms = rest.partition(",")
    return round(int(h) * 3600 + int(m) * 60 + int(s) + (int(ms) if ms else 0) / 1000.0, 4)


def parse_srt(text: str) -> List[StmSegment]:
    """Parse SRT subtitle text with optional `[SPEAKER_XX]:` prefixes into
    STM segments (rec filled by the caller). Cue text lines without a
    speaker prefix get speaker 'SPEAKER_empty', matching
    generate_hyp_stm_from_whisperx_output.py:36-48."""
    import re

    segs: List[StmSegment] = []
    blocks = re.split(r"\n\s*\n", text.strip())
    for block in blocks:
        lines = [ln for ln in block.strip().splitlines() if ln.strip()]
        if len(lines) < 2:
            continue
        # optional numeric index line
        ti = 1 if "-->" in lines[1] else 0 if "-->" in lines[0] else None
        if ti is None:
            continue
        start_s, _, end_s = lines[ti].partition("-->")
        body = " ".join(lines[ti + 1:]).strip()
        if ":" in body:
            spk, _, txt = body.partition(":")
            spk = spk.replace("[", "").replace("]", "").strip()
        else:
            spk, txt = "SPEAKER_empty", body
        segs.append(
            StmSegment(
                rec="",
                channel="1",
                speaker=spk,
                start=_srt_time_to_seconds(start_s),
                end=_srt_time_to_seconds(end_s),
                text=normalize_text(txt),
            )
        )
    return segs


def srt_file_to_stm(srt_path: str, rec: Optional[str] = None) -> List[StmSegment]:
    """Read one .srt file (whisperx / Kimi-Audio subtitle output) → STM
    segments; `rec` defaults to the file stem, as in
    generate_hyp_stm_from_whisperx_output.py:25-29."""
    import os

    with open(srt_path, encoding="utf-8") as f:
        segs = parse_srt(f.read())
    rec = rec if rec is not None else os.path.splitext(os.path.basename(srt_path))[0]
    return [StmSegment(rec, s.channel, s.speaker, s.start, s.end, s.text) for s in segs]
