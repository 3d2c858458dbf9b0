"""RTTM (Rich Transcription Time Marked) segment I/O.

The lingua franca of the whole stack: data prep emits it, inference emits it,
the DER scorer consumes it (reference: bin/make_rttm.py, ts_vad2/infer.py:104-131).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple


@dataclass(frozen=True)
class Turn:
    rec: str
    start: float
    dur: float
    speaker: str

    @property
    def end(self) -> float:
        return self.start + self.dur


def parse_rttm_line(line: str) -> Turn | None:
    parts = line.split()
    if not parts or parts[0] != "SPEAKER":
        return None
    return Turn(rec=parts[1], start=float(parts[3]), dur=float(parts[4]), speaker=parts[7])


def read_rttm(path) -> List[Turn]:
    turns = []
    with open(path) as f:
        for line in f:
            t = parse_rttm_line(line)
            if t is not None:
                turns.append(t)
    return turns


def read_rttm_by_rec(path) -> Dict[str, List[Turn]]:
    by_rec: Dict[str, List[Turn]] = {}
    for t in read_rttm(path):
        by_rec.setdefault(t.rec, []).append(t)
    for rec in by_rec:
        by_rec[rec].sort(key=lambda t: (t.start, t.end, t.speaker))
    return by_rec


def format_turn(t: Turn, channel: int = 1) -> str:
    return (
        f"SPEAKER {t.rec} {channel} {t.start:.3f} {t.dur:.3f} "
        f"<NA> <NA> {t.speaker} <NA> <NA>"
    )


def write_rttm(path, turns: Iterable[Turn], channel: int = 1) -> None:
    with open(path, "w") as f:
        for t in turns:
            f.write(format_turn(t, channel) + "\n")


def turns_from_frames(
    activity, rec: str, speakers: List[str], frame_shift_s: float, offset_s: float = 0.0
) -> List[Turn]:
    """Binary frame activity (T, S) → merged speaker turns."""
    import numpy as np

    activity = np.asarray(activity)
    turns: List[Turn] = []
    T = activity.shape[0]
    for s, name in enumerate(speakers):
        a = activity[:, s].astype(bool)
        if not a.any():
            continue
        d = np.diff(a.astype(np.int8), prepend=0, append=0)
        starts = np.nonzero(d == 1)[0]
        ends = np.nonzero(d == -1)[0]
        for st, en in zip(starts, ends):
            turns.append(Turn(rec, offset_s + st * frame_shift_s, (en - st) * frame_shift_s, name))
    turns.sort(key=lambda t: (t.start, t.end, t.speaker))
    return turns


def frames_from_turns(
    turns: Iterable[Turn], speakers: List[str], frame_shift_s: float, n_frames: int, offset_s: float = 0.0
):
    """Speaker turns → binary frame activity (n_frames, len(speakers))."""
    import numpy as np

    spk_idx = {s: i for i, s in enumerate(speakers)}
    A = np.zeros((n_frames, len(speakers)), dtype=np.int32)
    for t in turns:
        if t.speaker not in spk_idx:
            continue
        st = int(round((t.start - offset_s) / frame_shift_s))
        en = int(round((t.end - offset_s) / frame_shift_s))
        st, en = max(0, st), min(n_frames, en)
        if en > st:
            A[st:en, spk_idx[t.speaker]] = 1
    return A


def load_uem(path) -> Dict[str, List[Tuple[float, float]]]:
    """UEM scoring-region file: rec channel start end."""
    regions: Dict[str, List[Tuple[float, float]]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 4:
                regions.setdefault(parts[0], []).append((float(parts[2]), float(parts[3])))
    return regions
