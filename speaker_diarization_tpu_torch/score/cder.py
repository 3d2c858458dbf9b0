"""CDER — Conversational Diarization Error Rate (utterance-level).

Reference: `egs/magicdata-ramc/cder/` (CSSDErrorRate,
pyannote_modify/metrics/identification_cssd.py:113-190 + Hungarian label
mapping in diarization.py:115-180). Algorithm per recording:

1. Map hypothesis speaker labels to reference labels by Hungarian matching
   on total time-overlap.
2. tot_ref = number of reference utterances.
3. Every hypothesis utterance whose mapped label has no reference utterance
   with IoU ≥ 0.5 counts one error (including unmapped labels).
4. Candidate (ref, hyp) matches per label are greedily deduplicated best-IoU
   first; duplicate claims count one error each.
5. Reference labels that matched nothing at all add one error per utterance.
   (Reference quirk kept: partially-matched labels do NOT add errors for
   their remaining unmatched utterances.)
CDER_file = tot_err / tot_ref; the corpus number is the mean over files.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..data.rttm import Turn, read_rttm_by_rec


def _overlap(a: Turn, b: Turn) -> float:
    return max(0.0, min(a.end, b.end) - max(a.start, b.start))


def _hungarian_label_map(ref: Sequence[Turn], hyp: Sequence[Turn]) -> Dict[str, str]:
    """hyp label → ref label maximizing total overlap time."""
    ref_labels = sorted({t.speaker for t in ref})
    hyp_labels = sorted({t.speaker for t in hyp})
    if not ref_labels or not hyp_labels:
        return {}
    M = np.zeros((len(hyp_labels), len(ref_labels)))
    ref_by = {l: [t for t in ref if t.speaker == l] for l in ref_labels}
    for i, hl in enumerate(hyp_labels):
        for t in hyp:
            if t.speaker != hl:
                continue
            for j, rl in enumerate(ref_labels):
                M[i, j] += sum(_overlap(t, r) for r in ref_by[rl])
    hi, rj = linear_sum_assignment(-M)
    return {hyp_labels[i]: ref_labels[j] for i, j in zip(hi, rj) if M[i, j] > 0}


def cder_file(ref: Sequence[Turn], hyp: Sequence[Turn]) -> float:
    """Utterance-level CDER for one recording."""
    tot_ref = len(ref)
    if tot_ref == 0:
        return 0.0
    mapping = _hungarian_label_map(ref, hyp)
    ref_by_label: Dict[str, List[Turn]] = {}
    for t in ref:
        ref_by_label.setdefault(t.speaker, []).append(t)

    tot_err = 0
    matches: Dict[str, List[Tuple[float, int, int]]] = {l: [] for l in ref_by_label}
    for hi, h in enumerate(hyp):
        label = mapping.get(h.speaker)
        if label is None or label not in ref_by_label:
            tot_err += 1
            continue
        matched = False
        for ri, r in enumerate(ref_by_label[label]):
            inter = _overlap(h, r)
            union = r.dur + h.dur - inter
            if union > 0 and inter / union >= 0.5:
                matches[label].append((inter / union, ri, hi))
                matched = True
        if not matched:
            tot_err += 1

    for label, cand in matches.items():
        cand.sort(reverse=True)
        seen_ref, seen_hyp = set(), set()
        kept = 0
        for rate, ri, hi in cand:
            if ri in seen_ref or hi in seen_hyp:
                tot_err += 1
            else:
                seen_ref.add(ri)
                seen_hyp.add(hi)
                kept += 1
        if kept == 0:
            # label never matched: every reference utterance of it is an error
            tot_err += len(ref_by_label[label])
    return tot_err / tot_ref


def score_cder(ref, hyp) -> Dict[str, float]:
    """Per-recording CDER + 'avg' over recordings (reference score.py:69-85).

    Accepts RTTM paths or {rec: [Turn]} dicts; recordings missing from the
    hypothesis are skipped with a warning entry (reference prints a warning
    and excludes them from the average)."""
    ref_by = read_rttm_by_rec(ref) if isinstance(ref, str) else ref
    hyp_by = read_rttm_by_rec(hyp) if isinstance(hyp, str) else hyp
    out: Dict[str, float] = {}
    vals = []
    for rec in sorted(ref_by):
        if rec not in hyp_by:
            continue
        v = cder_file(ref_by[rec], hyp_by[rec])
        out[rec] = v
        vals.append(v)
    out["avg"] = float(np.mean(vals)) if vals else float("nan")
    return out
