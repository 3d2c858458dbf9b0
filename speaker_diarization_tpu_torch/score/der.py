"""Diarization Error Rate scorer with SCTK md-eval.pl semantics.

Replicates the speaker-diarization scoring path of
`SCTK-2.4.12/src/md-eval/md-eval.pl` (score_speaker_diarization, ~line 1870;
create_speaker_segs ~2261; add_collars_to_uem ~2034; uem_from_rttm ~2245;
map_speakers ~2461), validated against golden md-eval.pl outputs in
tests/test_der.py:

- per file, the evaluation UEM defaults to [min ref begin, max ref end];
- the ref↔sys speaker map maximizes total overlap time over the *un-collared*
  UEM (Hungarian / weighted bipartite match);
- scoring excludes ±collar zones around every reference segment boundary;
- with `overlap_limit` ( md-eval -1 ) scoring is limited to regions where at
  most one reference speaker is talking;
- the timeline is partitioned into elementary segments at every speaker
  boundary; per segment with Nref/Nsys active and Nmap matched pairs:
    MISS  += dur * max(Nref - Nsys, 0)
    FA    += dur * max(Nsys - Nref, 0)
    SPKERR+= dur * (min(Nref, Nsys) - Nmap)
    SCORED+= dur * Nref
  and DER = (MISS + FA + SPKERR) / SCORED.

A native C++ core (score/native/der_core.cpp) accelerates the event sweep for
large batches of long recordings; this module falls back to the pure-NumPy
sweep when the shared library is unavailable. Both paths share identical
segment semantics and are cross-checked in tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..data.rttm import Turn, read_rttm_by_rec

_EPS = 1e-8


@dataclass
class DerResult:
    scored_speaker_time: float = 0.0
    missed_speaker_time: float = 0.0
    falarm_speaker_time: float = 0.0
    speaker_error_time: float = 0.0
    scored_time: float = 0.0
    scored_speech: float = 0.0
    missed_speech: float = 0.0
    falarm_speech: float = 0.0
    speaker_maps: Dict[str, Dict[str, str]] = field(default_factory=dict)
    per_file: Dict[str, "DerResult"] = field(default_factory=dict)

    @property
    def der(self) -> float:
        return (
            self.missed_speaker_time + self.falarm_speaker_time + self.speaker_error_time
        ) / max(self.scored_speaker_time, _EPS)

    @property
    def miss_rate(self) -> float:
        return self.missed_speaker_time / max(self.scored_speaker_time, _EPS)

    @property
    def falarm_rate(self) -> float:
        return self.falarm_speaker_time / max(self.scored_speaker_time, _EPS)

    @property
    def confusion_rate(self) -> float:
        return self.speaker_error_time / max(self.scored_speaker_time, _EPS)

    def summary(self) -> str:
        return (
            f"DER {100*self.der:.2f}%, MS {100*self.miss_rate:.2f}%, "
            f"FA {100*self.falarm_rate:.2f}%, SC {100*self.confusion_rate:.2f}%"
        )


Interval = Tuple[float, float]


def _merge_speaker_turns(turns: Iterable[Turn]) -> Dict[str, List[Interval]]:
    """Group turns by speaker and union overlapping same-speaker intervals."""
    by_spk: Dict[str, List[Interval]] = {}
    for t in turns:
        if t.dur > 0:
            by_spk.setdefault(t.speaker, []).append((t.start, t.end))
    for spk, ivs in by_spk.items():
        ivs.sort()
        merged = [list(ivs[0])]
        for s, e in ivs[1:]:
            if s <= merged[-1][1] + _EPS:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        by_spk[spk] = [(s, e) for s, e in merged]
    return by_spk


def _subtract_intervals(uem: List[Interval], cuts: List[Interval]) -> List[Interval]:
    """Set-subtract `cuts` from the union-of-intervals `uem`."""
    if not cuts:
        return uem
    cuts = sorted(cuts)
    out: List[Interval] = []
    for ub, ue in uem:
        cur = ub
        for cb, ce in cuts:
            if ce <= cur or cb >= ue:
                continue
            if cb > cur:
                out.append((cur, min(cb, ue)))
            cur = max(cur, ce)
            if cur >= ue:
                break
        if cur < ue:
            out.append((cur, ue))
    return [(s, e) for s, e in out if e > s + _EPS]


def _elementary_segments(
    uem: List[Interval],
    ref: Dict[str, List[Interval]],
    sys: Dict[str, List[Interval]],
):
    """Sweep the event timeline → (dur, ref_active_set, sys_active_set) list.

    Mirrors md-eval create_speaker_segs: END events sort before BEG at equal
    times (within epsilon); active-speaker sets are tracked with counters.
    """
    events = []  # (time, order, kind, who, delta); kind: 0=uem,1=ref,2=sys
    for s, e in uem:
        if e > s + _EPS:
            events.append((s, 1, 0, "", 1))
            events.append((e, 0, 0, "", -1))
    for spk, ivs in ref.items():
        for s, e in ivs:
            events.append((s, 1, 1, spk, 1))
            events.append((e, 0, 1, spk, -1))
    for spk, ivs in sys.items():
        for s, e in ivs:
            events.append((s, 1, 2, spk, 1))
            events.append((e, 0, 2, spk, -1))
    events.sort(key=lambda ev: (ev[0], ev[1]))

    segs = []
    ref_active: Dict[str, int] = {}
    sys_active: Dict[str, int] = {}
    evaluate = False
    tbeg = 0.0
    for time, _order, kind, who, delta in events:
        if evaluate and tbeg < time - _EPS:
            segs.append((time - tbeg, frozenset(ref_active), frozenset(sys_active)))
            tbeg = time
        if kind == 0:
            evaluate = delta > 0
            if evaluate:
                tbeg = time
        else:
            active = ref_active if kind == 1 else sys_active
            c = active.get(who, 0) + delta
            if c <= 0:
                active.pop(who, None)
            else:
                active[who] = c
    return segs


def _map_speakers(overlap: Dict[str, Dict[str, float]]) -> Dict[str, str]:
    """Hungarian max-total-overlap ref→sys map; zero-overlap pairs unmapped."""
    refs = sorted(overlap.keys())
    syss = sorted({s for d in overlap.values() for s in d})
    if not refs or not syss:
        return {}
    M = np.zeros((len(refs), len(syss)))
    for i, r in enumerate(refs):
        for j, s in enumerate(syss):
            M[i, j] = overlap.get(r, {}).get(s, 0.0)
    ri, sj = linear_sum_assignment(-M)
    return {refs[i]: syss[j] for i, j in zip(ri, sj) if M[i, j] > 0}


def _overlap_regions(ref: Dict[str, List[Interval]]) -> List[Interval]:
    """Regions where ≥2 reference speakers are simultaneously active."""
    events = []
    for ivs in ref.values():
        for s, e in ivs:
            events.append((s, 1))
            events.append((e, -1))
    events.sort()
    out: List[Interval] = []
    n, start = 0, 0.0
    for t, d in events:
        was = n
        n += d
        if was < 2 <= n:
            start = t
        elif was >= 2 > n:
            out.append((start, t))
    return out


def _intersect_intervals(uem: List[Interval], keep: List[Interval]) -> List[Interval]:
    """Intersect the union-of-intervals `uem` with the union `keep`."""
    keep = sorted(keep)
    out: List[Interval] = []
    for ub, ue in uem:
        for kb, ke in keep:
            s, e = max(ub, kb), min(ue, ke)
            if e > s + _EPS:
                out.append((s, e))
    return out


def score_file_native(
    ref_turns: Sequence[Turn],
    sys_turns: Sequence[Turn],
    collar: float = 0.0,
    uem: Optional[List[Interval]] = None,
    overlap_limit: bool = False,
) -> Optional[Tuple[DerResult, Dict[str, str]]]:
    """C++ fast path (score/native/der_core.cpp); None if lib unavailable."""
    import ctypes

    from .native_build import get_lib

    lib = get_lib()
    if lib is None:
        return None
    ref_spks = sorted({t.speaker for t in ref_turns if t.dur > 0})
    sys_spks = sorted({t.speaker for t in sys_turns if t.dur > 0})
    r_idx = {s: i for i, s in enumerate(ref_spks)}
    s_idx = {s: i for i, s in enumerate(sys_spks)}

    def arrs(turns, idx):
        ts = [t for t in turns if t.dur > 0]
        st = np.array([t.start for t in ts], np.float64)
        en = np.array([t.end for t in ts], np.float64)
        sp = np.array([idx[t.speaker] for t in ts], np.int32)
        return st, en, sp

    rs, re_, rk = arrs(ref_turns, r_idx)
    ss, se, sk = arrs(sys_turns, s_idx)
    if uem:
        us = np.array([s for s, _ in uem], np.float64)
        ue = np.array([e for _, e in uem], np.float64)
    else:
        us = np.zeros(0, np.float64)
        ue = np.zeros(0, np.float64)
    out = np.zeros(8, np.float64)
    omap = np.full(max(len(ref_spks), 1), -1, np.int32)

    D = ctypes.POINTER(ctypes.c_double)
    I = ctypes.POINTER(ctypes.c_int32)
    lib.sdt_score_der_file(
        rs.ctypes.data_as(D), re_.ctypes.data_as(D), rk.ctypes.data_as(I), len(rs), len(ref_spks),
        ss.ctypes.data_as(D), se.ctypes.data_as(D), sk.ctypes.data_as(I), len(ss), len(sys_spks),
        us.ctypes.data_as(D), ue.ctypes.data_as(D), len(us),
        float(collar), int(overlap_limit),
        out.ctypes.data_as(D), omap.ctypes.data_as(I),
    )
    res = DerResult(
        scored_speaker_time=out[0], missed_speaker_time=out[1], falarm_speaker_time=out[2],
        speaker_error_time=out[3], scored_time=out[4], scored_speech=out[5],
        missed_speech=out[6], falarm_speech=out[7],
    )
    spkr_map = {ref_spks[i]: sys_spks[omap[i]] for i in range(len(ref_spks)) if omap[i] >= 0}
    return res, spkr_map


def score_file(
    ref_turns: Sequence[Turn],
    sys_turns: Sequence[Turn],
    collar: float = 0.0,
    uem: Optional[List[Interval]] = None,
    overlap_limit: bool = False,
    use_native: bool = True,
    regions: str = "all",
) -> Tuple[DerResult, Dict[str, str]]:
    """Score one recording. Returns (stats, ref→sys speaker map).

    `regions` selects which parts of the timeline are scored (spyder-style
    breakdown, used by the reference for overlap-only DER,
    egs/alimeeting/run_ts_vad2.sh:249-261):
      - "all": everything inside the UEM (default; md-eval behavior);
      - "single": only where ≤1 reference speaker is active (== md-eval -1,
        equivalent to overlap_limit=True);
      - "overlap": only where ≥2 reference speakers are active.
    The ref→sys speaker map is always computed over the full un-collared UEM.
    """
    if regions not in ("all", "single", "overlap"):
        raise ValueError(f"regions must be all|single|overlap, got {regions!r}")
    if regions == "single":
        overlap_limit = True
    if use_native and regions != "overlap":
        native = score_file_native(ref_turns, sys_turns, collar, uem, overlap_limit)
        if native is not None:
            return native
    ref = _merge_speaker_turns(ref_turns)
    sys = _merge_speaker_turns(sys_turns)

    if uem is None:
        if not ref:
            uem = []
        else:
            lo = min(s for ivs in ref.values() for s, _ in ivs)
            hi = max(e for ivs in ref.values() for _, e in ivs)
            uem = [(lo, hi)]

    # speaker map over un-collared UEM
    overlap: Dict[str, Dict[str, float]] = {}
    for dur, r_act, s_act in _elementary_segments(uem, ref, sys):
        if not r_act:
            continue
        for r in r_act:
            for s in s_act:
                overlap.setdefault(r, {})
                overlap[r][s] = overlap[r].get(s, 0.0) + dur
    spkr_map = _map_speakers(overlap) if overlap else {}

    # scoring UEM: remove collars around every RAW reference segment boundary
    # (md-eval add_collars_to_uem uses the un-merged RTTM segments, so interior
    # boundaries between abutting same-speaker turns are also excluded)
    score_uem = uem
    if collar > 0:
        cuts = []
        for t in ref_turns:
            if t.dur > 0:
                cuts.append((t.start - collar, t.start + collar))
                cuts.append((t.end - collar, t.end + collar))
        score_uem = _subtract_intervals(uem, cuts)
    if overlap_limit:
        score_uem = _subtract_intervals(score_uem, _overlap_regions(ref))
    elif regions == "overlap":
        score_uem = _intersect_intervals(score_uem, _overlap_regions(ref))

    res = DerResult()
    for dur, r_act, s_act in _elementary_segments(score_uem, ref, sys):
        nref, nsys = len(r_act), len(s_act)
        res.scored_time += dur
        if nref:
            res.scored_speech += dur
            if not nsys:
                res.missed_speech += dur
        elif nsys:
            res.falarm_speech += dur
        nmap = sum(1 for r in r_act if spkr_map.get(r) in s_act)
        res.scored_speaker_time += dur * nref
        res.missed_speaker_time += dur * max(nref - nsys, 0)
        res.falarm_speaker_time += dur * max(nsys - nref, 0)
        res.speaker_error_time += dur * (min(nref, nsys) - nmap)
    return res, spkr_map


def score_der(
    ref: str | Dict[str, List[Turn]],
    sys: str | Dict[str, List[Turn]],
    collar: float = 0.0,
    uem: Optional[Dict[str, List[Interval]]] = None,
    overlap_limit: bool = False,
    regions: str = "all",
) -> DerResult:
    """Score hypothesis vs reference RTTM (paths or pre-parsed dicts).

    Accumulates stats over all reference recordings (md-eval overall line);
    recordings absent from the hypothesis count fully as misses.
    """
    ref_by_rec = read_rttm_by_rec(ref) if isinstance(ref, str) else ref
    sys_by_rec = read_rttm_by_rec(sys) if isinstance(sys, str) else sys

    total = DerResult()
    for rec in sorted(ref_by_rec):
        file_uem = uem.get(rec) if uem else None
        r, m = score_file(
            ref_by_rec[rec], sys_by_rec.get(rec, []), collar, file_uem, overlap_limit,
            regions=regions,
        )
        total.scored_speaker_time += r.scored_speaker_time
        total.missed_speaker_time += r.missed_speaker_time
        total.falarm_speaker_time += r.falarm_speaker_time
        total.speaker_error_time += r.speaker_error_time
        total.scored_time += r.scored_time
        total.scored_speech += r.scored_speech
        total.missed_speech += r.missed_speech
        total.falarm_speech += r.falarm_speech
        total.speaker_maps[rec] = m
        total.per_file[rec] = r
    return total
