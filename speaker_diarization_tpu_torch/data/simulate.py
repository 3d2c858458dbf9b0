"""Multi-talker mixture simulation.

A copy of speaker_diarization_tpu/data/simulate.py.

Reimplements the reference's two-stage pipeline
(the reference `speaker_diarization/bin/random_mixture.py` +
`make_mixture.py`): stage 1 samples mixture *specs* (speakers, cycled
utterances, exponential inter-utterance silences, background noise + SNR,
optional RIR); stage 2 renders wavs + a Kaldi data dir (wav.scp / segments /
utt2spk / reco2dur / rttm).

Extras over the reference:
- RIR reverberation via scipy fftconvolve (no Kaldi wav-reverberate binary),
  power-normalized so the dry/wet speech level matches;
- `synthesize_speaker_corpus` generates a fully synthetic single-speaker
  corpus (distinct harmonic voices) so the entire train→infer→score loop is
  runnable hermetically — the de-facto CI fixture (SURVEY.md §4).
"""

from __future__ import annotations

import itertools
import json
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import kaldi_io, wav as wavio
from .rttm import Turn, write_rttm


# ---------------------------------------------------------------------------
# Synthetic single-speaker corpus (hermetic fixture)
# ---------------------------------------------------------------------------


def synthesize_voice(
    rng: np.random.Generator,
    f0: float,
    tilt: float,
    formants: Sequence[float],
    n_samples: int,
    rate: int,
) -> np.ndarray:
    """A crude but spectrally distinctive 'voice': harmonic stack with
    speaker-specific tilt + formant peaks, syllabic amplitude modulation."""
    t = np.arange(n_samples) / rate
    # vibrato-ish f0 wobble
    f0_t = f0 * (1.0 + 0.02 * np.sin(2 * np.pi * rng.uniform(4, 7) * t))
    phase = 2 * np.pi * np.cumsum(f0_t) / rate
    sig = np.zeros(n_samples)
    n_harm = max(3, int((rate / 2 * 0.8) / f0))
    for k in range(1, n_harm + 1):
        fk = k * f0
        amp = k ** tilt
        for fc, bw in zip(formants, (120.0, 180.0, 260.0)):
            amp *= 1.0 + 2.0 * np.exp(-0.5 * ((fk - fc) / bw) ** 2)
        sig += amp * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
    # syllabic envelope (~3-5 Hz)
    env = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2.5, 5.0) * t + rng.uniform(0, 2 * np.pi))
    sig = sig * env + 0.01 * rng.standard_normal(n_samples)
    sig /= max(np.abs(sig).max(), 1e-6)
    return (0.3 * sig).astype(np.float32)


def synthesize_speaker_corpus(
    out_dir: str,
    n_speakers: int = 6,
    utts_per_speaker: int = 10,
    rate: int = 8000,
    min_dur: float = 1.0,
    max_dur: float = 4.0,
    seed: int = 0,
) -> str:
    """Write a Kaldi data dir of synthetic single-speaker utterances."""
    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(out_dir, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    wavs, utt2spk = {}, {}
    for s in range(n_speakers):
        spk = f"spk{s:03d}"
        f0 = float(rng.uniform(80, 280))
        tilt = float(rng.uniform(-1.6, -0.7))
        formants = sorted(rng.uniform(300, rate / 2 * 0.7, size=3))
        for u in range(utts_per_speaker):
            utt = f"{spk}_utt{u:03d}"
            dur = float(rng.uniform(min_dur, max_dur))
            sig = synthesize_voice(rng, f0, tilt, formants, int(dur * rate), rate)
            path = os.path.join(wav_dir, f"{utt}.wav")
            wavio.write_wav(path, sig, rate)
            wavs[utt] = path
            utt2spk[utt] = spk
    kaldi_io.save_data_dir(out_dir, wavs=wavs, utt2spk=utt2spk)
    return out_dir


def synthesize_noise_corpus(out_dir: str, n_noises: int = 4, rate: int = 8000, dur: float = 10.0, seed: int = 1) -> str:
    """Background noises: colored noise + hum."""
    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(out_dir, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    wavs = {}
    n = int(dur * rate)
    for i in range(n_noises):
        # 1/f-ish colored noise via repeated one-pole low-pass of white noise
        alpha = rng.uniform(0.8, 0.99)
        colored = rng.standard_normal(n)
        for _ in range(2):
            colored = alpha * np.concatenate([[0], colored[:-1]]) + (1 - alpha) * colored
        colored /= max(np.abs(colored).max(), 1e-6)
        path = os.path.join(wav_dir, f"noise{i:02d}.wav")
        wavio.write_wav(path, (0.3 * colored).astype(np.float32), rate)
        wavs[f"noise{i:02d}"] = path
    kaldi_io.save_data_dir(out_dir, wavs=wavs)
    return out_dir


def synthesize_rir_corpus(
    out_dir: str, n_rirs: int = 4, rate: int = 8000, seed: int = 2,
    method: str = "decay",
) -> str:
    """RIR corpus. method='decay': exponentially-decaying sparse
    reflections (cheap). method='image_source': geometric shoebox-room
    image-method RIRs with genrir.py's sampling semantics (room dims, mic
    near center, Sabine-validated T60) — see data/room.py."""
    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(out_dir, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    wavs = {}
    if method == "image_source":
        from .room import RandomRoomSimulator

        sim = RandomRoomSimulator(fs=rate, seed=seed)
        for i in range(n_rirs):
            h = sim.rirs(1)[0]
            path = os.path.join(wav_dir, f"rir{i:02d}.wav")
            wavio.write_wav(path, h, rate, subtype="FLOAT")
            wavs[f"rir{i:02d}"] = path
        kaldi_io.save_data_dir(out_dir, wavs=wavs)
        return out_dir
    for i in range(n_rirs):
        t60 = rng.uniform(0.1, 0.4)
        n = int(t60 * rate)
        h = rng.standard_normal(n) * np.exp(-6.9 * np.arange(n) / n)
        h[0] = 1.0
        h /= np.sqrt(np.sum(h ** 2))
        path = os.path.join(wav_dir, f"rir{i:02d}.wav")
        wavio.write_wav(path, h.astype(np.float32), rate, subtype="FLOAT")
        wavs[f"rir{i:02d}"] = path
    kaldi_io.save_data_dir(out_dir, wavs=wavs)
    return out_dir


# ---------------------------------------------------------------------------
# Stage 1: random mixture specs (reference random_mixture.py semantics)
# ---------------------------------------------------------------------------


def random_mixture_specs(
    data_dir: str,
    noise_dir: Optional[str] = None,
    rir_dir: Optional[str] = None,
    n_mixtures: int = 10,
    n_speakers: int = 2,
    min_utts: int = 5,
    max_utts: int = 10,
    sil_scale: float = 2.0,
    noise_snrs: Sequence[float] = (5.0, 10.0, 15.0, 20.0),
    speech_rvb_probability: float = 1.0,
    seed: int = 777,
) -> List[dict]:
    """Sample mixture configurations (one JSON-able dict per mixture)."""
    rnd = random.Random(seed)
    nprng = np.random.default_rng(seed)
    wavs = kaldi_io.load_scp(os.path.join(data_dir, "wav.scp"))
    spk2utt = kaldi_io.load_spk2utt(os.path.join(data_dir, "spk2utt"))
    noises = kaldi_io.load_scp(os.path.join(noise_dir, "wav.scp")) if noise_dir else {}
    rirs = kaldi_io.load_scp(os.path.join(rir_dir, "wav.scp")) if rir_dir else {}
    all_speakers = sorted(spk2utt)
    all_noises = sorted(noises)
    all_rirs = sorted(rirs)

    specs = []
    for it in range(n_mixtures):
        recid = f"mix_{it + 1:07d}"
        speakers = rnd.sample(all_speakers, n_speakers)
        mixture = {"speakers": [], "recid": recid}
        for speaker in speakers:
            n_utts = int(nprng.integers(min_utts, max_utts + 1))
            cyc = itertools.cycle(spk2utt[speaker])
            for _ in range(int(nprng.integers(0, len(spk2utt[speaker])))):
                next(cyc)
            utts = [next(cyc) for _ in range(n_utts)]
            rir = rirs[rnd.choice(all_rirs)] if (all_rirs and rnd.random() < speech_rvb_probability) else None
            mixture["speakers"].append(
                {
                    "spkid": speaker,
                    "rir": rir,
                    "utts": [wavs[u] for u in utts],
                    "intervals": nprng.exponential(sil_scale, size=n_utts).tolist(),
                }
            )
        mixture["noise"] = noises[rnd.choice(all_noises)] if all_noises else None
        mixture["snr"] = float(rnd.choice(list(noise_snrs)))
        specs.append(mixture)
    return specs


# ---------------------------------------------------------------------------
# Stage 2: render mixtures (reference make_mixture.py semantics)
# ---------------------------------------------------------------------------


def _reverberate(speech: np.ndarray, rir: np.ndarray) -> np.ndarray:
    from scipy.signal import fftconvolve

    wet = fftconvolve(speech, rir)[: len(speech)]
    p_dry = np.sum(speech ** 2) + 1e-12
    p_wet = np.sum(wet ** 2) + 1e-12
    return (wet * np.sqrt(p_dry / p_wet)).astype(np.float32)


def make_mixtures(
    specs: Sequence[dict],
    out_data_dir: str,
    out_wav_dir: str,
    rate: int = 8000,
) -> str:
    """Render mixture specs to wavs + Kaldi data dir (+ rttm)."""
    os.makedirs(out_wav_dir, exist_ok=True)
    os.makedirs(out_data_dir, exist_ok=True)
    wav_scp: Dict[str, str] = {}
    segments: List[dict] = []
    utt2spk: Dict[str, str] = {}
    reco2dur: Dict[str, float] = {}
    turns: List[Turn] = []

    for spec in specs:
        recid = spec["recid"]
        per_spk = []
        for speaker in spec["speakers"]:
            spkid = speaker["spkid"]
            rir = None
            if speaker.get("rir"):
                rir, _ = wavio.load_wav_maybe_piped(speaker["rir"])
            data = []
            pos = 0
            for interval, utt in zip(speaker["intervals"], speaker["utts"]):
                silence = np.zeros(int(interval * rate), dtype=np.float32)
                data.append(silence)
                if isinstance(utt, (list, tuple)):
                    rec, st, et = utt
                    speech, r = wavio.load_wav_maybe_piped(rec, int(round(st * rate)), int(round(et * rate)))
                else:
                    speech, r = wavio.load_wav_maybe_piped(utt)
                assert r == rate, f"sample-rate mismatch: {r} != {rate} for {utt}"
                if rir is not None:
                    speech = _reverberate(speech, rir)
                data.append(speech)
                startpos = pos + len(silence)
                endpos = startpos + len(speech)
                uttid = f"{spkid}_{recid}_{int(startpos / rate * 100):07d}_{int(endpos / rate * 100):07d}"
                segments.append(dict(utt=uttid, rec=recid, st=startpos / rate, et=endpos / rate))
                utt2spk[uttid] = spkid
                turns.append(Turn(recid, startpos / rate, (endpos - startpos) / rate, spkid))
                pos = endpos
            per_spk.append(np.concatenate(data) if data else np.zeros(0, np.float32))

        maxlen = max(len(x) for x in per_spk)
        mixture = np.sum([np.pad(x, (0, maxlen - len(x))) for x in per_spk], axis=0)
        if spec.get("noise"):
            noise, r = wavio.load_wav_maybe_piped(spec["noise"])
            assert r == rate
            if maxlen > len(noise):
                noise = np.pad(noise, (0, maxlen - len(noise)), "wrap")
            else:
                noise = noise[:maxlen]
            sig_p = np.sum(mixture ** 2) / max(len(mixture), 1)
            noi_p = np.sum(noise ** 2) / max(len(noise), 1)
            scale = np.sqrt(10 ** (-spec["snr"] / 10) * sig_p / max(noi_p, 1e-12))
            mixture = mixture + noise * scale
        peak = np.abs(mixture).max()
        if peak > 0.99:
            mixture = mixture * (0.99 / peak)
        out_path = os.path.join(out_wav_dir, f"{recid}.wav")
        wavio.write_wav(out_path, mixture.astype(np.float32), rate)
        wav_scp[recid] = os.path.abspath(out_path)
        reco2dur[recid] = maxlen / rate

    kaldi_io.save_data_dir(out_data_dir, wavs=wav_scp, segments=segments, utt2spk=utt2spk, reco2dur=reco2dur)
    write_rttm(os.path.join(out_data_dir, "rttm"), turns)
    return out_data_dir


# ---------------------------------------------------------------------------
# LibriCSS-style meeting simulation
# (reference source_md/gen_mixspec_mtg.py + mixaudio_mtg.py)
# ---------------------------------------------------------------------------

# Mirror of source_md/meeting_dynamics.json: five equally-likely session
# shapes trading #speakers against utterances per speaker.
DEFAULT_MEETING_DYNAMICS = {
    "probabilities": {f"cfg{i}": 0.2 for i in range(1, 6)},
    "configurations": {
        "cfg1": dict(speakers_per_session=[7, 8], utterances_per_speaker=[2],
                     overlap_time_ratio=[0.0, 0.3], silence_probability=0.1,
                     silence_duration=[0.6, 2.0], allow_3fold_overlap=False),
        "cfg2": dict(speakers_per_session=[5, 6], utterances_per_speaker=[3],
                     overlap_time_ratio=[0.0, 0.3], silence_probability=0.1,
                     silence_duration=[0.6, 2.0], allow_3fold_overlap=False),
        "cfg3": dict(speakers_per_session=[4], utterances_per_speaker=[3, 4],
                     overlap_time_ratio=[0.0, 0.3], silence_probability=0.1,
                     silence_duration=[0.6, 2.0], allow_3fold_overlap=False),
        "cfg4": dict(speakers_per_session=[3], utterances_per_speaker=[4, 5, 6],
                     overlap_time_ratio=[0.0, 0.3], silence_probability=0.1,
                     silence_duration=[0.6, 2.0], allow_3fold_overlap=False),
        "cfg5": dict(speakers_per_session=[2], utterances_per_speaker=[7, 8],
                     overlap_time_ratio=[0.0, 0.3], silence_probability=0.1,
                     silence_duration=[0.6, 2.0], allow_3fold_overlap=False),
    },
}


def give_timing(
    utts: List[dict],
    rnd: random.Random,
    overlap_time_ratio: float = 0.3,
    sil_prob: float = 0.2,
    sil_dur: Sequence[float] = (0.3, 2.0),
    allow_3fold_overlap: bool = False,
) -> List[dict]:
    """Assign start offsets to an ordered utterance list
    (gen_mixspec_mtg.py:110-174).

    The total overlap budget `total_len · r/(1+r)` is distributed over the
    overlapping boundaries by stick-breaking (Beta(1,5) sticks); each
    non-overlap boundary instead inserts a uniform silence. Offsets are
    clamped so one speaker never overlaps themself and (unless allowed) at
    most two utterances overlap at a time. Returns new dicts with 'offset'.
    """
    utts = [dict(u) for u in utts]
    total_len = float(sum(u["length_in_seconds"] for u in utts))
    total_overlap = total_len * overlap_time_ratio / (1.0 + overlap_time_ratio)

    to_overlap = [rnd.random() < (1.0 - sil_prob) for _ in range(len(utts) - 1)]
    n_overlaps = sum(to_overlap)
    probs = []
    rem = 1.0
    for _ in range(max(n_overlaps - 1, 0)):
        p = rnd.betavariate(1, 5)
        probs.append(rem * p)
        rem *= 1.0 - p
    probs.append(rem)
    rnd.shuffle(probs)

    idx = -1
    boundary = [0.0]
    for b in to_overlap:
        if b:
            idx += 1
            boundary.append(probs[idx] * total_overlap)
        else:
            boundary.append(-rnd.uniform(sil_dur[0], sil_dur[1]))

    speakers = {u["speaker_id"] for u in utts}
    offset = 0.0
    last_end = {s: 0.0 for s in speakers}
    last_end_sorted = sorted(last_end.values(), reverse=True)
    for u, ot in zip(utts, boundary):
        spk = u["speaker_id"]
        if len(last_end_sorted) > 1 and not allow_3fold_overlap:
            ot = min(ot, offset - last_end[spk], offset - last_end_sorted[1])
        else:
            ot = min(ot, offset - last_end[spk])
        offset -= ot
        u["offset"] = offset
        offset += u["length_in_seconds"]
        last_end[spk] = offset
        last_end_sorted = sorted(last_end.values(), reverse=True)
        offset = last_end_sorted[0]
    return utts


def meeting_mixture_specs(
    data_dir: str,
    dynamics: Optional[dict] = None,
    noise_dir: Optional[str] = None,
    rir_dir: Optional[str] = None,
    noise_snrs: Sequence[float] = (10.0, 15.0, 20.0),
    rvb_probability: float = 0.5,
    seed: int = 7,
) -> List[dict]:
    """Group a single-speaker corpus into meeting sessions and time them
    (gen_mixspec_mtg.py:10-106): shuffled speakers are consumed round-robin
    into sessions drawn from the dynamics configs; per session, utterances
    are interleaved so adjacent turns avoid the same speaker, then timed
    with `give_timing`.
    """
    dynamics = dynamics or DEFAULT_MEETING_DYNAMICS
    rnd = random.Random(seed)
    wavs = kaldi_io.load_scp(os.path.join(data_dir, "wav.scp"))
    spk2utt = kaldi_io.load_spk2utt(os.path.join(data_dir, "spk2utt"))
    noises = kaldi_io.load_scp(os.path.join(noise_dir, "wav.scp")) if noise_dir else {}
    rirs = kaldi_io.load_scp(os.path.join(rir_dir, "wav.scp")) if rir_dir else {}
    durations = {u: wavio.wav_info(p)["duration"] for u, p in wavs.items()}

    cfg_names = sorted(dynamics["probabilities"])
    cfg_weights = [dynamics["probabilities"][c] for c in cfg_names]

    dyn = {}
    for spk, utts in spk2utt.items():
        lst = list(utts)
        rnd.shuffle(lst)
        dyn[spk] = lst

    specs: List[dict] = []
    while dyn:
        speakers = sorted(dyn)
        rnd.shuffle(speakers)
        start = 0
        while start < len(speakers):
            cfg = dynamics["configurations"][rnd.choices(cfg_names, weights=cfg_weights, k=1)[0]]
            n_spk = rnd.choice(cfg["speakers_per_session"])
            cur = speakers[start : start + n_spk]
            start += n_spk

            rounds: List[List[dict]] = []
            for spk in cur:
                if spk not in dyn:
                    continue
                n_utts = rnd.choice(cfg["utterances_per_speaker"])
                pop, rem = dyn[spk][:n_utts], dyn[spk][n_utts:]
                if rem:
                    dyn[spk] = rem
                else:
                    dyn.pop(spk)
                for i, utt in enumerate(pop):
                    while len(rounds) <= i:
                        rounds.append([])
                    rounds[i].append(dict(utt=utt, speaker_id=spk, length_in_seconds=durations[utt]))
            if not rounds:
                continue

            # interleave rounds, avoiding same-speaker adjacency
            ordered = list(rounds[0])
            for grp in rounds[1:]:
                if not grp:
                    break
                if len(grp) == 1:
                    ordered.append(grp[0])
                    continue
                last = ordered[-1]["speaker_id"]
                grp = list(grp)
                for _ in range(20):
                    rnd.shuffle(grp)
                    if grp[0]["speaker_id"] != last:
                        break
                ordered += grp

            r = rnd.uniform(cfg["overlap_time_ratio"][0], cfg["overlap_time_ratio"][1])
            timed = give_timing(
                ordered, rnd,
                overlap_time_ratio=r,
                sil_prob=cfg["silence_probability"],
                sil_dur=cfg["silence_duration"],
                allow_3fold_overlap=cfg["allow_3fold_overlap"],
            )
            spec = {
                "recid": f"meeting_{len(specs) + 1:05d}",
                "utterances": [
                    dict(utt=u["utt"], path=wavs[u["utt"]], speaker_id=u["speaker_id"],
                         offset=u["offset"], length_in_seconds=u["length_in_seconds"])
                    for u in timed
                ],
                "target_overlap_time_ratio": r,
                "noise": noises[rnd.choice(sorted(noises))] if noises else None,
                "snr": float(rnd.choice(list(noise_snrs))),
                "rirs": (
                    {s: rirs[rnd.choice(sorted(rirs))] for s in {u["speaker_id"] for u in timed}}
                    if rirs and rnd.random() < rvb_probability else {}
                ),
            }
            specs.append(spec)
    return specs


def make_meeting_mixtures(
    specs: Sequence[dict],
    out_data_dir: str,
    out_wav_dir: str,
    rate: int = 8000,
) -> str:
    """Render meeting specs (mixaudio_mtg.py semantics): each utterance is
    placed at its offset, per-speaker RIRs applied, sources summed, noise
    added at the spec SNR. Writes wavs + Kaldi dir + rttm."""
    os.makedirs(out_wav_dir, exist_ok=True)
    os.makedirs(out_data_dir, exist_ok=True)
    wav_scp: Dict[str, str] = {}
    segments: List[dict] = []
    utt2spk: Dict[str, str] = {}
    reco2dur: Dict[str, float] = {}
    turns: List[Turn] = []

    for spec in specs:
        recid = spec["recid"]
        end = max(u["offset"] + u["length_in_seconds"] for u in spec["utterances"])
        n = int(np.ceil(end * rate)) + 1
        mixture = np.zeros(n, np.float32)
        rir_cache = {
            s: wavio.load_wav_maybe_piped(p)[0] for s, p in spec.get("rirs", {}).items()
        }
        for k, u in enumerate(spec["utterances"]):
            speech, r = wavio.load_wav_maybe_piped(u["path"])
            assert r == rate, f"sample-rate mismatch: {r} != {rate} for {u['path']}"
            rir = rir_cache.get(u["speaker_id"])
            if rir is not None:
                speech = _reverberate(speech, rir)
            st = int(round(u["offset"] * rate))
            mixture[st : st + len(speech)] += speech[: max(0, n - st)]
            uttid = f"{u['speaker_id']}_{recid}_{k:03d}"
            segments.append(dict(utt=uttid, rec=recid, st=st / rate, et=(st + len(speech)) / rate))
            utt2spk[uttid] = u["speaker_id"]
            turns.append(Turn(recid, st / rate, len(speech) / rate, u["speaker_id"]))
        if spec.get("noise"):
            noise, r = wavio.load_wav_maybe_piped(spec["noise"])
            assert r == rate
            noise = np.pad(noise, (0, max(0, n - len(noise))), "wrap")[:n]
            sig_p = np.sum(mixture ** 2) / n
            noi_p = np.sum(noise ** 2) / n
            scale = np.sqrt(10 ** (-spec["snr"] / 10) * sig_p / max(noi_p, 1e-12))
            mixture = mixture + noise * scale
        peak = np.abs(mixture).max()
        if peak > 0.99:
            mixture = mixture * (0.99 / peak)
        out_path = os.path.join(out_wav_dir, f"{recid}.wav")
        wavio.write_wav(out_path, mixture, rate)
        wav_scp[recid] = os.path.abspath(out_path)
        reco2dur[recid] = n / rate

    kaldi_io.save_data_dir(out_data_dir, wavs=wav_scp, segments=segments, utt2spk=utt2spk, reco2dur=reco2dur)
    write_rttm(os.path.join(out_data_dir, "rttm"), turns)
    return out_data_dir


class SimuDiarMixer:
    """On-the-fly simulated meeting batches (reference SSND
    `simu_diar_dataset.py:18` SimuDiarMixer): each sample draws speakers,
    utterances, overlap/silence statistics and noise, returning the mixture
    plus per-speaker activity labels at `label_rate` — no disk I/O in the
    training loop, fresh mixtures every step.
    """

    def __init__(
        self,
        src_data_dir: str,
        noise_dir: Optional[str] = None,
        duration: float = 8.0,
        rate: int = 16000,
        max_speakers: int = 4,
        min_speakers: int = 1,
        label_rate: int = 25,
        sil_scale: float = 1.0,
        overlap_prob: float = 0.3,
        noise_snrs: Sequence[float] = (10.0, 20.0),
        seed: int = 0,
    ):
        self.kd = kaldi_io.KaldiData(src_data_dir)
        self.noise = kaldi_io.load_scp(os.path.join(noise_dir, "wav.scp")) if noise_dir else {}
        self.duration, self.rate = duration, rate
        self.max_speakers, self.min_speakers = max_speakers, min_speakers
        self.label_rate = label_rate
        self.sil_scale = sil_scale
        self.overlap_prob = overlap_prob
        self.noise_snrs = list(noise_snrs)
        self.rng = np.random.default_rng(seed)
        self.spk2utt = self.kd.spk2utt or {}
        self.speakers = sorted(self.spk2utt)
        self.spk_to_gid = {s: i for i, s in enumerate(self.speakers)}

    def sample(self):
        """→ dict(audio (N,), labels (T, max_speakers), spk_gids (max_speakers,))."""
        n_samples = int(self.duration * self.rate)
        n_frames = int(self.duration * self.label_rate)
        n_spk = int(self.rng.integers(self.min_speakers, self.max_speakers + 1))
        spks = list(self.rng.choice(self.speakers, size=n_spk, replace=False))
        mix = np.zeros(n_samples, np.float32)
        labels = np.zeros((n_frames, self.max_speakers), np.float32)
        gids = np.full((self.max_speakers,), -1, np.int32)
        for si, spk in enumerate(spks):
            gids[si] = self.spk_to_gid[spk]
            pos = float(self.rng.exponential(self.sil_scale))
            while pos < self.duration - 0.5:
                utt = self.spk2utt[spk][int(self.rng.integers(len(self.spk2utt[spk])))]
                audio, r = wavio.load_wav_maybe_piped(self.kd.wavs[utt])
                assert r == self.rate
                start = int(pos * self.rate)
                seg = audio[: n_samples - start]
                mix[start : start + len(seg)] += seg
                f0, f1 = int(pos * self.label_rate), min(
                    int((pos + len(seg) / self.rate) * self.label_rate), n_frames
                )
                labels[f0:f1, si] = 1.0
                dur = len(seg) / self.rate
                if self.rng.random() < self.overlap_prob:
                    pos += dur * float(self.rng.uniform(0.3, 0.9))  # overlapped start
                else:
                    pos += dur + float(self.rng.exponential(self.sil_scale))
        if self.noise:
            key = list(self.noise)[int(self.rng.integers(len(self.noise)))]
            noise, r = wavio.load_wav_maybe_piped(self.noise[key])
            if len(noise) < n_samples:
                noise = np.pad(noise, (0, n_samples - len(noise)), "wrap")
            off = int(self.rng.integers(max(len(noise) - n_samples, 1)))
            noise = noise[off : off + n_samples]
            snr = float(self.rng.choice(self.noise_snrs))
            sp = np.mean(mix**2) + 1e-12
            npow = np.mean(noise**2) + 1e-12
            mix = mix + noise * np.sqrt(10 ** (-snr / 10) * sp / npow)
        peak = np.abs(mix).max()
        if peak > 0.99:
            mix *= 0.99 / peak
        return dict(audio=mix.astype(np.float32), labels=labels, spk_gids=gids)

    def batches(self, batch_size: int):
        """Infinite iterator of stacked batches."""
        while True:
            items = [self.sample() for _ in range(batch_size)]
            yield dict(
                audio=np.stack([i["audio"] for i in items]),
                labels=np.stack([i["labels"] for i in items]),
                spk_gids=np.stack([i["spk_gids"] for i in items]),
            )

    @property
    def n_all_speakers(self) -> int:
        return len(self.speakers)


class RealDiarBlocks:
    """Fixed-length blocks cut from real diarization recordings for SSND
    training (reference `egs/alimeeting/ssnd/alimeeting_diar_dataset.py` —
    the second source of the reference's dual simu+real protocol,
    `train_accelerate_ddp.py:847` train_one_epoch_multi).

    Samples a random window from a meeting wav, reads per-speaker activity
    from the data dir's RTTM, and assigns slot gids via the provided
    speaker→gid map (the SimuDiarMixer's source-pool indexing), so E_all
    rows are shared between the simulated and real sources.
    """

    def __init__(
        self,
        data_dir: str,
        spk_to_gid: Dict[str, int],
        duration: float = 4.0,
        rate: int = 16000,
        max_speakers: int = 4,
        label_rate: int = 25,
        seed: int = 0,
    ):
        from .rttm import read_rttm_by_rec

        self.kd = kaldi_io.KaldiData(data_dir)
        self.turns = read_rttm_by_rec(os.path.join(data_dir, "rttm"))
        self.spk_to_gid = spk_to_gid
        self.duration, self.rate = duration, rate
        self.max_speakers, self.label_rate = max_speakers, label_rate
        self.rng = np.random.default_rng(seed)
        self.recs = sorted(r for r in self.kd.wavs if r in self.turns)
        self._cache: Dict[str, np.ndarray] = {}

    def _audio(self, rec: str) -> np.ndarray:
        if rec not in self._cache:
            a, r = wavio.load_wav_maybe_piped(self.kd.wavs[rec])
            assert r == self.rate, f"{rec}: rate {r} != {self.rate}"
            if a.ndim > 1:
                a = a[:, 0]
            self._cache[rec] = a.astype(np.float32)
        return self._cache[rec]

    def sample(self):
        """→ dict(audio (N,), labels (T, max_speakers), spk_gids (max_speakers,))."""
        n_samples = int(self.duration * self.rate)
        n_frames = int(self.duration * self.label_rate)
        rec = self.recs[int(self.rng.integers(len(self.recs)))]
        audio = self._audio(rec)
        start = float(self.rng.uniform(0.0, max(len(audio) / self.rate - self.duration, 0.0)))
        seg = audio[int(start * self.rate) : int(start * self.rate) + n_samples]
        seg = np.pad(seg, (0, n_samples - len(seg)))

        # per-speaker activity inside the window, most-active first
        acts: Dict[str, np.ndarray] = {}
        for t in self.turns[rec]:
            b, e = t.start - start, t.end - start
            f0 = max(int(b * self.label_rate), 0)
            f1 = min(int(e * self.label_rate), n_frames)
            if f1 <= f0:
                continue
            acts.setdefault(t.speaker, np.zeros(n_frames, np.float32))[f0:f1] = 1.0
        order = sorted(acts, key=lambda s: -float(acts[s].sum()))[: self.max_speakers]
        labels = np.zeros((n_frames, self.max_speakers), np.float32)
        gids = np.full((self.max_speakers,), -1, np.int32)
        for si, spk in enumerate(order):
            labels[:, si] = acts[spk]
            gids[si] = self.spk_to_gid[spk]
        return dict(audio=seg, labels=labels, spk_gids=gids)


def simulate_corpus(
    out_dir: str,
    n_mixtures: int = 8,
    n_speakers: int = 2,
    rate: int = 8000,
    seed: int = 0,
    sil_scale: float = 2.0,
    with_noise: bool = True,
    with_rir: bool = False,
    rir_method: str = "decay",  # decay | image_source (data/room.py)
    src_speakers: int = 8,
    utts_per_speaker: int = 8,
) -> str:
    """One-call hermetic corpus: synth voices → specs → mixtures.

    Returns the mixture Kaldi data dir (with rttm)."""
    src = synthesize_speaker_corpus(
        os.path.join(out_dir, "src"), n_speakers=src_speakers, utts_per_speaker=utts_per_speaker, rate=rate, seed=seed
    )
    noise_dir = synthesize_noise_corpus(os.path.join(out_dir, "noise"), rate=rate, seed=seed + 1) if with_noise else None
    rir_dir = synthesize_rir_corpus(os.path.join(out_dir, "rir"), rate=rate, seed=seed + 2, method=rir_method) if with_rir else None
    specs = random_mixture_specs(
        src,
        noise_dir,
        rir_dir,
        n_mixtures=n_mixtures,
        n_speakers=n_speakers,
        min_utts=4,
        max_utts=8,
        sil_scale=sil_scale,
        noise_snrs=(15.0, 20.0),
        speech_rvb_probability=0.5 if with_rir else 0.0,
        seed=seed + 3,
    )
    return make_mixtures(specs, os.path.join(out_dir, "data"), os.path.join(out_dir, "mix_wav"), rate)
