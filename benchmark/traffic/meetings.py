"""The one traffic generator: seeded meetings, cut into fixed windows.

A traffic file (`<name>.json` beside this one) holds only parameters:

- `loop`: the loop that drives the cell, `infer` (forwards) or `train`
  (train steps);
- `batch`, `window_s`, `shift_s`: windows per batch, their length and the
  hop between window starts inside a meeting (a hop of the window's length
  cuts disjoint chunks);
- `ring`: distinct batches made ahead and cycled through;
- `meeting_s`, `speakers` [lo, hi], `turn_s` [lo, hi], `gap_s` [lo, hi]:
  meeting length, speakers per meeting and the turn-taking (a negative gap
  starts the next turn inside the previous one: overlap);
- `f0_hz` [lo, hi], `level`, `noise`: the synthetic voices (a pitch with
  five harmonics, vibrato and a syllable-rate envelope, gated by the turns)
  and the noise floor;
- `trainer`: the optimiser settings of a `train` loop.

Every seed gives the same sizes: the same number of meetings and windows,
each of the same length. Only turns, voices, embeddings and noise move.
Turns, labels and embeddings are drawn on the host (small); the waveforms
on the device, from a generator seeded by the run's seed.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from ..weights import stream


def windows_per_meeting(t: dict) -> int:
    return int(math.floor((t["meeting_s"] - t["window_s"]) / t["shift_s"] + 1e-9)) + 1


def _turns(rng, n_spk: int, n_frames: int, rate: int, t: dict) -> np.ndarray:
    """(n_spk, n_frames) 0/1 activity of one meeting."""
    act = np.zeros((n_spk, n_frames), np.float32)
    at, prev = rng.uniform(0.0, 1.0), -1
    while at * rate < n_frames:
        spk = int(rng.integers(n_spk - 1))
        spk = spk + 1 if spk >= prev >= 0 else spk  # never the previous speaker
        dur = rng.uniform(*t["turn_s"])
        act[spk, int(at * rate): int((at + dur) * rate)] = 1.0
        at, prev = max(at + dur + rng.uniform(*t["gap_s"]), at + 0.2), spk
    return act


def _voice(t_s: torch.Tensor, rng, f0_range) -> torch.Tensor:
    """One speaker's voiced signal over the times `t_s` (seconds)."""
    f0 = rng.uniform(*f0_range)
    vib, vib_hz = rng.uniform(0.01, 0.03), rng.uniform(4.0, 6.0)
    phase = 2 * math.pi * f0 * (t_s - vib * torch.cos(2 * math.pi * vib_hz * t_s) / (2 * math.pi * vib_hz))
    amps, offs = rng.uniform(0.2, 1.0, 5) / np.arange(1, 6), rng.uniform(0, 2 * math.pi, 5)
    v = sum(float(a) * torch.sin(h * phase + float(o)) for h, (a, o) in enumerate(zip(amps, offs), start=1))
    syl = 0.6 + 0.4 * torch.sin(2 * math.pi * rng.uniform(3.0, 5.0) * t_s + rng.uniform(0, 2 * math.pi))
    return v * syl


def make(traffic: dict, model: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """`traffic["ring"]` batches {audio (B, N), target_embs (B, S, E), labels
    (B, T, S)} on `device`; `model` gives sample_rate, label_rate,
    max_num_speaker and speaker_embed_dim."""
    sr, rate = model["sample_rate"], model["label_rate"]
    S, E = model["max_num_speaker"], model["speaker_embed_dim"]
    t = traffic
    B, wpm = t["batch"], windows_per_meeting(t)
    per_batch = -(-B // wpm)
    n = int(round(t["meeting_s"] * sr))
    n_frames = int(round(t["meeting_s"] * rate))
    win, hop = int(round(t["window_s"] * sr)), int(round(t["shift_s"] * sr))
    fwin, fhop = int(round(t["window_s"] * rate)), int(round(t["shift_s"] * rate))
    rng = np.random.default_rng([seed, 2])
    g = torch.Generator(device=device).manual_seed(stream(seed, 3))
    t_s = torch.arange(n, device=device, dtype=torch.float32) / sr
    up = sr // rate
    out = []
    for _ in range(t["ring"]):
        audios, embs, labels = [], [], []
        for _ in range(per_batch):
            n_spk = int(rng.integers(t["speakers"][0], t["speakers"][1] + 1))
            act = _turns(rng, n_spk, n_frames, rate, t)
            slots = rng.permutation(S)[:n_spk]
            lab = np.zeros((S, n_frames), np.float32)
            lab[slots] = act
            emb = np.zeros((S, E), np.float32)
            emb[slots] = rng.standard_normal((n_spk, E))
            audio = t["noise"] * torch.randn(n, generator=g, device=device)
            gate = torch.from_numpy(act).to(device).repeat_interleave(up, dim=1)[:, :n]
            gate = torch.nn.functional.pad(gate, (0, n - gate.shape[1]))
            for k in range(n_spk):
                audio = audio + t["level"] * gate[k] * _voice(t_s, rng, t["f0_hz"])
            audios.append(audio.unfold(0, win, hop)[:wpm])
            labels.append(torch.from_numpy(lab.T.copy()).unfold(0, fwin, fhop)[:wpm].transpose(1, 2))
            embs.append(torch.from_numpy(emb)[None].expand(wpm, S, E))
        out.append(dict(audio=torch.cat(audios)[:B].contiguous(),
                        target_embs=torch.cat(embs)[:B].contiguous().to(device),
                        labels=torch.cat(labels)[:B].contiguous().to(device)))
    return out
