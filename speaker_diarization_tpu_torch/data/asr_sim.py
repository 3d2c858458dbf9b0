"""Synthetic token-speech: utterances whose transcript is knowable by
construction, so ASR components (DiCoW CTC, conditioned decoding) can be
TRAINED and evaluated hermetically — the ASR analogue of the synthetic
diarization voices in data/simulate.py.

The port's own copy of speaker_diarization_tpu/data/asr_sim.py (NumPy only),
unchanged below this paragraph; tests/test_torch_dicow.py holds the
two copies to the same output.

Each vocabulary token is a fixed, spectrally distinct tone unit (an f0 +
harmonic stack unique to the token); an utterance is a sequence of such
units with short silences. A "speaker" imposes a global f0 shift so
speaker separation stays non-trivial in mixtures.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def token_unit(
    token: int,
    rate: int,
    dur_s: float = 0.22,
    speaker_shift: float = 1.0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """One token's waveform: token-specific f0 ladder + harmonic weights."""
    n = int(dur_s * rate)
    t = np.arange(n) / rate
    f0 = (140.0 + 55.0 * token) * speaker_shift
    sig = np.zeros(n)
    for k, w in ((1, 1.0), (2, 0.5 if token % 2 else 0.15), (3, 0.3 if token % 3 else 0.1)):
        sig += w * np.sin(2 * np.pi * k * f0 * t)
    env = np.minimum(1.0, np.minimum(t / 0.02, (dur_s - t) / 0.02))  # 20 ms ramps
    sig *= np.maximum(env, 0.0)
    if rng is not None:
        sig += 0.01 * rng.standard_normal(n)
    return (0.3 * sig / max(np.abs(sig).max(), 1e-6)).astype(np.float32)


def token_utterance(
    tokens: List[int],
    rate: int,
    gap_s: float = 0.06,
    speaker_shift: float = 1.0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    gap = np.zeros(int(gap_s * rate), np.float32)
    parts = []
    for tok in tokens:
        parts.append(token_unit(tok, rate, speaker_shift=speaker_shift, rng=rng))
        parts.append(gap)
    return np.concatenate(parts[:-1]) if parts else np.zeros(0, np.float32)


def token_batches(
    vocab_size: int,
    rate: int,
    batch_size: int,
    min_len: int = 3,
    max_len: int = 8,
    utt_s: float = 2.5,
    speaker_shift: float = 1.0,
    seed: int = 0,
):
    """Endless (audio (B, N), labels (B, L), label_mask) batches.

    Token ids are 1..vocab_size (0 is the CTC blank); labels padded with 0.
    """
    rng = np.random.default_rng(seed)
    n = int(utt_s * rate)
    L = max_len
    while True:
        audio = np.zeros((batch_size, n), np.float32)
        labels = np.zeros((batch_size, L), np.int32)
        mask = np.zeros((batch_size, L), np.float32)
        for b in range(batch_size):
            k = int(rng.integers(min_len, max_len + 1))
            toks = rng.integers(1, vocab_size + 1, size=k)
            wav = token_utterance(list(toks), rate, speaker_shift=speaker_shift, rng=rng)
            audio[b, : min(len(wav), n)] = wav[:n]
            labels[b, :k] = toks
            mask[b, :k] = 1.0
        yield dict(audio=audio, labels=labels, label_mask=mask)


def two_speaker_token_mixture(
    vocab_size: int,
    rate: int,
    total_s: float,
    seed: int = 0,
) -> Tuple[np.ndarray, list, list, np.ndarray]:
    """A 2-speaker 'meeting': speaker A (shift 1.0) and speaker B (shift
    1.35) alternate non-overlapping utterances. Returns (audio, transcripts
    per speaker, turn list [(spk, start_s, end_s, tokens)], activity
    (T25, 2))."""
    rng = np.random.default_rng(seed)
    n = int(total_s * rate)
    audio = np.zeros(n, np.float32)
    shifts = (1.0, 1.35)
    transcripts: list = [[], []]
    turns = []
    pos = 0.1 * rate
    spk = 0
    while True:
        k = int(rng.integers(2, 5))
        toks = list(rng.integers(1, vocab_size + 1, size=k))
        wav = token_utterance(toks, rate, speaker_shift=shifts[spk], rng=rng)
        if pos + len(wav) >= n:
            break
        audio[int(pos) : int(pos) + len(wav)] += wav
        turns.append((spk, pos / rate, (pos + len(wav)) / rate, toks))
        transcripts[spk].extend(toks)
        pos += len(wav) + rng.uniform(0.05, 0.25) * rate
        spk = 1 - spk
    t25 = int(total_s * 25)
    act = np.zeros((t25, 2), np.float32)
    for s, st, en, _ in turns:
        act[int(st * 25) : int(en * 25), s] = 1.0
    return audio, transcripts, turns, act


def conditioned_batches(
    vocab_size: int,
    rate: int,
    batch_size: int,
    utt_s: float = 3.0,
    seed: int = 0,
):
    """Endless DiCoW-style conditioned batches: each sample is a 2-speaker
    audio (A speaks, then B, no overlap), the STNO mask selects ONE target
    speaker, and the labels are that speaker's tokens only. Yields
    audio (B, N), stno (B, 4, T50), labels (B, L), label_mask."""
    rng = np.random.default_rng(seed)
    n = int(utt_s * rate)
    t50 = n // 160 // 2  # whisper frame rate after conv stride 2
    L = 5
    shifts = (1.0, 1.35)
    while True:
        audio = np.zeros((batch_size, n), np.float32)
        stno = np.zeros((batch_size, 4, t50), np.float32)
        labels = np.zeros((batch_size, L), np.int32)
        mask = np.zeros((batch_size, L), np.float32)
        for b in range(batch_size):
            toks = [list(rng.integers(1, vocab_size + 1, size=int(rng.integers(2, 5)))) for _ in range(2)]
            wavs = [
                token_utterance(toks[s], rate, speaker_shift=shifts[s], rng=rng)
                for s in range(2)
            ]
            starts = [int(0.05 * rate)]
            starts.append(starts[0] + len(wavs[0]) + int(rng.uniform(0.05, 0.2) * rate))
            act = np.zeros((2, t50), np.float32)
            for s in range(2):
                en = min(starts[s] + len(wavs[s]), n)
                audio[b, starts[s] : en] += wavs[s][: en - starts[s]]
                f0, f1 = starts[s] * t50 // n, en * t50 // n
                act[s, f0:f1] = 1.0
            target = int(rng.integers(0, 2))
            tgt, oth = act[target], act[1 - target]
            stno[b, 0] = (1 - tgt) * (1 - oth)  # silence
            stno[b, 1] = tgt * (1 - oth)  # target alone
            stno[b, 2] = oth * (1 - tgt)  # non-target
            stno[b, 3] = tgt * oth  # overlap
            k = len(toks[target])
            labels[b, :k] = toks[target]
            mask[b, :k] = 1.0
        yield dict(audio=audio, stno=stno, labels=labels, label_mask=mask)
