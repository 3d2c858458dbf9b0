"""Utterance dataset for speaker-embedding pretraining.

A copy of speaker_diarization_tpu/data/spk_dataset.py.

Reads a Kaldi dir (wav.scp + utt2spk, optional segments); yields
fixed-duration audio crops with integer speaker labels. Train: random crop
(wrap-pad short utterances); eval: center crop. This feeds
models/spk_embed.SpeakerClassifier — the standalone replacement for the
reference's externally-trained modelscope/wespeaker encoders.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from . import kaldi_io
from .wav import load_wav_maybe_piped


class SpeakerUttDataset:
    def __init__(
        self,
        data_dir: str,
        dur: float = 2.0,
        rate: int = 16000,
        is_train: bool = True,
        seed: int = 0,
        min_dur: float = 0.5,
        noise_dir: Optional[str] = None,
        aug_prob: float = 0.6,
        noise_snrs: Tuple[float, float] = (5.0, 20.0),
    ):
        self.kd = kaldi_io.KaldiData(data_dir)
        self.rate = rate
        self.samples = int(dur * rate)
        self.is_train = is_train
        # per-item RNG from (seed, epoch, idx): deterministic under the
        # parallel fetcher (data/parallel_fetch.py) in any thread order
        self.seed = seed
        self._epoch = 0
        self.aug_prob = aug_prob
        self.noise_snrs = noise_snrs
        # additive-noise augmentation: without it, embeddings of targets cut
        # from noisy mixtures collapse toward the noise direction (the
        # encoder must see the deployment noise conditions)
        self._noises: List[np.ndarray] = []
        if noise_dir and is_train:
            nkd = kaldi_io.KaldiData(noise_dir)
            for recid in sorted(nkd.wavs):
                a, r = load_wav_maybe_piped(nkd.wavs[recid])
                if a.ndim > 1:
                    a = a[:, 0]
                self._noises.append(a.astype(np.float32))
        if not self.kd.utt2spk:
            raise ValueError(f"{data_dir} has no utt2spk — required for speaker training")
        # (utt, rec, start_s, end_s) from segments, else whole recordings
        self.utts: List[Tuple[str, str, Optional[float], Optional[float]]] = []
        if self.kd.segments:
            for rec, segs in sorted(self.kd.segments.items()):
                for seg in segs:
                    if seg["et"] - seg["st"] >= min_dur and seg["utt"] in self.kd.utt2spk:
                        self.utts.append((seg["utt"], rec, seg["st"], seg["et"]))
        else:
            for utt in sorted(self.kd.utt2spk):
                if utt in self.kd.wavs:
                    self.utts.append((utt, utt, None, None))
        self.speakers = sorted({self.kd.utt2spk[u] for u, _, _, _ in self.utts})
        self.spk_index: Dict[str, int] = {s: i for i, s in enumerate(self.speakers)}
        self._cache: Dict[str, Tuple[np.ndarray, int]] = {}

    @property
    def n_speakers(self) -> int:
        return len(self.speakers)

    def __len__(self):
        return len(self.utts)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _load(self, rec: str) -> np.ndarray:
        if rec not in self._cache:
            audio, rate = load_wav_maybe_piped(self.kd.wavs[rec])
            if audio.ndim > 1:
                audio = audio[:, 0]
            assert rate == self.rate, (rate, self.rate)
            if len(self._cache) > 64:
                self._cache.clear()
            self._cache[rec] = audio.astype(np.float32)
        return self._cache[rec]

    def __getitem__(self, idx: int):
        utt, rec, st, et = self.utts[idx]
        rng = random.Random((self.seed * 1_000_003 + self._epoch) * 1_000_003 + idx)
        audio = self._load(rec)
        if st is not None:
            audio = audio[int(st * self.rate): int(et * self.rate)]
        n = self.samples
        if len(audio) < n:
            audio = np.tile(audio, n // max(len(audio), 1) + 1)
        if self.is_train:
            off = rng.randint(0, len(audio) - n)
        else:
            off = (len(audio) - n) // 2
        crop = audio[off: off + n]
        if self._noises and rng.random() < self.aug_prob:
            crop = self._add_noise(rng, crop)
        return dict(
            audio=crop,
            label=np.int32(self.spk_index[self.kd.utt2spk[utt]]),
        )

    def _add_noise(self, rng: random.Random, audio: np.ndarray) -> np.ndarray:
        noise = self._noises[rng.randrange(len(self._noises))]
        n = len(audio)
        if len(noise) < n:
            noise = np.tile(noise, n // max(len(noise), 1) + 1)
        off = rng.randint(0, len(noise) - n)
        noise = noise[off: off + n]
        snr = rng.uniform(*self.noise_snrs)
        ap = np.mean(audio ** 2) + 1e-12
        np_ = np.mean(noise ** 2) + 1e-12
        scale = np.sqrt(ap / (np_ * 10.0 ** (snr / 10.0)))
        return (audio + scale * noise).astype(np.float32)


def spk_batch_iterator(
    ds: SpeakerUttDataset, batch_size: int, shuffle: bool = True, seed: int = 0, epoch: int = 0
) -> Iterator[dict]:
    from .parallel_fetch import fetch_items

    if hasattr(ds, "set_epoch"):
        ds.set_epoch(epoch)
    order = list(range(len(ds)))
    if shuffle:
        random.Random(seed * 10007 + epoch).shuffle(order)
    for i in range(0, len(order) - batch_size + 1, batch_size):
        items = fetch_items(ds, order[i: i + batch_size])
        yield dict(
            audio=np.stack([it["audio"] for it in items]),
            label=np.stack([it["label"] for it in items]),
        )
