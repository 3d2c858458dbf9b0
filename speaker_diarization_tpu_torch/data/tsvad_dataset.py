"""TS-VAD chunked dataset: mixture windows + target embeddings + 25 Hz labels.

Counterpart of speaker_diarization_tpu/data/tsvad_dataset.py (reference
`egs/alimeeting/ts_vad2/ts_vad_dataset.py:118-814`), NumPy only:
- windows of rs_len seconds (label chunk = rs_len·25 frames) with
  segment_shift over each meeting;
- per window, the meeting's speakers fill the first channels (sorted at
  eval, shuffled at train); remaining channels are "silence" speakers: zero
  embedding, or at train with probability 1 − zero_ratio a random distractor
  speaker's embedding (labels all-zero either way);
- target embedding per speaker: a random row of its embedding matrix at
  train, the mean row at eval;
- at train, with probability aug_prob: reverb by a random RIR of `rir_dir`
  (half the time) and additive noise from `noise_dir` at 5-20 dB SNR;
- labels come from the corpus RTTM at 25 Hz;
- with `target_audio_dir` (prepare-targets' target_audio/<rec>/<spk>.wav
  tree), items also carry `enroll_audio` (S, enroll_len_s·rate): each
  speaker's enrollment waveform for TS-VAD3. `emb_store` may then be None
  (zero target embeddings);
- speech enhancement (reference ts_vad_dataset.py:423-492, data/enhance.py):
  with `enhanced_audio_dir` (a Kaldi dir of pre-enhanced recordings keyed
  by rec id) a chunk is read from the enhanced copy, always at eval and
  with probability `enhance_prob` at train; then, after augmentation, the
  online `enhancer` ('spectral_gate', 'neural:<npz>' or a callable `(audio,
  rate) -> audio`) is applied, always at eval and with probability
  `enhance_prob` at train.

Each item's randomness is a `random.Random` seeded from (seed, epoch,
index), drawn in the JAX package's order, so one seed gives the JAX
package's items and batches exactly. `is_train` defaults to False here
(True in the JAX class).
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from . import kaldi_io
from .rttm import frames_from_turns, read_rttm_by_rec
from .wav import load_wav_maybe_piped


@dataclass(frozen=True)
class TSVADChunk:
    rec: str
    start_frame: int  # label-rate frames
    end_frame: int


class TSVADChunkDataset:
    def __init__(
        self,
        data_dir: str,
        emb_store,
        rs_len: float = 4.0,
        segment_shift: float = 2.0,
        max_speakers: int = 4,
        rate: int = 16000,
        label_rate: int = 25,
        is_train: bool = False,
        rttm_path: Optional[str] = None,
        zero_ratio: float = 0.5,
        noise_dir: Optional[str] = None,
        rir_dir: Optional[str] = None,
        aug_prob: float = 0.5,
        seed: int = 0,
        enhancer=None,
        enhance_prob: float = 0.0,
        enhanced_audio_dir: Optional[str] = None,
        target_audio_dir: Optional[str] = None,
        enroll_len_s: float = 3.0,
    ):
        self.kd = kaldi_io.KaldiData(data_dir)
        self.embs = emb_store
        self.rate = rate
        self.label_rate = label_rate
        self.max_speakers = max_speakers
        self.is_train = is_train
        self.zero_ratio = zero_ratio
        self.aug_prob = aug_prob
        self.seed = seed
        self._epoch = 0
        self._noises = kaldi_io.load_scp(os.path.join(noise_dir, "wav.scp")) if noise_dir else None
        self._rirs = kaldi_io.load_scp(os.path.join(rir_dir, "wav.scp")) if rir_dir else None
        self.target_audio_dir = target_audio_dir
        self.enroll_samples = int(enroll_len_s * rate)
        if enhancer is not None:
            from .enhance import get_enhancer

            enhancer = get_enhancer(enhancer)
        self.enhancer = enhancer
        self.enhance_prob = enhance_prob
        self._enhanced_wavs = kaldi_io.load_scp(os.path.join(enhanced_audio_dir, "wav.scp")) if enhanced_audio_dir else None

        rttm_path = rttm_path or os.path.join(data_dir, "rttm")
        self.turns = read_rttm_by_rec(rttm_path)
        self.rec_speakers: Dict[str, List[str]] = {
            rec: sorted({t.speaker for t in ts}) for rec, ts in self.turns.items()
        }
        self.all_speakers = sorted({s for ss in self.rec_speakers.values() for s in ss})  # distractor pool

        self.chunk_frames = int(rs_len * label_rate)
        shift = int(segment_shift * label_rate)
        self.chunks: List[TSVADChunk] = []
        for rec in sorted(self.kd.wavs):
            if rec not in self.turns:
                continue
            n_frames = self.n_frames(rec)
            for st in range(0, max(n_frames - self.chunk_frames, 0) + 1, shift):
                self.chunks.append(TSVADChunk(rec, st, st + self.chunk_frames))

    def n_frames(self, rec: str) -> int:
        """Label-rate frames of a recording (reco2dur, else the wav header)."""
        if self.kd.reco2dur and rec in self.kd.reco2dur:
            return int(self.kd.reco2dur[rec] * self.label_rate)
        from .wav import wav_info

        return int(wav_info(self.kd.wavs[rec])["frames"] / self.rate * self.label_rate)

    def __len__(self):
        return len(self.chunks)

    def set_epoch(self, epoch: int) -> None:
        """Reseed sampling and augmentation per epoch: the same (seed,
        epoch, index) gives the same item in any fetch order."""
        self._epoch = int(epoch)

    def _item_rng(self, idx: int) -> random.Random:
        return random.Random((self.seed * 1_000_003 + self._epoch) * 1_000_003 + idx)

    @property
    def chunk_samples(self) -> int:
        return int(self.chunk_frames / self.label_rate * self.rate)

    # ------------------------------------------------------------------
    def _target_embedding(self, rng: random.Random, rec: str, spk: str) -> np.ndarray:
        if self.embs is None:  # TS-VAD3 from enrollment waveforms alone
            return np.zeros((192,), np.float32)
        m = self.embs.get(rec, spk) if self.embs.has(rec, spk) else None
        if m is None or len(m) == 0:
            # fall back to any recording of this speaker with usable windows
            for r, spks in self.embs.speakers().items():
                if spk in spks and len(self.embs.get(r, spk)):
                    m = self.embs.get(r, spk)
                    break
        if m is None or len(m) == 0:
            return np.zeros((self.embs.dim,), np.float32)
        if self.is_train:
            return m[rng.randrange(len(m))]
        return m.mean(axis=0)

    def _distractor_embedding(self, rng: random.Random, exclude: List[str]) -> Optional[np.ndarray]:
        if self.embs is None:
            return None
        pool = [s for s in self.all_speakers if s not in exclude]
        if not pool:
            return None
        spk = rng.choice(pool)
        for r, spks in self.embs.speakers().items():
            if spk in spks:
                m = self.embs.get(r, spk)
                if len(m):
                    return m[rng.randrange(len(m))] if self.is_train else m.mean(axis=0)
        return None

    def _augment(self, rng: random.Random, audio: np.ndarray) -> np.ndarray:
        if not self.is_train or rng.random() > self.aug_prob:
            return audio
        if self._rirs and rng.random() < 0.5:
            from scipy.signal import fftconvolve

            rir, _ = load_wav_maybe_piped(rng.choice(list(self._rirs.values())))
            wet = fftconvolve(audio, rir)[: len(audio)]
            p = np.sqrt((np.sum(audio**2) + 1e-12) / (np.sum(wet**2) + 1e-12))
            audio = (wet * p).astype(np.float32)
        if self._noises:
            noise, _ = load_wav_maybe_piped(rng.choice(list(self._noises.values())))
            if len(noise) < len(audio):
                noise = np.pad(noise, (0, len(audio) - len(noise)), "wrap")
            else:
                off = rng.randrange(max(len(noise) - len(audio), 1))
                noise = noise[off : off + len(audio)]
            snr = rng.uniform(5.0, 20.0)
            sp = np.mean(audio**2) + 1e-12
            npow = np.mean(noise**2) + 1e-12
            audio = audio + noise * np.sqrt(10 ** (-snr / 10) * sp / npow)
        return audio.astype(np.float32)

    # ------------------------------------------------------------------
    def __getitem__(self, idx: int) -> dict:
        ch = self.chunks[idx]
        rng = self._item_rng(idx)
        lr = self.label_rate
        start_sample = int(ch.start_frame / lr * self.rate)
        want = self.chunk_samples
        # offline substitution: always at eval, with enhance_prob at train
        use_enhanced = (
            self._enhanced_wavs is not None
            and ch.rec in self._enhanced_wavs
            and (not self.is_train or rng.random() < self.enhance_prob)
        )
        if use_enhanced:
            audio, rate = load_wav_maybe_piped(self._enhanced_wavs[ch.rec], start_sample, start_sample + want)
        else:
            audio, rate = self.kd.load_wav(ch.rec, start_sample, start_sample + want)
        if rate != self.rate:
            raise ValueError(f"{ch.rec}: sample rate {rate} != dataset rate {self.rate}")
        if audio.ndim > 1:
            audio = audio[:, 0]
        if len(audio) < want:
            audio = np.pad(audio, (0, want - len(audio)))
        audio = self._augment(rng, audio)
        if self.enhancer is not None and (not self.is_train or rng.random() < self.enhance_prob):
            audio = self.enhancer(audio, self.rate)

        T = self.chunk_frames
        speakers = list(self.rec_speakers[ch.rec])
        if self.is_train:
            rng.shuffle(speakers)
        speakers = speakers[: self.max_speakers]
        offset_s = ch.start_frame / lr
        act = frames_from_turns(self.turns[ch.rec], speakers, 1.0 / lr, T, offset_s)

        S = self.max_speakers
        labels = np.zeros((T, S), np.float32)
        labels[:, : len(speakers)] = act
        embs = np.zeros((S, self.embs.dim if self.embs is not None else 192), np.float32)
        for i in range(S):
            if i < len(speakers):
                embs[i] = self._target_embedding(rng, ch.rec, speakers[i])
            elif self.is_train and rng.random() > self.zero_ratio:
                d = self._distractor_embedding(rng, speakers)
                if d is not None:
                    embs[i] = d
        item = dict(
            audio=audio.astype(np.float32),
            target_embs=embs,
            labels=labels,
            rec=ch.rec,
            start_frame=ch.start_frame,
            speakers=speakers,
        )
        if self.target_audio_dir is not None:  # drawn after every other draw of the item, as in JAX
            item["enroll_audio"] = self._enroll_audio(rng, ch.rec, speakers)
        return item

    def _enroll_audio(self, rng: random.Random, rec: str, speakers: List[str]) -> np.ndarray:
        """(max_speakers, enroll_len_s·rate) enrollment crops from
        prepare-targets' overlap-free target wavs (a random crop at train,
        the start at eval), zero-padded; zeros for absent speaker slots."""
        out = np.zeros((self.max_speakers, self.enroll_samples), np.float32)
        for i, spk in enumerate(speakers[: self.max_speakers]):
            path = os.path.join(self.target_audio_dir, rec, f"{spk}.wav")
            if not os.path.exists(path):
                continue
            wav, rate = load_wav_maybe_piped(path)
            if rate != self.rate:
                raise ValueError(f"{path}: sample rate {rate} != dataset rate {self.rate}")
            if wav.ndim > 1:
                wav = wav[:, 0]
            if len(wav) > self.enroll_samples:
                st = rng.randrange(len(wav) - self.enroll_samples) if self.is_train else 0
                wav = wav[st : st + self.enroll_samples]
            out[i, : len(wav)] = wav
        return out


def tsvad_batch_iterator(
    dataset: TSVADChunkDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    epoch: int = 0,
) -> Iterator[dict]:
    """Batches of stacked numpy items {audio, target_embs, labels[,
    enroll_audio]} in the
    JAX package's order (a numpy shuffle seeded with seed + epoch). A
    ConcatChunkDataset of several corpora has no set_epoch: its members keep
    epoch 0's augmentation draws, as in the JAX package."""
    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(epoch)
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    n = len(order)
    stop = n - (n % batch_size) if drop_last else n
    for i in range(0, stop, batch_size):
        items = [dataset[int(j)] for j in order[i : i + batch_size]]
        batch = dict(
            audio=np.stack([it["audio"] for it in items]),
            target_embs=np.stack([it["target_embs"] for it in items]),
            labels=np.stack([it["labels"] for it in items]),
        )
        if "enroll_audio" in items[0]:
            batch["enroll_audio"] = np.stack([it["enroll_audio"] for it in items])
        yield batch
