"""TS-VAD chunked dataset: mixture windows + target embeddings + 25 Hz labels.

Counterpart of speaker_diarization_tpu/data/tsvad_dataset.py (reference
`egs/alimeeting/ts_vad2/ts_vad_dataset.py:118-814`), NumPy only:
- windows of rs_len seconds (label chunk = rs_len·25 frames) with
  segment_shift over each meeting;
- per window, the meeting's speakers fill the first channels in sorted
  order; remaining channels are "silence" speakers with zero embeddings and
  all-zero labels;
- target embedding per speaker: the mean row of its embedding matrix;
- labels come from the corpus RTTM at 25 Hz.

Only the eval path (is_train=False) is ported; it gives the same items as
the JAX package's. The training path (speaker shuffling, random embedding
rows, distractor speakers, noise/RIR augmentation, the speech enhancer and
the batch iterator) belongs to the training slice (ROADMAP item 6).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from . import kaldi_io
from .rttm import frames_from_turns, read_rttm_by_rec


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
    ):
        if is_train:
            raise NotImplementedError("the TS-VAD training data path is not ported yet (ROADMAP item 6)")
        self.kd = kaldi_io.KaldiData(data_dir)
        self.embs = emb_store
        self.rate = rate
        self.label_rate = label_rate
        self.max_speakers = max_speakers

        rttm_path = rttm_path or os.path.join(data_dir, "rttm")
        self.turns = read_rttm_by_rec(rttm_path)
        self.rec_speakers: Dict[str, List[str]] = {
            rec: sorted({t.speaker for t in ts}) for rec, ts in self.turns.items()
        }

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

    @property
    def chunk_samples(self) -> int:
        return int(self.chunk_frames / self.label_rate * self.rate)

    # ------------------------------------------------------------------
    def _target_embedding(self, rec: str, spk: str) -> np.ndarray:
        m = self.embs.get(rec, spk) if self.embs.has(rec, spk) else None
        if m is None or len(m) == 0:
            # fall back to any recording of this speaker with usable windows
            for r, spks in self.embs.speakers().items():
                if spk in spks and len(self.embs.get(r, spk)):
                    m = self.embs.get(r, spk)
                    break
        if m is None or len(m) == 0:
            return np.zeros((self.embs.dim,), np.float32)
        return m.mean(axis=0)

    # ------------------------------------------------------------------
    def __getitem__(self, idx: int) -> dict:
        ch = self.chunks[idx]
        lr = self.label_rate
        start_sample = int(ch.start_frame / lr * self.rate)
        want = self.chunk_samples
        audio, rate = self.kd.load_wav(ch.rec, start_sample, start_sample + want)
        if rate != self.rate:
            raise ValueError(f"{ch.rec}: sample rate {rate} != dataset rate {self.rate}")
        if audio.ndim > 1:
            audio = audio[:, 0]
        if len(audio) < want:
            audio = np.pad(audio, (0, want - len(audio)))

        T = self.chunk_frames
        speakers = list(self.rec_speakers[ch.rec])[: self.max_speakers]
        offset_s = ch.start_frame / lr
        act = frames_from_turns(self.turns[ch.rec], speakers, 1.0 / lr, T, offset_s)

        S = self.max_speakers
        labels = np.zeros((T, S), np.float32)
        labels[:, : len(speakers)] = act
        embs = np.zeros((S, self.embs.dim), np.float32)
        for i, spk in enumerate(speakers):
            embs[i] = self._target_embedding(ch.rec, spk)
        return dict(
            audio=audio.astype(np.float32),
            target_embs=embs,
            labels=labels,
            rec=ch.rec,
            start_frame=ch.start_frame,
            speakers=speakers,
        )
