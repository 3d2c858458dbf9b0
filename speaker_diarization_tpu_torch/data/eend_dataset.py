"""Chunked diarization dataset for the EEND family.

A copy of speaker_diarization_tpu/data/eend_dataset.py (NumPy only); it
takes `FrontendConfig` from this package's models/eend.py.

Reference semantics: `eend_eda/diarization_dataset.py:37-129` — recordings
are windowed into fixed-length chunks in the *subsampled* frame domain; each
item is (features, frame labels). TPU-first difference: items carry the raw
audio chunk (static sample count) and labels; the log-mel front-end runs on
device inside the model, so host workers only slice wavs and build labels.

Static shapes throughout: every chunk has exactly `chunk_frames` subsampled
frames and `n_speakers` label channels (+ per-chunk speaker mask), so one
XLA compilation serves the whole epoch.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..models.eend import FrontendConfig
from . import kaldi_io


@dataclass(frozen=True)
class ChunkIndexEntry:
    rec: str
    start_sub: int  # chunk start, subsampled-frame domain
    end_sub: int


class EendChunkDataset:
    """Chunk sampler over a Kaldi data dir with frame-aligned labels."""

    def __init__(
        self,
        data_dir: str,
        chunk_frames: int = 500,
        frontend: FrontendConfig = FrontendConfig(),
        n_speakers: int = 2,
        rate: Optional[int] = None,
        use_last_partial: bool = False,
    ):
        self.kd = kaldi_io.KaldiData(data_dir)
        self.fe = frontend
        self.chunk_frames = chunk_frames
        self.n_speakers = n_speakers
        self.rate = rate or frontend.sample_rate
        ss, shift = frontend.subsampling, frontend.frame_shift

        # per-rec speaker lists in the reference's ordering (sorted unique)
        self.rec_speakers: Dict[str, List[str]] = {}
        for rec, segs in self.kd.segments.items():
            self.rec_speakers[rec] = sorted({self.kd.utt2spk[s["utt"]] for s in segs})
        # global speaker ids (EEND-VC speaker-table targets)
        self.all_speakers: List[str] = sorted({s for ss in self.rec_speakers.values() for s in ss})
        self.spk_to_gid = {s: i for i, s in enumerate(self.all_speakers)}

        self.chunks: List[ChunkIndexEntry] = []
        for rec in sorted(self.kd.wavs):
            if rec not in self.kd.segments:
                continue
            if self.kd.reco2dur and rec in self.kd.reco2dur:
                n_samples = int(self.kd.reco2dur[rec] * self.rate)
            else:
                from .wav import wav_info

                n_samples = wav_info(self.kd.wavs[rec])["frames"]
            data_len = n_samples // shift // ss  # full chunks available
            for st in range(0, data_len - chunk_frames + 1, chunk_frames):
                self.chunks.append(ChunkIndexEntry(rec, st, st + chunk_frames))
            rem = data_len % chunk_frames
            if use_last_partial and rem > 0:
                self.chunks.append(ChunkIndexEntry(rec, data_len - rem, data_len))

        # Data-coverage guard: a recording shorter than one chunk yields NO
        # chunks when use_last_partial=False. With chunk_frames larger than
        # the typical recording this silently discards most of the corpus
        # (round-5 diagnosis: chunk_frames=500 vs ~426-subsampled-frame
        # meetings kept 253 of 1200 recordings and the model overfit).
        n_recs = sum(1 for r in self.kd.wavs if r in self.kd.segments)
        covered = len({c.rec for c in self.chunks})
        if covered < n_recs:
            import logging

            logging.getLogger(__name__).warning(
                "EendChunkDataset: only %d of %d recordings produce chunks "
                "(chunk_frames=%d subsampled frames > the rest); consider a "
                "smaller chunk_frames or use_last_partial=True",
                covered, n_recs, chunk_frames,
            )

    def __len__(self) -> int:
        return len(self.chunks)

    @property
    def chunk_samples(self) -> int:
        return self.fe.chunk_samples(self.chunk_frames)

    def labels_for_window(self, rec: str, start_raw: int, end_raw: int) -> Tuple[np.ndarray, np.ndarray]:
        """Frame labels for raw-frame window [start_raw, end_raw).

        Returns (labels (T_raw, n_speakers), spk_mask (n_speakers,)); speakers
        active in the chunk are packed into the lowest channels in rec-level
        sorted order (reference get_labeledSTFT + chunk speaker selection).
        """
        shift, rate = self.fe.frame_shift, self.rate
        speakers = self.rec_speakers[rec]
        T = end_raw - start_raw
        full = np.zeros((T, len(speakers)), dtype=np.float32)
        for seg in self.kd.segments[rec]:
            si = speakers.index(self.kd.utt2spk[seg["utt"]])
            sf = int(np.rint(seg["st"] * rate / shift))
            ef = int(np.rint(seg["et"] * rate / shift))
            lo, hi = max(sf, start_raw), min(ef, end_raw)
            if hi > lo:
                full[lo - start_raw : hi - start_raw, si] = 1.0
        active = np.where(full.any(axis=0))[0]
        C = self.n_speakers
        labels = np.zeros((T, C), dtype=np.float32)
        spk_mask = np.zeros((C,), dtype=np.float32)
        spk_ids = np.full((C,), -1, dtype=np.int32)
        for out_c, src_c in enumerate(active[:C]):
            labels[:, out_c] = full[:, src_c]
            spk_mask[out_c] = 1.0
            spk_ids[out_c] = self.spk_to_gid[speakers[src_c]]
        return labels, spk_mask, spk_ids

    def __getitem__(self, idx: int) -> dict:
        e = self.chunks[idx]
        ss, shift = self.fe.subsampling, self.fe.frame_shift
        start_raw, end_raw = e.start_sub * ss, e.end_sub * ss
        audio, rate = self.kd.load_wav(e.rec, start_raw * shift, end_raw * shift)
        assert rate == self.rate
        want = (end_raw - start_raw) * shift
        if len(audio) < want:  # pad tail of recording
            audio = np.pad(audio, (0, want - len(audio)))
        labels_raw, spk_mask, spk_ids = self.labels_for_window(e.rec, start_raw, end_raw)
        labels = labels_raw[::ss]
        T = e.end_sub - e.start_sub
        frame_mask = np.ones((T,), dtype=np.float32)
        return dict(
            audio=audio.astype(np.float32),
            labels=labels,
            frame_mask=frame_mask,
            spk_mask=spk_mask,
            spk_ids=spk_ids,
            rec=e.rec,
            start_sub=e.start_sub,
        )


class ConcatChunkDataset:
    """Concatenation of chunk datasets for joint multi-corpus training
    (the reference's egs/multi_datasets recipes train one TS-VAD over
    AliMeeting + RAMC + ... jointly).

    Works with any dataset exposing `chunks`/`__len__`/`__getitem__`
    (EendChunkDataset, TSVADChunkDataset). When the members carry global
    speaker tables (`all_speakers`/`spk_ids`, the EEND-VC case), per-member
    ids are remapped into one merged table."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("no datasets")
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])
        self.chunks = [c for d in self.datasets for c in d.chunks]
        if all(hasattr(d, "all_speakers") for d in self.datasets):
            self.all_speakers = sorted({s for d in self.datasets for s in d.all_speakers})
            gid = {s: i for i, s in enumerate(self.all_speakers)}
            self._remap = [
                np.array([gid[s] for s in d.all_speakers], np.int32) for d in self.datasets
            ]
        else:
            self._remap = None

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx: int) -> dict:
        k = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        item = self.datasets[k][idx - int(self._offsets[k])]
        if self._remap is not None and "spk_ids" in item:
            item = dict(item)
            ids = item["spk_ids"]
            item["spk_ids"] = np.where(ids >= 0, self._remap[k][np.maximum(ids, 0)], ids)
        return item


def batch_iterator(
    dataset: EendChunkDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    epoch: int = 0,
) -> Iterator[dict]:
    """Minibatch iterator yielding stacked numpy dicts with static shapes."""
    from .parallel_fetch import fetch_items

    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(epoch)
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    n = len(order)
    stop = n - (n % batch_size) if drop_last else n
    for i in range(0, stop, batch_size):
        idxs = order[i : i + batch_size]
        items = fetch_items(dataset, idxs)
        if len(items) < batch_size:  # pad final batch with repeats, mask frames off
            pad = [dict(items[0]) for _ in range(batch_size - len(items))]
            for p in pad:
                p["frame_mask"] = np.zeros_like(p["frame_mask"])
                p["labels"] = np.zeros_like(p["labels"])
            items += pad
        yield dict(
            audio=np.stack([it["audio"] for it in items]),
            labels=np.stack([it["labels"] for it in items]),
            frame_mask=np.stack([it["frame_mask"] for it in items]),
            spk_mask=np.stack([it["spk_mask"] for it in items]),
            spk_ids=np.stack([it["spk_ids"] for it in items]),
        )
