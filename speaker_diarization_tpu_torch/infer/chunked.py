"""Chunked inference over long recordings.

Counterpart of speaker_diarization_tpu/infer/chunked.py:
- `infer_recording` / `infer_dataset` (EEND family; reference
  eend_eda/infer_eda.py:21-125): fixed-size chunks in the subsampled frame
  domain, batched to one static shape, the tail chunk zero-padded and
  masked, per-chunk probabilities concatenated over the recording;
- `tsvad_infer_dataset`: overlapped TS-VAD windows with per-frame
  probability voting (reference ts_vad2/model.py:957-968 + infer.py:86-94).
`make_eend_predict` / `make_tsvad_predict` wrap a model as the predictor
(TS-VAD3 takes enrollment waveforms through the latter); `make_m2f_predict`
turns EEND-M2F's kept queries into channels and `make_fs_eend_predict`
keeps FS-EEND's speaker channels;
`make_streaming_window_predict` decodes each TS-VAD window chunk by chunk
through a streaming model's caches; `make_sond_predict` folds SOND's
powerset posteriors back to per-speaker probabilities on the 25 Hz grid.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..data.kaldi_io import KaldiData
from ..models.eend import FrontendConfig


def _chunks(audio: np.ndarray, frontend: FrontendConfig, chunk_frames: int):
    """(n_sub, chunk audio list, frame-mask list): the recording cut into
    full-size chunks, the tail zero-padded and masked."""
    chunk_samples = frontend.chunk_samples(chunk_frames)
    n_sub = max(len(audio) // (frontend.subsampling * frontend.frame_shift), 1)
    n_chunks = (n_sub + chunk_frames - 1) // chunk_frames
    audio_p = np.pad(audio.astype(np.float32), (0, max(0, n_chunks * chunk_samples - len(audio))))
    chunks, masks = [], []
    for ci in range(n_chunks):
        chunks.append(audio_p[ci * chunk_samples : (ci + 1) * chunk_samples])
        m = np.zeros((chunk_frames,), np.float32)
        m[: min(chunk_frames, n_sub - ci * chunk_frames)] = 1.0
        masks.append(m)
    return n_sub, chunks, masks


def infer_recording(
    predict_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    audio: np.ndarray,
    frontend: FrontendConfig,
    chunk_frames: int = 500,
    batch_size: int = 8,
) -> np.ndarray:
    """Chunked inference over one recording's samples → (n_sub_frames, S).

    predict_fn: (audio (B, chunk_samples), frame_mask (B, T)) → probs (B, T, S).
    The last batch is zero-padded to `batch_size` (all-masked items), so
    every call has one shape.
    """
    n_sub, chunks, masks = _chunks(audio, frontend, chunk_frames)
    n_chunks = len(chunks)
    outs = []
    for i in range(0, n_chunks, batch_size):
        b_audio, b_mask = np.stack(chunks[i : i + batch_size]), np.stack(masks[i : i + batch_size])
        if len(b_audio) < batch_size:
            pad = batch_size - len(b_audio)
            b_audio = np.concatenate([b_audio, np.zeros((pad,) + b_audio.shape[1:], np.float32)])
            b_mask = np.concatenate([b_mask, np.zeros((pad,) + b_mask.shape[1:], np.float32)])
        outs.append(np.asarray(predict_fn(b_audio, b_mask))[: min(batch_size, n_chunks - i)])
    probs = np.concatenate(outs, axis=0)  # (n_chunks, T, S)
    return probs.reshape(-1, probs.shape[-1])[:n_sub]


def infer_dataset(
    predict_fn, data_dir: str, frontend: FrontendConfig, chunk_frames: int = 500, batch_size: int = 8
) -> Dict[str, np.ndarray]:
    """Chunked inference over every recording of a Kaldi data dir → {rec: (T_sub, S)}."""
    kd = KaldiData(data_dir)
    out = {}
    for rec in sorted(kd.wavs):
        audio, rate = kd.load_wav(rec)
        if rate != frontend.sample_rate:
            raise ValueError(f"{rec}: {rate} Hz audio, the model's front-end wants {frontend.sample_rate} Hz")
        out[rec] = infer_recording(predict_fn, audio, frontend, chunk_frames, batch_size)
    return out


def make_eend_predict(model) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """(audio, frame_mask) numpy → masked sigmoid probabilities numpy, on the model's device."""
    dev = model.device

    @torch.no_grad()
    def predict(audio: np.ndarray, mask: np.ndarray) -> np.ndarray:
        a = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(dev)
        m = torch.from_numpy(np.ascontiguousarray(mask, np.float32)).to(dev)
        return (torch.sigmoid(model(a, m)) * m[..., None]).cpu().numpy()

    return predict


def make_m2f_predict(model, class_threshold: float = 0.5, max_concurrent: int = 0):
    """(audio, frame_mask) numpy → (B, T, Q) probabilities: the activity of
    every query whose class probability passes `class_threshold`, at most
    `max_concurrent` a frame (0: no cap), masked (models/eend_m2f.
    m2f_predict_activity)."""
    from ..models.eend_m2f import m2f_predict_activity

    dev = model.device

    @torch.no_grad()
    def predict(audio: np.ndarray, mask: np.ndarray) -> np.ndarray:
        a = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(dev)
        m = torch.from_numpy(np.ascontiguousarray(mask, np.float32)).to(dev)
        act, _ = m2f_predict_activity(model(a, m), class_threshold, max_concurrent)
        return (act.transpose(1, 2) * m[..., None]).cpu().numpy()

    return predict


def make_fs_eend_predict(model) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """(audio, frame_mask) numpy → the speaker channels' masked sigmoid
    probabilities (B, T, n_speakers): channel 0 is silence and the last the pad."""
    dev = model.device

    @torch.no_grad()
    def predict(audio: np.ndarray, mask: np.ndarray) -> np.ndarray:
        a = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(dev)
        m = torch.from_numpy(np.ascontiguousarray(mask, np.float32)).to(dev)
        logits, _ = model(a, m)
        return (torch.sigmoid(logits[..., 1 : 1 + model.n_speakers]) * m[..., None]).cpu().numpy()

    return predict


def tsvad_infer_dataset(
    predict_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    dataset,
    batch_size: int = 16,
    emb_key: str = "target_embs",
) -> Dict[str, np.ndarray]:
    """Overlap-voted probabilities over every recording of `dataset`.

    `dataset` is a TSVADChunkDataset (eval path, canonical speaker order)
    with a small segment_shift so windows overlap.
    predict_fn: (audio (B, N), target_embs (B, S, D)) → probs (B, T25, S).
    The last batch is zero-padded to `batch_size`, so every call has one
    shape. Returns {rec: (n_frames, n_speakers_rec) mean probabilities}.
    """
    sums: Dict[str, np.ndarray] = {}
    counts: Dict[str, np.ndarray] = {}
    for rec, spks in dataset.rec_speakers.items():
        n = dataset.n_frames(rec)
        sums[rec] = np.zeros((n, len(spks)), np.float64)
        counts[rec] = np.zeros((n, 1), np.float64)

    n_items = len(dataset)
    for i in range(0, n_items, batch_size):
        items = [dataset[j] for j in range(i, min(i + batch_size, n_items))]
        audio = np.stack([it["audio"] for it in items])
        embs = np.stack([it[emb_key] for it in items])
        if len(items) < batch_size:
            pad = batch_size - len(items)
            audio = np.concatenate([audio, np.zeros((pad,) + audio.shape[1:], np.float32)])
            embs = np.concatenate([embs, np.zeros((pad,) + embs.shape[1:], np.float32)])
        probs = np.asarray(predict_fn(audio, embs))[: len(items)]
        for it, p in zip(items, probs):
            rec = it["rec"]
            st = it["start_frame"]
            n_spk = len(it["speakers"])
            en = min(st + p.shape[0], sums[rec].shape[0])
            sums[rec][st:en, :n_spk] += p[: en - st, :n_spk]
            counts[rec][st:en] += 1.0
    return {rec: (sums[rec] / np.maximum(counts[rec], 1.0)).astype(np.float32) for rec in sums}


def make_tsvad_predict(model, n_label_frames: int) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """(audio, embs) numpy → sigmoid probabilities numpy, on the model's device."""
    dev = model.device

    @torch.no_grad()
    def predict(audio: np.ndarray, embs: np.ndarray) -> np.ndarray:
        a = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(dev)
        e = torch.from_numpy(np.ascontiguousarray(embs, np.float32)).to(dev)
        return torch.sigmoid(model(a, e, n_label_frames)).cpu().numpy()

    return predict


def streaming_window_logits(model, audio: torch.Tensor, embs: torch.Tensor, n_label_frames: int) -> torch.Tensor:
    """Each window of `audio` (B, N) decoded chunk by chunk through a
    streaming model's caches from a fresh state → logits (B, n_label_frames,
    S), on the model's device. The mix is cut to n_label_frames and
    zero-padded to whole chunks; the JAX `lax.scan` over chunks is a loop
    (7 chunks for a 4 s window at chunk 16)."""
    chunk = model.cfg.chunk_size
    n_chunks = -(-n_label_frames // chunk)
    mix = model.encode_frames(audio)[:, :n_label_frames]
    mix = torch.nn.functional.pad(mix, (0, 0, 0, n_chunks * chunk - mix.shape[1]))
    state = model.streaming_state(mix.shape[0])
    outs = []
    for c in range(n_chunks):
        logits, state = model.streaming_step_mix(mix[:, c * chunk : (c + 1) * chunk], embs, state)
        outs.append(logits)
    return torch.cat(outs, dim=1)[:, :n_label_frames]


def make_streaming_window_predict(model, n_label_frames: int) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """Window-wise streaming TS-VAD predictor for `tsvad_infer_dataset`.

    Counterpart of the JAX make_streaming_window_predict (reference
    run_ts_vad2_streaming.sh:70-128, ts_vad2_streaming/model.py:368-462):
    each overlapped rs_len window is decoded chunk by chunk from a fresh
    state (`streaming_window_logits`), and the windows are then
    overlap-voted. Decoding whole recordings in one pass would push the
    absolute positions far past the trained window.

    (audio (B, N), embs (B, S, D)) numpy → sigmoid probabilities (B, T25, S) numpy.
    """
    dev = model.device

    @torch.no_grad()
    def predict(audio: np.ndarray, embs: np.ndarray) -> np.ndarray:
        a = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(dev)
        e = torch.from_numpy(np.ascontiguousarray(embs, np.float32)).to(dev)
        return torch.sigmoid(streaming_window_logits(model, a, e, n_label_frames)).cpu().numpy()

    return predict


def sond_probabilities(model, audio: torch.Tensor, embs: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """SOND's per-speaker probabilities (B, T25, N_spk) from audio (B, N)
    and profiles (B, N_spk, D) on the device: kaldi fbank (K1 on CUDA),
    powerset softmax times the class → speakers mapping, each 12.5 Hz frame
    (ResNet34's ×8) repeated onto the 25 Hz label grid."""
    from ..ops import features as F
    from ..ops.powerset import powerset_mapping

    c = model.cfg
    mapping = torch.from_numpy(powerset_mapping(c.max_speakers, c.max_set_size)).to(audio.device)
    logits = model(F.kaldi_fbank_auto(audio, sample_rate=sample_rate, num_mel_bins=c.feat_dim, mean_norm=True), embs)
    return (torch.softmax(logits, dim=-1) @ mapping).repeat_interleave(2, dim=1)


def make_sond_predict(model, sample_rate: int) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """(audio (B, N), profiles (B, N_spk, D)) numpy → `sond_probabilities` numpy, on the model's device."""
    dev = model.device

    @torch.no_grad()
    def predict(audio: np.ndarray, embs: np.ndarray) -> np.ndarray:
        a = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(dev)
        e = torch.from_numpy(np.ascontiguousarray(embs, np.float32)).to(dev)
        return sond_probabilities(model, a, e, sample_rate).cpu().numpy()

    return predict
