"""OTS-VAD online inference: self-enrolled block-wise decoding.

Counterpart of speaker_diarization_tpu/infer/ots_vad.py (reference
egs/alimeeting/ots_vad/test_inference_case1.py, Algorithm 1). The host
bookkeeping is that module's, unchanged:
  * overlapping chunks of length l with shift m; per-frame outputs and
    frame embeddings are vote-averaged across overlaps (float64 sums);
  * the first chunk bootstraps one speaker on all its frames;
  * target embeddings = masked means of the embedding history over frames
    where the vote-averaged output exceeds `upper`;
  * new-speaker rule: if every active slot's history is below `lower`
    across the freshest m frames and a slot is free, a new slot starts on
    exactly those m frames.
The two forwards (frame embeddings, then the per-speaker backend) run on
the model's device in eval mode, the fbank through K1 on CUDA.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def ots_vad_infer_dataset(
    model,
    kd,
    rate: int,
    rs_len: float,
    upper: float = 0.6,
    lower: float = 0.3,
    shift_s: float = 0.8,
) -> Dict[str, np.ndarray]:
    """kd: KaldiData over the eval dir. Returns {rec: (n_frames25, S) probs}
    on the 25 Hz label grid (model frame rate is 12.5 Hz, repeated ×2)."""
    model.eval()
    dev = model.device
    S = model.cfg.num_speakers
    block = int(rs_len * rate)
    frames_per_block = None  # discovered from the first embed

    @torch.no_grad()
    def embed(a: np.ndarray) -> np.ndarray:
        return model.embed_frames(torch.from_numpy(a).to(dev)).float().cpu().numpy()

    @torch.no_grad()
    def score(emb: np.ndarray, targets: np.ndarray) -> np.ndarray:
        logits = model.backend(torch.from_numpy(emb).to(dev), torch.from_numpy(targets.astype(np.float32)).to(dev))
        return torch.sigmoid(logits).cpu().numpy()

    out: Dict[str, np.ndarray] = {}
    for rec in sorted(kd.wavs):
        audio, r = kd.load_wav(rec)
        if r != rate:
            raise ValueError(f"{rec}: {r} Hz audio, the model wants {rate} Hz")
        if audio.ndim > 1:
            audio = audio[:, 0]

        shift = int(shift_s * rate)
        n_starts = max(1, -(-max(len(audio) - block, 1) // shift) + 1)
        need = (n_starts - 1) * shift + block
        padded = np.zeros((need,), np.float32)
        padded[: len(audio)] = audio

        d_model = model.cfg.d_model
        sumY = None  # (S, T_total) vote sums
        sumE = None  # (T_total, D)
        ct = None  # (T_total,)
        n_active = 0

        for b in range(n_starts):
            s0 = b * shift
            emb = embed(padded[None, s0 : s0 + block])[0]  # (Tk, D)
            Tk = emb.shape[0]
            if frames_per_block is None:
                frames_per_block = Tk
            # frame index of this chunk on the 12.5 Hz grid
            fstart = round(s0 / rate * Tk / rs_len)
            fend = fstart + Tk
            m_frames = max(1, round(shift_s / rs_len * Tk))
            if sumY is None:
                total = round(need / rate * Tk / rs_len) + Tk
                sumY = np.zeros((S, total), np.float64)
                sumE = np.zeros((total, d_model), np.float64)
                ct = np.zeros((total,), np.float64)
                # bootstrap: first chunk is one speaker everywhere
                sumY[0, fstart:fend] = 1.0
                sumE[fstart:fend] = emb
                ct[fstart:fend] = 1.0
                n_active = 1
                continue

            seen = ct > 0
            Y_hat = np.where(seen, sumY / np.maximum(ct, 1e-8), 0.0)  # (S, T)
            E_hat = sumE / np.maximum(ct[:, None], 1e-8)
            Y_bar = (Y_hat > upper).astype(np.float64)  # binarize history
            denom = Y_bar.sum(axis=1, keepdims=True)
            ek = (Y_bar @ E_hat) / np.maximum(denom, 1e-8)  # (S, D)

            Yk = np.array(score(emb[None], ek[None]))[0]
            Yk[n_active:] = 0.0  # never-activated slots stay silent

            # new-speaker rule on the freshest m frames of history
            hist_end = fstart  # frames strictly before this chunk are settled
            lo = max(0, hist_end - m_frames)
            if hist_end > lo and n_active < S:
                recent = Y_hat[:max(n_active, 1), lo:hist_end]
                if (recent < lower).all():
                    sumY[n_active, lo:hist_end] = ct[lo:hist_end]  # mean = 1.0
                    n_active += 1

            sumY[:, fstart:fend] += Yk
            sumE[fstart:fend] += emb
            ct[fstart:fend] += 1.0

        total_frames = round(len(audio) / rate * frames_per_block / rs_len)
        Y_final = np.where(ct > 0, sumY / np.maximum(ct, 1e-8), 0.0)[:, :total_frames]
        pr = np.repeat(Y_final.T, 2, axis=0).astype(np.float32)  # 12.5 → 25 Hz
        n25 = int(len(audio) / rate * 25)
        out[rec] = pr[:n25]
    return out
