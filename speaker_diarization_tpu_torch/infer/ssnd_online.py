"""SSND online block-wise inference with an embedding memory.

The port's own copy of speaker_diarization_tpu/infer/ssnd_online.py, which
is numpy-only; the bookkeeping below is that module's, line for line, and
tests/test_torch_ssnd.py holds the two copies to the same output.
`make_ssnd_predict` is the port's predictor: one forward of SSNDModel on
its device per block.

Reference: `egs/alimeeting/ssnd/ssnd_model.py:802` (online_infer) — process
a recording block by block; slots carry the embeddings of speakers
discovered so far plus one pseudo-speaker slot (the model's learned e_pse)
that detects new speakers. After each block, the representation decoder's
embedding for any sufficiently-active slot updates the memory (running
mean); a pseudo-slot that fires promotes to a new speaker.
"""


from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch


@dataclass
class SpeakerMemory:
    embeddings: List[np.ndarray] = field(default_factory=list)
    counts: List[int] = field(default_factory=list)

    def update(self, idx: int, emb: np.ndarray):
        n = self.counts[idx]
        self.embeddings[idx] = (self.embeddings[idx] * n + emb) / (n + 1)
        self.counts[idx] += 1

    def add(self, emb: np.ndarray) -> int:
        self.embeddings.append(emb.copy())
        self.counts.append(1)
        return len(self.embeddings) - 1

    def __len__(self):
        return len(self.embeddings)


def ssnd_online_infer(
    predict_fn: Callable[[np.ndarray, np.ndarray], tuple],
    audio: np.ndarray,
    block_samples: int,
    vad_out_len: int,
    max_speakers: int,
    e_pse: np.ndarray,
    e_non: np.ndarray,
    active_threshold: float = 0.3,
    new_speaker_threshold: float = 0.5,
    return_memory: bool = False,
):
    """→ (n_blocks · vad_out_len, n_discovered_speakers) activity probs
    (plus the final SpeakerMemory when return_memory=True).

    predict_fn: (audio_block (1, N), aux_embs (1, S, D)) →
    (vad_logits (1, S, T), spk_embs (1, S, D)).
    """
    memory = SpeakerMemory()
    n_blocks = int(np.ceil(len(audio) / block_samples))
    audio = np.pad(audio.astype(np.float32), (0, n_blocks * block_samples - len(audio)))
    outputs = []  # per block: (T, n_speakers_at_that_time)

    for bi in range(n_blocks):
        block = audio[bi * block_samples : (bi + 1) * block_samples][None]
        # slots: known speakers (up to S-1) + one pseudo slot; pad with e_non
        S = max_speakers
        aux = np.tile(e_non[None], (S, 1)).astype(np.float32)
        known = min(len(memory), S - 1)
        for i in range(known):
            aux[i] = memory.embeddings[i]
        pse_slot = known
        aux[pse_slot] = e_pse
        vad, emb = predict_fn(block, aux[None])
        vad = 1 / (1 + np.exp(-np.asarray(vad)[0]))  # (S, T)
        emb = np.asarray(emb)[0]

        # update memory for active known slots
        for i in range(known):
            if vad[i].mean() > active_threshold:
                memory.update(i, emb[i])
        # pseudo slot fires → new speaker discovered
        if vad[pse_slot].mean() > new_speaker_threshold and len(memory) < 100:
            memory.add(emb[pse_slot])
            known_after = known + 1
        else:
            known_after = known
        frame = np.zeros((vad.shape[1], max(len(memory), 1)), np.float32)
        for i in range(known):
            frame[:, i] = vad[i]
        if known_after > known:
            frame[:, known_after - 1] = vad[pse_slot]
        outputs.append(frame)

    n_spk = max(len(memory), 1)
    total = np.zeros((sum(o.shape[0] for o in outputs), n_spk), np.float32)
    pos = 0
    for o in outputs:
        total[pos : pos + o.shape[0], : o.shape[1]] = o
        pos += o.shape[0]
    if return_memory:
        return total, memory
    return total


def ssnd_offline_rescore(
    predict_fn: Callable[[np.ndarray, np.ndarray], tuple],
    audio: np.ndarray,
    block_samples: int,
    vad_out_len: int,
    max_speakers: int,
    e_pse: np.ndarray,
    e_non: np.ndarray,
    active_threshold: float = 0.3,
    new_speaker_threshold: float = 0.5,
) -> np.ndarray:
    """Two-pass offline inference (reference ssnd_model.py offline_rescore,
    :899): pass 1 = online_infer collecting the global speaker-embedding
    buffer; pass 2 = re-decode every block against the *final* buffer, so
    early blocks see speakers discovered later and slot identities are
    globally consistent. → (n_blocks · vad_out_len, n_speakers) probs."""
    _, memory = ssnd_online_infer(
        predict_fn, audio, block_samples, vad_out_len, max_speakers,
        e_pse, e_non, active_threshold, new_speaker_threshold, return_memory=True,
    )
    n_spk = len(memory)
    if n_spk == 0:
        n_blocks = int(np.ceil(len(audio) / block_samples))
        return np.zeros((n_blocks * vad_out_len, 1), np.float32)

    S = max_speakers
    aux = np.tile(e_non[None], (S, 1)).astype(np.float32)
    known = min(n_spk, S)
    for i in range(known):
        aux[i] = memory.embeddings[i]

    n_blocks = int(np.ceil(len(audio) / block_samples))
    padded = np.pad(audio.astype(np.float32), (0, n_blocks * block_samples - len(audio)))
    outputs = []
    for bi in range(n_blocks):
        block = padded[bi * block_samples : (bi + 1) * block_samples][None]
        vad, _ = predict_fn(block, aux[None])
        vad = 1 / (1 + np.exp(-np.asarray(vad)[0]))  # (S, T)
        outputs.append(vad[:known].T)  # (T, known)
    return np.concatenate(outputs, axis=0)


def make_ssnd_predict(model) -> Callable[[np.ndarray, np.ndarray], tuple]:
    """(audio block (1, N), slot queries (1, S, D)) numpy → (VAD logits
    (1, S, T), slot embeddings (1, S, D)) numpy, one eval-mode forward of
    `model` on its device (the fbank through K1 on CUDA)."""
    model.eval()

    @torch.no_grad()
    def predict(audio: np.ndarray, aux: np.ndarray):
        dev = model.device
        vad, emb = model(torch.from_numpy(np.asarray(audio, np.float32)).to(dev),
                         torch.from_numpy(np.asarray(aux, np.float32)).to(dev))
        return vad.cpu().numpy(), emb.cpu().numpy()

    return predict
