"""OTS-VAD: online target-speaker VAD without enrollment embeddings, PyTorch.

Counterpart of speaker_diarization_tpu/models/ots_vad.py (reference
egs/alimeeting/ots_vad/model.py):

  audio (B, N) → kaldi fbank (K1 on CUDA) → ResNet34 frames (×8 in time,
  12.5 Hz) → Linear → frame embeddings (B, T, D)
  target embeddings are self-generated: masked means of a block's frame
  embeddings under that block's labels (training) or decisions (inference)
  backend per speaker: Linear([frame ‖ target]) → conformer blocks
  (BatchNorm conv module) → BiLSTM (flax nn.RNN(OptimizedLSTMCell) forward
  and on the reversed sequence) → ReLU(Linear) → Linear → logits (B, S, T)

Training self-enrolls on the left half of a chunk with its true labels and
predicts the right half (two K1 launches a step). `online_init` and
`online_step` keep running (sum, count) accumulators per speaker.
Submodules carry the flax names (`frontend`, `front_proj`, `conf_0`,
`back_in`, `lstm_fwd`, `lstm_bwd`, `fc1`, `fc2`), so utils/convert.
ots_vad_from_flax maps the JAX variables. Parameters are fp32; `dtype` is
the compute dtype; `model.train()` is the JAX `train=True` (BatchNorm on
batch statistics, dropout from the `generator`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import torch
import torch.nn as nn

from ..ops import features as F
from ..utils.device import resolve_dtype
from .conformer import ConformerBlock
from .eda import LSTM
from .eend import materialize_
from .layers import Linear
from .speaker_encoders import ResNet34


@dataclass(frozen=True)
class OTSVADConfig:
    num_speakers: int = 4
    d_model: int = 256
    conformer_layers: int = 2
    n_heads: int = 4
    d_ff: int = 512
    lstm_hidden: int = 256
    feat_dim: int = 80
    sample_rate: int = 16000
    encoder_m_channels: int = 32
    encoder_blocks: tuple = (3, 4, 6, 3)
    dropout: float = 0.1


class OTSVADModel(nn.Module):
    """Built on `device` (None: CUDA, or raise without it) with fp32 weights
    drawn from `seed`; `dtype` is the compute dtype."""

    def __init__(
        self,
        cfg: OTSVADConfig = OTSVADConfig(),
        dtype: Union[str, torch.dtype] = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = resolve_dtype(dtype)
        with torch.device("meta"):
            self.frontend = ResNet34(feat_dim=c.feat_dim, m_channels=c.encoder_m_channels, num_blocks=c.encoder_blocks,
                                     with_head=False)
            self.front_proj = Linear(self.frontend.out_channels, c.d_model)
            for i in range(c.conformer_layers):
                self.add_module(f"conf_{i}", ConformerBlock(c.d_model, c.n_heads, c.d_ff, dropout=c.dropout))
            self.back_in = Linear(2 * c.d_model, c.d_model)
            self.lstm_fwd = LSTM(c.d_model, c.lstm_hidden)
            self.lstm_bwd = LSTM(c.d_model, c.lstm_hidden, reverse=True)
            self.fc1 = Linear(2 * c.lstm_hidden, c.d_model)
            self.fc2 = Linear(c.d_model, 1)
        materialize_(self, device, seed)

    @property
    def device(self) -> torch.device:
        return self.fc2.weight.device

    def embed_frames(self, audio_or_fbank: torch.Tensor) -> torch.Tensor:
        """audio (B, N) or fbank (B, T100, F) → frame embeddings (B, ceil(T100/8), D)."""
        c = self.cfg
        fbank = audio_or_fbank
        if fbank.dim() == 2:
            fbank = F.kaldi_fbank_auto(fbank, sample_rate=c.sample_rate, num_mel_bins=c.feat_dim, mean_norm=True)
        return self.front_proj(self.frontend(fbank.to(self.dtype), mode="frames"))

    @staticmethod
    def masked_target_embeddings(frame_emb: torch.Tensor, labels: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
        """(B, T, D) embeddings, (B, S, T) activity → (B, S, D) masked means, fp32."""
        sums = torch.einsum("bst,btd->bsd", labels.float(), frame_emb.float())
        return sums / (labels.float().sum(-1, keepdim=True) + eps)

    def backend(self, frame_emb: torch.Tensor, target_emb: torch.Tensor, generator=None) -> torch.Tensor:
        """(B, T, D) + (B, S, D) → per-speaker logits (B, S, T), fp32."""
        c = self.cfg
        B, T, D = frame_emb.shape
        S = c.num_speakers
        f = frame_emb.to(self.dtype)[:, None].expand(B, S, T, D)
        t = target_emb.to(self.dtype)[:, :, None].expand(B, S, T, D)
        x = self.back_in(torch.cat([f, t], dim=-1)).reshape(B * S, T, c.d_model)
        for i in range(c.conformer_layers):
            x = getattr(self, f"conf_{i}")(x, generator)
        h = torch.cat([self.lstm_fwd(x)[1], self.lstm_bwd(x)[1]], dim=-1).to(self.dtype)  # the LSTMs' fp32 outputs
        h = torch.relu(self.fc1(h))
        return self.fc2(h)[..., 0].reshape(B, S, T).float()

    def forward(self, left, right, y_left, generator=None):
        """Training forward: self-enroll on the left block with its true
        labels y_left (B, S, T_left), predict the right block → (B, S, T)."""
        emb_l = self.embed_frames(left)
        emb_r = self.embed_frames(right)
        Tl = min(emb_l.shape[1], y_left.shape[-1])
        target = self.masked_target_embeddings(emb_l[:, :Tl], y_left[..., :Tl])
        return self.backend(emb_r, target, generator)

    def online_init(self, batch: int) -> Dict[str, torch.Tensor]:
        c = self.cfg
        return dict(sums=torch.zeros((batch, c.num_speakers, c.d_model), device=self.device),
                    counts=torch.zeros((batch, c.num_speakers, 1), device=self.device))

    def online_step(self, block, state, threshold: float = 0.5):
        """One block: predict with the current self-enrolled embeddings, then
        add this block's decisions to the accumulators → (logits, state)."""
        emb = self.embed_frames(block)
        logits = self.backend(emb, state["sums"] / (state["counts"] + 1e-8))
        dec = (torch.sigmoid(logits) > threshold).float()  # (B, S, T)
        return logits, dict(sums=state["sums"] + torch.einsum("bst,btd->bsd", dec, emb.float()),
                            counts=state["counts"] + dec.sum(-1, keepdim=True))
