"""EEND: end-to-end neural diarization with a fixed speaker capacity.

Counterpart of speaker_diarization_tpu/models/eend.py (reference
TransformerModel in eend_eda/models.py:26 + PIT-BCE in eend/loss.py:20):

  audio (B, N) 8 kHz → log-mel 23 (K1′ on CUDA) → mean-norm → splice ±7
  → subsample ×10 → (B, T, 345) → TransformerEncoder (input projection,
  LayerNorm, post-norm layers, padding mask) → Linear → (B, T, n_speakers)

Parameters are fp32; `dtype` is the compute dtype (the features are cast
to it after the front-end, the logits back to fp32). `model.train()` is the
JAX `deterministic=False`: dropout from the `generator` passed to forward.
`remat` recomputes each encoder layer in the backward pass (JAX `remat`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn as nn

from ..ops import features as F
from ..utils.device import resolve_device, resolve_dtype
from .layers import Linear, init_weights_
from .transformer import TransformerEncoder


@dataclass(frozen=True)
class FrontendConfig:
    """Log-mel front-end settings (8 kHz mini_librispeech defaults:
    conf/eend_eda/*.yaml — frame 200/shift 80, logmel23_mn, context 7, ss 10)."""

    sample_rate: int = 8000
    frame_size: int = 200
    frame_shift: int = 80
    n_mels: int = 23
    context_size: int = 7
    subsampling: int = 10
    mean_norm: bool = True

    @property
    def input_dim(self) -> int:
        return self.n_mels * (2 * self.context_size + 1)

    def n_frames(self, n_samples: int) -> int:
        full = F.count_frames(n_samples, self.frame_shift)
        return (full + self.subsampling - 1) // self.subsampling

    def chunk_samples(self, n_sub_frames: int) -> int:
        """Samples for a chunk of n_sub_frames subsampled frames."""
        return n_sub_frames * self.subsampling * self.frame_shift


def frontend_features(x: torch.Tensor, fe: FrontendConfig) -> torch.Tensor:
    """Raw audio (B, N) → spliced, subsampled log-mel; features (B, T, d) pass through."""
    if x.dim() != 2:
        return x
    return F.eend_frontend_auto(x, x.shape[-1], fe.frame_size, fe.frame_shift, fe.sample_rate, fe.n_mels,
                                fe.context_size, fe.subsampling, fe.mean_norm)


def materialize_(module: nn.Module, device, seed: int) -> None:
    """Allocate a module built on the meta device on `device` (None: CUDA,
    or raise without it) and fill it with seeded random weights (eval mode)."""
    module.to_empty(device=resolve_device(device))
    init_weights_(module, torch.Generator().manual_seed(seed))
    module.eval()


class EENDModel(nn.Module):
    """Transformer EEND: audio (or features) → per-speaker frame logits."""

    def __init__(
        self,
        n_speakers: int = 2,
        d_model: int = 256,
        n_layers: int = 4,
        n_heads: int = 4,
        d_ff: int = 2048,
        dropout: float = 0.1,
        frontend: FrontendConfig = FrontendConfig(),
        dtype: Union[str, torch.dtype] = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
        remat: bool = False,
    ):
        super().__init__()
        self.n_speakers, self.frontend = n_speakers, frontend
        self.dtype = resolve_dtype(dtype)
        with torch.device("meta"):
            self.encoder = TransformerEncoder(frontend.input_dim, d_model, n_layers, n_heads, d_ff, dropout,
                                              remat=remat)
            self.head = Linear(d_model, n_speakers)
        materialize_(self, device, seed)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def embed(self, x, frame_mask=None, generator=None):
        """Raw audio (B, N) or features (B, T, in_dim) → frame embeddings (B, T, d_model)."""
        x = frontend_features(x, self.frontend).to(self.dtype)
        return self.encoder(x, frame_mask, generator)

    def forward(self, x, frame_mask=None, generator=None):
        """→ logits (B, T, n_speakers), float32."""
        return self.head(self.embed(x, frame_mask, generator)).float()
