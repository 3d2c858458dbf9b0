"""EEND-VC: chunked EEND that also emits one speaker vector per channel.

Counterpart of speaker_diarization_tpu/models/eend_vc.py (reference
eend_vector_cluster/models_vector_cluster.py:194-370). Per chunk the model
gives frame logits per channel and one vector per channel: each channel's
frame vectors (its own Linear head `vec_head_i`) are L2-normalised, weighted
by the channel's sigmoid posterior, summed over time and normalised again.
Training adds a distance-softmax loss against a global speaker table
(`spk_table`, with learned `alpha` and `beta`); inference clusters the chunk
vectors of a recording with cannot-link-constrained AHC (infer/eend_vc.py).

The front end and trunk are the port's EEND ones: log-mel through K1′ on a
CUDA batch (models/eend.frontend_features), then the TransformerEncoder.
Parameters are fp32, `dtype` is the compute dtype; `model.train()` is the
JAX `deterministic=False`, dropout from the `generator` passed to forward.
The module builds every parameter when it is made, so JAX's `init_all`
(an init entry that also touches the speaker table) has no counterpart.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn

from ..ops.losses import l2_normalize
from ..utils.device import resolve_dtype
from .eend import FrontendConfig, frontend_features, materialize_
from .layers import Linear
from .transformer import TransformerEncoder


class EENDVCModel(nn.Module):
    def __init__(
        self,
        n_speakers: int = 3,  # channels per chunk
        vec_dim: int = 256,
        all_n_speakers: int = 0,  # global speaker-table rows (training only)
        d_model: int = 256,
        n_layers: int = 4,
        n_heads: int = 4,
        d_ff: int = 2048,
        dropout: float = 0.1,
        frontend: FrontendConfig = FrontendConfig(),
        remat: bool = False,
        dtype: Union[str, torch.dtype] = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        self.n_speakers, self.all_n_speakers, self.frontend = n_speakers, all_n_speakers, frontend
        self.dtype = resolve_dtype(dtype)
        with torch.device("meta"):
            self.encoder = TransformerEncoder(frontend.input_dim, d_model, n_layers, n_heads, d_ff, dropout,
                                              remat=remat)
            self.head = Linear(d_model, n_speakers)
            for i in range(n_speakers):  # one vector head per channel (reference linear0..linearS-1)
                self.add_module(f"vec_head_{i}", Linear(d_model, vec_dim))
            if all_n_speakers > 0:
                self.spk_table = nn.Embedding(all_n_speakers, vec_dim)
                self.alpha = nn.Parameter(torch.empty(()))
                self.beta = nn.Parameter(torch.empty(()))
        materialize_(self, device, seed)
        if all_n_speakers > 0:  # the JAX initial values
            with torch.no_grad():
                self.alpha.fill_(1.0)
                self.beta.fill_(1.0)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def forward(self, x, frame_mask=None, generator=None):
        """Raw audio (B, N) or features (B, T, in_dim) → (logits (B, T, S)
        float32, chunk speaker vectors (B, S, vec_dim) L2-normalised)."""
        emb = self.encoder(frontend_features(x, self.frontend).to(self.dtype), frame_mask, generator)
        logits = self.head(emb).float()
        if frame_mask is not None:
            logits = logits * frame_mask[..., None]
        z = torch.sigmoid(logits)
        if frame_mask is not None:
            z = z * frame_mask[..., None]
        vecs = []
        for i in range(self.n_speakers):
            v = l2_normalize(getattr(self, f"vec_head_{i}")(emb).float())  # (B, T, D)
            vecs.append(l2_normalize((v * z[..., i : i + 1]).sum(dim=1)))
        return logits, torch.stack(vecs, dim=1)

    def spk_distance_logits(self, vecs: torch.Tensor) -> torch.Tensor:
        """-(alpha·dist² + beta) against the normalised global table:
        vecs (..., D) → (..., all_n_speakers), for a log-softmax CE
        (reference spk_loss, models_vector_cluster.py:159-192)."""
        table = l2_normalize(self.spk_table.weight)
        d2 = ((vecs[..., None, :] - table) ** 2).sum(-1)
        return -(torch.clamp_min(self.alpha, 1e-8) * d2 + self.beta)
