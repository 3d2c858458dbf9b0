"""EEND-EDA: encoder-decoder attractors for variable speaker counts.

Counterpart of speaker_diarization_tpu/models/eda.py (reference
eend_eda/models.py:160-652 + encoder_decoder_attractor.py:8-59). An LSTM
encoder reads the (optionally time-shuffled) frame embeddings; an LSTM
decoder, started from the encoder's final state, unrolls zero inputs into
attractors; the diarization logits are emb · attractorᵀ and a linear head
gives each attractor's existence logit.

The recurrences are flax `OptimizedLSTMCell`s under `nn.RNN`, written out:
- parameters `ii/if/ig/io` (input kernels, no bias) and `hi/hf/hg/ho`
  (hidden kernels with bias), gate order i, f, g, o, carry (c, h); here
  `input` and `hidden` Linears whose rows are the four gates in that order;
- the input projection of all steps is one matmul, then one small step per
  frame (the JAX package runs a `lax.scan` there, outside any kernel);
- the carry starts at zero in fp32 and stays fp32; the gate pre-activations
  and gates are computed in the compute dtype and promoted where they meet
  the carry, as JAX promotes them, so the attractors come out fp32 in a
  bf16 model and the product emb · attractorᵀ runs in fp32;
- `seq_lengths` freezes each row's carry at its last valid frame (a row of
  length 0 keeps the carry after all T steps, as flax's index −1 does);
- `reverse` runs the sequence last frame first and gives the outputs back
  in the input's order (flax `nn.RNN(reverse=True, keep_order=True)`), the
  backward half of TS-VAD's BiLSTM backend.

The encoder is the transformer (`TransformerEncoder`) or, with
`encoder_type="conformer"`, models/conformer.ConformerEncoder with its
conv-module norm `conv_norm` ("group" is what the CLI builds).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from ..utils.device import resolve_dtype
from .eend import FrontendConfig, frontend_features, materialize_
from .conformer import ConformerEncoder
from .layers import Linear
from .transformer import TransformerEncoder


class LSTM(nn.Module):
    """flax OptimizedLSTMCell unrolled over time by nn.RNN."""

    def __init__(self, d_in: int, d: int, reverse: bool = False):
        super().__init__()
        self.input = Linear(d_in, 4 * d, bias=False)  # ii | if | ig | io
        self.hidden = Linear(d, 4 * d)  # hi | hf | hg | ho, with bias
        self.d = d
        self.reverse = reverse

    def forward(
        self, x: torch.Tensor, carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        seq_lengths: Optional[torch.Tensor] = None,
    ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        """x (B, T, d_in) in the compute dtype → (final carry (c, h), outputs (B, T, d)), fp32."""
        if self.reverse:
            if seq_lengths is not None:
                raise ValueError("a reversed LSTM takes no seq_lengths")
            carry, out = self._run(x.flip(1), carry, None)
            return carry, out.flip(1)
        return self._run(x, carry, seq_lengths)

    def _run(self, x, carry, seq_lengths):
        B, T, _ = x.shape
        D = self.d
        xi = self.input(x)  # (B, T, 4D)
        if carry is None:
            zero = torch.zeros((B, D), dtype=torch.float32, device=x.device)
            carry = (zero, zero)
        c, h = carry
        hs, cs = [], []
        for t in range(T):
            z = self.hidden(h.to(x.dtype)) + xi[:, t]
            s = torch.sigmoid(z)  # i, f and o; the g quarter is unused
            g = torch.tanh(z[:, 2 * D : 3 * D])
            c = s[:, D : 2 * D].float() * c + (s[:, :D] * g).float()
            h = s[:, 3 * D :].float() * torch.tanh(c)
            hs.append(h)
            cs.append(c)
        out = torch.stack(hs, 1)
        if seq_lengths is None:
            return (c, h), out
        last = (seq_lengths.long() - 1) % T
        rows = torch.arange(B, device=x.device)
        return (torch.stack(cs, 1)[rows, last], out[rows, last]), out


class EncoderDecoderAttractor(nn.Module):
    def __init__(self, d_model: int = 256):
        super().__init__()
        self.enc_lstm = LSTM(d_model, d_model)
        self.dec_lstm = LSTM(d_model, d_model)
        self.exist_head = Linear(d_model, 1)
        self.d_model = d_model

    def forward(self, emb, n_attractors: int, frame_mask=None, order=None):
        """emb (B, T, D) → (attractors (B, n_attractors, D) fp32, exist_logits (B, n_attractors) fp32).

        order: optional (B, T) int frame permutation applied before the
        encoder LSTM (the reference's time-shuffle, models.py:531-536).
        frame_mask: (B, T); padded frames are zeroed before encoding.
        """
        fm = frame_mask
        if order is not None:
            emb = torch.gather(emb, 1, order[..., None].expand(-1, -1, emb.shape[-1]))
            fm = None if frame_mask is None else torch.gather(frame_mask, 1, order)
        seq = None
        if fm is not None:
            emb = emb * fm[..., None].to(emb.dtype)
            seq = fm.sum(-1)
        carry, _ = self.enc_lstm(emb, seq_lengths=seq)
        zeros = torch.zeros((emb.shape[0], n_attractors, self.d_model), dtype=emb.dtype, device=emb.device)
        _, attractors = self.dec_lstm(zeros, carry)
        exist = self.exist_head(attractors.to(emb.dtype))[..., 0].float()
        return attractors, exist


class EendEdaModel(nn.Module):
    """Transformer or conformer encoder + EDA. Trains at capacity
    n_speakers; `infer` decodes max_attractors and leaves the choice to a
    threshold on the existence probability. `remat` recomputes each
    transformer layer in the backward pass (the JAX conformer has none)."""

    def __init__(
        self,
        n_speakers: int = 2,
        max_attractors: int = 15,
        d_model: int = 256,
        n_layers: int = 4,
        n_heads: int = 4,
        d_ff: int = 2048,
        dropout: float = 0.1,
        encoder_type: str = "transformer",
        conv_norm: str = "batch",
        frontend: FrontendConfig = FrontendConfig(),
        remat: bool = False,
        dtype: Union[str, torch.dtype] = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        if encoder_type not in ("transformer", "conformer"):
            raise ValueError(f"encoder_type must be transformer|conformer, got {encoder_type!r}")
        self.n_speakers, self.max_attractors, self.frontend = n_speakers, max_attractors, frontend
        self.dtype = resolve_dtype(dtype)
        with torch.device("meta"):
            if encoder_type == "conformer":
                self.encoder = ConformerEncoder(frontend.input_dim, d_model, n_layers, n_heads, d_ff,
                                                dropout=dropout, conv_norm=conv_norm)
            else:
                self.encoder = TransformerEncoder(frontend.input_dim, d_model, n_layers, n_heads, d_ff, dropout,
                                                  remat=remat)
            self.eda = EncoderDecoderAttractor(d_model)
        materialize_(self, device, seed)

    @property
    def device(self) -> torch.device:
        return self.eda.exist_head.weight.device

    def embed(self, x, frame_mask=None, generator=None):
        x = frontend_features(x, self.frontend).to(self.dtype)
        return self.encoder(x, frame_mask, generator)

    def forward(self, x, frame_mask=None, order=None, generator=None):
        """→ (logits (B, T, C), exist_logits (B, C+1)), fp32, with C =
        n_speakers; the logits use the first C attractors and are zero on
        padded frames."""
        C = self.n_speakers
        emb = self.embed(x, frame_mask, generator)
        attractors, exist = self.eda(emb, C + 1, frame_mask, order)
        logits = torch.matmul(emb.float(), attractors[:, :C].transpose(1, 2))
        if frame_mask is not None:
            logits = logits * frame_mask[..., None]
        return logits, exist

    def infer(self, x, frame_mask=None):
        """Decode max_attractors attractors → (logits (B, T, A), exist_probs (B, A))."""
        emb = self.embed(x, frame_mask)
        attractors, exist = self.eda(emb, self.max_attractors, frame_mask)
        return torch.matmul(emb.float(), attractors.transpose(1, 2)), torch.sigmoid(exist)
