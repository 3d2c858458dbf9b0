"""FS-EEND: frame-streaming online EEND with a masked attractor decoder, PyTorch.

Counterpart of speaker_diarization_tpu/models/fs_eend.py (reference
speaker_diarization/fs_eend/fs_eend.py:22-135 and model.py:55-99):

  audio (B, N) 8 kHz → log-mel 23, spliced and subsampled (K1′ on CUDA) →
  causal transformer encoder (look-ahead `mask_delay`, combined with the
  padding mask) → 1-D conv with `conv_delay` frames of look-ahead → L2
  normalised frame embeddings (B, T, D)
  attractors (B, T, C, D): Linear([embedding ‖ the channel's sinusoidal
  position]) refined by fusion layers (causal attention along time per
  channel, then attention across channels per frame, then an FFN, each post
  norm), L2 normalised
  logits = embedding · attractorᵀ per frame (B, T, C), zero on padded frames

The C = n_speakers + 2 channels are [silence ‖ speakers in order of first
appearance ‖ a zero pad] (`fs_eend_labels`). Every operation is causal up to
its bounded look-ahead, so this offline forward equals the frame-streaming
output. Submodules carry the flax names (`lookahead_conv`, `convert`,
`fusion_0.time_attn`, ...; the encoder as the EEND family's), so
utils/convert.fs_eend_from_flax maps the JAX variables. Parameters are fp32;
`dtype` is the compute dtype; dropout draws from the `generator` in train mode.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn

from ..ops import losses as L
from ..parallel.collectives import batch_mean
from ..utils.device import resolve_dtype
from .eend import FrontendConfig, frontend_features, materialize_
from .layers import Conv1d, Linear, dropout as drop
from .transformer import (LayerNorm, MultiHeadAttention, TransformerEncoder, make_causal_mask,
                          sinusoidal_position_encoding)


class FusionLayer(nn.Module):
    """Time-causal attention per channel + channel attention per frame + FFN."""

    def __init__(self, d: int, n_heads: int, d_ff: int, dropout: float = 0.1, mask_delay: int = 0):
        super().__init__()
        self.time_attn = MultiHeadAttention(d, n_heads, dropout)
        self.norm_t = LayerNorm(d)
        self.spk_attn = MultiHeadAttention(d, n_heads, dropout)
        self.norm_c = LayerNorm(d)
        self.ff1 = Linear(d, d_ff)
        self.ff2 = Linear(d_ff, d)
        self.norm_ff = LayerNorm(d)
        self.dropout, self.mask_delay = dropout, mask_delay

    def forward(self, x, generator=None):
        B, T, C, D = x.shape
        p, on = self.dropout, self.training
        xt = x.transpose(1, 2).reshape(B * C, T, D)
        tmask = make_causal_mask(T, self.mask_delay, x.device)
        xt = self.norm_t(xt + drop(self.time_attn(xt, generator, tmask), p, on, generator))
        xc = xt.reshape(B, C, T, D).transpose(1, 2).reshape(B * T, C, D)
        xc = self.norm_c(xc + drop(self.spk_attn(xc, generator), p, on, generator))
        h = self.ff2(drop(torch.relu(self.ff1(xc)), p, on, generator))
        xc = self.norm_ff(xc + drop(h, p, on, generator))
        return xc.reshape(B, T, C, D)


class FSEENDModel(nn.Module):
    """audio (or features) → (logits (B, T, n_speakers + 2), frame embeddings (B, T, D)), fp32.

    Built on `device` (None: CUDA, or raise without it) with fp32 weights
    drawn from `seed`; `dtype` is the compute dtype.
    """

    def __init__(
        self,
        n_speakers: int = 2,
        d_model: int = 256,
        enc_layers: int = 4,
        dec_layers: int = 2,
        n_heads: int = 4,
        d_ff: int = 2048,
        dec_d_ff: int = 512,
        dropout: float = 0.1,
        conv_delay: int = 9,
        mask_delay: int = 0,
        frontend: FrontendConfig = FrontendConfig(),
        dtype: Union[str, torch.dtype] = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        self.n_speakers, self.frontend, self.mask_delay = n_speakers, frontend, mask_delay
        self.n_channels = n_speakers + 2
        self.dtype = resolve_dtype(dtype)
        with torch.device("meta"):
            self.encoder = TransformerEncoder(frontend.input_dim, d_model, enc_layers, n_heads, d_ff, dropout)
            self.lookahead_conv = Conv1d(d_model, d_model, 2 * conv_delay + 1, padding=conv_delay)
            self.convert = Linear(2 * d_model, d_model)
            for i in range(dec_layers):
                self.add_module(f"fusion_{i}", FusionLayer(d_model, n_heads, dec_d_ff, dropout, mask_delay))
        self.dec_layers = dec_layers
        materialize_(self, device, seed)

    @property
    def device(self) -> torch.device:
        return self.convert.weight.device

    def forward(self, x, frame_mask=None, generator=None):
        x = frontend_features(x, self.frontend).to(self.dtype)
        B, T, _ = x.shape
        cm = make_causal_mask(T, self.mask_delay, x.device)
        emb = self.encoder(x, frame_mask, generator, attn_mask=cm)
        emb = L.l2_normalize(self.lookahead_conv(emb.transpose(1, 2)).transpose(1, 2))
        C, D = self.n_channels, emb.shape[-1]
        pe = torch.from_numpy(sinusoidal_position_encoding(C, D)).to(emb.device, emb.dtype)
        att = self.convert(torch.cat([emb[:, :, None].expand(B, T, C, D), pe[None, None].expand(B, T, C, D)], -1))
        for i in range(self.dec_layers):
            att = getattr(self, f"fusion_{i}")(att, generator)
        att = L.l2_normalize(att)
        logits = torch.einsum("btd,btcd->btc", emb, att).float()
        if frame_mask is not None:
            logits = logits * frame_mask[..., None]
        return logits, emb.float()


def fs_eend_labels(labels: torch.Tensor, frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference label protocol (fs_eend/model.py:62-79): speakers sorted by
    first appearance, then [silence ‖ speakers ‖ zero pad] → (B, T, S + 2).
    The sort is stable, as jnp.argsort: silent speakers (first frame ∞) and
    speakers that start on the same frame keep their order."""
    B, T, S = labels.shape
    idx = torch.arange(1, T + 1, dtype=torch.float32, device=labels.device)[None, :, None]
    first = torch.where(labels > 0, idx * labels, torch.full_like(labels, float("inf"))).amin(1)  # (B, S)
    order = torch.argsort(first, dim=-1, stable=True)
    sorted_labels = torch.gather(labels, 2, order[:, None, :].expand(B, T, S))
    silence = 1.0 - sorted_labels.amax(-1, keepdim=True)
    if frame_mask is not None:
        silence = silence * frame_mask[..., None]
    return torch.cat([silence, sorted_labels, torch.zeros_like(silence)], dim=-1)


def consistency_loss(emb: torch.Tensor, channel_labels: torch.Tensor, frame_mask=None) -> torch.Tensor:
    """MSE between the frame embeddings' cosine map and the labels' cosine
    map (reference fs_eend.py:57-70), over valid frame pairs."""
    en = L.l2_normalize(emb, eps=1e-6)
    ln = L.l2_normalize(channel_labels, eps=1e-6)
    e = (torch.einsum("btd,bsd->bts", en, en) - torch.einsum("btc,bsc->bts", ln, ln)) ** 2
    if frame_mask is None:
        return e.mean()
    m = frame_mask[:, :, None] * frame_mask[:, None, :]
    return batch_mean((e * m).sum(), m.sum())
