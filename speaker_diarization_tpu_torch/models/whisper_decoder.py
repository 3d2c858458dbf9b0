"""Whisper text decoder and greedy conditioned generation, PyTorch.

Counterpart of speaker_diarization_tpu/models/whisper_decoder.py (the
decoder half of DiCoW, reference `egs/mlc_slm/dicow/`): token embeddings
plus learned positions from `position_offset` → N pre-norm blocks (causal
self-attention, cross-attention over the encoder states, GELU MLP) → final
LayerNorm → logits through the tied token embedding.

With the flax numerics: q and k both scaled by head_dim^-1/4, k without
bias; masked scores set to −1e9 and the softmax taken in fp32, cast back to
the compute dtype; LayerNorm eps 1e-5 with fp32 statistics. The logits are
taken as JAX takes them: h cast to fp32, then, as flax's `Embed.attend`
promotes both operands to the module's dtype, the product with the
embedding in the compute dtype, returned in fp32.

`greedy_decode` re-scores the whole prefix at each step, as JAX does (no
key/value cache), and pads with eos once a row has emitted it.
Submodules carry the flax names (`embed_tokens`, `embed_positions`,
`block_i.{self_attn_ln,self_attn,cross_attn_ln,cross_attn,mlp_ln,fc1,fc2}`,
`ln`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as Fn

from ..utils.device import resolve_dtype
from .eend import materialize_
from .layers import Linear
from .transformer import LayerNorm

MASKED = -1e9


@dataclass(frozen=True)
class WhisperDecoderConfig:
    vocab_size: int = 51865
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_positions: int = 448


class DecoderAttention(nn.Module):
    """Whisper attention over `kv` (cross) or x itself (self, causal if set)."""

    def __init__(self, d_model: int, n_heads: int, causal: bool = False):
        super().__init__()
        self.n_heads, self.causal = n_heads, causal
        self.q_proj = Linear(d_model, d_model)
        self.k_proj = Linear(d_model, d_model, bias=False)
        self.v_proj = Linear(d_model, d_model)
        self.out_proj = Linear(d_model, d_model)

    def forward(self, x, kv=None, kv_mask=None):
        mem = x if kv is None else kv
        B, T, D = x.shape
        S, H = mem.shape[1], self.n_heads
        hd = D // H
        q = self.q_proj(x).view(B, T, H, hd).transpose(1, 2) * hd**-0.25
        k = self.k_proj(mem).view(B, S, H, hd).transpose(1, 2) * hd**-0.25
        v = self.v_proj(mem).view(B, S, H, hd).transpose(1, 2)
        w = torch.matmul(q, k.transpose(-1, -2))
        if self.causal and kv is None:
            w = w.masked_fill(~torch.ones(T, S, dtype=torch.bool, device=x.device).tril(), MASKED)
        if kv_mask is not None:
            w = w.masked_fill(~kv_mask.bool()[:, None, None, :], MASKED)
        w = torch.softmax(w.float(), dim=-1).to(x.dtype)
        return self.out_proj(torch.matmul(w, v).transpose(1, 2).reshape(B, T, D))


class WhisperDecoderBlock(nn.Module):
    def __init__(self, cfg: WhisperDecoderConfig):
        super().__init__()
        self.self_attn_ln = LayerNorm(cfg.d_model, eps=1e-5)
        self.self_attn = DecoderAttention(cfg.d_model, cfg.n_heads, causal=True)
        self.cross_attn_ln = LayerNorm(cfg.d_model, eps=1e-5)
        self.cross_attn = DecoderAttention(cfg.d_model, cfg.n_heads)
        self.mlp_ln = LayerNorm(cfg.d_model, eps=1e-5)
        self.fc1 = Linear(cfg.d_model, cfg.d_ff)
        self.fc2 = Linear(cfg.d_ff, cfg.d_model)

    def forward(self, x, enc, enc_mask=None):
        x = x + self.self_attn(self.self_attn_ln(x))
        x = x + self.cross_attn(self.cross_attn_ln(x), kv=enc, kv_mask=enc_mask)
        return x + self.fc2(Fn.gelu(self.fc1(self.mlp_ln(x))))


class WhisperDecoder(nn.Module):
    """tokens (B, U) and encoder states (B, T, d_model) → logits (B, U,
    vocab) fp32. Built on `device` (None: CUDA, or raise without it) with
    weights drawn from `seed`; `embed_positions` starts N(0, 0.02) as in
    JAX."""

    def __init__(self, cfg: WhisperDecoderConfig = WhisperDecoderConfig(),
                 dtype: Union[str, torch.dtype] = torch.float32,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0):
        super().__init__()
        self.cfg, self.dtype = cfg, resolve_dtype(dtype)
        with torch.device("meta"):
            self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
            self.embed_positions = nn.Parameter(torch.empty(cfg.max_positions, cfg.d_model))
            for i in range(cfg.n_layers):
                self.add_module(f"block_{i}", WhisperDecoderBlock(cfg))
            self.ln = LayerNorm(cfg.d_model, eps=1e-5)
        materialize_(self, device, seed)
        with torch.no_grad():
            g = torch.Generator().manual_seed(seed + 1)
            self.embed_positions.copy_(0.02 * torch.randn(self.embed_positions.shape, generator=g))

    @property
    def device(self) -> torch.device:
        return self.embed_positions.device

    def forward(self, tokens: torch.Tensor, enc: torch.Tensor, enc_mask: Optional[torch.Tensor] = None,
                position_offset: int = 0) -> torch.Tensor:
        U, dt = tokens.shape[1], self.dtype
        h = self.embed_tokens.weight.to(dt)[tokens.long()]
        h = h + self.embed_positions[position_offset:position_offset + U].to(dt)[None]
        enc = enc.to(dt)
        for i in range(self.cfg.n_layers):
            h = getattr(self, f"block_{i}")(h, enc, enc_mask)
        h = self.ln(h)
        return torch.matmul(h.float().to(dt), self.embed_tokens.weight.to(dt).t()).float()


@torch.no_grad()
def greedy_decode(decoder: WhisperDecoder, enc: torch.Tensor, start_tokens, max_new_tokens: int,
                  eos_id: int) -> np.ndarray:
    """Greedy conditioned generation: re-scores the growing prefix each step.
    → (B, U_start + n) int32 token ids, n ≤ max_new_tokens (it stops once
    every row has emitted eos), padded with eos after a row's eos."""
    decoder.eval()
    tokens = np.asarray(start_tokens, np.int32)
    done = np.zeros((tokens.shape[0],), bool)
    for _ in range(max_new_tokens):
        logits = decoder(torch.from_numpy(tokens).to(decoder.device), enc)
        nxt = logits[:, -1].argmax(-1).cpu().numpy()
        nxt = np.where(done, eos_id, nxt)
        tokens = np.concatenate([tokens, nxt[:, None].astype(np.int32)], axis=1)
        done |= nxt == eos_id
        if done.all():
            break
    return tokens
