"""Post-norm transformer encoder layer, PyTorch.

Counterpart of speaker_diarization_tpu/models/transformer.py
(`sinusoidal_position_encoding`, `FeedForward`, `TransformerEncoderLayer`)
with the flax layer's numerics:

- attention is per-head q/k/v projections, q scaled by 1/sqrt(head_dim),
  softmax in the compute dtype, written as plain matmuls (the JAX layer is
  plain XLA too); flax keeps per-head kernels (D, H, Dh) and (H, Dh, D),
  which utils/convert.py flattens into these (D, D) Linear weights;
- LayerNorm uses eps = 1e-6 (flax's default, not torch's 1e-5), normalised
  in fp32 and cast back to the compute dtype;
- dropout is not applied: this port is inference-only so far.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as Fn

from .layers import Linear

LN_EPS = 1e-6


def sinusoidal_position_encoding(max_len: int, d_model: int) -> np.ndarray:
    """Standard sine/cosine positional table (reference models.py:129-155)."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


class LayerNorm(nn.LayerNorm):
    def __init__(self, d_model: int):
        super().__init__(d_model, eps=LN_EPS)

    def forward(self, x):
        return Fn.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps).to(x.dtype)


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.query = Linear(d_model, d_model)
        self.key = Linear(d_model, d_model)
        self.value = Linear(d_model, d_model)
        self.out = Linear(d_model, d_model)

    def forward(self, x):  # (B, T, D) self-attention, no mask
        B, T, D = x.shape
        H = self.n_heads
        q = self.query(x).view(B, T, H, D // H).transpose(1, 2)
        k = self.key(x).view(B, T, H, D // H).transpose(1, 2)
        v = self.value(x).view(B, T, H, D // H).transpose(1, 2)
        q = q / torch.tensor(math.sqrt(D // H), dtype=x.dtype)
        w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)  # (B, H, T, T)
        o = torch.matmul(w, v).transpose(1, 2).reshape(B, T, D)
        return self.out(o)


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.dense0 = Linear(d_model, d_ff)
        self.dense1 = Linear(d_ff, d_model)

    def forward(self, x):
        return self.dense1(torch.relu(self.dense0(x)))


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer (torch nn.TransformerEncoderLayer semantics)."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int):
        super().__init__()
        self.attn = MultiHeadAttention(d_model, n_heads)
        self.ln1 = LayerNorm(d_model)
        self.ff = FeedForward(d_model, d_ff)
        self.ln2 = LayerNorm(d_model)

    def forward(self, x):
        x = self.ln1(x + self.attn(x))
        return self.ln2(x + self.ff(x))
