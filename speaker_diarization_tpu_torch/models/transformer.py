"""Post-norm transformer encoder, PyTorch.

Counterpart of speaker_diarization_tpu/models/transformer.py
(`sinusoidal_position_encoding`, `make_padding_mask`, `make_chunk_mask`,
`FeedForward`, `TransformerEncoderLayer`, `TransformerEncoder`) with the
flax numerics:

- attention is per-head q/k/v projections, q scaled by 1/sqrt(head_dim),
  softmax in the compute dtype, written as plain matmuls (the JAX layer is
  plain XLA too); flax keeps per-head kernels (D, H, Dh) and (H, Dh, D),
  which utils/convert.py flattens into these (D, D) Linear weights;
- LayerNorm uses eps = 1e-6 (flax's default, not torch's 1e-5), normalised
  in fp32 and cast back to the compute dtype;
- in train mode dropout (rate `dropout`) sits where flax puts it: on the
  attention weights, after the FFN activation, and on both residual
  branches; its masks come from an explicit torch.Generator;
- a boolean attention mask (True = attend) fills masked scores with the
  dtype's most negative finite value, as flax does, not -inf: a query row
  with no valid key (a padded frame) gets a uniform softmax, never NaN.

`MultiHeadAttention` and `FeedForward` have a tensor-parallel mode, set by
`parallel.mesh.shard_params` (`tp`, the model group): q, k and v hold this
rank's heads (column-parallel) and `out` the matching input columns
(row-parallel); the FFN's first Linear holds a slice of d_ff and the second
the matching columns. The input enters through `copy_to_model` and the
row-parallel product leaves through `reduce_from_model` (Megatron's pair),
and the row-parallel bias is added once, after the sum.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as Fn

from ..parallel.collectives import copy_to_model, reduce_from_model
from .layers import Linear, dropout as drop, remat as _remat

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
    def __init__(self, d_model: int, eps: float = LN_EPS):
        super().__init__(d_model, eps=eps)

    def forward(self, x):
        return Fn.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps).to(x.dtype)


def _row_parallel(x, linear: Linear, tp):
    """`linear(x)` whose input columns are split over the model group: the
    partial products summed over the group, then the bias."""
    y = reduce_from_model(Fn.linear(x, linear.weight.to(x.dtype)), tp)
    return y if linear.bias is None else y + linear.bias.to(x.dtype)


class MultiHeadAttention(nn.Module):
    tp = None  # the model group when its heads are sharded (parallel.mesh.shard_params)

    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.0):
        super().__init__()
        self.n_heads = n_heads
        self.head_dim = d_model // n_heads
        self.dropout = dropout
        self.query = Linear(d_model, d_model)
        self.key = Linear(d_model, d_model)
        self.value = Linear(d_model, d_model)
        self.out = Linear(d_model, d_model)

    def forward(self, x, generator=None, mask=None):
        """(B, T, D) self-attention; `mask` (B|1, 1, T, T) bool, True = attend."""
        return self.attend(x, x, x, generator, mask)

    def attend(self, x_q, x_k, x_v, generator=None, mask=None):
        """flax `MultiHeadDotProductAttention(x_q, x_k, x_v)`: queries (B, Tq, D)
        over keys (B, Tk, D) and values (B, Tk, D); `mask` (B|1, 1|H, Tq, Tk)
        bool, True = attend."""
        B, Tq, _ = x_q.shape
        Tk, hd = x_k.shape[1], self.head_dim
        if self.tp is not None:  # this rank's heads
            x_q, x_k, x_v = (copy_to_model(t, self.tp) for t in (x_q, x_k, x_v))
        q = self.query(x_q)
        H = q.shape[-1] // hd
        q = q.view(B, Tq, H, hd).transpose(1, 2)
        k = self.key(x_k).view(B, Tk, H, hd).transpose(1, 2)
        v = self.value(x_v).view(B, Tk, H, hd).transpose(1, 2)
        q = q / torch.tensor(math.sqrt(hd), dtype=x_q.dtype)
        s = torch.matmul(q, k.transpose(-1, -2))  # (B, H, Tq, Tk)
        if mask is not None:
            s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
        w = torch.softmax(s, dim=-1)
        w = drop(w, self.dropout, self.training, generator)
        o = torch.matmul(w, v).transpose(1, 2).reshape(B, Tq, H * hd)
        return self.out(o) if self.tp is None else _row_parallel(o, self.out, self.tp)


class FeedForward(nn.Module):
    tp = None  # the model group when d_ff is sharded (parallel.mesh.shard_params)

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.0):
        super().__init__()
        self.dense0 = Linear(d_model, d_ff)
        self.dense1 = Linear(d_ff, d_model)
        self.dropout = dropout

    def forward(self, x, generator=None):
        if self.tp is None:
            return self.dense1(drop(torch.relu(self.dense0(x)), self.dropout, self.training, generator))
        h = drop(torch.relu(self.dense0(copy_to_model(x, self.tp))), self.dropout, self.training, generator)
        return _row_parallel(h, self.dense1, self.tp)


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer (torch nn.TransformerEncoderLayer semantics)."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float = 0.0):
        super().__init__()
        self.attn = MultiHeadAttention(d_model, n_heads, dropout)
        self.ln1 = LayerNorm(d_model)
        self.ff = FeedForward(d_model, d_ff, dropout)
        self.ln2 = LayerNorm(d_model)
        self.dropout = dropout

    def forward(self, x, generator=None, mask=None):
        p, on = self.dropout, self.training
        x = self.ln1(x + drop(self.attn(x, generator, mask), p, on, generator))
        return self.ln2(x + drop(self.ff(x, generator), p, on, generator))


def make_padding_mask(frame_mask: torch.Tensor) -> torch.Tensor:
    """(B, T) validity → (B, 1, T, T) attention mask (True = attend)."""
    m = frame_mask.bool()
    return m[:, None, :, None] & m[:, None, None, :]


def make_causal_mask(T: int, delay: int = 0, device=None) -> torch.Tensor:
    """(1, 1, T, T) causal mask with a look-ahead of `delay` frames (True = attend)."""
    i = torch.arange(T, device=device)
    return (i[None, :] <= i[:, None] + delay)[None, None]


def make_chunk_mask(T: int, chunk_size: int, num_left_chunks: int = -1, device=None) -> torch.Tensor:
    """WeNet-style chunk attention mask (reference ts_vad2_streaming/mask.py:137):
    a frame attends within its chunk and to `num_left_chunks` earlier chunks
    (-1: all history). → (1, 1, T, T) bool, True = attend."""
    chunk_of = torch.arange(T, device=device) // chunk_size
    ci, cj = chunk_of[:, None], chunk_of[None, :]
    ok = cj <= ci
    if num_left_chunks >= 0:
        ok = ok & (cj >= ci - num_left_chunks)
    return ok[None, None]


class TransformerEncoder(nn.Module):
    """Input projection + LayerNorm (+ sinusoidal positions when `has_pos`)
    + N post-norm self-attention layers; padded frames are masked out of
    attention and zeroed at the output. The EEND family's trunk. `remat`
    recomputes each layer's activations in the backward pass (JAX
    `nn.remat` of each layer)."""

    def __init__(self, in_dim: int, d_model: int = 256, n_layers: int = 4, n_heads: int = 4, d_ff: int = 2048,
                 dropout: float = 0.0, has_pos: bool = False, max_len: int = 8192, remat: bool = False):
        super().__init__()
        self.input_proj = Linear(in_dim, d_model)
        self.input_norm = LayerNorm(d_model)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(d_model, n_heads, d_ff, dropout))
        self.n_layers = n_layers
        self.has_pos = has_pos
        self.max_len = max_len
        self.remat = remat

    def forward(self, x, frame_mask=None, generator=None, attn_mask=None):
        """(B, T, in_dim) → (B, T, d_model); frame_mask (B, T) 1 = valid;
        attn_mask an extra (1|B, 1, T, T) bool mask (causal, chunk), True =
        attend, combined with the padding mask as JAX's `attn_mask=`."""
        mask = None if frame_mask is None else make_padding_mask(frame_mask)
        if attn_mask is not None:
            mask = attn_mask if mask is None else mask & attn_mask
        h = self.input_norm(self.input_proj(x))
        if self.has_pos:
            pe = torch.from_numpy(sinusoidal_position_encoding(self.max_len, h.shape[-1])[: h.shape[1]])
            h = h + pe.to(h.device, h.dtype)[None]
        for i in range(self.n_layers):
            layer = getattr(self, f"layer_{i}")
            if self.remat and torch.is_grad_enabled():
                h = _remat(layer, h, generator, mask, generator=generator)
            else:
                h = layer(h, generator, mask)
        if frame_mask is not None:
            h = h * frame_mask[..., None].to(h.dtype)
        return h
