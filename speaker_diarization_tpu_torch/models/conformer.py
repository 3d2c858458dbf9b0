"""Conformer encoder blocks (macaron FF + MHSA + conv module), PyTorch.

Counterpart of speaker_diarization_tpu/models/conformer.py: the EEND-EDA
`encoder_type="conformer"` trunk and the TS-VAD `conformer` backend
(reference eend_eda/models.py:495-504, ts_vad2 'conformer_ots_vad'). Each
block is ½FF → MHSA → depthwise conv module (GLU, norm, swish) → ½FF → LN.

Submodules carry the flax module names (`ff1_ln`, `mhsa`, `conv.pw1`,
`conv.dw`, `conv.bn` | `conv.gn`, `block_0`, ...), so utils/convert.py maps
the JAX variables by name. flax numerics: LayerNorm and GroupNorm use eps
1e-6 and normalise in fp32; the conv module's BatchNorm is flax's
(models/layers.BatchNorm, batch statistics in train mode); the attention
is the port's MultiHeadAttention (flax MultiHeadDotProductAttention,
dropout on the attention weights); in train mode dropout masks come from
the caller's torch.Generator.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as Fn

from .layers import BatchNorm, Conv1d, Linear, dropout as drop
from .transformer import LN_EPS, LayerNorm, MultiHeadAttention, make_padding_mask, sinusoidal_position_encoding


class GroupNorm1(nn.GroupNorm):
    """flax GroupNorm(num_groups=1) on (B, C, T): one mean and variance per
    item over all of T and C, eps 1e-6, in fp32."""

    def __init__(self, channels: int):
        super().__init__(1, channels, eps=LN_EPS)

    def forward(self, x):
        return Fn.group_norm(x.float(), 1, self.weight, self.bias, self.eps).to(x.dtype)


class ConformerConvModule(nn.Module):
    """LN → pointwise to 2d → GLU → depthwise conv → BatchNorm (`batch`) or
    GroupNorm (`group`) → swish → pointwise → dropout, on (B, T, d)."""

    def __init__(self, d: int, kernel_size: int = 15, dropout: float = 0.1, conv_norm: str = "batch"):
        super().__init__()
        if conv_norm not in ("batch", "group"):
            raise ValueError(f"conv_norm must be batch|group, got {conv_norm!r}")
        self.LayerNorm_0 = LayerNorm(d)
        self.pw1 = Linear(d, 2 * d)
        self.dw = Conv1d(d, d, kernel_size, padding=(kernel_size - 1) // 2, groups=d)
        if conv_norm == "batch":
            self.bn = BatchNorm(d)
        else:
            self.gn = GroupNorm1(d)
        self.pw2 = Linear(d, d)
        self.dropout = dropout

    def forward(self, x, generator=None):
        a, b = self.pw1(self.LayerNorm_0(x)).chunk(2, dim=-1)
        h = self.dw((a * torch.sigmoid(b)).transpose(1, 2))  # GLU, then (B, d, T)
        h = self.bn(h) if hasattr(self, "bn") else self.gn(h)
        h = (h * torch.sigmoid(h)).transpose(1, 2)  # swish
        return drop(self.pw2(h), self.dropout, self.training, generator)


class ConformerBlock(nn.Module):
    def __init__(self, d: int, n_heads: int = 4, d_ff: int = 1024, conv_kernel: int = 15, dropout: float = 0.1,
                 conv_norm: str = "batch"):
        super().__init__()
        for name in ("ff1", "ff2"):
            setattr(self, f"{name}_ln", LayerNorm(d))
            setattr(self, f"{name}_1", Linear(d, d_ff))
            setattr(self, f"{name}_2", Linear(d_ff, d))
        self.mhsa_ln = LayerNorm(d)
        self.mhsa = MultiHeadAttention(d, n_heads, dropout)
        self.conv = ConformerConvModule(d, conv_kernel, dropout, conv_norm)
        self.final_ln = LayerNorm(d)
        self.dropout = dropout

    def _ff(self, name: str, x, generator):
        p, on = self.dropout, self.training
        h = getattr(self, f"{name}_1")(getattr(self, f"{name}_ln")(x))
        h = drop(h * torch.sigmoid(h), p, on, generator)
        return drop(getattr(self, f"{name}_2")(h), p, on, generator)

    def forward(self, x, generator=None, mask=None):
        x = x + 0.5 * self._ff("ff1", x, generator)
        x = x + drop(self.mhsa(self.mhsa_ln(x), generator, mask), self.dropout, self.training, generator)
        x = x + self.conv(x, generator)
        x = x + 0.5 * self._ff("ff2", x, generator)
        return self.final_ln(x)


class ConformerEncoder(nn.Module):
    """Input projection (+ sinusoidal positions when `has_pos`) + N conformer
    blocks; padded frames are masked out of attention and zeroed at the
    output. (B, T, in_dim) → (B, T, d_model)."""

    def __init__(self, in_dim: int, d_model: int = 256, n_layers: int = 4, n_heads: int = 4, d_ff: int = 1024,
                 conv_kernel: int = 15, dropout: float = 0.1, conv_norm: str = "batch", has_pos: bool = True,
                 max_len: int = 8192):
        super().__init__()
        self.input_proj = Linear(in_dim, d_model)
        for i in range(n_layers):
            self.add_module(f"block_{i}", ConformerBlock(d_model, n_heads, d_ff, conv_kernel, dropout, conv_norm))
        self.n_layers = n_layers
        self.has_pos = has_pos
        self.max_len = max_len

    def forward(self, x, frame_mask=None, generator=None):
        h = self.input_proj(x)
        if self.has_pos:  # the first T rows of the max_len table: each row depends on its position only
            if h.shape[1] > self.max_len:
                raise ValueError(f"{h.shape[1]} frames exceed the positional table's {self.max_len}")
            pe = torch.from_numpy(sinusoidal_position_encoding(h.shape[1], h.shape[-1]))
            h = h + pe.to(h.device, h.dtype)[None]
        mask = None if frame_mask is None else make_padding_mask(frame_mask)
        for i in range(self.n_layers):
            h = getattr(self, f"block_{i}")(h, generator, mask)
        if frame_mask is not None:
            h = h * frame_mask[..., None].to(h.dtype)
        return h
