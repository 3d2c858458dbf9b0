"""w2v-BERT 2.0 conformer encoder, PyTorch.

Counterpart of speaker_diarization_tpu/models/w2vbert.py (reference TS-VAD
`speech_encoder_type=w2v-bert2`, model.py:418-448, 831-841; the transformers
Wav2Vec2BertModel): 80-bin fbank frames paired to 160-d features at 50 Hz
→ LayerNorm → projection → conformer layers of macaron half-step FFNs
(swish), self-attention with a Shaw relative-key bias (a learned
`distance_embedding` indexed by the clipped distance, added as
q·pe / sqrt(head_dim)), a conv module (LayerNorm, pointwise conv, GLU over
channels, a causal depthwise conv padded k − 1 on the left, LayerNorm,
swish, pointwise conv) and a final LayerNorm.

Submodules carry the flax names (`fp_layer_norm`, `fp_projection`,
`layer_i.{ffn1,ffn1_layer_norm,self_attn,self_attn_layer_norm,conv_module,
ffn2,ffn2_layer_norm,final_layer_norm}`), so utils/convert.w2vbert_from_flax
maps the JAX variables by name. Activations are (B, T, C).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as Fn

from .layers import Conv1d, Linear
from .transformer import LayerNorm


@dataclass(frozen=True)
class W2vBertConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    feature_input_dim: int = 160  # 2 × 80 fbank bins
    conv_kernel: int = 31
    left_max_pos: int = 64
    right_max_pos: int = 8


def swish(x):
    return x * torch.sigmoid(x)


class W2vBertFFN(nn.Module):
    def __init__(self, cfg: W2vBertConfig):
        super().__init__()
        self.intermediate_dense = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.output_dense(swish(self.intermediate_dense(x)))


class W2vBertAttention(nn.Module):
    def __init__(self, cfg: W2vBertConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        for n in ("linear_q", "linear_k", "linear_v", "linear_out"):
            self.add_module(n, Linear(D, D))
        self.distance_embedding = nn.Parameter(
            torch.zeros(cfg.left_max_pos + cfg.right_max_pos + 1, D // cfg.num_heads))
        self._dist: Dict[Tuple[int, str], torch.Tensor] = {}

    def _distances(self, T: int, device) -> torch.Tensor:
        """(T, T) row indices of `distance_embedding`: the key-minus-query
        distance clipped to [−left_max_pos, right_max_pos], shifted to 0."""
        c, key = self.cfg, (T, str(device))
        if key not in self._dist:
            d = np.clip(np.arange(T)[None, :] - np.arange(T)[:, None], -c.left_max_pos, c.right_max_pos)
            self._dist[key] = torch.from_numpy(d + c.left_max_pos).to(device)
        return self._dist[key]

    def forward(self, x):
        B, T, D = x.shape
        H = self.cfg.num_heads
        hd = D // H
        q = self.linear_q(x).view(B, T, H, hd).transpose(1, 2)
        k = self.linear_k(x).view(B, T, H, hd).transpose(1, 2)
        v = self.linear_v(x).view(B, T, H, hd).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        pe = self.distance_embedding[self._distances(T, x.device)].to(q.dtype)  # (T, T, hd)
        scores = scores + torch.einsum("bhld,lrd->bhlr", q, pe) / math.sqrt(hd)
        probs = torch.softmax(scores, dim=-1)
        return self.linear_out(torch.matmul(probs, v).transpose(1, 2).reshape(B, T, D))


class W2vBertConvModule(nn.Module):
    def __init__(self, cfg: W2vBertConfig):
        super().__init__()
        D = cfg.hidden_size
        self.kernel = cfg.conv_kernel
        self.layer_norm = LayerNorm(D, eps=1e-5)
        self.pointwise_conv1 = Conv1d(D, 2 * D, 1, bias=False)
        self.depthwise_conv = Conv1d(D, D, cfg.conv_kernel, groups=D, bias=False)
        self.depthwise_layer_norm = LayerNorm(D, eps=1e-5)
        self.pointwise_conv2 = Conv1d(D, D, 1, bias=False)

    def forward(self, x):
        h = self.pointwise_conv1(self.layer_norm(x).transpose(1, 2))
        a, b = h.chunk(2, dim=1)
        h = Fn.pad(a * torch.sigmoid(b), (self.kernel - 1, 0))  # GLU, then causal
        h = self.depthwise_layer_norm(self.depthwise_conv(h).transpose(1, 2))
        return self.pointwise_conv2(swish(h).transpose(1, 2)).transpose(1, 2)


class W2vBertLayer(nn.Module):
    def __init__(self, cfg: W2vBertConfig):
        super().__init__()
        D = cfg.hidden_size
        self.ffn1_layer_norm = LayerNorm(D, eps=1e-5)
        self.ffn1 = W2vBertFFN(cfg)
        self.self_attn_layer_norm = LayerNorm(D, eps=1e-5)
        self.self_attn = W2vBertAttention(cfg)
        self.conv_module = W2vBertConvModule(cfg)
        self.ffn2_layer_norm = LayerNorm(D, eps=1e-5)
        self.ffn2 = W2vBertFFN(cfg)
        self.final_layer_norm = LayerNorm(D, eps=1e-5)

    def forward(self, x):
        x = x + 0.5 * self.ffn1(self.ffn1_layer_norm(x))
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        x = x + self.conv_module(x)
        x = x + 0.5 * self.ffn2(self.ffn2_layer_norm(x))
        return self.final_layer_norm(x)


class W2vBertModel(nn.Module):
    """features (B, T50, feature_input_dim), 80-d fbank pairs, in the compute
    dtype → hidden states (B, T50, hidden_size)."""

    def __init__(self, cfg: W2vBertConfig = W2vBertConfig()):
        super().__init__()
        self.cfg = cfg
        self.fp_layer_norm = LayerNorm(cfg.feature_input_dim, eps=1e-5)
        self.fp_projection = Linear(cfg.feature_input_dim, cfg.hidden_size)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", W2vBertLayer(cfg))
        self.out_channels = cfg.hidden_size

    def forward(self, features):
        h = self.fp_projection(self.fp_layer_norm(features))
        for i in range(self.cfg.num_layers):
            h = getattr(self, f"layer_{i}")(h)
        return h


def fbank_to_w2vbert_features(fbank: torch.Tensor) -> torch.Tensor:
    """(B, T100, 80) fbank → (B, T100 // 2, 160) paired features (reference
    model.py:831-834 reshape)."""
    B, T, Fd = fbank.shape
    T2 = T // 2
    return fbank[:, : 2 * T2].reshape(B, T2, 2 * Fd)
