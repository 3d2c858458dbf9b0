"""WavLM SSL speech encoder with gated relative position bias, PyTorch.

Counterpart of speaker_diarization_tpu/models/wavlm.py (reference
ts_vad2/wavlm.py + modules.py): a 7-layer conv waveform extractor (20 ms
frames at 50 Hz; GroupNorm with one group per channel on layer 0) →
LayerNorm → projection → grouped conv positional embedding (kernel 128, 16
groups; its even kernel drops the trailing frame) → LayerNorm → post-norm
transformer layers. With `relative_position_embedding` the layers share a
T5-bucket relative attention bias, scaled per layer and head by WavLM's GRU
gate (`gru_rel_pos`), computed from the raw layer input split per head, not
from the projected query. HuBERT, wav2vec2 and MMS are the same trunk with
`relative_position_embedding=False, gru_rel_pos=False`.

Submodules carry the flax names (`feature_extractor.conv_i`, `gn0`,
`layer_norm`, `post_extract_proj`, `pos_conv`, `encoder_layer_norm`,
`layer_i.self_attn.{q,k,v,out}_proj`, `grep_linear`, `grep_a`,
`relative_attention_bias`), so utils/convert.wavlm_from_flax maps the JAX
variables by name. Activations are (B, T, C); the convs run (B, C, T).
Parameters are fp32; the trunk computes in `dtype`, normalisations in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as Fn

from ..utils.device import resolve_dtype
from .layers import Conv1d, Linear
from .transformer import LayerNorm


@dataclass(frozen=True)
class WavLMFlaxConfig:
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 2, 2), (512, 2, 2),
    )
    conv_pos: int = 128
    conv_pos_groups: int = 16
    relative_position_embedding: bool = True
    num_buckets: int = 320
    max_distance: int = 800
    gru_rel_pos: bool = True
    normalize: bool = False  # Base+: False; Large: True
    dropout: float = 0.1


def relative_position_bucket(relative_positions: np.ndarray, num_buckets: int, max_distance: int) -> np.ndarray:
    """T5 bidirectional bucketing (modules.py:417-447), on the host."""
    nb = num_buckets // 2
    out = (relative_positions > 0).astype(np.int64) * nb
    rp = np.abs(relative_positions)
    max_exact = nb // 2
    is_small = rp < max_exact
    large = max_exact + (
        np.log(np.maximum(rp, 1) / max_exact) / np.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return out + np.where(is_small, rp, large)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over (B, C, T), normalised in fp32 and cast back."""

    def forward(self, x):
        return Fn.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps).to(x.dtype)


class ConvFeatureExtractor(nn.Module):
    """(B, N) waveform → (B, T50, 512): VALID convs without bias, GELU."""

    def __init__(self, layers: Tuple[Tuple[int, int, int], ...]):
        super().__init__()
        d_in = 1
        for i, (dim, k, stride) in enumerate(layers):
            self.add_module(f"conv_{i}", Conv1d(d_in, dim, k, stride=stride, bias=False))
            d_in = dim
        self.gn0 = GroupNorm(layers[0][0], layers[0][0], eps=1e-5)  # 'default' mode: layer 0 only
        self.n_layers = len(layers)

    def forward(self, x):
        h = x[:, None, :]
        for i in range(self.n_layers):
            h = getattr(self, f"conv_{i}")(h)
            if i == 0:
                h = self.gn0(h)
            h = Fn.gelu(h)
        return h.transpose(1, 2)


class WavLMAttention(nn.Module):
    """Self-attention with the shared relative bias and per-layer GRU gating."""

    def __init__(self, d_model: int, n_heads: int, gru_rel_pos: bool):
        super().__init__()
        self.n_heads = n_heads
        self.gru_rel_pos = gru_rel_pos
        self.q_proj = Linear(d_model, d_model)
        self.k_proj = Linear(d_model, d_model)
        self.v_proj = Linear(d_model, d_model)
        self.out_proj = Linear(d_model, d_model)
        if gru_rel_pos:
            self.grep_linear = Linear(d_model // n_heads, 8)
            self.grep_a = nn.Parameter(torch.ones(1, n_heads, 1, 1))

    def forward(self, x, pos_bias: Optional[torch.Tensor] = None):
        B, T, D = x.shape
        H = self.n_heads
        hd = D // H
        q = (self.q_proj(x) * hd**-0.5).view(B, T, H, hd).transpose(1, 2)
        k = self.k_proj(x).view(B, T, H, hd).transpose(1, 2)
        v = self.v_proj(x).view(B, T, H, hd).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2))
        if pos_bias is not None:
            bias = pos_bias[None]  # (1, H, T, T), fp32
            if self.gru_rel_pos:
                # the gate reads the raw layer input split per head (modules.py:533-543)
                g = self.grep_linear(x.view(B, T, H, hd).transpose(1, 2))  # (B, H, T, 8)
                gate = torch.sigmoid(g.view(B, H, T, 2, 4).sum(-1))
                gate_a, gate_b = gate[..., 0:1], gate[..., 1:2]
                bias = (gate_a * (gate_b * self.grep_a - 1.0) + 2.0) * bias
            logits = logits.float() + bias  # fp32, as JAX promotes the bf16 scores
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, D)
        return self.out_proj(out)


class WavLMEncoderLayer(nn.Module):
    """Post-norm layer (layer_norm_first=False, the Base+ setting)."""

    def __init__(self, cfg: WavLMFlaxConfig):
        super().__init__()
        D = cfg.encoder_embed_dim
        self.self_attn = WavLMAttention(D, cfg.encoder_attention_heads, cfg.gru_rel_pos)
        self.self_attn_layer_norm = LayerNorm(D, eps=1e-5)
        self.fc1 = Linear(D, cfg.encoder_ffn_embed_dim)
        self.fc2 = Linear(cfg.encoder_ffn_embed_dim, D)
        self.final_layer_norm = LayerNorm(D, eps=1e-5)

    def forward(self, x, pos_bias=None):
        x = self.self_attn_layer_norm(x + self.self_attn(x, pos_bias))
        return self.final_layer_norm(x + self.fc2(Fn.gelu(self.fc1(x))))


class WavLMModel(nn.Module):
    """(B, N) waveform → (B, T50, encoder_embed_dim); `extract_features`
    with `ret_layer_results` also returns every layer's output, the
    projected input first. `dtype` is the compute dtype."""

    def __init__(self, cfg: WavLMFlaxConfig = WavLMFlaxConfig(), dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = resolve_dtype(dtype)
        D = c.encoder_embed_dim
        self.feature_extractor = ConvFeatureExtractor(c.conv_feature_layers)
        feat = c.conv_feature_layers[-1][0]
        self.layer_norm = LayerNorm(feat, eps=1e-5)
        self.post_extract_proj = Linear(feat, D)
        self.pos_conv = Conv1d(D, D, c.conv_pos, padding=c.conv_pos // 2, groups=c.conv_pos_groups)
        self.encoder_layer_norm = LayerNorm(D, eps=1e-5)
        for i in range(c.encoder_layers):
            self.add_module(f"layer_{i}", WavLMEncoderLayer(c))
        if c.relative_position_embedding:
            self.relative_attention_bias = nn.Parameter(torch.zeros(c.num_buckets, c.encoder_attention_heads))
        self.out_channels = D
        self._buckets: Dict[Tuple[int, str], torch.Tensor] = {}

    def _pos_bias(self, T: int, device) -> Optional[torch.Tensor]:
        c = self.cfg
        if not c.relative_position_embedding:
            return None
        key = (T, str(device))
        if key not in self._buckets:
            b = relative_position_bucket(np.arange(T)[None, :] - np.arange(T)[:, None], c.num_buckets, c.max_distance)
            self._buckets[key] = torch.from_numpy(b).to(device)
        return self.relative_attention_bias[self._buckets[key]].permute(2, 0, 1)  # (H, T, T)

    def extract_features(self, source: torch.Tensor, ret_layer_results: bool = False):
        """(reference WavLM.extract_features, wavlm.py:359-434)"""
        c = self.cfg
        if c.normalize:
            mu = source.mean(dim=-1, keepdim=True)
            sd = source.std(dim=-1, unbiased=False, keepdim=True)
            source = (source - mu) / (sd + 1e-5)
        feats = self.layer_norm(self.feature_extractor(source.to(self.dtype)))
        x = self.post_extract_proj(feats)
        pc = self.pos_conv(x.transpose(1, 2)).transpose(1, 2)
        if c.conv_pos % 2 == 0:  # SamePad: an even kernel gives one frame more
            pc = pc[:, : x.shape[1]]
        x = self.encoder_layer_norm(x + Fn.gelu(pc))
        pos_bias = self._pos_bias(x.shape[1], x.device)
        layer_results: List[torch.Tensor] = [x]
        for i in range(c.encoder_layers):
            x = getattr(self, f"layer_{i}")(x, pos_bias)
            layer_results.append(x)
        return (x, layer_results) if ret_layer_results else x

    def forward(self, source):
        return self.extract_features(source)
