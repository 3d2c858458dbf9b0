"""Whisper audio encoder and its log-mel front-end, PyTorch.

Counterpart of speaker_diarization_tpu/models/whisper_encoder.py (reference
ts_vad2/whisper_encoder.py, the OpenAI AudioEncoder as a TS-VAD speech
encoder): log-mel (10 ms hop) → conv k3 + GELU → conv k3 stride 2 + GELU →
+ the `embed_positions` table → pre-norm attention blocks (q and k both
scaled by head_dim^-1/4, k without bias) → 50 Hz frames.

`whisper_log_mel` is plain PyTorch (the JAX function is plain JAX, not the
front-end kernel): the port's centred framing, periodic hann, DFT and slaney
mel (`ops.features.logmel_frames_torch` without mean-norm), then the
per-utterance dynamic-range clamp at max − 8 over (T, mels) and (x + 4) / 4.

With `layer_st`/`layer_ed` set the encoder returns the concatenated outputs
of blocks layer_st..layer_ed, LayerNorm'd by `ln_post2`. The JAX module
runs all n_layers blocks and XLA drops the unused ones as dead code; this
one stops after layer_ed, and keeps the later blocks' parameters so weights
carry across both ways (their gradients are zero in both packages).
Submodules carry the flax names (`conv1`, `conv2`, `embed_positions`,
`block_i.{attn_ln,attn,mlp_ln,fc1,fc2}`, `ln_post`, `ln_post2`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch
import torch.nn as nn
import torch.nn.functional as Fn

from ..ops import features as F
from ..utils.device import resolve_dtype
from .layers import Conv1d, Linear
from .transformer import LayerNorm, sinusoidal_position_encoding


@dataclass(frozen=True)
class WhisperEncoderConfig:
    n_mels: int = 80
    n_ctx: int = 1500  # max frames after conv stride 2 (30 s)
    d_model: int = 512  # base
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048


def whisper_log_mel(audio: torch.Tensor, n_mels: int = 80, sample_rate: int = 16000) -> torch.Tensor:
    """(B, N) → (B, T, n_mels) fp32: stft(400/160, hann) → slaney mel →
    log10 with the dynamic-range clamp → (x + 4) / 4."""
    n_frames = F.count_frames(audio.shape[-1], 160)
    logspec = F.logmel_frames_torch(audio, n_frames, 400, 160, sample_rate, n_mels, mean_norm=False)
    logspec = torch.maximum(logspec, logspec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (logspec + 4.0) / 4.0


class WhisperAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = Linear(d_model, d_model)
        self.k_proj = Linear(d_model, d_model, bias=False)
        self.v_proj = Linear(d_model, d_model)
        self.out_proj = Linear(d_model, d_model)

    def forward(self, x):
        B, T, D = x.shape
        H = self.n_heads
        hd = D // H
        scale = hd**-0.25
        q = self.q_proj(x).view(B, T, H, hd).transpose(1, 2) * scale
        k = self.k_proj(x).view(B, T, H, hd).transpose(1, 2) * scale
        v = self.v_proj(x).view(B, T, H, hd).transpose(1, 2)
        w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
        return self.out_proj(torch.matmul(w, v).transpose(1, 2).reshape(B, T, D))


class WhisperEncoderBlock(nn.Module):
    def __init__(self, cfg: WhisperEncoderConfig):
        super().__init__()
        self.attn_ln = LayerNorm(cfg.d_model, eps=1e-5)
        self.attn = WhisperAttention(cfg.d_model, cfg.n_heads)
        self.mlp_ln = LayerNorm(cfg.d_model, eps=1e-5)
        self.fc1 = Linear(cfg.d_model, cfg.d_ff)
        self.fc2 = Linear(cfg.d_ff, cfg.d_model)

    def forward(self, x):
        x = x + self.attn(self.attn_ln(x))
        return x + self.fc2(Fn.gelu(self.fc1(self.mlp_ln(x))))


class WhisperEncoder(nn.Module):
    """mel (B, T100, n_mels) or audio (B, N) → (B, T50, d_model), or
    (B, T50, d_model·(layer_ed − layer_st + 1)) in layer-concat mode.
    `dtype` is the compute dtype (the log-mel runs in fp32)."""

    def __init__(self, cfg: WhisperEncoderConfig = WhisperEncoderConfig(), layer_st: int = -1, layer_ed: int = -1,
                 layer_concat_ln: bool = True, dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = resolve_dtype(dtype)
        self.collect = layer_st >= 0 and layer_ed >= layer_st
        if self.collect and layer_ed >= c.n_layers:
            raise ValueError(f"layer_ed {layer_ed} >= n_layers {c.n_layers}")
        self.layer_st, self.layer_ed = layer_st, layer_ed
        self.conv1 = Conv1d(c.n_mels, c.d_model, 3, padding=1)
        self.conv2 = Conv1d(c.d_model, c.d_model, 3, stride=2, padding=1)
        self.embed_positions = nn.Parameter(torch.zeros(c.n_ctx, c.d_model))
        for i in range(c.n_layers):
            self.add_module(f"block_{i}", WhisperEncoderBlock(c))
        if not self.collect:
            self.ln_post = LayerNorm(c.d_model, eps=1e-5)
            self.out_channels = c.d_model
        else:
            self.out_channels = c.d_model * (layer_ed - layer_st + 1)
            if layer_concat_ln:
                self.ln_post2 = LayerNorm(self.out_channels, eps=1e-5)

    def reset_positions_(self) -> None:
        """The flax initializer of `embed_positions`: the sinusoidal table."""
        c = self.cfg
        with torch.no_grad():
            self.embed_positions.copy_(torch.from_numpy(sinusoidal_position_encoding(c.n_ctx, c.d_model)))

    def forward(self, mel_or_audio: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        mel = whisper_log_mel(mel_or_audio, c.n_mels) if mel_or_audio.dim() == 2 else mel_or_audio
        h = Fn.gelu(self.conv1(mel.to(self.dtype).transpose(1, 2)))
        h = Fn.gelu(self.conv2(h)).transpose(1, 2)
        h = h + self.embed_positions[None, : h.shape[1]].to(h.dtype)
        if not self.collect:
            for i in range(c.n_layers):
                h = getattr(self, f"block_{i}")(h)
            return self.ln_post(h)
        collected = []
        for i in range(self.layer_ed + 1):  # the blocks after layer_ed feed nothing
            h = getattr(self, f"block_{i}")(h)
            if i >= self.layer_st:
                collected.append(h)
        cat = torch.cat(collected, dim=-1)
        return self.ln_post2(cat) if hasattr(self, "ln_post2") else cat
