"""Streaming TS-VAD: chunk-masked training, cache-based chunk-by-chunk decode.

Counterpart of speaker_diarization_tpu/models/streaming_tsvad.py (reference
egs/alimeeting/ts_vad2_streaming/model.py, WeNet-style):

  audio (B, N) → kaldi fbank @100 Hz (mean-norm; the K1 kernel on CUDA)
  → Conv2d ×2 (3×3, stride 2) subsampling → 25 Hz → Linear → speaker dim
  → per speaker: [target ‖ mix] (→ Linear to d_model when 2·spk ≠ d_model)
  → post-norm transformer with a chunk attention mask ("single backend",
    speakers folded into the batch) → speakers stacked → Linear
  → chunk-masked transformer ("multi backend") → Linear → (B, T25, S) logits

Each layer has explicit Q/K/V projections (flax DenseGeneral kernels
(D, H, Dh) and (H, Dh, D), held as (D, D) Linear weights), so the decode can
cache each layer's projected keys and values: a chunk's queries attend to
[cache ‖ chunk] with the training weights, and the concatenated chunk
outputs equal the offline chunk-masked forward. Masked logits take the
dtype's most negative finite value, the softmax runs in fp32. The decode
state is a dict the caller keeps and passes in: per-layer (k, v) caches of
length chunk_size · num_left_chunks, the absolute frame position and the
number of valid cached frames (Python ints, so the decode never waits on
the device). Dropout in train mode draws from the `generator` passed to
`forward`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

from ..ops import features as F
from ..utils.device import resolve_device, resolve_dtype
from .layers import Conv2d, Linear, dropout, init_weights_
from .transformer import FeedForward, LayerNorm, make_chunk_mask, sinusoidal_position_encoding


@dataclass(frozen=True)
class StreamingTSVADConfig:
    max_num_speaker: int = 4
    speaker_embed_dim: int = 192
    d_model: int = 384
    d_ff: int = 1536
    n_heads: int = 4
    n_layers: int = 2
    dropout: float = 0.1
    sample_rate: int = 16000
    label_rate: int = 25
    feat_dim: int = 80
    chunk_size: int = 16  # frames @25 Hz per attention chunk (0.64 s)
    num_left_chunks: int = 4  # history window in chunks


class Conv2dSubsampling4(nn.Module):
    """fbank (B, T100, F) → (B, ⌈T100/4⌉, d_model): two stride-2 3×3 convs
    and a Linear over the frequency-major flattening (B, T4, F4·C), as the
    flax module flattens its NHWC output."""

    def __init__(self, feat_dim: int, d_model: int):
        super().__init__()
        c = d_model // 4
        self.conv1 = Conv2d(1, c, 3, stride=2, padding=1)
        self.conv2 = Conv2d(c, c, 3, stride=2, padding=1)
        f4 = ((feat_dim + 1) // 2 + 1) // 2  # each conv: ⌈n/2⌉
        self.out = Linear(f4 * c, d_model)

    def forward(self, x):
        h = torch.relu(self.conv2(torch.relu(self.conv1(x[:, None]))))  # (B, C, T4, F4)
        B, C, T4, F4 = h.shape
        return self.out(h.permute(0, 2, 3, 1).reshape(B, T4, F4 * C))


class KVEncoderLayer(nn.Module):
    """Post-norm encoder layer with explicit Q/K/V projections; `streaming`
    decodes one chunk against cached projected keys and values."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float = 0.0):
        super().__init__()
        self.n_heads, self.dropout = n_heads, dropout
        self.query = Linear(d_model, d_model)
        self.key = Linear(d_model, d_model)
        self.value = Linear(d_model, d_model)
        self.out = Linear(d_model, d_model)
        self.ln1 = LayerNorm(d_model)
        self.ff = FeedForward(d_model, d_ff, dropout)
        self.ln2 = LayerNorm(d_model)

    def _heads(self, lin: Linear, x):
        B, T, D = x.shape
        return lin(x).view(B, T, self.n_heads, D // self.n_heads)

    def _attend(self, q, k, v, mask, generator=None):
        """q (B, Tq, H, Dh); k, v (B, Tk, H, Dh); mask (B|1, 1, Tq, Tk) bool."""
        B, Tq, H, dh = q.shape
        logits = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / torch.tensor(math.sqrt(dh), dtype=q.dtype)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        w = dropout(w, self.dropout, self.training, generator)
        return self.out(torch.matmul(w, v.transpose(1, 2)).transpose(1, 2).reshape(B, Tq, H * dh))

    def forward(self, x, mask=None, generator=None):
        p, on = self.dropout, self.training
        attn = self._attend(self._heads(self.query, x), self._heads(self.key, x), self._heads(self.value, x), mask,
                            generator)
        x = self.ln1(x + dropout(attn, p, on, generator))
        return self.ln2(x + dropout(self.ff(x, generator), p, on, generator))

    def streaming(self, x_q, k_cache, v_cache, mask):
        """x_q (B, C, D); caches (B, L, H, Dh); mask (1, 1, 1, L + C) →
        (out (B, C, D), k_new, v_new (B, C, H, Dh))."""
        k_new, v_new = self._heads(self.key, x_q), self._heads(self.value, x_q)
        attn = self._attend(self._heads(self.query, x_q), torch.cat([k_cache, k_new], 1),
                            torch.cat([v_cache, v_new], 1), mask)
        x = self.ln1(x_q + attn)
        return self.ln2(x + self.ff(x)), k_new, v_new


Caches = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


class StreamingLayerStack(nn.Module):
    """Sinusoidal positions + KV encoder layers, run over a whole sequence
    (with the chunk mask) or one chunk at a time (with per-layer caches)."""

    def __init__(self, d_model: int, n_layers: int, n_heads: int, d_ff: int, dropout: float = 0.0,
                 max_len: int = 8192):
        super().__init__()
        self.n_layers, self.n_heads = n_layers, n_heads
        self.register_buffer("pe", torch.from_numpy(sinusoidal_position_encoding(max_len, d_model)), persistent=False)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", KVEncoderLayer(d_model, n_heads, d_ff, dropout))

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.n_layers)]

    def forward(self, x, chunk_size: int = 0, num_left_chunks: int = -1, generator=None):
        T = x.shape[1]
        x = x + self.pe[None, :T].to(x.dtype)
        mask = make_chunk_mask(T, chunk_size, num_left_chunks, x.device) if chunk_size > 0 else None
        for layer in self.layers():
            x = layer(x, mask, generator)
        return x

    def init_cache(self, batch: int, cache_len: int, dtype, device) -> Caches:
        """Per-layer (k, v) caches (B, cache_len, H, Dh), zeros."""
        shape = (batch, cache_len, self.n_heads, self.pe.shape[1] // self.n_heads)
        return tuple((torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))
                     for _ in range(self.n_layers))

    def streaming_step(self, x_chunk, caches: Caches, pos: int, cache_valid: int):
        """One chunk (B, C, D) at absolute frame `pos` through every layer;
        the last `cache_valid` of the L cached frames are real. The chunk
        attends to all of itself, as the training mask lets it.
        → (out (B, C, D), new caches)."""
        C = x_chunk.shape[1]
        L = caches[0][0].shape[1]
        x = x_chunk + self.pe[pos : pos + C].to(x_chunk.dtype)[None]
        mask = (torch.arange(L + C, device=x.device) >= L - cache_valid)[None, None, None, :]
        new = []
        for layer, (kc, vc) in zip(self.layers(), caches):
            x, k_new, v_new = layer.streaming(x, kc, vc, mask)
            new.append((torch.cat([kc, k_new], 1)[:, C:], torch.cat([vc, v_new], 1)[:, C:]))
        return x, tuple(new)


class StreamingTSVADModel(nn.Module):
    """Streaming TS-VAD with its own conv front-end (no CAM++).

    Built on `device` (None: CUDA, or raise without it) with fp32 weights
    drawn from `seed`; load JAX weights with
    `utils/convert.streaming_tsvad_from_flax`. `dtype` is the compute dtype.
    """

    def __init__(self, cfg: StreamingTSVADConfig = StreamingTSVADConfig(),
                 dtype: Union[str, torch.dtype] = torch.float32,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = resolve_dtype(dtype)
        dev = resolve_device(device)
        stack = dict(d_model=c.d_model, n_layers=c.n_layers, n_heads=c.n_heads, d_ff=c.d_ff, dropout=c.dropout)
        self.frontend = Conv2dSubsampling4(c.feat_dim, c.d_model)
        self.front_proj = Linear(c.d_model, c.speaker_embed_dim)
        self.proj = Linear(2 * c.speaker_embed_dim, c.d_model) if 2 * c.speaker_embed_dim != c.d_model else None
        self.single_backend = StreamingLayerStack(**stack)
        self.backend_down = Linear(c.max_num_speaker * c.d_model, c.d_model)
        self.multi_backend = StreamingLayerStack(**stack)
        self.fc = Linear(c.d_model, c.max_num_speaker)
        init_weights_(self, torch.Generator().manual_seed(seed))
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.fc.weight.device

    def encode_frames(self, audio_or_fbank: torch.Tensor) -> torch.Tensor:
        """audio (B, N) or fbank (B, T100, F) → mix features (B, T25, spk_dim)."""
        c = self.cfg
        if audio_or_fbank.dim() == 2:
            fbank = F.kaldi_fbank_auto(audio_or_fbank, sample_rate=c.sample_rate, num_mel_bins=c.feat_dim,
                                       mean_norm=True)
        else:
            fbank = audio_or_fbank
        return self.front_proj(self.frontend(fbank.to(self.dtype)))

    def _fuse(self, mix, target_embs, generator=None):
        """(B, T, spk) mix, (B, S, spk) targets → (B, S, T, d_model)."""
        B, T, D = mix.shape
        S = self.cfg.max_num_speaker
        ts = dropout(target_embs.to(self.dtype), self.cfg.dropout, self.training, generator)
        cat = torch.cat([ts[:, :, None, :].expand(B, S, T, D), mix[:, None].expand(B, S, T, D)], dim=-1)
        return cat if self.proj is None else self.proj(cat)

    def _down(self, x, B: int):
        """(B·S, T, D) single-backend output → (B, T, D) through backend_down."""
        _, T, D = x.shape
        S = self.cfg.max_num_speaker
        return self.backend_down(x.reshape(B, S, T, D).transpose(1, 2).reshape(B, T, S * D))

    def forward(self, audio_or_fbank: torch.Tensor, target_embs: torch.Tensor, n_label_frames: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The offline forward with chunk-masked attention (training and the
        decode's reference) → logits (B, T25, max_num_speaker), float32."""
        c = self.cfg
        mix = self.encode_frames(audio_or_fbank)
        if n_label_frames is not None:
            mix = mix[:, :n_label_frames]
            if mix.shape[1] < n_label_frames:
                mix = torch.nn.functional.pad(mix, (0, 0, 0, n_label_frames - mix.shape[1]))
        cat = self._fuse(mix, target_embs, generator)
        B, S, T, D = cat.shape
        kw = dict(chunk_size=c.chunk_size, num_left_chunks=c.num_left_chunks, generator=generator)
        x = self._down(self.single_backend(cat.reshape(B * S, T, D), **kw), B)
        return self.fc(self.multi_backend(x, **kw)).float()

    def streaming_state(self, batch: int) -> Dict:
        """The initial decode state: zero caches, position 0, none valid."""
        c = self.cfg
        L = c.chunk_size * c.num_left_chunks
        return dict(single=self.single_backend.init_cache(batch * c.max_num_speaker, L, self.dtype, self.device),
                    multi=self.multi_backend.init_cache(batch, L, self.dtype, self.device), pos=0, valid=0)

    def streaming_step(self, audio_or_fbank_chunk, target_embs, state: Dict):
        """One chunk of audio or fbank (4·chunk_size frames @100 Hz) →
        (logits (B, ~chunk_size, S), new state). The subsampling convs see
        zero padding at the chunk's edges, so its edge frames can differ
        from the offline forward's; the backends are exact
        (`streaming_step_mix`)."""
        return self.streaming_step_mix(self.encode_frames(audio_or_fbank_chunk), target_embs, state)

    def streaming_step_mix(self, mix, target_embs, state: Dict):
        """One chunk of 25 Hz mix features (B, C, spk_dim) through both
        backends' caches → (logits (B, C, S) float32, new state)."""
        c = self.cfg
        C = mix.shape[1]
        cat = self._fuse(mix, target_embs)
        B, S, T, D = cat.shape
        x, single = self.single_backend.streaming_step(cat.reshape(B * S, T, D), state["single"], state["pos"],
                                                       state["valid"])
        x, multi = self.multi_backend.streaming_step(self._down(x, B), state["multi"], state["pos"], state["valid"])
        L = c.chunk_size * c.num_left_chunks
        return self.fc(x).float(), dict(single=single, multi=multi, pos=state["pos"] + C,
                                        valid=min(state["valid"] + C, L))
