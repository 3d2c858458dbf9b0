"""TS-VAD3: TS-VAD conditioned on enrollment waveforms, with attention fusion.

Counterpart of speaker_diarization_tpu/models/tsvad3.py (reference
egs/alimeeting/ts_vad3/model.py). Where TS-VAD takes precomputed speaker
embeddings, TS-VAD3 takes each target speaker's enrollment waveform
(ts_len s) and runs it through a second CAM++ trained with the model, which
gives both the utterance embedding (the conditioning vector) and its frames
(forward_speaker_encoder, model.py:947-981). The speaker frames can be fused
into the mixture path by scaled dot-product attention (query = mixture
frames, key/value = all speakers' frames along time), at the fbank level
and/or after the speech encoder (att_fuse_kernel, model.py:982-1080):

  audio (B, N) → kaldi fbank (K1) ─[fuse_fbank_feat]─ CAM++ frames (B, T50, 512)
  enrollment (B, S, Nts) → (B·S, Nts) → kaldi fbank (K1) → CAM++ 'both'
      → embeddings (B, S, 192) and frames (B, S·T50', 512)
  ─[fuse_speaker_embedding_feat]─ Conv k5 s2 + BN + ReLU → (B, T25, 192)
  → TS-VAD's single backend, backend_down, multi backend and Linear.

Both CAM++ run on their module path, as in JAX (the fused K2/K4 path is the
TS-VAD speech encoder's eval path only), so K1 is this model's kernel: two
launches a forward. Submodules carry the flax names; utils/convert.
tsvad3_from_flax maps the JAX variables. Parameters are fp32, `dtype` is the
compute dtype; `model.train()` is the JAX `train=True`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

import torch
import torch.nn as nn

from ..ops import features as F
from ..utils.device import resolve_device, resolve_dtype
from .campplus import CAMPPlus
from .layers import Linear, dropout, init_weights_
from .transformer import sinusoidal_position_encoding
from .tsvad import BackendTransformer, ConvBnRelu, TSVADConfig


@dataclass(frozen=True)
class TSVAD3Config:
    base: TSVADConfig = field(default_factory=TSVADConfig)
    ts_len: float = 6.0  # enrollment seconds per speaker
    use_spk_embed: bool = False  # True: embeddings in, as TS-VAD
    fuse_fbank_feat: bool = False  # attention-fuse speaker fbank into the mixture fbank
    fuse_speaker_embedding_feat: bool = True  # fuse speaker frames into the encoder frames
    att_fuse_dropout: float = 0.0
    speaker_encoder_layers: tuple = (12, 24, 16)  # CAM++ depth of the speaker side


class AttFuse(nn.Module):
    """SDPA fusion (ts_vad3 att_fuse_kernel): query = speech frames (B, Tq, D),
    key/value = speaker frames (B, Tk, D); concat(attended, speech) → Linear
    to `out_dim`. The softmax runs in fp32 and is cast back."""

    def __init__(self, dim: int, out_dim: int, dropout: float = 0.0):
        super().__init__()
        self.proj = Linear(2 * dim, out_dim)
        self.dropout = dropout

    def forward(self, speaker_feat, speech_feat, generator=None):
        D = speech_feat.shape[-1]
        scores = torch.einsum("bqd,bkd->bqk", speech_feat, speaker_feat) / torch.sqrt(
            torch.tensor(float(D), dtype=speech_feat.dtype))
        w = torch.softmax(scores.float(), dim=-1).to(speech_feat.dtype)
        w = dropout(w, self.dropout, self.training, generator)
        att = torch.einsum("bqk,bkd->bqd", w, speaker_feat)
        return self.proj(torch.cat([att, speech_feat], dim=-1))


class TSVAD3Model(nn.Module):
    """Mixture audio + per-speaker enrollment waveforms → VAD logits (B, T25, S).

    Built on `device` (None: CUDA, or raise without it) with fp32 weights
    drawn from `seed`.
    """

    def __init__(
        self,
        cfg: TSVAD3Config = TSVAD3Config(),
        dtype: Union[str, torch.dtype] = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        self.cfg = cfg
        c = cfg.base
        self.dtype = resolve_dtype(dtype)
        dev = resolve_device(device)
        d = c.transformer_embed_dim
        if 2 * c.speaker_embed_dim != d:
            raise ValueError(f"TS-VAD3 concatenates two {c.speaker_embed_dim}-d vectors into the "
                             f"{d}-d backend: transformer_embed_dim must be twice speaker_embed_dim")
        with torch.device("meta"):
            self.speech_encoder = CAMPPlus(feat_dim=c.feat_dim, block_layers=c.encoder_block_layers,
                                           block_dilations=(1, 2, 2)[: len(c.encoder_block_layers)],
                                           with_dense=False)
            if not cfg.use_spk_embed:
                self.speaker_encoder = CAMPPlus(feat_dim=c.feat_dim, embedding_size=c.speaker_embed_dim,
                                                block_layers=cfg.speaker_encoder_layers,
                                                block_dilations=(1, 2, 2)[: len(cfg.speaker_encoder_layers)])
            if cfg.fuse_fbank_feat:
                self.fuse_fbank_module = AttFuse(c.feat_dim, c.feat_dim, cfg.att_fuse_dropout)
            frame_c = self.speech_encoder.out_channels
            if cfg.fuse_speaker_embedding_feat and not cfg.use_spk_embed:
                self.fuse_frame_module = AttFuse(frame_c, 512, cfg.att_fuse_dropout)
                frame_c = 512
            self.speech_down = ConvBnRelu(frame_c, c.speaker_embed_dim, kernel=5, stride=2)
            self.single_backend = BackendTransformer(d, c.num_transformer_layer, c.num_attention_head,
                                                     c.transformer_ffn_embed_dim, c.dropout)
            self.backend_down = ConvBnRelu(c.max_num_speaker * d, d, kernel=5, stride=1)
            self.multi_backend = BackendTransformer(d, c.num_transformer_layer, c.num_attention_head,
                                                    c.transformer_ffn_embed_dim, c.dropout)
            self.fc = Linear(d, c.max_num_speaker)
        self.to_empty(device=dev)
        for mod in (self.single_backend, self.multi_backend):  # non-persistent buffers are not weights
            mod.pe = torch.from_numpy(sinusoidal_position_encoding(mod.pe.shape[0], mod.pe.shape[1])).to(dev)
        init_weights_(self, torch.Generator().manual_seed(seed))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.fc.weight.device

    def _fbank(self, audio):
        c = self.cfg.base
        return F.kaldi_fbank_auto(audio, sample_rate=c.sample_rate, num_mel_bins=c.feat_dim,
                                  mean_norm=True).to(self.dtype)

    def _encode(self, enc: nn.Module, fbank, mode: str, freeze: bool):
        """enc(fbank, mode); `freeze` in train mode runs it on its running
        statistics without gradient (the JAX stop_gradient)."""
        if freeze and self.training:
            enc.eval()
            try:
                with torch.no_grad():
                    return enc(fbank, mode=mode)
            finally:
                enc.train()
        return enc(fbank, mode=mode)

    def forward(
        self,
        audio: torch.Tensor,
        targets: torch.Tensor,
        n_label_frames: Optional[int] = None,
        freeze_speech_encoder: bool = False,
        freeze_speaker_encoder: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """audio (B, N); targets (B, S, Nts) enrollment waveforms, or
        (B, S, D) embeddings when cfg.use_spk_embed → logits (B, T25, S), float32."""
        c = self.cfg.base
        S = c.max_num_speaker
        mix_fbank = self._fbank(audio)  # (B, T100, feat)
        if n_label_frames is None:
            n50 = -(-mix_fbank.shape[1] // 2)
            n_label_frames = -(-n50 // 2)
        spk_frames = spk_fbank = None
        if self.cfg.use_spk_embed:
            spk_utt = targets.to(self.dtype)
        else:
            B, S_in, Nts = targets.shape
            if S_in != S:
                raise ValueError(f"{S_in} enrollment waveforms for {S} speaker slots")
            ts_fbank = self._fbank(targets.reshape(B * S, Nts))  # (B·S, Tts, feat)
            utt, frames = self._encode(self.speaker_encoder, ts_fbank, "both", freeze_speaker_encoder)
            spk_utt = utt.reshape(B, S, -1)  # (B, S, D) utterance embeddings
            spk_frames = frames.reshape(B, -1, frames.shape[-1])  # (B, S·T50, 512)
            spk_fbank = ts_fbank.reshape(B, -1, ts_fbank.shape[-1])  # (B, S·Tts, feat)
        if self.cfg.fuse_fbank_feat and spk_fbank is not None:
            mix_fbank = self.fuse_fbank_module(spk_fbank, mix_fbank, generator)
        x = self._encode(self.speech_encoder, mix_fbank, "frames", freeze_speech_encoder)
        if self.cfg.fuse_speaker_embedding_feat and spk_frames is not None:
            x = self.fuse_frame_module(spk_frames, x, generator)
        x = self.speech_down(x)  # (B, T25, emb)
        T = x.shape[1]
        if T < n_label_frames:
            x = torch.nn.functional.pad(x, (0, 0, 0, n_label_frames - T))
        x = x[:, :n_label_frames]

        B, T, D = x.shape
        ts = dropout(spk_utt, c.dropout, self.training, generator)  # rs_dropout
        cat = torch.cat([ts[:, :, None, :].expand(B, S, T, ts.shape[-1]), x[:, None].expand(B, S, T, D)], dim=-1)
        h = self.single_backend(cat.reshape(B * S, T, -1), generator)  # (B·S, T, d)
        h = h.reshape(B, S, T, -1).transpose(1, 2).reshape(B, T, -1)
        h = self.backend_down(h)
        h = self.multi_backend(h, generator)
        return self.fc(h).float()
