"""TS-VAD: target-speaker voice activity detection — the DER flagship.

Counterpart of speaker_diarization_tpu/models/tsvad.py (reference
ts_vad2/model.py:179-970), with the CAM++ speech encoder and transformer or
BiMamba (S6) backends:

  audio (B, N) → kaldi fbank 80d @100 Hz (mean-norm; K1 kernel on CUDA)
  → CAM++ frame encoder (512d @50 Hz; fused path, K2 kernel per block)
  → Conv k5 s2 + BN + ReLU → 192d @25 Hz ("mix embeddings")
  → per speaker i<4: concat[target_emb_i ‖ mix] (384d) → +sinusoidal PE
    → shared 2-layer post-norm transformer or BiMamba ("single backend")
  → stack speakers, Conv k5 s1 (4·384→384) + BN + ReLU ("backend down")
  → (+PE) → 2-layer transformer or BiMamba ("multi backend") → Linear
  → (B, T25, 4) logits

Speakers are folded into the batch for the shared single backend, as in the
JAX model. Parameters are fp32; the compute dtype is float32 or bfloat16.
`model.train()` is the JAX `train=True`: BatchNorm on batch statistics
(updating the running ones), dropout from the `generator` passed to
`forward`, and CAM++ on its plain module path (the fused K2 path serves
eval mode only, as in JAX). Other speech encoders and backends are not
ported yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn as nn

from ..ops import features as F
from ..utils.device import resolve_device, resolve_dtype
from .campplus import CAMPPlus
from .layers import BatchNorm, Conv1d, Linear, dropout, init_weights_
from .mamba import BiMambaBlock
from .transformer import TransformerEncoderLayer, sinusoidal_position_encoding


@dataclass(frozen=True)
class TSVADConfig:
    max_num_speaker: int = 4
    speaker_embed_dim: int = 192
    transformer_embed_dim: int = 384
    transformer_ffn_embed_dim: int = 1536
    num_attention_head: int = 4
    num_transformer_layer: int = 2
    dropout: float = 0.1
    sample_rate: int = 16000
    label_rate: int = 25
    feat_dim: int = 80  # fbank bins fed to CAM++
    encoder_block_layers: tuple = (12, 24, 16)  # CAM++ depth; shrink for tests
    single_backend_type: str = "transformer"  # transformer | conformer | mamba | mamba_add | mamba2 | mamba2_add
    # multi backend additionally accepts 'lstm' (reference lstm_ots_vad)
    multi_backend_type: str = "transformer"
    d_state: int = 64  # mamba state size (reference mamba2 cfg)
    expand: int = 2
    # campplus | wavlm | wavlm_weight_sum | w2vbert | hubert | wav2vec2 | mms
    # | whisper | resnet34 | simam_resnet34 | ecapa | eres2netv2 | redimnet_b*
    speech_encoder_type: str = "campplus"
    # use the fused dense-block path for CAM++ at inference
    fused_encoder_inference: bool = True
    whisper_d_model: int = 1280
    whisper_n_layers: int = 32
    whisper_n_heads: int = 20
    whisper_n_mels: int = 80
    whisper_layer_st: int = 16
    whisper_layer_ed: int = 23
    eres2net_base_width: int = 26
    eres2net_scale: int = 2
    eres2net_expansion: int = 2
    wavlm_layers: int = 12  # transformer layers used (reference select 6-12)
    wavlm_embed_dim: int = 768
    w2vbert_layers: int = 6  # reference best config uses the first 6 layers
    w2vbert_dim: int = 1024


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP item {item})")


class BackendTransformer(nn.Module):
    """Positional encoding + post-norm transformer stack."""

    def __init__(self, d_model: int, n_layers: int, n_heads: int, d_ff: int, dropout: float = 0.0,
                 max_len: int = 4096):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(sinusoidal_position_encoding(max_len, d_model)), persistent=False)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(d_model, n_heads, d_ff, dropout))
        self.n_layers = n_layers
        self.dropout = dropout

    def forward(self, x, generator=None):
        x = dropout(x + self.pe[None, : x.shape[1]].to(x.dtype), self.dropout, self.training, generator)
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, generator)
        return x


class ConvBnRelu(nn.Module):
    """(B, T, Cin) → (B, T', Cout): Conv1d (with bias) + BN + ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 5, stride: int = 1):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel, stride=stride, padding=(kernel - 1) // 2)
        self.bn = BatchNorm(out_channels)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x.transpose(1, 2)))).transpose(1, 2)


class TSVADModel(nn.Module):
    """Audio + per-speaker target embeddings → per-speaker VAD logits.

    Built on `device` (None: CUDA, or raise without it) with fp32 weights
    drawn from `seed`; load real weights with `load_state_dict` (see
    utils/convert.tsvad_from_flax). `dtype` is the compute dtype.
    """

    def __init__(
        self,
        cfg: TSVADConfig = TSVADConfig(),
        dtype: Union[str, torch.dtype] = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = resolve_dtype(dtype)
        dev = resolve_device(device)
        if c.speech_encoder_type != "campplus":
            _not_ported(f"speech_encoder_type={c.speech_encoder_type!r}", "12 (encoder zoo)")
        for kind in (c.single_backend_type, c.multi_backend_type):
            if kind not in ("transformer", "mamba", "mamba_add"):
                _not_ported(f"backend {kind!r}", "7 (Mamba2/SSD backends)" if kind.startswith("mamba2") else "9-10")
        with torch.device("meta"):
            self.speech_encoder = CAMPPlus(
                feat_dim=c.feat_dim,
                block_layers=c.encoder_block_layers,
                block_dilations=(1, 2, 2)[: len(c.encoder_block_layers)],
                with_dense=False,
            )
            self.speech_down = ConvBnRelu(self.speech_encoder.out_channels, c.speaker_embed_dim, kernel=5, stride=2)
            if c.speaker_embed_dim * 2 != c.transformer_embed_dim:
                self.proj_layer = Linear(2 * c.speaker_embed_dim, c.transformer_embed_dim)
            else:
                self.proj_layer = None
            self.single_backend = self._make_backend(c.single_backend_type)
            d = c.transformer_embed_dim
            self.backend_down = ConvBnRelu(c.max_num_speaker * d, d, kernel=5, stride=1)
            self.multi_backend = self._make_backend(c.multi_backend_type)
            self.fc = Linear(d, c.max_num_speaker)
        self.to_empty(device=dev)
        for mod in self.modules():  # non-persistent buffers are not weights
            if isinstance(mod, BackendTransformer):
                mod.pe = torch.from_numpy(sinusoidal_position_encoding(mod.pe.shape[0], mod.pe.shape[1])).to(dev)
        init_weights_(self, torch.Generator().manual_seed(seed))
        self.eval()

    def _make_backend(self, kind: str) -> nn.Module:
        c = self.cfg
        if kind == "transformer":
            return BackendTransformer(
                c.transformer_embed_dim, c.num_transformer_layer, c.num_attention_head,
                c.transformer_ffn_embed_dim, c.dropout,
            )
        return BiMambaBlock(
            c.transformer_embed_dim, c.num_transformer_layer, c.d_state, expand=c.expand,
            merge="add" if kind == "mamba_add" else "concat",
        )

    @property
    def device(self) -> torch.device:
        return self.fc.weight.device

    def encode_speech(self, audio_or_fbank: torch.Tensor, n_label_frames: int, freeze_encoder: bool = False) -> torch.Tensor:
        """audio (B, N) or fbank (B, T100, feat) → mix embeddings (B, T25, D).

        freeze_encoder (train mode): CAM++ runs with its running statistics
        and passes no gradient, the JAX `stop_gradient` of tsvad.py:393.
        """
        c = self.cfg
        if audio_or_fbank.dim() == 2:
            fbank = F.kaldi_fbank_auto(audio_or_fbank, sample_rate=c.sample_rate, num_mel_bins=c.feat_dim, mean_norm=True)
        else:
            fbank = audio_or_fbank
        fbank = fbank.to(self.dtype)
        enc = self.speech_encoder
        if c.fused_encoder_inference and not self.training:
            from ..kernels.cam_block_fused import campplus_frames_fused

            x = campplus_frames_fused(enc, fbank)
        elif freeze_encoder and self.training:
            enc.eval()
            try:
                with torch.no_grad():
                    x = enc(fbank, mode="frames")
            finally:
                enc.train()
        else:
            x = enc(fbank, mode="frames")  # (B, T50, 512)
        x = self.speech_down(x)  # (B, T25, 192)
        # align to label length (reference model.py:853-857 allows ±2)
        T = x.shape[1]
        if T < n_label_frames:
            x = torch.nn.functional.pad(x, (0, 0, 0, n_label_frames - T))
        return x[:, :n_label_frames]

    def forward(
        self,
        audio_or_fbank: torch.Tensor,
        target_embs: torch.Tensor,
        n_label_frames: Optional[int] = None,
        freeze_encoder: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """→ logits (B, T25, max_num_speaker), float32.

        target_embs: (B, max_num_speaker, speaker_embed_dim); silence/absent
        speakers use zero vectors (dataset contract, ts_vad_dataset.py:508).
        In train mode `generator` (on the model's device) draws the dropout
        masks.
        """
        c = self.cfg
        if n_label_frames is None:
            if audio_or_fbank.dim() == 2:
                n100 = 1 + (audio_or_fbank.shape[-1] - int(0.025 * c.sample_rate)) // int(0.01 * c.sample_rate)
            else:
                n100 = audio_or_fbank.shape[1]
            n50 = -(-n100 // 2)
            n_label_frames = -(-n50 // 2)
        mix = self.encode_speech(audio_or_fbank, n_label_frames, freeze_encoder)
        B, T, D = mix.shape
        S = c.max_num_speaker

        ts = dropout(target_embs.to(self.dtype), c.dropout, self.training, generator)  # rs_dropout
        ts = ts[:, :, None, :].expand(B, S, T, D)
        mixs = mix[:, None, :, :].expand(B, S, T, D)
        cat = torch.cat([ts, mixs], dim=-1)  # (B, S, T, 2D)
        if self.proj_layer is not None:
            cat = self.proj_layer(cat)
        F_dim = cat.shape[-1]
        # fold speakers into batch for the shared single backend
        cat = self.single_backend(cat.reshape(B * S, T, F_dim), generator)  # (B·S, T, F)
        cat = cat.reshape(B, S, T, F_dim).transpose(1, 2).reshape(B, T, S * F_dim)
        cat = self.backend_down(cat)  # (B, T, F)
        out = self.multi_backend(cat, generator)
        return self.fc(out).float()  # (B, T, S)
