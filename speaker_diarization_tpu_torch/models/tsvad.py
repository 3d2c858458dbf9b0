"""TS-VAD: target-speaker voice activity detection — the DER flagship.

Counterpart of speaker_diarization_tpu/models/tsvad.py (reference
ts_vad2/model.py:179-970), with every speech encoder of the JAX model
(SPEECH_ENCODERS) and transformer, conformer, BiMamba (S6), BiMamba-2 (SSD)
or (multi backend) BiLSTM backends. The CAM++ flagship:

  audio (B, N) → kaldi fbank 80d @100 Hz (mean-norm; K1 kernel on CUDA)
  → CAM++ frame encoder (512d @50 Hz; fused path, K2 kernel per block)
  → Conv k5 s2 + BN + ReLU → 192d @25 Hz ("mix embeddings")
  → per speaker i<4: concat[target_emb_i ‖ mix] (384d) → +sinusoidal PE
    → shared 2-layer post-norm transformer, BiMamba or BiMamba-2 ("single backend")
  → stack speakers, Conv k5 s1 (4·384→384) + BN + ReLU ("backend down")
  → (+PE) → 2-layer transformer, BiMamba or BiMamba-2 ("multi backend") → Linear
  → (B, T25, 4) logits

Speakers are folded into the batch for the shared single backend, as in the
JAX model. Parameters are fp32; the compute dtype is float32 or bfloat16.
`model.train()` is the JAX `train=True`: BatchNorm on batch statistics
(updating the running ones), dropout from the `generator` passed to
`forward`, and CAM++ on its plain module path (the fused K2 path serves
eval mode only, as in JAX). ECAPA frames come at 100 Hz and a stride-4
conv takes them to 25 Hz; ResNet frames come at 12.5 Hz and a ×2
transposed conv (flax's "SAME" padding, `ConvTransposeSame`) takes them up.
`remat_encoder` recomputes each CAM++ dense layer in the backward pass.
The WavLM trunk (wavlm, its layer-weighted sum wavlm_weight_sum over a
softmax of `wavlm_weights`, and hubert, wav2vec2 and mms without the gated
relative bias) and Whisper (its own plain log-mel; blocks 16-23 of the
large-v2 trunk concatenated) read the raw waveform at 50 Hz; w2v-BERT reads
K1's 80-bin fbank paired to 50 Hz; all four take a stride-2 conv to 25 Hz.
ERes2NetV2's stage-3 frames come at 25 Hz (a stride-1 conv) and ReDimNet's
C·F frames at 100 Hz (a stride-4 conv), both from K1's fbank at feat_dim
bins (60 for redimnet_b0, 72 for b1-b6).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn as nn

from ..ops import features as F
from ..utils import profiling
from ..utils.device import resolve_device, resolve_dtype
from .campplus import CAMPPlus
from .conformer import ConformerEncoder
from .eda import LSTM
from .layers import BatchNorm, Conv1d, Linear, dropout, init_weights_
from .mamba import BiMamba2Block, BiMambaBlock
from .eres2net import ERes2NetV2
from .redimnet import ReDimNet
from .speaker_encoders import ECAPA_TDNN, ResNet34, SimAMResNet34
from .transformer import TransformerEncoderLayer, sinusoidal_position_encoding
from .w2vbert import W2vBertConfig, W2vBertModel, fbank_to_w2vbert_features
from .wavlm import WavLMFlaxConfig, WavLMModel
from .whisper_encoder import WhisperEncoder, WhisperEncoderConfig

BACKENDS = ("transformer", "conformer", "lstm", "mamba", "mamba_add", "mamba2", "mamba2_add")


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


SSL_TYPES = ("wavlm", "wavlm_weight_sum", "hubert", "wav2vec2", "mms")  # the WavLM trunk, on raw waveforms
SPEECH_ENCODERS = ("campplus", "ecapa", "resnet34", "simam_resnet34", *SSL_TYPES, "whisper", "w2vbert",
                   "eres2netv2", *(f"redimnet_b{i}" for i in range(7)))


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


class BackendConformer(nn.Module):
    """Conformer backend (reference 'conformer_ots_vad'): depthwise kernel
    31, BatchNorm in the conv module, positions added, no padding mask."""

    def __init__(self, d_model: int, n_layers: int, n_heads: int, d_ff: int, dropout: float = 0.0,
                 conv_kernel: int = 31):
        super().__init__()
        self.conformer = ConformerEncoder(d_model, d_model, n_layers, n_heads, d_ff, conv_kernel, dropout)

    def forward(self, x, generator=None):
        return self.conformer(x, None, generator)


class BackendBiLSTM(nn.Module):
    """BiLSTM backend projected back to d_model (reference 'lstm_ots_vad'):
    a forward and a reversed flax OptimizedLSTMCell RNN, concatenated."""

    def __init__(self, d_model: int, hidden: int = 256):
        super().__init__()
        self.lstm_fwd = LSTM(d_model, hidden)
        self.lstm_bwd = LSTM(d_model, hidden, reverse=True)
        self.proj = Linear(2 * hidden, d_model)

    def forward(self, x, generator=None):
        _, fwd = self.lstm_fwd(x)
        _, bwd = self.lstm_bwd(x)
        return self.proj(torch.cat([fwd, bwd], dim=-1).to(x.dtype))


class ConvTransposeSame(nn.ConvTranspose1d):
    """flax `ConvTranspose(padding="SAME")` on (B, Cin, T) → (B, Cout, s·T).

    lax.conv_transpose (transpose_kernel=False) correlates the input,
    dilated by the stride, with the kernel as it is, padded by
    pad_a = ceil((k + s − 2) / 2) in front (k − 1 when s > k − 1). torch's
    transposed convolution flips its kernel, so the weight here is the flax
    kernel flipped in time (utils/convert.py flips it), with padding
    k − 1 − pad_a; torch's output then runs longer by 2·pad_a − k − s + 2
    frames at the end, which are cut.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int):
        pad_len = kernel + stride - 2
        pad_a = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
        if 2 * pad_a - kernel - stride + 2 < 0:
            raise ValueError(f"no torch padding gives flax SAME for kernel {kernel}, stride {stride}")
        super().__init__(in_channels, out_channels, kernel, stride=stride, padding=kernel - 1 - pad_a)

    def forward(self, x):
        y = nn.functional.conv_transpose1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride,
                                           self.padding)
        return y[..., : x.shape[-1] * self.stride[0]]


class SpeechFeatUpsample(nn.Module):
    """(B, T, Cin) → (B, 2T, Cout): ConvTranspose k5 ×2 ("SAME") + BN + ReLU,
    12.5 Hz → 25 Hz for ResNet-family encoders (reference
    SpeechFeatUpsample2, ts_vad2/model.py:114-134)."""

    def __init__(self, in_channels: int, out_channels: int, upsample: int = 2):
        super().__init__()
        self.up = ConvTransposeSame(in_channels, out_channels, 5, upsample)
        self.bn = BatchNorm(out_channels)

    def forward(self, x):
        return torch.relu(self.bn(self.up(x.transpose(1, 2)))).transpose(1, 2)


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
        remat_encoder: bool = False,
    ):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = resolve_dtype(dtype)
        dev = resolve_device(device)
        enc_type = c.speech_encoder_type
        if enc_type not in SPEECH_ENCODERS and not enc_type.startswith("redimnet"):
            raise ValueError(f"unknown speech_encoder_type: {enc_type}")
        for kind in (c.single_backend_type, c.multi_backend_type):
            if kind not in BACKENDS:
                raise ValueError(f"unknown backend type: {kind}")
        with torch.device("meta"):
            self.speech_encoder = self._make_encoder(remat_encoder)
            enc_c, emb_c = self.speech_encoder.out_channels, c.speaker_embed_dim
            if enc_type in ("resnet34", "simam_resnet34"):  # 12.5 Hz → 25 Hz
                self.speech_down = SpeechFeatUpsample(enc_c, emb_c, upsample=2)
            elif enc_type == "eres2netv2":  # stage-3 frames are at 25 Hz already
                self.speech_down = ConvBnRelu(enc_c, emb_c, kernel=5, stride=1)
            elif enc_type == "ecapa" or enc_type.startswith("redimnet"):  # 100 Hz → 25 Hz
                self.speech_down = ConvBnRelu(enc_c, emb_c, kernel=5, stride=4)
            else:  # CAM++, the SSL trunks, Whisper and w2v-BERT: 50 Hz → 25 Hz
                self.speech_down = ConvBnRelu(enc_c, emb_c, kernel=5, stride=2)
            if enc_type == "wavlm_weight_sum":  # reference WavLM_weight_sum (model.py:517)
                self.wavlm_weights = nn.Parameter(torch.zeros(c.wavlm_layers))
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
        if isinstance(self.speech_encoder, WhisperEncoder):
            self.speech_encoder.reset_positions_()
        self.eval()

    def _make_encoder(self, remat_encoder: bool) -> nn.Module:
        """The speech encoder of JAX TSVADModel.setup (tsvad.py:177-289),
        holding what the JAX variables hold for its frames."""
        c = self.cfg
        t = c.speech_encoder_type
        if t == "campplus":
            return CAMPPlus(feat_dim=c.feat_dim, block_layers=c.encoder_block_layers,
                            block_dilations=(1, 2, 2)[: len(c.encoder_block_layers)], with_dense=False,
                            remat=remat_encoder)
        if t == "ecapa":  # reference ecapa_channel_1024_wespeaker (model.py:632-655)
            return ECAPA_TDNN(channels=1024, feat_dim=c.feat_dim, with_head=False)
        if t in ("resnet34", "simam_resnet34"):  # reference wespeaker wiring (model.py:584-630)
            return (ResNet34 if t == "resnet34" else SimAMResNet34)(feat_dim=c.feat_dim, with_head=False)
        if t in SSL_TYPES:
            # hubert / wav2vec2 / mms (reference model.py:449-493) are the
            # WavLM trunk without its gated relative position bias
            wavlm_like = t in ("wavlm", "wavlm_weight_sum")
            return WavLMModel(WavLMFlaxConfig(
                encoder_layers=c.wavlm_layers, encoder_embed_dim=c.wavlm_embed_dim,
                encoder_ffn_embed_dim=4 * c.wavlm_embed_dim, encoder_attention_heads=max(1, c.wavlm_embed_dim // 64),
                relative_position_embedding=wavlm_like, gru_rel_pos=wavlm_like), dtype=self.dtype)
        if t == "w2vbert":
            return W2vBertModel(W2vBertConfig(
                hidden_size=c.w2vbert_dim, num_layers=c.w2vbert_layers, num_heads=max(1, c.w2vbert_dim // 64),
                intermediate_size=4 * c.w2vbert_dim, feature_input_dim=2 * c.feat_dim))
        if t == "whisper":  # reference model.py:556-580: blocks layer_st..layer_ed concatenated at 50 Hz
            return WhisperEncoder(WhisperEncoderConfig(
                n_mels=c.whisper_n_mels, d_model=c.whisper_d_model, n_heads=c.whisper_n_heads,
                n_layers=c.whisper_n_layers, d_ff=4 * c.whisper_d_model),
                layer_st=c.whisper_layer_st, layer_ed=c.whisper_layer_ed, dtype=self.dtype)
        if t == "eres2netv2":  # reference ERes2NetV2_COMMON at label rate 25 (magicdata-ramc model.py:586-615)
            return ERes2NetV2(feat_dim=c.feat_dim, base_width=c.eres2net_base_width, scale=c.eres2net_scale,
                              expansion=c.eres2net_expansion, with_head=False)
        # reference ReDimNetB* wiring: un-subsampled 100 Hz frames of C·F; the
        # fbank width must be the size's (60 for b0, 72 for b1-b6)
        return ReDimNet(size=t.split("_")[-1], feat_dim=c.feat_dim, with_head=False)

    def _make_backend(self, kind: str) -> nn.Module:
        c = self.cfg
        if kind == "transformer":
            return BackendTransformer(
                c.transformer_embed_dim, c.num_transformer_layer, c.num_attention_head,
                c.transformer_ffn_embed_dim, c.dropout,
            )
        if kind == "conformer":  # reference 'conformer_ots_vad' (model.py:258-267)
            return BackendConformer(
                c.transformer_embed_dim, c.num_transformer_layer, c.num_attention_head,
                c.transformer_ffn_embed_dim, c.dropout,
            )
        if kind == "lstm":  # reference 'lstm_ots_vad' multi backend (model.py:357-364)
            return BackendBiLSTM(c.transformer_embed_dim)
        block = BiMamba2Block if kind.startswith("mamba2") else BiMambaBlock
        return block(
            c.transformer_embed_dim, c.num_transformer_layer, c.d_state, expand=c.expand,
            merge="add" if kind.endswith("_add") else "concat",
        )

    @property
    def device(self) -> torch.device:
        return self.fc.weight.device

    def _encode_waveform(self, audio: torch.Tensor) -> torch.Tensor:
        """WavLM family and Whisper: (B, N) audio → (B, T50, D)."""
        if self.cfg.speech_encoder_type == "wavlm_weight_sum":  # softmax-weighted sum over layers[1:]
            _, layers = self.speech_encoder.extract_features(audio, ret_layer_results=True)
            stacked = torch.stack(layers[1:], dim=0)
            w = torch.softmax(self.wavlm_weights, dim=0)  # fp32: the mix promotes, as in JAX
            return torch.einsum("l,lbtd->btd", w, stacked.float()).to(stacked.dtype)
        return self.speech_encoder(audio)

    def _encode_fbank(self, audio_or_fbank: torch.Tensor) -> torch.Tensor:
        """audio (B, N) → mean-normed K1 fbank, or fbank (B, T100, feat) →
        the encoder's frames."""
        c = self.cfg
        if audio_or_fbank.dim() == 2:
            fbank = F.kaldi_fbank_auto(audio_or_fbank, sample_rate=c.sample_rate, num_mel_bins=c.feat_dim, mean_norm=True)
        else:
            fbank = audio_or_fbank
        t, enc = c.speech_encoder_type, self.speech_encoder
        if t == "w2vbert":
            return enc(fbank_to_w2vbert_features(fbank).to(self.dtype))  # (B, T50, D)
        fbank = fbank.to(self.dtype)
        if t == "campplus" and c.fused_encoder_inference and not self.training:
            from ..kernels.cam_block_fused import campplus_frames_fused

            return campplus_frames_fused(enc, fbank)
        return enc(fbank, mode="frames25" if t == "eres2netv2" else "frames")  # (B, T50, 512) for CAM++

    def encode_speech(self, audio_or_fbank: torch.Tensor, n_label_frames: int, freeze_encoder: bool = False) -> torch.Tensor:
        """audio (B, N) or fbank (B, T100, feat) → mix embeddings (B, T25, D).

        freeze_encoder (train mode): the encoder runs with its running
        statistics and passes no gradient, the JAX `stop_gradient` of
        tsvad.py:393.
        """
        c = self.cfg
        t = c.speech_encoder_type
        enc = self.speech_encoder
        frozen = freeze_encoder and self.training
        if frozen:
            enc.eval()
        try:
            with torch.no_grad() if frozen else contextlib.nullcontext():
                if t in SSL_TYPES or t == "whisper":  # raw waveforms, no fbank
                    x = self._encode_waveform(audio_or_fbank)
                else:
                    x = self._encode_fbank(audio_or_fbank)
        finally:
            if frozen:
                enc.train()
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
        masks. Traced as `tsvad.forward`, with `tsvad.encode` (the speech
        encoder and `speech_down`) and `tsvad.backends` (the rest).
        """
        with profiling.span("tsvad.forward"):
            c = self.cfg
            if n_label_frames is None:
                if audio_or_fbank.dim() == 2:
                    n100 = 1 + (audio_or_fbank.shape[-1] - int(0.025 * c.sample_rate)) // int(0.01 * c.sample_rate)
                else:
                    n100 = audio_or_fbank.shape[1]
                n50 = -(-n100 // 2)
                n_label_frames = -(-n50 // 2)
            with profiling.span("tsvad.encode"):
                mix = self.encode_speech(audio_or_fbank, n_label_frames, freeze_encoder)
            with profiling.span("tsvad.backends"):
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
