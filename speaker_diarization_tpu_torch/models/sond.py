"""SOND: speaker-overlap-aware neural diarization with powerset labels, PyTorch.

Counterpart of speaker_diarization_tpu/models/sond.py (reference
sond/models.py:40-130, DiarSondModel):

  fbank (B, T100, 80) → ResNet34 frames (×8 in time, ceil) → Linear → d_model
  profiles (B, N, 192) → speaker ConvEncoder (k=1 conv stack, tanh) → d_model
  CI scores: cosine of L2-normalised frames and profiles        (B, T, N)
  CD scores: concat[frame ‖ profile] per (speaker, frame), folded into the
    batch (B·N, T, 2D) → Linear → SANM (or vanilla) layers → Linear 1
  concat[CD ‖ CI] (B, T, 2N) → FSMN blocks → Linear → (B, T, n_classes)

`n_classes` counts the speaker subsets of size ≤ max_set_size (ops/
powerset.py): 2517 at the reference's 16 speakers, 4 at once. Submodules
carry the flax module names (`speech_encoder`, `frame_proj`, `cd_0`,
`fsmn_0`, ...), so utils/convert.sond_from_flax maps the JAX variables by
name. Parameters are fp32; `dtype` is the compute dtype. `model.train()` is
the JAX `train=True`: BatchNorm on batch statistics and dropout from the
`generator` passed to forward. The fbank comes from the caller
(train/tasks.make_sond_loss_from_audio, infer/chunked.make_sond_predict),
through K1 on a CUDA batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as Fn

from ..ops import losses as L
from ..ops import metrics as M
from ..ops import powerset as P
from ..utils.device import resolve_dtype
from .eend import materialize_
from .layers import Conv1d, Linear, dropout as drop
from .speaker_encoders import ResNet34
from .transformer import LayerNorm, TransformerEncoderLayer


@dataclass(frozen=True)
class SONDConfig:
    max_speakers: int = 16
    max_set_size: int = 4
    feat_dim: int = 80
    spk_emb_dim: int = 192
    d_model: int = 256
    n_heads: int = 4
    cd_layers: int = 2
    fsmn_layers: int = 3
    fsmn_lorder: int = 10
    fsmn_rorder: int = 10
    dropout: float = 0.1
    label_smoothing: float = 0.1
    encoder_m_channels: int = 32
    encoder_blocks: tuple = (3, 4, 6, 3)
    # speaker profile encoder (reference conv_encoder.py:19 ConvEncoder)
    spk_encoder_layers: int = 3
    # CD scorer attention: 'sanm' (reference attention.py:311) or 'vanilla'
    cd_attention: str = "sanm"
    sanm_kernel: int = 11

    @property
    def n_classes(self) -> int:
        return P.n_powerset_classes(self.max_speakers, self.max_set_size)


class DepthwiseConv1d(Conv1d):
    """Depthwise time conv without bias on (B, T, D), padded (left, right)
    in time as flax's `padding=[(left, right)]`."""

    def __init__(self, channels: int, kernel: int, left: int, right: int):
        super().__init__(channels, channels, kernel, groups=channels, bias=False)
        self.pad = (left, right)

    def forward(self, x):
        return super().forward(Fn.pad(x.transpose(1, 2), self.pad)).transpose(1, 2)


class FsmnBlock(nn.Module):
    """Feedforward sequential memory (reference fsmn_encoder.py:89): linear
    projection, a depthwise conv of lorder past and rorder future taps added
    to it, ReLU(Linear), and a residual where the widths agree."""

    def __init__(self, in_dim: int, d_model: int, lorder: int = 10, rorder: int = 10, dropout: float = 0.1):
        super().__init__()
        self.proj = Linear(in_dim, d_model, bias=False)
        self.memory = DepthwiseConv1d(d_model, lorder + rorder + 1, lorder, rorder)
        self.out = Linear(d_model, d_model)
        self.dropout = dropout

    def forward(self, x, generator=None):
        h = self.proj(x)
        h = drop(h + self.memory(h), self.dropout, self.training, generator)
        out = torch.relu(self.out(h))
        return out + x if x.shape[-1] == out.shape[-1] else out


class SpeakerConvEncoder(nn.Module):
    """Speaker-profile encoder (reference sond/conv_encoder.py:19): a k=1
    conv stack over the profiles (a per-profile MLP) with tanh, residuals
    from layer 2 on, and an output projection. Profiles are L2-normalised;
    absent (all-zero) profiles stay zero."""

    def __init__(self, in_dim: int, d_model: int, n_layers: int = 3):
        super().__init__()
        for i in range(n_layers):
            self.add_module(f"conv_{i}", Linear(in_dim if i == 0 else d_model, d_model))
        self.conv_out = Linear(d_model, d_model)
        self.n_layers, self.d_model = n_layers, d_model

    def forward(self, profiles, dtype):
        """(B, N, spk_emb_dim) → (B, N, d_model) in `dtype`."""
        mask = (torch.linalg.vector_norm(profiles, dim=-1, keepdim=True) > 0).to(dtype)
        h = L.l2_normalize(profiles.to(dtype))
        for i in range(self.n_layers):
            y = torch.tanh(getattr(self, f"conv_{i}")(h))
            h = h + y if (i > 0 and h.shape[-1] == self.d_model) else y
        return self.conv_out(h) * mask


class SANMLayer(nn.Module):
    """Self-attention with an FSMN memory branch (reference sond/attention.py:311
    MultiHeadedAttentionSANM): fused qkv projection, softmax attention, and a
    depthwise conv over v padded ((k-1)//2, k-1-(k-1)//2) added with v to the
    attention output; pre-LN residual wiring and a ReLU feed-forward."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, kernel: int = 11, dropout: float = 0.1):
        super().__init__()
        self.ln1 = LayerNorm(d_model)
        self.qkv = Linear(d_model, 3 * d_model)
        self.out_proj = Linear(d_model, d_model)
        lpad = (kernel - 1) // 2
        self.fsmn = DepthwiseConv1d(d_model, kernel, lpad, kernel - 1 - lpad)
        self.ln2 = LayerNorm(d_model)
        self.ffn1 = Linear(d_model, d_ff)
        self.ffn2 = Linear(d_ff, d_model)
        self.n_heads, self.dropout = n_heads, dropout

    def forward(self, x, generator=None):
        B, T, d = x.shape
        H = self.n_heads
        hd = d // H
        q, k, v = self.qkv(self.ln1(x)).chunk(3, dim=-1)
        qh = q.reshape(B, T, H, hd).transpose(1, 2) * (hd**-0.5)
        kh = k.reshape(B, T, H, hd).transpose(1, 2)
        vh = v.reshape(B, T, H, hd).transpose(1, 2)
        w = torch.softmax(qh @ kh.transpose(-1, -2), dim=-1)
        att = self.out_proj((w @ vh).transpose(1, 2).reshape(B, T, d))
        p, on = self.dropout, self.training
        mem = drop(v + self.fsmn(v), p, on, generator)
        x = x + drop(att + mem, p, on, generator)
        h = self.ffn2(torch.relu(self.ffn1(self.ln2(x))))
        return x + drop(h, p, on, generator)


class SONDModel(nn.Module):
    """fbank + speaker profiles → powerset logits (B, ceil(T100/8), n_classes).

    Built on `device` (None: CUDA, or raise without it) with fp32 weights
    drawn from `seed`; `dtype` is the compute dtype.
    """

    def __init__(
        self,
        cfg: SONDConfig = SONDConfig(),
        dtype: Union[str, torch.dtype] = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = resolve_dtype(dtype)
        if c.cd_attention not in ("sanm", "vanilla"):
            raise ValueError(f"unknown cd_attention {c.cd_attention!r}")
        with torch.device("meta"):
            self.speech_encoder = ResNet34(feat_dim=c.feat_dim, m_channels=c.encoder_m_channels,
                                           num_blocks=c.encoder_blocks, with_head=False)
            self.frame_proj = Linear(self.speech_encoder.out_channels, c.d_model)
            self.speaker_encoder = SpeakerConvEncoder(c.spk_emb_dim, c.d_model, c.spk_encoder_layers)
            # CD scorer input: concat[speech ‖ profile] (models.py:315-326 concate_speech_ivc)
            self.cd_in_proj = Linear(2 * c.d_model, c.d_model)
            for i in range(c.cd_layers):
                layer = (SANMLayer(c.d_model, c.n_heads, 4 * c.d_model, c.sanm_kernel, c.dropout)
                         if c.cd_attention == "sanm" else
                         TransformerEncoderLayer(c.d_model, c.n_heads, 4 * c.d_model, c.dropout))
                self.add_module(f"cd_{i}", layer)
            self.cd_score = Linear(c.d_model, 1)
            for i in range(c.fsmn_layers):
                self.add_module(f"fsmn_{i}", FsmnBlock(2 * c.max_speakers if i == 0 else c.d_model, c.d_model,
                                                       c.fsmn_lorder, c.fsmn_rorder, c.dropout))
            self.out = Linear(c.d_model, c.n_classes)
        materialize_(self, device, seed)

    @property
    def device(self) -> torch.device:
        return self.out.weight.device

    def n_out_frames(self, n_fbank_frames: int) -> int:
        """Frames out of the ×8 encoder (ceil rounding) for a 100 Hz fbank
        length; fbank padded to 8·T_labels aligns one frame per label."""
        return -(-n_fbank_frames // 8)

    def forward(self, fbank: torch.Tensor, spk_embs: torch.Tensor, generator: Optional[torch.Generator] = None):
        """fbank (B, T100, F), spk_embs (B, N=max_speakers, D) → powerset
        logits (B, T_frames, n_classes), float32."""
        c = self.cfg
        frames = self.frame_proj(self.speech_encoder(fbank.to(self.dtype), mode="frames"))  # (B, T, D)
        spk = self.speaker_encoder(spk_embs, self.dtype)  # (B, N, D)
        # both scorers see L2-normalised frames and profiles (models.py:337-339)
        fn = L.l2_normalize(frames)
        sn = L.l2_normalize(spk) * (torch.linalg.vector_norm(spk, dim=-1, keepdim=True) > 0).to(spk.dtype)
        ci = torch.einsum("btd,bnd->btn", fn, sn)  # cosine CI scores
        B, T, D = frames.shape
        N = spk.shape[1]
        # CD scorer: (speaker, frame) pairs folded into the batch (models.py:329-346)
        fused = torch.cat([fn[:, None].expand(B, N, T, D), sn[:, :, None].expand(B, N, T, D)], dim=-1)
        fused = self.cd_in_proj(fused.reshape(B * N, T, 2 * D))
        for i in range(c.cd_layers):
            fused = getattr(self, f"cd_{i}")(fused, generator)
        cd = self.cd_score(fused).reshape(B, N, T).transpose(1, 2)  # (B, T, N)
        h = torch.cat([cd, ci], dim=-1)  # cd first (models.py:377)
        for i in range(c.fsmn_layers):
            h = getattr(self, f"fsmn_{i}")(h, generator)
        return self.out(h).float()


def sond_loss(model: SONDModel, fbank, spk_embs, labels, generator=None, frame_mask=None):
    """(loss, aux) of JAX's `make_sond_loss` on one batch: identity-order
    powerset CE with label smoothing (channel i against profile i, see
    ops/powerset.powerset_pit_ce), and the frame DER of the powerset argmax.
    The labels must have one frame per encoder frame: pad the fbank to
    8·T_labels (train/tasks.make_sond_loss_from_audio does)."""
    c = model.cfg
    logits = model(fbank, spk_embs, generator)
    if logits.shape[1] != labels.shape[1]:
        raise ValueError(f"SOND frame/label mismatch: logits T={logits.shape[1]} vs labels T={labels.shape[1]} — "
                         f"pad fbank to 8*T_labels (see make_sond_loss_from_audio)")
    loss, _ = P.powerset_pit_ce(logits, labels, c.max_speakers, c.max_set_size, frame_mask=frame_mask,
                                label_smoothing=c.label_smoothing, permutation_invariant=False)
    pred = P.powerset_to_multilabel(logits.argmax(-1), c.max_speakers, c.max_set_size)
    stats = M.diarization_error_stats((pred * 2 - 1) * 10.0, labels, frame_mask)
    return loss, {"frame_der": M.der_from_stats(stats)}
