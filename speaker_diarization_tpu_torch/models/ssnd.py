"""SSND: sequence-to-sequence neural diarization with query decoders, PyTorch.

Counterpart of speaker_diarization_tpu/models/ssnd.py (reference
egs/alimeeting/ssnd/ssnd_model.py):

  audio (B, N) → kaldi fbank (K1 on CUDA) → CAM++ frames (module path,
  50 Hz) → Linear → extractor features (B, T, emb_dim) → Conformer
  (BatchNorm conv module) → (B, T, d_model)
  detection decoder: N slot queries (learned `det_query`) fused with the
  slots' L2-normalised auxiliary speaker embeddings, keys fused with the
  learned positional table `pos_emb`, values the conformer features → per
  slot VAD logits over the block (B, N, vad_out_len)
  representation decoder: slot queries from `rep_query`, auxiliary queries
  from the slots' VAD activity (labels in training, probabilities at
  inference), keys and values from the extractor features → one speaker
  embedding per slot (B, N, emb_dim)

ArcFace logits score those embeddings against the learned all-speaker table
`E_all`; `e_pse` (pseudo speaker) and `e_non` (no speaker) fill slots.
Submodules and parameters carry the flax names (`extractor`, `encoder`,
`det_0.cross_attn.query`, `E_all`, ...), so utils/convert.ssnd_from_flax
maps the JAX variables by name. Parameters are fp32; `dtype` is the compute
dtype. `model.train()` is the JAX `train=True` (BatchNorm on batch
statistics, the conformer's dropout from the `generator`); the query
decoders have no dropout, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn as nn

from ..ops import features as F
from ..ops import losses as L
from ..ops import metrics as M
from ..parallel.collectives import batch_mean
from ..utils.device import resolve_dtype
from .campplus import CAMPPlus
from .conformer import ConformerEncoder
from .eend import materialize_
from .layers import Linear
from .transformer import LayerNorm, MultiHeadAttention


@dataclass(frozen=True)
class SSNDConfig:
    feat_dim: int = 80
    emb_dim: int = 256  # speaker embedding dim
    d_model: int = 256
    n_heads: int = 8
    d_ff: int = 512
    num_layers: int = 4
    max_speakers: int = 4
    vad_out_len: int = 100  # frames per block (label rate 25 × 4 s)
    pos_emb_dim: int = 256
    max_seq_len: int = 1000
    n_all_speakers: int = 1000
    arcface_margin: float = 0.2
    arcface_scale: float = 32.0
    sample_rate: int = 16000
    extractor_blocks: tuple = (12, 24, 16)


# parameters held directly by SSNDModel (flax `self.param`), drawn N(0, 1) as in JAX
RAW_PARAMS = ("pos_emb", "E_all", "e_pse", "e_non", "det_query", "rep_query")


class QueryFusionBlock(nn.Module):
    """SWDecoderBlockV2 (reference ssnd_model.py): cross-attention whose
    queries are fq([x_dec ‖ q_aux]) and keys fk([x_fea ‖ k_pos]) over the
    values x_fea, then self-attention over the slots, then a ReLU FFN, each
    with a post-norm residual."""

    def __init__(self, d: int, d_aux: int, d_pos: int, n_heads: int, d_ff: int):
        super().__init__()
        self.fq = Linear(d + d_aux, d)
        self.fk = Linear(d + d_pos, d)
        self.cross_attn = MultiHeadAttention(d, n_heads)
        self.norm1 = LayerNorm(d)
        self.self_attn = MultiHeadAttention(d, n_heads)
        self.norm2 = LayerNorm(d)
        self.ffn1 = Linear(d, d_ff)
        self.ffn2 = Linear(d_ff, d)
        self.norm3 = LayerNorm(d)

    def forward(self, x_dec, x_fea, q_aux, k_pos):
        q = self.fq(torch.cat([x_dec, q_aux], dim=-1))
        k = self.fk(torch.cat([x_fea, k_pos], dim=-1))
        x = self.norm1(x_dec + self.cross_attn.attend(q, k, x_fea))
        x = self.norm2(x + self.self_attn(x))
        return self.norm3(x + self.ffn2(torch.relu(self.ffn1(x))))


class SSNDModel(nn.Module):
    """audio (or fbank) + per-slot auxiliary embeddings → (VAD logits, slot embeddings).

    Built on `device` (None: CUDA, or raise without it) with fp32 weights
    drawn from `seed`; `dtype` is the compute dtype; `dropout` is the
    conformer's (the JAX SSNDModel leaves its ConformerEncoder at 0.1).
    """

    def __init__(
        self,
        cfg: SSNDConfig = SSNDConfig(),
        dtype: Union[str, torch.dtype] = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
        dropout: float = 0.1,
    ):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = resolve_dtype(dtype)
        with torch.device("meta"):
            self.extractor = CAMPPlus(feat_dim=c.feat_dim, block_layers=c.extractor_blocks,
                                      block_dilations=(1, 2, 2)[: len(c.extractor_blocks)], with_dense=False)
            self.extract_proj = Linear(self.extractor.out_channels, c.emb_dim)
            self.encoder = ConformerEncoder(c.emb_dim, c.d_model, c.num_layers, c.n_heads, c.d_ff, dropout=dropout)
            for i in range(c.num_layers):
                self.add_module(f"det_{i}", QueryFusionBlock(c.d_model, c.emb_dim, c.pos_emb_dim, c.n_heads, c.d_ff))
            self.det_out = Linear(c.d_model, c.vad_out_len)
            self.rep_in_fea = Linear(c.emb_dim, c.d_model)
            self.rep_in_dec = Linear(1, c.d_model)
            self.rep_in_aux = Linear(1, c.emb_dim)
            for i in range(c.num_layers):
                self.add_module(f"rep_{i}", QueryFusionBlock(c.d_model, c.emb_dim, c.pos_emb_dim, c.n_heads, c.d_ff))
            self.rep_out = Linear(c.d_model, c.emb_dim)
            shapes = dict(pos_emb=(1, c.max_seq_len, c.pos_emb_dim), E_all=(c.n_all_speakers, c.emb_dim),
                          e_pse=(1, c.emb_dim), e_non=(1, c.emb_dim), det_query=(c.max_speakers, c.d_model),
                          rep_query=(c.max_speakers, c.vad_out_len))
            for name in RAW_PARAMS:
                self.register_parameter(name, nn.Parameter(torch.empty(shapes[name])))
        materialize_(self, device, seed)
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for name in RAW_PARAMS:
                p = getattr(self, name)
                p.copy_(torch.randn(p.shape, generator=g).to(p.device))

    @property
    def device(self) -> torch.device:
        return self.rep_out.weight.device

    def encode(self, audio_or_fbank: torch.Tensor, generator=None):
        """audio (B, N) or fbank (B, T100, feat) → (extractor features
        (B, T50, emb_dim), conformer features (B, T50, d_model))."""
        c = self.cfg
        fbank = audio_or_fbank
        if fbank.dim() == 2:
            fbank = F.kaldi_fbank_auto(fbank, sample_rate=c.sample_rate, num_mel_bins=c.feat_dim, mean_norm=True)
        feats = self.extract_proj(self.extractor(fbank.to(self.dtype), mode="frames"))
        return feats, self.encoder(feats, generator=generator)

    def _k_pos(self, B: int, T: int) -> torch.Tensor:
        return self.pos_emb[:, :T].expand(B, T, self.cfg.pos_emb_dim).to(self.dtype)

    def detect(self, x_fea: torch.Tensor, aux_embs: torch.Tensor) -> torch.Tensor:
        """x_fea (B, T, d_model), aux_embs (B, N, emb_dim) → VAD logits (B, N, vad_out_len), fp32."""
        B, T, _ = x_fea.shape
        c = self.cfg
        q_aux = L.l2_normalize(aux_embs.float()).to(self.dtype)
        x_dec = self.det_query[None].expand(B, c.max_speakers, c.d_model).to(self.dtype)
        k_pos = self._k_pos(B, T)
        for i in range(c.num_layers):
            x_dec = getattr(self, f"det_{i}")(x_dec, x_fea, q_aux, k_pos)
        return self.det_out(x_dec).float()

    def represent(self, x_ext: torch.Tensor, q_vad: torch.Tensor) -> torch.Tensor:
        """x_ext (B, T, emb_dim) extractor features, q_vad (B, N, T_vad)
        activities → slot embeddings (B, N, emb_dim), fp32."""
        B, T, _ = x_ext.shape
        c = self.cfg
        fea = self.rep_in_fea(x_ext)
        x_dec = self.rep_in_dec(self.rep_query.mean(-1, keepdim=True).to(self.dtype))  # (N, d_model)
        x_dec = x_dec[None].expand(B, c.max_speakers, c.d_model)
        q_aux = self.rep_in_aux(q_vad.float().mean(-1, keepdim=True).to(self.dtype))
        k_pos = self._k_pos(B, T)
        for i in range(c.num_layers):
            x_dec = getattr(self, f"rep_{i}")(x_dec, fea, q_aux, k_pos)
        return self.rep_out(x_dec).float()

    def forward(self, audio_or_fbank, aux_embs, vad_labels=None, generator=None):
        """→ (vad_logits (B, N, vad_out_len), spk_embs (B, N, emb_dim)), fp32.
        `vad_labels` teacher-force the representation decoder (training);
        without them it reads the detached VAD probabilities (inference)."""
        x_ext, enc = self.encode(audio_or_fbank, generator)
        vad = self.detect(enc, aux_embs)
        q_vad = torch.sigmoid(vad.detach()) if vad_labels is None else vad_labels.float()
        return vad, self.represent(x_ext, q_vad)

    def lookup_speaker_embs(self, gids: torch.Tensor) -> torch.Tensor:
        """E_all[gid] per slot, the pseudo-speaker embedding where gid < 0."""
        embs = self.E_all[torch.clamp_min(gids.long(), 0)]
        return torch.where((gids < 0)[..., None], self.e_pse[0], embs)

    def arcface_logits(self, emb: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Scaled cos(θ + m·onehot) logits of (M, emb_dim) embeddings against E_all."""
        c = self.cfg
        cos = torch.clamp(L.l2_normalize(emb) @ L.l2_normalize(self.E_all).T, -0.9999, 0.9999)
        onehot = nn.functional.one_hot(labels.long(), c.n_all_speakers).to(cos.dtype)
        return torch.cos(torch.arccos(cos) + onehot * c.arcface_margin) * c.arcface_scale


def ssnd_loss(model: SSNDModel, audio, aux, labels, gids, generator=None, arcface_weight: float = 0.01,
              bce_alpha: float = 0.75, bce_gamma: float = 2.0):
    """(loss, aux) of JAX's make_ssnd_loss for given slot queries `aux`
    (B, S, emb_dim): focal BCE (α, γ) of the teacher-forced forward's VAD
    logits against `labels` (B, S, T), plus `arcface_weight` × (the ArcFace
    CE with label smoothing 0.05 over the slots with gid ≥ 0, plus 0.001 ×
    the mean embedding norm); aux carries the BCE, the ArcFace loss, its
    top-1 accuracy and the frame DER."""
    vad, emb = model(audio, aux, vad_labels=labels, generator=generator)
    p = torch.sigmoid(vad)
    ce = L.bce_with_logits(vad, labels)
    p_t = p * labels + (1 - p) * (1 - labels)
    a_t = bce_alpha * labels + (1 - bce_alpha) * (1 - labels)
    bce = (a_t * (1 - p_t) ** bce_gamma * ce).mean()
    valid = (gids >= 0).reshape(-1).float()
    flat_emb = emb.reshape(-1, emb.shape[-1])
    flat_gid = torch.clamp_min(gids.reshape(-1).long(), 0)
    logits_arc = model.arcface_logits(flat_emb, flat_gid)
    logp = torch.log_softmax(logits_arc, dim=-1)
    n_all, smooth = logits_arc.shape[-1], 0.05
    target = nn.functional.one_hot(flat_gid, n_all).float() * (1 - smooth) + smooth / n_all
    n_valid = torch.clamp_min(valid.sum(), 1.0)
    arc = batch_mean(-((target * logp).sum(-1) * valid).sum(), valid.sum())
    arc = arc + 0.001 * torch.linalg.vector_norm(flat_emb, dim=-1).mean()
    acc = ((logits_arc.argmax(-1) == flat_gid).float() * valid).sum() / n_valid
    stats = M.diarization_error_stats(vad.transpose(1, 2), labels.transpose(1, 2))
    return bce + arcface_weight * arc, {"bce_loss": bce.detach(), "arcface_loss": arc.detach(),
                                        "arcface_acc": acc.detach(), "frame_der": M.der_from_stats(stats)}
