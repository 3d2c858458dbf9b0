"""EEND-M2F: Mask2Former-style set-prediction diarization, PyTorch.

Counterpart of speaker_diarization_tpu/models/eend_m2f.py (reference
speaker_diarization/eend_m2f/):

  audio (B, N) 8 kHz → log-mel 23 at subsampling 1, context 0 (K1′ on
  CUDA) → depthwise-separable conv subsampling ×10 (k15 s10) → conformer
  (k49, GroupNorm conv module) → transposed-conv pixel decoder ×2 then ×5
  back to the input frame rate (pad or cut to T_in) → features and mask
  features (B, T_in, D)
  N learned queries → masked decoder layers (cross-attention restricted to
  each query's previous foreground, then self-attention, then an FFN, post
  norm) → per layer a class logit per query and mask logits
  mask_head(q) · mask_featuresᵀ (B, Q, T_in)

`use_backbone=False` keeps the flat variant (a transformer encoder at the
frame rate with positions, then a Linear to the pixel features);
`encoder_type="transformer"` puts that encoder behind the backbone.
Training matches queries to speakers with the Hungarian matcher
(ops/hungarian.py) on class, mask-BCE and dice costs (`m2f_criterion`),
every decoder level's assignment solved in one host call.
Submodules carry the flax names (`subsampler.depthwise`, `pixel_decoder.up2`,
`dec_0.cross_attn`, `query_emb`, ...), so utils/convert.m2f_from_flax maps
the JAX variables by name. Parameters are fp32; `dtype` is the compute
dtype; dropout (attention weights, the subsampler's output, the conformer)
draws from the `generator` in train mode.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as Fn

from ..ops import losses as L
from ..ops.hungarian import dice_loss, hungarian_assign
from ..utils.device import resolve_dtype
from .conformer import ConformerEncoder
from .eend import FrontendConfig, frontend_features, materialize_
from .layers import Conv1d, Linear, dropout as drop
from .transformer import LayerNorm, MultiHeadAttention, TransformerEncoder
from .tsvad import ConvTransposeSame


@dataclass(frozen=True)
class M2FConfig:
    num_queries: int = 16
    d_model: int = 256
    n_heads: int = 4
    d_ff: int = 1024
    enc_layers: int = 4
    dec_layers: int = 3
    dropout: float = 0.1
    mask_threshold: float = 0.5
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    no_object_weight: float = 0.1
    use_backbone: bool = True
    subsample: int = 10
    encoder_type: str = "conformer"  # conformer (reference) | transformer
    conv_kernel: int = 49  # conformer depthwise kernel (reference backbone.py)
    matcher: str = "mask2former"  # mask2former | fastinst (+ a location cost)
    location_weight: float = 1000.0


M2F_FRONTEND = dataclasses.replace(FrontendConfig(), subsampling=1, context_size=0)


class DepthwiseSeparableSubsample10(nn.Module):
    """×10 conv subsampling (reference backbone.py:7): depthwise k15 s10
    pad 3 without bias → ReLU → pointwise 1×1 without bias → ReLU →
    LayerNorm → dropout. (B, T, F) → (B, ≈T/10, D)."""

    def __init__(self, n_in: int, d_model: int, dropout: float = 0.1):
        super().__init__()
        self.depthwise = Conv1d(n_in, n_in, 15, stride=10, padding=3, groups=n_in, bias=False)
        self.pointwise = Conv1d(n_in, d_model, 1, bias=False)
        self.ln = LayerNorm(d_model)
        self.dropout = dropout

    def forward(self, x, generator=None):
        h = torch.relu(self.pointwise(torch.relu(self.depthwise(x.transpose(1, 2)))))
        return drop(self.ln(h.transpose(1, 2)), self.dropout, self.training, generator)


class PixelDecoderUpsample10(nn.Module):
    """×10 transposed-conv upsampling (reference pixel_decoder.py:3): flax
    ConvTranspose("SAME") k3 s2 → GELU → k5 s5 → GELU → LayerNorm → GELU
    (tanh GELUs, flax's `approximate=True`), then a 1×1 conv to the mask
    features. (B, T', D) → (features (B, 10·T', D), mask features)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.up2 = ConvTransposeSame(d_model, d_model, 3, 2)
        self.up5 = ConvTransposeSame(d_model, d_model, 5, 5)
        self.ln = LayerNorm(d_model)
        self.mask_features = Conv1d(d_model, d_model, 1)

    def forward(self, x):
        gelu = lambda t: Fn.gelu(t, approximate="tanh")  # noqa: E731
        h = gelu(self.up5(gelu(self.up2(x.transpose(1, 2)))))
        h = gelu(self.ln(h.transpose(1, 2)))
        return h, self.mask_features(h.transpose(1, 2)).transpose(1, 2)


class MaskedDecoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float = 0.1):
        super().__init__()
        self.cross_attn = MultiHeadAttention(d_model, n_heads, dropout)
        self.norm1 = LayerNorm(d_model)
        self.self_attn = MultiHeadAttention(d_model, n_heads, dropout)
        self.norm2 = LayerNorm(d_model)
        self.ffn1 = Linear(d_model, d_ff)
        self.ffn2 = Linear(d_ff, d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(self, queries, feats, attn_mask=None, generator=None):
        """queries (B, Q, D) over feats (B, T, D); attn_mask (B, 1, Q, T) bool, True = attend."""
        q = self.norm1(queries + self.cross_attn.attend(queries, feats, feats, generator, attn_mask))
        q = self.norm2(q + self.self_attn(q, generator))
        return self.norm3(q + self.ffn2(torch.relu(self.ffn1(q))))


class EENDM2FModel(nn.Module):
    """audio (or features) → {'mask_logits' (B, Q, T), 'class_logits' (B, Q),
    'aux_mask_logits', 'aux_class_logits' (the earlier decoder levels)}, fp32.

    Built on `device` (None: CUDA, or raise without it) with fp32 weights
    drawn from `seed`; `dtype` is the compute dtype. With the backbone the
    front-end must not subsample (M2F_FRONTEND): masks are scored at its
    frame rate.
    """

    def __init__(
        self,
        cfg: M2FConfig = M2FConfig(),
        frontend: Optional[FrontendConfig] = M2F_FRONTEND,
        dtype: Union[str, torch.dtype] = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
        in_dim: Optional[int] = None,
    ):
        super().__init__()
        c = self.cfg = cfg
        self.frontend = frontend
        self.dtype = resolve_dtype(dtype)
        if c.encoder_type not in ("conformer", "transformer"):
            raise ValueError(f"unknown encoder_type {c.encoder_type!r}")
        d_in = in_dim or frontend.input_dim
        with torch.device("meta"):
            if c.use_backbone:
                self.subsampler = DepthwiseSeparableSubsample10(d_in, c.d_model, c.dropout)
                self.pixel_decoder = PixelDecoderUpsample10(c.d_model)
            if c.use_backbone and c.encoder_type == "conformer":
                self.encoder = ConformerEncoder(c.d_model, c.d_model, c.enc_layers, c.n_heads, c.d_ff, c.conv_kernel,
                                                c.dropout, conv_norm="group")
            else:
                self.encoder = TransformerEncoder(c.d_model if c.use_backbone else d_in, c.d_model, c.enc_layers,
                                                  c.n_heads, c.d_ff, c.dropout, has_pos=True)
            if not c.use_backbone:
                self.pixel_proj = Linear(c.d_model, c.d_model)
            self.query_emb = nn.Parameter(torch.empty(c.num_queries, c.d_model))
            for i in range(c.dec_layers):
                self.add_module(f"dec_{i}", MaskedDecoderLayer(c.d_model, c.n_heads, c.d_ff, c.dropout))
            self.class_head = Linear(c.d_model, 1)
            self.mask_head = Linear(c.d_model, c.d_model)
        materialize_(self, device, seed)
        with torch.no_grad():  # flax normal(0.5)
            self.query_emb.copy_(0.5 * torch.randn(self.query_emb.shape, generator=torch.Generator().manual_seed(seed + 1)))

    @property
    def device(self) -> torch.device:
        return self.mask_head.weight.device

    def forward(self, x, frame_mask=None, generator=None):
        """x: audio (B, N) or features (B, T, d_in); frame_mask is read by
        the flat variant's encoder only, as in JAX."""
        c = self.cfg
        if self.frontend is not None:
            x = frontend_features(x, self.frontend)
        x = x.to(self.dtype)
        if c.use_backbone:
            T_in = x.shape[1]
            h = self.subsampler(x, generator)
            h = self.encoder(h, generator=generator)
            feat, mask_feat = self.pixel_decoder(h)  # (B, 10·T', D) each
            if feat.shape[1] < T_in:  # back to the input frame count
                feat = Fn.pad(feat, (0, 0, 0, T_in - feat.shape[1]))
                mask_feat = Fn.pad(mask_feat, (0, 0, 0, T_in - mask_feat.shape[1]))
            pixel, cross = mask_feat[:, :T_in], feat[:, :T_in]
        else:
            pixel = cross = self.pixel_proj(self.encoder(x, frame_mask, generator))
        B, T, D = pixel.shape
        q = self.query_emb[None].expand(B, c.num_queries, D).to(self.dtype)
        masks, classes = [], []
        attn_mask = None
        for i in range(c.dec_layers):
            q = getattr(self, f"dec_{i}")(q, cross, attn_mask, generator)
            mask_logits = torch.einsum("bqd,btd->bqt", self.mask_head(q), pixel).float()
            masks.append(mask_logits)
            classes.append(self.class_head(q)[..., 0].float())
            # masked attention: each query attends to its predicted foreground,
            # an empty foreground to every frame
            fg = torch.sigmoid(mask_logits) > c.mask_threshold
            fg = torch.where(fg.any(-1, keepdim=True), fg, torch.ones_like(fg))
            attn_mask = fg[:, None]
        return dict(mask_logits=masks[-1], class_logits=classes[-1], aux_mask_logits=masks[:-1],
                    aux_class_logits=classes[:-1])


def _matching_cost(mask_logits, class_logits, labels, cfg: M2FConfig):
    """(B, Q, S) matching cost of a decoder level (class, mask BCE, dice,
    and fastinst's location cost), columns of absent speakers at the
    sentinel real_max + 1; no gradient."""
    with torch.no_grad():
        T = mask_logits.shape[-1]
        p = torch.sigmoid(mask_logits)
        eps = 1e-6
        bce_pos = -torch.log(torch.clamp(p, eps, 1.0))
        bce_neg = -torch.log(torch.clamp(1 - p, eps, 1.0))
        cost_mask = (torch.einsum("bqt,bst->bqs", bce_pos, labels)
                     + torch.einsum("bqt,bst->bqs", bce_neg, 1 - labels)) / T
        num = 2 * torch.einsum("bqt,bst->bqs", p, labels)
        den = p.sum(-1)[:, :, None] + labels.sum(-1)[:, None, :]
        cost_dice = 1 - (num + 1) / (den + 1)
        cost_class = -torch.sigmoid(class_logits)[:, :, None]
        cost = cfg.mask_weight * cost_mask + cfg.dice_weight * cost_dice + cfg.class_weight * cost_class
        if cfg.matcher == "fastinst":  # a query's location: its peak frame, paid for outside the target
            loc = mask_logits.argmax(-1)  # (B, Q)
            inside = torch.gather(labels, 2, loc[:, None, :].expand(-1, labels.shape[1], -1)).transpose(1, 2)
            cost = cost + cfg.location_weight * (1.0 - inside)
        real = labels.sum(-1) > 0  # (B, S)
        ninf = torch.tensor(float("-inf"), device=cost.device)
        real_max = torch.where(real[:, None, :], cost, ninf).amax(dim=(1, 2), keepdim=True)
        real_max = torch.where(torch.isfinite(real_max), real_max, torch.zeros_like(real_max))
        return torch.where(real[:, None, :], cost, real_max + 1.0)


def _level_loss(mask_logits, class_logits, labels, assign, cfg: M2FConfig, frame_mask=None):
    B, Q, T = mask_logits.shape
    real = labels.sum(-1) > 0  # (B, S)
    onehot = Fn.one_hot(assign, Q).to(mask_logits.dtype)  # (B, S, Q)
    matched = torch.where(real[..., None], onehot, torch.zeros_like(onehot))
    is_obj = matched.amax(1)  # (B, Q)
    w = is_obj + cfg.no_object_weight * (1 - is_obj)
    class_loss = (L.bce_with_logits(class_logits, is_obj) * w).sum() / torch.clamp_min(w.sum(), 1.0)
    pred = torch.einsum("bsq,bqt->bst", matched, mask_logits)
    mce = L.bce_with_logits(pred, labels)
    if frame_mask is not None:
        mce = mce * frame_mask[:, None, :]
    realf = real.to(mask_logits.dtype)
    n_real = torch.clamp_min(realf.sum(), 1.0)
    mask_loss = (mce * realf[..., None]).sum() / (n_real * T)
    d = dice_loss(torch.where(real[..., None], pred, torch.full_like(pred, -1e9)), labels)
    dice = (d * realf).sum() / n_real
    total = cfg.class_weight * class_loss + cfg.mask_weight * mask_loss + cfg.dice_weight * dice
    return total, (class_loss, mask_loss, dice)


def m2f_criterion(outputs: dict, labels: torch.Tensor, cfg: M2FConfig, frame_mask=None):
    """Hungarian-matched set loss (reference criterion.py:176 SetCriterion)
    over the last decoder level and every auxiliary one → (loss, aux of the
    last level's class, mask and dice losses). labels (B, S, T), S ≤ the
    queries, rows without activity left out. The assignments of all levels
    come from one hungarian_assign call (one host copy a step)."""
    levels = [(outputs["mask_logits"], outputs["class_logits"])]
    levels += list(zip(outputs.get("aux_mask_logits", []), outputs.get("aux_class_logits", [])))
    labels = labels.to(levels[0][0].dtype)
    costs = torch.stack([_matching_cost(m, c, labels, cfg) for m, c in levels])  # (L, B, Q, S)
    Lv, B, Q, S = costs.shape
    assign = hungarian_assign(costs.transpose(-1, -2).reshape(Lv * B, S, Q)).reshape(Lv, B, S)
    total, (cl, ml, dl) = _level_loss(*levels[0], labels, assign[0], cfg, frame_mask)
    for (m, c), a in zip(levels[1:], assign[1:]):
        total = total + _level_loss(m, c, labels, a, cfg, frame_mask)[0]
    return total, {"class_loss": cl.detach(), "mask_loss": ml.detach(), "dice_loss": dl.detach()}


def m2f_predict_activity(outputs: dict, class_threshold: float = 0.5, max_concurrent: int = 0):
    """Inference (reference infer_mask_model.py): the sigmoid masks of the
    queries whose class probability is above the threshold → (activity
    (B, Q, T), keep (B, Q)). max_concurrent > 0 keeps, per frame, the
    activities at or above the k-th largest (ties at the k-th value are all
    kept), the reference infer2's per-frame top-k."""
    keep = torch.sigmoid(outputs["class_logits"]) > class_threshold
    act = torch.sigmoid(outputs["mask_logits"]) * keep[..., None]
    if 0 < max_concurrent < act.shape[1]:
        kth = torch.sort(act, dim=1, descending=True).values[:, max_concurrent - 1 : max_concurrent]
        act = torch.where(act >= kth, act, torch.zeros_like(act))
    return act, keep
