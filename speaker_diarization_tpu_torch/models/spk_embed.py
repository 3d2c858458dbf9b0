"""Speaker-embedding pretraining: encoder + AAM-softmax classifier.

Counterpart of speaker_diarization_tpu/models/spk_embed.py: utterance-level
speaker classification with additive-angular-margin softmax, so that the
encoder → enrollment → TS-VAD pipeline runs with no external weights.
Trained encoders are exported (CLI `export-encoder`) in the JAX package's
npz format and read by `extract-embeddings` and `train --family tsvad
--encoder-ckpt`, in either package.

The encoder is CAM++ with its dense head, ECAPA-TDNN (`ecapa_channels`
wide) or ResNet34, on its module path (BatchNorm on batch statistics in
train mode, running statistics in eval), fed fbank in the compute dtype.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..ops import features as F
from ..ops.losses import l2_normalize
from ..utils.convert import _flatten, encoder_from_flax, encoder_to_flax, load_encoder_npz
from ..utils.device import resolve_device, resolve_dtype
from .campplus import CAMPPlus
from .layers import init_weights_
from .speaker_encoders import ECAPA_TDNN, ResNet34

ENCODERS = ("campplus", "ecapa", "resnet34")


@dataclass(frozen=True)
class SpkEmbedConfig:
    n_classes: int = 100
    encoder: str = "campplus"  # campplus | ecapa | resnet34
    feat_dim: int = 80
    emb_dim: int = 192
    margin: float = 0.2  # AAM margin m
    scale: float = 32.0  # AAM scale s
    encoder_blocks: tuple = (12, 24, 16)  # CAM++ depth; shrink for tests
    ecapa_channels: int = 512


def build_encoder(cfg: SpkEmbedConfig) -> nn.Module:
    """The config's speaker encoder with its embedding head (unmaterialised
    where the caller builds on the meta device)."""
    if cfg.encoder == "campplus":
        return CAMPPlus(
            feat_dim=cfg.feat_dim, embedding_size=cfg.emb_dim, block_layers=cfg.encoder_blocks,
            block_dilations=(1, 2, 2)[: len(cfg.encoder_blocks)], with_dense=True,
        )
    if cfg.encoder == "ecapa":
        return ECAPA_TDNN(channels=cfg.ecapa_channels, feat_dim=cfg.feat_dim, embed_dim=cfg.emb_dim)
    if cfg.encoder == "resnet34":
        return ResNet34(feat_dim=cfg.feat_dim, embed_dim=cfg.emb_dim)
    raise ValueError(f"unknown encoder {cfg.encoder}")


class SpeakerClassifier(nn.Module):
    """fbank (B, T100, F) → scaled cosine logits (B, n_classes).

    Built on `device` (None: CUDA, or raise without it) with fp32 weights
    drawn from `seed` (the AAM class centroids xavier-normal, as flax draws
    them); `dtype` is the compute dtype of the encoder.
    """

    def __init__(
        self,
        cfg: SpkEmbedConfig = SpkEmbedConfig(),
        dtype: Union[str, torch.dtype] = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        self.cfg = cfg
        self.dtype = resolve_dtype(dtype)
        dev = resolve_device(device)
        with torch.device("meta"):
            self.speech_encoder = build_encoder(cfg)
            self.aam_weight = nn.Parameter(torch.empty(cfg.n_classes, cfg.emb_dim))
        self.to_empty(device=dev)
        gen = torch.Generator().manual_seed(seed)
        init_weights_(self.speech_encoder, gen)
        std = math.sqrt(2.0 / (cfg.n_classes + cfg.emb_dim))  # xavier normal: fan_in + fan_out
        with torch.no_grad():
            self.aam_weight.copy_(torch.randn((cfg.n_classes, cfg.emb_dim), generator=gen) * std)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.aam_weight.device

    def embed(self, fbank: torch.Tensor) -> torch.Tensor:
        """fbank (B, T100, F) → L2-normalized embedding (B, emb_dim), fp32."""
        e = self.speech_encoder(fbank.to(self.dtype), mode="embedding")
        return l2_normalize(e.float())

    def forward(self, fbank: torch.Tensor, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """→ scaled cosine logits (B, n_classes), fp32; with labels, the
        target class gets the additive angular margin cos(θ + m)."""
        c = self.cfg
        e = self.embed(fbank)
        cos = torch.clamp(e @ l2_normalize(self.aam_weight.float()).T, -0.9999, 0.9999)
        if labels is not None:
            idx = labels.long()[:, None]
            cos = cos.scatter(1, idx, torch.cos(torch.acos(cos.gather(1, idx)) + c.margin))
        return cos * c.scale


def embed_audio(encoder: nn.Module, audio: torch.Tensor, sample_rate: int, n_mels: int = 80) -> torch.Tensor:
    """audio (B, N) → the embeddings `extract-embeddings` stores (B, emb_dim):
    mean-normalised kaldi fbank (the K1 kernel on CUDA), the encoder in
    embedding mode (its module path, as the JAX CLI runs it)."""
    fbank = F.kaldi_fbank_auto(audio, sample_rate=sample_rate, num_mel_bins=n_mels, mean_norm=True)
    return encoder(fbank, mode="embedding")


# ---------------------------------------------------------------------------
# Trained-encoder export/import (CLI export-encoder → extract-embeddings),
# in the JAX package's npz format: "/"-joined flax variable paths
# ("params/head/conv1/kernel", "batch_stats/...") and a JSON "__cfg__".
# ---------------------------------------------------------------------------


def save_encoder(path: str, cfg: SpkEmbedConfig, encoder_state_dict) -> None:
    """Write an encoder's state dict (with its embedding head) and the config as npz."""
    if cfg.encoder not in ENCODERS:
        raise ValueError(f"unknown encoder {cfg.encoder}")
    variables = encoder_to_flax(cfg.encoder, encoder_state_dict)
    flat = {"/".join(p): v for p, v in _flatten({k: t for k, t in variables.items() if t})}
    meta = dict(encoder=cfg.encoder, feat_dim=cfg.feat_dim, emb_dim=cfg.emb_dim,
                encoder_blocks=list(cfg.encoder_blocks), ecapa_channels=cfg.ecapa_channels)
    np.savez(path, __cfg__=json.dumps(meta), **flat)


def load_encoder(path: str, device: Optional[Union[str, torch.device]] = None) -> Tuple[nn.Module, SpkEmbedConfig]:
    """An export-encoder npz (from either package) → (the encoder in eval
    mode on `device`, its config); the encoder's forward(fbank,
    mode="embedding") gives the embedding."""
    meta, v = load_encoder_npz(path)
    cfg = SpkEmbedConfig(
        n_classes=1, encoder=meta["encoder"], feat_dim=meta["feat_dim"], emb_dim=meta["emb_dim"],
        encoder_blocks=tuple(meta["encoder_blocks"]), ecapa_channels=meta.get("ecapa_channels", 512),
    )
    enc = build_encoder(cfg)
    enc.load_state_dict(encoder_from_flax(cfg.encoder, v["params"], v["batch_stats"]))
    return enc.to(resolve_device(device)).eval(), cfg
