"""Speaker-encoder zoo: ECAPA-TDNN, ResNet34 and SimAM-ResNet34 (wespeaker), PyTorch.

Counterpart of speaker_diarization_tpu/models/speaker_encoders.py
(reference ts_vad2 ecapa_tdnn_wespeaker.py, resnet_wespeaker.py,
samresnet_wespeaker.py). Each model takes fbank (B, T, feat) and runs in
'frames' mode (pre-pooling features: TS-VAD's speech encoder) or
'embedding' mode, the CAM++ contract (models/campplus.py).

Submodules carry the flax module names (`layer1`, `res2.conv_0`,
`layer2_0.shortcut_bn`, `pool.linear1`, ...), so utils/convert.py maps
the JAX variables by name. Layouts: the 1-D trunks run (B, C, T); the 2-D
trunks run NCHW with H = time and W = frequency, the JAX NHWC (B, T, F, C)
with the channel moved to dim 1, so flax's 3×3 kernels and strides (s, s)
carry over as they are. The JAX frames flatten (B, T/8, F/8, C) as
F/8·C, frequency-major: the torch trunk permutes to (B, T/8, F/8, C)
before flattening. BatchNorm is flax's (models/layers.BatchNorm).
`with_head=False` builds the frames-only trunk, as the JAX TS-VAD model's
variables hold it (its pooling and embedding layers are never created).
`build_speaker_encoder` also builds the zoo's ERes2Net, ReDimNet, WavLM and
Whisper from their own modules (models/eres2net.py, redimnet.py, wavlm.py,
whisper_encoder.py).
"""

from __future__ import annotations

import importlib
from typing import Literal, Sequence

import torch
import torch.nn as nn

from .layers import BatchNorm, Conv1d, Conv2d, Linear


class ConvReluBn1d(nn.Module):
    """(B, Cin, T) → (B, Cout, T): dilated conv (with bias) → ReLU → BN."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1, dilation: int = 1):
        super().__init__()
        pad = (kernel - 1) // 2 * dilation
        self.conv = Conv1d(in_channels, out_channels, kernel, padding=pad, dilation=dilation)
        self.bn = BatchNorm(out_channels)

    def forward(self, x):
        return self.bn(torch.relu(self.conv(x)))


class Res2ConvReluBn(nn.Module):
    """Res2Net 1-D: the channels split into `scale` groups, convs cascaded."""

    def __init__(self, channels: int, kernel: int = 3, dilation: int = 1, scale: int = 8):
        super().__init__()
        self.scale = scale
        width = channels // scale
        self.nums = scale if scale == 1 else scale - 1
        pad = (kernel - 1) // 2 * dilation
        for i in range(self.nums):
            self.add_module(f"conv_{i}", Conv1d(width, width, kernel, padding=pad, dilation=dilation))
            self.add_module(f"bn_{i}", BatchNorm(width))

    def forward(self, x):
        spx = x.chunk(self.scale, dim=1)
        out = []
        sp = spx[0]
        for i in range(self.nums):
            if i >= 1:
                sp = sp + spx[i]
            sp = getattr(self, f"bn_{i}")(torch.relu(getattr(self, f"conv_{i}")(sp)))
            out.append(sp)
        if self.scale != 1:
            out.append(spx[self.nums])
        return torch.cat(out, dim=1)


class SEConnect(nn.Module):
    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.linear1 = Linear(channels, bottleneck)
        self.linear2 = Linear(bottleneck, channels)

    def forward(self, x):  # (B, C, T)
        s = torch.relu(self.linear1(x.mean(dim=2)))
        return x * torch.sigmoid(self.linear2(s))[:, :, None]


class SERes2Block(nn.Module):
    def __init__(self, channels: int, kernel: int = 3, dilation: int = 2, scale: int = 8):
        super().__init__()
        self.in1x1 = ConvReluBn1d(channels, channels, 1)
        self.res2 = Res2ConvReluBn(channels, kernel, dilation, scale)
        self.out1x1 = ConvReluBn1d(channels, channels, 1)
        self.se = SEConnect(channels)

    def forward(self, x):
        return x + self.se(self.out1x1(self.res2(self.in1x1(x))))


def stats_pool_time(x: torch.Tensor, unbiased: bool = False, eps: float = 1e-10) -> torch.Tensor:
    """TSTP: (B, T, C) → (B, 2C) mean ‖ std, the variance as E[x²] − E[x]²
    clipped at 0. unbiased=True scales it by T/(T−1) and uses eps 1e-8
    (the reference pooling layers, pooling_layers_3d_speaker.py:52)."""
    T = x.shape[1]
    mean = x.mean(dim=1)
    var = torch.clamp_min((x * x).mean(dim=1) - mean * mean, 0.0)
    if unbiased:
        var = var * (T / max(T - 1, 1))
        eps = 1e-8
    return torch.cat([mean, torch.sqrt(var + eps)], dim=-1)


class ASTP(nn.Module):
    """Attentive statistics pooling (wespeaker ASTP) over (B, T, C); the
    attention's Linears run in `dtype`, the statistics in x's dtype."""

    def __init__(self, channels: int, bottleneck: int = 128, global_context: bool = False):
        super().__init__()
        self.global_context = global_context
        self.linear1 = Linear(3 * channels if global_context else channels, bottleneck)
        self.linear2 = Linear(bottleneck, channels)

    def forward(self, x, dtype=None):
        if self.global_context:
            mean = x.mean(dim=1, keepdim=True)
            std = torch.sqrt(torch.clamp_min((x * x).mean(dim=1, keepdim=True) - mean**2, 1e-10))
            ctx = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=-1)
        else:
            ctx = x
        a = self.linear2(torch.tanh(self.linear1(ctx.to(dtype or x.dtype))))
        a = torch.exp(a - a.amax(dim=1, keepdim=True))
        a = a / a.sum(dim=1, keepdim=True)  # softmax over time
        mean = (a * x).sum(dim=1)
        var = torch.clamp_min((a * x * x).sum(dim=1) - mean * mean, 1e-10)
        return torch.cat([mean, torch.sqrt(var)], dim=-1)


class ECAPA_TDNN(nn.Module):
    """ECAPA-TDNN: fbank (B, T, feat) → 'frames' (B, T, 1536) at the fbank
    rate (100 Hz) or an embedding (B, embed_dim)."""

    def __init__(self, channels: int = 512, feat_dim: int = 80, embed_dim: int = 192,
                 global_context_att: bool = False, emb_bn: bool = False, with_head: bool = True):
        super().__init__()
        self.feat_dim = feat_dim
        self.with_head = with_head
        self.layer1 = ConvReluBn1d(feat_dim, channels, 5)
        self.layer2 = SERes2Block(channels, 3, 2)
        self.layer3 = SERes2Block(channels, 3, 3)
        self.layer4 = SERes2Block(channels, 3, 4)
        self.mfa_conv = Conv1d(3 * channels, 1536, 1)
        self.out_channels = 1536
        if with_head:
            self.pool = ASTP(1536, global_context=global_context_att)
            self.pool_bn = BatchNorm(2 * 1536)
            self.linear = Linear(2 * 1536, embed_dim)
            if emb_bn:
                self.emb_bn_layer = BatchNorm(embed_dim)

    def forward(self, x, mode: Literal["frames", "embedding"] = "embedding"):
        h1 = self.layer1(x.transpose(1, 2))
        h2 = self.layer2(h1)
        h3 = self.layer3(h2)
        h4 = self.layer4(h3)
        h = torch.relu(self.mfa_conv(torch.cat([h2, h3, h4], dim=1))).transpose(1, 2)
        if mode == "frames":
            return h  # (B, T, 1536)
        if not self.with_head:
            raise ValueError("embedding mode needs ECAPA_TDNN(with_head=True)")
        p = self.pool_bn(self.pool(h.float(), dtype=x.dtype)).to(x.dtype)
        e = self.linear(p)
        if hasattr(self, "emb_bn_layer"):
            e = self.emb_bn_layer(e)
        return e


class ResBasicBlock2d(nn.Module):
    """(B, C, T, F) basic residual block, stride (s, s); `simam` adds SimAM
    attention before the residual add (SimAMBasicBlock2d)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1, simam: bool = False):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.simam = simam
        self.has_shortcut = stride != 1 or in_planes != planes
        if self.has_shortcut:
            self.shortcut_conv = Conv2d(in_planes, planes, 1, stride=stride, bias=False)
            self.shortcut_bn = BatchNorm(planes)

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if self.simam:
            h = simam(h.float()).to(h.dtype)
        sc = self.shortcut_bn(self.shortcut_conv(x)) if self.has_shortcut else x
        return torch.relu(h + sc)


def SimAMBasicBlock2d(in_planes: int, planes: int, stride: int = 1) -> ResBasicBlock2d:
    """Basic ResNet block with SimAM before the residual add (reference
    SimAMBasicBlock, samresnet_wespeaker.py:21-70)."""
    return ResBasicBlock2d(in_planes, planes, stride, simam=True)


def simam(x: torch.Tensor, lambda_p: float = 1e-4) -> torch.Tensor:
    """SimAM parameter-free attention over the (T, F) plane of (B, C, T, F)
    (reference samresnet_wespeaker.py:65-70)."""
    n = x.shape[2] * x.shape[3] - 1
    d = (x - x.mean(dim=(2, 3), keepdim=True)) ** 2
    v = d.sum(dim=(2, 3), keepdim=True) / n
    return x * torch.sigmoid(d / (4.0 * (v + lambda_p)) + 0.5)


class _ResNetTrunk(nn.Module):
    """conv1 + bn1 + four groups of basic blocks at strides 1, 2, 2, 2 on
    (B, 1, T, F); `frames` flattens (B, C, T/8, F/8) frequency-major."""

    def __init__(self, feat_dim: int, m_channels: int, num_blocks: Sequence[int], simam: bool):
        super().__init__()
        self.feat_dim = feat_dim
        self.conv1 = Conv2d(1, m_channels, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(m_channels)
        planes, in_planes = m_channels, m_channels
        for gi, (n, stride) in enumerate(zip(num_blocks, (1, 2, 2, 2))):
            for bi in range(n):
                self.add_module(f"layer{gi + 1}_{bi}",
                                ResBasicBlock2d(in_planes, planes, stride if bi == 0 else 1, simam))
                in_planes = planes
            planes *= 2
        self.blocks = [f"layer{gi + 1}_{bi}" for gi, n in enumerate(num_blocks) for bi in range(n)]
        self.out_channels = in_planes * (-(-feat_dim // 8))

    def frames(self, x):
        """(B, T, F) → (B, ceil(T/8), C·ceil(F/8)) at 12.5 Hz."""
        h = torch.relu(self.bn1(self.conv1(x[:, None])))
        for name in self.blocks:
            h = getattr(self, name)(h)
        B, C, T8, F8 = h.shape
        return h.permute(0, 2, 3, 1).reshape(B, T8, F8 * C)


class ResNet34(_ResNetTrunk):
    """wespeaker ResNet34: fbank (B, T, feat) → 'frames' (B, ceil(T/8),
    8m·F/8) at 12.5 Hz or a TSTP embedding."""

    def __init__(self, feat_dim: int = 80, embed_dim: int = 256, m_channels: int = 32,
                 num_blocks: Sequence[int] = (3, 4, 6, 3), with_head: bool = True):
        super().__init__(feat_dim, m_channels, num_blocks, simam=False)
        self.with_head = with_head
        if with_head:
            self.embed_linear = Linear(2 * self.out_channels, embed_dim)

    def forward(self, x, mode: Literal["frames", "embedding"] = "embedding"):
        h = self.frames(x)
        if mode == "frames":
            return h
        if not self.with_head:
            raise ValueError("embedding mode needs ResNet34(with_head=True)")
        return self.embed_linear(stats_pool_time(h.float()).to(x.dtype))


class WespeakerASP(nn.Module):
    """Channel-wise attentive statistics pooling (wespeaker ASP,
    pooling_layers_wespeaker.py:146-168): per-channel softmax over time,
    weighted mean ‖ std, on (B, T, D)."""

    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.att_conv1 = Conv1d(channels, bottleneck, 1)
        self.att_bn = BatchNorm(bottleneck)
        self.att_conv2 = Conv1d(bottleneck, channels, 1)

    def forward(self, x):
        a = self.att_conv2(self.att_bn(torch.relu(self.att_conv1(x.transpose(1, 2)))))
        w = torch.softmax(a.float(), dim=2).transpose(1, 2)
        xf = x.float()
        mu = (xf * w).sum(dim=1)
        sg = torch.sqrt(torch.clamp_min((xf * xf * w).sum(dim=1) - mu * mu, 1e-5))
        return torch.cat([mu, sg], dim=-1)


class SimAMResNet34(_ResNetTrunk):
    """SimAM-ResNet34 (wespeaker): fbank (B, T, feat) → 'frames'
    (B, ceil(T/8), 8m·F/8) at 12.5 Hz (5120 wide at m 64, F 80) or an ASP
    embedding (reference SimAM_ResNet34_ASP, samresnet_wespeaker.py:126-160)."""

    def __init__(self, feat_dim: int = 80, embed_dim: int = 256, m_channels: int = 64,
                 num_blocks: Sequence[int] = (3, 4, 6, 3), with_head: bool = True):
        super().__init__(feat_dim, m_channels, num_blocks, simam=True)
        self.with_head = with_head
        if with_head:
            self.pool = WespeakerASP(self.out_channels)
            self.bottleneck = Linear(2 * self.out_channels, embed_dim)

    def forward(self, x, mode: Literal["frames", "embedding"] = "embedding"):
        h = self.frames(x)
        if mode == "frames":
            return h
        if not self.with_head:
            raise ValueError("embedding mode needs SimAMResNet34(with_head=True)")
        return self.bottleneck(self.pool(h).to(x.dtype))


SPEAKER_ENCODERS = {
    "campplus": "speaker_diarization_tpu_torch.models.campplus:CAMPPlus",
    "ecapa_tdnn": "speaker_diarization_tpu_torch.models.speaker_encoders:ECAPA_TDNN",
    "resnet34": "speaker_diarization_tpu_torch.models.speaker_encoders:ResNet34",
    "simam_resnet34": "speaker_diarization_tpu_torch.models.speaker_encoders:SimAMResNet34",
    "eres2net": "speaker_diarization_tpu_torch.models.eres2net:ERes2Net",
    "redimnet": "speaker_diarization_tpu_torch.models.redimnet:ReDimNet",
    "wavlm": "speaker_diarization_tpu_torch.models.wavlm:WavLMModel",
    "whisper": "speaker_diarization_tpu_torch.models.whisper_encoder:WhisperEncoder",
}


def build_speaker_encoder(name: str, **kwargs) -> nn.Module:
    """Zoo factory (reference create_speech_encoder, ts_vad2/model.py:369);
    an unknown name raises KeyError, as in JAX."""
    mod, cls = SPEAKER_ENCODERS[name].split(":")
    return getattr(importlib.import_module(mod), cls)(**kwargs)
