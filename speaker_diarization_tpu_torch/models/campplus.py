"""CAM++ speaker encoder (D-TDNN with context-aware masking), PyTorch.

Counterpart of speaker_diarization_tpu/models/campplus.py, with the tensor
names of the reference wespeaker module (cam_pplus_wespeaker.py): `head.*`
for the FCM front-end, `xvector.{tdnn,blockN.tdnndM,transitN,out_nonlinear,
dense}.*` for the trunk. A wespeaker state dict therefore loads as it is,
and the JAX package's `utils/torch_convert.campplus_torch_to_flax` maps
this module's state dict to flax.

Layout: the public `CAMPPlus.forward` takes fbank (B, T, F) and returns
frames (B, ceil(T/2), 512) or an embedding (B, 192), as the JAX module
does. Inside, the FCM head is NCHW with H = frequency (the JAX module is
NHWC with H = frequency): (B, 1, F, T), strides (2, 1) on F, and the final
flatten is C-major, F-minor. The trunk is (B, C, T).

This module path is the eval-mode reference; TS-VAD inference runs the
fused path in kernels/cam_block_fused.py.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Literal, Sequence

import torch
import torch.nn as nn

from .layers import BatchNorm, Conv1d, Conv2d, remat as _remat


def get_nonlinear(channels: int, relu: bool = True, affine: bool = True) -> nn.Sequential:
    """wespeaker 'batchnorm-relu' (or 'batchnorm_' = no affine, no relu)."""
    mods = OrderedDict(batchnorm=BatchNorm(channels, eps=1e-5, affine=affine))
    if relu:
        mods["relu"] = nn.ReLU()
    return nn.Sequential(mods)


class TDNNLayer(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, dilation=1):
        super().__init__()
        pad = (kernel_size - 1) // 2 * dilation
        self.linear = Conv1d(in_channels, out_channels, kernel_size, stride=stride, padding=pad, dilation=dilation, bias=False)
        self.nonlinear = get_nonlinear(out_channels)

    def forward(self, x):
        return self.nonlinear(self.linear(x))


def seg_pooling(x: torch.Tensor, seg_len: int = 100) -> torch.Tensor:
    """Segment-average pooling with ceil-mode tail (CAMLayer.seg_pooling).

    x: (B, T, C) → per-100-frame segment means broadcast back to (B, T, C).
    """
    B, T, C = x.shape
    n_seg = -(-T // seg_len)
    pad = n_seg * seg_len - T
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad))
    sums = xp.reshape(B, n_seg, seg_len, C).sum(dim=2)
    counts = torch.tensor([min(seg_len, T - s * seg_len) for s in range(n_seg)], dtype=x.dtype, device=x.device)
    means = sums / counts[None, :, None]
    return means.repeat_interleave(seg_len, dim=1)[:, :T]


class CAMLayer(nn.Module):
    def __init__(self, bn_channels, out_channels, kernel_size, dilation, reduction=2):
        super().__init__()
        pad = (kernel_size - 1) // 2 * dilation
        self.linear_local = Conv1d(bn_channels, out_channels, kernel_size, padding=pad, dilation=dilation, bias=False)
        self.linear1 = Conv1d(bn_channels, bn_channels // reduction, 1)
        self.relu = nn.ReLU()
        self.linear2 = Conv1d(bn_channels // reduction, out_channels, 1)
        self.sigmoid = nn.Sigmoid()

    def forward(self, x):  # (B, C, T)
        y = self.linear_local(x)
        xf = x.float()
        context = xf.mean(dim=-1, keepdim=True) + seg_pooling(xf.transpose(1, 2)).transpose(1, 2)
        context = self.relu(self.linear1(context.to(x.dtype)))
        m = self.sigmoid(self.linear2(context))
        return y * m


class CAMDenseTDNNLayer(nn.Module):
    def __init__(self, in_channels, out_channels, bn_channels, kernel_size, dilation=1):
        super().__init__()
        self.nonlinear1 = get_nonlinear(in_channels)
        self.linear1 = Conv1d(in_channels, bn_channels, 1, bias=False)
        self.nonlinear2 = get_nonlinear(bn_channels)
        self.cam_layer = CAMLayer(bn_channels, out_channels, kernel_size, dilation)

    def forward(self, x):
        return self.cam_layer(self.nonlinear2(self.linear1(self.nonlinear1(x))))


class CAMDenseTDNNBlock(nn.ModuleList):
    """`remat`: each layer's activations are recomputed in the backward pass
    (the JAX block's `nn.remat` of each CAMDenseTDNNLayer)."""

    def __init__(self, num_layers, in_channels, out_channels, bn_channels, kernel_size, dilation=1, remat=False):
        super().__init__()
        for i in range(num_layers):
            self.add_module(
                f"tdnnd{i + 1}",
                CAMDenseTDNNLayer(in_channels + i * out_channels, out_channels, bn_channels, kernel_size, dilation),
            )
        self.remat = remat

    def forward(self, x):
        for layer in self:
            out = _remat(layer, x) if self.remat and torch.is_grad_enabled() else layer(x)
            x = torch.cat([x, out], dim=1)
        return x


class TransitLayer(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.nonlinear = get_nonlinear(in_channels)
        self.linear = Conv1d(in_channels, out_channels, 1, bias=False)

    def forward(self, x):
        return self.linear(self.nonlinear(x))


class DenseLayer(nn.Module):
    """1x1 projection + BN without affine ('batchnorm_'), on (B, C)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.linear = Conv1d(in_channels, out_channels, 1, bias=False)
        self.nonlinear = get_nonlinear(out_channels, relu=False, affine=False)

    def forward(self, x):
        return self.nonlinear(self.linear(x.unsqueeze(-1))).squeeze(-1)


class BasicResBlock(nn.Module):
    """(B, C, F, T) residual block; the stride applies to frequency only."""

    def __init__(self, in_planes, planes, stride=1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride=(stride, 1), padding=1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=1, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=(stride, 1), bias=False), BatchNorm(planes)
            )

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return torch.relu(h + self.shortcut(x))


class FCM(nn.Module):
    """2-D residual front-end: (B, F, T) fbank → (B, C·F/8, T) at 100 Hz."""

    def __init__(self, num_blocks: Sequence[int] = (2, 2), m_channels: int = 32, feat_dim: int = 80):
        super().__init__()
        self.conv1 = Conv2d(1, m_channels, 3, stride=1, padding=1, bias=False)
        self.bn1 = BatchNorm(m_channels)
        # NOTE: like the JAX module, both layer groups use num_blocks[0]
        self.layer1 = nn.Sequential(*[BasicResBlock(m_channels, m_channels, 2 if i == 0 else 1) for i in range(num_blocks[0])])
        self.layer2 = nn.Sequential(*[BasicResBlock(m_channels, m_channels, 2 if i == 0 else 1) for i in range(num_blocks[0])])
        self.conv2 = Conv2d(m_channels, m_channels, 3, stride=(2, 1), padding=1, bias=False)
        self.bn2 = BatchNorm(m_channels)
        self.out_channels = m_channels * (feat_dim // 8)

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x.unsqueeze(1))))
        h = self.layer2(self.layer1(h))
        h = torch.relu(self.bn2(self.conv2(h)))
        B, C, Fq, T = h.shape
        return h.reshape(B, C * Fq, T)


def stats_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, T, C) → (B, 2C): mean ‖ unbiased std over time."""
    mean = x.mean(dim=1)
    var = ((x - mean[:, None, :]) ** 2).sum(dim=1) / max(x.shape[1] - 1, 1)
    return torch.cat([mean, torch.sqrt(var + 1e-10)], dim=-1)


class CAMPPlus(nn.Module):
    """CAM++: fbank (B, T, feat_dim) @100 Hz → frame features and/or embedding.

    mode 'frames': (B, ceil(T/2), 512) 50 Hz features (TS-VAD speech encoder).
    mode 'embedding': (B, embedding_size) x-vector; needs with_dense=True.
    mode 'both': (embedding, frames) from one pass; needs with_dense=True.
    The TS-VAD speech encoder is built with with_dense=False, matching the
    JAX model, whose frames-only encoder has no dense layer. `remat`
    recomputes each dense layer in the backward pass (TS-VAD's
    `remat_encoder`).
    """

    def __init__(
        self,
        feat_dim: int = 80,
        embedding_size: int = 192,
        growth_rate: int = 32,
        bn_size: int = 4,
        init_channels: int = 128,
        block_layers: Sequence[int] = (12, 24, 16),
        block_dilations: Sequence[int] = (1, 2, 2),
        with_dense: bool = True,
        remat: bool = False,
    ):
        super().__init__()
        self.feat_dim = feat_dim
        self.growth_rate = growth_rate
        self.bn_size = bn_size
        self.init_channels = init_channels
        self.block_layers = tuple(block_layers)
        self.block_dilations = tuple(block_dilations)
        self.with_dense = with_dense
        self.head = FCM(feat_dim=feat_dim)
        channels = self.head.out_channels
        self.xvector = nn.Sequential(OrderedDict(tdnn=TDNNLayer(channels, init_channels, 5, stride=2, dilation=1)))
        channels = init_channels
        for i, (num_layers, dil) in enumerate(zip(self.block_layers, self.block_dilations)):
            block = CAMDenseTDNNBlock(num_layers, channels, growth_rate, bn_size * growth_rate, 3, dil, remat)
            self.xvector.add_module(f"block{i + 1}", block)
            channels += num_layers * growth_rate
            self.xvector.add_module(f"transit{i + 1}", TransitLayer(channels, channels // 2))
            channels //= 2
        self.xvector.add_module("out_nonlinear", get_nonlinear(channels))
        self.out_channels = channels
        if with_dense:
            self.xvector.add_module("dense", DenseLayer(channels * 2, embedding_size))

    def frames(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F) → (B, C, ceil(T/2)) trunk output, channel-first."""
        h = self.head(x.transpose(1, 2))
        for name, mod in self.xvector.named_children():
            if name == "dense":
                break
            h = mod(h)
        return h

    def forward(self, x: torch.Tensor, mode: Literal["frames", "embedding", "both"] = "embedding"):
        h = self.frames(x)
        if mode == "frames":
            return h.transpose(1, 2)  # (B, T/2, 512)
        if not self.with_dense:
            raise ValueError(f"{mode} mode needs CAMPPlus(with_dense=True)")
        e = self.xvector.dense(stats_pool(h.transpose(1, 2).float()).to(x.dtype))  # (B, 192)
        # 'both': the utterance embedding and the frames of one pass (the
        # TS-VAD3 speaker encoder, reference ts_vad3/model.py:964-968)
        return (e, h.transpose(1, 2)) if mode == "both" else e
