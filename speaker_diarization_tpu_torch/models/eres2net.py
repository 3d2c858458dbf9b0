"""ERes2Net and ERes2NetV2 speaker encoders (3D-Speaker), PyTorch.

Counterpart of speaker_diarization_tpu/models/eres2net.py (reference
ts_vad2/ERes2Net.py, magicdata-ramc ts_vad2/ERes2NetV2.py): Res2Net blocks
with local feature fusion (AFF attention between split branches in the
deeper stages) and, in ERes2Net, global fusion of the downsampled stage
outputs; ReLU clamped at 20 (`relu20`, the reference Hardtanh(0, 20)); a
TSTP embedding (`speaker_encoders.stats_pool_time`, unbiased).

Layout: NCHW with H = frequency and W = time, the JAX NHWC (B, F, T, C)
with the channel moved to dim 1, so flax's kernels and (s, s) strides carry
over as they are. Frames flatten (B, C, F', T') as the JAX
`transpose(0, 2, 1, 3).reshape(B, T', F'·C)`: time-major, then frequency,
then channel. Submodules carry the flax names (`conv1`, `bn1`,
`layer{k}_{i}.{conv1,bn1,conv_j,bn_j,aff_j,conv3,bn3,shortcut_conv,
shortcut_bn}`, `fuse34`, `seg_1`, ...); BatchNorm is flax's
(models/layers.BatchNorm). ERes2NetV2's modes: 'frames' (stage 4 fused with
stage 3, 12.5 Hz), 'frames25' (stage 3, 25 Hz: TS-VAD's speech encoder) and
'embedding'. `with_head=False` builds what TS-VAD's frames25 mode reaches.
"""

from __future__ import annotations

from typing import Literal, Sequence

import torch
import torch.nn as nn

from .layers import BatchNorm, Conv2d, Linear
from .speaker_encoders import stats_pool_time


def relu20(x):
    return torch.clamp(x, 0.0, 20.0)


def _frames(h: torch.Tensor) -> torch.Tensor:
    """(B, C, F', T') → (B, T', F'·C)."""
    B, C, Fq, T = h.shape
    return h.permute(0, 3, 2, 1).reshape(B, T, Fq * C)


class AFF(nn.Module):
    """Attentional feature fusion: a gate from the concatenation blends the two inputs."""

    def __init__(self, channels: int, r: int = 4):
        super().__init__()
        inter = max(channels // r, 1)
        self.conv1 = Conv2d(2 * channels, inter, 1)
        self.bn1 = BatchNorm(inter)
        self.conv2 = Conv2d(inter, channels, 1)
        self.bn2 = BatchNorm(channels)

    def forward(self, x, ds_y):
        a = self.bn1(self.conv1(torch.cat([x, ds_y], dim=1)))
        att = 1.0 + torch.tanh(self.bn2(self.conv2(a * torch.sigmoid(a))))
        return x * att + ds_y * (2.0 - att)


class ERes2NetBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1, base_width: int = 32, scale: int = 2,
                 use_aff: bool = False, expansion: int = 2):
        super().__init__()
        width = int(planes * base_width / 64.0)
        self.scale, self.use_aff = scale, use_aff
        self.conv1 = Conv2d(in_planes, width * scale, 1, stride=stride, bias=False)
        self.bn1 = BatchNorm(width * scale)
        for i in range(scale):
            if i > 0 and use_aff:
                self.add_module(f"aff_{i - 1}", AFF(width))
            self.add_module(f"conv_{i}", Conv2d(width, width, 3, padding=1, bias=False))
            self.add_module(f"bn_{i}", BatchNorm(width))
        out = planes * expansion
        self.conv3 = Conv2d(width * scale, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        self.has_shortcut = stride != 1 or in_planes != out
        if self.has_shortcut:
            self.shortcut_conv = Conv2d(in_planes, out, 1, stride=stride, bias=False)
            self.shortcut_bn = BatchNorm(out)

    def forward(self, x):
        spx = relu20(self.bn1(self.conv1(x))).chunk(self.scale, dim=1)
        outs, sp = [], None
        for i in range(self.scale):
            if i == 0:
                sp = spx[0]
            elif self.use_aff:
                sp = getattr(self, f"aff_{i - 1}")(sp, spx[i])
            else:
                sp = sp + spx[i]
            sp = relu20(getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(sp)))
            outs.append(sp)
        out = self.bn3(self.conv3(torch.cat(outs, dim=1)))
        sc = self.shortcut_bn(self.shortcut_conv(x)) if self.has_shortcut else x
        return relu20(out + sc)


class _ERes2NetTrunk(nn.Module):
    """conv1 + bn1 and `len(stages)` stages of blocks at strides 1, 2, 2, 2
    on (B, 1, F, T); AFF inside the blocks from stage 3 on."""

    def __init__(self, feat_dim: int, m_channels: int, num_blocks: Sequence[int], base_width: int, scale: int,
                 expansion: int, n_stages: int):
        super().__init__()
        self.feat_dim, self.m, self.e = feat_dim, m_channels, expansion
        self.conv1 = Conv2d(1, m_channels, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(m_channels)
        in_planes = m_channels
        self.stage_blocks = []
        for si in range(n_stages):
            planes, names = m_channels * 2**si, []
            for bi in range(num_blocks[si]):
                name = f"layer{si + 1}_{bi}"
                self.add_module(name, ERes2NetBlock(in_planes, planes, (1, 2, 2, 2)[si] if bi == 0 else 1,
                                                    base_width, scale, use_aff=si >= 2, expansion=expansion))
                in_planes = planes * expansion
                names.append(name)
            self.stage_blocks.append(names)

    def stem(self, x):
        """fbank (B, T, F) → (B, m, F, T)."""
        return relu20(self.bn1(self.conv1(x.transpose(1, 2)[:, None])))

    def stage(self, h, si: int):
        for name in self.stage_blocks[si]:
            h = getattr(self, name)(h)
        return h

    def frame_channels(self, stage: int) -> int:
        """Width of the flattened frames after stage `stage` (1-based)."""
        f = self.feat_dim
        for _ in range(stage - 1):
            f = -(-f // 2)
        return f * self.m * 2 ** (stage - 1) * self.e


class ERes2Net(_ERes2NetTrunk):
    """Base ERes2Net with the full 12/123/1234 global-fusion cascade:
    fbank (B, T, feat) → 'frames' (B, T/8, F/8·8me) or an embedding."""

    def __init__(self, feat_dim: int = 80, embedding_size: int = 192, m_channels: int = 32,
                 num_blocks: Sequence[int] = (3, 4, 6, 3), base_width: int = 32, scale: int = 2,
                 expansion: int = 2):
        super().__init__(feat_dim, m_channels, num_blocks, base_width, scale, expansion, 4)
        m, e = m_channels, expansion
        for i, (name, c) in enumerate((("fuse12", m * 2 * e), ("fuse123", m * 4 * e), ("fuse1234", m * 8 * e))):
            self.add_module(f"layer{i + 1}_downsample", Conv2d(c // 2, c, 3, stride=2, padding=1, bias=False))
            self.add_module(name, AFF(c))
        self.out_channels = self.frame_channels(4)
        self.seg_1 = Linear(2 * self.out_channels, embedding_size)

    def forward(self, x, mode: Literal["frames", "embedding"] = "embedding"):
        out1 = self.stage(self.stem(x), 0)
        out2 = self.stage(out1, 1)
        fuse12 = self.fuse12(out2, self.layer1_downsample(out1))
        out3 = self.stage(out2, 2)
        fuse123 = self.fuse123(out3, self.layer2_downsample(fuse12))
        out4 = self.stage(out3, 3)
        frames = _frames(self.fuse1234(out4, self.layer3_downsample(fuse123)))
        if mode == "frames":
            return frames
        return self.seg_1(stats_pool_time(frames.float(), unbiased=True).to(x.dtype))


class ERes2NetV2(_ERes2NetTrunk):
    """ERes2NetV2: the global fusion pruned to stage 3 → stage 4 (`layer3_ds`
    + `fuse34`), wider m_channels. `with_head=False` builds the trunk up to
    stage 3, all that 'frames25' reaches, as the JAX TS-VAD variables hold it."""

    def __init__(self, feat_dim: int = 80, embedding_size: int = 192, m_channels: int = 64,
                 num_blocks: Sequence[int] = (3, 4, 6, 3), base_width: int = 26, scale: int = 2,
                 expansion: int = 2, with_head: bool = True):
        super().__init__(feat_dim, m_channels, num_blocks, base_width, scale, expansion, 4 if with_head else 3)
        self.with_head = with_head
        m, e = m_channels, expansion
        self.out_channels = self.frame_channels(4 if with_head else 3)  # of 'frames', or 'frames25' alone
        if with_head:
            self.layer3_ds = Conv2d(m * 4 * e, m * 8 * e, 3, stride=2, padding=1, bias=False)
            self.fuse34 = AFF(m * 8 * e)
            self.seg_1 = Linear(2 * self.out_channels, embedding_size)

    def forward(self, x, mode: Literal["frames", "frames25", "embedding"] = "embedding"):
        out3 = self.stage(self.stage(self.stage(self.stem(x), 0), 1), 2)
        if mode == "frames25":
            return _frames(out3)
        if not self.with_head:
            raise ValueError(f"mode {mode!r} needs ERes2NetV2(with_head=True)")
        frames = _frames(self.fuse34(self.stage(out3, 3), self.layer3_ds(out3)))
        if mode == "frames":
            return frames
        return self.seg_1(stats_pool_time(frames.float(), unbiased=True).to(x.dtype))
