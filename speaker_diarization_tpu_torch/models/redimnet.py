"""ReDimNet: the reshape-dimensions speaker network, PyTorch.

Counterpart of speaker_diarization_tpu/models/redimnet.py (reference
ts_vad2/redimnet.py, IDRnD ReDimNet, arXiv:2407.18223). The network moves
between a 2-D view (frequency × time × channel) and a 1-D view (time ×
C·F, C·F constant through the network): each stage pools frequency into
channels with a VALID (stride, 1) conv, runs 2-D conv blocks, squeezes the
channels back when it expanded them, flattens to 1-D and runs an optional
time-context block (ConvNeXt-1d stack + transformer, or fc, GRU or
attention). A stage's input is a softmax-weighted sum, per C·F channel, of
every earlier stage's output. Frames stay at the 100 Hz fbank rate.

Layout: the 2-D view is NCHW with H = frequency and W = time, the JAX
(B, F, T, C) with the channel moved to dim 1; the 1-D view is (B, T, C·F)
with channel index f·C + c, as JAX's `to1d`. Submodules carry the flax
names (`backbone.stem_conv`, `stage{i}.pool_conv`, `block_j.conv_block.*`,
`tcb.*`, `inputs_weights_{i}`, `pool_linear1`, `seg_1`, ...), so
utils/convert.redimnet_from_flax maps the JAX variables by name; the GRU
block's flax GRUCells are the enhancer's GRU (models/enhancer.GRU).
flax BatchNorm(momentum=0.9) is models/layers.BatchNorm (torch momentum
0.1); the LayerNorms, and `squeeze_bn`, use eps 1e-6.
"""

from __future__ import annotations

from typing import Literal, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as Fn

from .enhancer import GRU
from .layers import BatchNorm, Conv1d, Conv2d, Linear
from .transformer import LayerNorm

# stride, num_blocks, conv_exp, kernel_sizes (unused upstream), att_block_red
StageSetup = Tuple[int, int, int, object, Optional[int]]

# the factory configs of redimnet.py:875-1055 (JAX models/redimnet.py:30-76)
REDIMNET_SIZES = {
    "b0": dict(
        feat_dim=60, C=10, block_1d_type="conv+att", block_2d_type="basic_resnet",
        stages_setup=((1, 2, 1, None, 30), (2, 3, 2, None, 30), (1, 3, 3, None, 30),
                      (2, 4, 2, None, 10), (1, 3, 1, None, 10)),
        group_divisor=1,
    ),
    "b1": dict(
        feat_dim=72, C=12, block_1d_type="conv+att", block_2d_type="convnext_like",
        stages_setup=((1, 2, 1, None, None), (2, 3, 1, None, None), (3, 4, 1, None, 12),
                      (2, 5, 1, None, 12), (2, 3, 1, None, 8)),
        group_divisor=8,
    ),
    "b2": dict(
        feat_dim=72, C=16, block_1d_type="conv+att", block_2d_type="convnext_like",
        stages_setup=((1, 2, 1, None, 12), (2, 2, 1, None, 12), (1, 3, 1, None, 12),
                      (2, 4, 1, None, 8), (1, 4, 1, None, 8), (2, 4, 1, None, 4)),
        group_divisor=4,
    ),
    "b3": dict(
        feat_dim=72, C=16, block_1d_type="conv+att", block_2d_type="basic_resnet_fwse",
        stages_setup=((1, 6, 4, None, 32), (2, 6, 2, None, 32), (1, 8, 2, None, 32),
                      (2, 10, 2, None, 16), (1, 10, 1, None, 16), (2, 8, 1, None, 16)),
        group_divisor=1,
    ),
    "b4": dict(
        feat_dim=72, C=32, block_1d_type="conv+att", block_2d_type="basic_resnet_fwse",
        stages_setup=((1, 4, 2, None, 48), (2, 4, 2, None, 48), (1, 6, 2, None, 48),
                      (2, 6, 1, None, 32), (1, 8, 1, None, 24), (2, 4, 1, None, 16)),
        group_divisor=1,
    ),
    "b5": dict(
        feat_dim=72, C=32, block_1d_type="conv+att", block_2d_type="basic_resnet_fwse",
        stages_setup=((1, 4, 2, None, 48), (2, 4, 2, None, 48), (1, 6, 2, None, 48),
                      (2, 6, 1, None, 32), (1, 8, 1, None, 24), (2, 4, 1, None, 16)),
        group_divisor=16,
    ),
    "b6": dict(
        feat_dim=72, C=32, block_1d_type="conv+att", block_2d_type="basic_resnet",
        stages_setup=((1, 4, 4, None, 32), (2, 6, 2, None, 32), (1, 6, 2, None, 24),
                      (3, 8, 1, None, 24), (1, 8, 1, None, 16), (2, 8, 1, None, 16)),
        group_divisor=32,
    ),
}


def new_gelu(x):
    """HF NewGELUActivation (the tanh approximation, redimnet.py:56-61)."""
    return Fn.gelu(x, approximate="tanh")


def to1d(x: torch.Tensor) -> torch.Tensor:
    """(B, C, F, T) → (B, T, F·C), channel index f·C + c (redimnet.py:48-53)."""
    B, C, Fq, T = x.shape
    return x.permute(0, 3, 2, 1).reshape(B, T, Fq * C)


def to2d(x: torch.Tensor, c: int, f: int) -> torch.Tensor:
    """(B, T, f·c) → (B, c, f, T) (redimnet.py:763-766)."""
    B, T, _ = x.shape
    return x.reshape(B, T, f, c).permute(0, 3, 2, 1)


def _groups(channels: int, group_divisor: Optional[int]) -> int:
    return channels // group_divisor if group_divisor is not None else 1


def _same(kernel) -> object:
    """flax padding "SAME" at stride 1 for odd kernels."""
    return tuple(k // 2 for k in kernel) if isinstance(kernel, tuple) else kernel // 2


class ConvNeXtLikeBlock(nn.Module):
    """dwconv(s) → BN → GELU → pointwise, residual (redimnet.py:135-165), on
    the 1-D view (B, T, C) when its kernels are ints, on the 2-D view
    (B, C, F, T) when they are (kf, kt) pairs."""

    def __init__(self, C: int, kernel_sizes: Sequence, group_divisor: Optional[int] = 1):
        super().__init__()
        self.two_d = not isinstance(kernel_sizes[0], int)
        conv = Conv2d if self.two_d else Conv1d
        groups = max(1, _groups(C, group_divisor))
        for i, ks in enumerate(kernel_sizes):
            ks = tuple(ks) if self.two_d else ks
            self.add_module(f"dwconv_{i}", conv(C, C, ks, padding=_same(ks), groups=groups))
        self.n = len(kernel_sizes)
        self.norm = BatchNorm(C * self.n)
        self.pwconv1 = conv(C * self.n, C, 1)

    def forward(self, x):
        h = x if self.two_d else x.transpose(1, 2)
        h = torch.cat([getattr(self, f"dwconv_{i}")(h) for i in range(self.n)], dim=1)
        h = self.pwconv1(Fn.gelu(self.norm(h)))
        return x + (h if self.two_d else h.transpose(1, 2))


class FwSEBlock(nn.Module):
    """Frequency-wise squeeze-excitation (redimnet.py:435-459)."""

    def __init__(self, num_freq: int, se_channels: int = 64):
        super().__init__()
        self.squeeze = Linear(num_freq, se_channels)
        self.exitation = Linear(se_channels, num_freq)

    def forward(self, x):  # (B, C, F, T); squeeze over (C, T)
        s = torch.sigmoid(self.exitation(torch.relu(self.squeeze(x.mean(dim=(1, 3))))))
        return x * s[:, None, :, None]


class ResBasicBlock(nn.Module):
    """Grouped 3×3 residual block, optional fwSE (redimnet.py:462-538)."""

    def __init__(self, in_planes: int, planes: int, num_freq: int, se_channels: int = 64,
                 group_divisor: Optional[int] = 4, use_fwse: bool = False):
        super().__init__()
        gd = group_divisor
        c1_out = in_planes if gd is not None else planes
        self.conv1 = Conv2d(in_planes, c1_out, 3, padding=1, bias=False, groups=_groups(in_planes, gd))
        if gd is not None:
            self.conv1pw = Conv2d(c1_out, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False, groups=_groups(planes, gd))
        if gd is not None:
            self.conv2pw = Conv2d(planes, planes, 1)
        self.bn2 = BatchNorm(planes)
        if use_fwse:
            self.se = FwSEBlock(num_freq, se_channels)
        if planes != in_planes:
            self.downsample_conv = Conv2d(in_planes, planes, 1, bias=False)
            self.downsample_bn = BatchNorm(planes)
        self.grouped, self.use_fwse, self.has_shortcut = gd is not None, use_fwse, planes != in_planes

    def forward(self, x):
        h = self.conv1(x)
        if self.grouped:
            h = self.conv1pw(h)
        h = self.bn1(torch.relu(h))
        h = self.conv2(h)
        if self.grouped:
            h = self.conv2pw(h)
        h = self.bn2(h)
        if self.use_fwse:
            h = self.se(h)
        sc = self.downsample_bn(self.downsample_conv(x)) if self.has_shortcut else x
        return torch.relu(h + sc)


class ConvBlock2d(nn.Module):
    """Dispatch on block_2d_type (redimnet.py:168-204)."""

    def __init__(self, c: int, f: int, block_type: str = "convnext_like", group_divisor: Optional[int] = 1):
        super().__init__()
        if block_type == "convnext_like":
            self.conv_block = ConvNeXtLikeBlock(c, [(3, 3)], group_divisor)
        elif block_type in ("basic_resnet", "basic_resnet_fwse"):
            self.conv_block = ResBasicBlock(c, c, f, se_channels=min(64, max(c, 32)), group_divisor=group_divisor,
                                            use_fwse=block_type == "basic_resnet_fwse")
        else:
            raise NotImplementedError(block_type)

    def forward(self, x):
        return self.conv_block(x)


class RDNAttention(nn.Module):
    """Plain MHA with pre-scaled queries, softmax in fp32 (redimnet.py:207-274)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(n, Linear(embed_dim, embed_dim))

    def forward(self, x):
        B, T, E = x.shape
        H = self.num_heads
        D = E // H
        q = (self.q_proj(x) * D**-0.5).view(B, T, H, D).transpose(1, 2)
        k = self.k_proj(x).view(B, T, H, D).transpose(1, 2)
        v = self.v_proj(x).view(B, T, H, D).transpose(1, 2)
        a = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float(), dim=-1).to(v.dtype)
        return self.out_proj(torch.matmul(a, v).transpose(1, 2).reshape(B, T, E))


class RDNTransformerLayer(nn.Module):
    """Post-norm layer (redimnet.py:277-329): x + attn → LN → + FF (NewGELU) → LN."""

    def __init__(self, n_state: int, n_mlp: int, n_head: int = 4):
        super().__init__()
        self.attention = RDNAttention(n_state, n_head)
        self.layer_norm = LayerNorm(n_state)
        self.ff_intermediate = Linear(n_state, n_mlp)
        self.ff_output = Linear(n_mlp, n_state)
        self.final_layer_norm = LayerNorm(n_state)

    def forward(self, x):
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.ff_output(new_gelu(self.ff_intermediate(x))))


class PosEncConv(nn.Module):
    """Depthwise conv positional encoding, residual (redimnet.py:119-132)."""

    def __init__(self, C: int, ks: int):
        super().__init__()
        self.conv = Conv1d(C, C, ks, padding=ks // 2, groups=C)
        self.norm = LayerNorm(C)

    def forward(self, x):  # (B, T, C)
        return x + self.norm(self.conv(x.transpose(1, 2)).transpose(1, 2))


class TimeContextBlock1d(nn.Module):
    """1-D time-context block over (B, T, C) (redimnet.py:541-620)."""

    def __init__(self, C: int, hC: int, pos_ker_sz: int = 59, block_type: str = "att"):
        super().__init__()
        self.block_type = block_type
        self.red_dim_conv = Conv1d(C, hC, 1)
        self.red_dim_norm = LayerNorm(hC)
        if block_type == "fc":
            self.tcm_fc1 = Conv1d(hC, 2 * hC, 1)
            self.tcm_norm = LayerNorm(2 * hC)
            self.tcm_fc2 = Conv1d(2 * hC, hC, 1)
        elif block_type == "gru":
            self.gru_fwd = GRU(hC, hC)
            self.gru_bwd = GRU(hC, hC, reverse=True)
            self.tcm_gru_proj = Conv1d(2 * hC, hC, 1)
        elif block_type == "att":
            self.tcm_pos = PosEncConv(hC, pos_ker_sz)
            self.tcm_att = RDNTransformerLayer(hC, 2 * hC, 4)
        elif block_type == "conv+att":
            for i, ks in enumerate((7, 19, 31, 59)):
                self.add_module(f"tcm_conv_{i}", ConvNeXtLikeBlock(hC, [ks], 1))
            self.tcm_att = RDNTransformerLayer(hC, hC, 4)
        else:
            raise NotImplementedError(block_type)
        self.exp_dim_conv = Conv1d(hC, C, 1)

    @staticmethod
    def _pw(conv, x):  # a 1×1 conv on (B, T, C)
        return conv(x.transpose(1, 2)).transpose(1, 2)

    def forward(self, x):
        h = self.red_dim_norm(self._pw(self.red_dim_conv, x))
        if self.block_type == "fc":
            h = self._pw(self.tcm_fc2, Fn.gelu(self.tcm_norm(self._pw(self.tcm_fc1, h))))
        elif self.block_type == "gru":
            h = torch.cat([self.gru_fwd(h), self.gru_bwd(h)], dim=-1).to(x.dtype)
            h = self._pw(self.tcm_gru_proj, h)
        elif self.block_type == "att":
            h = self.tcm_att(self.tcm_pos(h))
        else:
            for i in range(4):
                h = getattr(self, f"tcm_conv_{i}")(h)
            h = self.tcm_att(h)
        return x + self._pw(self.exp_dim_conv, h)


class ReDimNetStage(nn.Module):
    """freq-pool conv → 2-D blocks → (squeeze back) → to1d → optional
    time-context block (redimnet.py:689-745)."""

    def __init__(self, cur_c: int, cur_f: int, stride: int, num_blocks: int, conv_exp: int,
                 att_block_red: Optional[int], block_1d_type: str, block_2d_type: str,
                 group_divisor: Optional[int], CF: int):
        super().__init__()
        self.c, self.f, self.conv_exp = cur_c, cur_f, conv_exp
        new_c, new_f = stride * cur_c, cur_f // stride
        self.pool_conv = Conv2d(cur_c, new_c * conv_exp, (stride, 1), stride=(stride, 1))
        for i in range(num_blocks):
            self.add_module(f"block_{i}", ConvBlock2d(new_c * conv_exp, new_f, block_2d_type, group_divisor))
        self.num_blocks = num_blocks
        if conv_exp != 1:
            self.squeeze_conv = Conv2d(new_c * conv_exp, new_c, 3, padding=1, groups=_groups(new_c, group_divisor))
            self.squeeze_bn = BatchNorm(new_c, eps=1e-6)
            self.squeeze_pw = Conv2d(new_c, new_c, 1)
        if att_block_red is not None:
            self.tcb = TimeContextBlock1d(CF, CF // att_block_red, block_type=block_1d_type)

    def forward(self, x1d):
        h = self.pool_conv(to2d(x1d, self.c, self.f))
        for i in range(self.num_blocks):
            h = getattr(self, f"block_{i}")(h)
        if self.conv_exp != 1:
            h = self.squeeze_pw(Fn.gelu(self.squeeze_bn(self.squeeze_conv(h))))
        h = to1d(h)
        return self.tcb(h) if hasattr(self, "tcb") else h


class ReDimNetBone(nn.Module):
    """Stem + weighted-stage stack (+ MFA when `out_channels`) (redimnet.py:623-790)."""

    def __init__(self, F: int = 72, C: int = 16, block_1d_type: str = "conv+att",
                 block_2d_type: str = "basic_resnet", stages_setup: Sequence[StageSetup] = (),
                 group_divisor: Optional[int] = 1, out_channels: Optional[int] = 512):
        super().__init__()
        self.C, self.F = C, F
        CF = C * F
        self.stem_conv = Conv2d(1, C, 3, padding=1)
        self.stem_norm = LayerNorm(C)
        cur_c, cur_f = C, F
        for si, (stride, num_blocks, conv_exp, _ks, att_red) in enumerate(stages_setup):
            if si > 0:  # softmax over a single input is the identity: stage 0 has no weights
                self.register_parameter(f"inputs_weights_{si}", nn.Parameter(torch.zeros(si + 1, CF)))
            self.add_module(f"stage{si}", ReDimNetStage(cur_c, cur_f, stride, num_blocks, conv_exp, att_red,
                                                        block_1d_type, block_2d_type, group_divisor, CF))
            cur_c, cur_f = cur_c * stride, cur_f // stride
        n = len(stages_setup)
        self.n_stages = n
        self.register_parameter(f"inputs_weights_{n}", nn.Parameter(torch.zeros(n + 1, CF)))
        self.has_mfa = out_channels is not None
        if self.has_mfa:
            self.mfa_conv = Conv1d(CF, out_channels, 1)
            self.mfa_bn = BatchNorm(out_channels)
        self.out_channels = out_channels if self.has_mfa else CF

    def _mix(self, outs, si: int) -> torch.Tensor:
        ws = torch.softmax(getattr(self, f"inputs_weights_{si}"), dim=0).to(outs[0].dtype)
        return torch.einsum("nc,nbtc->btc", ws, torch.stack(outs, dim=0))

    def forward(self, fbank):
        x = self.stem_conv(fbank.transpose(1, 2)[:, None])  # (B, C, F, T)
        outs = [to1d(self.stem_norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2))]  # LayerNorm over C
        for si in range(self.n_stages):
            outs.append(getattr(self, f"stage{si}")(outs[0] if si == 0 else self._mix(outs, si)))
        x = self._mix(outs, self.n_stages)
        if self.has_mfa:
            x = self.mfa_bn(self.mfa_conv(x.transpose(1, 2))).transpose(1, 2)
        return x  # (B, T, out_channels) at 100 Hz


class ReDimNet(nn.Module):
    """Full ReDimNet: 'frames' (B, T, C·F) at 100 Hz or the ASTP embedding.

    `size` picks a factory config (REDIMNET_SIZES); the explicit fields
    override it. The embedding head is wespeaker ASTP with global context
    (pooling_layers_wespeaker.py:91-144), its statistics in fp32.
    """

    def __init__(self, size: Optional[str] = "b2", feat_dim: Optional[int] = None, C: Optional[int] = None,
                 stages_setup: Optional[Sequence[StageSetup]] = None, block_1d_type: Optional[str] = None,
                 block_2d_type: Optional[str] = None, group_divisor: Optional[int] = None,
                 out_channels: Optional[int] = None, embed_dim: int = 192, global_context_att: bool = True,
                 with_head: bool = True):
        super().__init__()
        cfg = dict(REDIMNET_SIZES[size]) if size else {}
        for k, v in dict(feat_dim=feat_dim, C=C, stages_setup=stages_setup, block_1d_type=block_1d_type,
                         block_2d_type=block_2d_type, group_divisor=group_divisor).items():
            if v is not None:
                cfg[k] = v
        self.feat_dim = cfg["feat_dim"]
        self.backbone = ReDimNetBone(F=cfg["feat_dim"], C=cfg["C"], block_1d_type=cfg["block_1d_type"],
                                     block_2d_type=cfg["block_2d_type"], stages_setup=cfg["stages_setup"],
                                     group_divisor=cfg["group_divisor"], out_channels=out_channels)
        D = self.out_channels = self.backbone.out_channels
        self.global_context_att, self.with_head = global_context_att, with_head
        if with_head:
            self.pool_linear1 = Linear(3 * D if global_context_att else D, 128)
            self.pool_linear2 = Linear(128, D)
            self.seg_1 = Linear(2 * D, embed_dim)

    def forward(self, fbank, mode: Literal["frames", "embedding"] = "embedding"):
        out = self.backbone(fbank)
        if mode == "frames":
            return out
        if not self.with_head:
            raise ValueError("embedding mode needs ReDimNet(with_head=True)")
        xf = out.float()
        if self.global_context_att:
            mean = xf.mean(dim=1, keepdim=True)
            std = torch.sqrt(xf.var(dim=1, unbiased=True, keepdim=True) + 1e-7)
            ctx = torch.cat([xf, mean.expand_as(xf), std.expand_as(xf)], dim=-1)
        else:
            ctx = xf
        a = torch.softmax(self.pool_linear2(torch.tanh(self.pool_linear1(ctx))), dim=1)
        mu = (a * xf).sum(dim=1)
        sg = torch.sqrt(torch.clamp_min((a * xf * xf).sum(dim=1) - mu * mu, 1e-7))
        return self.seg_1(torch.cat([mu, sg], dim=-1).to(fbank.dtype))
