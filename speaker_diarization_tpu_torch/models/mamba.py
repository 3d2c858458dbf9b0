"""Bidirectional Mamba (S6) blocks: the TS-VAD Mamba backends.

Counterpart of speaker_diarization_tpu/models/mamba.py (`MambaLayer`,
`BiMambaBlock`; reference egs/alimeeting/ts_vad2/mamba.py), with the flax
module's numerics and parameter names:

- in_proj → causal depthwise conv (flax WIO kernel (d_conv, 1, d_inner) held
  here as `conv.weight` (d_inner, 1, d_conv), left pad d_conv − 1, no flip;
  the fp32 bias is added after the conv, so in bf16 the sum is fp32 as in
  JAX) → SiLU → x_proj → (Δ, B, C) → softplus(dt_proj(Δ)) → selective scan
  on fp32 inputs (the K3 kernels through `ops.mamba_scan.selective_scan_auto`)
  → y·SiLU(z) → out_proj;
- A = −exp(A_log), skip D; the reverse direction runs on torch.flip(·, [1]);
- BiMambaBlock: pre-LayerNorm residual layers merged by concat + linear or
  by add, and a final LayerNorm (eps 1e-6, flax's default).

`Mamba2Layer` / `BiMamba2Block` (JAX mamba.py:110-223; reference
`mamba_ssm.modules.mamba2.Mamba2` as stacked by ts_vad2/mamba.py:150-233):

- in_proj → [z | xBC | dt]; a causal depthwise conv over xBC (flax WIO
  kernel (d_conv, 1, d_xbc) held as `conv.weight` (d_xbc, 1, d_conv), left
  pad d_conv − 1, the fp32 bias added after the conv) → SiLU → x, B, C;
- dt = softplus(dt + dt_bias) in fp32, A = −exp(A_log) one scalar per head,
  then the chunked SSD scan (ops/ssd.py, plain torch ops: the JAX scan has
  no Pallas kernel) on fp32 inputs, plus D·x;
- the gated RMSNorm: y·SiLU(z), then RMSNorm (eps 1e-6 as flax's, a scale
  and no bias, normalised in fp32), then out_proj;
- BiMamba2Block: pre-RMSNorm residual layers, the reverse direction on the
  flipped sequence, merged by concat + linear or by add, a final RMSNorm.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as Fn

from ..ops.mamba_scan import selective_scan_auto
from ..ops.ssd import ssd_chunked
from .layers import Linear
from .transformer import LN_EPS, LayerNorm


class MambaLayer(nn.Module):
    """(B, T, d_model) → (B, T, d_model), causal, computed in x.dtype."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2, dt_rank: int = 0):
        super().__init__()
        d_inner = expand * d_model
        dt_rank = dt_rank or -(-d_model // 16)
        self.d_inner, self.d_state, self.d_conv, self.dt_rank = d_inner, d_state, d_conv, dt_rank
        self.in_proj = Linear(d_model, 2 * d_inner, bias=False)
        self.conv = nn.Conv1d(d_inner, d_inner, d_conv, groups=d_inner)
        self.x_proj = Linear(d_inner, dt_rank + 2 * d_state, bias=False)
        self.dt_proj = Linear(dt_rank, d_inner)
        self.A_log = nn.Parameter(torch.log(torch.arange(1, d_state + 1, dtype=torch.float32)).repeat(d_inner, 1))
        self.D = nn.Parameter(torch.ones(d_inner))
        self.out_proj = Linear(d_inner, d_model, bias=False)

    def forward(self, x):
        cdt = x.dtype
        xi, z = self.in_proj(x).chunk(2, dim=-1)
        xi = Fn.pad(xi.transpose(1, 2), (self.d_conv - 1, 0))
        xi = Fn.conv1d(xi, self.conv.weight.to(cdt), None, groups=self.d_inner).transpose(1, 2)
        xi = Fn.silu(xi.float() + self.conv.bias)  # fp32, as the JAX bias add promotes
        dt, Bm, C = self.x_proj(xi.to(cdt)).split([self.dt_rank, self.d_state, self.d_state], dim=-1)
        delta = Fn.softplus(self.dt_proj(dt))
        A = -torch.exp(self.A_log)
        y = selective_scan_auto(xi, delta.float(), A, Bm.float(), C.float(), self.D).to(cdt)
        return self.out_proj(y * Fn.silu(z))


class BiMambaBlock(nn.Module):
    """Residual stack of bidirectional Mamba layers; output (B, T, d_model).

    merge 'concat' (fwd ‖ bwd → linear) or 'add'.
    """

    def __init__(self, d_model: int, n_layer: int = 2, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 merge: str = "concat"):
        super().__init__()
        if merge not in ("concat", "add"):
            raise ValueError(f"merge must be 'concat' or 'add', got {merge!r}")
        self.n_layer, self.merge = n_layer, merge
        for i in range(n_layer):
            self.add_module(f"norm_{i}", LayerNorm(d_model))
            self.add_module(f"fwd_{i}", MambaLayer(d_model, d_state, d_conv, expand))
            self.add_module(f"bwd_{i}", MambaLayer(d_model, d_state, d_conv, expand))
            if merge == "concat":
                self.add_module(f"merge_{i}", Linear(2 * d_model, d_model, bias=False))
        self.norm_out = LayerNorm(d_model)

    def forward(self, x, generator=None):  # no dropout: `generator` is unused
        h = x
        for i in range(self.n_layer):
            hn = getattr(self, f"norm_{i}")(h)
            fwd = getattr(self, f"fwd_{i}")(hn)
            bwd = getattr(self, f"bwd_{i}")(torch.flip(hn, [1])).flip(1)
            if self.merge == "add":
                h = h + fwd + bwd
            else:
                h = h + getattr(self, f"merge_{i}")(torch.cat([fwd, bwd], dim=-1))
        return self.norm_out(h)


class RMSNorm(nn.Module):
    """flax nn.RMSNorm: a scale, no bias, eps 1e-6, normalised in fp32 and
    cast back to the input's dtype."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, x):
        xf = x.float()
        return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + LN_EPS) * self.weight).to(x.dtype)


class Mamba2Layer(nn.Module):
    """(B, T, d_model) → (B, T, d_model), causal, computed in x.dtype with
    the scan in fp32. Seeded weights come from `layers.init_weights_` (the
    JAX draws for A_log and dt_bias); until then A_log, dt_bias and D hold
    deterministic values inside the JAX init ranges."""

    def __init__(self, d_model: int, d_state: int = 64, d_conv: int = 4, expand: int = 2, headdim: int = 64):
        super().__init__()
        d_inner = expand * d_model
        if d_inner % headdim:
            raise ValueError(f"d_inner {d_inner} must be a multiple of headdim {headdim}")
        H = d_inner // headdim
        self.d_inner, self.d_state, self.d_conv, self.headdim = d_inner, d_state, d_conv, headdim
        self.d_xbc = d_inner + 2 * d_state  # x and one group of B and C (JAX ngroups 1)
        self.in_proj = Linear(d_model, d_inner + self.d_xbc + H, bias=False)
        self.conv = nn.Conv1d(self.d_xbc, self.d_xbc, d_conv, groups=self.d_xbc)
        # softplus(dt_bias) spans [1e-3, 1e-1] and A spans [1, 16], the JAX init ranges
        dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), H))
        self.dt_bias = nn.Parameter(dt + torch.log(-torch.expm1(-dt)))
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, H)))
        self.D = nn.Parameter(torch.ones(H))
        self.norm = RMSNorm(d_inner)
        self.out_proj = Linear(d_inner, d_model, bias=False)

    def forward(self, x):
        cdt = x.dtype
        B, T, _ = x.shape
        H, P, N = self.d_inner // self.headdim, self.headdim, self.d_state
        z, xbc, dt = self.in_proj(x).split([self.d_inner, self.d_xbc, H], dim=-1)
        xbc = Fn.pad(xbc.transpose(1, 2), (self.d_conv - 1, 0))
        xbc = Fn.conv1d(xbc, self.conv.weight.to(cdt), None, groups=self.d_xbc).transpose(1, 2)
        xbc = Fn.silu(xbc.float() + self.conv.bias)  # fp32, as the JAX bias add promotes
        xi, Bm, Cm = xbc.split([self.d_inner, N, N], dim=-1)
        dt = Fn.softplus(dt.float() + self.dt_bias)
        y = ssd_chunked(xi.reshape(B, T, H, P), dt, -torch.exp(self.A_log), Bm[:, :, None], Cm[:, :, None], self.D)
        y = y.reshape(B, T, self.d_inner).to(cdt) * Fn.silu(z)
        return self.out_proj(self.norm(y))


class BiMamba2Block(nn.Module):
    """Residual stack of bidirectional Mamba-2 layers; output (B, T, d_model).

    merge 'concat' (fwd ‖ bwd → linear back to d_model) or 'add'.
    """

    def __init__(self, d_model: int, n_layer: int = 2, d_state: int = 64, d_conv: int = 4, expand: int = 2,
                 headdim: int = 64, merge: str = "concat"):
        super().__init__()
        if merge not in ("concat", "add"):
            raise ValueError(f"merge must be 'concat' or 'add', got {merge!r}")
        self.n_layer, self.merge = n_layer, merge
        for i in range(n_layer):
            self.add_module(f"norm_{i}", RMSNorm(d_model))
            self.add_module(f"fwd_{i}", Mamba2Layer(d_model, d_state, d_conv, expand, headdim))
            self.add_module(f"bwd_{i}", Mamba2Layer(d_model, d_state, d_conv, expand, headdim))
            if merge == "concat":
                self.add_module(f"merge_{i}", Linear(2 * d_model, d_model, bias=False))
        self.norm_out = RMSNorm(d_model)

    forward = BiMambaBlock.forward
