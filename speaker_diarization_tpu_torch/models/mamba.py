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

Mamba2Layer/BiMamba2Block (the SSD scan) are not ported yet and raise.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as Fn

from ..ops.mamba_scan import selective_scan_auto
from .layers import Linear
from .transformer import LayerNorm


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


class Mamba2Layer(nn.Module):
    """Mamba-2 mixer on the chunked SSD scan: not ported yet."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        raise NotImplementedError("Mamba2Layer (SSD scan) is not ported to PyTorch yet (ROADMAP item 7)")


class BiMamba2Block(nn.Module):
    """Bidirectional Mamba-2 stack: not ported yet."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        raise NotImplementedError("BiMamba2Block (SSD scan) is not ported to PyTorch yet (ROADMAP item 7)")
