"""Plain PyTorch TS-VAD: the benchmark's reference for the CAM++ flagship.

Written from the published description of the model (the reference
recipe's egs/alimeeting/ts_vad2/model.py, wespeaker's CAM++, Mamba's S6
block) and independent of the measured package: it imports nothing of it.
Weights are a flat dict of tensors named as the measured model's
state_dict, so one set of seeded weights serves both sides.

  audio (B, N) at 16 kHz → kaldi fbank 80 (hamming, snip edges, mean-norm)
  → CAM++ frames at 50 Hz (FCM 2-D head, TDNN, three dense blocks of
    context-aware-masked layers, transits) → conv k5 s2 + BN + ReLU (25 Hz)
  → per speaker [target embedding ‖ frames] → shared single backend
  → speakers stacked, conv k5 + BN + ReLU → multi backend → linear → logits

Backends: post-norm transformer (sinusoidal positions, dropout on the
attention weights, after the FFN activation and on both residual branches)
or bidirectional Mamba (pre-LayerNorm residual layers, concat merge, a final
LayerNorm; the selective scan as the plain recurrence).

Everything is computed in float32 with TF32 off (`exact_fp32`). A
`Precision` with `fp8=True` holds in float8, with a per-tensor scale, what
the measured model holds in bfloat16 (the operands and outputs of products,
the outputs of normalisations; e4m3 values, e5m2 gradients): the control
that must fail the comparison.

Train mode uses batch statistics in BatchNorm (biased variance) and draws
dropout masks from a generator in the order the forward meets them, each
as `empty(shape).bernoulli_(1 - p)` in float32, so a generator seeded as
the measured trainer's yields its masks.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5
LN_EPS = 1e-6
FP8_MAX = 448.0  # largest finite float8 e4m3fn
FP8_E5M2_MAX = 57344.0  # largest finite float8 e5m2


@contextlib.contextmanager
def exact_fp32():
    """float32 products without TF32 for the duration."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _round(x: torch.Tensor, fmt: torch.dtype, top: float) -> torch.Tensor:
    """x rounded to the float8 format `fmt` under a per-tensor scale that maps its largest magnitude to `top`."""
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(fmt).to(torch.float32) / scale


class _Fp8(torch.autograd.Function):
    """Values rounded to float8 e4m3 going forward, gradients to e5m2 coming back."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, FP8_E5M2_MAX)


class Precision:
    """Where the measured model computes in bfloat16: float32 here, or float8
    (`fp8`): the operands and the outputs of every convolution and matrix
    product and the outputs of every normalisation held in e4m3, their
    gradients in e5m2. Statistics, softmax, the scan and the loss stay float32."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.fp8 else x


class Dropout:
    """Inverted dropout with masks drawn from `generator`; None: off."""

    def __init__(self, p: float, generator: Optional[torch.Generator]):
        self.p, self.generator = p, generator

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.generator is None or self.p == 0.0:
            return x
        keep = torch.empty(x.shape, device=x.device, dtype=torch.float32).bernoulli_(1.0 - self.p,
                                                                                    generator=self.generator)
        return x * (keep / (1.0 - self.p))


# ---------------------------------------------------------------------------
# kaldi fbank
# ---------------------------------------------------------------------------


def _mel_banks(num_bins: int, n_fft: int, sample_rate: int, low: float = 20.0) -> np.ndarray:
    """kaldi's triangular mel filters on the FFT bins below Nyquist."""
    mel = lambda f: 1127.0 * np.log(1.0 + f / 700.0)  # noqa: E731
    lo, hi = mel(low), mel(sample_rate / 2.0)
    step = (hi - lo) / (num_bins + 1)
    bins = mel(np.arange(n_fft // 2) * sample_rate / n_fft)
    w = np.zeros((num_bins, n_fft // 2 + 1))
    for b in range(num_bins):
        left, center, right = lo + b * step, lo + (b + 1) * step, lo + (b + 2) * step
        w[b, : n_fft // 2] = np.clip(np.minimum((bins - left) / (center - left), (right - bins) / (right - center)),
                                     0.0, None)
    return w


def fbank(audio: torch.Tensor, sample_rate: int, num_bins: int) -> torch.Tensor:
    """(B, N) in [-1, 1] → (B, T, num_bins) mean-normalised log mel energies
    (25 ms hamming frames every 10 ms, DC removed, pre-emphasis 0.97)."""
    win, shift = sample_rate * 25 // 1000, sample_rate * 10 // 1000
    n_fft = 1 << (win - 1).bit_length()
    frames = (audio.float() * 32768.0).unfold(-1, win, shift)
    frames = frames - frames.mean(-1, keepdim=True)
    frames = torch.cat([frames[..., :1] * 0.03, frames[..., 1:] - 0.97 * frames[..., :-1]], dim=-1)
    i = torch.arange(win, dtype=torch.float64)
    frames = frames * (0.54 - 0.46 * torch.cos(2 * math.pi * i / (win - 1))).float().to(audio.device)
    ang = -2.0 * math.pi * torch.outer(torch.arange(win, dtype=torch.float64),
                                       torch.arange(n_fft // 2 + 1, dtype=torch.float64)) / n_fft
    re = frames @ torch.cos(ang).float().to(audio.device)
    im = frames @ torch.sin(ang).float().to(audio.device)
    mel = torch.from_numpy(_mel_banks(num_bins, n_fft, sample_rate)).float().to(audio.device)
    feats = torch.log(torch.clamp_min((re * re + im * im) @ mel.T, torch.finfo(torch.float32).eps))
    return feats - feats.mean(-2, keepdim=True)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


class Net:
    """Weights `P` (name → tensor), the precision and the mode."""

    def __init__(self, P: Dict[str, torch.Tensor], prec: Precision, train: bool, stats: Optional[dict] = None):
        self.P, self.prec, self.train, self.stats = P, prec, train, stats

    def conv1d(self, x, name, stride=1, padding=0, dilation=1, groups=1):
        b = self.P.get(name + ".bias")
        q = self.prec.q
        return q(F.conv1d(q(x), q(self.P[name + ".weight"]), b, stride, padding, dilation, groups))

    def conv2d(self, x, name, stride=1, padding=0):
        q = self.prec.q
        return q(F.conv2d(q(x), q(self.P[name + ".weight"]), self.P.get(name + ".bias"), stride, padding))

    def linear(self, x, name):
        q = self.prec.q
        return q(F.linear(q(x), q(self.P[name + ".weight"]), self.P.get(name + ".bias")))

    def bn(self, x, name):
        """BatchNorm over dim 1: batch statistics in train mode, running ones in eval."""
        shape = [1, -1] + [1] * (x.dim() - 2)
        if self.train:
            dims = [0, *range(2, x.dim())]
            mean, var = x.mean(dims), x.var(dims, unbiased=False)
            if self.stats is not None:  # a recomputation stores the same values again
                self.stats[name] = (mean.detach(), var.detach())
        else:
            mean, var = self.P[name + ".running_mean"], self.P[name + ".running_var"]
        y = (x - mean.view(shape)) / torch.sqrt(var.view(shape) + BN_EPS)
        w = self.P.get(name + ".weight")
        return self.prec.q(y if w is None else y * w.view(shape) + self.P[name + ".bias"].view(shape))

    def ln(self, x, name):
        return self.prec.q(F.layer_norm(x, x.shape[-1:], self.P[name + ".weight"], self.P[name + ".bias"], LN_EPS))

    def matmul(self, a, b):
        q = self.prec.q
        return q(torch.matmul(q(a), q(b)))


def _grad_ckpt(fn, *args):
    """fn(*args), its activations recomputed in the backward when grads flow."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in args if torch.is_tensor(a)):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# CAM++ frames
# ---------------------------------------------------------------------------


def _res_block(n: Net, x, name, stride):
    h = torch.relu(n.bn(n.conv2d(x, name + ".conv1", (stride, 1), 1), name + ".bn1"))
    h = n.bn(n.conv2d(h, name + ".conv2", 1, 1), name + ".bn2")
    if name + ".shortcut.0.weight" in n.P:
        x = n.bn(n.conv2d(x, name + ".shortcut.0", (stride, 1), 0), name + ".shortcut.1")
    return torch.relu(h + x)


def _fcm(n: Net, feats):
    """(B, T, F) fbank → (B, 32·F/8, T): the 2-D residual head."""
    p = "speech_encoder.head"
    h = torch.relu(n.bn(n.conv2d(feats.transpose(1, 2).unsqueeze(1), p + ".conv1", 1, 1), p + ".bn1"))
    for group in ("layer1", "layer2"):
        i = 0
        while f"{p}.{group}.{i}.conv1.weight" in n.P:
            h = _res_block(n, h, f"{p}.{group}.{i}", 2 if i == 0 else 1)
            i += 1
    h = torch.relu(n.bn(n.conv2d(h, p + ".conv2", (2, 1), 1), p + ".bn2"))
    B, C, Fq, T = h.shape
    return h.reshape(B, C * Fq, T)


def _segment_means(x, seg: int = 100):
    """(B, C, T) → each frame's mean over its 100-frame segment (the last may be short)."""
    T = x.shape[-1]
    return F.avg_pool1d(x, seg, seg, ceil_mode=True).repeat_interleave(seg, dim=-1)[..., :T]


def _dense_layer(n: Net, x, name, dilation):
    h = torch.relu(n.bn(x, name + ".nonlinear1.batchnorm"))
    h = torch.relu(n.bn(n.conv1d(h, name + ".linear1"), name + ".nonlinear2.batchnorm"))
    c = name + ".cam_layer"
    y = n.conv1d(h, c + ".linear_local", padding=dilation, dilation=dilation)
    context = h.mean(-1, keepdim=True) + _segment_means(h)
    m = torch.sigmoid(n.conv1d(torch.relu(n.conv1d(context, c + ".linear1")), c + ".linear2"))
    return y * m


def campplus_frames(n: Net, feats, dilations=(1, 2, 2)):
    """(B, T100, 80) → (B, ceil(T/2), 512) frames at 50 Hz."""
    x = "speech_encoder.xvector"
    h = torch.relu(n.bn(n.conv1d(_fcm(n, feats), x + ".tdnn.linear", stride=2, padding=2),
                        x + ".tdnn.nonlinear.batchnorm"))
    for b, dil in enumerate(dilations, start=1):
        i = 1
        while f"{x}.block{b}.tdnnd{i}.linear1.weight" in n.P:
            name = f"{x}.block{b}.tdnnd{i}"
            h = torch.cat([h, _grad_ckpt(lambda t, nm=name, d=dil: _dense_layer(n, t, nm, d), h)], dim=1)
            i += 1
        t = f"{x}.transit{b}"
        h = n.conv1d(torch.relu(n.bn(h, t + ".nonlinear.batchnorm")), t + ".linear")
    return torch.relu(n.bn(h, x + ".out_nonlinear.batchnorm")).transpose(1, 2)


def _conv_bn_relu(n: Net, x, name, stride):
    """(B, T, Cin) → (B, T', Cout): conv k5 (padding 2) + BN + ReLU."""
    return torch.relu(n.bn(n.conv1d(x.transpose(1, 2), name + ".conv", stride=stride, padding=2),
                           name + ".bn")).transpose(1, 2)


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


def positions(T: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(T, dtype=torch.float64)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64) * (-math.log(10000.0) / d))
    pe = torch.zeros(T, d, dtype=torch.float64)
    pe[:, 0::2], pe[:, 1::2] = torch.sin(pos * div), torch.cos(pos * div)
    return pe.float().to(device)


def _attention(n: Net, x, name, heads, drop):
    B, T, D = x.shape
    hd = D // heads
    split = lambda t: t.view(B, T, heads, hd).transpose(1, 2)  # noqa: E731
    q = split(n.linear(x, name + ".query")) / math.sqrt(hd)
    k, v = split(n.linear(x, name + ".key")), split(n.linear(x, name + ".value"))
    w = drop(torch.softmax(n.matmul(q, k.transpose(-1, -2)), dim=-1))
    return n.linear(n.matmul(w, v).transpose(1, 2).reshape(B, T, D), name + ".out")


def transformer_backend(n: Net, x, name, heads, drop):
    x = drop(x + positions(x.shape[1], x.shape[2], x.device))
    i = 0
    while f"{name}.layer_{i}.ln1.weight" in n.P:
        p = f"{name}.layer_{i}"
        x = n.ln(x + drop(_attention(n, x, p + ".attn", heads, drop)), p + ".ln1")
        ff = n.linear(drop(torch.relu(n.linear(x, p + ".ff.dense0"))), p + ".ff.dense1")
        x = n.ln(x + drop(ff), p + ".ln2")
        i += 1
    return x


def selective_scan(x, delta, A, Bm, C, D):
    """h_t = exp(Δ_t A) h_{t-1} + Δ_t x_t B_t, y_t = C_t · h_t + D x_t; x, Δ (B, T, D), A (D, N)."""
    decay = torch.exp(delta[..., None] * A).unbind(1)  # T × (B, D, N)
    drive = ((delta * x)[..., None] * Bm[:, :, None, :]).unbind(1)
    h = x.new_zeros(x.shape[0], x.shape[2], A.shape[1])
    ys = []
    for a, b, c in zip(decay, drive, C.unsqueeze(-1).unbind(1)):
        h = torch.addcmul(b, a, h)
        ys.append(torch.bmm(h, c)[..., 0])
    return torch.stack(ys, dim=1) + x * D


def _mamba_layer(n: Net, x, name):
    """(B, T, d) → (B, T, d), causal."""
    xi, z = n.linear(x, name + ".in_proj").chunk(2, dim=-1)
    w = n.P[name + ".conv.weight"]
    k = w.shape[-1]
    xi = n.prec.q(F.conv1d(F.pad(n.prec.q(xi).transpose(1, 2), (k - 1, 0)), n.prec.q(w), None, groups=w.shape[0]))
    xi = F.silu(xi.transpose(1, 2) + n.P[name + ".conv.bias"])
    N = n.P[name + ".A_log"].shape[1]
    dt, Bm, C = n.linear(xi, name + ".x_proj").split([n.P[name + ".dt_proj.weight"].shape[1], N, N], dim=-1)
    delta = F.softplus(n.linear(dt, name + ".dt_proj"))
    y = selective_scan(xi, delta, -torch.exp(n.P[name + ".A_log"]), Bm, C, n.P[name + ".D"])
    return n.linear(y * F.silu(z), name + ".out_proj")


def mamba_backend(n: Net, x, name, rows: int):
    """Bidirectional Mamba layers; each direction in blocks of `rows` sequences."""

    def layer(t, nm):
        return torch.cat([_grad_ckpt(lambda u: _mamba_layer(n, u, nm), t[i: i + rows])
                          for i in range(0, t.shape[0], rows)])

    i = 0
    while f"{name}.norm_{i}.weight" in n.P:
        hn = n.ln(x, f"{name}.norm_{i}")
        fwd = layer(hn, f"{name}.fwd_{i}")
        bwd = layer(hn.flip(1), f"{name}.bwd_{i}").flip(1)
        x = x + n.linear(torch.cat([fwd, bwd], dim=-1), f"{name}.merge_{i}")
        i += 1
    return n.ln(x, name + ".norm_out")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def forward(P: Dict[str, torch.Tensor], cfg: dict, audio, target_embs, n_label: int, prec: Precision = Precision(),
            train: bool = False, generator: Optional[torch.Generator] = None, scan_rows: int = 128,
            stats: Optional[dict] = None):
    """→ logits (B, n_label, S). `cfg` holds the model's widths (TSVADConfig
    keys); in train mode `generator` draws the dropout masks and `stats`, if
    given, receives each BatchNorm's batch mean and biased variance."""
    n = Net(P, prec, train, stats)
    drop = Dropout(cfg["dropout"], generator if train else None)
    feats = fbank(audio, cfg["sample_rate"], cfg["feat_dim"])
    mix = _conv_bn_relu(n, campplus_frames(n, feats), "speech_down", stride=2)
    T = mix.shape[1]
    mix = F.pad(mix, (0, 0, 0, max(0, n_label - T)))[:, :n_label]
    B, T, D = mix.shape
    S = cfg["max_num_speaker"]
    ts = drop(target_embs.float())[:, :, None, :].expand(B, S, T, D)
    x = torch.cat([ts, mix[:, None].expand(B, S, T, D)], dim=-1).reshape(B * S, T, 2 * D)
    heads = cfg["num_attention_head"]

    def backend(h, name, kind):
        if kind == "transformer":
            return transformer_backend(n, h, name, heads, drop)
        if kind == "mamba":
            return mamba_backend(n, h, name, scan_rows)
        raise ValueError(f"the reference has no {kind!r} backend")

    x = backend(x, "single_backend", cfg["single_backend_type"])
    x = x.reshape(B, S, T, -1).transpose(1, 2).reshape(B, T, -1)
    x = _conv_bn_relu(n, x, "backend_down", stride=1)
    x = backend(x, "multi_backend", cfg["multi_backend_type"])
    return n.linear(x, "fc")


def bce_loss(logits, labels):
    """Mean binary cross-entropy on logits over every frame and speaker."""
    return F.binary_cross_entropy_with_logits(logits, labels)
