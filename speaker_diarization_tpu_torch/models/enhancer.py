"""Learned speech enhancement: a compact spectral-masking denoiser, PyTorch.

Counterpart of speaker_diarization_tpu/models/enhancer.py, the trainable
stand-in for the external ZipEnhancer / GTCRN models the reference's ts_vad2
recipes denoise with (offline_add_noise_and_speech_enhance.py; dataset hooks
ts_vad_dataset.py:423-492):

  STFT (reflect pad, periodic hann, `torch.fft.rfft`) → log1p magnitude →
  n_convs × (Conv k5 SAME → LayerNorm eps 1e-6 → tanh-form GELU, flax
  `nn.gelu`'s default) → GRU forward and GRU on the reversed sequence
  (flax `GRUCell` under `nn.RNN`, the second `reverse=True,
  keep_order=True`) → sigmoid mask over the bins → masked STFT → ISTFT
  (irfft, then a window-normalised overlap-add).

The overlap-add sums ⌈n_fft/hop⌉ shifted views of the frames, oldest frame
first, so its sum order is fixed (no atomic scatter). The GRU is written
out: gates r, z, n; input Denses `ir`/`iz`/`in` with bias (`input`), hidden
Denses `hr`/`hz` without bias (`hidden`) and `hn` with bias (`hidden_n`);
h' = (1 − z)·n + z·h with an fp32 carry, the gates in the compute dtype and
promoted where they meet the carry, as JAX promotes them. Submodules carry
the flax names (`conv_i`, `ln_i`, `mask_head`; the GRUs, flax's
`GRUCell_0` and `GRUCell_1`, are `gru_fwd` and `gru_bwd`), so
utils/convert.enhancer_from_flax maps the JAX variables. `save_enhancer`
writes the config keys of the JAX npz beside flax-layout weights;
`load_enhancer` reads that npz and the JAX-written one (flax msgpack bytes
under `params`, decoded by utils/msgpack.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as Fn

from ..utils.device import resolve_dtype
from .eend import materialize_
from .layers import Conv1d, Linear
from .transformer import LayerNorm

CONFIG_KEYS = ("n_fft", "hop", "hidden", "conv_channels", "n_convs")


@dataclass(frozen=True)
class EnhancerConfig:
    n_fft: int = 512
    hop: int = 128
    hidden: int = 96
    conv_channels: int = 48
    n_convs: int = 3


def _hann(n_fft: int, device) -> torch.Tensor:
    return torch.from_numpy(np.hanning(n_fft + 1)[:-1].astype(np.float32)).to(device)


def stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, N) fp32 → complex (B, T, F); hann window, reflect-centred."""
    pad = n_fft // 2
    x = Fn.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop) * _hann(n_fft, x.device)
    return torch.fft.rfft(frames, dim=-1)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, T, n) frames hop apart → (B, (T−1)·hop + n) sums, each sample's
    frames added oldest first."""
    B, T, n = frames.shape
    r = -(-n // hop)
    f = Fn.pad(frames, (0, r * hop - n)).reshape(B, T, r, hop)
    out = torch.zeros((B, T + r - 1, hop), dtype=frames.dtype, device=frames.device)
    for j in reversed(range(r)):  # block b takes frame b − j's j-th piece
        out[:, j : j + T] += f[:, :, j]
    return out.reshape(B, -1)[:, : (T - 1) * hop + n]


def istft(X: torch.Tensor, n_fft: int, hop: int, n_samples: int) -> torch.Tensor:
    """complex (B, T, F) → (B, n_samples); window-normalised overlap-add."""
    win = _hann(n_fft, X.device)
    frames = torch.fft.irfft(X, n=n_fft, dim=-1) * win
    out = _overlap_add(frames, hop)
    norm = _overlap_add((win * win).expand(1, X.shape[1], n_fft), hop)
    out = out / torch.clamp_min(norm, 1e-8)
    pad = n_fft // 2
    return out[:, pad : pad + n_samples]


class GRU(nn.Module):
    """flax GRUCell unrolled over time by nn.RNN (`reverse`: last frame
    first, outputs in the input's order)."""

    def __init__(self, d_in: int, d: int, reverse: bool = False):
        super().__init__()
        self.input = Linear(d_in, 3 * d)  # ir | iz | in, with bias
        self.hidden = Linear(d, 2 * d, bias=False)  # hr | hz
        self.hidden_n = Linear(d, d)  # hn, with bias
        self.d = d
        self.reverse = reverse

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, d_in) in the compute dtype → outputs (B, T, d), fp32."""
        if self.reverse:
            x = x.flip(1)
        B, T, _ = x.shape
        D = self.d
        xi = self.input(x)
        h = torch.zeros((B, D), dtype=torch.float32, device=x.device)
        hs = []
        for t in range(T):
            hd = h.to(x.dtype)
            hrz = self.hidden(hd)
            r = torch.sigmoid(xi[:, t, :D] + hrz[:, :D])
            z = torch.sigmoid(xi[:, t, D : 2 * D] + hrz[:, D:])
            n = torch.tanh(xi[:, t, 2 * D :] + r * self.hidden_n(hd))
            h = ((1.0 - z) * n).float() + z.float() * h
            hs.append(h)
        out = torch.stack(hs, 1)
        return out.flip(1) if self.reverse else out


class MaskDenoiser(nn.Module):
    """(B, N) audio → (B, N) denoised audio, fp32. Built on `device` (None:
    CUDA, or raise without it) with fp32 weights drawn from `seed`; `dtype`
    is the compute dtype of the convs, GRUs and mask head (the STFT and
    ISTFT run in fp32)."""

    def __init__(
        self,
        cfg: EnhancerConfig = EnhancerConfig(),
        dtype: Union[str, torch.dtype] = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = resolve_dtype(dtype)
        bins = c.n_fft // 2 + 1
        with torch.device("meta"):
            d = bins
            for i in range(c.n_convs):
                self.add_module(f"conv_{i}", Conv1d(d, c.conv_channels, 5, padding=2))
                self.add_module(f"ln_{i}", LayerNorm(c.conv_channels))
                d = c.conv_channels
            self.gru_fwd = GRU(d, c.hidden)
            self.gru_bwd = GRU(d, c.hidden, reverse=True)
            self.mask_head = Linear(2 * c.hidden, bins)
        materialize_(self, device, seed)

    @property
    def device(self) -> torch.device:
        return self.mask_head.weight.device

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        n = audio.shape[-1]
        X = stft(audio.float(), c.n_fft, c.hop)  # (B, T, F)
        h = torch.log1p(X.abs()).to(self.dtype)
        for i in range(c.n_convs):
            h = getattr(self, f"conv_{i}")(h.transpose(1, 2)).transpose(1, 2)
            h = Fn.gelu(getattr(self, f"ln_{i}")(h), approximate="tanh")
        h = torch.cat([self.gru_fwd(h), self.gru_bwd(h)], dim=-1)  # fp32
        mask = torch.sigmoid(self.mask_head(h.to(self.dtype)))
        return istft(X * mask.float(), c.n_fft, c.hop, n)


def si_snr(est: torch.Tensor, ref: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SNR in dB, per batch row."""
    ref = ref - ref.mean(-1, keepdim=True)
    est = est - est.mean(-1, keepdim=True)
    proj = (est * ref).sum(-1, keepdim=True) / ((ref * ref).sum(-1, keepdim=True) + eps) * ref
    noise = est - proj
    return 10.0 * torch.log10(((proj * proj).sum(-1) + eps) / ((noise * noise).sum(-1) + eps))


def make_enhance_loss():
    """loss_fn(model, batch, generator, train) for MaskDenoiser: the
    negative mean SI-SNR of the denoised `noisy` against `clean`; aux
    carries the mean SI-SNR. The model has no dropout."""

    def loss_fn(model, batch, generator, train):
        snr = si_snr(model(batch["noisy"]), batch["clean"])
        return -snr.mean(), {"si_snr": snr.mean().detach()}

    return loss_fn


def save_enhancer(path: str, model: MaskDenoiser) -> None:
    """The config keys of the JAX npz (n_fft, hop, hidden, conv_channels,
    n_convs) beside the weights as flax-layout `params/...` arrays."""
    from ..utils.convert import enhancer_to_flax, save_flax_npz

    c = model.cfg
    save_flax_npz(path, enhancer_to_flax(model.state_dict()), **{k: np.asarray(getattr(c, k)) for k in CONFIG_KEYS})


def load_enhancer(path: str, device: Optional[Union[str, torch.device]] = None) -> MaskDenoiser:
    """A MaskDenoiser (fp32, eval mode) on `device` from `save_enhancer`'s
    npz, or from the JAX package's (its config keys beside the flax msgpack
    bytes of the params under `params`)."""
    from ..utils.convert import enhancer_from_flax, load_flax_npz
    from ..utils.msgpack import flax_variables

    with np.load(path, allow_pickle=False) as z:
        cfg = EnhancerConfig(**{k: int(z[k]) for k in CONFIG_KEYS})
        packed = z["params"].tobytes() if "params" in z.files else None
    if packed is not None:
        variables = flax_variables(packed, path)
    else:
        variables = {k: v for k, v in load_flax_npz(path).items() if k not in CONFIG_KEYS}
    model = MaskDenoiser(cfg, device=device)
    model.load_state_dict(enhancer_from_flax(variables))
    return model


def neural_enhancer_fn(path: str, device: Optional[Union[str, torch.device]] = None):
    """Enhancer callable `(audio, rate) -> audio` over a trained checkpoint
    (the dataset's enhancer hook, through data/enhance.get_enhancer). The
    model is loaded once on `device` (None: CUDA, or raise without it); each
    call is one forward of one chunk on the current stream, under no_grad,
    whatever its length, with nothing cached per length."""
    model = load_enhancer(path, device)

    @torch.no_grad()
    def enhance(audio: np.ndarray, rate: int) -> np.ndarray:
        x = torch.from_numpy(np.asarray(audio, np.float32)[None]).to(model.device)
        return model(x)[0].cpu().numpy().astype(audio.dtype)

    return enhance
