"""Kaldi fbank front-end (torchaudio.compliance.kaldi.fbank semantics).

Counterpart of speaker_diarization_tpu/ops/features.py (the kaldi part):

- `kaldi_fbank`: the host NumPy oracle, a verbatim copy of the JAX
  package's (snip_edges framing, hamming window, natural-log mel energies);
- `kaldi_fbank_torch`: the plain PyTorch twin of `kaldi_fbank_jax`, framing
  by `unfold` and the DFT as an fp32 matmul against a cos/sin basis;
- `kaldi_fbank_auto`: the batched entry the TS-VAD model calls. A CUDA
  tensor goes through the hand-written kernel (kernels/fbank.py, K1); a CPU
  tensor through the twin. Mean-norm runs outside the kernel in both.

The TS-VAD stack extracts 80-dim kaldi fbank with a hamming window and
mean-norm as CAM++ input (reference ts_vad_dataset.py:29-57).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host-side constants
# ---------------------------------------------------------------------------


def fft_size_for(frame_size: int) -> int:
    """Round frame_size up to the next power of two (reference stft:178)."""
    return 1 << (frame_size - 1).bit_length()


@functools.lru_cache(maxsize=8)
def _dft_basis(n_fft: int):
    """Real/imag DFT basis matrices (n_fft, n_bins) as float32 numpy."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None] * np.arange(n_bins)[None, :]
    ang = -2.0 * np.pi * t / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _hamming_window(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2 * np.pi * i / (n - 1))


@functools.lru_cache(maxsize=8)
def kaldi_mel_banks(num_bins: int, n_fft: int, sample_rate: int, low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Kaldi mel filterbank, (num_bins, n_fft//2 + 1); triangles are computed
    in mel space on FFT-bin center frequencies; the nyquist bin gets weight 0."""
    if high_freq <= 0:
        high_freq = sample_rate / 2.0 + high_freq
    mel = lambda f: 1127.0 * np.log(1.0 + f / 700.0)  # noqa: E731
    mel_lo, mel_hi = mel(low_freq), mel(high_freq)
    delta = (mel_hi - mel_lo) / (num_bins + 1)
    fft_freqs = np.arange(n_fft // 2) * sample_rate / n_fft  # kaldi: excludes nyquist
    fft_mels = mel(fft_freqs)
    weights = np.zeros((num_bins, n_fft // 2 + 1), dtype=np.float64)
    for b in range(num_bins):
        left, center, right = mel_lo + b * delta, mel_lo + (b + 1) * delta, mel_lo + (b + 2) * delta
        up = (fft_mels - left) / (center - left)
        down = (right - fft_mels) / (right - center)
        weights[b, : n_fft // 2] = np.clip(np.minimum(up, down), 0.0, None)
    return weights.astype(np.float32)


def frame_params(sample_rate: int, frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0):
    """(win, shift, n_fft) in samples for a kaldi frame configuration."""
    win = int(sample_rate * frame_length_ms / 1000)
    shift = int(sample_rate * frame_shift_ms / 1000)
    return win, shift, fft_size_for(win)


# ---------------------------------------------------------------------------
# Host (NumPy) oracle
# ---------------------------------------------------------------------------


def kaldi_fbank(
    waveform: np.ndarray,
    sample_rate: int = 16000,
    num_mel_bins: int = 80,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    dither: float = 0.0,
    preemphasis: float = 0.97,
    remove_dc_offset: bool = True,
    scale_to_int16: bool = True,
    mean_norm: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Host NumPy kaldi fbank: (n_samples,) float ∈ [-1,1] → (T, num_mel_bins).

    snip_edges=True framing, hamming window, natural-log mel energies.
    """
    x = np.asarray(waveform, dtype=np.float64)
    if scale_to_int16:
        x = x * 32768.0
    win = int(sample_rate * frame_length_ms / 1000)
    shift = int(sample_rate * frame_shift_ms / 1000)
    n_fft = fft_size_for(win)
    if len(x) < win:
        return np.zeros((0, num_mel_bins), np.float32)
    n_frames = 1 + (len(x) - win) // shift
    idx = np.arange(win)[None, :] + shift * np.arange(n_frames)[:, None]
    frames = x[idx]
    if dither != 0.0:
        rng = rng or np.random.default_rng()
        frames = frames + dither * rng.standard_normal(frames.shape)
    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis != 0.0:
        first = frames[:, :1] - preemphasis * frames[:, :1]
        frames = np.concatenate([first, frames[:, 1:] - preemphasis * frames[:, :-1]], axis=1)
    frames = frames * _hamming_window(win)[None, :]
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=1)) ** 2
    mel = kaldi_mel_banks(num_mel_bins, n_fft, sample_rate)
    feats = spec @ mel.T
    feats = np.log(np.maximum(feats, np.finfo(np.float32).eps))
    feats = feats.astype(np.float32)
    if mean_norm:
        feats = feats - feats.mean(axis=0, keepdims=True)
    return feats


# ---------------------------------------------------------------------------
# Batched PyTorch path
# ---------------------------------------------------------------------------


def kaldi_fbank_torch(
    waveform: torch.Tensor,
    sample_rate: int = 16000,
    num_mel_bins: int = 80,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    preemphasis: float = 0.97,
    remove_dc_offset: bool = True,
    scale_to_int16: bool = True,
    mean_norm: bool = True,
) -> torch.Tensor:
    """Plain batched kaldi fbank: (..., n) → (..., T, num_mel_bins), fp32.

    The twin of `kaldi_fbank_jax`: DFT-as-matmul in full fp32 (the caller's
    device must not allow TF32; utils.device.set_fp32_precision), no dither.
    """
    x = waveform.to(torch.float32)
    if scale_to_int16:
        x = x * 32768.0
    win, shift, n_fft = frame_params(sample_rate, frame_length_ms, frame_shift_ms)
    frames = x.unfold(-1, win, shift)  # (..., T, win)
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis != 0.0:
        first = frames[..., :1] * (1.0 - preemphasis)
        frames = torch.cat([first, frames[..., 1:] - preemphasis * frames[..., :-1]], dim=-1)
    window = torch.from_numpy(_hamming_window(win).astype(np.float32)).to(x.device)
    fw = frames * window
    cos_b, sin_b = _dft_basis(n_fft)
    # frames are win<n_fft wide; zero-pad via slicing the basis rows
    cb = torch.from_numpy(cos_b[:win]).to(x.device)
    sb = torch.from_numpy(sin_b[:win]).to(x.device)
    re = torch.matmul(fw, cb)
    im = torch.matmul(fw, sb)
    spec = re * re + im * im
    mel = torch.from_numpy(kaldi_mel_banks(num_mel_bins, n_fft, sample_rate)).to(x.device)
    feats = torch.matmul(spec, mel.T)
    feats = torch.log(torch.clamp_min(feats, float(np.finfo(np.float32).eps)))
    if mean_norm:
        feats = feats - feats.mean(dim=-2, keepdim=True)
    return feats


def kaldi_fbank_auto(
    waveform: torch.Tensor,
    sample_rate: int = 16000,
    num_mel_bins: int = 80,
    mean_norm: bool = True,
) -> torch.Tensor:
    """Batched (B, N) → (B, T, num_mel_bins) kaldi fbank.

    A CUDA tensor runs the hand-written fbank kernel (or raises); a CPU
    tensor runs the plain twin (`fbank_cuda` dispatches).
    """
    from ..kernels.fbank import fbank_cuda

    feats = fbank_cuda(waveform, sample_rate=sample_rate, num_mel_bins=num_mel_bins)
    if mean_norm:
        feats = feats - feats.mean(dim=-2, keepdim=True)
    return feats
