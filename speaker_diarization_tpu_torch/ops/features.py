"""Spectral front-ends: kaldi fbank (TS-VAD) and the EEND log-mel.

Counterpart of speaker_diarization_tpu/ops/features.py:

- `kaldi_fbank`: the host NumPy oracle, a verbatim copy of the JAX
  package's (snip_edges framing, hamming window, natural-log mel energies);
- `kaldi_fbank_torch`: the plain PyTorch twin of `kaldi_fbank_jax`, framing
  by `unfold` and the DFT as an fp32 matmul against a cos/sin basis;
- `kaldi_fbank_auto`: the batched entry the TS-VAD model calls. A CUDA
  tensor goes through the hand-written kernel (kernels/fbank.py, K1); a CPU
  tensor through the twin. Mean-norm runs outside the kernel in both.
- `logmel_frames_torch`: the plain twin of `logmel_frames_jax` (centered
  hann STFT, slaney mel of the power spectrum, log10), and
  `eend_frontend_auto`, the EEND family's entry: log-mel through K1′ on a
  CUDA tensor (the twin on a CPU one), then mean-norm, splice, subsample.
  The window, slaney mel bank and `count_frames` are copies of the JAX
  package's NumPy helpers.

The TS-VAD stack extracts 80-dim kaldi fbank with a hamming window and
mean-norm as CAM++ input (reference ts_vad_dataset.py:29-57); the EEND
family 23-dim 'logmel23_mn' at 8 kHz, spliced ±7 and subsampled ×10.
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


def hann_window(win_length: int, dtype=np.float64) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, as used by librosa.stft."""
    n = np.arange(win_length, dtype=dtype)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Center-pad a window to `size` samples (librosa util.pad_center)."""
    lpad = (size - len(window)) // 2
    return np.pad(window, (lpad, size - len(window) - lpad))


def _hz_to_mel_slaney(f):
    f = np.asanyarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep, mels)


def _mel_to_hz_slaney(m):
    m = np.asanyarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asanyarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asanyarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm: Optional[str] = "slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, (n_mels, 1 + n_fft//2).

    Matches librosa.filters.mel defaults (Slaney mel scale, Slaney area
    normalization) used throughout the reference's `transform()` family.
    """
    if fmax is None:
        fmax = sr / 2.0
    hz_to_mel = _hz_to_mel_htk if htk else _hz_to_mel_slaney
    mel_to_hz = _mel_to_hz_htk if htk else _mel_to_hz_slaney

    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    mel_f = mel_to_hz(mel_pts)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"unsupported mel norm: {norm}")
    return weights.astype(dtype)


def count_frames(data_len: int, frame_shift: int) -> int:
    """Number of STFT frames for centered framing with the reference's
    drop-excessive-last-frame rule (feature.py:188-192)."""
    n = 1 + data_len // frame_shift
    if data_len % frame_shift == 0:
        n -= 1
    return n


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


# ---------------------------------------------------------------------------
# EEND log-mel front-end ('logmel23_mn' → splice → subsample)
# ---------------------------------------------------------------------------


def logmel_frames_torch(
    audio: torch.Tensor,
    n_frames: int,
    frame_size: int = 400,
    frame_shift: int = 160,
    sample_rate: int = 16000,
    n_mels: int = 23,
    mean_norm: bool = True,
) -> torch.Tensor:
    """Plain batched log-mel: (..., n_samples) → (..., n_frames, n_mels), fp32.

    The twin of `logmel_frames_jax`: centered framing with n_fft//2 zeros on
    both sides, periodic hann of `frame_size` center-padded to n_fft, the
    DFT as an fp32 matmul, slaney mel of the power spectrum,
    log10(max(·, 1e-10)), then (optionally) mean-norm over time. `n_frames`
    is `count_frames(n_samples, frame_shift)`.
    """
    x = audio.to(torch.float32)
    n_fft = fft_size_for(frame_size)
    pad = n_fft // 2
    frames = torch.nn.functional.pad(x, (pad, pad)).unfold(-1, n_fft, frame_shift)[..., :n_frames, :]
    window = torch.from_numpy(pad_center(hann_window(frame_size), n_fft).astype(np.float32)).to(x.device)
    xw = frames * window
    cos_b, sin_b = _dft_basis(n_fft)
    re = torch.matmul(xw, torch.from_numpy(cos_b).to(x.device))
    im = torch.matmul(xw, torch.from_numpy(sin_b).to(x.device))
    mel = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels)).to(x.device)
    logmel = torch.log10(torch.clamp_min(torch.matmul(re * re + im * im, mel.T), 1e-10))
    if mean_norm:
        logmel = logmel - logmel.mean(dim=-2, keepdim=True)
    return logmel


def splice_subsample(Y: torch.Tensor, context_size: int, subsampling: int = 1) -> torch.Tensor:
    """Splice ±context_size frames (zero edges), then keep every
    `subsampling`-th frame: (..., T, d) → (..., ceil(T/ss), d·(2c+1)).

    Equal to the JAX package's `splice_jax(Y, c)[..., ::ss, :]`, but it
    gathers only the frames it keeps.
    """
    T = Y.shape[-2]
    if context_size == 0:
        return Y[..., ::subsampling, :]
    Yp = torch.nn.functional.pad(Y, (0, 0, context_size, context_size))
    return torch.cat([Yp[..., i : i + T : subsampling, :] for i in range(2 * context_size + 1)], dim=-1)


def eend_frontend_auto(
    audio: torch.Tensor,
    n_samples: int,
    frame_size: int = 200,
    frame_shift: int = 80,
    sample_rate: int = 8000,
    n_mels: int = 23,
    context_size: int = 7,
    subsampling: int = 10,
    mean_norm: bool = True,
) -> torch.Tensor:
    """EEND front-end: (B, n_samples) audio → (B, ceil(n_frames/ss), n_mels·(2c+1)).

    The counterpart of `eend_frontend_jax`. A CUDA tensor runs the
    hand-written log-mel kernel (K1′, or raises); a CPU tensor runs the
    plain twin (`logmel_cuda` dispatches). Mean-norm over all n_frames
    (a zero-padded tail included, as in JAX), splice and subsampling follow
    in plain PyTorch.
    """
    from ..kernels.fbank import logmel_cuda

    n_frames = count_frames(n_samples, frame_shift)
    lm = logmel_cuda(audio, n_frames, frame_size, frame_shift, sample_rate, n_mels)
    if mean_norm:
        lm = lm - lm.mean(dim=-2, keepdim=True)
    return splice_subsample(lm, context_size, subsampling)
