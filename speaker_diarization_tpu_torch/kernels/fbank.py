"""K1 and K1′: the spectral front-end kernel (csrc/fbank.cu) and its plain twins.

Replaces speaker_diarization_tpu/kernels/fbank_pallas.py (`_frontend_kernel`)
through both of its entries:

- `fbank_cuda` (K1, for `fbank_pallas`) computes what `kaldi_fbank_jax`
  computes up to the log (no mean-norm) for a CUDA tensor; its plain twin,
  used for CPU tensors and as the reference the kernel is held to on the
  card, is `ops.features.kaldi_fbank_torch(..., mean_norm=False)`;
- `logmel_cuda` (K1′, for `logmel_pallas`) computes what
  `logmel_frames_jax(..., mean_norm=False)` computes; its twin is
  `ops.features.logmel_frames_torch(..., mean_norm=False)`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import features as F


@functools.lru_cache(maxsize=8)
def _host_consts(sample_rate: int, num_mel_bins: int, win: int, n_fft: int) -> Dict[str, np.ndarray]:
    """K1's constants: hamming window of `win`, the kaldi mel bank."""
    return _banded(F.kaldi_mel_banks(num_mel_bins, n_fft, sample_rate), F._hamming_window(win), n_fft)


@functools.lru_cache(maxsize=8)
def _logmel_consts(sample_rate: int, n_mels: int, frame_size: int, n_fft: int) -> Dict[str, np.ndarray]:
    """K1′'s constants: periodic hann of `frame_size` center-padded to
    n_fft, the slaney mel bank."""
    window = F.pad_center(F.hann_window(frame_size), n_fft)
    return _banded(F.mel_filterbank(sample_rate, n_fft, n_mels), window, n_fft)


def _banded(mel: np.ndarray, window: np.ndarray, n_fft: int) -> Dict[str, np.ndarray]:
    """Window, FFT twiddles and the mel bank cut to each filter's band.

    mel_w[m, q] = mel[m, mel_start[m] + q] for q < mel_len, where the band
    covers every non-zero weight of filter m; weights outside a filter's
    triangle are exact zeros, so the banded sum equals the dense one.
    """
    half = n_fft // 2
    nz = mel > 0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), nz.shape[1] - 1 - nz[:, ::-1].argmax(1), 0)
    mel_len = int(max(1, (last - first + 1).max()))
    start = np.minimum(first, half + 1 - mel_len).astype(np.int32)
    mel_w = np.stack([mel[m, s : s + mel_len] for m, s in enumerate(start)]).astype(np.float32)
    k = np.arange(half, dtype=np.float64)
    return dict(
        window=window.astype(np.float32),
        tw_re=np.cos(2 * np.pi * k / n_fft).astype(np.float32),
        tw_im=(-np.sin(2 * np.pi * k / n_fft)).astype(np.float32),
        mel_w=np.ascontiguousarray(mel_w),
        mel_start=start,
        mel_nnz=np.int64(nz.sum()),
    )


_dev_consts: Dict[Tuple, Dict[str, torch.Tensor]] = {}


def _device_consts(make, sample_rate, num_mel_bins, win, n_fft, device) -> Dict[str, torch.Tensor]:
    """`make(sample_rate, num_mel_bins, win, n_fft)`'s arrays on `device`, cached."""
    key = (make.__name__, sample_rate, num_mel_bins, win, n_fft, str(device))
    if key not in _dev_consts:
        host = make(sample_rate, num_mel_bins, win, n_fft)
        _dev_consts[key] = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in host.items() if k != "mel_nnz"}
    return _dev_consts[key]


def _lib():
    from ._build import load

    lib = load("fbank")
    if not getattr(lib, "_sdt_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.sdt_fbank_smem_bytes.restype = ctypes.c_size_t
        lib.sdt_fbank_smem_bytes.argtypes = [I, I, I, I, I]
        lib.sdt_fbank_f32.restype = I
        lib.sdt_fbank_f32.argtypes = [P] * 7 + [I] * 9 + [ctypes.c_float, ctypes.c_float, I, P]
        lib.sdt_logmel_f32.restype = I
        lib.sdt_logmel_f32.argtypes = [P] * 7 + [I] * 8 + [P]
        lib._sdt_typed = True
    return lib


def fbank_cuda(
    audio: torch.Tensor,
    sample_rate: int = 16000,
    num_mel_bins: int = 80,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    preemphasis: float = 0.97,
) -> torch.Tensor:
    """(B, N) float32 audio in [-1, 1] → (B, T, n_mels) log-mel, no mean-norm.

    A CPU tensor runs the plain twin `kaldi_fbank_torch`; a CUDA tensor
    launches the kernel or raises. Counts its launches in
    `fbank_cuda.launches`.
    """
    if not audio.is_cuda:
        return F.kaldi_fbank_torch(
            audio, sample_rate, num_mel_bins, frame_length_ms, frame_shift_ms, preemphasis, mean_norm=False
        )
    if audio.dim() != 2 or audio.dtype != torch.float32:
        raise ValueError(f"fbank_cuda wants (B, N) float32 audio, got {tuple(audio.shape)} {audio.dtype}")
    audio = audio.contiguous()
    win, shift, n_fft = F.frame_params(sample_rate, frame_length_ms, frame_shift_ms)
    B, N = audio.shape
    if N < win:
        raise ValueError(f"fbank_cuda: {N} samples is shorter than one frame ({win})")
    T = 1 + (N - win) // shift
    out = torch.empty((B, T, num_mel_bins), dtype=torch.float32, device=audio.device)
    if B == 0:
        return out
    c = _device_consts(_host_consts, sample_rate, num_mel_bins, win, n_fft, audio.device)
    mel_len = c["mel_w"].shape[1]
    lib = _lib()
    from ._build import SMEM_LIMIT, check

    smem = lib.sdt_fbank_smem_bytes(win, shift, n_fft, num_mel_bins, mel_len)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fbank_cuda: n_fft {n_fft} needs {smem} B of shared memory (limit {SMEM_LIMIT})")
    code = lib.sdt_fbank_f32(
        audio.data_ptr(), out.data_ptr(), c["window"].data_ptr(), c["tw_re"].data_ptr(),
        c["tw_im"].data_ptr(), c["mel_w"].data_ptr(), c["mel_start"].data_ptr(),
        B, N, T, win, shift, n_fft, n_fft.bit_length() - 1, num_mel_bins, mel_len,
        32768.0, preemphasis, 1, torch.cuda.current_stream(audio.device).cuda_stream,
    )
    check(lib, code, "fbank_cuda")
    fbank_cuda.launches += 1
    return out


fbank_cuda.launches = 0


def logmel_cuda(
    audio: torch.Tensor,
    n_frames: int,
    frame_size: int = 200,
    frame_shift: int = 80,
    sample_rate: int = 8000,
    n_mels: int = 23,
) -> torch.Tensor:
    """(B, N) float32 audio → (B, n_frames, n_mels) EEND log-mel (log10), no
    mean-norm; `n_frames` is `count_frames(N, frame_shift)`.

    A CPU tensor runs the plain twin `logmel_frames_torch`; a CUDA tensor
    launches the kernel or raises. Counts its launches in
    `logmel_cuda.launches`.
    """
    if not audio.is_cuda:
        return F.logmel_frames_torch(audio, n_frames, frame_size, frame_shift, sample_rate, n_mels, mean_norm=False)
    if audio.dim() != 2 or audio.dtype != torch.float32:
        raise ValueError(f"logmel_cuda wants (B, N) float32 audio, got {tuple(audio.shape)} {audio.dtype}")
    B, N = audio.shape
    if n_frames != F.count_frames(N, frame_shift):
        raise ValueError(f"logmel_cuda: {N} samples give {F.count_frames(N, frame_shift)} frames, not {n_frames}")
    audio = audio.contiguous()
    n_fft = F.fft_size_for(frame_size)
    out = torch.empty((B, n_frames, n_mels), dtype=torch.float32, device=audio.device)
    if B == 0 or n_frames == 0:
        return out
    c = _device_consts(_logmel_consts, sample_rate, n_mels, frame_size, n_fft, audio.device)
    mel_len = c["mel_w"].shape[1]
    lib = _lib()
    from ._build import SMEM_LIMIT, check

    smem = lib.sdt_fbank_smem_bytes(n_fft, frame_shift, n_fft, n_mels, mel_len)
    if smem > SMEM_LIMIT:
        raise ValueError(f"logmel_cuda: n_fft {n_fft} needs {smem} B of shared memory (limit {SMEM_LIMIT})")
    code = lib.sdt_logmel_f32(
        audio.data_ptr(), out.data_ptr(), c["window"].data_ptr(), c["tw_re"].data_ptr(),
        c["tw_im"].data_ptr(), c["mel_w"].data_ptr(), c["mel_start"].data_ptr(),
        B, N, n_frames, frame_shift, n_fft, n_fft.bit_length() - 1, n_mels, mel_len,
        torch.cuda.current_stream(audio.device).cuda_stream,
    )
    check(lib, code, "logmel_cuda")
    logmel_cuda.launches += 1
    return out


logmel_cuda.launches = 0


def fbank_work(B: int, N: int, sample_rate: int = 16000, num_mel_bins: int = 80) -> Dict[str, float]:
    """Bytes the function must move and the fp32 operations it needs.

    Bytes: audio read once, fbank written once. Operations per frame: DC
    removal and preemphasis/window (5 per sample), a real-input FFT of the
    zero-padded frame (2.5 · n_fft · log2 n_fft, half the complex radix-2
    count the kernel itself performs), the power spectrum (3 per bin), the
    mel bank's non-zero weights (2 each) and the log (1 per mel).
    """
    win, shift, n_fft = F.frame_params(sample_rate)
    T = 1 + (N - win) // shift
    nnz = int(_host_consts(sample_rate, num_mel_bins, win, n_fft)["mel_nnz"])
    rfft = 2.5 * n_fft * (n_fft.bit_length() - 1)
    per_frame = 5 * win + rfft + 3 * (n_fft // 2 + 1) + 2 * nnz + num_mel_bins
    return dict(bytes=4.0 * B * N + 4.0 * B * T * num_mel_bins, flops=float(B * T * per_frame), frames=B * T)


def logmel_work(B: int, N: int, frame_size: int = 200, frame_shift: int = 80, sample_rate: int = 8000,
                n_mels: int = 23) -> Dict[str, float]:
    """Bytes and fp32 operations of K1′ on (B, N) audio, as `fbank_work`:
    audio read once, log-mel written once; per frame the window (1 per
    sample of n_fft), a real-input FFT (2.5 · n_fft · log2 n_fft), the power
    spectrum (3 per bin), the slaney bank's non-zero weights (2 each) and
    the log (1 per mel)."""
    n_fft = F.fft_size_for(frame_size)
    T = F.count_frames(N, frame_shift)
    nnz = int(_logmel_consts(sample_rate, n_mels, frame_size, n_fft)["mel_nnz"])
    rfft = 2.5 * n_fft * (n_fft.bit_length() - 1)
    per_frame = n_fft + rfft + 3 * (n_fft // 2 + 1) + 2 * nnz + n_mels
    return dict(bytes=4.0 * B * N + 4.0 * B * T * n_mels, flops=float(B * T * per_frame), frames=B * T)
