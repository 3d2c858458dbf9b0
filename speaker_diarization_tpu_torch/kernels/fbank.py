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

Both entries launch one kernel whose grid is planned here (`launch_plan`):
a few persistent CTAs per SM, each walking a contiguous run of frame tiles,
so the CPU tests reach the tiling the card runs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Tuple

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
    mel_band[m] = (q0, n) says where in its band filter m's non-zero weights
    lie, mel_w[m, q0 : q0 + n]: the kernel sums over those only.
    """
    half = n_fft // 2
    nz = mel > 0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), nz.shape[1] - 1 - nz[:, ::-1].argmax(1), 0)
    mel_len = int(max(1, (last - first + 1).max()))
    start = np.minimum(first, half + 1 - mel_len).astype(np.int32)
    mel_w = np.stack([mel[m, s : s + mel_len] for m, s in enumerate(start)]).astype(np.float32)
    # (q0, n) of filter m: its non-zero weights are mel_w[m, q0 : q0 + n]
    band = np.stack([np.where(nz.any(1), first - start, 0), np.where(nz.any(1), last - first + 1, 0)], 1)
    k = np.arange(half, dtype=np.float64)
    return dict(
        window=window.astype(np.float32),
        tw_re=np.cos(2 * np.pi * k / n_fft).astype(np.float32),
        tw_im=(-np.sin(2 * np.pi * k / n_fft)).astype(np.float32),
        mel_w=np.ascontiguousarray(mel_w),
        mel_start=start,
        mel_band=np.ascontiguousarray(band.astype(np.int32)),
        mel_nnz=np.int64(nz.sum()),
    )


# The kernel's fixed shape (csrc/fbank.cu): 256 threads a CTA, 16 complex
# points a thread, so a frame of n_fft real samples (n_fft/2 complex points)
# takes n_fft/32 threads (two warps at n_fft 2048) and a CTA transforms
# 8192/n_fft frames at once, a tile; at most three CTAs a SM (its
# __launch_bounds__), two at n_fft 2048 by shared memory.
THREADS = 256
POINTS = 16
CTAS_PER_SM = 3
N_SM = 132  # streaming multiprocessors of an H100 SXM
SM_SMEM = 233472  # shared memory of one SM on sm_90 (228 KB)
FFT_SIZES = (128, 256, 512, 1024, 2048)


def _align4(n: int) -> int:
    return (n + 3) & ~3


def fft_radices(n_fft: int) -> List[int]:
    """The kernel's radix passes over the n_fft/2-point complex FFT: 16 while
    more than 16 points remain, then the rest (n_fft 128 → 16·4, 256 → 16·8,
    512 → 16·16, 1024 → 16·16·2, 2048 → 16·16·4)."""
    if n_fft not in FFT_SIZES:
        raise ValueError(f"the fbank kernel takes n_fft in {FFT_SIZES}, not {n_fft}")
    rest, out = n_fft // 2, []
    while rest > 1:
        out.append(min(POINTS, rest))
        rest //= out[-1]
    return out


def slots(n_fft: int) -> int:
    """Frames one CTA transforms at once, the frames of a tile: a frame takes
    n_fft/32 threads."""
    return THREADS * POINTS // (n_fft // 2)


def pow_stride(n_fft: int) -> int:
    """Row stride of a tile's power spectra in shared memory: the first value
    from n_fft/2 + 1 up that is n_fft/32 + 1 mod 32 (odd: the mel stage's
    frames start on distinct banks)."""
    s = n_fft // 2 + 1
    while s % 32 != (n_fft // 32 + 1) % 32:
        s += 1
    return s


def smem_bytes(frames_per_tile: int, frame_len: int, shift: int, n_fft: int, n_mels: int, mel_len: int) -> int:
    """Shared memory of one CTA (csrc/fbank.cu `make_layout`): two staging
    buffers of a tile's samples, the window, the half-length FFT's twiddles
    and the split post-pass's, the banded mel table, each filter's first
    non-zero bin and count, and the exchange buffer of the FFT (complex
    values per frame slot, padded one in 16), which then holds the tile's
    power spectra and its mel rows."""
    half = n_fft // 2
    span = _align4((frames_per_tile - 1) * shift + frame_len)
    exch = _align4(slots(n_fft) * (half + half // 16))
    tail = _align4(frames_per_tile * pow_stride(n_fft)) + _align4(frames_per_tile * n_mels)
    return 4 * (2 * span + _align4(n_fft) + 4 * half + _align4(n_mels * mel_len) + _align4(2 * n_mels)
                + max(2 * exch, tail))


class FbankPlan(NamedTuple):
    """The kernel's grid: `tiles` tiles of `frames_per_tile` frames
    (`tiles_per_wave` for each waveform, the last one ragged), walked by
    `grid` persistent CTAs, each a contiguous run of tiles (`cta_tiles`);
    `smem` bytes of shared memory per CTA."""

    frames_per_tile: int
    tiles_per_wave: int
    tiles: int
    grid: int
    smem: int

    def cta_tiles(self, cta: int) -> range:
        q, r = divmod(self.tiles, self.grid)
        start = cta * q + min(cta, r)
        return range(start, start + q + (cta < r))

    def tile_frames(self, tile: int, T: int) -> Tuple[int, int, int]:
        """(waveform, first frame, end frame) of a tile."""
        b, i = divmod(tile, self.tiles_per_wave)
        t0 = i * self.frames_per_tile
        return b, t0, min(T, t0 + self.frames_per_tile)


def launch_plan(B: int, T: int, frame_len: int, shift: int, n_fft: int, n_mels: int, mel_len: int,
                n_sm: int = N_SM) -> FbankPlan:
    """The grid of one launch over (B, T) frames of `frame_len` samples.

    Tiles of `slots(n_fft)` frames; as many CTAs as fit three to a SM by
    shared memory (one wave), but no more than there are tiles. (64, 64000)
    at 16 kHz gives 1,600 tiles of 16 frames on 396 CTAs.
    """
    from ._build import SMEM_LIMIT

    fft_radices(n_fft)
    per_tile = slots(n_fft)
    smem = smem_bytes(per_tile, frame_len, shift, n_fft, n_mels, mel_len)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the fbank kernel needs {smem} B of shared memory at n_fft {n_fft} (limit {SMEM_LIMIT})")
    per_wave = max(1, -(-T // per_tile))
    tiles = B * per_wave
    per_sm = max(1, min(CTAS_PER_SM, SM_SMEM // (smem + 1024)))
    return FbankPlan(per_tile, per_wave, tiles, max(1, min(tiles, per_sm * n_sm)), smem)


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_for(audio: torch.Tensor, T: int, frame_len: int, shift: int, n_fft: int, n_mels: int,
              mel_len: int) -> FbankPlan:
    return launch_plan(audio.shape[0], T, frame_len, shift, n_fft, n_mels, mel_len, _sm_count(audio.device.index))


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
        lib.sdt_fbank_smem_bytes.argtypes = [I] * 6
        lib.sdt_fbank_f32.restype = I
        lib.sdt_fbank_f32.argtypes = [P] * 8 + [I] * 8 + [ctypes.c_float] + [I] * 3 + [P]
        lib.sdt_logmel_f32.restype = I
        lib.sdt_logmel_f32.argtypes = [P] * 8 + [I] * 7 + [I] * 3 + [P]
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
    if audio.data_ptr() % 16:  # the kernel stages audio by 16-byte copies
        audio = audio.clone()
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
    plan = _plan_for(audio, T, win, shift, n_fft, num_mel_bins, mel_len)
    lib = _lib()
    from ._build import check

    code = lib.sdt_fbank_f32(
        audio.data_ptr(), out.data_ptr(), c["window"].data_ptr(), c["tw_re"].data_ptr(),
        c["tw_im"].data_ptr(), c["mel_w"].data_ptr(), c["mel_start"].data_ptr(), c["mel_band"].data_ptr(),
        B, N, T, win, shift, n_fft, num_mel_bins, mel_len, preemphasis,
        plan.grid, plan.frames_per_tile, plan.smem, torch.cuda.current_stream(audio.device).cuda_stream,
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
    if audio.data_ptr() % 16:  # the kernel stages audio by 16-byte copies
        audio = audio.clone()
    n_fft = F.fft_size_for(frame_size)
    out = torch.empty((B, n_frames, n_mels), dtype=torch.float32, device=audio.device)
    if B == 0 or n_frames == 0:
        return out
    c = _device_consts(_logmel_consts, sample_rate, n_mels, frame_size, n_fft, audio.device)
    mel_len = c["mel_w"].shape[1]
    plan = _plan_for(audio, n_frames, n_fft, frame_shift, n_fft, n_mels, mel_len)
    lib = _lib()
    from ._build import check

    code = lib.sdt_logmel_f32(
        audio.data_ptr(), out.data_ptr(), c["window"].data_ptr(), c["tw_re"].data_ptr(),
        c["tw_im"].data_ptr(), c["mel_w"].data_ptr(), c["mel_start"].data_ptr(), c["mel_band"].data_ptr(),
        B, N, n_frames, frame_shift, n_fft, n_mels, mel_len,
        plan.grid, plan.frames_per_tile, plan.smem, torch.cuda.current_stream(audio.device).cuda_stream,
    )
    check(lib, code, "logmel_cuda")
    logmel_cuda.launches += 1
    return out


logmel_cuda.launches = 0


def fbank_work(B: int, N: int, sample_rate: int = 16000, num_mel_bins: int = 80) -> Dict[str, float]:
    """Bytes the function must move and the fp32 operations it needs.

    Bytes: audio read once, fbank written once. Operations per frame: DC
    removal and preemphasis/window (5 per sample), a real-input FFT of the
    zero-padded frame (2.5 · n_fft · log2 n_fft, the radix-2 count of a
    real-input FFT, whatever radices the kernel uses), the power spectrum
    (3 per bin), the mel bank's non-zero weights (2 each) and the log (1 per
    mel).
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
