"""Speech-enhancement augmentation for training mixtures.

The port's own copy of speaker_diarization_tpu/data/enhance.py (NumPy only),
unchanged but for `get_enhancer`, which builds the port's learned enhancer
(models/enhancer.neural_enhancer_fn) on `device` (None: CUDA, or raise
without it); tests/test_torch_enhancer.py holds the two copies to the
same output.

Reference: `egs/alimeeting/ts_vad2/offline_add_noise_and_speech_enhance.py`
and the dataset hooks `ts_vad_dataset.py:423-492` — the reference denoises
training mixtures with external ANS models (modelscope ZipEnhancer /
sherpa-onnx GTCRN) either offline (pre-enhanced audio substituted by path)
or online (callable applied to each chunk). Those model downloads need
network egress; here the same integration points are provided with a
built-in spectral-gating denoiser, and any callable `(audio, rate) ->
audio` (e.g. an ONNX runtime wrapper) plugs into the same hooks.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np

from . import kaldi_io
from . import wav as wavio

Enhancer = Callable[[np.ndarray, int], np.ndarray]


def spectral_gate_denoise(
    audio: np.ndarray,
    rate: int = 16000,
    frame: int = 512,
    hop: int = 128,
    noise_percentile: float = 10.0,
    over_subtract: float = 1.5,
    floor: float = 0.05,
) -> np.ndarray:
    """Wiener-style spectral gating: the per-bin noise floor is estimated as
    a low percentile of the magnitude envelope over time, and a smoothed
    power-subtraction gain is applied before overlap-add resynthesis."""
    n = len(audio)
    if n < frame:
        return audio.copy()
    win = np.hanning(frame + 1)[:-1].astype(np.float64)
    # reflect-pad so every original sample gets full overlap-add coverage
    x = np.concatenate([audio[frame:0:-1], audio, audio[-2 : -frame - 2 : -1]]).astype(np.float64)
    n_frames = 1 + (len(x) - frame) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n_frames)[:, None]
    X = np.fft.rfft(x[idx] * win, axis=1)  # (T, F)
    mag = np.abs(X)
    noise = np.percentile(mag, noise_percentile, axis=0, keepdims=True)  # (1, F)
    snr2 = (mag / np.maximum(noise, 1e-12)) ** 2
    gain = np.maximum(1.0 - over_subtract / np.maximum(snr2, 1e-12), floor)
    # smooth the gain over time and frequency (3-tap) to reduce musical noise
    g = gain
    g = (np.roll(g, 1, axis=0) + g + np.roll(g, -1, axis=0)) / 3.0
    g = (np.roll(g, 1, axis=1) + g + np.roll(g, -1, axis=1)) / 3.0
    Y = X * g
    frames = np.fft.irfft(Y, n=frame, axis=1) * win
    out = np.zeros(len(x), np.float64)
    norm = np.zeros(len(x), np.float64)
    for t in range(n_frames):
        st = t * hop
        out[st : st + frame] += frames[t]
        norm[st : st + frame] += win ** 2
    out /= np.maximum(norm, 1e-8)
    return out[frame : frame + n].astype(audio.dtype)


def get_enhancer(name_or_fn, device=None) -> Enhancer:
    """'spectral_gate' | 'neural:<ckpt.npz>' | callable → Enhancer; a
    neural enhancer runs on `device`."""
    if callable(name_or_fn):
        return name_or_fn
    if name_or_fn == "spectral_gate":
        return spectral_gate_denoise
    if isinstance(name_or_fn, str) and name_or_fn.startswith("neural:"):
        # trained MaskDenoiser (train --family enhance → export-enhancer)
        from ..models.enhancer import neural_enhancer_fn

        return neural_enhancer_fn(name_or_fn.split(":", 1)[1], device)
    raise ValueError(f"unknown enhancer: {name_or_fn!r}")


def noisy_pair_batches(
    src_dir: str,
    noise_dir: str,
    rate: int,
    dur_s: float = 2.0,
    batch_size: int = 16,
    snr_range=(0.0, 15.0),
    seed: int = 0,
):
    """Endless (clean, noisy) training pairs for the learned denoiser:
    random crops of single-speaker utterances + noise at a random SNR."""
    rng = np.random.default_rng(seed)
    n = int(dur_s * rate)
    clean_wavs = sorted(kaldi_io.load_scp(os.path.join(src_dir, "wav.scp")).values())
    noise_wavs = sorted(kaldi_io.load_scp(os.path.join(noise_dir, "wav.scp")).values())
    cache: Dict[str, np.ndarray] = {}

    def crop(path):
        if path not in cache:
            audio, r = wavio.load_wav_maybe_piped(path)
            assert r == rate
            cache[path] = audio.astype(np.float32)
        a = cache[path]
        if len(a) <= n:
            return np.pad(a, (0, n - len(a)))
        st = rng.integers(0, len(a) - n)
        return a[st : st + n]

    while True:
        clean = np.stack([crop(clean_wavs[rng.integers(len(clean_wavs))]) for _ in range(batch_size)])
        noise = np.stack([crop(noise_wavs[rng.integers(len(noise_wavs))]) for _ in range(batch_size)])
        snr = rng.uniform(*snr_range, size=(batch_size, 1)).astype(np.float32)
        cp = np.sqrt(np.mean(clean**2, axis=-1, keepdims=True) + 1e-12)
        npow = np.sqrt(np.mean(noise**2, axis=-1, keepdims=True) + 1e-12)
        scaled = noise / npow * cp * (10.0 ** (-snr / 20.0))
        yield dict(clean=clean, noisy=clean + scaled)


def enhance_corpus(
    data_dir: str,
    out_dir: str,
    enhancer: Enhancer | str = "spectral_gate",
    rate: Optional[int] = None,
) -> str:
    """Offline enhancement of a Kaldi dir's recordings
    (offline_add_noise_and_speech_enhance.py semantics): writes enhanced
    copies + a wav.scp keyed by the same rec ids, for substitution via
    `enhanced_audio_dir` at train time."""
    fn = get_enhancer(enhancer)
    os.makedirs(out_dir, exist_ok=True)
    wav_dir = os.path.join(out_dir, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    wavs = kaldi_io.load_scp(os.path.join(data_dir, "wav.scp"))
    out_scp: Dict[str, str] = {}
    for rec, path in sorted(wavs.items()):
        audio, r = wavio.load_wav_maybe_piped(path)
        if rate is not None:
            assert r == rate, f"{rec}: rate {r} != {rate}"
        enhanced = fn(audio, r)
        out_path = os.path.join(wav_dir, f"{rec}.wav")
        wavio.write_wav(out_path, enhanced.astype(np.float32), r)
        out_scp[rec] = os.path.abspath(out_path)
    with open(os.path.join(out_dir, "wav.scp"), "w") as f:
        for rec, p in sorted(out_scp.items()):
            f.write(f"{rec} {p}\n")
    return out_dir
