"""Neural voice-activity detection (system SAD), PyTorch.

Counterpart of speaker_diarization_tpu/models/vad.py, the trainable
stand-in for the silero-vad ONNX model the reference runs on the host
(`egs/alimeeting/spectral_cluster/make_system_sad.py:32-57`):

- `NeuralVAD`: log-mel front-end (`ops/features.eend_frontend_auto` at
  context 0 and subsampling 1, i.e. `kernels/fbank.logmel_cuda`: the K1′
  kernel on CUDA, its plain twin on the CPU; no mean-norm, which would leak
  the future into every frame) → causal convs (a left pad of k−1, flax
  `padding="CAUSAL"`), each followed by LayerNorm (eps 1e-6, in fp32) and
  ReLU → a unidirectional LSTM (models/eda.LSTM: flax's OptimizedLSTMCell
  under nn.RNN, fp32 carry) → Dense to one logit per frame at the feature
  rate (100 Hz at 16 kHz 400/160). Fully causal.
- `make_vad_labels` and `get_speech_timestamps` (silero's hysteresis:
  trigger at `threshold`, release below `neg_threshold` after
  `min_silence_s`, drop islands shorter than `min_speech_s`, pad by
  `pad_s`) are the JAX module's, line for line.
- `neural_sad`: audio → [(start, end), ...] over 30 s chunks of one shape,
  pluggable as the `sad` of infer/clustering.cluster_recording.

Submodules carry the flax names (`Conv_i`, `LayerNorm_i`, `lstm`,
`Dense_0`), so utils/convert.vad_from_flax maps the JAX variables.
`save_vad_params`/`load_vad_params` write and read them as one flax-layout
npz (utils/convert.save_flax_npz); `load_vad_params` also reads the JAX
package's flax msgpack file (utils/msgpack.py decodes it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as Fn

from ..ops import features as F
from ..ops.features import count_frames
from ..utils.device import resolve_dtype
from .eda import LSTM
from .eend import materialize_
from .layers import Conv1d, Linear
from .transformer import LayerNorm

CHUNKS_PER_FORWARD = 16  # neural_sad's batch: 8 minutes of audio a forward


@dataclass(frozen=True)
class NeuralVADConfig:
    sample_rate: int = 16000
    frame_size: int = 400  # 25 ms
    frame_shift: int = 160  # 10 ms → prob rate 100 Hz
    n_mels: int = 40
    conv_channels: Tuple[int, ...] = (48, 48)
    conv_kernel: int = 5
    lstm_hidden: int = 64

    @property
    def frame_shift_s(self) -> float:
        return self.frame_shift / self.sample_rate


class NeuralVAD(nn.Module):
    """(B, samples) audio → (B, T) per-frame speech logits, fp32. Built on
    `device` (None: CUDA, or raise without it) with fp32 weights drawn from
    `seed`; `dtype` is the compute dtype."""

    def __init__(
        self,
        cfg: NeuralVADConfig = NeuralVADConfig(),
        dtype: Union[str, torch.dtype] = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = resolve_dtype(dtype)
        with torch.device("meta"):
            d = c.n_mels
            for i, ch in enumerate(c.conv_channels):
                self.add_module(f"Conv_{i}", Conv1d(d, ch, c.conv_kernel))
                self.add_module(f"LayerNorm_{i}", LayerNorm(ch))
                d = ch
            self.lstm = LSTM(d, c.lstm_hidden)
            self.Dense_0 = Linear(c.lstm_hidden, 1)
        materialize_(self, device, seed)

    @property
    def device(self) -> torch.device:
        return self.Dense_0.weight.device

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        # the log-mel alone: no context, no subsampling, no mean-norm
        x = F.eend_frontend_auto(audio.float(), audio.shape[-1], c.frame_size, c.frame_shift, c.sample_rate, c.n_mels,
                                 0, 1, False).to(self.dtype)
        for i in range(len(c.conv_channels)):
            x = getattr(self, f"Conv_{i}")(Fn.pad(x.transpose(1, 2), (c.conv_kernel - 1, 0))).transpose(1, 2)
            x = torch.relu(getattr(self, f"LayerNorm_{i}")(x))
        y = self.lstm(x)[1]  # fp32
        return self.Dense_0(y.to(self.dtype))[..., 0].float()


def make_vad_labels(
    sad: List[Tuple[float, float]], n_frames: int, frame_shift_s: float
) -> np.ndarray:
    """(start, end) speech regions → per-frame 0/1 labels at the prob rate."""
    lab = np.zeros(n_frames, np.float32)
    for s, e in sad:
        lab[max(0, int(round(s / frame_shift_s))) : max(0, int(round(e / frame_shift_s)))] = 1.0
    return lab


def get_speech_timestamps(
    probs: np.ndarray,
    frame_shift_s: float,
    threshold: float = 0.5,
    neg_threshold: Optional[float] = None,
    min_speech_s: float = 0.25,
    min_silence_s: float = 0.10,
    pad_s: float = 0.03,
) -> List[Tuple[float, float]]:
    """Silero-style hysteresis over per-frame speech probabilities
    (silero_vad.get_speech_timestamps semantics, as driven by
    make_system_sad.py:50-68)."""
    if neg_threshold is None:
        neg_threshold = max(threshold - 0.15, 0.01)
    min_sil = int(round(min_silence_s / frame_shift_s))
    segs: List[Tuple[int, int]] = []
    triggered = False
    start = 0
    tmp_end = -1
    for i, p in enumerate(np.asarray(probs, np.float64)):
        if not triggered:
            if p >= threshold:
                triggered, start, tmp_end = True, i, -1
        else:
            if p >= threshold:
                tmp_end = -1
            elif p < neg_threshold:
                if tmp_end < 0:
                    tmp_end = i
                if i - tmp_end >= min_sil:
                    segs.append((start, tmp_end))
                    triggered, tmp_end = False, -1
    if triggered:
        segs.append((start, tmp_end if tmp_end > 0 else len(probs)))

    out: List[Tuple[float, float]] = []
    for s, e in segs:
        b, en = s * frame_shift_s, e * frame_shift_s
        if en - b < min_speech_s:
            continue
        out.append((max(0.0, b - pad_s), en + pad_s))
    # merge padding-induced overlaps
    merged: List[List[float]] = []
    for b, en in out:
        if merged and b <= merged[-1][1] + 1e-9:
            merged[-1][1] = max(merged[-1][1], en)
        else:
            merged.append([b, en])
    return [(b, en) for b, en in merged]


def save_vad_params(path: str, model: NeuralVAD) -> None:
    """The VAD's weights as flax-layout variables in one npz, for
    `cluster --vad-ckpt`."""
    from ..utils.convert import save_flax_npz, vad_to_flax

    save_flax_npz(path, vad_to_flax(model.state_dict()))


def load_vad_params(path: str, model: NeuralVAD) -> NeuralVAD:
    """Load weights into `model`: the npz of `save_vad_params`, or the flax
    msgpack file of the JAX package's save_vad_params (its `export-vad`)."""
    from ..utils.convert import load_flax_npz, vad_from_flax
    from ..utils.msgpack import flax_variables

    with open(path, "rb") as f:
        data = f.read()
    variables = load_flax_npz(path) if data[:2] == b"PK" else flax_variables(data, path)
    model.load_state_dict(vad_from_flax(variables))
    return model


@torch.no_grad()
def neural_sad(
    audio: np.ndarray,
    rate: int,
    model: NeuralVAD,
    threshold: float = 0.5,
    min_duration_s: float = 0.0,
    chunk_s: float = 30.0,
) -> List[Tuple[float, float]]:
    """Whole-recording system SAD: the recording zero-padded to whole
    `chunk_s` chunks (one shape), CHUNKS_PER_FORWARD chunks a forward on
    the model's device → sigmoid → timestamps. `min_duration_s` mirrors
    make_system_sad.py's --min-duration filter."""
    c = model.cfg
    if rate != c.sample_rate:
        raise ValueError(f"{rate} Hz audio, the VAD wants {c.sample_rate} Hz")
    model.eval()
    chunk = int(chunk_s * rate)
    n_chunks = max(1, int(np.ceil(len(audio) / chunk)))
    padded = np.zeros(n_chunks * chunk, np.float32)
    padded[: len(audio)] = audio
    rows = padded.reshape(n_chunks, chunk)
    probs = []
    for i in range(0, n_chunks, CHUNKS_PER_FORWARD):
        x = torch.from_numpy(rows[i : i + CHUNKS_PER_FORWARD]).to(model.device)
        probs.append(torch.sigmoid(model(x)).cpu().numpy().reshape(-1))
    p = np.concatenate(probs)[: count_frames(len(audio), c.frame_shift)]
    segs = get_speech_timestamps(p, c.frame_shift_s, threshold=threshold)
    return [(b, e) for b, e in segs if e - b >= min_duration_s]
