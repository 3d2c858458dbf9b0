"""DiCoW: the diarization-conditioned Whisper encoder (target-speaker ASR), PyTorch.

Counterpart of speaker_diarization_tpu/models/dicow.py (reference
`egs/mlc_slm/dicow/encoder.py`, BUT-FIT DiCoW v3). A diarization output
becomes per-target-speaker STNO masks (postproc/stno.py: silence, target,
non-target, overlap) at the encoder's frame rate; FDDT applies one learned
transform per STNO class as a mask-weighted sum, once on the conv features
(before the positions) and once before each of the first N blocks. A CTC
head over the encoder output gives target-speaker transcripts.

- `FDDT`: a full Linear per class (identity init for target and overlap,
  `non_target_rate`·I for silence and non-target, zero biases), or
  per-channel scales and biases (`is_diagonal`), or biases only
  (`bias_only`), with the inits of JAX `dicow.py:38-82`;
- `DiCoWEncoder`: the port's Whisper log-mel and `WhisperEncoderBlock`s,
  `embed_positions` a Parameter that starts as the sinusoid table, the STNO
  mask cut to the frame count, the CTC head on h cast to fp32;
- `ctc_loss`: optax's per-sequence negative log-likelihood, meaned, through
  `F.ctc_loss`; paddings are 1 at padded frames and labels, as optax takes
  them; an impossible alignment (more labels and repeats than frames) costs
  `CTC_IMPOSSIBLE` with no gradient, where optax's log(0) stand-in of −1e5
  gives about that, not inf;
- `ctc_prefix_beam_search` and `ctc_greedy_decode`: host NumPy, carried over.

Speakers fold into the batch axis ((B·S, T, D)), as in the TS-VAD backends.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as Fn

from ..utils.device import resolve_dtype
from .eend import materialize_
from .layers import Conv1d, Linear
from .transformer import LayerNorm, sinusoidal_position_encoding
from .whisper_encoder import WhisperEncoderBlock, WhisperEncoderConfig, whisper_log_mel

STNO_CLASSES = ("silence", "target", "non_target", "overlap")
CTC_IMPOSSIBLE = 1e5


class FDDT(nn.Module):
    """Frame-level diarization-dependent transformation: x (B, T, D) and the
    (B, 4, T) soft STNO mask → Σ_c mask_c · transform_c(x)."""

    def __init__(self, d_model: int, non_target_rate: float = 0.01, is_diagonal: bool = False,
                 bias_only: bool = False):
        super().__init__()
        self.d_model, self.rate = d_model, non_target_rate
        self.is_diagonal, self.bias_only = is_diagonal, bias_only
        for name in STNO_CLASSES:
            if bias_only:
                setattr(self, f"{name}_bias", nn.Parameter(torch.zeros(d_model)))
            elif is_diagonal:
                setattr(self, f"{name}_scale", nn.Parameter(torch.zeros(d_model)))
                setattr(self, f"{name}_bias", nn.Parameter(torch.zeros(d_model)))
            else:
                setattr(self, f"{name}_linear", Linear(d_model, d_model))

    @torch.no_grad()
    def reset_parameters_(self) -> None:
        """The JAX inits: scale 1 for target and overlap, `non_target_rate`
        for silence and non-target; zero biases."""
        for name, iv in zip(STNO_CLASSES, (self.rate, 1.0, self.rate, 1.0)):
            if self.bias_only:
                getattr(self, f"{name}_bias").zero_()
            elif self.is_diagonal:
                getattr(self, f"{name}_scale").fill_(iv)
                getattr(self, f"{name}_bias").zero_()
            else:
                lin = getattr(self, f"{name}_linear")
                lin.weight.copy_(torch.eye(self.d_model, device=lin.weight.device) * iv)
                lin.bias.zero_()

    def forward(self, x: torch.Tensor, stno_mask: torch.Tensor) -> torch.Tensor:
        m = stno_mask.to(x.dtype)[..., None]  # (B, 4, T, 1)
        if self.bias_only:
            out = x
            for i, name in enumerate(STNO_CLASSES):
                out = out + m[:, i] * getattr(self, f"{name}_bias").to(x.dtype)
            return out
        out = torch.zeros_like(x)
        for i, name in enumerate(STNO_CLASSES):
            if self.is_diagonal:
                w, b = getattr(self, f"{name}_scale").to(x.dtype), getattr(self, f"{name}_bias").to(x.dtype)
                out = out + m[:, i] * (x * w + b)
            else:
                out = out + m[:, i] * getattr(self, f"{name}_linear")(x)
        return out


@dataclass(frozen=True)
class DiCoWConfig:
    whisper: WhisperEncoderConfig = field(default_factory=WhisperEncoderConfig)
    use_fddt: bool = True
    fddt_is_diagonal: bool = False
    fddt_bias_only: bool = False
    non_target_fddt_value: float = 0.01
    apply_fddt_to_n_layers: int = -1  # -1 → every layer
    vocab_size: int = 64  # CTC vocabulary (incl. blank at index 0)


class DiCoWEncoder(nn.Module):
    """mel (B, T100, n_mels) or audio (B, N), and the STNO mask (B, 4, ≥T50)
    or None → (CTC logits (B, T50, vocab) fp32, hidden (B, T50, d_model) in
    the compute dtype). Built on `device` (None: CUDA, or raise without it)
    with weights drawn from `seed`, then the JAX inits of FDDT and the
    positions. With `use_fddt` the FDDT modules always exist; without an
    STNO mask they are not applied (JAX creates them only when one is)."""

    def __init__(self, cfg: DiCoWConfig = DiCoWConfig(), dtype: Union[str, torch.dtype] = torch.float32,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0):
        super().__init__()
        c = cfg.whisper
        self.cfg, self.dtype = cfg, resolve_dtype(dtype)
        self.n_fddt = c.n_layers if cfg.apply_fddt_to_n_layers == -1 else cfg.apply_fddt_to_n_layers
        with torch.device("meta"):
            self.conv1 = Conv1d(c.n_mels, c.d_model, 3, padding=1)
            self.conv2 = Conv1d(c.d_model, c.d_model, 3, stride=2, padding=1)
            if cfg.use_fddt:
                self.initial_fddt = self._fddt()
                for i in range(min(self.n_fddt, c.n_layers)):
                    self.add_module(f"fddt_{i}", self._fddt())
            self.embed_positions = nn.Parameter(torch.empty(c.n_ctx, c.d_model))
            for i in range(c.n_layers):
                self.add_module(f"block_{i}", WhisperEncoderBlock(c))
            self.ln_post = LayerNorm(c.d_model, eps=1e-5)
            self.ctc_head = Linear(c.d_model, cfg.vocab_size)
        materialize_(self, device, seed)
        self.reset_conditioning_()

    def _fddt(self) -> FDDT:
        cfg = self.cfg
        return FDDT(cfg.whisper.d_model, cfg.non_target_fddt_value, cfg.fddt_is_diagonal, cfg.fddt_bias_only)

    @torch.no_grad()
    def reset_conditioning_(self) -> None:
        """The JAX initializers of the FDDT transforms and `embed_positions`."""
        for mod in self.modules():
            if isinstance(mod, FDDT):
                mod.reset_parameters_()
        c = self.cfg.whisper
        self.embed_positions.copy_(torch.from_numpy(sinusoidal_position_encoding(c.n_ctx, c.d_model)))

    @property
    def device(self) -> torch.device:
        return self.embed_positions.device

    def forward(self, mel_or_audio: torch.Tensor, stno_mask: Optional[torch.Tensor] = None):
        c = self.cfg.whisper
        mel = whisper_log_mel(mel_or_audio, c.n_mels) if mel_or_audio.dim() == 2 else mel_or_audio
        h = Fn.gelu(self.conv1(mel.to(self.dtype).transpose(1, 2)))
        h = Fn.gelu(self.conv2(h)).transpose(1, 2)
        cond = self.cfg.use_fddt and stno_mask is not None
        if cond:
            stno_mask = stno_mask[..., : h.shape[1]]
            h = self.initial_fddt(h, stno_mask)  # before the positions (encoder.py:244-247)
        h = h + self.embed_positions[None, : h.shape[1]].to(h.dtype)
        for i in range(c.n_layers):
            if cond and i < self.n_fddt:
                h = getattr(self, f"fddt_{i}")(h, stno_mask)
            h = getattr(self, f"block_{i}")(h)
        h = self.ln_post(h)
        return self.ctc_head(h.float()), h


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor, labels: torch.Tensor,
             label_paddings: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """The mean over the batch of optax.ctc_loss: logits (B, T, V), labels
    (B, L) int, paddings (B, T) and (B, L) with 1 at padded (trailing)
    positions."""
    T, L = logits.shape[1], labels.shape[1]
    in_len = (T - logit_paddings.sum(1)).round().long()
    lab_len = (L - label_paddings.sum(1)).round().long()
    logp = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # (T, B, V)
    per = Fn.ctc_loss(logp, labels.long(), in_len, lab_len, blank=blank_id, reduction="none", zero_infinity=True)
    # an alignment needs a frame per label and a blank between repeats
    valid = torch.arange(L, device=labels.device)[None, 1:] < lab_len[:, None]
    repeats = ((labels[:, 1:] == labels[:, :-1]) & valid).sum(1)
    return torch.where(lab_len + repeats > in_len, torch.full_like(per, CTC_IMPOSSIBLE), per).mean()


def ctc_prefix_beam_search(log_probs, beam_size: int = 8, blank_id: int = 0, return_nbest: bool = False):
    """CTC prefix beam search over (T, V) log-probabilities (host NumPy, the
    JAX function carried over): prefixes carry separate blank-ending and
    non-blank-ending probabilities, merged in log space. → the best label
    sequence, or the n-best list of (labels, logprob) with return_nbest."""
    lp = np.asarray(log_probs, np.float64)
    T, V = lp.shape
    NEG = -np.inf

    def logsumexp2(a, b):
        if a == NEG:
            return b
        if b == NEG:
            return a
        m = max(a, b)
        return m + np.log(np.exp(a - m) + np.exp(b - m))

    beams = {(): [0.0, NEG]}  # prefix → [p_blank, p_nonblank]
    for t in range(T):
        new: dict = {}

        def add(prefix, pb, pnb):
            cur = new.setdefault(prefix, [NEG, NEG])
            cur[0] = logsumexp2(cur[0], pb)
            cur[1] = logsumexp2(cur[1], pnb)

        for prefix, (pb, pnb) in beams.items():
            p_tot = logsumexp2(pb, pnb)
            add(prefix, p_tot + lp[t, blank_id], NEG)  # a blank: the prefix, now blank-ending
            if prefix:  # the last symbol repeated: only the non-blank mass stays collapsed
                add(prefix, NEG, pnb + lp[t, prefix[-1]])
            for v in range(V):
                if v == blank_id:
                    continue
                if prefix and v == prefix[-1]:  # a new occurrence needs a blank in between
                    add(prefix + (v,), NEG, pb + lp[t, v])
                else:
                    add(prefix + (v,), NEG, p_tot + lp[t, v])
        beams = dict(sorted(new.items(), key=lambda kv: -logsumexp2(*kv[1]))[:beam_size])
    nbest = sorted(((list(k), logsumexp2(*v)) for k, v in beams.items()), key=lambda kv: -kv[1])
    return nbest if return_nbest else nbest[0][0]


def ctc_greedy_decode(logits, blank_id: int = 0):
    """Greedy CTC collapse: (T, V) or (B, T, V) logits (a tensor or an
    array) → a list of label lists."""
    arr = logits.argmax(-1).cpu().numpy() if isinstance(logits, torch.Tensor) else np.argmax(np.asarray(logits), -1)
    if arr.ndim == 1:
        arr = arr[None]
    outs = []
    for seq in arr:
        prev, out = -1, []
        for t in seq.tolist():
            if t != prev and t != blank_id:
                out.append(t)
            prev = t
        outs.append(out)
    return outs
