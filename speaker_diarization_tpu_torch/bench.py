"""Inference and training throughput of the port on one GPU.

TS-VAD (the default family) measures what the JAX package's bench.py
measures, on the card: audio seconds per second of the full-size TS-VAD
forward (TSVADConfig(), CAM++ 12/24/16, bf16) at batch 64 × 4 s chunks, with
seeded random weights; `--backend mamba` swaps both backends for BiMamba
(S6, d_state 64), `--backend mamba2` for BiMamba-2 (SSD: d_state 64,
expand 2, 12 heads of 64). `--speech-encoder` swaps CAM++ for another
speech encoder of TSVADConfig (wavlm, wavlm_weight_sum, hubert, wav2vec2,
mms, w2vbert, whisper, eres2netv2, redimnet_b0…b6, at their fbank widths:
60 bins for b0, 72 for b1-b6) at batch 32 × 4 s (`zoo_config`).
`--train` instead times train steps at the hermetic recipe's settings
(batch 64 × 4 s, bf16, adam, poly schedule, lr 2e-4, warmup 400, clip 5) on
seeded random batches.

`--family tsvad_streaming` measures streaming TS-VAD at the second hermetic
recipe's stream_cfg (recipes/hermetic_streaming_and_eda.sh: 8 kHz, 80 bins,
d_model 256, d_ff 1024, 2 layers of 4 heads, chunk 16 with 4 left chunks),
bf16, batch 64 × 4 s: audio seconds per second of the decode `infer` runs
(each window chunk by chunk through the caches), or with `--train` ms per
step of the chunk-masked forward and backward at the recipe's settings.

`--family eend|eend_eda` measures the EEND family at the JAX CLI's
TrainCliConfig widths (d_model 256, 4 layers, 4 heads, d_ff 1024; EDA
decodes 15 attractors) and front-end (8 kHz, frame 200 / shift 80, 23 mels,
context 7, subsampling 10), bf16, at the recipe's batch 32
(recipes/mini_librispeech_eend.sh:31) × one 500-frame chunk (50 s): audio
seconds per second of the forward (`EendEdaModel.infer` for EDA), or with
`--train` ms per step at the recipe's settings (adam, noam, lr 1.0, warmup
800, clip 5).

`--family spk` measures the speaker encoder of the hermetic TS-VAD recipe
(recipes/hermetic_tsvad_full_stack.sh stages 2-3): with `--train`, ms per
pretraining step at its settings (CAM++ 12/24/16 with the dense head, AAM
margin 0.3 over 32 speakers, batch 64 × 2 s at 8 kHz, 80 bins, bf16, adam,
poly, lr 1e-3, warmup 200, clip 5); without, windows per second of the fp32
embedding forward `extract-embeddings` runs (fbank + CAM++ in eval, batch 32
× 6 s windows at 8 kHz).

`--family sond|tsvad3|eend_vc` measures the seventh slice at full width:
SOND at SONDConfig() (16 profiles, 2517 powerset classes, ResNet34 3,4,6,3,
bf16, batch 16 × 4 s at 16 kHz; the forward is what `infer` computes:
fbank, logits, per-speaker probabilities), TS-VAD3 at TSVAD3Config() (CAM++
12/24/16 on the mixture and on 4 enrollment waveforms of 6 s, frame fusion,
bf16, batch 16 × 4 s at 16 kHz) and EEND-VC at the CLI's widths and the
leaderboard's chunks (d_model 256, 4 layers, 3 channels, 8 kHz, bf16, batch
32 × 200 frames = 20 s); with `--train`, ms per step at the hermetic
leaderboard's settings (SOND, TS-VAD3: adam, poly, lr 2e-4, warmup 400;
EEND-VC: adam, noam, lr 1.0, warmup 1000; clip 5).

`--family ssnd|eend_m2f|fs_eend|ots_vad` measures the eighth slice at full
width: SSND at SSNDConfig() (CAM++ 12/24/16 extractor, d_model 256, 4 layers
of 8 heads, 4 slots, 1,000 global speakers, bf16, batch 16 × 4 s at 16 kHz;
the forward for given slot queries), EEND-M2F at the CLI's widths (d_model
256, 4 conformer layers with k49, 8 queries, 2 decoder layers; log-mel at
subsampling 1; batch 16 × 500 frames = 5 s at 8 kHz), FS-EEND at the CLI's
widths (d_model 256, 4 encoder and 2 fusion layers, 5 channels; batch 16 ×
500 subsampled frames = 50 s at 8 kHz) and OTS-VAD at OTSVADConfig()
(ResNet34 3,4,6,3, d_model 256, batch 16 × 4 s at 16 kHz for the forward,
16 × (4 s + 4 s) for a step); with `--train`, ms per step at the hermetic
leaderboard's settings (FS-EEND: adam, noam, lr 1.0, warmup 1000; the
others: adam, poly, lr 2e-4, warmup 400; clip 5).

`--family vad|enhance` measures the ninth slice's models: the neural VAD at
NeuralVADConfig() (16 kHz, 400/160, 40 mels, causal convs 48/48, LSTM 64;
fp32, as the vad family trains) at batch 16 × 30 s, the chunks `cluster
--sad neural` reads (the log-mel through K1′, then 3,000 LSTM steps), and
the learned enhancer at EnhancerConfig() (n_fft 512, hop 128, 3 convs of 48,
GRUs of 96 both ways; bf16) at the leaderboard's enhance stage batch, 16 ×
2 s at 8 kHz (126 frames each way); with `--train`, ms per step at the
CLI's defaults for vad (adam, noam, lr 1.0, warmup 25000, clip 5) and the
leaderboard's enhance settings (adam, poly, lr 2e-4, warmup 200, 1,500
steps, clip 5).

Completion is proven by a data dependency: every forward's probability
checksum (every step's loss) is chained into one device scalar that is read
on the host after torch.cuda.synchronize(), so the clock cannot stop before
every forward or step ran.

    python -m speaker_diarization_tpu_torch.bench \\
        [--family tsvad|tsvad_streaming|eend|eend_eda|spk|sond|tsvad3|eend_vc|ssnd|eend_m2f|fs_eend|ots_vad|vad|enhance] \\
        [--backend mamba|mamba2] [--speech-encoder wavlm|whisper|w2vbert|eres2netv2|redimnet_b2|...] \\
        [--train] [--profile profile.txt]

`--profile` also records a torch.profiler window of a few forwards (train
steps with `--train`), writes the device time per kernel, and reports the
device's busy share: CUDA kernel time per call over the unprofiled wall
time per call.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .models.tsvad import SPEECH_ENCODERS, TSVADConfig, TSVADModel

BATCH, CHUNK_S = 64, 4.0  # the JAX bench's shape (reference run_ts_vad2.sh:198)
ZOO_BATCH = 32  # the speech-encoder zoo's batch of 4 s chunks at 16 kHz (chip_smoke.py's [zoo] phase)
EEND_BATCH = 32  # recipes/mini_librispeech_eend.sh:31
# recipes/hermetic_tsvad_full_stack.sh: stage 2 (32 simulated speakers, 2 s
# crops, batch 64 at 8 kHz) and stage 3 (6 s windows, in batches of 32)
SPK_BATCH, SPK_DUR_S, SPK_RATE, SPK_CLASSES = 64, 2.0, 8000, 32
EMB_BATCH, EMB_WINDOW_S = 32, 6.0


def _pipelined(call: Callable[[int], torch.Tensor], device, iters: int, reps: int) -> Tuple[float, float, List[float]]:
    """(median seconds, checksum, seconds per rep) of `reps` runs of `iters`
    pipelined calls; call(i) returns a device scalar chained into the checksum."""
    for i in range(2):  # warm-up: kernel builds, cuDNN plans, allocator
        call(i).item()
    dts, witness = [], 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = torch.zeros((), dtype=torch.float64, device=device)
        for i in range(iters):
            acc += call(i)
        torch.cuda.synchronize()
        witness = acc.item()
        dts.append(time.perf_counter() - t0)
        if not np.isfinite(witness):
            raise RuntimeError(f"non-finite checksum {witness}")
    return statistics.median(dts), witness, dts


def zoo_config(speech_encoder: str = "campplus", backend: str = "transformer") -> TSVADConfig:
    """TSVADConfig() with `speech_encoder` at its fbank width (60 bins for
    redimnet_b0, 72 for b1-b6, else 80) and `backend` for both backends."""
    feat = 60 if speech_encoder == "redimnet_b0" else 72 if speech_encoder.startswith("redimnet") else 80
    return TSVADConfig(speech_encoder_type=speech_encoder, feat_dim=feat, single_backend_type=backend,
                       multi_backend_type=backend)


def make_inputs(cfg: TSVADConfig, batch: int, chunk_s: float, n_bufs: int, seed: int, device) -> Tuple[List, List]:
    """Distinct seeded (audio, target_embs) device buffers."""
    rng = np.random.default_rng(seed)
    n = int(chunk_s * cfg.sample_rate)
    audios = [torch.from_numpy((0.1 * rng.standard_normal((batch, n))).astype(np.float32)).to(device) for _ in range(n_bufs)]
    embss = [
        torch.from_numpy(rng.standard_normal((batch, cfg.max_num_speaker, cfg.speaker_embed_dim)).astype(np.float32)).to(device)
        for _ in range(n_bufs)
    ]
    return audios, embss


@torch.no_grad()
def throughput(model: TSVADModel, audios, embss, n_label: int, iters: int = 20, reps: int = 3) -> Dict[str, float]:
    """Median over `reps` of `iters` pipelined forwards on distinct inputs."""
    dt, witness, dts = _pipelined(
        lambda i: torch.sigmoid(model(audios[i % len(audios)], embss[i % len(embss)], n_label)).sum(),
        audios[0].device, iters, reps)
    B, N = audios[0].shape
    audio_s = B * N / model.cfg.sample_rate
    return dict(ms_per_forward=1e3 * dt / iters, audio_s_per_s=audio_s * iters / dt, witness=witness, reps_s=dts)


def eend_model(family: str, device, seed: int = 0, bf16: bool = True, **overrides):
    """The family's model at the JAX CLI's TrainCliConfig defaults (and
    `overrides` of its fields), seeded random weights."""
    from .cli.main import TrainCliConfig, build_model

    cfg = TrainCliConfig(family=family, bf16=bf16, seed=seed, **overrides)
    return build_model(cfg, device), cfg


def make_eend_batches(cfg, batch: int, n_bufs: int, seed: int, device) -> List[Dict]:
    """Distinct seeded {audio, frame_mask, labels, spk_mask} device batches of one full chunk each."""
    from .cli.main import frontend_config

    rng = np.random.default_rng(seed)
    n = frontend_config(cfg).chunk_samples(cfg.chunk_frames)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return [
        dict(audio=t((0.1 * rng.standard_normal((batch, n))).astype(np.float32)),
             frame_mask=t(np.ones((batch, cfg.chunk_frames), np.float32)),
             labels=t((rng.random((batch, cfg.chunk_frames, cfg.n_speakers)) < 0.3).astype(np.float32)),
             spk_mask=t(np.ones((batch, cfg.n_speakers), np.float32)))
        for _ in range(n_bufs)
    ]


def eend_forward(model):
    """(audio, frame_mask) → the logits a user's inference computes (EDA: `infer`'s)."""
    from .models.eda import EendEdaModel

    if isinstance(model, EendEdaModel):
        return lambda a, m: model.infer(a, m)[0]
    return lambda a, m: model(a, m)


@torch.no_grad()
def eend_throughput(model, batches, iters: int = 10, reps: int = 3) -> Dict[str, float]:
    """Median over `reps` of `iters` pipelined EEND / EDA forwards on distinct chunks."""
    fwd = eend_forward(model)
    dt, witness, dts = _pipelined(
        lambda i: torch.sigmoid(fwd(batches[i % len(batches)]["audio"], batches[i % len(batches)]["frame_mask"])).sum(),
        batches[0]["audio"].device, iters, reps)
    B, N = batches[0]["audio"].shape
    audio_s = B * N / model.frontend.sample_rate
    return dict(ms_per_forward=1e3 * dt / iters, audio_s_per_s=audio_s * iters / dt, witness=witness, reps_s=dts)


def eend_recipe_trainer(model, family: str, seed: int = 0):
    """A Trainer with the EEND recipe's settings (TrainCliConfig defaults and
    warmup 800, mini_librispeech_eend.sh:32)."""
    from .train.tasks import make_eda_loss, make_eend_loss
    from .train.trainer import Trainer, TrainerConfig

    tcfg = TrainerConfig(optimizer="adam", schedule="noam", learning_rate=1.0, d_model=256, warmup_steps=800,
                         grad_clip_norm=5.0, seed=seed)
    return Trainer(model, make_eend_loss() if family == "eend" else make_eda_loss(), tcfg)


def profile(step: Callable[[], object], n: int = 3, family: str = "") -> Tuple[str, float]:
    """Profiler table of `n` calls of `step` (a forward or a train step) of
    `family`, sorted by device time, and the device time per call in ms,
    summed over the CUDA kernels. A family in HOST_STEPPED records device
    events only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    step()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] if family in HOST_STEPPED else [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tprofile(activities=acts) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    kernel_us = sum(getattr(e, attr) for e in events if e.device_type == DeviceType.CUDA)
    return events.table(sort_by=attr, row_limit=30), kernel_us / 1e3 / n


def make_train_batches(cfg: TSVADConfig, batch: int, chunk_s: float, n_bufs: int, seed: int, device) -> List[Dict]:
    """Distinct seeded training batches {audio, target_embs, labels} on the device."""
    audios, embss = make_inputs(cfg, batch, chunk_s, n_bufs, seed, device)
    rng = np.random.default_rng(seed + 1)
    T = int(chunk_s * cfg.label_rate)
    return [
        dict(audio=a, target_embs=e, labels=torch.from_numpy(
            (rng.random((batch, T, cfg.max_num_speaker)) < 0.3).astype(np.float32)).to(device))
        for a, e in zip(audios, embss)
    ]


def recipe_trainer(model, n_label: int, seed: int = 0):
    """A Trainer with the hermetic recipes' TS-VAD optimisation settings
    (the same for TSVADModel and StreamingTSVADModel)."""
    from .models.streaming_tsvad import StreamingTSVADModel
    from .train.tasks import make_streaming_tsvad_loss, make_tsvad_loss
    from .train.trainer import Trainer, TrainerConfig

    tcfg = TrainerConfig(optimizer="adam", schedule="poly", learning_rate=2e-4, warmup_steps=400,
                         total_steps=4000, grad_clip_norm=5.0, seed=seed)
    loss = make_streaming_tsvad_loss if isinstance(model, StreamingTSVADModel) else make_tsvad_loss
    return Trainer(model, loss(n_label), tcfg)


def streaming_model(device, seed: int = 0, bf16: bool = True):
    """Streaming TS-VAD at the second hermetic recipe's stream_cfg, seeded random weights."""
    from .cli.main import TrainCliConfig, build_model

    cfg = TrainCliConfig(family="tsvad_streaming", bf16=bf16, seed=seed, sample_rate=8000, n_mels=80, rs_len=CHUNK_S,
                         d_model=256, d_ff=1024, n_layers=2, n_heads=4, streaming_chunk_size=16,
                         streaming_left_chunks=4)
    return build_model(cfg, device)


@torch.no_grad()
def streaming_throughput(model, audios, embss, n_label: int, iters: int = 20, reps: int = 3) -> Dict[str, float]:
    """Median over `reps` of `iters` pipelined window decodes on distinct inputs."""
    from .infer.chunked import streaming_window_logits

    dt, witness, dts = _pipelined(
        lambda i: torch.sigmoid(streaming_window_logits(model, audios[i % len(audios)], embss[i % len(embss)],
                                                        n_label)).sum(), audios[0].device, iters, reps)
    B, N = audios[0].shape
    audio_s = B * N / model.cfg.sample_rate
    return dict(ms_per_forward=1e3 * dt / iters, audio_s_per_s=audio_s * iters / dt, witness=witness, reps_s=dts)


def train_throughput(trainer, batches, iters: int = 5, reps: int = 3) -> Dict[str, float]:
    """Median over `reps` of `iters` pipelined train steps on distinct batches."""
    dt, witness, dts = _pipelined(lambda i: trainer.train_step(batches[i % len(batches)])["loss"],
                                  trainer.device, iters, reps)
    return dict(ms_per_step=1e3 * dt / iters, witness=witness, reps_s=dts)


def spk_model(device, seed: int = 0, bf16: bool = True):
    """The recipe's SpeakerClassifier (TrainCliConfig with its stage-2
    settings), seeded random weights."""
    from .cli.main import TrainCliConfig, build_model

    cfg = TrainCliConfig(family="spk", bf16=bf16, seed=seed, sample_rate=SPK_RATE, n_mels=80,
                         encoder_blocks="12,24,16", aam_margin=0.3, all_n_speakers=SPK_CLASSES,
                         spk_dur=SPK_DUR_S, batch_size=SPK_BATCH)
    return build_model(cfg, device), cfg


def make_spk_batches(batch: int, n_bufs: int, seed: int, device, seconds: float = SPK_DUR_S) -> List[Dict]:
    """Distinct seeded {audio (B, N) at 8 kHz, label (B,)} device batches."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SPK_RATE)
    return [dict(audio=torch.from_numpy((0.1 * rng.standard_normal((batch, n))).astype(np.float32)).to(device),
                 label=torch.from_numpy(rng.integers(0, SPK_CLASSES, batch)).to(device))
            for _ in range(n_bufs)]


def spk_recipe_trainer(model, seed: int = 0):
    """A Trainer with the recipe's speaker-pretraining settings."""
    from .train.tasks import make_spk_loss
    from .train.trainer import Trainer, TrainerConfig

    tcfg = TrainerConfig(optimizer="adam", schedule="poly", learning_rate=1e-3, warmup_steps=200,
                         total_steps=2000, grad_clip_norm=5.0, seed=seed)
    return Trainer(model, make_spk_loss(sample_rate=SPK_RATE), tcfg)


def embed_forward(encoder):
    """audio (B, N) at 8 kHz → the embeddings `extract-embeddings` computes."""
    from .models.spk_embed import embed_audio

    return lambda a: embed_audio(encoder, a, SPK_RATE)


@torch.no_grad()
def embed_throughput(encoder, audios, iters: int = 10, reps: int = 3) -> Dict[str, float]:
    """Median over `reps` of `iters` pipelined embedding forwards on distinct windows."""
    fwd = embed_forward(encoder)
    dt, witness, dts = _pipelined(lambda i: fwd(audios[i % len(audios)]).float().sum(), audios[0].device, iters, reps)
    return dict(ms_per_forward=1e3 * dt / iters, windows_per_s=audios[0].shape[0] * iters / dt, witness=witness,
                reps_s=dts)


# the seventh, eighth and ninth slices at full width: SOND, TS-VAD3, EEND-VC;
# SSND, EEND-M2F, FS-EEND, OTS-VAD; the neural VAD and the learned enhancer
SLICE_FAMILIES = ("sond", "tsvad3", "eend_vc", "ssnd", "eend_m2f", "fs_eend", "ots_vad", "vad", "enhance")
SLICE7_BATCH, SLICE7_RATE, ENROLL_S = 16, 16000, 6.0
VC_BATCH, VC_CHUNK, VC_SPEAKERS = 32, 200, 32  # the leaderboard's eend_vc batch and chunk; a 32-row speaker table
SLICE8_BATCH, SLICE8_CHUNK = 16, 500  # the leaderboard's m2f and fs_eend batch and chunk (frames)
EIGHT_KHZ = ("eend_vc", "eend_m2f", "fs_eend", "enhance")
VAD_BATCH, VAD_S = 16, 30.0  # neural_sad's 30 s chunks, at NeuralVADConfig()'s 16 kHz
ENH_BATCH, ENH_S = 16, 2.0  # the leaderboard's enhance stage: batch 16 × spk_dur 2 s at 8 kHz
SLICE_DTYPES = {"vad": "fp32"}  # the dtype each family trains in, where it is not bf16
# families whose recurrences are stepped from the host: a step holds hundreds
# of thousands of host events, whose post-processing would outlast many steps,
# so `profile` records only their device events
HOST_STEPPED = ("vad", "enhance")


def slice_audio(family: str, batch: Dict) -> torch.Tensor:
    """The batch's input audio (B, N): the enhancer's is its noisy half."""
    return batch["noisy" if family == "enhance" else "audio"]


def slice_model(family: str, device, seed: int = 0, bf16: bool = True, dropout: float = 0.1):
    """(model, TrainCliConfig or None) at the full widths above, seeded random weights."""
    from .models.ots_vad import OTSVADConfig, OTSVADModel
    from .models.sond import SONDConfig, SONDModel
    from .models.ssnd import SSNDConfig, SSNDModel
    from .models.tsvad import TSVADConfig
    from .models.tsvad3 import TSVAD3Config, TSVAD3Model

    dtype = "bf16" if bf16 else "fp32"
    if family == "vad":
        from .models.vad import NeuralVAD

        return NeuralVAD(dtype=dtype, device=device, seed=seed), None
    if family == "enhance":
        from .models.enhancer import MaskDenoiser

        return MaskDenoiser(dtype=dtype, device=device, seed=seed), None
    if family == "sond":
        return SONDModel(SONDConfig(dropout=dropout), dtype=dtype, device=device, seed=seed), None
    if family == "tsvad3":
        cfg = TSVAD3Config(base=TSVADConfig(dropout=dropout))
        return TSVAD3Model(cfg, dtype=dtype, device=device, seed=seed), None
    if family == "ssnd":
        return SSNDModel(SSNDConfig(), dtype=dtype, device=device, seed=seed, dropout=dropout), None
    if family == "ots_vad":
        return OTSVADModel(OTSVADConfig(dropout=dropout), dtype=dtype, device=device, seed=seed), None
    if family == "eend_vc":
        return eend_model("eend_vc", device, seed=seed, bf16=bf16, n_speakers=3, chunk_frames=VC_CHUNK,
                          all_n_speakers=VC_SPEAKERS, dropout=dropout)
    front = dict(subsampling=1, context_size=0) if family == "eend_m2f" else {}
    return eend_model(family, device, seed=seed, bf16=bf16, n_speakers=3, chunk_frames=SLICE8_CHUNK, dropout=dropout,
                      **front)


def make_slice_batches(family: str, model, n_bufs: int, seed: int, device) -> List[Dict]:
    """Distinct seeded device batches of the family's training loss: SOND
    {audio, target_embs (the 16 profiles, the last 12 absent in half the
    batch), labels at 25 Hz}, TS-VAD3 {audio, enroll_audio, labels}, EEND-VC
    the EEND chunk batch with speaker ids (−1 among them), EEND-M2F and
    FS-EEND the EEND chunk batch (500 frames at subsampling 1 and at 10),
    SSND {audio 4 s, labels (B, S, 100), spk_gids (−1 among them), aux_embs
    (the slot queries)}, OTS-VAD {audio 8 s (left and right halves), labels
    at 25 Hz}, the VAD {audio 30 s, labels (B, T, 2) at its 100 Hz frame
    rate, frame_mask}, the enhancer {clean, noisy 2 s at 8 kHz}."""
    from .cli.main import TrainCliConfig, _slots
    from .ops.features import count_frames

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    if family == "vad":
        c = model.cfg
        n = int(VAD_S * c.sample_rate)
        T = count_frames(n, c.frame_shift)
        out = []
        for _ in range(n_bufs):
            # two speakers' on/off runs of 0.2-2 s; the audio a noise floor plus
            # a tone wherever either speaks, so the labels can be learnt
            labels = np.zeros((VAD_BATCH, T, 2), np.float32)
            for row in labels:
                for spk in range(2):
                    i = int(rng.integers(0, 100))
                    while i < T:
                        on = int(rng.integers(20, 200))
                        row[i : i + on, spk] = 1.0
                        i += on + int(rng.integers(20, 200))
            gate = np.repeat(labels.max(-1), c.frame_shift, axis=1)[:, :n]
            gate = np.pad(gate, ((0, 0), (0, n - gate.shape[1])))
            tone = np.sin(2 * np.pi * rng.uniform(100, 300, (VAD_BATCH, 1)) * np.arange(n) / c.sample_rate)
            audio = 0.01 * rng.standard_normal((VAD_BATCH, n)) + 0.1 * tone * gate
            mask = np.ones((VAD_BATCH, T), np.float32)
            mask[-1, T // 2 :] = 0.0  # a padded tail
            out.append(dict(audio=t(audio.astype(np.float32)), labels=t(labels), frame_mask=t(mask)))
        return out
    if family == "enhance":
        n = int(ENH_S * 8000)
        out = []
        for _ in range(n_bufs):
            clean = 0.1 * np.sin(np.cumsum(rng.uniform(0.02, 0.3, (ENH_BATCH, n)), axis=1))
            noisy = clean + 0.05 * rng.standard_normal((ENH_BATCH, n))
            out.append(dict(clean=t(clean.astype(np.float32)), noisy=t(noisy.astype(np.float32))))
        return out
    if family in EIGHT_KHZ:
        vc = family == "eend_vc"
        front = dict(subsampling=1, context_size=0) if family == "eend_m2f" else {}
        cfg = TrainCliConfig(family=family, n_speakers=3, chunk_frames=VC_CHUNK if vc else SLICE8_CHUNK, **front)
        out = make_eend_batches(cfg, VC_BATCH if vc else SLICE8_BATCH, n_bufs, seed, device)
        for b in out if vc else ():
            ids = rng.integers(0, VC_SPEAKERS, (VC_BATCH, 3)).astype(np.int32)
            ids[rng.random((VC_BATCH, 3)) < 0.2] = -1
            b["spk_ids"] = t(ids)
        return out
    seconds = 2 * CHUNK_S if family == "ots_vad" else CHUNK_S
    n = int(seconds * SLICE7_RATE)
    S = _slots(model)
    out = []
    for _ in range(n_bufs):
        labels = (rng.random((SLICE7_BATCH, int(seconds * 25), S)) < (0.15 if family == "sond" else 0.3))
        b = dict(audio=t((0.1 * rng.standard_normal((SLICE7_BATCH, n))).astype(np.float32)),
                 labels=t(labels.astype(np.float32)))
        if family == "sond":
            embs = rng.standard_normal((SLICE7_BATCH, S, 192)).astype(np.float32)
            embs[: SLICE7_BATCH // 2, 4:] = 0.0
            b["target_embs"] = t(embs)
        elif family == "tsvad3":
            b["enroll_audio"] = t((0.1 * rng.standard_normal((SLICE7_BATCH, S, int(ENROLL_S * SLICE7_RATE))))
                                  .astype(np.float32))
        elif family == "ssnd":
            gids = rng.integers(0, model.cfg.n_all_speakers, (SLICE7_BATCH, S))
            gids[rng.random((SLICE7_BATCH, S)) < 0.25] = -1
            b.update(labels=b["labels"].transpose(1, 2).contiguous(), spk_gids=t(gids),
                     aux_embs=t(rng.standard_normal((SLICE7_BATCH, S, model.cfg.emb_dim)).astype(np.float32)))
        out.append(b)
    return out


def slice_forward(family: str, model) -> Callable[[Dict], torch.Tensor]:
    """batch → what `infer` computes on the device: SOND's per-speaker
    probabilities on the 25 Hz grid, TS-VAD3's logits, EEND-VC's (logits,
    chunk vectors), SSND's (VAD logits, slot embeddings) for the batch's
    slot queries, EEND-M2F's (mask logits, class logits), FS-EEND's (logits,
    embeddings), OTS-VAD's per-speaker probabilities of a 4 s block (its
    frame embeddings, then the backend on the masked means under the labels:
    the embed and score forwards of the online decode)."""
    if family == "vad":
        return lambda b: model(b["audio"])
    if family == "enhance":
        return lambda b: model(b["noisy"])
    if family == "sond":
        from .infer.chunked import sond_probabilities

        return lambda b: sond_probabilities(model, b["audio"], b["target_embs"], SLICE7_RATE)
    if family == "tsvad3":
        return lambda b: model(b["audio"], b["enroll_audio"], int(CHUNK_S * 25))
    if family == "ssnd":
        return lambda b: model(b["audio"], b["aux_embs"])
    if family == "eend_m2f":
        def m2f(b):
            out = model(b["audio"])
            return out["mask_logits"], out["class_logits"]

        return m2f
    if family == "ots_vad":
        def ots(b):
            n = b["audio"].shape[1] // 2
            emb = model.embed_frames(b["audio"][:, :n])
            y = b["labels"][:, : 2 * emb.shape[1] : 2].transpose(1, 2)
            return torch.sigmoid(model.backend(emb, model.masked_target_embeddings(emb, y)))

        return ots
    return lambda b: model(b["audio"], b["frame_mask"])


def slice_loss(family: str):
    from .train import tasks

    if family == "sond":
        return tasks.make_sond_loss_from_audio(sample_rate=SLICE7_RATE)
    if family == "tsvad3":
        return tasks.make_tsvad3_loss(int(CHUNK_S * 25))
    if family == "enhance":
        from .models.enhancer import make_enhance_loss

        return make_enhance_loss()
    return {"eend_vc": tasks.make_eend_vc_loss, "eend_m2f": tasks.make_m2f_loss, "fs_eend": tasks.make_fs_eend_loss,
            "ots_vad": tasks.make_ots_vad_loss, "ssnd": lambda: tasks.make_ssnd_loss(arcface_weight=0.05),
            "vad": tasks.make_vad_loss}[family]()


def slice_recipe_trainer(family: str, model, seed: int = 0):
    """A Trainer with the hermetic leaderboard's settings for the family
    (EEND-VC and FS-EEND: adam, noam, lr 1.0, warmup 1000; the enhancer:
    adam, poly, lr 2e-4, warmup 200 over 1,500 steps; the others: adam,
    poly, lr 2e-4, warmup 400; clip 5), and the CLI's defaults for the VAD
    (adam, noam, lr 1.0, warmup 25000, clip 5)."""
    from .train.trainer import Trainer, TrainerConfig

    if family == "vad":
        tcfg = TrainerConfig(optimizer="adam", schedule="noam", learning_rate=1.0, d_model=256, warmup_steps=25000,
                             grad_clip_norm=5.0, seed=seed)
    elif family == "enhance":
        tcfg = TrainerConfig(optimizer="adam", schedule="poly", learning_rate=2e-4, warmup_steps=200,
                             total_steps=1500, grad_clip_norm=5.0, seed=seed)
    elif family in ("eend_vc", "fs_eend"):
        tcfg = TrainerConfig(optimizer="adam", schedule="noam", learning_rate=1.0, d_model=256, warmup_steps=1000,
                             grad_clip_norm=5.0, seed=seed)
    else:
        tcfg = TrainerConfig(optimizer="adam", schedule="poly", learning_rate=2e-4, warmup_steps=400,
                             total_steps=8000 if family == "ssnd" else 4000, grad_clip_norm=5.0, seed=seed)
    return Trainer(model, slice_loss(family), tcfg)


@torch.no_grad()
def slice_throughput(family: str, model, batches, iters: int = 10, reps: int = 3) -> Dict[str, float]:
    """Median over `reps` of `iters` pipelined forwards on distinct batches."""
    fwd = slice_forward(family, model)

    def call(i):
        out = fwd(batches[i % len(batches)])
        return sum(o.float().sum() for o in out) if isinstance(out, tuple) else out.float().sum()

    x = slice_audio(family, batches[0])
    dt, witness, dts = _pipelined(call, x.device, iters, reps)
    B, N = x.shape
    N = N // 2 if family == "ots_vad" else N
    rate = 8000 if family == "enhance" else model.frontend.sample_rate if family in EIGHT_KHZ else SLICE7_RATE
    return dict(ms_per_forward=1e3 * dt / iters, audio_s_per_s=B * N / rate * iters / dt, witness=witness, reps_s=dts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--family", choices=["tsvad", "tsvad_streaming", "eend", "eend_eda", "spk", *SLICE_FAMILIES],
                    default="tsvad")
    ap.add_argument("--backend", choices=["transformer", "mamba", "mamba_add", "mamba2", "mamba2_add"],
                    default="transformer", help="tsvad: both backends")
    ap.add_argument("--speech-encoder", choices=SPEECH_ENCODERS, default="campplus",
                    help="tsvad: the speech encoder (a type other than campplus runs at batch 32)")
    ap.add_argument("--train", action="store_true", help="time train steps instead of forwards")
    ap.add_argument("--profile", help="write a profiler table of a few forwards (train steps) to this file")
    args = ap.parse_args(argv)
    meta = dict(device=torch.cuda.get_device_name(0), family=args.family,
                dtype="fp32" if args.family == "spk" and not args.train else SLICE_DTYPES.get(args.family, "bf16"))
    per_call = "ms_per_step" if args.train else "ms_per_forward"
    if args.family == "tsvad":
        cfg = zoo_config(args.speech_encoder, args.backend)
        batch = BATCH if args.speech_encoder == "campplus" else ZOO_BATCH
        model = TSVADModel(cfg, dtype="bf16", device="cuda", seed=0)
        T = int(CHUNK_S * cfg.label_rate)
        meta.update(backend=args.backend, speech_encoder=args.speech_encoder, batch=batch, chunk_s=CHUNK_S)
        if args.train:
            trainer = recipe_trainer(model, T)
            batches = make_train_batches(cfg, batch, CHUNK_S, 4, 0, model.device)
            res = train_throughput(trainer, batches)
        else:
            audios, embss = make_inputs(cfg, batch, CHUNK_S, 8, seed=0, device=model.device)
            res = throughput(model, audios, embss, T)

            def forward():
                return model(audios[0], embss[0], T)
    elif args.family == "tsvad_streaming":
        from .infer.chunked import streaming_window_logits

        model = streaming_model("cuda")
        cfg = model.cfg
        T = int(CHUNK_S * cfg.label_rate)
        meta.update(batch=BATCH, chunk_s=CHUNK_S, chunk_size=cfg.chunk_size, left_chunks=cfg.num_left_chunks)
        if args.train:
            trainer = recipe_trainer(model, T)
            batches = make_train_batches(cfg, BATCH, CHUNK_S, 4, 0, model.device)
            res = train_throughput(trainer, batches)
        else:
            audios, embss = make_inputs(cfg, BATCH, CHUNK_S, 8, seed=0, device=model.device)
            res = streaming_throughput(model, audios, embss, T)

            def forward():
                return streaming_window_logits(model, audios[0], embss[0], T)
    elif args.family == "spk":
        model, cfg = spk_model("cuda", bf16=args.train)
        if args.train:
            batches = make_spk_batches(SPK_BATCH, 4, 0, model.device)
            meta.update(batch=SPK_BATCH, chunk_s=SPK_DUR_S, n_classes=SPK_CLASSES)
            trainer = spk_recipe_trainer(model)
            res = train_throughput(trainer, batches)
        else:
            encoder = model.speech_encoder
            audios = [b["audio"] for b in make_spk_batches(EMB_BATCH, 4, 0, model.device, EMB_WINDOW_S)]
            meta.update(batch=EMB_BATCH, chunk_s=EMB_WINDOW_S)
            res = embed_throughput(encoder, audios)
            fwd = embed_forward(encoder)

            def forward():
                return fwd(audios[0])
    elif args.family in SLICE_FAMILIES:
        model, _ = slice_model(args.family, "cuda", bf16=meta["dtype"] == "bf16")
        batches = make_slice_batches(args.family, model, 4, 0, model.device)
        x = slice_audio(args.family, batches[0])
        meta.update(batch=x.shape[0], chunk_s=x.shape[1] / (8000 if args.family in EIGHT_KHZ else SLICE7_RATE))
        if args.train:
            trainer = slice_recipe_trainer(args.family, model)
            res = train_throughput(trainer, batches)
        else:
            res = slice_throughput(args.family, model, batches)
            fwd = slice_forward(args.family, model)

            def forward():
                return fwd(batches[0])
    else:
        model, cfg = eend_model(args.family, "cuda")
        batches = make_eend_batches(cfg, EEND_BATCH, 4, 0, model.device)
        meta.update(batch=EEND_BATCH, chunk_s=batches[0]["audio"].shape[1] / cfg.sample_rate)
        if args.train:
            trainer = eend_recipe_trainer(model, args.family)
            res = train_throughput(trainer, batches)
        else:
            res = eend_throughput(model, batches)
            fwd = eend_forward(model)

            def forward():
                return fwd(batches[0]["audio"], batches[0]["frame_mask"])
    res.update(meta)
    if args.profile:
        if args.train:
            def step():
                return trainer.train_step(batches[0])
        else:
            step = torch.no_grad()(forward)
        table, device_ms = profile(step, family=args.family)
        with open(args.profile, "w") as f:
            f.write(table)
        # busy share: kernel time per call over the unprofiled wall time per call
        res.update(device_ms_per_call=device_ms, busy_share=device_ms / res[per_call])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
