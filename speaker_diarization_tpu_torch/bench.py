"""TS-VAD inference and training throughput of the port on one GPU.

Measures what the JAX package's bench.py measures, on the card: audio
seconds per second of the full-size TS-VAD forward (TSVADConfig(), CAM++
12/24/16, bf16) at batch 64 × 4 s chunks, with seeded random weights;
`--backend mamba` swaps both backends for BiMamba (S6, d_state 64).
`--train` instead times train steps at the hermetic recipe's settings
(batch 64 × 4 s, bf16, adam, poly schedule, lr 2e-4, warmup 400, clip 5)
on seeded random batches. Completion is proven by a data dependency: every
forward's probability checksum (every step's loss) is chained into one
device scalar that is read on the host after torch.cuda.synchronize(), so
the clock cannot stop before every forward or step ran.

    python -m speaker_diarization_tpu_torch.bench [--backend mamba] [--train] [--profile profile.txt]

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

from .models.tsvad import TSVADConfig, TSVADModel

BATCH, CHUNK_S = 64, 4.0  # the JAX bench's shape (reference run_ts_vad2.sh:198)


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
    for i in range(2):  # warm-up: kernel builds, cuDNN plans, allocator
        torch.sigmoid(model(audios[i % len(audios)], embss[i % len(embss)], n_label)).sum().item()
    dts, witness = [], 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = torch.zeros((), dtype=torch.float64, device=audios[0].device)
        for i in range(iters):
            acc += torch.sigmoid(model(audios[i % len(audios)], embss[i % len(embss)], n_label)).sum()
        torch.cuda.synchronize()
        witness = acc.item()
        dts.append(time.perf_counter() - t0)
        if not np.isfinite(witness):
            raise RuntimeError(f"non-finite checksum {witness}")
    dt = statistics.median(dts)
    B, N = audios[0].shape
    audio_s = B * N / model.cfg.sample_rate
    return dict(ms_per_forward=1e3 * dt / iters, audio_s_per_s=audio_s * iters / dt, witness=witness, reps_s=dts)


def profile(step: Callable[[], object], n: int = 3) -> Tuple[str, float]:
    """Profiler table of `n` calls of `step` (a forward or a train step),
    sorted by device time, and the device time per call in ms, summed over
    the CUDA kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    step()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def recipe_trainer(model: TSVADModel, n_label: int, seed: int = 0):
    """A Trainer with the hermetic recipe's TS-VAD optimisation settings."""
    from .train.tasks import make_tsvad_loss
    from .train.trainer import Trainer, TrainerConfig

    tcfg = TrainerConfig(optimizer="adam", schedule="poly", learning_rate=2e-4, warmup_steps=400,
                         total_steps=4000, grad_clip_norm=5.0, seed=seed)
    return Trainer(model, make_tsvad_loss(n_label), tcfg)


def train_throughput(trainer, batches, iters: int = 5, reps: int = 3) -> Dict[str, float]:
    """Median over `reps` of `iters` pipelined train steps on distinct batches."""
    for i in range(2):  # warm-up: kernel builds, cuDNN plans, allocator
        trainer.train_step(batches[i % len(batches)])["loss"].item()
    dts, witness = [], 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = torch.zeros((), dtype=torch.float64, device=batches[0]["audio"].device)
        for i in range(iters):
            acc += trainer.train_step(batches[i % len(batches)])["loss"]
        torch.cuda.synchronize()
        witness = acc.item()
        dts.append(time.perf_counter() - t0)
        if not np.isfinite(witness):
            raise RuntimeError(f"non-finite loss checksum {witness}")
    dt = statistics.median(dts)
    return dict(ms_per_step=1e3 * dt / iters, witness=witness, reps_s=dts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--backend", choices=["transformer", "mamba", "mamba_add"], default="transformer",
                    help="both TS-VAD backends")
    ap.add_argument("--train", action="store_true", help="time train steps instead of forwards")
    ap.add_argument("--profile", help="write a profiler table of a few forwards (train steps) to this file")
    args = ap.parse_args(argv)
    cfg = TSVADConfig(single_backend_type=args.backend, multi_backend_type=args.backend)
    model = TSVADModel(cfg, dtype="bf16", device="cuda", seed=0)
    T = int(CHUNK_S * cfg.label_rate)
    meta = dict(device=torch.cuda.get_device_name(0), backend=args.backend, batch=BATCH, chunk_s=CHUNK_S, dtype="bf16")
    if args.train:
        trainer = recipe_trainer(model, T)
        batches = make_train_batches(cfg, BATCH, CHUNK_S, 4, 0, model.device)
        res, per_call = train_throughput(trainer, batches), "ms_per_step"

        def step():
            return trainer.train_step(batches[0])
    else:
        audios, embss = make_inputs(cfg, BATCH, CHUNK_S, 8, seed=0, device=model.device)
        res, per_call = throughput(model, audios, embss, T), "ms_per_forward"

        @torch.no_grad()
        def step():
            return model(audios[0], embss[0], T)
    res.update(meta)
    if args.profile:
        table, device_ms = profile(step)
        with open(args.profile, "w") as f:
            f.write(table)
        # busy share: kernel time per call over the unprofiled wall time per call
        res.update(device_ms_per_call=device_ms, busy_share=device_ms / res[per_call])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
