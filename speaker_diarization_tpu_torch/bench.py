"""TS-VAD inference throughput of the port on one GPU.

Measures what the JAX package's bench.py measures, on the card: audio
seconds per second of the full-size TS-VAD forward (TSVADConfig(), CAM++
12/24/16, bf16) at batch 64 × 4 s chunks, with seeded random weights.
Completion is proven by a data dependency: every forward's probability
checksum is chained into one device scalar that is read on the host after
torch.cuda.synchronize(), so the clock cannot stop before every forward ran.

    python -m speaker_diarization_tpu_torch.bench [--profile profile.txt]

`--profile` also records a torch.profiler window of a few forwards, writes
the device time per kernel, and reports the device's busy share: CUDA
kernel time per forward over the unprofiled wall time per forward.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict, List, Tuple

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


@torch.no_grad()
def profile(model: TSVADModel, audio, embs, n_label: int, n: int = 3) -> Tuple[str, float]:
    """Profiler table of `n` forwards (sorted by device time) and the
    device time per forward in ms, summed over the CUDA kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.sigmoid(model(audio, embs, n_label)).sum().item()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            model(audio, embs, n_label)
        torch.cuda.synchronize()
    events = prof.key_averages()
    attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    kernel_us = sum(getattr(e, attr) for e in events if e.device_type == DeviceType.CUDA)
    return events.table(sort_by=attr, row_limit=30), kernel_us / 1e3 / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--profile", help="write a profiler table of a few forwards to this file")
    args = ap.parse_args(argv)
    cfg = TSVADConfig()
    model = TSVADModel(cfg, dtype="bf16", device="cuda", seed=0)
    audios, embss = make_inputs(cfg, BATCH, CHUNK_S, 8, seed=0, device=model.device)
    T = int(CHUNK_S * cfg.label_rate)
    res = throughput(model, audios, embss, T)
    res.update(device=torch.cuda.get_device_name(0), batch=BATCH, chunk_s=CHUNK_S, dtype="bf16")
    if args.profile:
        table, device_ms = profile(model, audios[0], embss[0], T)
        with open(args.profile, "w") as f:
            f.write(table)
        # busy share: kernel time per forward over the unprofiled wall time per forward
        res.update(device_ms_per_forward=device_ms, busy_share=device_ms / res["ms_per_forward"])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
