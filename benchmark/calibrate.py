"""Readings that the correctness limits are set from, at a cell's own size.

    python3 -m benchmark.calibrate --workload <name> --seeds 1 2 3 ... --mode program|control|half [--seconds 2]

`program`: the cell's loop as a run drives it (its set-up, a short window,
its check), on each seed. `control`: the reference put in the program's
place, computed with float8 operands, against the float32 reference.
`half` (train loops): the program with its loss taken over half of each
batch. Prints one JSON line of readings a seed. Never run by the benchmark's
own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import harness
from benchmark.reference import tsvad


def half_batch_loss():
    """Make the port's TS-VAD loss see only the first half of each batch (the fault)."""
    import speaker_diarization_tpu_torch.train.tasks as tasks

    make = tasks.make_tsvad_loss

    def make_half(n_label, freeze_encoder=False):
        inner = make(n_label, freeze_encoder)

        def loss_fn(model, batch, generator, train):
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return inner(model, half, generator, train)

        return loss_fn

    tasks.make_tsvad_loss = make_half


def reading(workload: str, seed: int, mode: str, seconds: float, device: str = "cuda", overrides=None) -> dict:
    man = harness.manifest()
    cell = {w["name"]: w for w in man["workloads"]}[workload]
    ctx = harness.Ctx(workload, cell["config"], cell["traffic"], seed, device, overrides=overrides)
    loop = __import__(f"benchmark.loops.{ctx.loop}", fromlist=["Loop"]).Loop(ctx)
    if mode == "control":
        model = ctx.build_model()  # the names and shapes of the weights only
        del model
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        loop.ring = ctx.batches()
        ref, low = loop.reference(), loop.reference(tsvad.Precision(fp8=True))
        return loop.readings(list(enumerate(low)) if ctx.loop == "infer" else low, ref)
    loop.setup()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        loop.call(i, timed=True)
        i += 1
    ctx.calls = i
    return loop.measure()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--mode", choices=("program", "control", "half"), default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--dtype", help="run the program in this dtype instead of the configuration's (a witness)")
    args = ap.parse_args(argv)
    over = {"config": {"dtype": args.dtype}} if args.dtype else None
    if args.mode == "half":
        half_batch_loss()
    for seed in args.seeds:
        t = time.time()
        r = reading(args.workload, seed, args.mode, args.seconds, overrides=over)
        print(json.dumps(dict(workload=args.workload, mode=args.mode, seed=seed, s=round(time.time() - t, 1),
                              peak=torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0, **r)))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
