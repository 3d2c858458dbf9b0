"""The cell runner: everything a run does between the command line and its result.

A cell is found by its name in BENCHMARK.json. Its configuration is
`configs/<config>.json`, its traffic `traffic/<traffic>.json` (read by
`traffic/meetings.py`), its loop `loops/<loop>.py` (the traffic's `loop`),
its correctness limits `limits/<workload>.json`, and each metric it
reports `metrics/<metric>.py`, a reader with `read(ctx) -> float | None`.
Adding a configuration, a traffic mix, a metric or a cell adds files and
manifest entries; no file here changes.

A run: build the measured model with the benchmark's seeded weights and the
traffic's batches, warm every shape (the loop's set-up), then call the loop
for `seconds` with nothing else on the path, synchronise, and read the
window. With `trace` it then profiles a short stretch of the same calls and
times a few calls' host dispatch from an idle device. Last, with the
program's state freed, the loop compares what its timed calls produced
with the plain reference.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import time
from typing import Callable, Dict, List, Optional

import torch

from . import costs, weights
from .traffic import meetings

BENCH = os.path.dirname(os.path.abspath(__file__))
CALIBRATION_WINDOWS = 32  # windows of the traffic's kind that set eval-mode BatchNorm statistics
ROOT = os.path.dirname(BENCH)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(path: Optional[str] = None) -> dict:
    return load_json(path or os.path.join(ROOT, "BENCHMARK.json"))


def cell_metrics(man: dict, workload: str, trace: bool) -> List[dict]:
    """The metric entries a run of `workload` reports: the end-to-end ones
    without `trace`, the per-layer ones with it; an entry with `workloads`
    only in the cells it lists."""
    return [m for m in man["per_layer" if trace else "end_to_end"] if workload in m.get("workloads", [workload])]


def load_reader(name: str, metrics_dir: Optional[str] = None):
    """metrics/<name>.py's `read`; names may hold dots, so load by path."""
    path = os.path.join(metrics_dir or os.path.join(BENCH, "metrics"), name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


class Ctx:
    """One run's state, shared by the loop and the metric readers."""

    def __init__(self, workload: str, config: str, traffic: str, seed: int, device: str, bench_dir: str = BENCH,
                 overrides: Optional[dict] = None):
        self.workload, self.seed, self.device = workload, seed, torch.device(device)
        over = overrides or {}
        self.config = {**load_json(os.path.join(bench_dir, "configs", config + ".json")), **over.get("config", {})}
        self.config["tsvad"] = {**self.config["tsvad"], **over.get("tsvad", {})}
        self.traffic = {**load_json(os.path.join(bench_dir, "traffic", traffic + ".json")), **over.get("traffic", {})}
        limits = os.path.join(bench_dir, "limits", workload + ".json")
        self.limits = {**(load_json(limits) if os.path.exists(limits) else {}), **over.get("limits", {})}
        self.model_cfg = self.config["tsvad"]
        self.peaks = costs.PEAKS
        # filled by the loop and the run
        self.shapes: Dict[str, tuple] = {}
        self.calls = 0
        self.window_s = self.setup_s = 0.0
        self.memory_peak = 0
        self.profile: Optional[dict] = None
        self.dispatch_s: List[float] = []
        self._flops: Optional[float] = None
        self.calibrate_bn = False  # eval-mode loops set it: running statistics from a calibration batch

    # -- shapes of the traffic
    @property
    def loop(self) -> str:
        return self.traffic["loop"]

    @property
    def batch(self) -> int:
        return self.traffic["batch"]

    @property
    def samples(self) -> int:
        return int(round(self.traffic["window_s"] * self.model_cfg["sample_rate"]))

    @property
    def n_label(self) -> int:
        return int(round(self.traffic["window_s"] * self.model_cfg["label_rate"]))

    @property
    def audio_s_per_call(self) -> float:
        return self.batch * self.traffic["window_s"]

    def frames50(self) -> int:
        """CAM++ frames of one window: 25 ms fbank frames every 10 ms, halved."""
        sr = self.model_cfg["sample_rate"]
        n100 = 1 + (self.samples - sr * 25 // 1000) // (sr // 100)
        return -(-n100 // 2)

    def flops_per_call(self) -> float:
        if self._flops is None:
            from .costs.flops import call_flops

            self._flops = call_flops(self.loop, self.shapes, self.model_cfg, self.batch, self.samples, self.n_label)
        return self._flops

    # -- device
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def make_weights(self) -> Dict[str, torch.Tensor]:
        P = weights.make_weights(self.shapes, self.seed, self.device)
        if self.calibrate_bn:
            t = dict(self.traffic, batch=CALIBRATION_WINDOWS, ring=1)
            weights.calibrate_bn(P, self.model_cfg, meetings.make(t, self.model_cfg, weights.stream(self.seed, 6),
                                                                  self.device)[0])
        return P

    def build_model(self):
        """The measured TS-VAD with the benchmark's seeded weights."""
        from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel

        c = dict(self.model_cfg)
        c["encoder_block_layers"] = tuple(c["encoder_block_layers"])
        model = TSVADModel(TSVADConfig(**c), dtype=self.config["dtype"], device=self.device, seed=0)
        self.shapes = weights.shapes_of(model)
        model.load_state_dict(self.make_weights())
        return model

    def batches(self):
        return meetings.make(self.traffic, self.model_cfg, self.seed, self.device)


def probe_dispatch(ctx: Ctx, call: Callable[[int], None], start: int, n: int = 3) -> List[float]:
    """Host seconds to enqueue one call, each from an idle device."""
    out = []
    for i in range(n):
        ctx.sync()
        t = time.perf_counter()
        call(start + i)
        out.append(time.perf_counter() - t)
        ctx.sync()
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_process: Optional[float] = None, man: Optional[dict] = None, bench_dir: str = BENCH,
             overrides: Optional[dict] = None) -> dict:
    """One run of `workload`. → the result object (without the import check)."""
    t_process = time.time() if t_process is None else t_process
    man = man or manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    ctx = Ctx(workload, cell["config"], cell["traffic"], seed, device, bench_dir, overrides)
    loop = importlib.import_module(f"benchmark.loops.{ctx.loop}").Loop(ctx)
    loop.setup()
    ctx.sync()
    ctx.setup_s = time.time() - t_process
    t0 = time.perf_counter()
    i = 0
    while True:
        loop.call(i, timed=True)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    ctx.sync()
    ctx.window_s = time.perf_counter() - t0
    ctx.calls = i
    if ctx.device.type == "cuda":
        ctx.memory_peak = int(torch.cuda.max_memory_allocated(ctx.device))
    failed = loop.failed()
    t_trace = time.perf_counter()
    if trace:
        from .trace import profile_stretch

        ctx.profile = profile_stretch(ctx, loop.call, start=i, n=loop.TRACE_CALLS, span=loop.SPAN)
        ctx.dispatch_s = probe_dispatch(ctx, lambda k: loop.call(k, timed=False), start=i + loop.TRACE_CALLS)
    metrics = {}
    for m in cell_metrics(man, workload, trace):
        value = load_reader(m["name"], os.path.join(bench_dir, "metrics"))(ctx)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    t_check = time.perf_counter()
    checks = loop.check()
    stages = dict(setup_s=ctx.setup_s, window_s=ctx.window_s, trace_s=t_check - t_trace,
                  check_s=time.perf_counter() - t_check)
    device_info = dict(platform="gpu" if ctx.device.type == "cuda" else ctx.device.type,
                       kind=torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
                       count=cell["chips"], memory_peak_bytes=ctx.memory_peak)
    if ctx.device.type == "cuda":
        device_info["power"] = power_limit()
    if trace and ctx.profile is not None:
        device_info.update(busy_s=ctx.profile["busy_s"], window_s=ctx.profile["window_s"])
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and failed == 0 and bool(checks)
    result = dict(correct=correct, attempted=ctx.calls, failed=failed, metrics=metrics, device=device_info)
    if trace and ctx.profile is not None:
        result["breakdown"] = ctx.profile["breakdown"]
    result["stages"] = stages
    result["checks"] = checks
    return result

