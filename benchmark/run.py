"""Run one cell of the benchmark and print its result.

    python3 -m benchmark.run --workload <config>.<traffic> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is the result object; the last
lines of standard error are the numbers the correctness check compared,
each beside its limit. Without CUDA, with fewer cards than the cell asks
for, or with JAX or the JAX package loaded once the window has closed, it
prints no result and exits with a code other than 0.
"""

import os
import time


def _process_start() -> float:
    """Wall-clock time at which this process started (from /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROCESS = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "speaker_diarization_tpu")


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m.split(".", 1)[0] for m in modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    man = harness.manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {need} CUDA device(s); {n} available", file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS, man)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 4
    print("stages " + " ".join(f"{k} {v:.1f}" for k, v in result["stages"].items()), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
