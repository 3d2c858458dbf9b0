"""Frozen operation and byte counts of the port's hand-written kernels.

Copies of the counts the measured package keeps beside its kernels
(`kernels/cam_block.cam_block_work`, `kernels/selective_scan.scan_work`), so
that a later change to the program cannot move the yardstick. A bound is
the least time the card could take: the larger of bytes over the HBM rate
and each kind of operation over its peak (costs/peaks.json).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from . import PEAKS

# K2: the CAM++ dense block (csrc/cam_block.cu), CAM++'s fixed widths
BOTTLENECK, GROWTH, CONTEXT_HIDDEN = 128, 32, 64
# CAM++ (12, 24, 16) as TS-VAD runs it: (input channels, layers) of each block
CAMPP_BLOCKS = ((128, 12), (256, 24), (512, 16))
SCAN_CHUNK = 16  # steps per saved state of K3b / K3c


def cam_block_work(B: int, T: int, c0: int, L: int, seg_len: int = 100, elem_bytes: int = 2) -> Dict[str, float]:
    """One K2 launch: x read once, the (B, T, c0 + 32 L) output written once,
    the live weights read once; operations over the live channels only (the
    1x1 projection, the three k=3 products, the context MLP and the
    element-wise BN/ReLU, mask and sigmoid work)."""
    n_seg = -(-T // seg_len)
    flops = wbytes = 0.0
    for i in range(L):
        c_in = c0 + GROWTH * i
        flops += 2.0 * B * T * (c_in * BOTTLENECK + 3 * BOTTLENECK * GROWTH)
        flops += 2.0 * B * n_seg * (BOTTLENECK * CONTEXT_HIDDEN + CONTEXT_HIDDEN * GROWTH)
        flops += B * T * (3.0 * c_in + 3.0 * BOTTLENECK + 2.0 * GROWTH) + B * n_seg * 4.0 * GROWTH
        wbytes += elem_bytes * (c_in * BOTTLENECK + 3 * BOTTLENECK * GROWTH + BOTTLENECK * CONTEXT_HIDDEN
                                + CONTEXT_HIDDEN * GROWTH)
        wbytes += 4.0 * (2 * c_in + 2 * BOTTLENECK + CONTEXT_HIDDEN + GROWTH)
    io = elem_bytes * B * T * (c0 + c0 + GROWTH * L)
    return dict(bytes=io + wbytes, flops=flops)


def scan_bwd_work(B: int, T: int, D: int, N: int) -> Dict[str, float]:
    """One K3c launch: reads x, Δ, dy, B, C, the saved chunk states, A and D,
    writes dx, dΔ, dB, dC, dA and dD; one exponential and about 16 fp32
    operations per (b, t, d, n)."""
    n_chunks = -(-T // SCAN_CHUNK)
    btd, btn, elems = B * T * D, B * T * N, B * T * D * N
    return dict(bytes=4.0 * (5 * btd + 4 * btn + 2 * (D * N + D) + B * n_chunks * N * D), flops=16.0 * elems,
                exps=float(elems))


def bound_s(work: Dict[str, float], flops_per_s: float) -> Tuple[float, str]:
    """(seconds, what bounds it) for one launch's work at `flops_per_s`."""
    times = {"bytes": work["bytes"] / PEAKS["hbm_bytes_per_s"], "operations": work["flops"] / flops_per_s}
    if "exps" in work:
        times["exp"] = work["exps"] / PEAKS["exp_per_s"]
    by = max(times, key=times.get)
    return times[by], by


def k2_bound_s(B: int, T50: int, blocks: Iterable[Tuple[int, int]] = CAMPP_BLOCKS) -> float:
    """The three bf16 K2 launches of one TS-VAD forward of B windows of T50 frames."""
    return sum(bound_s(cam_block_work(B, T50, c0, L), PEAKS["bf16_flops_per_s"])[0] for c0, L in blocks)


def k3c_bound_s(rows_single: int, rows_multi: int, T: int, D: int, N: int, layers: int) -> float:
    """The K3c launches of one BiMamba TS-VAD train step: two directions per
    layer in each backend, the single backend over B·S rows, the multi
    backend over B."""
    per = lambda rows: bound_s(scan_bwd_work(rows, T, D, N), PEAKS["fp32_flops_per_s"])[0]  # noqa: E731
    return 2 * layers * (per(rows_single) + per(rows_multi))
