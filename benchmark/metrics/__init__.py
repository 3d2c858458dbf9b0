"""One reader a metric: `<name>.py` with `read(ctx) -> float | None` (None: nothing to read)."""

import statistics


def rate(ctx, loop: str):
    """Audio seconds the window's calls covered, over the window's seconds."""
    if ctx.loop != loop or ctx.window_s <= 0:
        return None
    return ctx.calls * ctx.audio_s_per_call / ctx.window_s


def dispatch_ms(ctx, loop: str):
    return 1e3 * statistics.median(ctx.dispatch_s) if ctx.loop == loop and ctx.dispatch_s else None


def device_ms(ctx, loop: str):
    p = ctx.profile
    if ctx.loop != loop or not p or not p["kernels"]:
        return None
    return 1e3 * sum(p["kernels"].values()) / p["calls"]


def idle_share(ctx, loop: str):
    p = ctx.profile
    if ctx.loop != loop or not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def kernel_s(ctx, *names):
    """Device seconds a call of the kernels whose names hold any of `names`."""
    p = ctx.profile
    if not p:
        return 0.0
    return sum(v for k, v in p["kernels"].items() if any(n in k for n in names)) / p["calls"]


def mfu(ctx, loop: str):
    """Model FLOPs of the window's calls over its seconds, against the bf16 peak."""
    if ctx.loop != loop or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.flops_per_call() * ctx.calls / ctx.window_s / ctx.peaks["bf16_flops_per_s"]
