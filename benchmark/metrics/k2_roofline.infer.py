"""K2's share of its roofline: the bound of a forward's three CAM++ dense-block
launches (costs/kernels.py, at the cell's windows and frames) over their traced time."""

from benchmark.costs.kernels import k2_bound_s
from benchmark.metrics import kernel_s


def read(ctx):
    t = kernel_s(ctx, "cam_block")
    return 100.0 * k2_bound_s(ctx.batch, ctx.frames50()) / t if ctx.loop == "infer" and t > 0 else None
