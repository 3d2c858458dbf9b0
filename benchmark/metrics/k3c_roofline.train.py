"""K3c's share of its roofline: the bound of a BiMamba step's selective-scan
backward launches (costs/kernels.py, at the cell's shape) over their traced
time, the row-sum pass that finishes dA and dD included."""

from benchmark.costs.kernels import k3c_bound_s
from benchmark.metrics import kernel_s


def read(ctx):
    t = kernel_s(ctx, "scan_bwd_kernel", "sum_rows_kernel")
    if ctx.loop != "train" or t <= 0:
        return None
    c = ctx.model_cfg
    S = c["max_num_speaker"]
    bound = k3c_bound_s(ctx.batch * S, ctx.batch, ctx.n_label, c["expand"] * c["transformer_embed_dim"], c["d_state"],
                        c["num_transformer_layer"])
    return 100.0 * bound / t
