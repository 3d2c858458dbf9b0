"""Collectives over one axis of the mesh, and the data-parallel context.

`AxisComm` reduces over the process group of one mesh axis, in one of two
orders: `all_reduce(SUM)` (the default, the order NCCL or gloo choose), or,
when `deterministic`, an `all_gather` followed by a sum over ranks 0..n−1 in
that order (JAX `train/trainer.py:246-280`), so the floating-point result is
the same however the ranks are laid out.

`data_parallel(comm)` makes `comm` the active data axis for the code run
inside it (a `contextvars.ContextVar`, restored on exit). Two things read
it, so that a data-parallel step computes what one device computes on the
global batch, as JAX's GSPMD step does:

- `models/layers.BatchNorm` in train mode takes its mean and E[x²] over the
  global batch (`AxisComm.mean_grad`, differentiable);
- `batch_mean(num, count)`, the masked means of the losses: the count is
  summed over the data group, so the data-mean of the per-rank losses is the
  global loss and its gradient the global gradient.

The Megatron pair for tensor parallelism over the `model` axis:
`copy_to_model` (identity forward, all-reduce backward) before a
column-parallel Linear, `reduce_from_model` (all-reduce forward, identity
backward) after a row-parallel one.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


class AxisComm:
    """The process group of one mesh axis: `ranks` are the global ranks of
    the group in axis order, `index` this process's place among them."""

    def __init__(self, group, ranks: Sequence[int], index: int, deterministic: bool = False):
        self.group, self.ranks, self.index = group, list(ranks), index
        self.size = len(self.ranks)
        self.deterministic = deterministic

    def with_order(self, deterministic: bool) -> "AxisComm":
        return AxisComm(self.group, self.ranks, self.index, deterministic)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the group of x (not differentiable)."""
        x = x.contiguous()
        if self.deterministic:
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.group)
            acc = parts[0]
            for p in parts[1:]:
                acc = acc + p
            return acc
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return self.sum(x) / self.size

    def mean_flat(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the group of each tensor, through one flattened
        buffer per dtype (one collective per dtype, not one per tensor)."""
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        for dtype in {t.dtype for t in tensors}:
            idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
            flat = self.mean(torch.cat([tensors[i].reshape(-1) for i in idx]))
            for i, part in zip(idx, torch.split(flat, [tensors[i].numel() for i in idx])):
                out[i] = part.view_as(tensors[i])
        return out

    def mean_grad(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable mean over the group: the backward takes the mean of
        the incoming gradients (each rank's loss reads every rank's x)."""
        return _MeanOverGroup.apply(x, self)


class _MeanOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.mean(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.mean(g), None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.sum(g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, comm: AxisComm) -> torch.Tensor:
    """The input of a column-parallel Linear: x forward, the sum of the
    model ranks' gradients backward."""
    return _CopyToModel.apply(x, comm)


def reduce_from_model(x: torch.Tensor, comm: AxisComm) -> torch.Tensor:
    """The output of a row-parallel Linear: the sum of the model ranks'
    partial products forward, the gradient as it is backward."""
    return _ReduceFromModel.apply(x, comm)


_DATA: contextvars.ContextVar = contextvars.ContextVar("data_axis", default=None)


@contextlib.contextmanager
def data_parallel(comm: Optional[AxisComm]):
    """Run the enclosed code with `comm` as the data axis (None: none)."""
    token = _DATA.set(comm)
    try:
        yield
    finally:
        _DATA.reset(token)


def data_axis() -> Optional[AxisComm]:
    """The active data axis, or None outside a data-parallel step."""
    return _DATA.get()


def batch_mean(num: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """num / max(count, 1), where num and count are sums over the batch.

    Inside a data-parallel step of n ranks, count is summed over the data
    group and the result scaled by n: n · num_r / max(Σ count, 1), whose mean
    over the ranks is Σ num / max(Σ count, 1), the loss of the global batch.
    """
    comm = _DATA.get()
    if comm is None:
        return num / torch.clamp_min(count, 1.0)
    return num * comm.size / torch.clamp_min(comm.sum(count.detach()), 1.0)
