"""Layers that keep fp32 parameters and compute in the input's dtype.

The JAX package's modules hold fp32 parameters and cast them to the compute
dtype at use (flax `dtype=`); these subclasses do the same, so one set of
fp32 weights serves float32 and bfloat16 runs. BatchNorm normalises in
fp32 and casts back, as flax's BatchNorm does for a bf16 input.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as Fn
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import data_axis


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Conv1d(nn.Conv1d):
    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Linear(nn.Linear):
    def forward(self, x):
        return Fn.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over dim 1 of (N, C, ...) inputs, normalised in fp32.

    Train mode follows flax's BatchNorm, not PyTorch's: the batch variance is
    the biased E[x²] − E[x]² (clipped at 0), and the running statistics move
    by `momentum` = 0.1 towards the batch mean and that same biased variance
    (flax momentum 0.9).

    Inside a data-parallel step (`parallel.collectives.data_parallel`) train
    mode is synced: the mean and E[x²] are averaged over the data group,
    differentiably (in the fixed rank order under `deterministic_reduce`),
    so they are the global batch's, as under JAX's GSPMD. The shards are the
    same size (`shard_batch` of a batch that divides by the data size).
    """

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"BatchNorm wants (N, C, ...), got {tuple(x.shape)}")

    def forward(self, x):
        xf = x.float()
        if not self.training:
            y = Fn.batch_norm(xf, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
            return y.to(x.dtype)
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        mean, sq = xf.mean(dims), (xf * xf).mean(dims)
        comm = data_axis()
        if comm is not None:
            mean, sq = comm.mean_grad(torch.stack([mean, sq])).unbind(0)
        var = torch.clamp_min(sq - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        y = (xf - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        if self.weight is not None:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


def dropout(x: torch.Tensor, p: float, training: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with its mask drawn from `generator` (on x's device).

    The JAX package draws from jax.random keys; the two frameworks' bits
    differ, so parity tests run with p = 0.
    """
    if not training or p == 0.0:
        return x
    keep = torch.empty(x.shape, device=x.device).bernoulli_(1.0 - p, generator=generator)
    return x * (keep / (1.0 - p)).to(x.dtype)


def remat(module: nn.Module, *args, generator: Optional[torch.Generator] = None):
    """module(*args) with its activations recomputed in the backward pass
    instead of kept (flax `nn.remat`), through torch.utils.checkpoint.

    The recomputation must repeat the forward exactly. checkpoint restores
    only the global RNG, so the dropout `generator` is wound back to its
    state at the forward for the recomputation and then put back where the
    backward found it; a train-mode BatchNorm would move its running
    statistics a second time, so the module's buffers are restored after it.
    """

    at_forward = {}

    @contextlib.contextmanager
    def forward_ctx():
        if generator is not None:
            at_forward["rng"] = generator.get_state()
        yield

    @contextlib.contextmanager
    def recompute_ctx():
        saved = [b.clone() for b in module.buffers()]
        now = None
        if generator is not None:
            now = generator.get_state()
            generator.set_state(at_forward["rng"])
        try:
            yield
        finally:
            if now is not None:
                generator.set_state(now)
            with torch.no_grad():
                for b, s in zip(module.buffers(), saved):
                    b.copy_(s)

    return checkpoint(module, *args, use_reentrant=False, context_fn=lambda: (forward_ctx(), recompute_ctx()))


def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights for every parameter and BatchNorm statistic.

    Matrices and kernels are N(0, 1/fan_in); biases N(0, 0.01); BatchNorm
    scale 1 + N(0, 0.01), shift N(0, 0.01), running mean N(0, 0.01) and
    running variance 1 + U(0, 0.2), so folded statistics are not trivial.
    Mamba's A_log and D take Mamba's own init (log 1..N per channel, ones),
    as in the JAX package; Mamba-2's per-head A_log and dt_bias take the JAX
    Mamba2Layer's draws (A uniform in [1, 16]; softplus(dt_bias) log-uniform
    in [1e-3, 1e-1]). Draws on the CPU from `generator`, in state-dict
    order, then copies.
    """
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "num_batches_tracked":
                t.zero_()
                continue
            shape = tuple(t.shape)
            if leaf == "A_log" and t.dim() == 1:  # Mamba-2: one A per head
                v = torch.log(1.0 + 15.0 * torch.rand(shape, generator=generator))
            elif leaf == "dt_bias":
                u = math.log(1e-3) + (math.log(1e-1) - math.log(1e-3)) * torch.rand(shape, generator=generator)
                v = torch.log(torch.expm1(torch.exp(u)))
            elif leaf == "A_log":
                v = torch.log(torch.arange(1, shape[1] + 1, dtype=torch.float32)).repeat(shape[0], 1)
            elif leaf == "D":
                v = torch.ones(shape)
            elif leaf == "running_var":
                v = 1.0 + 0.2 * torch.rand(shape, generator=generator)
            elif leaf == "running_mean" or leaf == "bias":
                v = 0.1 * torch.randn(shape, generator=generator)
            elif leaf == "weight" and t.dim() == 1:  # norm scale
                v = 1.0 + 0.1 * torch.randn(shape, generator=generator)
            else:
                fan_in = max(1, t[0].numel()) if t.dim() > 1 else 1
                v = torch.randn(shape, generator=generator) / fan_in**0.5
            t.copy_(v.to(t.dtype))
