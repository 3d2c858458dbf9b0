"""Layers that keep fp32 parameters and compute in the input's dtype.

The JAX package's modules hold fp32 parameters and cast them to the compute
dtype at use (flax `dtype=`); these subclasses do the same, so one set of
fp32 weights serves float32 and bfloat16 runs. BatchNorm normalises in
fp32 and casts back, as flax's BatchNorm does for a bf16 input.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as Fn


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
    """BatchNorm over dim 1 of (N, C, ...) inputs, normalised in fp32."""

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"BatchNorm wants (N, C, ...), got {tuple(x.shape)}")

    def forward(self, x):
        y = Fn.batch_norm(
            x.float(), self.running_mean, self.running_var, self.weight, self.bias,
            self.training, self.momentum, self.eps,
        )
        return y.to(x.dtype)


def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights for every parameter and BatchNorm statistic.

    Matrices and kernels are N(0, 1/fan_in); biases N(0, 0.01); BatchNorm
    scale 1 + N(0, 0.01), shift N(0, 0.01), running mean N(0, 0.01) and
    running variance 1 + U(0, 0.2), so folded statistics are not trivial.
    Draws on the CPU from `generator`, in state-dict order, then copies.
    """
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "num_batches_tracked":
                t.zero_()
                continue
            shape = tuple(t.shape)
            if leaf == "running_var":
                v = 1.0 + 0.2 * torch.rand(shape, generator=generator)
            elif leaf == "running_mean" or leaf == "bias":
                v = 0.1 * torch.randn(shape, generator=generator)
            elif leaf == "weight" and t.dim() == 1:  # norm scale
                v = 1.0 + 0.1 * torch.randn(shape, generator=generator)
            else:
                fan_in = max(1, t[0].numel()) if t.dim() > 1 else 1
                v = torch.randn(shape, generator=generator) / fan_in**0.5
            t.copy_(v.to(t.dtype))
