"""Selective state-space scan (Mamba S6): the plain O(T) recurrence.

Counterpart of speaker_diarization_tpu/ops/mamba_scan.py. With ZOH
discretisation (decay exp(Δ·A), input Δ·B·x):

    h_t = exp(Δ_t ⊗ A) ⊙ h_{t-1} + B_t ⊗ (Δ_t · x_t),   h_{-1} = 0
    y_t = C_t · h_t + D ⊙ x_t

`selective_scan_sequential` loops over time and keeps only the (B, D, N)
state; it is the plain twin of the K3a kernel. The JAX package's
associative form is not ported: at the main-path shape it materialises
(B, T, D, N) tensors of 5 GB each. `selective_scan_auto` sends the scan
through the kernel wrappers (kernels/selective_scan.py): the forward kernel
when no input needs a gradient, the autograd function (forward with saved
states, backward kernel) otherwise.
"""

from __future__ import annotations

import torch


def selective_scan_sequential(x, delta, A, Bm, C, D):
    """x, delta (B, T, D); A (D, N); Bm, C (B, T, N); D (D,) → y (B, T, D)."""
    h = x.new_zeros((x.shape[0], x.shape[2], A.shape[1]))
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(delta[:, t, :, None] * A) * h + (delta[:, t] * x[:, t])[:, :, None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    return torch.stack(ys, dim=1) + x * D


def selective_scan_auto(x, delta, A, Bm, C, D):
    """The scan through the port's kernels (their twins for CPU tensors)."""
    from ..kernels import selective_scan as K3

    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, delta, A, Bm, C, D)):
        return K3.SelectiveScanFn.apply(x, delta, A, Bm, C, D)
    return K3.selective_scan_fwd(x, delta, A, Bm, C, D)
