"""Hungarian (linear sum assignment) for set-prediction matching.

Counterpart of speaker_diarization_tpu/ops/hungarian.py. The JAX package
solves the assignment on the device (a Jonker–Volgenant solver in lax
control flow) only because TPU runtimes lack host callbacks; the reference's
EEND-M2F matcher is scipy's `linear_sum_assignment` on the host
(eend_m2f/mask2former_matcher.py), and so is this one. The cost matrices
are sanitised on the device exactly as in JAX (non-finite entries to a
sentinel just above the finite range, then the per-matrix minimum
subtracted) and the whole batch crosses to the host in one copy: the
caller stacks every matrix of a step (all decoder levels, all batch rows)
into one call, so a training step syncs once for its matching.
"""

from __future__ import annotations

import numpy as np
import torch


def sanitize_costs(cost: torch.Tensor) -> torch.Tensor:
    """(B, N, M) → the matrices the solver sees: nan/±inf replaced by
    max + max(max − min, 1) of the finite entries (0 when there are none),
    then each matrix shifted by its finite minimum; fp32, no gradient."""
    cost = cost.detach().float()
    finite = torch.isfinite(cost)
    inf = torch.tensor(float("inf"), device=cost.device)
    fmax = torch.where(finite, cost, -inf).amax(dim=(1, 2), keepdim=True)
    fmin = torch.where(finite, cost, inf).amin(dim=(1, 2), keepdim=True)
    fmax = torch.where(torch.isfinite(fmax), fmax, torch.zeros_like(fmax))
    fmin = torch.where(torch.isfinite(fmin), fmin, torch.zeros_like(fmin))
    sentinel = fmax + torch.clamp_min(fmax - fmin, 1.0)
    return torch.where(finite, cost, sentinel) - fmin


def hungarian_assign(cost: torch.Tensor) -> torch.Tensor:
    """Batched exact assignment: cost (B, N, M), N ≤ M → (B, N) int64 column
    per row, on the cost's device; one device→host copy for the batch."""
    from scipy.optimize import linear_sum_assignment

    B, N, M = cost.shape
    if N > M:
        raise ValueError(f"hungarian_assign expects N <= M, got {(N, M)}")
    host = sanitize_costs(cost).cpu().numpy()
    out = np.zeros((B, N), np.int64)
    for b in range(B):
        r, c = linear_sum_assignment(host[b])
        out[b, r] = c
    return torch.from_numpy(out).to(cost.device)


def dice_loss(pred_logits: torch.Tensor, targets: torch.Tensor, eps: float = 1.0) -> torch.Tensor:
    """Soft dice on sigmoid(mask logits): (..., T) → (...)."""
    p = torch.sigmoid(pred_logits)
    num = 2 * (p * targets).sum(-1)
    den = p.sum(-1) + targets.sum(-1)
    return 1.0 - (num + eps) / (den + eps)
