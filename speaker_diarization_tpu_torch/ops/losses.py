"""Training losses of the ported families.

Counterpart of speaker_diarization_tpu/ops/losses.py: `bce_with_logits`,
`standard_bce` (TS-VAD, reference ts_vad2/model.py:1050), `l2_normalize`
(speaker embeddings, gradient-safe at zero rows), and the EEND
family's permutation-invariant BCE (`pit_loss` over a table of all C!
permutations, reference eend/loss.py:20-67) and EDA attractor existence
loss (reference eend_eda/models.py:654-692).

The masked means divide by counts over the whole batch through
`parallel.collectives.batch_mean`, which sums the count over the data group
inside a data-parallel step, so the step's loss is the global batch's.
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional

import numpy as np
import torch

from ..parallel.collectives import batch_mean


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on pre-activations (stable form)."""
    return torch.clamp_min(logits, 0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """Gradient-safe L2 normalization: x · rsqrt(sum(x²) + eps²).

    `x / max(norm(x), eps)` has a NaN gradient at exactly-zero rows (the
    norm's derivative at 0 is 0/0); this form is finite everywhere, and
    zero rows do occur (zero-vector silence speakers in TS-VAD enrollment).
    """
    return x * torch.rsqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps * eps)


def standard_bce(
    logits: torch.Tensor,
    labels: torch.Tensor,
    frame_mask: Optional[torch.Tensor] = None,
    spk_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked mean BCE without permutation (TS-VAD): (B, T, C) → scalar."""
    e = bce_with_logits(logits, labels)
    m = torch.ones_like(e)
    if frame_mask is not None:
        m = m * frame_mask[..., None]
    if spk_mask is not None:
        m = m * spk_mask[..., None, :]
    return batch_mean((e * m).sum(), m.sum())


@functools.lru_cache(maxsize=16)
def permutation_table(n: int) -> np.ndarray:
    """(n!, n) int32 table of all permutations of range(n)."""
    return np.array(list(itertools.permutations(range(n))), dtype=np.int32)


def pairwise_bce_cost(logits: torch.Tensor, labels: torch.Tensor, frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, C) logits and labels → (B, C, C) cost; cost[b, i, j] = sum over
    valid frames of BCE(logits[b, :, i], labels[b, :, j])."""
    e = bce_with_logits(logits[..., :, None], labels[..., None, :])
    if frame_mask is not None:
        e = e * frame_mask[..., None, None]
    return e.sum(-3)


def pit_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    frame_mask: Optional[torch.Tensor] = None,
    spk_mask: Optional[torch.Tensor] = None,
):
    """Batched permutation-invariant BCE → (loss, labels_perm, best_perm).

    loss: the minimum-permutation BCE summed over the batch, over C and over
    the valid frame count; labels_perm (B, T, C) = labels[b, t, best_perm[b, i]].
    With spk_mask (B, C), a sample with n < C speakers considers only
    permutations that map its first n channels onto its n real labels.
    """
    B, T, C = logits.shape
    cost = pairwise_bce_cost(logits, labels, frame_mask)  # (B, C, C)
    perms = torch.from_numpy(permutation_table(C)).long().to(logits.device)  # (P, C)
    perm_cost = cost[:, torch.arange(C, device=logits.device)[None, :], perms].sum(-1)  # (B, P)
    if spk_mask is not None:
        n = spk_mask.sum(-1, keepdim=True)  # (B, 1)
        maps_real = perms[None] < n[..., None]  # (B, P, C)
        is_real = torch.arange(C, device=logits.device)[None, None, :] < n[..., None]
        valid = (maps_real == is_real).all(-1)
        perm_cost = torch.where(valid, perm_cost, torch.full_like(perm_cost, float("inf")))
    best = perm_cost.argmin(-1)  # the first minimum, as jnp.argmin
    min_cost = perm_cost.gather(1, best[:, None])[:, 0]
    best_perm = perms[best]  # (B, C)
    labels_perm = torch.gather(labels, 2, best_perm[:, None, :].expand(B, T, C))
    n_frames = frame_mask.sum() if frame_mask is not None else torch.tensor(float(B * T), device=logits.device)
    loss = batch_mean((min_cost / C).sum(), n_frames)
    return loss, labels_perm, best_perm.int()


def attractor_existence_loss(exist_logits: torch.Tensor, spk_mask: torch.Tensor) -> torch.Tensor:
    """EEND-EDA existence BCE: exist_logits (B, C+1), spk_mask (B, C). The
    target of sample b is n_b ones and then a zero; later positions are
    left out of the loss."""
    C1 = exist_logits.shape[1]
    n = spk_mask.sum(-1, keepdim=True)
    pos = torch.arange(C1, device=exist_logits.device)[None, :]
    target = (pos < n).to(exist_logits.dtype)
    valid = (pos <= n).to(exist_logits.dtype)
    e = bce_with_logits(exist_logits, target) * valid
    return batch_mean(e.sum(), valid.sum())
