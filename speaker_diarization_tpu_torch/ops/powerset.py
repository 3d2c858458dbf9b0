"""Powerset multi-class encoding of multilabel speaker activity.

Counterpart of speaker_diarization_tpu/ops/powerset.py, used by the SOND
family (2517 classes over ≤ 16 speakers, at most 4 at once). Classes are all
speaker subsets of size ≤ max_set_size, ordered by (set size,
lexicographic): [∅, {0}, …, {K-1}, {0,1}, {0,2}, …]. The table is a NumPy
copy of the JAX package's; the rest is PyTorch.
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional

import numpy as np
import torch

from ..parallel.collectives import batch_mean

from . import losses as L


@functools.lru_cache(maxsize=32)
def powerset_mapping(n_speakers: int, max_set_size: int = 2) -> np.ndarray:
    """(n_classes, n_speakers) binary matrix: class → active speakers."""
    rows = []
    for size in range(max_set_size + 1):
        for combo in itertools.combinations(range(n_speakers), size):
            row = np.zeros(n_speakers, np.float32)
            row[list(combo)] = 1.0
            rows.append(row)
    return np.stack(rows)


def n_powerset_classes(n_speakers: int, max_set_size: int = 2) -> int:
    return powerset_mapping(n_speakers, max_set_size).shape[0]


def _mapping(n_speakers: int, max_set_size: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(powerset_mapping(n_speakers, max_set_size)).to(like.device)


def multilabel_to_powerset(labels: torch.Tensor, n_speakers: int, max_set_size: int = 2) -> torch.Tensor:
    """(…, n_speakers) {0,1} → (…,) class indices: the class that maximises
    matched actives minus mismatches, so the nearest class when more
    speakers are active than the set size allows. Ties go to the first
    index, as with jnp.argmax."""
    A = _mapping(n_speakers, max_set_size, labels)  # (C, K)
    score = (labels.float() * 2.0 - 1.0) @ A.T - A.sum(-1) * 0.5
    return torch.argmax(score, dim=-1)


def powerset_to_multilabel(idx: torch.Tensor, n_speakers: int, max_set_size: int = 2) -> torch.Tensor:
    return _mapping(n_speakers, max_set_size, idx)[idx]


def powerset_pit_ce(
    logits: torch.Tensor,  # (B, T, n_classes)
    labels: torch.Tensor,  # (B, T, n_speakers) multilabel
    n_speakers: int,
    max_set_size: int = 2,
    frame_mask: Optional[torch.Tensor] = None,
    label_smoothing: float = 0.0,
    permutation_invariant: bool = True,
):
    """Powerset cross-entropy → (loss, class targets).

    With `permutation_invariant` the best speaker permutation is found on
    the multilabel marginals (the class probabilities folded back through
    the mapping), and the CE is taken against the permuted class targets.

    `permutation_invariant=False` takes the labels in the given channel
    order. Profile-conditioned models (SOND) need it: channel i is scored
    against profile i, as the reference's LabelSmoothingLoss does, and
    inference relies on that binding. Trained with PIT, SOND fits a permuted
    solution and the profile binding never forms.
    """
    if not permutation_invariant:
        target_idx = multilabel_to_powerset(labels, n_speakers, max_set_size)
        return _powerset_ce(logits, target_idx, frame_mask, label_smoothing), target_idx
    A = _mapping(n_speakers, max_set_size, logits)
    marginals = torch.softmax(logits, dim=-1) @ A  # (B, T, K) speaker probabilities
    eps = 1e-6
    marg_logits = torch.log(torch.clamp(marginals, eps, 1 - eps)) - torch.log(torch.clamp(1 - marginals, eps, 1 - eps))
    _, labels_perm, _ = L.pit_loss(marg_logits, labels, frame_mask)
    target_idx = multilabel_to_powerset(labels_perm, n_speakers, max_set_size)
    return _powerset_ce(logits, target_idx, frame_mask, label_smoothing), target_idx


def _powerset_ce(logits, target_idx, frame_mask=None, label_smoothing: float = 0.0):
    n_classes = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(target_idx, n_classes).to(logp.dtype)
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / n_classes
    ce = -(onehot * logp).sum(-1)  # (B, T)
    if frame_mask is not None:
        return batch_mean((ce * frame_mask).sum(), frame_mask.sum())
    return ce.mean()
