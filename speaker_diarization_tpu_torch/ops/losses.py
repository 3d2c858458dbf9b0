"""Training losses of the ported families.

Counterpart of speaker_diarization_tpu/ops/losses.py (`bce_with_logits`,
`standard_bce`, the TS-VAD objective; reference ts_vad2/model.py:1050).
The permutation-invariant losses of the EEND family wait for ROADMAP item 8.
"""

from __future__ import annotations

from typing import Optional

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on pre-activations (stable form)."""
    return torch.clamp_min(logits, 0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


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
    return (e * m).sum() / torch.clamp_min(m.sum(), 1.0)
