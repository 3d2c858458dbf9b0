"""Frame-level diarization error statistics (training-time reporting).

Counterpart of speaker_diarization_tpu/ops/metrics.py (reference
`calc_diarization_error`, eend/loss.py:70-103 and ts_vad2/model.py:973-1048):
one call over (B, T, C) tensors with an optional frame mask.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def diarization_error_stats(
    logits: torch.Tensor,
    labels: torch.Tensor,
    frame_mask: Optional[torch.Tensor] = None,
    threshold: float = 0.5,
) -> Dict[str, torch.Tensor]:
    """Scalar counts from pre-activations: speech_scored/miss/falarm,
    speaker_scored/miss/falarm/error, correct, frames, diarization_error."""
    decisions = (torch.sigmoid(logits) > threshold).long()
    labels = labels.long()
    fm = torch.ones(logits.shape[:2], dtype=torch.long, device=logits.device) if frame_mask is None else frame_mask.long()
    decisions = decisions * fm[..., None]
    labels = labels * fm[..., None]

    n_ref = labels.sum(-1)  # (B, T)
    n_sys = decisions.sum(-1)
    res = {}
    res["speech_scored"] = ((n_ref > 0) & (fm > 0)).sum()
    res["speech_miss"] = ((n_ref > 0) & (n_sys == 0)).sum()
    res["speech_falarm"] = ((n_ref == 0) & (n_sys > 0) & (fm > 0)).sum()
    res["speaker_scored"] = n_ref.sum()
    res["speaker_miss"] = torch.clamp_min(n_ref - n_sys, 0).sum()
    res["speaker_falarm"] = torch.clamp_min(n_sys - n_ref, 0).sum()
    n_map = ((labels == 1) & (decisions == 1)).sum(-1)
    res["speaker_error"] = (torch.minimum(n_ref, n_sys) - n_map).sum()
    res["correct"] = ((labels == decisions).all(-1).long() * fm).sum()
    res["frames"] = fm.sum()
    res["diarization_error"] = res["speaker_miss"] + res["speaker_falarm"] + res["speaker_error"]
    return res


def der_from_stats(stats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Frame-level DER = (miss + falarm + confusion) / scored speaker-frames."""
    return stats["diarization_error"] / torch.clamp_min(stats["speaker_scored"], 1)
