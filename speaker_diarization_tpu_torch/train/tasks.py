"""Task losses plugged into the port's Trainer.

Counterpart of speaker_diarization_tpu/train/tasks.py; the TS-VAD objective
so far (`make_tsvad_loss`, tasks.py:241-271). The other families' losses
come with their models.
"""

from __future__ import annotations

from ..ops import losses as L
from ..ops import metrics as M


def make_tsvad_loss(n_label_frames: int, freeze_encoder: bool = False):
    """loss_fn(model, batch, generator, train) for TSVADModel: per-speaker
    BCE; aux carries the frame DER. `model.train()`/`eval()` is set by the
    Trainer; `freeze_encoder` keeps CAM++ on its running statistics with no
    gradient during training (reference freeze_speech_encoder_updates)."""

    def loss_fn(model, batch, generator, train):
        logits = model(batch["audio"], batch["target_embs"], n_label_frames,
                       freeze_encoder=freeze_encoder and train, generator=generator)
        loss = L.standard_bce(logits, batch["labels"])
        stats = M.diarization_error_stats(logits, batch["labels"])
        return loss, {"frame_der": M.der_from_stats(stats)}

    return loss_fn
