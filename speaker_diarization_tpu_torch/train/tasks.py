"""Task losses plugged into the port's Trainer.

Counterpart of speaker_diarization_tpu/train/tasks.py: EEND PIT-BCE
(`make_eend_loss`, tasks.py:20-37), EEND-EDA PIT + attractor existence
(`make_eda_loss`, tasks.py:40-77), TS-VAD per-speaker BCE
(`make_tsvad_loss`, tasks.py:241-271), streaming TS-VAD's BCE on the
chunk-masked forward (`make_streaming_tsvad_loss`, tasks.py:335-357), the
speaker encoder's AAM-softmax cross-entropy (`make_spk_loss`,
tasks.py:430-456), TS-VAD3's BCE from enrollment waveforms
(`make_tsvad3_loss`, tasks.py:274-297), SOND's powerset CE from raw audio
(`make_sond_loss_from_audio`, tasks.py:400-427), EEND-VC's PIT plus
speaker-table loss (`make_eend_vc_loss`, tasks.py:106-143) and SSND's focal
BCE plus ArcFace CE with its query construction (`make_ssnd_loss`,
tasks.py:148-238), and EEND-M2F's Hungarian-matched set criterion
(`make_m2f_loss`, tasks.py:382-397) and FS-EEND's PIT over its silence,
speaker and pad channels plus the consistency MSE (`make_fs_eend_loss`,
tasks.py:80-103) and OTS-VAD's BCE on the right half of a chunk after
self-enrolling on the left (`make_ots_vad_loss`, tasks.py:301-332), and the
neural VAD's masked BCE on the union of speakers (`make_vad_loss`,
tasks.py:360-379). The other families' losses come with their models (the
enhancer's negative SI-SNR: models/enhancer.make_enhance_loss).
"""

from __future__ import annotations

import torch

from ..parallel.collectives import batch_mean

from ..ops import features as F
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


def make_streaming_tsvad_loss(n_label_frames: int):
    """loss_fn for StreamingTSVADModel: per-speaker BCE on the chunk-masked
    offline forward (reference ts_vad2_streaming training with a static
    chunk mask); aux carries the frame DER. The model has no BatchNorm."""

    def loss_fn(model, batch, generator, train):
        logits = model(batch["audio"], batch["target_embs"], n_label_frames, generator=generator)
        loss = L.standard_bce(logits, batch["labels"])
        stats = M.diarization_error_stats(logits, batch["labels"])
        return loss, {"frame_der": M.der_from_stats(stats)}

    return loss_fn


def make_eend_loss():
    """loss_fn for EENDModel: PIT-BCE with frame and speaker masks; aux
    carries the frame DER under the best permutation."""

    def loss_fn(model, batch, generator, train):
        fm = batch["frame_mask"]
        logits = model(batch["audio"], fm, generator=generator)
        loss, labels_perm, _ = L.pit_loss(logits, batch["labels"], fm, batch.get("spk_mask"))
        stats = M.diarization_error_stats(logits, labels_perm, fm)
        return loss, {"frame_der": M.der_from_stats(stats)}

    return loss_fn


def make_eda_loss(attractor_weight: float = 1.0, shuffle_frames: bool = True):
    """loss_fn for EendEdaModel: PIT-BCE + attractor existence BCE
    (reference eend_eda/models.py:654-692 and 694). In training the EDA
    encoder reads the frames in a random order per sample, valid frames
    first (reference models.py:531-536): the argsort of uniform noise minus
    the frame mask, the noise drawn from the Trainer's generator."""

    def loss_fn(model, batch, generator, train):
        fm = batch["frame_mask"]
        order = None
        if train and shuffle_frames:
            noise = torch.rand(fm.shape, generator=generator, device=fm.device) - fm
            order = torch.argsort(noise, dim=-1)
        logits, exist_logits = model(batch["audio"], fm, order, generator=generator)
        pit, labels_perm, _ = L.pit_loss(logits, batch["labels"], fm, batch.get("spk_mask"))
        att = L.attractor_existence_loss(exist_logits, batch["spk_mask"])
        stats = M.diarization_error_stats(logits, labels_perm, fm)
        return pit + attractor_weight * att, {
            "pit_loss": pit.detach(), "attractor_loss": att.detach(), "frame_der": M.der_from_stats(stats),
        }

    return loss_fn


def make_spk_loss(sample_rate: int = 16000):
    """loss_fn for SpeakerClassifier: kaldi fbank on the device (the K1
    kernel for a CUDA batch) → AAM-softmax cross-entropy; the margin applies
    in training only, as in JAX. Aux carries the top-1 accuracy."""

    def loss_fn(model, batch, generator, train):
        fbank = F.kaldi_fbank_auto(batch["audio"], sample_rate=sample_rate, num_mel_bins=model.cfg.feat_dim,
                                   mean_norm=True)
        labels = batch["label"].long()
        logits = model(fbank, labels if train else None)
        loss = -torch.log_softmax(logits, dim=-1).gather(-1, labels[:, None]).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"acc": acc.detach()}

    return loss_fn


def make_tsvad3_loss(n_label_frames: int, freeze_speech_encoder: bool = False):
    """loss_fn for TSVAD3Model: the enrollment waveforms (batch
    'enroll_audio' (B, S, Nts), else 'target_embs') are embedded by the
    model's speaker encoder; per-speaker BCE as TS-VAD."""

    def loss_fn(model, batch, generator, train):
        targets = batch["enroll_audio"] if "enroll_audio" in batch else batch["target_embs"]
        logits = model(batch["audio"], targets, n_label_frames,
                       freeze_speech_encoder=freeze_speech_encoder and train, generator=generator)
        loss = L.standard_bce(logits, batch["labels"])
        stats = M.diarization_error_stats(logits, batch["labels"])
        return loss, {"frame_der": M.der_from_stats(stats)}

    return loss_fn


def make_sond_loss_from_audio(sample_rate: int = 16000):
    """loss_fn for SONDModel over TS-VAD chunk batches: the 100 Hz kaldi
    fbank from the raw audio on the device (K1 for a CUDA batch), the
    target-speaker embeddings as the profile inventory, and the 25 Hz labels
    taken every other frame to the model's 12.5 Hz (ResNet34's ×8). The
    fbank is padded or cropped to 8·T_labels, so the ×8 encoder (ceil
    rounding) gives exactly one frame per label."""
    from ..models.sond import sond_loss

    def loss_fn(model, batch, generator, train):
        fbank = F.kaldi_fbank_auto(batch["audio"], sample_rate=sample_rate, num_mel_bins=model.cfg.feat_dim,
                                   mean_norm=True)
        labels = batch["labels"][:, ::2]  # 25 Hz → 12.5 Hz
        t_fb = 8 * labels.shape[1]
        if fbank.shape[1] < t_fb:
            fbank = torch.nn.functional.pad(fbank, (0, 0, 0, t_fb - fbank.shape[1]))
        return sond_loss(model, fbank[:, :t_fb], batch["target_embs"], labels, generator)

    return loss_fn


def make_eend_vc_loss(spk_loss_weight: float = 0.03):
    """loss_fn for EENDVCModel: (1 − w)·PIT-BCE + w·speaker CE (reference
    models_vector_cluster.py:24-72 and 159-192; train_vector_cluster.py:
    222-235, w = spk_loss_ratio 0.03). Each channel that carries speech is
    classified against the global speaker table by its id under the best
    permutation; channels without speech or with id −1 are left out."""

    def loss_fn(model, batch, generator, train):
        fm = batch["frame_mask"]
        logits, vecs = model(batch["audio"], fm, generator)
        pit, labels_perm, best_perm = L.pit_loss(logits, batch["labels"], fm, batch.get("spk_mask"))
        gids = torch.gather(batch["spk_ids"].long(), -1, best_perm.long())  # (B, S)
        valid = ((labels_perm.sum(1) > 0) & (gids >= 0)).float()
        logp = torch.log_softmax(model.spk_distance_logits(vecs), dim=-1)
        picked = logp.gather(-1, torch.clamp_min(gids, 0)[..., None])[..., 0]
        spk = batch_mean(-(picked * valid).sum(), valid.sum())
        stats = M.diarization_error_stats(logits, labels_perm, fm)
        total = (1.0 - spk_loss_weight) * pit + spk_loss_weight * spk
        return total, {"pit_loss": pit.detach(), "spk_loss": spk.detach(), "frame_der": M.der_from_stats(stats)}

    return loss_fn


def make_ssnd_loss(arcface_weight: float = 0.01, bce_alpha: float = 0.75, bce_gamma: float = 2.0,
                   mask_prob: float = 0.5):
    """loss_fn for SSNDModel (reference ssnd_model.py:445-520): focal BCE
    on the slots' VAD and ArcFace CE of their embeddings (models/ssnd.
    ssnd_loss). Batch: audio (B, N), labels (B, S, T), spk_gids (B, S) (−1 =
    empty slot), and optionally aux_embs (B, S, emb_dim), the slot queries.

    Without aux_embs the queries follow the reference's training protocol
    (ssnd_model.py:592-633), drawn from `generator`: a present slot gets
    its E_all row; an empty slot gets e_non or, with probability 1/2, a
    random distractor row, both with zero labels; in training, with
    probability `mask_prob` one present slot of a sample has its query
    replaced by the pseudo speaker e_pse, its labels kept, which teaches the
    pseudo slot to detect a speaker not enrolled. The representation
    decoder is teacher-forced with the labels in training and evaluation."""
    from ..models.ssnd import ssnd_loss

    def loss_fn(model, batch, generator, train):
        gids = batch["spk_gids"].long()
        if "aux_embs" in batch:
            aux = batch["aux_embs"]
        else:
            B, S = gids.shape
            dev = gids.device
            E_all = model.E_all  # the queries carry E_all's gradient, as in JAX
            present = gids >= 0
            rand_gid = torch.randint(0, E_all.shape[0], (B, S), generator=generator, device=dev)
            use_non = torch.rand((B, S), generator=generator, device=dev) < 0.5
            aux_empty = torch.where(use_non[..., None], model.e_non[0], E_all[rand_gid])
            aux = torch.where(present[..., None], E_all[torch.clamp_min(gids, 0)], aux_empty)
            if train:
                midx = torch.randint(0, S, (B,), generator=generator, device=dev)
                rows = torch.arange(B, device=dev)
                do_mask = (torch.rand((B,), generator=generator, device=dev) < mask_prob) & present[rows, midx]
                aux = aux.clone()
                aux[rows, midx] = torch.where(do_mask[:, None], model.e_pse[0], aux[rows, midx])
        return ssnd_loss(model, batch["audio"], aux, batch["labels"], gids, generator, arcface_weight,
                         bce_alpha, bce_gamma)

    return loss_fn


def make_m2f_loss():
    """loss_fn for EENDM2FModel over EEND chunk batches (at subsampling 1):
    the Hungarian-matched set criterion (reference eend_m2f/criterion.py:176)
    on per-speaker targets (B, S, T) from the (B, T, S) frame labels."""
    from ..models.eend_m2f import m2f_criterion

    def loss_fn(model, batch, generator, train):
        out = model(batch["audio"], generator=generator)
        return m2f_criterion(out, batch["labels"].transpose(1, 2), model.cfg, frame_mask=batch.get("frame_mask"))

    return loss_fn


def make_fs_eend_loss(consistency_weight: float = 1.0):
    """loss_fn for FSEENDModel (reference fs_eend/model.py:55-99): PIT-BCE
    over the [silence ‖ speakers by first appearance ‖ pad] channels plus
    the embedding-consistency MSE; aux carries both and the frame DER."""
    from ..models.fs_eend import consistency_loss, fs_eend_labels

    def loss_fn(model, batch, generator, train):
        fm = batch["frame_mask"]
        logits, emb = model(batch["audio"], fm, generator)
        ch = fs_eend_labels(batch["labels"], fm)
        pit, labels_perm, _ = L.pit_loss(logits, ch, fm)
        cons = consistency_loss(emb, ch, fm)
        stats = M.diarization_error_stats(logits, labels_perm, fm)
        return pit + consistency_weight * cons, {
            "pit_loss": pit.detach(), "consistency_loss": cons.detach(), "frame_der": M.der_from_stats(stats),
        }

    return loss_fn


def make_ots_vad_loss():
    """loss_fn for OTSVADModel over TS-VAD chunk batches of 2·rs_len: the
    chunk splits into a left and a right half; the model self-enrolls on the
    left half with its true labels and predicts the right (reference
    ots_vad training: no enrollment embeddings). The 25 Hz labels are taken
    every other frame to the model's 12.5 Hz; per-speaker BCE; aux carries
    the frame DER."""

    def loss_fn(model, batch, generator, train):
        audio = batch["audio"]
        labels = batch["labels"][:, ::2].transpose(1, 2)  # (B, S, T12)
        n, t = audio.shape[1] // 2, labels.shape[-1] // 2
        logits = model(audio[:, :n], audio[:, n:], labels[..., :t], generator)
        y_right = labels[..., t : 2 * t]
        T = min(logits.shape[-1], y_right.shape[-1])
        logits, y_right = logits[..., :T], y_right[..., :T]
        stats = M.diarization_error_stats(logits.transpose(1, 2), y_right.transpose(1, 2))
        return L.standard_bce(logits, y_right), {"frame_der": M.der_from_stats(stats)}

    return loss_fn


def make_vad_loss():
    """loss_fn for NeuralVAD (system SAD) over EEND chunk batches at
    subsampling 1 (one label per frame_shift hop): frame BCE with logits on
    the union of the speakers' activities, masked by `frame_mask`; aux
    carries the masked frame accuracy `vad_acc`. The model has no dropout."""

    def loss_fn(model, batch, generator, train):
        logits = model(batch["audio"])  # (B, T_frames)
        speech = (batch["labels"].amax(dim=-1) > 0).float()  # (B, T_lab)
        T = min(logits.shape[1], speech.shape[1])
        logits, speech = logits[:, :T], speech[:, :T]
        mask = batch["frame_mask"][:, :T].float()
        denom = torch.clamp_min(mask.sum(), 1.0)
        bce = torch.nn.functional.binary_cross_entropy_with_logits(logits, speech, reduction="none")
        acc = (((logits > 0) == (speech > 0.5)).float() * mask).sum() / denom
        return batch_mean((bce * mask).sum(), mask.sum()), {"vad_acc": acc.detach()}

    return loss_fn
