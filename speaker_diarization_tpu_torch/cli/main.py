"""Command-line interface of the PyTorch port: corpora, training, inference, scoring.

    python -m speaker_diarization_tpu_torch.cli simulate --out DIR \
        [--source-dir D --noise-dir N --rir-dir R] [--n-mixtures 10] [--n-speakers 2] \
        [--sil-scale 2] [--rate 8000] [--seed 777] [--with-rir --rir-method decay|image_source]
    python -m speaker_diarization_tpu_torch.cli simulate-meetings --out DIR --source-dir D \
        [--noise-dir N] [--rir-dir R] [--dynamics meeting.json] [--rate 8000] [--seed 7]
    python -m speaker_diarization_tpu_torch.cli config-dump [--config train.json] \
        [--set key=value ...] [--format yaml|json|bash]
    python -m speaker_diarization_tpu_torch.cli train --family spk --train-dir D \
        [--valid-dir V] [--noise-dir N] --exp-dir X [--resume] [--set key=value ...] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli export-encoder --exp-dir X [--step S] --out enc.npz \
        [--config train.json] [--set key=value ...]
    python -m speaker_diarization_tpu_torch.cli prepare-targets --rttm R --data-dir D --out DIR \
        [--label-rate 25] [--min-target-s 0]
    python -m speaker_diarization_tpu_torch.cli extract-embeddings --data-dir DIR --out E.npz \
        [--encoder-ckpt enc.npz|wespeaker.pt] [--rate 16000] [--window 6] [--hop 1] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli train --family eend|eend_eda \\
        --train-dir D[,D2] [--valid-dir V] --exp-dir X [--resume] \\
        [--set key=value ...] [--config train.json] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli train --family tsvad \\
        --train-dir D[,D2] --valid-dir V --emb-store E.npz[,E2.npz] --exp-dir X \\
        [--noise-dir N] [--rir-dir R] [--encoder-ckpt enc.npz] [--resume] \\
        [--set key=value ...] [--config train.json] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli train --family tsvad_streaming|sond \\
        --train-dir D[,D2] --valid-dir V --emb-store E.npz[,E2.npz] --exp-dir X \\
        [--noise-dir N] [--rir-dir R] [--resume] [--set key=value ...] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli train --family tsvad3 \\
        --train-dir D[,D2] --target-audio-dir T[,T2] [--valid-dir V --valid-target-audio-dir TV] \\
        --exp-dir X [--encoder-ckpt enc.npz] [--noise-dir N] [--rir-dir R] [--resume] \\
        [--set key=value ...] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli train --family eend_vc|eend_m2f|fs_eend \\
        --train-dir D[,D2] [--valid-dir V] --exp-dir X [--resume] [--set key=value ...] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli train --family ssnd --train-dir SRC \\
        [--real-data-dir D] [--noise-dir N] --exp-dir X [--resume] [--set key=value ...] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli train --family ots_vad --train-dir D[,D2] \\
        [--valid-dir V] [--noise-dir N] [--rir-dir R] --exp-dir X [--resume] [--set key=value ...] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli infer [--family eend|eend_eda] \\
        --data-dir DIR --exp-dir X [--step S] [--avg-last K] --out hyp.rttm \\
        [--set key=value ...] [--attractor-threshold 0.5] \\
        [--threshold-sweep --ref ref.rttm [--cder]] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli infer --family tsvad|tsvad_streaming \\
        --data-dir DIR --emb-store EMB.npz (--exp-dir X [--step S] [--avg-last K] \\
        | --params PARAMS.npz [--config tsvad.json]) --out hyp.rttm \\
        [--set key=value ...] [--rs-len 4] [--threshold-sweep --ref ref.rttm [--cder]] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli infer --family sond|tsvad3|eend_vc \\
        --data-dir DIR --exp-dir X (sond: --emb-store EMB.npz | tsvad3: --target-audio-dir T \\
        | eend_vc: [--num-spks -1|0|k] [--sil-spk-th 0.05]) --out hyp.rttm [...as above]
    python -m speaker_diarization_tpu_torch.cli infer --family ssnd|eend_m2f|fs_eend|ots_vad \\
        --data-dir DIR --exp-dir X --out hyp.rttm (ssnd: [--ssnd-rescore] | eend_m2f: \\
        [--class-threshold 0.5] [--m2f-max-concurrent K]) [...as above]
    python -m speaker_diarization_tpu_torch.cli train --family vad --train-dir D[,D2] [--valid-dir V] \\
        --exp-dir X [--resume] [--set key=value ...] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli train --family enhance --train-dir SRC --noise-dir N \\
        --exp-dir X [--resume] [--set key=value ...] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli export-vad --exp-dir X [--step S] --out vad.npz
    python -m speaker_diarization_tpu_torch.cli export-enhancer --exp-dir X [--step S] --out enh.npz
    python -m speaker_diarization_tpu_torch.cli estimate-plda --data-dir D --out plda.npz \\
        [--encoder campplus|spectrum] [--encoder-ckpt enc.npz] [--rate 16000] [--plda-dim K] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli cluster --data-dir D --out hyp.rttm \\
        [--method spectral|umap|vbx [--plda plda.npz]] [--sad energy|oracle|neural [--vad-ckpt vad.npz]] \\
        [--encoder campplus|spectrum] [--encoder-ckpt enc.npz] [--rate 16000] [--ref ref.rttm] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli score --ref ref.rttm --sys hyp.rttm [--cder]

Ported families: eend, eend_eda (transformer or conformer encoder, `--set
encoder_type=…`), tsvad (every speech encoder of the JAX TSVADConfig
through `--set speech_encoder_type=…`: campplus, ecapa, resnet34,
simam_resnet34, wavlm, wavlm_weight_sum, hubert, wav2vec2, mms, w2vbert,
whisper, eres2netv2 and redimnet_b0…b6, the last with `--set n_mels=60`
for b0 and 72 for b1-b6; transformer, conformer,
mamba, mamba_add, mamba2 and mamba2_add backends, and lstm for the multi
backend, through `--set single_backend_type=… --set
multi_backend_type=…`), tsvad_streaming
(its own conv front-end, chunk-masked training, chunk-by-chunk decode of
each window), tsvad3 (enrollment waveforms from prepare-targets'
target_audio tree instead of stored embeddings), sond (powerset classes
over profiles from the embedding store), eend_vc (chunk vectors clustered
by constrained AHC; `--num-spks` -1 takes each recording's speaker count
from --ref or the data dir's rttm, 0 cuts the dendrogram at a distance, k
fixes the count), ssnd (query decoders over speaker slots, trained on
meetings mixed on the fly from a single-speaker --train-dir and, with
--real-data-dir, blocks of real meetings; decoded online with a speaker
memory, `--ssnd-rescore` for the two-pass offline rescoring), eend_m2f
(Mask2Former set prediction, the front-end forced to subsampling 1 and
context 0; Hungarian matching on the host), fs_eend (frame-streaming EEND
with a causal attractor decoder), ots_vad (enrollment-free online TS-VAD,
trained on 2·rs_len chunks, slots named spk1…spkS), spk (speaker-encoder pretraining, exported by
`export-encoder` in the JAX package's npz format for `extract-embeddings`
and `train --family tsvad --encoder-ckpt`), vad (the neural system SAD,
trained on EEND chunks at subsampling 1, exported by `export-vad` for
`cluster --sad neural`) and enhance (the learned denoiser, trained on
(clean, clean + noise) pairs, exported by `export-enhancer` for `--set
enhancer=neural:<npz>`, which the TS-VAD datasets apply per chunk).
`cluster` diarizes by clustering subsegment embeddings (spectral, UMAP +
HDBSCAN*, or spectral then VBx with an `estimate-plda` PLDA). Flag names, `--set` keys and defaults follow the JAX
package's CLI (`TrainCliConfig`, cli/main.py:33-110; the family defaults to
eend in both). `--set remat=true` recomputes activations in the backward
pass where JAX rematerialises. `train` writes torch checkpoints
and its config (train_config.json) into --exp-dir, and for tsvad the last
weights as one flax-layout npz (flax_params.npz) beside the TSVADConfig
they fit (tsvad_config.json); `infer --exp-dir`
rebuilds the model from that config (its family unless --family is given,
then --set) and restores the best checkpoint by validation loss, else the
latest. `--params` takes the JAX TSVADModel variables as one flax-layout
.npz (utils/convert.py); reading the JAX trainer's Orbax directories waits
for ROADMAP item 1, [6].
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

BATCH_SIZE = 16  # windows per forward (tsvad_infer_dataset's default)
TRAIN_CONFIG = "train_config.json"  # written by `train` into --exp-dir
# and, for tsvad, the last weights as flax-layout variables and the TSVADConfig they fit
FLAX_PARAMS, FLAX_CONFIG = "flax_params.npz", "tsvad_config.json"
FAMILIES = ("eend", "eend_eda", "eend_vc", "tsvad", "tsvad_streaming", "tsvad3", "sond", "ssnd", "eend_m2f",
            "fs_eend", "ots_vad", "spk", "vad", "enhance")
EXPORTED = {"spk": "export-encoder", "vad": "export-vad", "enhance": "export-enhancer"}  # not inferred: exported
INFER_FAMILIES = tuple(f for f in FAMILIES if f not in EXPORTED)
TSVAD_FAMILIES = ("tsvad", "tsvad_streaming", "tsvad3", "sond", "ots_vad")  # windows of TS-VAD chunks

_PARAMS_HELP = (
    "flax-layout TSVADModel variables as one .npz ('params/...' and 'batch_stats/...' keys, "
    "utils/convert.save_flax_npz). Orbax checkpoint directories of the JAX trainer are not "
    "read yet (ROADMAP item 1, [6])."
)


@dataclasses.dataclass
class TrainCliConfig:
    """The fields of the JAX CLI's TrainCliConfig, same names, defaults and
    order."""

    family: str = "eend"  # one of FAMILIES
    # model
    n_speakers: int = 2  # tsvad, tsvad3, sond, ssnd, ots_vad: > 2 sets the speaker slots, else 4
    max_attractors: int = 15  # eend_eda: attractors decoded at inference
    d_model: int = 256  # EEND width; noam's d_model
    n_layers: int = 4  # EEND encoder layers; TS-VAD layers per backend
    n_heads: int = 4
    d_ff: int = 1024
    dropout: float = 0.1
    encoder_type: str = "transformer"  # eend_eda: transformer | conformer
    bf16: bool = False
    remat: bool = False
    sample_rate: int = 8000
    # front-end (EEND family)
    frame_size: int = 200
    frame_shift: int = 80
    n_mels: int = 23  # 23 (the EEND default) means 80 for TS-VAD's CAM++ fbank
    context_size: int = 7
    subsampling: int = 10
    chunk_frames: int = 500
    # tsvad
    rs_len: float = 4.0
    segment_shift: float = 2.0
    speech_encoder_type: str = "campplus"
    single_backend_type: str = "transformer"  # transformer|conformer|mamba|mamba_add|mamba2|mamba2_add
    multi_backend_type: str = "transformer"  # + lstm
    d_state: int = 64
    expand: int = 2
    # tsvad_streaming (reference ts_vad2_streaming: static_chunk_size 64
    # @100 Hz = 16 frames @25 Hz; num_left_chunks history window)
    streaming_chunk_size: int = 16
    streaming_left_chunks: int = 4
    # ssnd (on-the-fly simulated mixtures, reference simu_diar_dataset.py)
    ssnd_overlap_prob: float = 0.3
    ssnd_sil_scale: float = 1.0
    # reference --arcface-weight (train_accelerate_ddp.py:305, default 0.01)
    ssnd_arcface_weight: float = 0.01
    # fraction of each batch drawn from --real-data-dir meeting blocks
    # (reference dual simu+real protocol, train_one_epoch_multi)
    ssnd_real_ratio: float = 0.5
    encoder_blocks: str = ""  # "12,24,16" = reference CAM++; sond's ResNet34 "3,4,6,3"
    # spk classes, eend_vc and ssnd speaker-table rows; 0 = the training corpus's speakers
    all_n_speakers: int = 0
    # spk (speaker-embedding pretraining)
    spk_dur: float = 2.0  # crop seconds per training utterance
    aam_margin: float = 0.2
    aam_scale: float = 32.0
    freeze_encoder: bool = False
    # speech-enhancement hook of the TS-VAD datasets (reference
    # ts_vad_dataset.py:423-492): '' = off, 'spectral_gate' or
    # 'neural:<npz>'; at train it fires with enhance_prob, at eval always
    enhancer: str = ""
    enhance_prob: float = 0.5
    # tsvad3 (enrollment waveforms, egs/alimeeting/ts_vad3)
    ts_len: float = 6.0  # enrollment seconds per speaker
    fuse_fbank_feat: bool = False
    fuse_speaker_embedding_feat: bool = True
    # optimization
    batch_size: int = 16
    num_steps: int = 10000
    optimizer: str = "adam"
    schedule: str = "noam"
    learning_rate: float = 1.0
    warmup_steps: int = 25000
    grad_clip_norm: float = 5.0
    grad_accum_steps: int = 1
    model_avg_decay: float = 0.0
    seed: int = 777
    # loop
    log_every: int = 50
    valid_every: int = 500
    n_data: int = 0  # data-parallel ranks of a torchrun launch; 0 = all of them


def _blocks(cfg: TrainCliConfig, default: tuple = (12, 24, 16)) -> tuple:
    """Encoder depth: the `encoder_blocks` override, else `default` (the reference CAM++ 12,24,16)."""
    return tuple(int(x) for x in cfg.encoder_blocks.split(",")) if cfg.encoder_blocks else default


def spk_config(cfg: TrainCliConfig, n_classes: int):
    """TrainCliConfig → SpkEmbedConfig, as the JAX CLI's _build_model does."""
    from ..models.spk_embed import SpkEmbedConfig

    return SpkEmbedConfig(n_classes=n_classes, encoder=cfg.speech_encoder_type, feat_dim=cfg.n_mels,
                          margin=cfg.aam_margin, scale=cfg.aam_scale, encoder_blocks=_blocks(cfg))


def tsvad_config(cfg: TrainCliConfig):
    """TrainCliConfig → TSVADConfig, as the JAX CLI's _build_model does."""
    from ..models.tsvad import TSVADConfig

    blocks = _blocks(cfg)
    return TSVADConfig(
        max_num_speaker=cfg.n_speakers if cfg.n_speakers > 2 else 4,
        feat_dim=cfg.n_mels if cfg.n_mels != 23 else 80,
        num_transformer_layer=cfg.n_layers,
        num_attention_head=cfg.n_heads,
        transformer_ffn_embed_dim=cfg.d_ff,
        dropout=cfg.dropout,
        sample_rate=cfg.sample_rate,
        speech_encoder_type=cfg.speech_encoder_type,
        single_backend_type=cfg.single_backend_type,
        multi_backend_type=cfg.multi_backend_type,
        d_state=cfg.d_state,
        expand=cfg.expand,
        encoder_block_layers=blocks,
    )


def tsvad3_config(cfg: TrainCliConfig):
    """TrainCliConfig → TSVAD3Config, as the JAX CLI's _build_model does:
    both CAM++ at the `encoder_blocks` depth."""
    from ..models.tsvad import TSVADConfig
    from ..models.tsvad3 import TSVAD3Config

    blocks = _blocks(cfg)
    base = TSVADConfig(
        max_num_speaker=cfg.n_speakers if cfg.n_speakers > 2 else 4,
        feat_dim=cfg.n_mels if cfg.n_mels != 23 else 80,
        num_transformer_layer=cfg.n_layers,
        num_attention_head=cfg.n_heads,
        transformer_ffn_embed_dim=cfg.d_ff,
        dropout=cfg.dropout,
        sample_rate=cfg.sample_rate,
        encoder_block_layers=blocks,
    )
    return TSVAD3Config(base=base, ts_len=cfg.ts_len, fuse_fbank_feat=cfg.fuse_fbank_feat,
                        fuse_speaker_embedding_feat=cfg.fuse_speaker_embedding_feat, speaker_encoder_layers=blocks)


def sond_config(cfg: TrainCliConfig):
    """TrainCliConfig → SONDConfig, as the JAX CLI's _build_model does
    (n_mels as it is, 192-d profiles, ResNet34 3,4,6,3 unless encoder_blocks)."""
    from ..models.sond import SONDConfig

    n = cfg.n_speakers if cfg.n_speakers > 2 else 4
    return SONDConfig(max_speakers=n, max_set_size=min(n, 4), feat_dim=cfg.n_mels, spk_emb_dim=192,
                      d_model=cfg.d_model, n_heads=cfg.n_heads, dropout=cfg.dropout,
                      encoder_blocks=_blocks(cfg, (3, 4, 6, 3)))


def ssnd_config(cfg: TrainCliConfig):
    """TrainCliConfig → SSNDConfig, as the JAX CLI's _build_model does (the
    block is rs_len at 25 Hz; the other widths are SSNDConfig's)."""
    from ..models.ssnd import SSNDConfig

    return SSNDConfig(n_all_speakers=cfg.all_n_speakers, max_speakers=cfg.n_speakers if cfg.n_speakers > 2 else 4,
                      vad_out_len=int(cfg.rs_len * 25), sample_rate=cfg.sample_rate, extractor_blocks=_blocks(cfg))


def ots_vad_config(cfg: TrainCliConfig):
    """TrainCliConfig → OTSVADConfig, as the JAX CLI's _build_model does
    (n_layers // 2 conformer blocks, ResNet34 3,4,6,3 unless encoder_blocks)."""
    from ..models.ots_vad import OTSVADConfig

    return OTSVADConfig(num_speakers=cfg.n_speakers if cfg.n_speakers > 2 else 4, d_model=cfg.d_model,
                        conformer_layers=max(cfg.n_layers // 2, 1), n_heads=cfg.n_heads, d_ff=cfg.d_ff,
                        feat_dim=cfg.n_mels if cfg.n_mels != 23 else 80, sample_rate=cfg.sample_rate,
                        encoder_blocks=_blocks(cfg, (3, 4, 6, 3)), dropout=cfg.dropout)


def m2f_config(cfg: TrainCliConfig):
    """TrainCliConfig → M2FConfig, as the JAX CLI's _build_model does."""
    from ..models.eend_m2f import M2FConfig

    return M2FConfig(num_queries=max(cfg.n_speakers * 2, 8), d_model=cfg.d_model, n_heads=cfg.n_heads, d_ff=cfg.d_ff,
                     enc_layers=cfg.n_layers, dec_layers=max(cfg.n_layers // 2, 1), dropout=cfg.dropout)


def streaming_config(cfg: TrainCliConfig):
    """TrainCliConfig → StreamingTSVADConfig, as the JAX CLI's _build_model does."""
    from ..models.streaming_tsvad import StreamingTSVADConfig

    return StreamingTSVADConfig(
        max_num_speaker=cfg.n_speakers if cfg.n_speakers > 2 else 4,
        d_model=cfg.d_model,
        d_ff=cfg.d_ff,
        n_heads=cfg.n_heads,
        n_layers=cfg.n_layers,
        dropout=cfg.dropout,
        sample_rate=cfg.sample_rate,
        feat_dim=cfg.n_mels if cfg.n_mels != 23 else 80,
        chunk_size=cfg.streaming_chunk_size,
        num_left_chunks=cfg.streaming_left_chunks,
    )


def _cli_config(args, base: TrainCliConfig) -> TrainCliConfig:
    from ..utils.config import apply_overrides

    cfg = dataclasses.replace(base, family=args.family or base.family)
    if args.set:
        cfg = apply_overrides(cfg, args.set)
    if cfg.family not in FAMILIES:
        raise SystemExit(f"family {cfg.family!r} is not ported yet; ported: {', '.join(FAMILIES)}")
    if cfg.family == "vad" and cfg.subsampling != 1:  # labels at the frame rate, one per frame_shift hop
        logging.info("vad family: forcing subsampling=1")
        cfg = dataclasses.replace(cfg, subsampling=1)
    if cfg.family == "eend_m2f" and (cfg.subsampling != 1 or cfg.context_size != 0):
        # the ×10 lives in the conv backbone and masks are scored at the input
        # frame rate, so the front-end and the dataset run unsubsampled and
        # unspliced (JAX _normalize_cfg)
        logging.info("eend_m2f: forcing subsampling=1 context_size=0 (the backbone does the x10)")
        cfg = dataclasses.replace(cfg, subsampling=1, context_size=0)
    return cfg


def _load_config(path, overrides=()):
    from ..models.tsvad import TSVADConfig
    from ..utils.config import apply_overrides, load_json

    cfg = load_json(TSVADConfig, path) if path else TSVADConfig()
    return apply_overrides(cfg, list(overrides)) if overrides else cfg


def _load_encoder(model, path: str, attr: str = "speech_encoder") -> None:
    """Put a pretrained speech encoder into `model.<attr>` (TS-VAD3 has a
    `speaker_encoder` too): the `export-encoder` npz (of the module's
    encoder type), or a wespeaker-named CAM++ torch state dict. The tensors
    the module lacks (an embedding head TS-VAD does not use) are left out."""
    import torch

    from ..utils.convert import encoder_from_flax, load_encoder_npz

    if path.endswith(".npz"):
        meta, v = load_encoder_npz(path)
        sd = encoder_from_flax(meta.get("encoder", "campplus"), v["params"], v["batch_stats"])
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd.get("model", sd))
    enc = getattr(model, attr)
    want = enc.state_dict()
    missing = sorted(set(want) - set(sd))
    if missing:
        raise SystemExit(f"{path} lacks {len(missing)} tensors of the speech encoder, e.g. {missing[:3]}")
    enc.load_state_dict({k: sd[k] for k in want})
    logging.info("loaded an encoder from %s", path)


def frontend_config(cfg: TrainCliConfig):
    """TrainCliConfig → the EEND family's FrontendConfig (JAX _frontend_from_cfg)."""
    from ..models.eend import FrontendConfig

    return FrontendConfig(sample_rate=cfg.sample_rate, frame_size=cfg.frame_size, frame_shift=cfg.frame_shift,
                          n_mels=cfg.n_mels, context_size=cfg.context_size, subsampling=cfg.subsampling)


def build_model(cfg: TrainCliConfig, device, bf16: bool = False):
    """The family's model at the config's widths, as the JAX CLI's
    _build_model builds it, with weights drawn from cfg.seed."""
    dtype = "bf16" if (cfg.bf16 or bf16) else "fp32"
    if cfg.family == "tsvad":
        from ..models.tsvad import TSVADModel

        return TSVADModel(tsvad_config(cfg), dtype=dtype, device=device, seed=cfg.seed, remat_encoder=cfg.remat)
    if cfg.family == "tsvad_streaming":
        from ..models.streaming_tsvad import StreamingTSVADModel

        return StreamingTSVADModel(streaming_config(cfg), dtype=dtype, device=device, seed=cfg.seed)
    if cfg.family == "tsvad3":
        from ..models.tsvad3 import TSVAD3Model

        return TSVAD3Model(tsvad3_config(cfg), dtype=dtype, device=device, seed=cfg.seed)
    if cfg.family == "sond":
        from ..models.sond import SONDModel

        return SONDModel(sond_config(cfg), dtype=dtype, device=device, seed=cfg.seed)
    if cfg.family == "ots_vad":
        from ..models.ots_vad import OTSVADModel

        return OTSVADModel(ots_vad_config(cfg), dtype=dtype, device=device, seed=cfg.seed)
    if cfg.family == "ssnd":
        from ..models.ssnd import SSNDModel

        return SSNDModel(ssnd_config(cfg), dtype=dtype, device=device, seed=cfg.seed)
    if cfg.family == "spk":
        from ..models.spk_embed import SpeakerClassifier

        return SpeakerClassifier(spk_config(cfg, cfg.all_n_speakers), dtype=dtype, device=device, seed=cfg.seed)
    if cfg.family == "vad":
        from ..models.vad import NeuralVAD, NeuralVADConfig

        vcfg = NeuralVADConfig(sample_rate=cfg.sample_rate, frame_size=cfg.frame_size, frame_shift=cfg.frame_shift)
        return NeuralVAD(vcfg, dtype=dtype, device=device, seed=cfg.seed)
    if cfg.family == "enhance":
        from ..models.enhancer import EnhancerConfig, MaskDenoiser

        return MaskDenoiser(EnhancerConfig(), dtype=dtype, device=device, seed=cfg.seed)
    if cfg.family == "eend_m2f":
        from ..models.eend_m2f import EENDM2FModel

        fe = dataclasses.replace(frontend_config(cfg), subsampling=1, context_size=0)
        return EENDM2FModel(m2f_config(cfg), frontend=fe, dtype=dtype, device=device, seed=cfg.seed)
    common = dict(d_model=cfg.d_model, n_layers=cfg.n_layers, n_heads=cfg.n_heads, d_ff=cfg.d_ff, dropout=cfg.dropout,
                  frontend=frontend_config(cfg), dtype=dtype, device=device, seed=cfg.seed)
    if cfg.family == "fs_eend":
        from ..models.fs_eend import FSEENDModel

        return FSEENDModel(n_speakers=cfg.n_speakers, enc_layers=cfg.n_layers, dec_layers=max(cfg.n_layers // 2, 1),
                           **{k: v for k, v in common.items() if k != "n_layers"})
    if cfg.family == "eend_vc":
        from ..models.eend_vc import EENDVCModel

        return EENDVCModel(n_speakers=cfg.n_speakers, all_n_speakers=cfg.all_n_speakers, **common)
    if cfg.family == "eend":
        from ..models.eend import EENDModel

        return EENDModel(n_speakers=cfg.n_speakers, remat=cfg.remat, **common)
    from ..models.eda import EendEdaModel

    return EendEdaModel(n_speakers=cfg.n_speakers, max_attractors=cfg.max_attractors,
                        encoder_type=cfg.encoder_type, conv_norm="group", remat=cfg.remat, **common)


def _slots(model) -> int:
    """Speaker slots of a windowed model (TS-VAD, streaming TS-VAD, TS-VAD3, SOND, OTS-VAD)."""
    c = model.cfg
    for name in ("max_speakers", "num_speakers"):
        if hasattr(c, name):
            return getattr(c, name)
    return getattr(c, "base", c).max_num_speaker


def _enhancer_kwargs(cfg: TrainCliConfig, device) -> dict:
    """The dataset's enhancer hook from `--set enhancer=… enhance_prob=…`; a
    neural enhancer runs on `device`."""
    if not cfg.enhancer:
        return {}
    from ..data.enhance import get_enhancer

    return dict(enhancer=get_enhancer(cfg.enhancer, device), enhance_prob=cfg.enhance_prob)


def _tsvad_data(args, cfg: TrainCliConfig, model):
    """TS-VAD, streaming TS-VAD, TS-VAD3, SOND and OTS-VAD: (loss_fn, train
    iterator factory, valid iterator factory, sizes). The datasets give the
    model's slot count; a comma list of --train-dir trains on the corpora
    jointly (TS-VAD3: with a parallel comma list of --target-audio-dir).
    OTS-VAD needs no embeddings (--emb-store is optional) and reads chunks
    of 2·rs_len: it self-enrolls on the left half and predicts the right."""
    from ..data.eend_dataset import ConcatChunkDataset
    from ..data.tsvad_dataset import TSVADChunkDataset, tsvad_batch_iterator
    from ..infer.embeddings import EmbeddingStore
    from ..train import tasks

    train_dirs = args.train_dir.split(",")
    tads, vtad = [None] * len(train_dirs), None
    T = int(cfg.rs_len * 25)
    rs_len = 2 * cfg.rs_len if cfg.family == "ots_vad" else cfg.rs_len
    if cfg.family == "tsvad3":
        if not args.target_audio_dir:
            raise SystemExit("train --family tsvad3 needs --target-audio-dir (prepare-targets' target_audio tree): "
                             "it embeds enrollment waveforms, not stored embeddings")
        if args.valid_dir and not args.valid_target_audio_dir:
            raise SystemExit("train --family tsvad3 --valid-dir needs --valid-target-audio-dir")
        tads, vtad = args.target_audio_dir.split(","), args.valid_target_audio_dir
        if len(tads) != len(train_dirs):
            raise SystemExit(f"{len(tads)} --target-audio-dir trees for {len(train_dirs)} --train-dir corpora")
        if args.encoder_ckpt:  # the same pretrained CAM++ on both sides, as in JAX
            _load_encoder(model, args.encoder_ckpt)
            _load_encoder(model, args.encoder_ckpt, "speaker_encoder")
        loss_fn = tasks.make_tsvad3_loss(T, cfg.freeze_encoder)
    elif cfg.family == "ots_vad":
        loss_fn = tasks.make_ots_vad_loss()
    elif not args.emb_store:
        raise SystemExit(f"train --family {cfg.family} needs --emb-store")
    elif cfg.family == "tsvad_streaming":
        if args.encoder_ckpt:
            raise SystemExit("tsvad_streaming has its own conv front-end and no CAM++: drop --encoder-ckpt")
        loss_fn = tasks.make_streaming_tsvad_loss(T)
    elif cfg.family == "sond":
        loss_fn = tasks.make_sond_loss_from_audio(sample_rate=cfg.sample_rate)
    else:
        if args.encoder_ckpt:
            _load_encoder(model, args.encoder_ckpt)
        loss_fn = tasks.make_tsvad_loss(T, cfg.freeze_encoder)
    store = EmbeddingStore.load(args.emb_store) if args.emb_store else None  # a comma list merges stores
    common = dict(rs_len=rs_len, rate=cfg.sample_rate, max_speakers=_slots(model), enroll_len_s=cfg.ts_len)
    # as in the JAX CLI, the enhancer hook is on the training sets, and not on SOND's
    enh = _enhancer_kwargs(cfg, model.device) if cfg.family != "sond" else {}
    dss = [TSVADChunkDataset(d, store, segment_shift=cfg.segment_shift, is_train=True, seed=cfg.seed,
                             noise_dir=args.noise_dir, rir_dir=args.rir_dir, target_audio_dir=t, **common, **enh)
           for d, t in zip(train_dirs, tads)]
    train_ds = dss[0] if len(dss) == 1 else ConcatChunkDataset(dss)
    valid_ds = None
    if args.valid_dir:
        valid_ds = TSVADChunkDataset(args.valid_dir, store, segment_shift=rs_len, is_train=False,
                                     target_audio_dir=vtad, **common)
    return (
        loss_fn,
        lambda ep: tsvad_batch_iterator(train_ds, cfg.batch_size, True, cfg.seed, epoch=ep),
        (lambda: tsvad_batch_iterator(valid_ds, cfg.batch_size, False)) if valid_ds else None,
        (len(train_ds), len(valid_ds) if valid_ds else 0),
    )


def _eend_data(args, cfg: TrainCliConfig):
    """EEND / EEND-EDA / EEND-VC / EEND-M2F / FS-EEND / VAD: (cfg with the batch clamped to the chunks
    there are and, for EEND-VC, all_n_speakers from the corpus when 0,
    loss_fn, train iterator factory, valid iterator factory, sizes); a comma
    list of --train-dir trains on the corpora jointly."""
    from ..data.eend_dataset import ConcatChunkDataset, EendChunkDataset, batch_iterator
    from ..train import tasks

    fe = frontend_config(cfg)
    dss = [EendChunkDataset(d, cfg.chunk_frames, fe, cfg.n_speakers) for d in args.train_dir.split(",")]
    train_ds = dss[0] if len(dss) == 1 else ConcatChunkDataset(dss)
    valid_ds = EendChunkDataset(args.valid_dir, cfg.chunk_frames, fe, cfg.n_speakers) if args.valid_dir else None
    n_chunks = len(train_ds.chunks)
    if n_chunks == 0:
        raise SystemExit(f"no training chunks: recordings shorter than chunk_frames={cfg.chunk_frames} "
                         f"subsampled frames? (dir: {args.train_dir})")
    if cfg.batch_size > n_chunks:
        logging.warning("batch_size %d > %d available chunks; clamping", cfg.batch_size, n_chunks)
        cfg = dataclasses.replace(cfg, batch_size=n_chunks)
    if cfg.family == "eend_vc":
        if cfg.all_n_speakers == 0:
            cfg = dataclasses.replace(cfg, all_n_speakers=len(train_ds.all_speakers))
        if valid_ds:
            # the validation speaker CE is scored against the training table: a
            # valid speaker takes its training row by name, an unseen one −1
            # (left out), not its index in the valid corpus's own list
            table = {s: i for i, s in enumerate(train_ds.all_speakers)}
            valid_ds.spk_to_gid = {s: table.get(s, -1) for s in valid_ds.all_speakers}
    loss_fn = {"eend": tasks.make_eend_loss, "eend_eda": tasks.make_eda_loss, "eend_vc": tasks.make_eend_vc_loss,
               "eend_m2f": tasks.make_m2f_loss, "fs_eend": tasks.make_fs_eend_loss,
               "vad": tasks.make_vad_loss}[cfg.family]()
    # the iterator drops partial batches, so a small dev set gets a smaller batch
    vbs = max(1, min(cfg.batch_size, len(valid_ds.chunks))) if valid_ds else 0
    return (
        cfg,
        loss_fn,
        lambda ep: batch_iterator(train_ds, cfg.batch_size, True, cfg.seed, epoch=ep),
        (lambda: batch_iterator(valid_ds, vbs, False)) if valid_ds else None,
        (n_chunks, len(valid_ds.chunks) if valid_ds else 0),
    )


def _spk_data(args, cfg: TrainCliConfig):
    """Speaker pretraining: (cfg with all_n_speakers from the corpus when 0,
    loss_fn, train iterator factory, valid iterator factory, sizes)."""
    from ..data.spk_dataset import SpeakerUttDataset, spk_batch_iterator
    from ..train.tasks import make_spk_loss

    train_ds = SpeakerUttDataset(args.train_dir, dur=cfg.spk_dur, rate=cfg.sample_rate, is_train=True,
                                 seed=cfg.seed, noise_dir=args.noise_dir)
    valid_ds = None
    if args.valid_dir:
        valid_ds = SpeakerUttDataset(args.valid_dir, dur=cfg.spk_dur, rate=cfg.sample_rate, is_train=False)
    if cfg.all_n_speakers == 0:
        cfg = dataclasses.replace(cfg, all_n_speakers=train_ds.n_speakers)
    return (
        cfg,
        make_spk_loss(sample_rate=cfg.sample_rate),
        lambda ep: spk_batch_iterator(train_ds, cfg.batch_size, True, cfg.seed, epoch=ep),
        (lambda: spk_batch_iterator(valid_ds, min(cfg.batch_size, len(valid_ds)), False)) if valid_ds else None,
        (len(train_ds), len(valid_ds) if valid_ds else 0),
    )


def _enhance_data(args, cfg: TrainCliConfig):
    """The learned denoiser: (cfg, loss_fn, train iterator factory, None,
    sizes). Batches are endless (clean, clean + noise) pairs: spk_dur-second
    crops of --train-dir's single-speaker utterances with --noise-dir noise
    at 0-15 dB SNR (data/enhance.noisy_pair_batches). No validation set, as
    in JAX."""
    from ..data.enhance import noisy_pair_batches
    from ..data.kaldi_io import load_scp
    from ..models.enhancer import make_enhance_loss

    if not args.noise_dir:
        raise SystemExit("train --family enhance needs --noise-dir")

    def pairs(ep):
        return noisy_pair_batches(args.train_dir, args.noise_dir, rate=cfg.sample_rate, dur_s=cfg.spk_dur,
                                  batch_size=cfg.batch_size, seed=cfg.seed)

    n_clean = len(load_scp(os.path.join(args.train_dir, "wav.scp")))
    return cfg, make_enhance_loss(), pairs, None, (n_clean, 0)


def _ssnd_data(args, cfg: TrainCliConfig):
    """SSND: (cfg with all_n_speakers from the mixer when 0, loss_fn, train
    iterator factory, None, sizes). Batches are simulated meetings mixed on
    the fly from the single-speaker --train-dir (SimuDiarMixer), and, with
    --real-data-dir, a `ssnd_real_ratio` share of each batch cut from real
    meetings (RealDiarBlocks), their speakers on the mixer's rows of E_all.
    There is no validation set, as in JAX."""
    import numpy as np

    from ..data.simulate import RealDiarBlocks, SimuDiarMixer
    from ..train.tasks import make_ssnd_loss

    mixer = SimuDiarMixer(args.train_dir, noise_dir=args.noise_dir, duration=cfg.rs_len, rate=cfg.sample_rate,
                          max_speakers=cfg.n_speakers if cfg.n_speakers > 2 else 4, sil_scale=cfg.ssnd_sil_scale,
                          overlap_prob=cfg.ssnd_overlap_prob, seed=cfg.seed)
    if cfg.all_n_speakers == 0:
        cfg = dataclasses.replace(cfg, all_n_speakers=mixer.n_all_speakers)
    real = None
    if args.real_data_dir:
        real = RealDiarBlocks(args.real_data_dir, mixer.spk_to_gid, duration=cfg.rs_len, rate=cfg.sample_rate,
                              max_speakers=mixer.max_speakers, seed=cfg.seed + 1)

    def batches(bs):
        n_real = int(round(bs * cfg.ssnd_real_ratio)) if real else 0
        for b in mixer.batches(bs - n_real if n_real else bs):
            audio, labels, gids = b["audio"], b["labels"], b["spk_gids"]
            if n_real:
                items = [real.sample() for _ in range(n_real)]
                audio = np.concatenate([audio, np.stack([i["audio"] for i in items])])
                labels = np.concatenate([labels, np.stack([i["labels"] for i in items])])
                gids = np.concatenate([gids, np.stack([i["spk_gids"] for i in items])])
            yield dict(audio=audio, labels=labels.transpose(0, 2, 1), spk_gids=gids)  # labels (B, S, T)

    loss_fn = make_ssnd_loss(arcface_weight=cfg.ssnd_arcface_weight)
    return cfg, loss_fn, lambda ep: batches(cfg.batch_size), None, (mixer.n_all_speakers, 0)


def _fit_batch_to_mesh(cfg: TrainCliConfig, mesh):
    """The batch must split evenly over the mesh's data axis: round it down,
    or drop the mesh (every rank then trains the whole batch) when it is
    smaller than the axis (JAX `cli/main.py:349-367`)."""
    if mesh is None:
        return cfg, mesh
    n_data = mesh.n_data
    if cfg.batch_size < n_data:
        logging.warning("batch_size %d < data-parallel size %d; running unsharded", cfg.batch_size, n_data)
        return cfg, None
    if cfg.batch_size % n_data:
        nb = (cfg.batch_size // n_data) * n_data
        logging.warning("rounding batch_size %d -> %d (multiple of %d shards)", cfg.batch_size, nb, n_data)
        cfg = dataclasses.replace(cfg, batch_size=nb)
    return cfg, mesh


def cmd_train(args) -> int:
    """Train one family. Launched by `torchrun --nproc_per_node N` (WORLD_SIZE
    > 1), every rank joins the process group (NCCL on the GPUs, gloo with
    --device cpu) and trains data-parallel on a mesh of `n_data` ranks
    (0: all), each keeping its rows of the same global batches; rank 0
    alone writes."""
    from ..parallel.mesh import init_distributed, is_main_process, make_mesh, replicate
    from ..train.checkpoints import CheckpointManager
    from ..train.loop import run_training
    from ..train.trainer import Trainer, TrainerConfig
    from ..utils.config import load_json
    from ..utils.device import resolve_device

    cfg = _cli_config(args, load_json(TrainCliConfig, args.config) if args.config else TrainCliConfig())
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dev = init_distributed(args.device)
        mesh = make_mesh(n_data=cfg.n_data or None)
        if not is_main_process():
            logging.getLogger().setLevel(logging.WARNING)
        cfg, mesh = _fit_batch_to_mesh(cfg, mesh)
    else:
        dev = resolve_device(args.device)
    if cfg.family in TSVAD_FAMILIES:
        model = build_model(cfg, dev)
        loss_fn, make_train, make_valid, sizes = _tsvad_data(args, cfg, model)
    else:  # spk's class count and eend_vc's and ssnd's speaker tables come from the corpus
        data = {"spk": _spk_data, "ssnd": _ssnd_data, "enhance": _enhance_data}.get(cfg.family, _eend_data)
        cfg, loss_fn, make_train, make_valid, sizes = data(args, cfg)
        model = build_model(cfg, dev)
    tcfg = TrainerConfig(
        optimizer=cfg.optimizer, learning_rate=cfg.learning_rate, schedule=cfg.schedule, d_model=cfg.d_model,
        warmup_steps=cfg.warmup_steps, total_steps=cfg.num_steps, grad_clip_norm=cfg.grad_clip_norm,
        grad_accum_steps=cfg.grad_accum_steps, model_avg_decay=cfg.model_avg_decay or None, seed=cfg.seed,
    )
    if mesh is not None:
        replicate(model, mesh)
    trainer = Trainer(model, loss_fn, tcfg, mesh=mesh)
    mgr = CheckpointManager(args.exp_dir, max_to_keep=args.max_to_keep)
    if is_main_process():
        with open(os.path.join(args.exp_dir, TRAIN_CONFIG), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=1)
    if args.resume and mgr.latest_step() is not None:
        trainer.load_state_dict(mgr.restore())
        logging.info("resumed from step %d", trainer.step)
    logging.info("training %s on %s (%s): %d train items, %d valid", cfg.family, dev, model.dtype, *sizes)
    run_training(
        trainer,
        make_train,
        cfg.num_steps,
        make_valid,
        mgr,
        log_every=cfg.log_every,
        valid_every=cfg.valid_every,
        metrics_path=os.path.join(args.exp_dir, "metrics.jsonl"),
        profile_dir=args.profile_dir,
    )
    if cfg.family == "tsvad" and is_main_process():  # for `infer --params`, and the JAX package's TSVADModel
        from ..utils.convert import save_flax_npz, tsvad_to_flax

        save_flax_npz(os.path.join(args.exp_dir, FLAX_PARAMS), tsvad_to_flax(model.state_dict(), cfg.n_heads))
        with open(os.path.join(args.exp_dir, FLAX_CONFIG), "w") as f:
            json.dump(dataclasses.asdict(model.cfg), f, indent=1)
    logging.info("training done at step %d; checkpoints in %s", trainer.step, args.exp_dir)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    return 0


def _model_from_exp_dir(args, dev):
    """(model, config) from a `train` run: its config, --family and --set,
    and the chosen checkpoint's weights (optionally the mean of the last K)."""
    from ..train.checkpoints import CheckpointManager, average_checkpoints
    from ..utils.config import load_json

    saved = os.path.join(args.exp_dir, TRAIN_CONFIG)
    cfg = _cli_config(args, load_json(TrainCliConfig, saved) if os.path.exists(saved) else TrainCliConfig())
    if cfg.family not in INFER_FAMILIES:
        raise SystemExit(f"{args.exp_dir} is a {cfg.family} run, which is not inferred: export it with "
                         f"{EXPORTED[cfg.family]}")
    mgr = CheckpointManager(args.exp_dir)
    step = args.step or mgr.best_step() or mgr.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoints in {args.exp_dir}")
    sd = mgr.restore(step)["model"]
    if cfg.family == "ssnd" and cfg.all_n_speakers == 0:  # the trained inventory is E_all's rows
        cfg = dataclasses.replace(cfg, all_n_speakers=int(sd["E_all"].shape[0]))
    model = build_model(cfg, dev, bf16=args.bf16)
    model.load_state_dict(sd)
    logging.info("restored step %s", step)
    if args.avg_last and args.avg_last > 1:
        steps = mgr.all_steps()[-args.avg_last :]
        names = [n for n, _ in model.named_parameters()]
        model.load_state_dict(average_checkpoints(mgr, steps, names), strict=False)
        logging.info("averaged %d checkpoints: %s", len(steps), steps)
    return model, cfg


def _tsvad_probs(args, model, cfg: TrainCliConfig, rs_len: float):
    """Overlap-voted probabilities of a windowed family → ({rec: (T, S)},
    frame seconds, {rec: speaker names}): TS-VAD and streaming TS-VAD (a
    streaming model decodes each window chunk by chunk) from stored
    embeddings, SOND from stored profiles (powerset posteriors folded to
    speakers), TS-VAD3 from enrollment waveforms. As in JAX, TS-VAD3's RTTM
    names the speakers by slot."""
    from ..data.tsvad_dataset import TSVADChunkDataset
    from ..infer import chunked
    from ..infer.embeddings import EmbeddingStore

    store, tad, emb_key = None, None, "target_embs"
    if cfg.family == "tsvad3":
        if not args.target_audio_dir:
            raise SystemExit("tsvad3 inference needs --target-audio-dir (prepare-targets' target_audio tree)")
        tad, emb_key = args.target_audio_dir, "enroll_audio"
    elif not args.emb_store:
        raise SystemExit(f"{cfg.family} inference needs --emb-store")
    else:
        store = EmbeddingStore.load(args.emb_store)  # a comma list merges stores
    mc = getattr(model.cfg, "base", model.cfg)  # SONDConfig has no rates: the run's, and 25 Hz labels
    label_rate = getattr(mc, "label_rate", 25)
    enh = _enhancer_kwargs(cfg, model.device) if cfg.family == "tsvad" else {}  # as the JAX CLI's infer
    ds = TSVADChunkDataset(args.data_dir, store, rs_len=rs_len, segment_shift=args.infer_shift,
                           max_speakers=_slots(model), rate=getattr(mc, "sample_rate", cfg.sample_rate),
                           label_rate=label_rate, target_audio_dir=tad, enroll_len_s=cfg.ts_len, **enh)
    T = int(rs_len * label_rate)
    if cfg.family == "sond":
        predict = chunked.make_sond_predict(model, cfg.sample_rate)
    elif cfg.family == "tsvad_streaming":
        predict = chunked.make_streaming_window_predict(model, T)
    else:
        predict = chunked.make_tsvad_predict(model, T)
    probs = chunked.tsvad_infer_dataset(predict, ds, batch_size=BATCH_SIZE, emb_key=emb_key)
    return probs, 1.0 / label_rate, {} if cfg.family == "tsvad3" else ds.rec_speakers  # real speaker names


def _ots_vad_probs(args, model, cfg: TrainCliConfig, rs_len: float):
    """OTS-VAD: enrollment-free online decoding per recording (slot
    bootstrapping and the new-speaker rule) → ({rec: (T, S)}, 1/25 s, slots
    named spk1…spkS)."""
    from ..data.kaldi_io import KaldiData
    from ..infer.ots_vad import ots_vad_infer_dataset

    probs = ots_vad_infer_dataset(model, KaldiData(args.data_dir), rate=cfg.sample_rate, rs_len=rs_len)
    names = [f"spk{i + 1}" for i in range(model.cfg.num_speakers)]
    return probs, 1.0 / 25, {rec: names for rec in probs}


def _eend_vc_probs(args, model, cfg: TrainCliConfig):
    """EEND-VC: per recording, chunk posteriors and vectors → constrained
    AHC → stitched probabilities ({rec: (T, k)}, frame seconds, {}).
    --num-spks -1 takes each recording's speaker count from --ref (else the
    data dir's rttm), k > 0 fixes it, 0 cuts at the AHC distance threshold."""
    from ..data.kaldi_io import KaldiData
    from ..data.rttm import read_rttm_by_rec
    from ..infer.eend_vc import eend_vc_infer_recording, make_eend_vc_predict

    fe = frontend_config(cfg)
    kd = KaldiData(args.data_dir)
    oracle = {}
    if args.num_spks == -1:
        src = args.ref or os.path.join(args.data_dir, "rttm")
        oracle = {rec: len({t.speaker for t in ts}) for rec, ts in read_rttm_by_rec(src).items()}
    predict = make_eend_vc_predict(model)
    probs = {}
    for rec in sorted(kd.wavs):
        audio, rate = kd.load_wav(rec)
        if rate != fe.sample_rate:
            raise ValueError(f"{rec}: {rate} Hz audio, the model's front-end wants {fe.sample_rate} Hz")
        nk = oracle.get(rec) if args.num_spks == -1 else (args.num_spks or None)
        probs[rec] = eend_vc_infer_recording(predict, audio, fe, cfg.chunk_frames, n_clusters=nk,
                                             sil_spk_th=args.sil_spk_th)
    return probs, fe.frame_shift * fe.subsampling / fe.sample_rate, {}


def _ssnd_probs(args, model, cfg: TrainCliConfig):
    """SSND: per recording, block-wise online inference with a speaker
    memory, or with --ssnd-rescore the two-pass offline rescoring →
    ({rec: (T, n_speakers)}, 1/25 s, {})."""
    from ..data.kaldi_io import KaldiData
    from ..infer.ssnd_online import make_ssnd_predict, ssnd_offline_rescore, ssnd_online_infer

    c = model.cfg
    predict = make_ssnd_predict(model)
    e_pse, e_non = (getattr(model, n).detach().float().cpu().numpy()[0] for n in ("e_pse", "e_non"))
    block_samples = int(c.vad_out_len / 25 * cfg.sample_rate)
    infer_fn = ssnd_offline_rescore if args.ssnd_rescore else ssnd_online_infer
    kd = KaldiData(args.data_dir)
    probs = {}
    for rec in sorted(kd.wavs):
        audio, rate = kd.load_wav(rec)
        if rate != cfg.sample_rate:
            raise ValueError(f"{rec}: {rate} Hz audio, the model wants {cfg.sample_rate} Hz")
        if audio.ndim > 1:
            audio = audio[:, 0]
        probs[rec] = infer_fn(predict, audio, block_samples, c.vad_out_len, c.max_speakers, e_pse, e_non)
    return probs, 1.0 / 25, {}


def _eend_probs(args, model, cfg: TrainCliConfig):
    """Chunked EEND / EEND-EDA / EEND-M2F / FS-EEND probabilities → ({rec: (T, S)},
    frame seconds, {}). EEND-M2F keeps the queries above --class-threshold,
    at most --m2f-max-concurrent a frame (default n_speakers, 0: no cap)."""
    from ..infer.chunked import infer_dataset, make_eend_predict, make_fs_eend_predict, make_m2f_predict

    fe = frontend_config(cfg)
    if cfg.family == "eend":
        probs = infer_dataset(make_eend_predict(model), args.data_dir, fe, cfg.chunk_frames)
    elif cfg.family == "eend_m2f":
        cap = cfg.n_speakers if args.m2f_max_concurrent is None else args.m2f_max_concurrent
        probs = infer_dataset(make_m2f_predict(model, args.class_threshold, cap), args.data_dir, fe, cfg.chunk_frames)
    elif cfg.family == "fs_eend":
        probs = infer_dataset(make_fs_eend_predict(model), args.data_dir, fe, cfg.chunk_frames)
    else:
        from ..infer.eda import eda_infer_dataset, make_eda_predict

        probs = eda_infer_dataset(make_eda_predict(model), args.data_dir, fe, cfg.chunk_frames,
                                  threshold=args.attractor_threshold)
    return probs, fe.frame_shift * fe.subsampling / fe.sample_rate, {}


def cmd_infer(args) -> int:
    from ..data.rttm import write_rttm
    from ..models.tsvad import TSVADModel
    from ..postproc import probs_to_turns
    from ..utils.convert import load_flax_npz, tsvad_from_flax
    from ..utils.device import resolve_device

    if bool(args.exp_dir) == bool(args.params):
        raise SystemExit("infer needs one of --exp-dir (a `train` run) and --params (a flax npz)")
    if args.params and (args.family or "tsvad") != "tsvad":
        raise SystemExit("--params takes TS-VAD weights only; the EEND families infer from --exp-dir")
    dev = resolve_device(args.device)
    if args.exp_dir:
        model, cfg = _model_from_exp_dir(args, dev)
        rs_len = cfg.rs_len
    else:
        model = TSVADModel(_load_config(args.config, args.set), dtype="bf16" if args.bf16 else "fp32", device=dev)
        model.load_state_dict(tsvad_from_flax(load_flax_npz(args.params)))
        cfg, rs_len = TrainCliConfig(family="tsvad"), 4.0
        logging.info("loaded %s on %s (%s)", args.params, model.device, model.dtype)
    if cfg.family == "ots_vad":
        probs, fs, spk_names = _ots_vad_probs(args, model, cfg, args.rs_len or rs_len)
    elif cfg.family in TSVAD_FAMILIES:
        probs, fs, spk_names = _tsvad_probs(args, model, cfg, args.rs_len or rs_len)
    elif cfg.family == "eend_vc":
        probs, fs, spk_names = _eend_vc_probs(args, model, cfg)
    elif cfg.family == "ssnd":
        probs, fs, spk_names = _ssnd_probs(args, model, cfg)
    else:
        probs, fs, spk_names = _eend_probs(args, model, cfg)

    if args.threshold_sweep:
        # reference sweep (ts_vad2/infer.py:79): one RTTM per threshold;
        # score each when --ref is given and report the best
        from ..score import score_der

        best = None
        for th in [round(0.2 + 0.05 * i, 2) for i in range(16)] + [0.97, 0.98]:
            turns_t = []
            for rec, p in probs.items():
                turns_t += probs_to_turns(p, rec, fs, threshold=th, median=args.median, speakers=spk_names.get(rec))
            out_t = f"{args.out}_{th:.2f}"
            write_rttm(out_t, turns_t)
            if args.ref:
                res = score_der(args.ref, out_t, collar=0.25)
                extra = ""
                if args.cder:  # the reference RAMC recipes sweep CDER beside DER
                    from ..score.cder import score_cder

                    extra = f"  CDER {score_cder(args.ref, out_t)['avg']:.3f}"
                print(f"threshold {th:.2f}: {res.summary()}{extra}")
                if best is None or res.der < best[1]:
                    best = (th, res.der, out_t)
        if best:
            print(f"best threshold {best[0]:.2f} (DER {100 * best[1]:.2f}%) → {best[2]}")
        return 0

    turns = []
    for rec, p in probs.items():
        turns += probs_to_turns(p, rec, fs, threshold=args.threshold, median=args.median, speakers=spk_names.get(rec))
    write_rttm(args.out, turns)
    print(args.out)
    return 0


def cmd_simulate(args) -> int:
    from ..data import simulate as S

    if args.source_dir:
        specs = S.random_mixture_specs(
            args.source_dir, args.noise_dir, args.rir_dir, n_mixtures=args.n_mixtures,
            n_speakers=args.n_speakers, sil_scale=args.sil_scale, seed=args.seed,
        )
        out = S.make_mixtures(specs, os.path.join(args.out, "data"), os.path.join(args.out, "wav"), args.rate)
    else:
        out = S.simulate_corpus(
            args.out, n_mixtures=args.n_mixtures, n_speakers=args.n_speakers, rate=args.rate, seed=args.seed,
            sil_scale=args.sil_scale, with_rir=args.with_rir, rir_method=args.rir_method,
        )
    print(out)
    return 0


def cmd_simulate_meetings(args) -> int:
    """LibriCSS-style meetings from a single-speaker corpus (data/simulate.py)."""
    from ..data import simulate as S

    dynamics = None
    if args.dynamics:
        with open(args.dynamics) as f:
            dynamics = json.load(f)
    specs = S.meeting_mixture_specs(args.source_dir, dynamics=dynamics, noise_dir=args.noise_dir,
                                    rir_dir=args.rir_dir, seed=args.seed)
    out = S.make_meeting_mixtures(specs, os.path.join(args.out, "data"), os.path.join(args.out, "wav"), args.rate)
    print(out)
    return 0


def cmd_config_dump(args) -> int:
    """The resolved TrainCliConfig → stdout as yaml, json or bash, printed
    as the JAX CLI prints it (recipes source the bash form). The yaml form
    is written out by hand; --config takes JSON."""
    from ..utils.config import apply_overrides, load_json

    cfg = load_json(TrainCliConfig, args.config) if args.config else TrainCliConfig()
    if args.set:
        cfg = apply_overrides(cfg, args.set)
    d = dataclasses.asdict(cfg)
    if args.format == "json":
        print(json.dumps(d, indent=2))
    elif args.format == "bash":
        for k, v in d.items():
            if isinstance(v, bool):
                v = "true" if v else "false"
            print(f"{k}={json.dumps(v) if isinstance(v, str) else v}")
    else:
        for k, v in d.items():
            print(f"{k}: {v}")
    return 0


def cmd_export_encoder(args) -> int:
    """A spk `train` run's checkpoint → the encoder npz `extract-embeddings`
    and `train --family tsvad --encoder-ckpt` read (JAX save_encoder format).
    The config is the run's train_config.json, then --config, then --set."""
    import torch

    from ..models.spk_embed import build_encoder, save_encoder
    from ..train.checkpoints import CheckpointManager
    from ..utils.config import apply_overrides, load_json

    saved = os.path.join(args.exp_dir, TRAIN_CONFIG)
    cfg = load_json(TrainCliConfig, args.config or saved) if (args.config or os.path.exists(saved)) else TrainCliConfig()
    if args.set:
        cfg = apply_overrides(cfg, args.set)
    mgr = CheckpointManager(args.exp_dir)
    step = args.step or mgr.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoints in {args.exp_dir}")
    sd = mgr.restore(step)["model"]
    pre = "speech_encoder."
    enc = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    scfg = spk_config(cfg, 1)
    with torch.device("meta"):
        want = set(build_encoder(scfg).state_dict())
    if not want <= set(enc):
        raise SystemExit(f"{args.exp_dir} step {step} holds no {scfg.encoder} with an embedding head (not a spk run)")
    save_encoder(args.out, scfg, enc)
    logging.info("exported the encoder of step %d", step)
    print(args.out)
    return 0


def cmd_prepare_targets(args) -> int:
    from ..data.prep import prepare_targets_from_rttm

    out = prepare_targets_from_rttm(args.rttm, args.data_dir, args.out, label_rate=args.label_rate,
                                    min_target_s=args.min_target_s)
    print(out)
    return 0


def _embedding_encoder(path, device):
    """(a speaker encoder with its embedding head in eval mode on `device`,
    fbank bins): an export-encoder npz (CAM++, ECAPA or ResNet34), a
    wespeaker-named CAM++ torch state dict, or, with no path, CAM++ with
    seeded random weights (with a warning, as the JAX CLI does)."""
    import torch

    from ..models.campplus import CAMPPlus
    from ..models.layers import init_weights_
    from ..models.spk_embed import load_encoder

    if path and path.endswith(".npz"):
        camp, scfg = load_encoder(path, device)
        return camp, scfg.feat_dim
    camp = CAMPPlus()
    if path:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd.get("model", sd))
        missing = sorted(set(camp.state_dict()) - set(sd))
        if missing:
            raise SystemExit(f"{path} lacks {len(missing)} CAM++ tensors, e.g. {missing[:3]}")
        camp.load_state_dict({k: sd[k] for k in camp.state_dict()})
    else:
        init_weights_(camp, torch.Generator().manual_seed(0))
        logging.warning("no --encoder-ckpt: using random encoder weights")
    return camp.to(device).eval(), 80


def cmd_extract_embeddings(args) -> int:
    """Per-speaker target wavs → sliding-window speaker embeddings, one
    (n, emb_dim) matrix per (recording, speaker), as the JAX
    extract-embeddings. The fbank runs on the device (the K1 kernel on
    CUDA); the encoder on its module path."""
    import numpy as np
    import torch

    from ..data.kaldi_io import KaldiData
    from ..infer.embeddings import EmbeddingStore, chunk_embeddings
    from ..models.spk_embed import embed_audio
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    camp, n_mels = _embedding_encoder(args.encoder_ckpt, dev)

    @torch.no_grad()
    def embed(b: np.ndarray) -> np.ndarray:
        return embed_audio(camp, torch.from_numpy(b).to(dev), args.rate, n_mels).float().cpu().numpy()

    kd = KaldiData(args.data_dir)
    store = EmbeddingStore()
    # target wavs laid out as rec/spk.wav (AliMeeting prep) or keyed rec-spk
    for rec in sorted(kd.wavs):
        audio, rate = kd.load_wav(rec)
        if audio.ndim > 1:
            audio = audio[:, 0]
        if "/" in rec:
            meeting, spk = rec.rsplit("/", 1)
        elif "-" in rec:
            meeting, spk = rec.rsplit("-", 1)
        else:
            meeting, spk = rec, rec
        store.put(meeting, spk, chunk_embeddings(embed, audio, rate, window_s=args.window, hop_s=args.hop))
    store.save(args.out)
    print(args.out)
    return 0


def _restore_run(args, family: str):
    """(model on the CPU with a `train --family <family>` run's weights, step):
    the run's train_config.json, the --step checkpoint, else the latest."""
    import torch

    from ..train.checkpoints import CheckpointManager
    from ..utils.config import load_json

    saved = os.path.join(args.exp_dir, TRAIN_CONFIG)
    cfg = load_json(TrainCliConfig, saved) if os.path.exists(saved) else TrainCliConfig(family=family)
    if cfg.family != family:
        raise SystemExit(f"{args.exp_dir} is a {cfg.family} run, not a {family} one")
    mgr = CheckpointManager(args.exp_dir)
    step = args.step or mgr.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoints in {args.exp_dir}")
    model = build_model(cfg, torch.device("cpu"))
    model.load_state_dict(mgr.restore(step)["model"])
    return model, step


def cmd_export_vad(args) -> int:
    """A vad `train` run's checkpoint → the flax-layout npz `cluster
    --vad-ckpt` reads (models/vad.save_vad_params)."""
    from ..models.vad import save_vad_params

    model, step = _restore_run(args, "vad")
    save_vad_params(args.out, model)
    logging.info("exported VAD params from step %d", step)
    print(args.out)
    return 0


def cmd_export_enhancer(args) -> int:
    """An enhance `train` run's checkpoint → the npz the datasets' enhancer
    `neural:<path>` reads (models/enhancer.save_enhancer)."""
    from ..models.enhancer import save_enhancer

    model, step = _restore_run(args, "enhance")
    save_enhancer(args.out, model)
    logging.info("exported enhancer from step %d", step)
    print(args.out)
    return 0


def _make_embed_fn(args, device):
    """Subsegment embedding fn (B, samples) → (B, D) numpy for cluster and
    estimate-plda: `campplus` is the `extract-embeddings` encoder (an
    export-encoder npz, a wespeaker CAM++ state dict, or seeded random
    weights) after the fbank (K1 on CUDA); `spectrum` is the
    dependency-free baseline, the L2-normalised magnitude spectrum."""
    import numpy as np

    if args.encoder == "campplus":
        import torch

        from ..models.spk_embed import embed_audio

        enc, n_mels = _embedding_encoder(args.encoder_ckpt, device)

        @torch.no_grad()
        def embed(b: np.ndarray) -> np.ndarray:
            return embed_audio(enc, torch.from_numpy(b).to(device), args.rate, n_mels).float().cpu().numpy()

        return embed
    if args.encoder == "spectrum":
        def embed_fn(b):
            sp = np.abs(np.fft.rfft(b, axis=-1))[:, :512]
            return sp / (np.linalg.norm(sp, axis=-1, keepdims=True) + 1e-9)

        return embed_fn
    raise SystemExit(f"unknown encoder {args.encoder}")


def cmd_cluster(args) -> int:
    """SAD → subsegment embeddings → clustering → RTTM: the reference's
    spectral/umap clustering recipes as one command
    (egs/alimeeting/run_spectral_cluster.sh stages 2-8), as the JAX CLI's."""
    import numpy as np

    from ..data.kaldi_io import KaldiData
    from ..data.rttm import read_rttm_by_rec, write_rttm
    from ..infer.clustering import cluster_recording, energy_vad, oracle_sad
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    sad_fn = None
    ref_by_rec = {}
    if args.sad == "oracle":
        ref_by_rec = read_rttm_by_rec(args.oracle_rttm or os.path.join(args.data_dir, "rttm"))
    elif args.sad == "neural":
        from ..models.vad import NeuralVAD, NeuralVADConfig, load_vad_params, neural_sad

        if not args.vad_ckpt:
            raise SystemExit("--sad neural requires --vad-ckpt")
        vcfg = NeuralVADConfig(sample_rate=args.rate, frame_size=args.rate * 25 // 1000,
                               frame_shift=args.rate * 10 // 1000)
        vad = load_vad_params(args.vad_ckpt, NeuralVAD(vcfg, device=dev))
        sad_fn = lambda audio, rate: neural_sad(  # noqa: E731
            audio, rate, vad, threshold=args.vad_threshold, min_duration_s=args.min_duration)

    embed_fn = _make_embed_fn(args, dev)
    plda = None
    if args.method == "vbx":
        from ..infer.vbx import load_plda

        if not args.plda:
            raise SystemExit("--method vbx requires --plda (run estimate-plda first)")
        plda = load_plda(args.plda)

    kd = KaldiData(args.data_dir)
    all_turns = []
    for rec in sorted(kd.wavs):
        audio, rate = kd.load_wav(rec)
        if audio.ndim > 1:
            audio = audio[:, 0]
        audio = audio.astype(np.float32)
        if args.sad == "oracle":
            sad = oracle_sad(ref_by_rec.get(rec, []))
        elif args.sad == "neural":
            sad = sad_fn(audio, rate)
        else:
            sad = energy_vad(audio, rate)
        turns = cluster_recording(
            audio, rate, embed_fn, rec, sad=sad, method=args.method, num_spks=args.num_spks,
            max_num_spks=args.max_num_spks, window_s=args.window, hop_s=args.hop, plda=plda,
            vbx_loop_prob=args.vbx_loop_prob, vbx_fa=args.vbx_fa, vbx_fb=args.vbx_fb,
        )
        all_turns.extend(turns)
        logging.info("%s: %d turns, %d speakers", rec, len(turns), len({t.speaker for t in turns}))
    write_rttm(args.out, all_turns)
    print(args.out)
    if args.ref:
        from ..score import score_der

        print(score_der(args.ref, args.out, collar=args.collar).summary())
    return 0


def cmd_estimate_plda(args) -> int:
    """Labeled Kaldi dir (utt2spk [+segments]) → two-covariance PLDA npz for
    `cluster --method vbx`, estimated from the encoder's embeddings of up to
    --max-windows-per-utt windows an utterance, as the JAX CLI's."""
    import numpy as np

    from ..data.kaldi_io import KaldiData
    from ..data.wav import load_wav_maybe_piped
    from ..infer.vbx import estimate_plda, save_plda
    from ..utils.device import resolve_device

    embed_fn = _make_embed_fn(args, resolve_device(args.device))
    kd = KaldiData(args.data_dir)
    if not kd.utt2spk:
        raise SystemExit(f"{args.data_dir} has no utt2spk")
    win = int(args.window * args.rate)
    hop = int(args.hop * args.rate)
    wavs, labels = [], []
    spk_ids = {s: i for i, s in enumerate(sorted(set(kd.utt2spk.values())))}
    if kd.segments:
        entries = [(seg["utt"], rec, seg["st"], seg["et"]) for rec, segs in sorted(kd.segments.items())
                   for seg in segs if seg["utt"] in kd.utt2spk]
    else:
        entries = [(u, u, None, None) for u in sorted(kd.utt2spk) if u in kd.wavs]
    audio_cache = {}
    for utt, rec, st, et in entries:
        if rec not in audio_cache:
            a, r = load_wav_maybe_piped(kd.wavs[rec])
            if a.ndim > 1:
                a = a[:, 0]
            if r != args.rate:
                raise SystemExit(f"{rec}: {r} Hz audio, --rate is {args.rate}")
            if len(audio_cache) > 16:
                audio_cache.clear()
            audio_cache[rec] = a.astype(np.float32)
        a = audio_cache[rec]
        if st is not None:
            a = a[int(st * args.rate) : int(et * args.rate)]
        if len(a) < win:
            a = np.pad(a, (0, win - len(a)), "wrap")
        for off in range(0, min(len(a) - win, args.max_windows_per_utt * hop - 1) + 1, hop):
            wavs.append(a[off : off + win])
            labels.append(spk_ids[kd.utt2spk[utt]])
    embs = np.concatenate([embed_fn(np.stack(wavs[i : i + 64]).astype(np.float32))
                           for i in range(0, len(wavs), 64)], axis=0)
    plda = estimate_plda(embs, np.asarray(labels), dim=args.plda_dim)
    save_plda(args.out, plda)
    logging.info("PLDA from %d windows / %d speakers → %s (dim %d)", len(labels), len(spk_ids), args.out, len(plda.psi))
    print(args.out)
    return 0


def cmd_score(args) -> int:
    from ..score import score_der
    from ..score.cder import score_cder

    uem = None
    if args.uem:
        from ..data.rttm import load_uem

        uem = load_uem(args.uem)
    res = score_der(args.ref, args.sys, collar=args.collar, overlap_limit=args.overlap_limit, regions=args.regions, uem=uem)
    # reference md-eval (modified) prints the bare DER/MS/FA/SC line
    print(f"{100*res.der:.2f}/{100*res.miss_rate:.2f}/{100*res.falarm_rate:.2f}/{100*res.confusion_rate:.2f}")
    if args.per_file:
        for rec, r in res.per_file.items():
            print(f"  {rec}: {r.summary()}")
    if args.cder:
        print("CDER avg = {:.3f}".format(score_cder(args.ref, args.sys)["avg"]))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="speaker_diarization_tpu_torch.cli", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("simulate", help="build a simulated multi-talker corpus")
    s.add_argument("--out", required=True)
    s.add_argument("--source-dir", help="Kaldi dir of single-speaker utts (default: synthetic voices)")
    s.add_argument("--noise-dir")
    s.add_argument("--rir-dir")
    s.add_argument("--with-rir", action="store_true", help="synthesize and apply RIRs (no --rir-dir needed)")
    s.add_argument("--rir-method", choices=["decay", "image_source"], default="decay",
                   help="synthetic RIRs: sparse decays, or shoebox image-source rooms")
    s.add_argument("--n-mixtures", type=int, default=10)
    s.add_argument("--n-speakers", type=int, default=2)
    s.add_argument("--sil-scale", type=float, default=2.0)
    s.add_argument("--rate", type=int, default=8000)
    s.add_argument("--seed", type=int, default=777)
    s.set_defaults(fn=cmd_simulate)

    sm = sub.add_parser("simulate-meetings", help="LibriCSS-style meeting simulation from a single-speaker corpus")
    sm.add_argument("--out", required=True)
    sm.add_argument("--source-dir", required=True, help="Kaldi dir of single-speaker utts")
    sm.add_argument("--noise-dir")
    sm.add_argument("--rir-dir")
    sm.add_argument("--dynamics", help="JSON meeting-dynamics config (default: built-in LibriCSS shapes)")
    sm.add_argument("--rate", type=int, default=8000)
    sm.add_argument("--seed", type=int, default=7)
    sm.set_defaults(fn=cmd_simulate_meetings)

    t = sub.add_parser("train", help="train a model with periodic validation and checkpoints")
    t.add_argument("--family", choices=FAMILIES, help="model family (default: the --config's, else eend)")
    t.add_argument("--config", help="TrainCliConfig as JSON (field → value)")
    t.add_argument("--set", action="append", default=[], help="TrainCliConfig override key=value")
    t.add_argument("--train-dir", required=True,
                   help="Kaldi data dir (a comma list trains jointly, except for spk, which needs utt2spk)")
    t.add_argument("--valid-dir")
    t.add_argument("--exp-dir", required=True)
    t.add_argument("--emb-store", help="tsvad, tsvad_streaming, sond: target-speaker embedding npz "
                                       "(comma list merges)")
    t.add_argument("--target-audio-dir", help="tsvad3: comma list of target_audio trees (parallel to --train-dir)")
    t.add_argument("--valid-target-audio-dir", help="tsvad3: target_audio tree for --valid-dir")
    t.add_argument("--encoder-ckpt", help="tsvad, tsvad3: pretrained speech encoder, an export-encoder .npz or a "
                                          "wespeaker CAM++ torch state dict (tsvad3: both CAM++)")
    t.add_argument("--real-data-dir", help="ssnd: Kaldi dir of real meetings (with rttm) mixed into each batch "
                                           "at ssnd_real_ratio")
    t.add_argument("--noise-dir", help="Kaldi dir of noise wavs for additive-noise augmentation "
                                       "(enhance: the noise of its training pairs)")
    t.add_argument("--rir-dir", help="Kaldi dir of RIR wavs for reverberation")
    t.add_argument("--max-to-keep", type=int, default=5)
    t.add_argument("--resume", action="store_true", help="resume from the latest checkpoint in --exp-dir")
    t.add_argument("--profile-dir", help="write a torch.profiler trace of a few steps into this dir")
    t.add_argument("--device", help="torch device (default: cuda; pass 'cpu' to run on the CPU)")
    t.set_defaults(fn=cmd_train)

    i = sub.add_parser("infer", help="run chunked (EEND) or overlap-voted (TS-VAD) inference → RTTM")
    i.add_argument("--family", choices=INFER_FAMILIES,
                   help="model family (default: the --exp-dir run's, else tsvad with --params)")
    i.add_argument("--config", help="with --params: TSVADConfig as JSON; default: the full-size TSVADConfig()")
    i.add_argument("--set", action="append", default=[],
                   help="key=value override of the TSVADConfig (--params) or of the run's TrainCliConfig (--exp-dir)")
    i.add_argument("--data-dir", required=True)
    i.add_argument("--emb-store", help="tsvad, tsvad_streaming, sond: target-speaker embedding npz "
                                       "(comma list merges)")
    i.add_argument("--target-audio-dir", help="tsvad3: target_audio tree for enrollment waveforms")
    i.add_argument("--num-spks", type=int, default=0,
                   help="eend_vc: fixed cluster count (>0), -1 = oracle per-recording count from --ref "
                        "(reference est_nspk mode), 0 = distance-threshold AHC")
    i.add_argument("--sil-spk-th", type=float, default=0.05, help="eend_vc: silent-channel mean-activity threshold")
    i.add_argument("--class-threshold", type=float, default=0.5, help="eend_m2f: query-keep threshold")
    i.add_argument("--m2f-max-concurrent", type=int,
                   help="eend_m2f: per-frame top-k speaker cap (reference infer2); default n_speakers, 0 disables")
    i.add_argument("--ssnd-rescore", action="store_true",
                   help="ssnd: two-pass offline rescoring against the final speaker memory (reference offline_rescore)")
    i.add_argument("--params", help=_PARAMS_HELP)
    i.add_argument("--exp-dir", help="a `train` run: restore its best (else latest) checkpoint")
    i.add_argument("--step", type=int, help="with --exp-dir: restore this step")
    i.add_argument("--avg-last", type=int, default=0, help="with --exp-dir: average the last K checkpoints")
    i.add_argument("--out", required=True)
    i.add_argument("--threshold", type=float, default=0.5)
    i.add_argument("--attractor-threshold", type=float, default=0.5,
                   help="eend_eda: keep attractors until the first existence probability below this")
    i.add_argument("--median", type=int, default=11)
    i.add_argument("--rs-len", type=float, help="window seconds (default: the run's rs_len, else 4)")
    i.add_argument("--infer-shift", type=float, default=1.0)
    i.add_argument("--threshold-sweep", action="store_true", help="write RTTMs for thresholds 0.2..0.98")
    i.add_argument("--ref", help="reference RTTM for sweep scoring")
    i.add_argument("--cder", action="store_true", help="also report CDER in the threshold sweep")
    i.add_argument("--bf16", action="store_true", help="compute in bfloat16 (weights stay fp32)")
    i.add_argument("--device", help="torch device (default: cuda; pass 'cpu' to run on the CPU)")
    i.set_defaults(fn=cmd_infer)

    sc = sub.add_parser("score", help="score a hypothesis RTTM (DER, md-eval semantics)")
    sc.add_argument("--ref", required=True)
    sc.add_argument("--sys", required=True)
    sc.add_argument("-c", "--collar", type=float, default=0.25)
    sc.add_argument("-1", "--overlap-limit", action="store_true")
    sc.add_argument("-u", "--uem", help="NIST UEM file restricting the scored regions (md-eval -u)")
    sc.add_argument("--regions", choices=["all", "single", "overlap"], default="all")
    sc.add_argument("--per-file", action="store_true")
    sc.add_argument("--cder", action="store_true")
    sc.set_defaults(fn=cmd_score)

    pt = sub.add_parser("prepare-targets", help="system/oracle RTTM → overlap-free per-speaker target audio for TS-VAD")
    pt.add_argument("--rttm", required=True, help="system (clustering) or oracle RTTM")
    pt.add_argument("--data-dir", required=True, help="Kaldi dir of the mixture wavs")
    pt.add_argument("--out", required=True)
    pt.add_argument("--label-rate", type=int, default=25)
    pt.add_argument("--min-target-s", type=float, default=0.0, help="drop speakers with less clean speech than this")
    pt.set_defaults(fn=cmd_prepare_targets)

    cd = sub.add_parser("config-dump", help="print the resolved train config (yaml/json/bash)")
    cd.add_argument("--config", help="TrainCliConfig as JSON (field → value)")
    cd.add_argument("--set", action="append", default=[])
    cd.add_argument("--format", choices=["yaml", "json", "bash"], default="yaml")
    cd.set_defaults(fn=cmd_config_dump)

    ee = sub.add_parser("export-encoder", help="export a trained spk encoder for extract-embeddings")
    ee.add_argument("--exp-dir", required=True)
    ee.add_argument("--step", type=int)
    ee.add_argument("--out", required=True, help="output .npz path")
    ee.add_argument("--config", help="TrainCliConfig as JSON (default: the run's train_config.json)")
    ee.add_argument("--set", action="append", default=[])
    ee.set_defaults(fn=cmd_export_encoder)

    e = sub.add_parser("extract-embeddings", help="dump target-speaker embeddings to npz")
    e.add_argument("--data-dir", required=True, help="Kaldi dir of per-speaker target wavs")
    e.add_argument("--out", required=True)
    e.add_argument("--encoder-ckpt", help="export-encoder .npz (CAM++, ECAPA, ResNet34), or a wespeaker CAM++ "
                                          "torch state dict")
    e.add_argument("--rate", type=int, default=16000)
    e.add_argument("--window", type=float, default=6.0)
    e.add_argument("--hop", type=float, default=1.0)
    e.add_argument("--device", help="torch device (default: cuda; pass 'cpu' to run on the CPU)")
    e.set_defaults(fn=cmd_extract_embeddings)

    cl = sub.add_parser("cluster", help="SAD → embeddings → clustering → RTTM")
    cl.add_argument("--data-dir", required=True, help="Kaldi dir with wav.scp")
    cl.add_argument("--out", required=True, help="output RTTM path")
    cl.add_argument("--method", choices=["spectral", "umap", "vbx"], default="spectral")
    cl.add_argument("--plda", help="vbx: PLDA npz from estimate-plda")
    cl.add_argument("--vbx-loop-prob", type=float, default=0.9)
    cl.add_argument("--vbx-fa", type=float, default=0.4)
    cl.add_argument("--vbx-fb", type=float, default=17.0)
    cl.add_argument("--sad", choices=["energy", "oracle", "neural"], default="energy")
    cl.add_argument("--oracle-rttm", help="RTTM for oracle SAD (default: <data-dir>/rttm)")
    cl.add_argument("--vad-ckpt", help="neural VAD params: an export-vad npz, or the JAX package's flax msgpack")
    cl.add_argument("--vad-threshold", type=float, default=0.5)
    cl.add_argument("--min-duration", type=float, default=0.0)
    cl.add_argument("--encoder", choices=["campplus", "spectrum"], default="campplus")
    cl.add_argument("--encoder-ckpt", help="export-encoder .npz, or a wespeaker CAM++ torch state dict")
    cl.add_argument("--num-spks", type=int, help="fix the speaker count (else eigengap)")
    cl.add_argument("--max-num-spks", type=int, default=20)
    cl.add_argument("--window", type=float, default=1.5)
    cl.add_argument("--hop", type=float, default=0.75)
    cl.add_argument("--rate", type=int, default=16000)
    cl.add_argument("--ref", help="reference RTTM: score the result")
    cl.add_argument("-c", "--collar", type=float, default=0.25)
    cl.add_argument("--device", help="torch device (default: cuda; pass 'cpu' to run on the CPU)")
    cl.set_defaults(fn=cmd_cluster)

    ep = sub.add_parser("estimate-plda", help="labeled Kaldi dir → PLDA npz for cluster --method vbx")
    ep.add_argument("--data-dir", required=True, help="Kaldi dir with utt2spk (+segments)")
    ep.add_argument("--out", required=True, help="output PLDA npz path")
    ep.add_argument("--encoder", choices=["campplus", "spectrum"], default="campplus")
    ep.add_argument("--encoder-ckpt", help="export-encoder .npz, or a wespeaker CAM++ torch state dict")
    ep.add_argument("--rate", type=int, default=16000)
    ep.add_argument("--window", type=float, default=1.5)
    ep.add_argument("--hop", type=float, default=0.75)
    ep.add_argument("--max-windows-per-utt", type=int, default=8)
    ep.add_argument("--plda-dim", type=int, default=None, help="keep top-K PLDA dims")
    ep.add_argument("--device", help="torch device (default: cuda; pass 'cpu' to run on the CPU)")
    ep.set_defaults(fn=cmd_estimate_plda)

    ev = sub.add_parser("export-vad", help="export a trained VAD for `cluster --vad-ckpt`")
    ev.add_argument("--exp-dir", required=True)
    ev.add_argument("--step", type=int)
    ev.add_argument("--out", required=True)
    ev.set_defaults(fn=cmd_export_vad)

    en = sub.add_parser("export-enhancer", help="export a trained denoiser for the enhancer neural:<path>")
    en.add_argument("--exp-dir", required=True)
    en.add_argument("--step", type=int)
    en.add_argument("--out", required=True)
    en.set_defaults(fn=cmd_export_enhancer)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s [%(name)s] %(message)s",
    )
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
