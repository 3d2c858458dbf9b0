"""Command-line interface of the PyTorch port: TS-VAD training, inference, scoring.

    python -m speaker_diarization_tpu_torch.cli train --family tsvad \\
        --train-dir D --valid-dir V --emb-store E.npz[,E2.npz] --exp-dir X \\
        [--noise-dir N] [--rir-dir R] [--encoder-ckpt enc.npz] [--resume] \\
        [--set key=value ...] [--config train.json] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli infer --family tsvad \\
        --data-dir DIR --emb-store EMB.npz (--exp-dir X [--step S] [--avg-last K] \\
        | --params PARAMS.npz [--config tsvad.json]) --out hyp.rttm \\
        [--set key=value ...] [--rs-len 4] [--threshold-sweep --ref ref.rttm] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli score --ref ref.rttm --sys hyp.rttm

Flag names, `--set` keys and defaults follow the JAX package's CLI
(`TrainCliConfig`, cli/main.py:33-110, the TS-VAD fields). `train` writes
torch checkpoints and its config (train_config.json) into --exp-dir; `infer
--exp-dir` rebuilds the model from that config (then --set) and restores
the best checkpoint by validation loss, else the latest. `--params` takes
the JAX TSVADModel variables as one flax-layout .npz (utils/convert.py);
reading the JAX trainer's Orbax directories waits for ROADMAP item 6.
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

_PARAMS_HELP = (
    "flax-layout TSVADModel variables as one .npz ('params/...' and 'batch_stats/...' keys, "
    "utils/convert.save_flax_npz). Orbax checkpoint directories of the JAX trainer are not "
    "read yet (ROADMAP item 6)."
)


@dataclasses.dataclass
class TrainCliConfig:
    """The TS-VAD fields of the JAX CLI's TrainCliConfig, same names and defaults."""

    family: str = "tsvad"
    # model
    n_speakers: int = 2  # > 2 sets max_num_speaker, else 4
    d_model: int = 256  # noam's d_model
    n_layers: int = 4  # layers per backend
    n_heads: int = 4
    d_ff: int = 1024
    dropout: float = 0.1
    bf16: bool = False
    remat: bool = False
    sample_rate: int = 8000
    n_mels: int = 23  # 23 (the EEND default) means 80 for TS-VAD's CAM++ fbank
    # tsvad
    rs_len: float = 4.0
    segment_shift: float = 2.0
    speech_encoder_type: str = "campplus"
    single_backend_type: str = "transformer"
    multi_backend_type: str = "transformer"
    d_state: int = 64
    expand: int = 2
    encoder_blocks: str = ""  # "12,24,16" = reference CAM++
    freeze_encoder: bool = False
    enhancer: str = ""  # not ported: a non-empty value raises (ROADMAP item 10)
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


def tsvad_config(cfg: TrainCliConfig):
    """TrainCliConfig → TSVADConfig, as the JAX CLI's _build_model does."""
    from ..models.tsvad import TSVADConfig

    blocks = tuple(int(x) for x in cfg.encoder_blocks.split(",")) if cfg.encoder_blocks else (12, 24, 16)
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


def _cli_config(args, base: TrainCliConfig) -> TrainCliConfig:
    from ..utils.config import apply_overrides

    cfg = dataclasses.replace(base, family=args.family or base.family)
    if args.set:
        cfg = apply_overrides(cfg, args.set)
    if cfg.family != "tsvad":
        raise SystemExit(f"family {cfg.family!r} is not ported yet; only 'tsvad' is")
    if cfg.remat:
        raise NotImplementedError("remat is not ported to PyTorch yet (ROADMAP item 6)")
    return cfg


def _load_config(path, overrides=()):
    from ..models.tsvad import TSVADConfig
    from ..utils.config import apply_overrides, load_json

    cfg = load_json(TSVADConfig, path) if path else TSVADConfig()
    return apply_overrides(cfg, list(overrides)) if overrides else cfg


def _load_encoder(model, path: str) -> None:
    """Put a pretrained CAM++ into model.speech_encoder: the JAX
    `export-encoder` npz, or a wespeaker-named torch state dict."""
    import torch

    from ..utils.convert import campplus_from_flax, load_encoder_npz

    enc = model.speech_encoder
    if path.endswith(".npz"):
        meta, v = load_encoder_npz(path)
        if meta.get("encoder", "campplus") != "campplus":
            raise SystemExit(f"{path}: encoder {meta['encoder']!r} is not CAM++")
        sd = campplus_from_flax(v["params"], v["batch_stats"])
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd.get("model", sd))
    want = enc.state_dict()
    missing = sorted(set(want) - set(sd))
    if missing:
        raise SystemExit(f"{path} lacks {len(missing)} CAM++ tensors, e.g. {missing[:3]}")
    enc.load_state_dict({k: sd[k] for k in want})  # the embedding head (dense) is not used by TS-VAD
    logging.info("loaded speech encoder from %s", path)


def cmd_train(args) -> int:
    from ..data.tsvad_dataset import TSVADChunkDataset, tsvad_batch_iterator
    from ..infer.embeddings import EmbeddingStore
    from ..models.tsvad import TSVADModel
    from ..train.checkpoints import CheckpointManager
    from ..train.loop import run_training
    from ..train.tasks import make_tsvad_loss
    from ..train.trainer import Trainer, TrainerConfig
    from ..utils.config import load_json
    from ..utils.device import resolve_device

    cfg = _cli_config(args, load_json(TrainCliConfig, args.config) if args.config else TrainCliConfig())
    dev = resolve_device(args.device)
    if "," in args.train_dir:
        raise SystemExit("several --train-dir corpora are not ported yet; pass one directory")
    mcfg = tsvad_config(cfg)
    model = TSVADModel(mcfg, dtype="bf16" if cfg.bf16 else "fp32", device=dev, seed=cfg.seed)
    if args.encoder_ckpt:
        _load_encoder(model, args.encoder_ckpt)
    store = EmbeddingStore.load(args.emb_store)  # a comma list merges stores
    common = dict(rs_len=cfg.rs_len, rate=cfg.sample_rate, max_speakers=mcfg.max_num_speaker,
                  enhancer=cfg.enhancer or None)
    train_ds = TSVADChunkDataset(args.train_dir, store, segment_shift=cfg.segment_shift, is_train=True,
                                 seed=cfg.seed, noise_dir=args.noise_dir, rir_dir=args.rir_dir, **common)
    valid_ds = None
    if args.valid_dir:
        valid_ds = TSVADChunkDataset(args.valid_dir, store, segment_shift=cfg.rs_len, is_train=False, **common)
    T = int(cfg.rs_len * 25)
    tcfg = TrainerConfig(
        optimizer=cfg.optimizer, learning_rate=cfg.learning_rate, schedule=cfg.schedule, d_model=cfg.d_model,
        warmup_steps=cfg.warmup_steps, total_steps=cfg.num_steps, grad_clip_norm=cfg.grad_clip_norm,
        grad_accum_steps=cfg.grad_accum_steps, model_avg_decay=cfg.model_avg_decay or None, seed=cfg.seed,
    )
    trainer = Trainer(model, make_tsvad_loss(T, cfg.freeze_encoder), tcfg)
    mgr = CheckpointManager(args.exp_dir, max_to_keep=args.max_to_keep)
    with open(os.path.join(args.exp_dir, TRAIN_CONFIG), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)
    if args.resume and mgr.latest_step() is not None:
        trainer.load_state_dict(mgr.restore())
        logging.info("resumed from step %d", trainer.step)
    logging.info("training %s on %s (%s): %d train windows, %d valid", cfg.family, dev, model.dtype,
                 len(train_ds), len(valid_ds) if valid_ds else 0)
    run_training(
        trainer,
        lambda ep: tsvad_batch_iterator(train_ds, cfg.batch_size, True, cfg.seed, epoch=ep),
        cfg.num_steps,
        (lambda: tsvad_batch_iterator(valid_ds, cfg.batch_size, False)) if valid_ds else None,
        mgr,
        log_every=cfg.log_every,
        valid_every=cfg.valid_every,
        metrics_path=os.path.join(args.exp_dir, "metrics.jsonl"),
        profile_dir=args.profile_dir,
    )
    logging.info("training done at step %d; checkpoints in %s", trainer.step, args.exp_dir)
    return 0


def _model_from_exp_dir(args, dev):
    """(model, rs_len) from a `train` run: its config, --set, and the
    chosen checkpoint's weights (optionally the mean of the last K)."""
    from ..models.tsvad import TSVADModel
    from ..train.checkpoints import CheckpointManager, average_checkpoints
    from ..utils.config import load_json

    saved = os.path.join(args.exp_dir, TRAIN_CONFIG)
    cfg = _cli_config(args, load_json(TrainCliConfig, saved) if os.path.exists(saved) else TrainCliConfig())
    model = TSVADModel(tsvad_config(cfg), dtype="bf16" if (cfg.bf16 or args.bf16) else "fp32", device=dev)
    mgr = CheckpointManager(args.exp_dir)
    step = args.step or mgr.best_step() or mgr.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoints in {args.exp_dir}")
    model.load_state_dict(mgr.restore(step)["model"])
    logging.info("restored step %s", step)
    if args.avg_last and args.avg_last > 1:
        steps = mgr.all_steps()[-args.avg_last :]
        names = [n for n, _ in model.named_parameters()]
        model.load_state_dict(average_checkpoints(mgr, steps, names), strict=False)
        logging.info("averaged %d checkpoints: %s", len(steps), steps)
    return model, cfg.rs_len


def cmd_infer(args) -> int:
    from ..data.rttm import write_rttm
    from ..data.tsvad_dataset import TSVADChunkDataset
    from ..infer.chunked import make_tsvad_predict, tsvad_infer_dataset
    from ..infer.embeddings import EmbeddingStore
    from ..models.tsvad import TSVADModel
    from ..postproc import probs_to_turns
    from ..utils.convert import load_flax_npz, tsvad_from_flax
    from ..utils.device import resolve_device

    if args.family != "tsvad":
        raise SystemExit(f"family {args.family!r} is not ported yet; only 'tsvad' is")
    if bool(args.exp_dir) == bool(args.params):
        raise SystemExit("infer needs one of --exp-dir (a `train` run) and --params (a flax npz)")
    dev = resolve_device(args.device)
    if args.exp_dir:
        model, rs_len = _model_from_exp_dir(args, dev)
    else:
        model = TSVADModel(_load_config(args.config, args.set), dtype="bf16" if args.bf16 else "fp32", device=dev)
        model.load_state_dict(tsvad_from_flax(load_flax_npz(args.params)))
        rs_len = 4.0
        logging.info("loaded %s on %s (%s)", args.params, model.device, model.dtype)
    rs_len = args.rs_len or rs_len
    cfg = model.cfg

    store = EmbeddingStore.load(args.emb_store)  # a comma list merges stores
    ds = TSVADChunkDataset(
        args.data_dir, store, rs_len=rs_len, segment_shift=args.infer_shift,
        max_speakers=cfg.max_num_speaker, rate=cfg.sample_rate, label_rate=cfg.label_rate,
    )
    T = int(rs_len * cfg.label_rate)
    probs = tsvad_infer_dataset(make_tsvad_predict(model, T), ds, batch_size=BATCH_SIZE)
    fs = 1.0 / cfg.label_rate
    spk_names = ds.rec_speakers  # real speaker names in the RTTM

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
                print(f"threshold {th:.2f}: {res.summary()}")
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


def cmd_score(args) -> int:
    from ..score import score_der

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
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="speaker_diarization_tpu_torch.cli", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a model (TS-VAD) with periodic validation and checkpoints")
    t.add_argument("--family", default="tsvad", help="model family; only 'tsvad' is ported")
    t.add_argument("--config", help="TrainCliConfig as JSON (field → value)")
    t.add_argument("--set", action="append", default=[], help="TrainCliConfig override key=value")
    t.add_argument("--train-dir", required=True)
    t.add_argument("--valid-dir")
    t.add_argument("--exp-dir", required=True)
    t.add_argument("--emb-store", required=True, help="target-speaker embedding npz (comma list merges)")
    t.add_argument("--encoder-ckpt", help="pretrained CAM++: export-encoder .npz or a wespeaker torch state dict")
    t.add_argument("--noise-dir", help="Kaldi dir of noise wavs for additive-noise augmentation")
    t.add_argument("--rir-dir", help="Kaldi dir of RIR wavs for reverberation")
    t.add_argument("--max-to-keep", type=int, default=5)
    t.add_argument("--resume", action="store_true", help="resume from the latest checkpoint in --exp-dir")
    t.add_argument("--profile-dir", help="write a torch.profiler trace of a few steps into this dir")
    t.add_argument("--device", help="torch device (default: cuda; pass 'cpu' to run on the CPU)")
    t.set_defaults(fn=cmd_train)

    i = sub.add_parser("infer", help="run overlap-voted TS-VAD inference → RTTM")
    i.add_argument("--family", default="tsvad", help="model family; only 'tsvad' is ported")
    i.add_argument("--config", help="with --params: TSVADConfig as JSON; default: the full-size TSVADConfig()")
    i.add_argument("--set", action="append", default=[],
                   help="key=value override of the TSVADConfig (--params) or of the run's TrainCliConfig (--exp-dir)")
    i.add_argument("--data-dir", required=True)
    i.add_argument("--emb-store", required=True, help="target-speaker embedding npz (comma list merges)")
    i.add_argument("--params", help=_PARAMS_HELP)
    i.add_argument("--exp-dir", help="a `train` run: restore its best (else latest) checkpoint")
    i.add_argument("--step", type=int, help="with --exp-dir: restore this step")
    i.add_argument("--avg-last", type=int, default=0, help="with --exp-dir: average the last K checkpoints")
    i.add_argument("--out", required=True)
    i.add_argument("--threshold", type=float, default=0.5)
    i.add_argument("--median", type=int, default=11)
    i.add_argument("--rs-len", type=float, help="window seconds (default: the run's rs_len, else 4)")
    i.add_argument("--infer-shift", type=float, default=1.0)
    i.add_argument("--threshold-sweep", action="store_true", help="write RTTMs for thresholds 0.2..0.98")
    i.add_argument("--ref", help="reference RTTM for sweep scoring")
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
    sc.set_defaults(fn=cmd_score)
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
