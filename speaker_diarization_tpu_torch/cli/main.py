"""Command-line interface of the PyTorch port: TS-VAD inference and scoring.

    python -m speaker_diarization_tpu_torch.cli infer --family tsvad \\
        --data-dir DIR --emb-store EMB.npz --params PARAMS.npz --out hyp.rttm \\
        [--config tsvad.json] [--rs-len 4] [--threshold-sweep --ref ref.rttm] [--device cpu]
    python -m speaker_diarization_tpu_torch.cli score --ref ref.rttm --sys hyp.rttm

Flag names and defaults follow the JAX package's CLI. `--params` takes the
JAX TSVADModel variables as one flax-layout .npz (utils/convert.py
`save_flax_npz`); reading the JAX trainer's Orbax checkpoint directories
waits for the training slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys

BATCH_SIZE = 16  # windows per forward (tsvad_infer_dataset's default)

_PARAMS_HELP = (
    "flax-layout TSVADModel variables as one .npz ('params/...' and 'batch_stats/...' keys, "
    "utils/convert.save_flax_npz). Orbax checkpoint directories of the JAX trainer are not "
    "read yet: that waits for the training slice (ROADMAP item 6)."
)


def _load_config(path):
    from ..models.tsvad import TSVADConfig

    if not path:
        return TSVADConfig()
    with open(path) as f:
        raw = json.load(f)
    fields = {f.name for f in dataclasses.fields(TSVADConfig)}
    unknown = set(raw) - fields
    if unknown:
        raise SystemExit(f"unknown TSVADConfig fields in {path}: {sorted(unknown)}")
    if "encoder_block_layers" in raw:
        raw["encoder_block_layers"] = tuple(raw["encoder_block_layers"])
    return TSVADConfig(**raw)


def cmd_infer(args) -> int:
    from ..data.rttm import write_rttm
    from ..data.tsvad_dataset import TSVADChunkDataset
    from ..infer.chunked import make_tsvad_predict, tsvad_infer_dataset
    from ..infer.embeddings import EmbeddingStore
    from ..models.tsvad import TSVADModel
    from ..postproc import probs_to_turns
    from ..utils.convert import load_flax_npz, tsvad_from_flax

    if args.family != "tsvad":
        raise SystemExit(f"family {args.family!r} is not ported yet; only 'tsvad' is")
    cfg = _load_config(args.config)
    model = TSVADModel(cfg, dtype="bf16" if args.bf16 else "fp32", device=args.device)
    model.load_state_dict(tsvad_from_flax(load_flax_npz(args.params)))
    logging.info("loaded %s on %s (%s)", args.params, model.device, model.dtype)

    store = EmbeddingStore.load(args.emb_store)
    ds = TSVADChunkDataset(
        args.data_dir, store, rs_len=args.rs_len, segment_shift=args.infer_shift,
        max_speakers=cfg.max_num_speaker, rate=cfg.sample_rate, label_rate=cfg.label_rate,
    )
    T = int(args.rs_len * cfg.label_rate)
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

    i = sub.add_parser("infer", help="run overlap-voted TS-VAD inference → RTTM")
    i.add_argument("--family", default="tsvad", help="model family; only 'tsvad' is ported")
    i.add_argument("--config", help="TSVADConfig as JSON (field → value); default: the full-size TSVADConfig()")
    i.add_argument("--data-dir", required=True)
    i.add_argument("--emb-store", required=True, help="target-speaker embedding npz (comma list merges)")
    i.add_argument("--params", required=True, help=_PARAMS_HELP)
    i.add_argument("--out", required=True)
    i.add_argument("--threshold", type=float, default=0.5)
    i.add_argument("--median", type=int, default=11)
    i.add_argument("--rs-len", type=float, default=4.0, help="window seconds (the JAX CLI's rs_len)")
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
