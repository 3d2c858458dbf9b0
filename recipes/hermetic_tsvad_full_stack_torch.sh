#!/usr/bin/env bash
# The hermetic TS-VAD stack (recipes/hermetic_tsvad_full_stack.sh) on the
# PyTorch/CUDA port, same stages, corpora, seeds and settings:
#
#   stage 1  simulate train/valid/test meeting corpora (shared voice pool)
#   stage 2  pretrain the CAM++ speaker encoder (AAM-softmax, train --family spk)
#   stage 3  export encoder; oracle-RTTM target prep; enrollment embeddings
#   stage 4  train TS-VAD from the pretrained encoder
#   stage 5  chunked inference + threshold sweep + DER on held-out meetings
#
# Runs on one CUDA GPU (the port's entry points refuse to fall back to the
# CPU); everything goes through the port's CLI, no external data or weights.
#   bash recipes/hermetic_tsvad_full_stack_torch.sh [stage] [stop_stage]
set -euo pipefail

stage=${1:-1}
stop_stage=${2:-5}
work=${WORK:-exp/hermetic_tsvad_torch}
rate=8000
mels=80
blocks="12,24,16"

mkdir -p "$work"
cli="python -m speaker_diarization_tpu_torch.cli"

if [ "$stage" -le 1 ] && [ "$stop_stage" -ge 1 ]; then
  python - "$work" <<'EOF'
import sys, os
work = sys.argv[1]
from speaker_diarization_tpu_torch.data.simulate import (
    synthesize_speaker_corpus, synthesize_noise_corpus, random_mixture_specs, make_mixtures)
src = synthesize_speaker_corpus(os.path.join(work, "src"), n_speakers=32, utts_per_speaker=10, rate=8000, seed=0)
noise = synthesize_noise_corpus(os.path.join(work, "noise"), rate=8000, seed=1)
for split, n, seed in [("train", 400, 10), ("valid", 30, 20), ("test", 40, 30)]:
    out = os.path.join(work, split)
    if os.path.exists(os.path.join(out, "data", "rttm")):
        print("skip", split); continue
    specs = random_mixture_specs(src, noise, None, n_mixtures=n, n_speakers=3,
                                 min_utts=6, max_utts=12, sil_scale=1.5,
                                 noise_snrs=(10.0, 20.0), speech_rvb_probability=0.0, seed=seed)
    make_mixtures(specs, os.path.join(out, "data"), os.path.join(out, "wav"), 8000)
    print("made", split)
EOF
fi

if [ "$stage" -le 2 ] && [ "$stop_stage" -ge 2 ]; then
  $cli train --family spk --train-dir "$work/src" --exp-dir "$work/spk" --resume \
    --noise-dir "$work/noise" \
    --set sample_rate=$rate --set n_mels=$mels --set spk_dur=2.0 \
    --set aam_margin=0.3 \
    --set encoder_blocks=$blocks --set batch_size=64 --set num_steps=2000 \
    --set optimizer=adam --set schedule=poly --set learning_rate=1e-3 \
    --set warmup_steps=200 --set bf16=true \
    --set log_every=50 --set valid_every=100000
fi

if [ "$stage" -le 3 ] && [ "$stop_stage" -ge 3 ]; then
  $cli export-encoder --exp-dir "$work/spk" --out "$work/encoder.npz" \
    --set n_mels=$mels --set encoder_blocks=$blocks
  for split in train valid test; do
    $cli prepare-targets --rttm "$work/$split/data/rttm" \
      --data-dir "$work/$split/data" --out "$work/$split/targets"
    $cli extract-embeddings --data-dir "$work/$split/targets" \
      --out "$work/$split/embs.npz" --encoder-ckpt "$work/encoder.npz" \
      --rate $rate --window 6.0 --hop 1.0
  done
fi

if [ "$stage" -le 4 ] && [ "$stop_stage" -ge 4 ]; then
  $cli train --family tsvad --train-dir "$work/train/data" --valid-dir "$work/valid/data" \
    --exp-dir "$work/tsvad" --emb-store "$work/train/embs.npz,$work/valid/embs.npz" \
    --encoder-ckpt "$work/encoder.npz" --noise-dir "$work/noise" --resume \
    --set sample_rate=$rate --set n_mels=$mels --set encoder_blocks=$blocks \
    --set rs_len=4.0 --set segment_shift=2.0 --set batch_size=64 \
    --set num_steps=4000 --set optimizer=adam --set schedule=poly \
    --set learning_rate=2e-4 --set warmup_steps=400 --set bf16=true \
    --set log_every=20 --set valid_every=500
fi

if [ "$stage" -le 5 ] && [ "$stop_stage" -ge 5 ]; then
  $cli infer --family tsvad --data-dir "$work/test/data" --exp-dir "$work/tsvad" \
    --emb-store "$work/test/embs.npz" --out "$work/test_hyp.rttm" \
    --threshold-sweep --ref "$work/test/data/rttm" \
    --set sample_rate=$rate --set n_mels=$mels --set encoder_blocks=$blocks \
    --set rs_len=4.0
fi
