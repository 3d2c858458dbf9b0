#!/usr/bin/env bash
# recipes/hermetic_streaming_and_eda.sh on the PyTorch/CUDA port, same
# stages, settings and seeds, every command through the port's CLI.
# Follow-on to hermetic_tsvad_full_stack_torch.sh (expects its WORK dir;
# stages 1-3 there make the corpora, encoder.npz and the embedding stores):
#
#   stage 1  train streaming TS-VAD on the same corpus/embeddings
#   stage 2  chunk-by-chunk streaming decode + threshold sweep + DER
#   stage 3  train EEND-EDA on the mixtures (no enrollment)
#   stage 4  EDA chunked inference + threshold sweep + DER
#
# The hermetic analogue of run_ts_vad2_streaming.sh and the eend_eda recipe:
# offline vs streaming DER on identical data, plus the enrollment-free
# attractor family as a second point of comparison. Runs on one CUDA GPU
# (the port's entry points refuse to fall back to the CPU):
#   WORK=exp/hermetic_tsvad_torch bash recipes/hermetic_streaming_and_eda_torch.sh [stage] [stop_stage]
set -euo pipefail

#   stage 5  train TS-VAD with mamba2 (SSD) backends on the same data
#   stage 6  mamba2 TS-VAD inference + threshold sweep + DER
#
stage=${1:-1}
stop_stage=${2:-6}
work=${WORK:-exp/hermetic_tsvad_torch}
rate=8000
steps=${STEPS:-4000}
steps5=${STEPS5:-5000}
mels=80

cli="python -m speaker_diarization_tpu_torch.cli"

stream_cfg=(--set sample_rate=$rate --set n_mels=$mels --set rs_len=4.0
  --set d_model=256 --set d_ff=1024 --set n_layers=2 --set n_heads=4
  --set streaming_chunk_size=16 --set streaming_left_chunks=4)

if [ "$stage" -le 1 ] && [ "$stop_stage" -ge 1 ]; then
  $cli train --family tsvad_streaming --train-dir "$work/train/data" \
    --valid-dir "$work/valid/data" --exp-dir "$work/stream" \
    --emb-store "$work/train/embs.npz,$work/valid/embs.npz" \
    --noise-dir "$work/noise" --resume \
    "${stream_cfg[@]}" \
    --set segment_shift=2.0 --set batch_size=64 --set num_steps=$steps \
    --set optimizer=adam --set schedule=poly --set learning_rate=2e-4 \
    --set warmup_steps=400 --set bf16=true \
    --set log_every=20 --set valid_every=500
fi

if [ "$stage" -le 2 ] && [ "$stop_stage" -ge 2 ]; then
  $cli infer --family tsvad_streaming --data-dir "$work/test/data" \
    --exp-dir "$work/stream" --emb-store "$work/test/embs.npz" \
    --out "$work/test_hyp_stream.rttm" \
    --threshold-sweep --ref "$work/test/data/rttm" \
    "${stream_cfg[@]}"
fi

eda_cfg=(--set sample_rate=$rate --set n_mels=23 --set d_model=192
  --set d_ff=768 --set n_layers=3 --set n_heads=4 --set n_speakers=3
  --set chunk_frames=300 --set subsampling=10)

if [ "$stage" -le 3 ] && [ "$stop_stage" -ge 3 ]; then
  $cli train --family eend_eda --train-dir "$work/train/data" \
    --valid-dir "$work/valid/data" --exp-dir "$work/eda" --resume \
    "${eda_cfg[@]}" \
    --set batch_size=32 --set num_steps=$steps5 \
    --set optimizer=adam --set schedule=noam --set warmup_steps=1000 \
    --set learning_rate=1.0 --set bf16=true \
    --set log_every=20 --set valid_every=500
fi

if [ "$stage" -le 4 ] && [ "$stop_stage" -ge 4 ]; then
  $cli infer --family eend_eda --data-dir "$work/test/data" \
    --exp-dir "$work/eda" --out "$work/test_hyp_eda.rttm" \
    --threshold-sweep --ref "$work/test/data/rttm" \
    "${eda_cfg[@]}"
fi

# TS-VAD with mamba2 (chunked-matmul SSD) backends — the reference's
# best-RAMC configuration (run_ts_vad2.sh:2521), exercising the
# selective-scan path end-to-end on hardware.
mamba_cfg=(--set sample_rate=$rate --set n_mels=$mels --set encoder_blocks=12,24,16
  --set rs_len=4.0 --set single_backend_type=mamba2 --set multi_backend_type=mamba2
  --set d_state=64 --set expand=2)

if [ "$stage" -le 5 ] && [ "$stop_stage" -ge 5 ]; then
  $cli train --family tsvad --train-dir "$work/train/data" --valid-dir "$work/valid/data" \
    --exp-dir "$work/tsvad_mamba2" --emb-store "$work/train/embs.npz,$work/valid/embs.npz" \
    --encoder-ckpt "$work/encoder.npz" --noise-dir "$work/noise" --resume \
    "${mamba_cfg[@]}" \
    --set segment_shift=2.0 --set batch_size=64 --set num_steps=$steps \
    --set optimizer=adam --set schedule=poly --set learning_rate=2e-4 \
    --set warmup_steps=400 --set bf16=true \
    --set log_every=20 --set valid_every=500
fi

if [ "$stage" -le 6 ] && [ "$stop_stage" -ge 6 ]; then
  $cli infer --family tsvad --data-dir "$work/test/data" --exp-dir "$work/tsvad_mamba2" \
    --emb-store "$work/test/embs.npz" --out "$work/test_hyp_mamba2.rttm" \
    --threshold-sweep --ref "$work/test/data/rttm" \
    "${mamba_cfg[@]}"
fi
