#!/usr/bin/env bash
# The hermetic DER leaderboard (recipes/hermetic_leaderboard.sh) on the
# PyTorch/CUDA port, flag for flag, on the shared simulated corpus of
# recipes/hermetic_tsvad_full_stack_torch.sh (run its stages 1-3 first:
# corpus, encoder.npz and the embedding stores).
#
#   families the port runs (one training + inference stage each):
#     m2f        EEND-M2F set prediction (true ×10 backbone)
#     fs_eend    frame-streaming online EEND
#     eend_vc    chunked EEND + speaker-vector clustering
#     sond       powerset SOND (ConvEncoder profiles + SANM CD scorer)
#     ssnd       seq2seq neural diarization (simu mixer training)
#     ots_vad    enrollment-free online TS-VAD
#     tsvad3     TS-VAD with online enrollment-waveform embeddings
#     tsvad_rev  TS-VAD trained with image-source RIR reverberation
#     eend       EEND on the shared 3-speaker corpus
#     ecapa      TS-VAD with a scratch-initialised ECAPA-TDNN speech encoder
#     vbx        PLDA from the encoder's embeddings, spectral init + VBx
#     enhancer_eval  the flagship TS-VAD on a 2 dB-SNR copy of the test set,
#                without and with the learned enhancer
#   m2f, fs_eend, ssnd and ots_vad need only stage 1 (the corpus and the
#   noises); vbx stages 1-3 (encoder.npz); enhancer_eval stages 1-4 (the
#   flagship TS-VAD in $WORK/tsvad).
#
# Runs on one CUDA GPU through the port's CLI:
#   WORK=exp/hermetic_tsvad_torch bash recipes/hermetic_leaderboard_torch.sh [families...]
set -euo pipefail

work=${WORK:-exp/hermetic_tsvad_torch}
rate=8000
cli="python -m speaker_diarization_tpu_torch.cli"
steps=${STEPS:-4000}
steps5=${STEPS5:-5000}
families=${@:-m2f fs_eend eend_vc sond ssnd ots_vad tsvad3 tsvad_rev}

run_family() {
  local fam=$1
  case "$fam" in
  m2f)
    $cli train --family eend_m2f --train-dir "$work/train/data" \
      --valid-dir "$work/valid/data" --exp-dir "$work/m2f" --resume \
      --set sample_rate=$rate --set n_speakers=3 \
      --set d_model=256 --set d_ff=1024 --set n_layers=4 --set n_heads=4 \
      --set chunk_frames=500 --set batch_size=16 --set num_steps=$steps \
      --set optimizer=adam --set schedule=poly --set learning_rate=2e-4 \
      --set warmup_steps=400 --set bf16=true \
      --set log_every=20 --set valid_every=500
    $cli infer --family eend_m2f --data-dir "$work/test/data" \
      --exp-dir "$work/m2f" --out "$work/hyp_m2f.rttm" \
      --threshold-sweep --ref "$work/test/data/rttm" \
      --set sample_rate=$rate --set n_speakers=3 \
      --set d_model=256 --set d_ff=1024 --set n_layers=4 --set n_heads=4 \
      --set chunk_frames=500
    ;;
  fs_eend)
    $cli train --family fs_eend --train-dir "$work/train/data" \
      --valid-dir "$work/valid/data" --exp-dir "$work/fs_eend" --resume \
      --set sample_rate=$rate --set n_speakers=3 --set n_mels=23 \
      --set d_model=256 --set d_ff=1024 --set n_layers=4 --set n_heads=4 \
      --set chunk_frames=500 --set batch_size=16 --set num_steps=$steps5 \
      --set optimizer=adam --set schedule=noam --set learning_rate=1.0 \
      --set warmup_steps=1000 --set bf16=true \
      --set log_every=20 --set valid_every=500
    $cli infer --family fs_eend --data-dir "$work/test/data" \
      --exp-dir "$work/fs_eend" --out "$work/hyp_fs_eend.rttm" \
      --threshold-sweep --ref "$work/test/data/rttm" \
      --set sample_rate=$rate --set n_speakers=3 --set n_mels=23 \
      --set d_model=256 --set d_ff=1024 --set n_layers=4 --set n_heads=4 \
      --set chunk_frames=500
    ;;
  ssnd)
    # round-5 protocol: dual simu+real training (the round-4 simu-only
    # model failed decode even with oracle enrollment — domain gap), longer
    # budget, arcface weight 0.05, two-pass offline rescore at infer
    $cli train --family ssnd --train-dir "$work/src" \
      --real-data-dir "$work/train/data" \
      --exp-dir "$work/ssnd_r5" --resume \
      --set sample_rate=$rate --set rs_len=4.0 \
      --set encoder_blocks=4,8,4 \
      --set batch_size=16 --set num_steps=8000 \
      --set optimizer=adam --set schedule=poly --set learning_rate=2e-4 \
      --set warmup_steps=400 --set bf16=true \
      --set ssnd_arcface_weight=0.05 \
      --set log_every=50 --set valid_every=100000
    $cli infer --family ssnd --data-dir "$work/test/data" \
      --exp-dir "$work/ssnd_r5" --out "$work/hyp_ssnd.rttm" \
      --threshold-sweep --ssnd-rescore --ref "$work/test/data/rttm" \
      --set sample_rate=$rate --set rs_len=4.0 --set encoder_blocks=4,8,4
    ;;
  ots_vad)
    $cli train --family ots_vad --train-dir "$work/train/data" \
      --valid-dir "$work/valid/data" --exp-dir "$work/ots_vad" --resume \
      --noise-dir "$work/noise" \
      --set sample_rate=$rate --set n_mels=80 --set n_speakers=4 \
      --set rs_len=4.0 --set segment_shift=2.0 \
      --set encoder_blocks=2,2,2,2 --set d_model=192 --set n_layers=4 \
      --set n_heads=4 --set d_ff=512 \
      --set batch_size=16 --set num_steps=$steps \
      --set optimizer=adam --set schedule=poly --set learning_rate=2e-4 \
      --set warmup_steps=400 --set bf16=true \
      --set log_every=20 --set valid_every=500
    $cli infer --family ots_vad --data-dir "$work/test/data" \
      --exp-dir "$work/ots_vad" --out "$work/hyp_ots_vad.rttm" \
      --threshold-sweep --ref "$work/test/data/rttm" \
      --set sample_rate=$rate --set n_mels=80 --set n_speakers=4 \
      --set rs_len=4.0 --set encoder_blocks=2,2,2,2 --set d_model=192 \
      --set n_layers=4 --set n_heads=4 --set d_ff=512
    ;;
  tsvad_rev)
    # reverb-aug variant: train-time convolution with image-source
    # shoebox-room RIRs (data/room.py, genrir.py semantics)
    python - <<'PYEOF'
import os
from speaker_diarization_tpu_torch.data.simulate import synthesize_rir_corpus
work = os.environ.get("WORK", "exp/hermetic_tsvad_torch")
d = os.path.join(work, "rir_image")
if not os.path.exists(os.path.join(d, "wav.scp")):
    synthesize_rir_corpus(d, n_rirs=8, rate=8000, seed=7, method="image_source")
    print("made image-source RIRs:", d)
PYEOF
    $cli train --family tsvad --train-dir "$work/train/data" --valid-dir "$work/valid/data" \
      --exp-dir "$work/tsvad_rev" --emb-store "$work/train/embs.npz,$work/valid/embs.npz" \
      --encoder-ckpt "$work/encoder.npz" --noise-dir "$work/noise" \
      --rir-dir "$work/rir_image" --resume \
      --set sample_rate=$rate --set n_mels=80 --set encoder_blocks=12,24,16 \
      --set rs_len=4.0 --set segment_shift=2.0 --set batch_size=64 \
      --set num_steps=$steps --set optimizer=adam --set schedule=poly \
      --set learning_rate=2e-4 --set warmup_steps=400 --set bf16=true \
      --set log_every=20 --set valid_every=500
    $cli infer --family tsvad --data-dir "$work/test/data" --exp-dir "$work/tsvad_rev" \
      --emb-store "$work/test/embs.npz" --out "$work/hyp_tsvad_rev.rttm" \
      --threshold-sweep --ref "$work/test/data/rttm" \
      --set sample_rate=$rate --set n_mels=80 --set encoder_blocks=12,24,16 \
      --set rs_len=4.0
    ;;
  eend_vc)
    $cli train --family eend_vc --train-dir "$work/train/data" \
      --valid-dir "$work/valid/data" --exp-dir "$work/eend_vc" --resume \
      --set sample_rate=$rate --set n_speakers=3 --set n_mels=23 \
      --set d_model=256 --set d_ff=1024 --set n_layers=4 --set n_heads=4 \
      --set chunk_frames=200 --set batch_size=32 --set num_steps=$steps5 \
      --set optimizer=adam --set schedule=noam --set learning_rate=1.0 \
      --set warmup_steps=1000 --set bf16=true \
      --set log_every=20 --set valid_every=250
    # est_nspk=oracle decoding mode + raised silent-channel threshold
    # (reference infer_vector_cluster.py oracle speaker-count option).
    # --step pins the LATEST checkpoint: valid BCE does not track the
    # speaker-vector/clustering quality of this family (the JAX recipe's
    # measurement: 21.15% at best-valid vs 16.79% at latest). The port's
    # checkpoints are step_<10 digits>.pt.
    last_step=$(ls -d "$work/eend_vc"/step_* 2>/dev/null | sed 's/.*step_0*//; s/\.pt$//' | sort -n | tail -1)
    $cli infer --family eend_vc --data-dir "$work/test/data" \
      --exp-dir "$work/eend_vc" --out "$work/hyp_eend_vc.rttm" \
      --threshold-sweep --ref "$work/test/data/rttm" \
      --num-spks -1 --sil-spk-th 0.2 ${last_step:+--step $last_step} \
      --set sample_rate=$rate --set n_speakers=3 --set n_mels=23 \
      --set d_model=256 --set d_ff=1024 --set n_layers=4 --set n_heads=4 \
      --set chunk_frames=200
    ;;
  sond)
    $cli train --family sond --train-dir "$work/train/data" \
      --valid-dir "$work/valid/data" --exp-dir "$work/sond" --resume \
      --emb-store "$work/train/embs.npz,$work/valid/embs.npz" \
      --set sample_rate=$rate --set n_mels=80 --set n_speakers=4 \
      --set rs_len=4.0 --set segment_shift=2.0 --set d_model=256 \
      --set encoder_blocks=2,2,2,2 \
      --set batch_size=16 --set num_steps=$steps \
      --set optimizer=adam --set schedule=poly --set learning_rate=2e-4 \
      --set warmup_steps=400 --set bf16=true \
      --set log_every=20 --set valid_every=500
    $cli infer --family sond --data-dir "$work/test/data" \
      --exp-dir "$work/sond" --emb-store "$work/test/embs.npz" \
      --out "$work/hyp_sond.rttm" \
      --threshold-sweep --ref "$work/test/data/rttm" \
      --set sample_rate=$rate --set n_mels=80 --set n_speakers=4 \
      --set rs_len=4.0 --set d_model=256 --set encoder_blocks=2,2,2,2
    ;;
  tsvad3)
    $cli train --family tsvad3 --train-dir "$work/train/data" \
      --valid-dir "$work/valid/data" --exp-dir "$work/tsvad3" --resume \
      --target-audio-dir "$work/train/targets/target_audio" \
      --valid-target-audio-dir "$work/valid/targets/target_audio" \
      --encoder-ckpt "$work/encoder.npz" --noise-dir "$work/noise" \
      --set sample_rate=$rate --set n_mels=80 --set encoder_blocks=12,24,16 \
      --set rs_len=4.0 --set ts_len=3.0 --set segment_shift=2.0 \
      --set batch_size=16 --set num_steps=$steps \
      --set optimizer=adam --set schedule=poly --set learning_rate=2e-4 \
      --set warmup_steps=400 --set bf16=true \
      --set log_every=20 --set valid_every=500
    $cli infer --family tsvad3 --data-dir "$work/test/data" \
      --exp-dir "$work/tsvad3" \
      --target-audio-dir "$work/test/targets/target_audio" \
      --out "$work/hyp_tsvad3.rttm" \
      --threshold-sweep --ref "$work/test/data/rttm" \
      --set sample_rate=$rate --set n_mels=80 --set encoder_blocks=12,24,16 \
      --set rs_len=4.0 --set ts_len=3.0
    ;;
  eend)
    # re-base the EEND row on the shared 3-speaker corpus (round-3 table
    # mixed a 2-speaker round-2 row in; VERDICT r3 missing #4)
    $cli train --family eend --train-dir "$work/train/data" \
      --valid-dir "$work/valid/data" --exp-dir "$work/eend3" --resume \
      --set sample_rate=$rate --set n_speakers=3 --set n_mels=23 \
      --set d_model=256 --set d_ff=1024 --set n_layers=4 --set n_heads=4 \
      --set chunk_frames=500 --set batch_size=32 --set num_steps=$steps5 \
      --set optimizer=adam --set schedule=noam --set learning_rate=1.0 \
      --set warmup_steps=1000 --set bf16=true \
      --set log_every=20 --set valid_every=500
    $cli infer --family eend --data-dir "$work/test/data" \
      --exp-dir "$work/eend3" --out "$work/hyp_eend3.rttm" \
      --threshold-sweep --ref "$work/test/data/rttm" \
      --set sample_rate=$rate --set n_speakers=3 --set n_mels=23 \
      --set d_model=256 --set d_ff=1024 --set n_layers=4 --set n_heads=4 \
      --set chunk_frames=500
    ;;
  ecapa)
    # non-CAM++ speech encoder trained through the TS-VAD path end-to-end
    # (VERDICT r3 #6): scratch-initialized ECAPA-TDNN trunk
    $cli train --family tsvad --train-dir "$work/train/data" --valid-dir "$work/valid/data" \
      --exp-dir "$work/tsvad_ecapa" --emb-store "$work/train/embs.npz,$work/valid/embs.npz" \
      --noise-dir "$work/noise" --resume \
      --set speech_encoder_type=ecapa --set sample_rate=$rate --set n_mels=80 \
      --set rs_len=4.0 --set segment_shift=2.0 --set batch_size=32 \
      --set num_steps=$steps --set optimizer=adam --set schedule=poly \
      --set learning_rate=2e-4 --set warmup_steps=400 --set bf16=true \
      --set log_every=20 --set valid_every=500
    $cli infer --family tsvad --data-dir "$work/test/data" --exp-dir "$work/tsvad_ecapa" \
      --emb-store "$work/test/embs.npz" --out "$work/hyp_tsvad_ecapa.rttm" \
      --threshold-sweep --ref "$work/test/data/rttm" \
      --set speech_encoder_type=ecapa --set sample_rate=$rate --set n_mels=80 \
      --set rs_len=4.0
    ;;
  vbx)
    # diarizen's default clustering as a baseline row: PLDA from the
    # self-trained encoder's embeddings over the labeled source utterances,
    # spectral init + VBx resegmentation
    $cli estimate-plda --data-dir "$work/src" --out "$work/plda.npz" \
      --encoder campplus --encoder-ckpt "$work/encoder.npz" --rate $rate \
      --plda-dim 64
    $cli cluster --data-dir "$work/test/data" --out "$work/hyp_vbx.rttm" \
      --method vbx --plda "$work/plda.npz" --sad oracle \
      --encoder campplus --encoder-ckpt "$work/encoder.npz" --rate $rate \
      --ref "$work/test/data/rttm" -c 0.25
    ;;
  enhancer_eval)
    # the learned denoiser's effect on DER: corrupt the held-out test
    # mixtures at low SNR, score the flagship with and without enhancement
    # at inference
    WORK="$work" python - <<'PYEOF'
import os
import numpy as np
from speaker_diarization_tpu_torch.data.kaldi_io import KaldiData, save_data_dir
from speaker_diarization_tpu_torch.data.wav import read_wav, write_wav

work = os.environ.get("WORK", "exp/hermetic_tsvad_torch")
rate = 8000
src = KaldiData(os.path.join(work, "test", "data"))
noise_kd = KaldiData(os.path.join(work, "noise"))
noises = sorted(noise_kd.wavs)
outdir = os.path.join(work, "test_noisy")
os.makedirs(os.path.join(outdir, "wav"), exist_ok=True)
rng = np.random.default_rng(11)
wavs = {}
for i, rec in enumerate(sorted(src.wavs)):
    a, r = read_wav(src.wavs[rec]) if not src.wavs[rec].endswith("|") else (None, None)
    assert r == rate
    n, nr = read_wav(noise_kd.wavs[noises[i % len(noises)]])
    if n.ndim > 1:
        n = n[:, 0]
    reps = len(a) // len(n) + 1
    n = np.tile(n, reps)[: len(a)]
    snr = 2.0  # hard condition
    sp, npow = np.mean(a ** 2) + 1e-12, np.mean(n ** 2) + 1e-12
    noisy = a + n * np.sqrt(10 ** (-snr / 10) * sp / npow)
    path = os.path.join(outdir, "wav", rec + ".wav")
    write_wav(path, noisy.astype(np.float32), rate)
    wavs[rec] = path
datadir = os.path.join(outdir, "data")
save_data_dir(datadir, wavs)
import shutil
shutil.copy(os.path.join(work, "test", "data", "rttm"), os.path.join(datadir, "rttm"))
print("noisy test set:", datadir)
PYEOF
    # train and export the enhancer if absent
    if [ ! -f "$work/enhancer.npz" ]; then
      $cli train --family enhance --train-dir "$work/src" --noise-dir "$work/noise" \
        --exp-dir "$work/enh" --resume \
        --set sample_rate=$rate --set batch_size=16 --set num_steps=1500 \
        --set optimizer=adam --set schedule=poly --set learning_rate=2e-4 \
        --set warmup_steps=200 --set bf16=true --set log_every=50 --set valid_every=100000
      $cli export-enhancer --exp-dir "$work/enh" --out "$work/enhancer.npz"
    fi
    $cli infer --family tsvad --data-dir "$work/test_noisy/data" --exp-dir "$work/tsvad" \
      --emb-store "$work/test/embs.npz" --out "$work/hyp_noisy_plain.rttm" \
      --threshold-sweep --ref "$work/test_noisy/data/rttm" \
      --set sample_rate=$rate --set n_mels=80 --set encoder_blocks=12,24,16 --set rs_len=4.0
    $cli infer --family tsvad --data-dir "$work/test_noisy/data" --exp-dir "$work/tsvad" \
      --emb-store "$work/test/embs.npz" --out "$work/hyp_noisy_enh.rttm" \
      --threshold-sweep --ref "$work/test_noisy/data/rttm" \
      --set sample_rate=$rate --set n_mels=80 --set encoder_blocks=12,24,16 --set rs_len=4.0 \
      --set enhancer=neural:$work/enhancer.npz --set enhance_prob=1.0
    ;;
  *)
    echo "unknown family: $fam" >&2
    exit 1
    ;;
  esac
}

for fam in $families; do
  echo "=== leaderboard family: $fam ==="
  rc=0
  run_family "$fam" || rc=$?
  if [ $rc -eq 0 ]; then
    echo "=== family $fam DONE ==="
  else
    echo "=== family $fam FAILED (continuing) ==="
  fi
done
