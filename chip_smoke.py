#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ and holds each one (K1 fbank, K1′
EEND log-mel, K2 CAM++ dense block, K3a/K3b/K3c selective scan, K4 CAM++
FCM head) against its plain PyTorch twin on the card at the shapes of the
main paths (K4 also against the cuDNN head it replaces; K2 run twice must
give the same bits; K2 also at the input widths of shallower encoders, and
bf16 TS-VAD forwards with them; K1 and K1′ run twice must give the same bits,
also at 48 kHz (n_fft 2048) and at ReDimNet's 72 and 60 bins, and ptxas's
registers and spills of each K1 instance are printed; K3a and K3c run twice must give the same bits, K3a's y
and K3b's y must be equal bit for bit, no K3a/K3b instance may spill, and
ptxas's registers and spills of each K3 instance and the SASS instruction mix
of the forward at d_state 64 are printed). Where build/prev/{cam_block,fcm}.cu
hold K2 and K4 as of commit 8cf507d, where build/prev/fbank.cu holds K1/K1′
as of commit 2eeeb87 and where build/prev/selective_scan.cu holds K3a/K3b/K3c
as of commit e35add6 (copied there from git for a call; build/ is not
committed; each optional, checked by git blob id), they are built and timed
beside the current ones, and the Mamba forward (K3a) and train step (K3b,
then K3c) are timed with each previous scan kernel in turns. It then drives,
each with the launch counts set to 0 just before and read just after:
- the full-width TS-VAD forward (TSVADConfig(), bf16, batch 64 × 4 s, seeded
  random weights): fbank 1, cam_block 3, fcm 1;
- the same with BiMamba backends (d_state 64): fbank 1, cam_block 3, fcm 1,
  selective_scan_fwd 8;
- a Mamba TS-VAD train step at the hermetic recipe's settings: fbank 1,
  selective_scan_fwd_states 8, selective_scan_bwd 8; five steps on one
  fixed batch must lower the loss;
- the same forward with BiMamba-2 (SSD) backends: fbank 1, cam_block 3,
  fcm 1 (the SSD scan is plain torch, ops/ssd.py, held on the card to its
  per-step recurrence at the single backend's shape within JAX's 1e-4);
  Mamba-2 train steps at the recipe's 8 kHz settings: fbank 1 each, five
  steps on one fixed batch must lower the loss;
- streaming TS-VAD at the second hermetic recipe's stream_cfg (8 kHz, d_model
  256, chunk 16, 4 left chunks, batch 64 × 4 s): the window decode (fbank 1)
  within 2e-4 of the offline chunk-masked forward (fp32 probabilities), the
  bf16 decode, offline forward and train steps timed (fbank 1 a step, five
  steps on one fixed batch must lower the loss);
- the full-width bf16 EEND forward and `EendEdaModel.infer` (TrainCliConfig
  widths, 8 kHz, batch 32 × one 500-frame chunk): logmel 1 each;
- EEND and EDA train steps: logmel 1 per step; five steps on one fixed
  batch must lower the loss;
- the hermetic recipe's speaker-encoder pretraining step (CAM++ 12/24/16
  with the dense head, AAM over 32 speakers, bf16, batch 64 × 2 s at 8 kHz):
  fbank 1 per step, five steps on one fixed batch must lower the loss; and
  the embedding forward `extract-embeddings` runs (fp32, batch 32 × 6 s):
  fbank 1;
- the same EEND-EDA forward, infer and train steps with the conformer
  encoder the CLI builds (GroupNorm in the conv module): logmel 1 each;
- TS-VAD with conformer single and multi backends, and with a transformer
  single and a BiLSTM multi backend (TSVADConfig() widths, bf16, batch 64 ×
  4 s): fbank 1, cam_block 3, fcm 1 a forward, held to the plain twins;
  five adam steps on one fixed batch (fbank 1 each) must lower the loss;
- TS-VAD with ECAPA-TDNN (1024 channels) at the leaderboard's ecapa stage
  settings (8 kHz, 80 bins, batch 32 × 4 s, bf16): fbank 1 a forward and a
  step, five steps on one batch must lower the loss; a ResNet34 forward
  (fbank 1); both held to the plain twin;
- speaker-encoder pretraining with ECAPA (512 channels) and ResNet34 at
  stage 2's settings: fbank 1 a step, five steps on one batch must lower
  the loss;
- [zoo] TS-VAD with every other speech encoder of TSVADConfig at full
  width (bf16, batch 32 × 4 s at 16 kHz): wavlm, wavlm_weight_sum, hubert,
  wav2vec2, mms (12 × 768 on the waveform) and whisper (large-v2, 1280 ×
  32, blocks 16-23): no kernel; w2vbert (6 × 1024), eres2netv2 and
  redimnet_b0-b6 (K1 at 80, 60 and 72 bins): fbank 1; each held to the
  plain twins and timed with the profiler's busy share; five adam steps on
  one batch must lower the loss for wavlm, w2vbert, whisper, eres2netv2 and
  redimnet_b2, whose recipe step is timed; then, in this process, `train
  --family tsvad --set speech_encoder_type=wavlm` (4 steps) → `infer
  --threshold-sweep` → `score`;
- a TS-VAD train step with remat on and off (CAM++'s dense layers
  recomputed in the backward pass): the same loss, and the peak memory
  (`torch.cuda.max_memory_allocated`) of each;
- SOND at SONDConfig() (16 profiles, 2517 powerset classes, ResNet34
  3,4,6,3, bf16, batch 16 × 4 s at 16 kHz): fbank 1 a forward and a step;
  TS-VAD3 at TSVAD3Config() (CAM++ 12/24/16 on the mixture and on 4 × 6 s
  enrollment waveforms, frame fusion): fbank 2; EEND-VC at the CLI's widths
  (batch 32 × 200 frames at 8 kHz): logmel 1; each forward held to its plain
  twin (bf16 and fp32), five adam steps on one batch must lower the loss, and
  the forward and the leaderboard's train step are timed with the
  profiler's busy share;
- the same for SSND at SSNDConfig() (CAM++ 12/24/16 frames, 4 slots, 1000
  global speakers, batch 16 × 4 s at 16 kHz): fbank 1 a forward and a step;
  EEND-M2F at the CLI's widths (8 queries, conformer k49, 16 × 500 frames at
  subsampling 1, 8 kHz): logmel 1; FS-EEND at the CLI's widths (5 channels,
  16 × 500 subsampled frames, 8 kHz): logmel 1; OTS-VAD at OTSVADConfig()
  (ResNet34 3,4,6,3): fbank 1 a 4 s forward (the online decode's embed and
  score), 2 a step on 4 s + 4 s halves; and K1′ at EEND-M2F's front-end
  (16, 40000) at subsampling 1 and context 0;
- the neural VAD at NeuralVADConfig() (fp32, batch 16 × 30 s at 16 kHz):
  logmel 1 a forward and a step; the learned enhancer at EnhancerConfig()
  (bf16, batch 16 × 2 s at 8 kHz): no kernel; each held to its plain twin,
  five adam steps on one batch must lower the loss, forward and step timed
  with the profiler's busy share; and K1′ at the VAD's front-end, (16,
  480000) at 16 kHz 400/160 and (16, 240000) at 8 kHz 200/80, 40 mels, no
  mean-norm;
then the CLI: `infer --family tsvad` + `score` from flax-layout weights,
`train --family tsvad` (Mamba, two comma-separated --train-dir corpora,
batch 64 × 4 s, bf16, with validation and checkpoints) followed by `infer
--exp-dir`, and `train --family eend` /
`eend_eda` followed by `infer --exp-dir --threshold-sweep` + `score`, on
generated corpora; and the hermetic TS-VAD recipe at full width on a small
corpus: `simulate` (a voice pool; train, valid and test mixtures of 3
speakers at 8 kHz) → `train --family spk` → `export-encoder` →
`prepare-targets` + `extract-embeddings` per split → `train --family tsvad
--encoder-ckpt` → `infer --threshold-sweep` → `score`, then the second
hermetic recipe's stages 1-2 and 5-6 on the same corpus (`train --family
tsvad_streaming` and `train --family tsvad` with BiMamba-2 backends and the
exported encoder, 4 steps each, each followed by `infer --threshold-sweep`
and `score`), the torch leaderboard's ecapa stage (4 steps, `infer
--threshold-sweep --cder`, `score --cder`), its sond, tsvad3 and eend_vc
stages (4 steps each, `infer --threshold-sweep`, `score`), `simulate-meetings` and
`config-dump` in its three formats, its m2f, fs_eend, ssnd (with
--real-data-dir and --ssnd-rescore) and ots_vad stages, its vbx stage
(`estimate-plda`, then `cluster --method vbx`, and `spectral` and `umap`,
each scored), `train --family vad` → `export-vad` → `cluster --sad
neural`, and its enhancer_eval stage (`train --family enhance` →
`export-enhancer` → the TS-VAD `infer` with `--set enhancer=neural:…`) on
the same corpus, each stage's output checked. Last:
- [parallel] the parallel layer at world size 1 on NCCL (a tcp://127.0.0.1
  init): three full-width TS-VAD train steps (TSVADConfig(), bf16, batch 64
  × 4 s, the recipe's settings) through Trainer(mesh=...) with all_reduce
  and with deterministic_reduce, each bitwise equal to the plain trainer's
  from the same weights (fbank 1 a step), timed beside it; the synced
  BatchNorm bitwise equal to the plain one; ring attention (B 2, T 4096, H
  20, D 64, fp32) forward and backward against full attention;
- [dicow] DiCoW at DiCoW v3's widths (the large-v3 encoder, 32 × 1280, 128
  mels, FDDT before every layer, CTC over 51,866 tokens; seeded weights;
  4 streams of 30 s): the bf16 forward within 5e-2 mean-abs of the fp32
  forward, timed with the profiler's busy share; five adam steps on one
  batch lower the CTC loss; the Whisper decoder (4 × 1280) greedy-decodes
  32 tokens; no kernel;
- [dicow_hermetic] JAX's tests/test_dicow_hermetic.py on the card: 400
  unconditioned and 300 conditioned steps, the held-out conditioned TER
  below 0.15 and the all-target ablation's above it + 0.2;
- [orbax] a TS-VAD run of the JAX trainer (the committed Orbax directory
  tests/fixtures/torch_orbax_tsvad: a GPU host without JAX cannot write one) read
  without orbax or tensorstore and restored through the CLI's
  `_model_from_exp_dir`: its decode time and rate, then the fp32 and bf16
  eval forwards through K1, K2 (x3) and K4 against the JAX forward's logits
  and against the plain twins.
Each phase prints one line, with the
seconds since the start, and raises on failure. The main path's first
`infer` and `score` run as `python -m speaker_diarization_tpu_torch.cli`
processes; the other CLI verbs call the same entry point in this process. The
last lines are the kernels' JSON record (each kernel's launch sites: counts
of one forward or step, and of a whole run for the CLI verbs of the recipe
chain), the card's name and power limit, and {"ok": true, "device": ...}.
Needs one CUDA device; imports nothing of JAX.
"""

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # CUDA cores, no tensor cores
H100_BF16_FLOPS = 989e12  # dense tensor cores
# exponentials on the special-function units: 16 per SM per clock (sm_90),
# 132 SMs at the 1.98 GHz boost clock of the H100 SXM
H100_EXP_PER_S = 16 * 132 * 1.98e9
# Tight mean-abs bars on the bf16 kernels' outputs against their twins, set
# between sound kernels and a misplaced rounding point (PERF.md, findings).
# K2's grown channels: sound <= 6.3e-5; a K2 whose BN of h rounded once (one
# fma) instead of after the product and after the sum read 4.8e-4 to 5.7e-4.
# K4: sound <= 1.4e-4; a planted fault in its twin (conv B's output added to
# the residual before it is rounded to bf16) reads ~9.2e-4, checked each run.
K2_ROUNDING_BAR = 2e-4
K4_ROUNDING_BAR = 3e-4


T_START = time.perf_counter()


def phase(name, msg):
    print(f"[{name} {time.perf_counter() - T_START:.1f}s] {msg}", flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(work, flops_per_s):
    """(least ms the card could take, what bounds it) for `work` = {bytes,
    flops[, exps]}: the larger of the bytes over the memory rate and the
    operations over their peak, exponentials counted at the SFU rate."""
    t_bytes = work["bytes"] / H100_BYTES_PER_S
    t_ops = max(work["flops"] / flops_per_s, work.get("exps", 0.0) / H100_EXP_PER_S)
    return 1e3 * max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


PREV_DIR = os.path.join(REPO, "build", "prev")
# the git blob ids of K2's and K4's sources at commit 8cf507d (the CUDA-core
# K2 and the unfused K4), the only versions whose C interface prev_kernels calls
PREV_BLOBS = {"cam_block": "3fbddb1eed560d4fc65ad5f56cc88d4a9a86c74b", "fcm": "36001de2ffa4fd7ef211bbc660ab412357952334"}


def prev_kernels():
    """K2 and K4 as of commit 8cf507d, for timing beside the current ones on
    the same card: built from build/prev/{cam_block,fcm}.cu where a call put
    them there (`git show 8cf507d:speaker_diarization_tpu_torch/csrc/fcm.cu >
    build/prev/fcm.cu`, and cam_block.cu; build/ is not committed), else
    None. Any other source raises: the ctypes signatures below are that
    commit's. Returns {"cam_block": fn, "fcm": fn}, each fn taking the
    current wrapper's arguments (bf16 only)."""
    import ctypes
    import hashlib

    import torch

    from speaker_diarization_tpu_torch.kernels import _build
    from speaker_diarization_tpu_torch.kernels import cam_block as K2
    from speaker_diarization_tpu_torch.kernels import fcm as K4

    srcs = {n: os.path.join(PREV_DIR, n + ".cu") for n in ("cam_block", "fcm")}
    if not all(os.path.exists(p) for p in srcs.values()):
        return None
    for n, p in srcs.items():
        with open(p, "rb") as f:
            data = f.read()
        if hashlib.sha1(b"blob %d\0" % len(data) + data).hexdigest() != PREV_BLOBS[n]:
            raise RuntimeError(f"build/prev/{n}.cu is not {n}.cu of commit 8cf507d, whose C interface the timing calls")
    nvcc = _build.nvcc_path()
    procs = {n: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", p[:-3] + ".so", p], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT) for n, p in srcs.items()}
    libs = {}
    for n, proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for build/prev/{n}.cu:\n{log}")
        libs[n] = lib = ctypes.CDLL(srcs[n][:-3] + ".so")
        lib.sdt_cuda_error_string.restype = ctypes.c_char_p
        lib.sdt_cuda_error_string.argtypes = [ctypes.c_int]
    P, I = ctypes.c_void_p, ctypes.c_int
    libs["cam_block"].sdt_cam_block_bf16.restype = I
    libs["cam_block"].sdt_cam_block_bf16.argtypes = [P] * 14 + [I] * 7 + [P]
    libs["fcm"].sdt_fcm_scratch_elems.restype = ctypes.c_size_t
    libs["fcm"].sdt_fcm_scratch_elems.argtypes = [I, I]
    libs["fcm"].sdt_fcm_bf16.restype = I
    libs["fcm"].sdt_fcm_bf16.argtypes = [P, P, ctypes.POINTER(P), ctypes.POINTER(P), P, I, I, P]

    def cam_block(x, bp, dil, seg_len=100):  # u in shared memory: T <= 656
        B, T, c0 = x.shape
        L, c_max, _ = bp["W1"].shape
        out = torch.empty((B, T, c_max), dtype=x.dtype, device=x.device)
        code = libs["cam_block"].sdt_cam_block_bf16(
            x.data_ptr(), out.data_ptr(), *[bp[k].data_ptr() for k in K2._ARGS], None, None, B, T, c0, c_max, L,
            dil, seg_len, torch.cuda.current_stream().cuda_stream)
        _build.check(libs["cam_block"], code, "previous cam_block")
        return out

    def fcm(x, flat):
        B, T, _ = x.shape
        out = torch.empty((B, T, K4.OUT_DIM), dtype=x.dtype, device=x.device)
        scratch = torch.empty(libs["fcm"].sdt_fcm_scratch_elems(B, T), dtype=x.dtype, device=x.device)
        w_ptrs = (ctypes.c_void_p * K4.N_UNITS)(*[t.data_ptr() for t in flat[0::2]])
        sb_ptrs = (ctypes.c_void_p * K4.N_UNITS)(*[t.data_ptr() for t in flat[1::2]])
        code = libs["fcm"].sdt_fcm_bf16(x.data_ptr(), out.data_ptr(), w_ptrs, sb_ptrs, scratch.data_ptr(), B, T,
                                        torch.cuda.current_stream().cuda_stream)
        _build.check(libs["fcm"], code, "previous fcm")
        return out

    return {"cam_block": cam_block, "fcm": fcm}


# the git blob ids of the previous sources that build/prev may hold, the
# only versions whose C interfaces prev_fbank and prev_scan call: fbank.cu
# at 2eeeb87 (the radix-2 K1/K1′, one CTA per 8 frames) and
# selective_scan.cu at e35add6, unchanged since cb35afa (K3c with one warp
# per channel, reading its inputs from device memory at every step; K3a/K3b
# reading x and dt from device memory at every step, exp2f, the h0 test in
# the step loop, as through 8efc171)
PREV_BUILDS = {"fbank": ("2eeeb87", "09f7470c5770cf6754f83f3f3b4fe769b9a19a99"),
               "selective_scan": ("e35add6", "53f07f44c381e6e20bc2fdc32abea960623df257")}


def start_prev(name):
    """Start building csrc/<name>.cu as of its commit in PREV_BUILDS from
    build/prev/<name>.cu, where a call put it there (`mkdir -p build/prev;
    git show <commit>:speaker_diarization_tpu_torch/csrc/<name>.cu >
    build/prev/<name>.cu`; build/ is not committed), in parallel with the
    port's own builds; None where it is absent. Any other source raises."""
    import hashlib

    from speaker_diarization_tpu_torch.kernels import _build

    src = os.path.join(PREV_DIR, name + ".cu")
    if not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        data = f.read()
    commit, blob = PREV_BUILDS[name]
    if hashlib.sha1(b"blob %d\0" % len(data) + data).hexdigest() != blob:
        raise RuntimeError(f"build/prev/{name}.cu is not {name}.cu of commit {commit}, whose C interface the timing calls")
    so = src[:-3] + ".so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so, name


def finish_prev(started):
    """(the loaded library, nvcc's log) of a `start_prev` build, or None."""
    import ctypes

    if started is None:
        return None
    proc, so, name = started
    log = proc.communicate()[0].decode(errors="replace")
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for build/prev/{name}.cu:\n{log}")
    lib = ctypes.CDLL(so)
    lib.sdt_cuda_error_string.restype = ctypes.c_char_p
    lib.sdt_cuda_error_string.argtypes = [ctypes.c_int]
    return lib, log


def _instance(kernel, line):
    """The template arguments ("64" or "64, true") of the instance of
    `kernel<int>` or `kernel<int, bool>` whose mangled name is in `line`, or None."""
    m = re.search(rf"{kernel}ILi(\d+)E(?:Lb([01])E)?", line)
    return m and m.group(1) + ("" if m.group(2) is None else ", " + ("false", "true")[int(m.group(2))])


def _by_instance(d):
    return dict(sorted(d.items(), key=lambda kv: (int(kv[0].split(",")[0]), kv[0])))


def ptxas_props(log, kernel):
    """{template arguments: ptxas's register and spill lines} of each
    instance of `kernel` in an nvcc log."""
    props, inst = {}, None
    for line in log.splitlines():
        if "entry function" in line or "properties for" in line:
            inst = _instance(kernel, line)
        if inst and re.search(r"registers|spill", line):
            props.setdefault(inst, []).append(line.split(":", 1)[-1].strip())
    return _by_instance(props)


def sass_mix(so, kernel, hot="MUFU.EX2"):
    """{template arguments: (opcode counts of the whole function, opcode
    counts of its straight-line run between two branches that holds the
    most `hot` instructions)} of each instance of `kernel` in the SASS of
    the library `so` (cuobjdump, beside nvcc), or {} where there is no
    cuobjdump. The run is an unrolled loop body: its counts over its `hot`
    count are the instructions an element costs."""
    from speaker_diarization_tpu_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    code, inst = {}, None
    for line in subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout.splitlines():
        if "Function :" in line:
            inst = _instance(kernel, line)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inst and m:
            code.setdefault(inst, []).append(m.group(1))
    mixes = {}
    for inst, ops in code.items():
        runs, run = [], []
        for op in ops:
            run.append(op)
            if op.startswith("BRA"):
                runs.append(run)
                run = []
        runs.append(run)
        count = lambda seq: {op: seq.count(op) for op in sorted(set(seq))}  # noqa: E731
        mixes[inst] = (count(ops), count(max(runs, key=lambda r: r.count(hot))))
    return _by_instance(mixes)


def prev_fbank(started):
    """The previous K1 and K1′ from `start_prev("fbank")`'s build, or None:
    {"fbank": fn(x, sr, n_mels), "logmel": fn(x, T, fs, sh, sr, n_mels)},
    on the same device constants as the current wrappers."""
    import ctypes

    import torch

    from speaker_diarization_tpu_torch.kernels import _build
    from speaker_diarization_tpu_torch.kernels import fbank as K1
    from speaker_diarization_tpu_torch.ops import features as FE

    built = finish_prev(started)
    if built is None:
        return None
    lib = built[0]
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sdt_fbank_f32.restype = I
    lib.sdt_fbank_f32.argtypes = [P] * 7 + [I] * 9 + [ctypes.c_float, ctypes.c_float, I, P]
    lib.sdt_logmel_f32.restype = I
    lib.sdt_logmel_f32.argtypes = [P] * 7 + [I] * 8 + [P]
    ptrs = lambda c: [c[k].data_ptr() for k in ("window", "tw_re", "tw_im", "mel_w", "mel_start")]  # noqa: E731

    def fbank(x, sr, n_mels):
        win, shift, n_fft = FE.frame_params(sr)
        B, N = x.shape
        T = 1 + (N - win) // shift
        c = K1._device_consts(K1._host_consts, sr, n_mels, win, n_fft, x.device)
        out = torch.empty((B, T, n_mels), dtype=torch.float32, device=x.device)
        code = lib.sdt_fbank_f32(x.data_ptr(), out.data_ptr(), *ptrs(c), B, N, T, win, shift, n_fft,
                                 n_fft.bit_length() - 1, n_mels, c["mel_w"].shape[1], 32768.0, 0.97, 1,
                                 torch.cuda.current_stream().cuda_stream)
        _build.check(lib, code, "previous fbank")
        return out

    def logmel(x, T, fs, sh, sr, n_mels):
        n_fft = FE.fft_size_for(fs)
        B, N = x.shape
        c = K1._device_consts(K1._logmel_consts, sr, n_mels, fs, n_fft, x.device)
        out = torch.empty((B, T, n_mels), dtype=torch.float32, device=x.device)
        code = lib.sdt_logmel_f32(x.data_ptr(), out.data_ptr(), *ptrs(c), B, N, T, sh, n_fft,
                                  n_fft.bit_length() - 1, n_mels, c["mel_w"].shape[1],
                                  torch.cuda.current_stream().cuda_stream)
        _build.check(lib, code, "previous logmel")
        return out

    return {"fbank": fbank, "logmel": logmel}


def prev_scan(started):
    """The previous K3a, K3b and K3c from `start_prev("selective_scan")`'s
    build, or None: {"fwd", "fwd_states", "bwd": fn with the current
    wrapper's arguments and results, "log": nvcc's log, "so": the library}."""
    import ctypes

    import torch

    from speaker_diarization_tpu_torch.kernels import _build

    built = finish_prev(started)
    if built is None:
        return None
    lib = built[0]
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sdt_selective_scan_bwd_tiles.restype = I
    lib.sdt_selective_scan_bwd_tiles.argtypes = [I]
    lib.sdt_selective_scan_bwd.restype = I
    lib.sdt_selective_scan_bwd.argtypes = [P] * 18 + [I] * 4 + [P]
    lib.sdt_selective_scan_fwd.restype = I
    lib.sdt_selective_scan_fwd.argtypes = [P] * 8 + [I] * 4 + [P]
    lib.sdt_selective_scan_chunk.restype = I
    lib.sdt_selective_scan_chunk.argtypes = []

    def scan_fwd(x, delta, A, Bm, C, D, states=False):
        Bsz, T, Dd = x.shape
        N = A.shape[1]
        y = torch.empty_like(x)
        h0 = x.new_empty((Bsz * -(-T // lib.sdt_selective_scan_chunk()), N, Dd)) if states else None
        code = lib.sdt_selective_scan_fwd(*[t.data_ptr() for t in (x, delta, A, Bm, C, D, y)],
                                          None if h0 is None else h0.data_ptr(), Bsz, T, Dd, N,
                                          torch.cuda.current_stream().cuda_stream)
        _build.check(lib, code, "previous selective_scan_fwd")
        return (y, h0) if states else y

    def scan_bwd(x, delta, A, Bm, C, D, h0, g):
        Bsz, T, Dd = x.shape
        N = A.shape[1]
        dx, ddt, dB, dC = (torch.empty_like(t) for t in (x, delta, Bm, C))
        dA, dD = torch.empty_like(A), torch.empty_like(D)
        dA_part, dD_part = x.new_empty((Bsz, Dd, N)), x.new_empty((Bsz, Dd))
        dB_part = x.new_empty((lib.sdt_selective_scan_bwd_tiles(Dd), Bsz, T, N))
        dC_part = torch.empty_like(dB_part)
        ts = (x, delta, A, Bm, C, D, h0, g, dx, ddt, dA, dB, dC, dD, dA_part, dD_part, dB_part, dC_part)
        code = lib.sdt_selective_scan_bwd(*[t.data_ptr() for t in ts], Bsz, T, Dd, N,
                                          torch.cuda.current_stream().cuda_stream)
        _build.check(lib, code, "previous selective_scan_bwd")
        return dx, ddt, dA, dB, dC, dD

    return {"fwd": scan_fwd, "fwd_states": lambda *a: scan_fwd(*a, states=True), "bwd": scan_bwd, "log": built[1],
            "so": started[1]}


def graph_ms(fn, iters=20, reps=5):
    """Device ms of one call of `fn`: `iters` calls captured in a CUDA graph,
    replayed `reps` times between two events, so that the host's dispatch of
    a short kernel does not stand in for its time."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def paired_ms(fn, prev_fn, timer=graph_ms):
    """(kernel ms, previous kernel ms or None) on the device (`timer`,
    `graph_ms` by default), timed in turns kernel, previous, previous, kernel
    on one card; each the mean of its two runs."""
    if prev_fn is None:
        return timer(fn), None
    a, b = timer(fn), timer(prev_fn)
    b2, a2 = timer(prev_fn), timer(fn)
    return (a + a2) / 2, (b + b2) / 2


def scan_phase(gen, dev, prev=None):
    """K3a/K3b/K3c against their plain twins (fp32) at the Mamba main path's
    two shapes, T = 100, d_inner 768, d_state 64: the single backend's
    B·S = 256 rows and the multi backend's 64. Each forward or train step
    launches each kernel 4 times at each shape, so the records are per
    forward (K3a) or per train step (K3b, K3c). Bars: y and h0 within
    1e-4 · max(1, max|twin|) (a few ulp of exp per step over 100 steps);
    K3a's y and K3b's y bitwise equal (one template); each gradient within
    1e-3 · max|twin gradient| (dA and dD sum 25,600 rows in another order);
    two K3a and two K3c runs must give the same bits; ptxas must report no
    spills for any scan_fwd_kernel instance. Then the ragged shapes (T not a
    multiple of the chunk, d_inner not a multiple of the block; inputs one
    float past a 16-byte boundary) at every built d_state, y, h0 and the
    gradients. `prev` is `prev_scan`'s dict or
    None: the previous K3a, K3b and K3c, each timed beside its current
    kernel in turns. → records of the three kernels."""
    import torch

    from speaker_diarization_tpu_torch.kernels import _build
    from speaker_diarization_tpu_torch.kernels import selective_scan as K3
    from speaker_diarization_tpu_torch.ops.mamba_scan import selective_scan_sequential

    phase("prev", "the previous K3a/K3b/K3c built from build/prev/selective_scan.cu for timing" if prev else
          "no build/prev/selective_scan.cu: the previous K3a/K3b/K3c are not timed")
    for what, log in (("", _build.build_log("selective_scan")), ("previous ", prev["log"] if prev else "")):
        for kernel in ("scan_fwd_kernel", "scan_bwd_kernel"):
            for inst, lines in ptxas_props(log, kernel).items():
                phase("K3", f"{what}{kernel}<{inst}>: {' | '.join(lines)}")
    # the forward's instructions an element at d_state 64: the step loop's
    # body (its longest straight run, one MUFU.EX2 a (t, d, n) element), each
    # opcode's count over its MUFU.EX2 count; and the whole function's
    for what, so in (("", _build._so_path("selective_scan")), ("previous ", prev["so"] if prev else None)):
        for inst, (ops, body) in (sass_mix(so, "scan_fwd_kernel") if so else {}).items():
            n_exp = body.get("MUFU.EX2", 0)
            if inst.startswith("64,") and n_exp:
                top = sorted(body.items(), key=lambda kv: -kv[1])[:12]
                phase("K3", f"{what}scan_fwd_kernel<{inst}> SASS: the step loop's body holds {n_exp} MUFU.EX2 and "
                      f"{sum(body.values())} instructions, {sum(body.values()) / n_exp:.2f} an element: "
                      + ", ".join(f"{op} {c / n_exp:.2f}" for op, c in top)
                      + f"; the function {sum(ops.values())} instructions, {ops.get('MUFU.EX2', 0)} MUFU.EX2")
    fwd_props = ptxas_props(_build.build_log("selective_scan"), "scan_fwd_kernel")
    if len(fwd_props) != 2 * len(K3.STATE_SIZES) or any(
            re.search(r"\b[1-9]\d* bytes spill", line) for lines in fwd_props.values() for line in lines):
        raise AssertionError(f"scan_fwd_kernel instances spill or are missing: {fwd_props}")
    keys = ("selective_scan_fwd", "selective_scan_fwd_states", "selective_scan_bwd")
    k3 = {k: dict(ms=0.0, prev_ms=0.0 if prev else None, plain_ms=0.0, bound_ms=0.0, err=0.0, bytes=0.0, flops=0.0,
                  exps=0.0) for k in keys}
    T3, D3, N3 = 100, 768, 64
    for Bs in (256, 64):
        x = torch.randn((Bs, T3, D3), generator=gen).to(dev)
        dt = torch.nn.functional.softplus(torch.randn((Bs, T3, D3), generator=gen) - 2.0).to(dev)
        A = -torch.arange(1, N3 + 1, dtype=torch.float32).repeat(D3, 1).to(dev)
        Bm = torch.randn((Bs, T3, N3), generator=gen).to(dev)
        C = torch.randn((Bs, T3, N3), generator=gen).to(dev)
        Dp = (1.0 + 0.1 * torch.randn(D3, generator=gen)).to(dev)
        gy = torch.randn((Bs, T3, D3), generator=gen).to(dev)
        a3 = (x, dt, A, Bm, C, Dp)
        y = K3.selective_scan_fwd(*a3)
        y_again = K3.selective_scan_fwd(*a3)
        y2, h0 = K3.selective_scan_fwd_states(*a3)
        yr, h0r = K3.selective_scan_states_ref(*a3)
        grads = K3.selective_scan_bwd(*a3, h0, gy)
        again = K3.selective_scan_bwd(*a3, h0, gy)
        grads_r = K3.selective_scan_bwd_ref(*a3, h0r, gy)
        torch.cuda.synchronize()
        same = all(torch.equal(p, q) for p, q in zip(grads, again))
        same_fwd, same_ab = torch.equal(y, y_again), torch.equal(y, y2)
        y_bar, h_bar = 1e-4 * max(1.0, yr.abs().max().item()), 1e-4 * max(1.0, h0r.abs().max().item())
        e_fwd = (y - yr).abs().max().item()
        e_y2, e_h0 = (y2 - yr).abs().max().item(), (h0 - h0r).abs().max().item()
        g_errs = {n: ((p - q).abs().max().item(), 1e-3 * q.abs().max().item())
                  for n, p, q in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), grads, grads_r)}
        phase("K3", f"({Bs}, {T3}, {D3}, {N3}) fwd max-abs {e_fwd:.3e} (bar {y_bar:.3e}); fwd_states y {e_y2:.3e}, "
              f"h0 {e_h0:.3e} (bar {h_bar:.3e}); K3a y and K3b y bitwise equal: {same_ab}; two K3a runs bitwise "
              f"equal: {same_fwd}; bwd " + ", ".join(f"{n} {e:.3e} (bar {b:.3e})" for n, (e, b) in g_errs.items())
              + f"; two bwd runs bitwise equal: {same}")
        if not (e_fwd <= y_bar and e_y2 <= y_bar and e_h0 <= h_bar and all(e <= b for e, b in g_errs.values())
                and same and same_fwd and same_ab and all(torch.isfinite(t).all() for t in (y, y2, h0, *grads))):
            raise AssertionError(f"K3 disagrees with its twins at B={Bs}")
        eager = lambda f: cuda_ms(f, iters=10)  # noqa: E731
        fwd_ms, fwd_prev = paired_ms(lambda: K3.selective_scan_fwd(*a3),
                                     (lambda: prev["fwd"](*a3)) if prev else None, timer=eager)
        st_ms, st_prev = paired_ms(lambda: K3.selective_scan_fwd_states(*a3),
                                   (lambda: prev["fwd_states"](*a3)) if prev else None, timer=eager)
        bwd_ms, bwd_prev = paired_ms(lambda: K3.selective_scan_bwd(*a3, h0, gy),
                                     (lambda: prev["bwd"](*a3, h0, gy)) if prev else None,
                                     timer=lambda f: cuda_ms(f, iters=5))
        prev_errs = {}
        if prev:
            py, (py2, ph0) = prev["fwd"](*a3), prev["fwd_states"](*a3)
            prev_errs = {
                "selective_scan_fwd": f"max-abs {(py - yr).abs().max().item():.3e}",
                "selective_scan_fwd_states": f"max-abs y {(py2 - yr).abs().max().item():.3e}, h0 "
                                             f"{(ph0 - h0r).abs().max().item():.3e}",
                "selective_scan_bwd": "worst gradient error " + "{:.3f} of the bar".format(max(
                    (p - q).abs().max().item() / (1e-3 * q.abs().max().item())
                    for p, q in zip(prev["bwd"](*a3, h0, gy), grads_r))),
            }
        times = {
            "selective_scan_fwd": (fwd_ms, fwd_prev, cuda_ms(lambda: selective_scan_sequential(*a3), iters=3, warmup=1),
                                   "fwd", e_fwd),
            "selective_scan_fwd_states": (st_ms, st_prev, cuda_ms(lambda: K3.selective_scan_states_ref(*a3), iters=3,
                                                                  warmup=1), "states", max(e_y2, e_h0)),
            "selective_scan_bwd": (bwd_ms, bwd_prev, cuda_ms(lambda: K3.selective_scan_bwd_ref(*a3, h0r, gy), iters=2,
                                                             warmup=1), "bwd", max(e for e, _ in g_errs.values())),
        }
        for key, (ms, prev_ms, plain, kind, err) in times.items():
            work = K3.scan_work(kind, Bs, T3, D3, N3)
            bms, by = bound(work, H100_FP32_FLOPS)
            line = f"{key} ({Bs}, {T3}, {D3}, {N3}): kernel {ms:.4f} ms, "
            line += ("previous kernel not measured, " if prev_ms is None else
                     f"previous kernel {prev_ms:.4f} ms (its {prev_errs[key]}), ")
            phase("K3", line + f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}) per launch")
            r = k3[key]
            r["ms"] += 4 * ms
            r["plain_ms"] += 4 * plain
            r["bound_ms"] += 4 * bms
            r["err"] = max(r["err"], err)
            for q in ("bytes", "flops", "exps"):
                r[q] += 4 * work[q]
            if prev_ms is not None:
                r["prev_ms"] += 4 * prev_ms
    for key, name, per in zip(keys, ("K3a", "K3b", "K3c"), ("Mamba forward", "Mamba train step", "Mamba train step")):
        r = k3[key]
        prev_total = "not measured" if r["prev_ms"] is None else f"{r['prev_ms']:.4f} ms"
        phase("K3", f"{name} per {per} (4 launches at B = 256, 4 at 64): kernel {r['ms']:.4f} ms, "
              f"previous kernel {prev_total}, bound {r['bound_ms']:.4f} ms")
    def place(t, shifted):
        """t on the card; where `shifted`, one float past a 16-byte boundary,
        so that the forward stages it by 4-byte copies."""
        if not shifted:
            return t.to(dev)
        buf = torch.empty(t.numel() + 1, device=dev)
        buf[1:] = t.reshape(-1).to(dev)
        return buf[1:].view(t.shape)

    for Bs, Tx, Dx, shifted in ((3, 37, 100, False), (2, 50, 200, False), (4, 33, 130, False), (2, 37, 96, True)):
        for Nx in K3.STATE_SIZES:
            x = place(torch.randn((Bs, Tx, Dx), generator=gen), shifted)
            dt = place(0.01 + 0.1 * torch.rand((Bs, Tx, Dx), generator=gen), shifted)
            A = -torch.exp(torch.randn((Dx, Nx), generator=gen)).to(dev)
            a3 = (x, dt, A, place(torch.randn((Bs, Tx, Nx), generator=gen), shifted),
                  place(torch.randn((Bs, Tx, Nx), generator=gen), shifted), torch.randn(Dx, generator=gen).to(dev))
            gy = torch.randn((Bs, Tx, Dx), generator=gen).to(dev)
            yr, h0r = K3.selective_scan_states_ref(*a3)
            y1 = K3.selective_scan_fwd(*a3)
            y2, h0 = K3.selective_scan_fwd_states(*a3)
            e = max((y1 - yr).abs().max().item(), (y2 - yr).abs().max().item())
            eh = (h0 - h0r).abs().max().item()
            y_bar, h_bar = 1e-4 * max(1.0, yr.abs().max().item()), 1e-4 * max(1.0, h0r.abs().max().item())
            same_ab = torch.equal(y1, y2)
            grads = K3.selective_scan_bwd(*a3, h0, gy)
            same = all(torch.equal(p, q) for p, q in zip(grads, K3.selective_scan_bwd(*a3, h0, gy)))
            ge = max(((p - q).abs().max() / q.abs().max()).item()
                     for p, q in zip(grads, K3.selective_scan_bwd_ref(*a3, h0r, gy)))
            phase("K3", f"({Bs}, {Tx}, {Dx}, {Nx}){' shifted by a float' if shifted else ''}: y max-abs {e:.3e} "
                  f"(bar {y_bar:.3e}), h0 max-abs {eh:.3e} (bar "
                  f"{h_bar:.3e}), K3a y and K3b y bitwise equal: {same_ab}; gradients max-abs / max|twin| {ge:.3e} "
                  f"(bar 1e-3), two bwd runs bitwise equal: {same}")
            if not (e <= y_bar and eh <= h_bar and same_ab and ge <= 1e-3 and same):
                raise AssertionError(f"K3 disagrees with its twins at ({Bs}, {Tx}, {Dx}, {Nx})")
    for r in k3.values():
        r["bound_by"] = bound(r, H100_FP32_FLOPS)[1]
    return k3


def cli(*args):
    """Run one verb of the port's CLI through its entry point,
    `speaker_diarization_tpu_torch.cli.main.main`, in this process; its
    stdout, or raise with it. The recipe chain runs ~50 verbs, and a process
    of its own would take each ~8 s to reach the card (the main path's first
    `infer` and `score` go through `python -m` in processes of their own)."""
    import contextlib
    import gc
    import io

    import torch

    from speaker_diarization_tpu_torch.cli.main import main as cli_main

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli_main(list(args))
    except SystemExit as e:  # argparse and the CLI's own refusals
        rc = e.code
    except Exception as e:
        raise RuntimeError(f"CLI {args[0]} raised:\n{out.getvalue()[-3000:]}") from e
    finally:
        gc.collect()
        torch.cuda.empty_cache()
    if rc not in (0, None):
        raise RuntimeError(f"CLI {args[0]} failed ({rc}):\n{out.getvalue()[-3000:]}")
    return out.getvalue()


def kernel_wrappers():
    """Every kernel's wrapper by the name of its launch count."""
    from speaker_diarization_tpu_torch.kernels import cam_block, fbank, fcm, selective_scan

    return {"fbank": fbank.fbank_cuda, "logmel": fbank.logmel_cuda, "cam_block": cam_block.cam_dense_block_cuda,
            "selective_scan_fwd": selective_scan.selective_scan_fwd,
            "selective_scan_fwd_states": selective_scan.selective_scan_fwd_states,
            "selective_scan_bwd": selective_scan.selective_scan_bwd, "fcm": fcm.fcm_cuda}


def launch_counts():
    """Every kernel wrapper's launch count so far (differences of two reads
    count the launches of what ran between them)."""
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def read_metrics(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    ckpts = sorted(fn for fn in os.listdir(exp) if fn.startswith("step_"))
    return [r for r in recs if r["kind"] == "train"], [r for r in recs if r["kind"] == "valid"], ckpts


def recipe_chain():
    """The hermetic TS-VAD recipe's stages 1-5 through the port's CLI at the
    recipe's widths (8 kHz, 80 bins, CAM++ 12/24/16, batch 64), a few steps
    each, on a small simulated corpus, then the leaderboard's other stages
    on it; each stage's output is checked. → the kernels' launches over each
    whole run of `cluster`, `estimate-plda` and the enhanced TS-VAD `infer`."""
    import numpy as np

    from speaker_diarization_tpu_torch.data.rttm import read_rttm
    from speaker_diarization_tpu_torch.data.wav import load_wav_maybe_piped

    with tempfile.TemporaryDirectory(prefix="chip_smoke_recipe_") as tmp:
        # stage 1: a voice pool (8 synthetic speakers x 8 utterances, noises),
        # then train/valid/test mixtures of 3 speakers drawn from it
        t0 = time.perf_counter()
        pool = os.path.join(tmp, "pool")
        cli("simulate", "--out", pool, "--n-mixtures", "1", "--n-speakers", "3", "--seed", "0")
        split_mix = {"train": 6, "valid": 8, "test": 3}
        seconds = {}
        for i, (split, n) in enumerate(split_mix.items()):
            cli("simulate", "--out", os.path.join(tmp, split), "--source-dir", f"{pool}/src", "--noise-dir",
                f"{pool}/noise", "--n-mixtures", str(n), "--n-speakers", "3", "--seed", str(10 * (i + 1)))
            with open(os.path.join(tmp, split, "data", "reco2dur")) as f:
                durs = [float(line.split()[1]) for line in f]
            if len(durs) != n or not os.path.exists(os.path.join(tmp, split, "data", "rttm")):
                raise AssertionError(f"simulate wrote {len(durs)} {split} mixtures, want {n}")
            seconds[split] = round(sum(durs), 1)
        with open(os.path.join(pool, "src", "utt2spk")) as f:
            utt2spk = dict(line.split() for line in f)
        phase("cli", f"simulate: voice pool of {len(utt2spk)} utterances from {len(set(utt2spk.values()))} speakers; "
              f"mixtures of 3 speakers {split_mix}, seconds {seconds}, {time.perf_counter() - t0:.1f} s")

        # stage 2: speaker-encoder pretraining, then stage 3's export
        spk_exp, enc = os.path.join(tmp, "spk"), os.path.join(tmp, "encoder.npz")
        sets = ["sample_rate=8000", "n_mels=80", "spk_dur=2.0", "aam_margin=0.3", "encoder_blocks=12,24,16",
                "batch_size=64", "num_steps=4", "optimizer=adam", "schedule=poly", "learning_rate=1e-3",
                "warmup_steps=200", "bf16=true", "log_every=2", "valid_every=100000"]
        t0 = time.perf_counter()
        cli("train", "--family", "spk", "--train-dir", f"{pool}/src", "--noise-dir", f"{pool}/noise", "--exp-dir",
            spk_exp, *[a for kv in sets for a in ("--set", kv)])
        trains, _, ckpts = read_metrics(spk_exp)
        phase("cli", f"train --family spk (bf16, batch 64 x 2 s, 4 steps): {time.perf_counter() - t0:.1f} s; "
              f"last log {trains[-1] if trains else None}; checkpoints {ckpts}")
        if len(trains) != 2 or not all(math.isfinite(r["loss"]) for r in trains) or not ckpts:
            raise AssertionError(f"CLI train --family spk did not log and checkpoint as asked: {trains}, {ckpts}")
        cli("export-encoder", "--exp-dir", spk_exp, "--out", enc)
        with np.load(enc) as z:
            meta = json.loads(str(z["__cfg__"]))
            dense = z["params/dense_linear/kernel"].shape
            n_keys = len(z.files)
            finite = all(np.isfinite(z[k]).all() for k in z.files if k != "__cfg__")
            dense_bn = "batch_stats/dense_nonlinear/bn/mean" in z.files
        phase("cli", f"export-encoder: {n_keys} arrays, config {meta}, dense kernel {dense}")
        if (meta["encoder"], meta["feat_dim"], meta["emb_dim"], meta["encoder_blocks"]) != ("campplus", 80, 192,
                                                                                             [12, 24, 16]) \
                or dense != (1024, 192) or not dense_bn or not finite:
            raise AssertionError(f"export-encoder wrote a bad npz: {meta}, dense {dense}")

        # stage 3: oracle-RTTM targets and enrollment embeddings per split
        t0 = time.perf_counter()
        stores = {}
        for split in split_mix:
            data, targets = os.path.join(tmp, split, "data"), os.path.join(tmp, split, "targets")
            stores[split] = os.path.join(tmp, split, "embs.npz")
            cli("prepare-targets", "--rttm", f"{data}/rttm", "--data-dir", data, "--out", targets)
            cli("extract-embeddings", "--data-dir", targets, "--out", stores[split], "--encoder-ckpt", enc,
                "--rate", "8000", "--window", "6.0", "--hop", "1.0")
            want_keys = {f"{t.rec}/{t.speaker}" for t in read_rttm(f"{data}/rttm")}
            with np.load(stores[split]) as z:
                shapes = {k: z[k].shape for k in z.files}
                finite = all(np.isfinite(z[k]).all() for k in z.files)
            # a speaker with under 1 s of overlap-free speech gets an empty
            # matrix, as the JAX chunk_embeddings gives (min_window_s)
            short = {k for k, v in shapes.items() if v == (0, 0)}
            for k in short:
                rec, spk = k.split("/")
                audio, rate = load_wav_maybe_piped(os.path.join(targets, "target_audio", rec, f"{spk}.wav"))
                if len(audio) >= rate:
                    raise AssertionError(f"{split} store: {k} is empty but has {len(audio) / rate:.2f} s of target")
            if set(shapes) != want_keys or not finite or any(len(v) != 2 or v[0] < 1 or v[1] != 192
                                                             for k, v in shapes.items() if k not in short):
                raise AssertionError(f"{split} store: keys {sorted(shapes)} vs the RTTM's {sorted(want_keys)}, "
                                     f"shapes {shapes}, finite {finite}")
            phase("cli", f"prepare-targets + extract-embeddings ({split}): {len(shapes)} (recording, speaker) "
                  f"keys, windows per key {sorted(v[0] for v in shapes.values())}, dim 192, finite; "
                  f"{len(short)} with under 1 s of target speech")
        phase("cli", f"stage 3 took {time.perf_counter() - t0:.1f} s")

        # stage 4: TS-VAD from the exported encoder
        ts_exp = os.path.join(tmp, "tsvad")
        sets = ["sample_rate=8000", "n_mels=80", "encoder_blocks=12,24,16", "rs_len=4.0", "segment_shift=2.0",
                "batch_size=64", "num_steps=4", "optimizer=adam", "schedule=poly", "learning_rate=2e-4",
                "warmup_steps=400", "bf16=true", "log_every=2", "valid_every=2"]
        t0 = time.perf_counter()
        cli("train", "--family", "tsvad", "--train-dir", os.path.join(tmp, "train", "data"), "--valid-dir",
            os.path.join(tmp, "valid", "data"), "--exp-dir", ts_exp, "--emb-store",
            f"{stores['train']},{stores['valid']}", "--encoder-ckpt", enc, "--noise-dir", f"{pool}/noise",
            *[a for kv in sets for a in ("--set", kv)])
        trains, valids, ckpts = read_metrics(ts_exp)
        phase("cli", f"train --family tsvad --encoder-ckpt (bf16, batch 64 x 4 s, 4 steps): "
              f"{time.perf_counter() - t0:.1f} s; last log {trains[-1] if trains else None}; valid losses "
              f"{[round(r['loss'], 5) for r in valids]}; checkpoints {ckpts}")
        if len(trains) != 2 or len(valids) != 2 or not all(math.isfinite(r["loss"]) for r in trains + valids) \
                or not ckpts:
            raise AssertionError(f"CLI train --family tsvad did not log, validate and checkpoint: {trains}, {valids}")

        # stage 5: inference with the threshold sweep on the held-out mixtures, then the DER line
        test = os.path.join(tmp, "test", "data")
        hyp = os.path.join(tmp, "test_hyp.rttm")
        t0 = time.perf_counter()
        out = cli("infer", "--family", "tsvad", "--data-dir", test, "--exp-dir", ts_exp, "--emb-store",
                  stores["test"], "--out", hyp, "--threshold-sweep", "--ref", f"{test}/rttm")
        best = re.search(r"best threshold ([0-9.]+) \(DER ([0-9.]+)%\)", out)
        n_rttm = sum(fn.startswith("test_hyp.rttm_") for fn in os.listdir(tmp))
        phase("cli", f"infer --threshold-sweep (test): {n_rttm} RTTMs, best threshold "
              f"{best.group(1) if best else None} DER {best.group(2) if best else None}% (4 steps of training), "
              f"{time.perf_counter() - t0:.1f} s")
        if not best or n_rttm != 18:
            raise AssertionError(f"CLI infer wrote {n_rttm} RTTMs:\n{out}")
        line = cli("score", "--ref", f"{test}/rttm", "--sys", f"{hyp}_{float(best.group(1)):.2f}").strip()
        line = line.splitlines()[-1] if line else ""
        if not re.fullmatch(r"[0-9.]+/[0-9.]+/[0-9.]+/[0-9.]+", line):
            raise AssertionError(f"CLI score printed no DER line: {line!r}")
        phase("cli", f"score (hermetic recipe, test): DER/MS/FA/SC {line}")

        # the leaderboard's ecapa stage (recipes/hermetic_leaderboard_torch.sh):
        # TS-VAD with a scratch ECAPA-TDNN at its flags, 4 steps, then the
        # sweep and the score with CDER beside DER
        ec_exp, hyp = os.path.join(tmp, "tsvad_ecapa"), os.path.join(tmp, "hyp_tsvad_ecapa.rttm")
        ec_sets = ["speech_encoder_type=ecapa", "sample_rate=8000", "n_mels=80", "rs_len=4.0"]
        t0 = time.perf_counter()
        cli("train", "--family", "tsvad", "--train-dir", os.path.join(tmp, "train", "data"), "--valid-dir",
            os.path.join(tmp, "valid", "data"), "--exp-dir", ec_exp, "--emb-store",
            f"{stores['train']},{stores['valid']}", "--noise-dir", f"{pool}/noise",
            *[a for kv in ec_sets + ["segment_shift=2.0", "batch_size=32", "num_steps=4", "optimizer=adam",
                                     "schedule=poly", "learning_rate=2e-4", "warmup_steps=400", "bf16=true",
                                     "log_every=2", "valid_every=2"] for a in ("--set", kv)])
        trains, valids, ckpts = read_metrics(ec_exp)
        if len(trains) != 2 or len(valids) != 2 or not all(math.isfinite(r["loss"]) for r in trains + valids) \
                or not ckpts:
            raise AssertionError(f"CLI train (ecapa stage) did not log, validate and checkpoint: {trains}, {valids}")
        out = cli("infer", "--family", "tsvad", "--data-dir", test, "--exp-dir", ec_exp, "--emb-store",
                  stores["test"], "--out", hyp, "--threshold-sweep", "--ref", f"{test}/rttm", "--cder",
                  *[a for kv in ec_sets for a in ("--set", kv)])
        sweep = [ln for ln in out.splitlines() if ln.startswith("threshold ")]
        best = re.search(r"best threshold ([0-9.]+) \(DER ([0-9.]+)%\)", out)
        if len(sweep) != 18 or not best or not all(re.search(r"  CDER (\d+\.\d{3}|nan)$", ln) for ln in sweep):
            raise AssertionError(f"CLI infer --cder (ecapa stage) printed no CDER sweep:\n{out}")
        lines = cli("score", "--ref", f"{test}/rttm", "--sys", f"{hyp}_{float(best.group(1)):.2f}", "--cder")
        lines = lines.strip().splitlines()
        if len(lines) < 2 or not re.fullmatch(r"[0-9.]+/[0-9.]+/[0-9.]+/[0-9.]+", lines[-2]) \
                or not lines[-1].startswith("CDER avg = "):
            raise AssertionError(f"CLI score --cder printed {lines}")
        phase("cli", f"ecapa stage (train 4 steps, bf16, batch 32 x 4 s; infer --threshold-sweep --cder; score "
              f"--cder): {time.perf_counter() - t0:.1f} s; best threshold {best.group(1)}: DER/MS/FA/SC {lines[-2]}, "
              f"{lines[-1]}")

        # the leaderboard's vbx stage (recipes/hermetic_leaderboard_torch.sh):
        # a PLDA from the exported encoder's embeddings of the labelled voice
        # pool, then `cluster` with oracle SAD on the test mixtures by VBx,
        # and by spectral and UMAP + HDBSCAN* clustering, each scored
        cli_sites = {}
        plda = os.path.join(tmp, "plda.npz")
        t0 = time.perf_counter()
        c0 = launch_counts()
        cli("estimate-plda", "--data-dir", f"{pool}/src", "--out", plda, "--encoder", "campplus", "--encoder-ckpt", enc,
            "--rate", "8000", "--plda-dim", "64")
        cli_sites["estimate_plda"] = {k: v - c0[k] for k, v in launch_counts().items()}
        with np.load(plda) as z:
            pshapes = {k: z[k].shape for k in z.files}
            pfinite = all(np.isfinite(z[k]).all() for k in z.files)
        phase("cli", f"estimate-plda (CAM++ 12/24/16 embeddings of 1.5 s windows, --plda-dim 64): {pshapes}, "
              f"launches {cli_sites['estimate_plda']}, {time.perf_counter() - t0:.1f} s")
        if not pfinite or pshapes.get("tr", (0, 0))[1] != 192 or not 1 <= pshapes["psi"][0] <= 64 \
                or cli_sites["estimate_plda"]["fbank"] < 1:
            raise AssertionError(f"estimate-plda wrote a bad PLDA: {pshapes}, finite {pfinite}")
        for method in ("vbx", "spectral", "umap"):
            hyp = os.path.join(tmp, f"hyp_cluster_{method}.rttm")
            t0 = time.perf_counter()
            c0 = launch_counts()
            out = cli("cluster", "--data-dir", test, "--out", hyp, "--method", method, "--plda", plda, "--sad",
                      "oracle", "--encoder", "campplus", "--encoder-ckpt", enc, "--rate", "8000", "--ref",
                      f"{test}/rttm", "-c", "0.25")
            counts = {k: v - c0[k] for k, v in launch_counts().items()}
            cli_sites[f"cluster_{method}"] = counts
            der = re.search(r"DER ([0-9.]+)%, MS ([0-9.]+)%, FA ([0-9.]+)%, SC ([0-9.]+)%", out)
            n_spk = {t.rec: set() for t in read_rttm(hyp)}
            for t in read_rttm(hyp):
                n_spk[t.rec].add(t.speaker)
            phase("cli", f"cluster --method {method} --sad oracle (test): DER/MS/FA/SC "
                  f"{'/'.join(der.groups()) if der else None}, speakers {sorted(len(v) for v in n_spk.values())}, "
                  f"launches {counts}, {time.perf_counter() - t0:.1f} s")
            if not der or not n_spk or counts["fbank"] < 1:
                raise AssertionError(f"cluster --method {method} went wrong:\n{out}")

        # the neural VAD: `train --family vad` (8 kHz 200/80, 40 mels; the
        # EEND chunks at subsampling 1, 500 frames = 5 s), `export-vad`, then
        # `cluster --sad neural` with it
        vad_exp, vad_npz = os.path.join(tmp, "vad"), os.path.join(tmp, "vad.npz")
        vad_sets = ["sample_rate=8000", "chunk_frames=500", "batch_size=16", "num_steps=4", "optimizer=adam",
                    "schedule=poly", "learning_rate=1e-3", "warmup_steps=1", "log_every=2", "valid_every=2"]
        t0 = time.perf_counter()
        cli("train", "--family", "vad", "--train-dir", os.path.join(tmp, "train", "data"), "--valid-dir",
            os.path.join(tmp, "valid", "data"), "--exp-dir", vad_exp,
            *[a for kv in vad_sets for a in ("--set", kv)])
        trains, valids, ckpts = read_metrics(vad_exp)
        if len(trains) != 2 or len(valids) != 2 or not all(math.isfinite(r["loss"]) for r in trains + valids) \
                or not ckpts:
            raise AssertionError(f"CLI train --family vad did not log, validate and checkpoint: {trains}, {valids}")
        t_train = time.perf_counter() - t0
        cli("export-vad", "--exp-dir", vad_exp, "--out", vad_npz)
        hyp = os.path.join(tmp, "hyp_cluster_neural.rttm")
        c0 = launch_counts()
        out = cli("cluster", "--data-dir", test, "--out", hyp, "--sad", "neural", "--vad-ckpt", vad_npz,
                  "--encoder", "campplus", "--encoder-ckpt", enc, "--rate", "8000", "--ref", f"{test}/rttm")
        counts = {k: v - c0[k] for k, v in launch_counts().items()}
        cli_sites["cluster_neural_sad"] = counts
        der = re.search(r"DER ([0-9.]+)%", out)
        phase("cli", f"train --family vad (fp32, batch 16 x 5 s, 4 steps): {t_train:.1f} s, last log {trains[-1]}; "
              f"export-vad; cluster --sad neural (test): {'DER ' + der.group(1) + '%' if der else out[-200:]} "
              f"(4 steps of training), launches {counts}, {time.perf_counter() - t0:.1f} s")
        if not der or counts["logmel"] != 3:  # one forward of neural_sad per test recording
            raise AssertionError(f"cluster --sad neural went wrong ({counts}):\n{out}")

        # the leaderboard's enhancer_eval stage: `train --family enhance` at its
        # flags (4 steps), `export-enhancer`, then the stage-4 TS-VAD's
        # threshold sweep on the test mixtures with every chunk enhanced
        enh_exp, enh_npz = os.path.join(tmp, "enh"), os.path.join(tmp, "enhancer.npz")
        enh_sets = ["sample_rate=8000", "batch_size=16", "num_steps=4", "optimizer=adam", "schedule=poly",
                    "learning_rate=2e-4", "warmup_steps=200", "bf16=true", "log_every=2", "valid_every=100000"]
        t0 = time.perf_counter()
        cli("train", "--family", "enhance", "--train-dir", f"{pool}/src", "--noise-dir", f"{pool}/noise",
            "--exp-dir", enh_exp, *[a for kv in enh_sets for a in ("--set", kv)])
        trains, _, ckpts = read_metrics(enh_exp)
        if len(trains) != 2 or not all(math.isfinite(r["loss"]) for r in trains) or not ckpts:
            raise AssertionError(f"CLI train --family enhance did not log and checkpoint: {trains}, {ckpts}")
        t_train = time.perf_counter() - t0
        cli("export-enhancer", "--exp-dir", enh_exp, "--out", enh_npz)
        hyp = os.path.join(tmp, "hyp_enh.rttm")
        c0 = launch_counts()
        out = cli("infer", "--family", "tsvad", "--data-dir", test, "--exp-dir", ts_exp, "--emb-store",
                  stores["test"], "--out", hyp, "--threshold-sweep", "--ref", f"{test}/rttm", "--set",
                  f"enhancer=neural:{enh_npz}", "--set", "enhance_prob=1.0")
        counts = {k: v - c0[k] for k, v in launch_counts().items()}
        cli_sites["enhancer_eval_infer"] = counts
        best = re.search(r"best threshold ([0-9.]+) \(DER ([0-9.]+)%\)", out)
        n_rttm = sum(fn.startswith("hyp_enh.rttm_") for fn in os.listdir(tmp))
        phase("cli", f"train --family enhance (bf16, batch 16 x 2 s, 4 steps): {t_train:.1f} s, last log "
              f"{trains[-1]}; export-enhancer; infer --family tsvad --set enhancer=neural:… --set enhance_prob=1.0 "
              f"--threshold-sweep (test): {n_rttm} RTTMs, best threshold {best.group(1) if best else None} DER "
              f"{best.group(2) if best else None}%, launches {counts}, {time.perf_counter() - t0:.1f} s")
        if not best or n_rttm != 18 or counts["fbank"] < 1:
            raise AssertionError(f"the enhanced TS-VAD infer went wrong ({counts}):\n{out}")

        # the torch leaderboard's sond, tsvad3, eend_vc, m2f, fs_eend, ssnd and
        # ots_vad stages (recipes/hermetic_leaderboard_torch.sh), flag for flag
        # at 4 steps, each followed by the threshold sweep and the score, all
        # on this corpus. fs_eend reads 300-frame chunks, not the recipe's
        # 500: these mixtures last 32-51 s, and 50 s chunks would leave one
        # training chunk and no validation chunk. ssnd trains on the voice
        # pool with real blocks from the train split and has no validation.
        data = {split: os.path.join(tmp, split, "data") for split in split_mix}
        tad = {split: os.path.join(tmp, split, "targets", "target_audio") for split in split_mix}
        last = ["num_steps=4", "log_every=2", "valid_every=2"]
        eend_sets = ["sample_rate=8000", "n_speakers=3", "d_model=256", "d_ff=1024", "n_layers=4", "n_heads=4"]
        lb_opt = ["batch_size=16", "optimizer=adam", "schedule=poly", "learning_rate=2e-4", "warmup_steps=400",
                  "bf16=true"]
        stages = {
            "sond": (["--emb-store", f"{stores['train']},{stores['valid']}"],
                     ["sample_rate=8000", "n_mels=80", "n_speakers=4", "rs_len=4.0", "d_model=256",
                      "encoder_blocks=2,2,2,2"],
                     ["segment_shift=2.0", "batch_size=16", "optimizer=adam", "schedule=poly", "learning_rate=2e-4",
                      "warmup_steps=400", "bf16=true"], ["--emb-store", stores["test"]]),
            "tsvad3": (["--target-audio-dir", tad["train"], "--valid-target-audio-dir", tad["valid"], "--encoder-ckpt",
                        enc, "--noise-dir", f"{pool}/noise"],
                       ["sample_rate=8000", "n_mels=80", "encoder_blocks=12,24,16", "rs_len=4.0", "ts_len=3.0"],
                       ["segment_shift=2.0", "batch_size=16", "optimizer=adam", "schedule=poly", "learning_rate=2e-4",
                        "warmup_steps=400", "bf16=true"], ["--target-audio-dir", tad["test"]]),
            "eend_vc": ([], ["sample_rate=8000", "n_speakers=3", "n_mels=23", "d_model=256", "d_ff=1024", "n_layers=4",
                             "n_heads=4", "chunk_frames=200"],
                        ["batch_size=32", "optimizer=adam", "schedule=noam", "learning_rate=1.0", "warmup_steps=1000",
                         "bf16=true"], ["--num-spks", "-1", "--sil-spk-th", "0.2"]),
            "eend_m2f": ([], eend_sets + ["chunk_frames=500"], lb_opt, []),
            "fs_eend": ([], eend_sets + ["n_mels=23", "chunk_frames=300"],
                        ["batch_size=16", "optimizer=adam", "schedule=noam", "learning_rate=1.0", "warmup_steps=1000",
                         "bf16=true"], []),
            "ssnd": (["--train-dir", f"{pool}/src", "--real-data-dir", data["train"]],
                     ["sample_rate=8000", "rs_len=4.0", "encoder_blocks=4,8,4"], lb_opt + ["ssnd_arcface_weight=0.05"],
                     ["--ssnd-rescore"]),
            "ots_vad": (["--noise-dir", f"{pool}/noise"],
                        ["sample_rate=8000", "n_mels=80", "n_speakers=4", "rs_len=4.0", "encoder_blocks=2,2,2,2",
                         "d_model=192", "n_layers=4", "n_heads=4", "d_ff=512"], ["segment_shift=2.0"] + lb_opt, []),
        }
        for fam, (train_args, model_sets, opt_sets, infer_args) in stages.items():
            exp, hyp = os.path.join(tmp, f"lb_{fam}"), os.path.join(tmp, f"hyp_{fam}.rttm")
            dirs = [] if fam == "ssnd" else ["--train-dir", data["train"], "--valid-dir", data["valid"]]
            t0 = time.perf_counter()
            cli("train", "--family", fam, *dirs, "--exp-dir", exp, *train_args,
                *[a for kv in model_sets + opt_sets + last for a in ("--set", kv)])
            trains, valids, ckpts = read_metrics(exp)
            if len(trains) != 2 or len(valids) != (0 if fam == "ssnd" else 2) \
                    or not all(math.isfinite(r["loss"]) for r in trains + valids) or not ckpts:
                raise AssertionError(f"CLI train ({fam} stage) did not log, validate and checkpoint: {trains}, {valids}")
            t_train = time.perf_counter() - t0
            step = [] if fam != "eend_vc" else ["--step", str(int(ckpts[-1].split("_")[1].split(".")[0]))]
            out = cli("infer", "--family", fam, "--data-dir", data["test"], "--exp-dir", exp, "--out", hyp,
                      "--threshold-sweep", "--ref", f"{data['test']}/rttm", *infer_args, *step,
                      *[a for kv in model_sets for a in ("--set", kv)])
            best = re.search(r"best threshold ([0-9.]+) \(DER ([0-9.]+)%\)", out)
            n_rttm = sum(fn.startswith(f"hyp_{fam}.rttm_") for fn in os.listdir(tmp))
            if not best or n_rttm != 18:
                raise AssertionError(f"CLI infer ({fam} stage) wrote {n_rttm} RTTMs:\n{out}")
            line = cli("score", "--ref", f"{data['test']}/rttm", "--sys", f"{hyp}_{float(best.group(1)):.2f}").strip()
            line = line.splitlines()[-1] if line else ""
            if not re.fullmatch(r"[0-9.]+/[0-9.]+/[0-9.]+/[0-9.]+", line):
                raise AssertionError(f"CLI score printed no DER line for the {fam} stage: {line!r}")
            phase("cli", f"{fam} stage (train 4 steps, bf16: {t_train:.1f} s, last log {trains[-1]}; infer "
                  f"--threshold-sweep; score): best threshold {best.group(1)}, DER/MS/FA/SC {line}, "
                  f"{time.perf_counter() - t0:.1f} s")

        # simulate-meetings from the voice pool, and config-dump in its three formats
        t0 = time.perf_counter()
        meet = os.path.join(tmp, "meetings")
        cli("simulate-meetings", "--out", meet, "--source-dir", f"{pool}/src", "--noise-dir", f"{pool}/noise",
            "--seed", "3")
        n_meet = len(read_rttm(os.path.join(meet, "data", "rttm")))
        with open(os.path.join(meet, "data", "wav.scp")) as f:
            n_wav = sum(1 for _ in f)
        dumps = {fmt: cli("config-dump", "--format", fmt, "--set", "family=tsvad", "--set", "remat=true")
                 for fmt in ("json", "bash", "yaml")}
        cfg_json = json.loads(dumps["json"])
        if not (n_meet and n_wav) or cfg_json["family"] != "tsvad" or cfg_json["remat"] is not True \
                or 'family="tsvad"' not in dumps["bash"].splitlines() or "remat: True" not in dumps["yaml"].splitlines():
            raise AssertionError(f"simulate-meetings ({n_wav} meetings, {n_meet} turns) or config-dump went wrong")
        phase("cli", f"simulate-meetings: {n_wav} meetings, {n_meet} turns; config-dump json/bash/yaml: "
              f"{len(cfg_json)} keys each; {time.perf_counter() - t0:.1f} s")

        # the second hermetic recipe (recipes/hermetic_streaming_and_eda_torch.sh)
        # on the same corpus, stores and encoder: stages 1-2 (streaming TS-VAD)
        # and 5-6 (TS-VAD with BiMamba-2 backends) at its settings, 4 steps each
        stream_sets = ["sample_rate=8000", "n_mels=80", "rs_len=4.0", "d_model=256", "d_ff=1024", "n_layers=2",
                       "n_heads=4", "streaming_chunk_size=16", "streaming_left_chunks=4"]
        mamba2_sets = ["sample_rate=8000", "n_mels=80", "encoder_blocks=12,24,16", "rs_len=4.0",
                       "single_backend_type=mamba2", "multi_backend_type=mamba2", "d_state=64", "expand=2"]
        steps = ["segment_shift=2.0", "batch_size=64", "num_steps=4", "optimizer=adam", "schedule=poly",
                 "learning_rate=2e-4", "warmup_steps=400", "bf16=true", "log_every=2", "valid_every=2"]
        for name, family, sets, extra in (("stream", "tsvad_streaming", stream_sets, []),
                                          ("tsvad_mamba2", "tsvad", mamba2_sets, ["--encoder-ckpt", enc])):
            exp = os.path.join(tmp, name)
            t0 = time.perf_counter()
            cli("train", "--family", family, "--train-dir", os.path.join(tmp, "train", "data"), "--valid-dir",
                os.path.join(tmp, "valid", "data"), "--exp-dir", exp, "--emb-store",
                f"{stores['train']},{stores['valid']}", *extra, "--noise-dir", f"{pool}/noise",
                *[a for kv in sets + steps for a in ("--set", kv)])
            trains, valids, ckpts = read_metrics(exp)
            phase("cli", f"train {name} ({family}, bf16, batch 64 x 4 s, 4 steps): {time.perf_counter() - t0:.1f} s; "
                  f"last log {trains[-1] if trains else None}; valid losses "
                  f"{[round(r['loss'], 5) for r in valids]}; checkpoints {ckpts}")
            if len(trains) != 2 or len(valids) != 2 or not all(math.isfinite(r["loss"]) for r in trains + valids) \
                    or not ckpts:
                raise AssertionError(f"CLI train {name} did not log, validate and checkpoint: {trains}, {valids}")
            hyp = os.path.join(tmp, f"test_hyp_{name}.rttm")
            t0 = time.perf_counter()
            out = cli("infer", "--family", family, "--data-dir", test, "--exp-dir", exp, "--emb-store",
                      stores["test"], "--out", hyp, "--threshold-sweep", "--ref", f"{test}/rttm",
                      *[a for kv in sets for a in ("--set", kv)])
            best = re.search(r"best threshold ([0-9.]+) \(DER ([0-9.]+)%\)", out)
            n_rttm = sum(fn.startswith(f"test_hyp_{name}.rttm_") for fn in os.listdir(tmp))
            if not best or n_rttm != 18:
                raise AssertionError(f"CLI infer {name} wrote {n_rttm} RTTMs:\n{out}")
            line = cli("score", "--ref", f"{test}/rttm", "--sys", f"{hyp}_{float(best.group(1)):.2f}").strip()
            line = line.splitlines()[-1] if line else ""
            if not re.fullmatch(r"[0-9.]+/[0-9.]+/[0-9.]+/[0-9.]+", line):
                raise AssertionError(f"CLI score printed no DER line for {name}: {line!r}")
            phase("cli", f"infer {name} --threshold-sweep (test): {n_rttm} RTTMs, best threshold {best.group(1)}, "
                  f"DER/MS/FA/SC {line} (4 steps of training), {time.perf_counter() - t0:.1f} s")
        return cli_sites


def zoo_phase(dev, smi, plain_forward, want, reset_counts, fixed_batch_steps):
    """[zoo]: TS-VAD with every other speech encoder of TSVADConfig at its
    full width (bf16, batch 32 x 4 s at 16 kHz, seeded weights): the WavLM
    trunk (wavlm, its layer-weighted sum, hubert, wav2vec2, mms: 12 x 768 on
    raw waveforms) and Whisper (the large-v2 trunk, 1280 x 32, blocks 16-23
    concatenated, its own plain log-mel) launch no kernel; w2v-BERT (6 x
    1024), ERes2NetV2 (stage 3 of 3/4/6/3, m 64) and ReDimNet b0-b6 read K1's
    fbank (80 bins; 60 for b0, 72 for b1-b6): fbank 1 a forward and a step.
    Each forward held to the plain twins (`plain_forward`), timed, with the
    profiler's busy share; for one type of each trunk five adam steps at
    1e-4 on one batch must lower the loss, and the recipe's step is timed.
    → the launches of each forward and step."""
    import torch

    from speaker_diarization_tpu_torch.bench import (ZOO_BATCH, make_inputs, make_train_batches, profile,
                                                     recipe_trainer, throughput, train_throughput, zoo_config)
    from speaker_diarization_tpu_torch.models.tsvad import SSL_TYPES, TSVADModel
    from speaker_diarization_tpu_torch.train.tasks import make_tsvad_loss
    from speaker_diarization_tpu_torch.train.trainer import Trainer, TrainerConfig

    n_label = 100
    zoo_types = (*SSL_TYPES, "w2vbert", "whisper", "eres2netv2", *(f"redimnet_b{i}" for i in range(7)))
    zoo_train = ("wavlm", "w2vbert", "whisper", "eres2netv2", "redimnet_b2")
    zoo_launches, t_zoo = {}, time.perf_counter()
    for zi, zt in enumerate(zoo_types):
        zcfg = zoo_config(zt)
        fbank_enc = not (zt in SSL_TYPES or zt == "whisper")
        zmodel = TSVADModel(zcfg, dtype="bf16", device=dev, seed=0)
        za, ze = make_inputs(zcfg, ZOO_BATCH, 4.0, 3, seed=40 + zi, device=dev)
        with torch.no_grad():
            zmodel(za[0], ze[0], n_label)  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            zlogits = zmodel(za[1], ze[1], n_label)
            torch.cuda.synchronize()
            zl = launch_counts()
            ref = plain_forward(zmodel, za[1], ze[1], n_label)
        mean_err, scale = (zlogits - ref).abs().mean().item(), max(1.0, ref.abs().mean().item())
        n_params = sum(p.numel() for p in zmodel.speech_encoder.parameters())
        phase("zoo", f"TS-VAD {zt} ({zcfg.feat_dim if fbank_enc else 'raw'} in, encoder {n_params / 1e6:.1f} M "
              f"params) bf16 ({ZOO_BATCH}, 64000) -> {tuple(zlogits.shape)}; launches {zl}; vs plain twins "
              f"mean-abs {mean_err:.3e} (bar 5e-2 x {scale:.3f})")
        if zl != want(fbank=1 if fbank_enc else 0) or tuple(zlogits.shape) != (ZOO_BATCH, 100, 4) \
                or not torch.isfinite(zlogits).all() or not mean_err <= 5e-2 * scale:
            raise AssertionError(f"TS-VAD {zt}: launches {zl}, mean-abs {mean_err} against the twins")
        zoo_launches[f"tsvad_{zt}"] = zl
        tpz = throughput(zmodel, za, ze, n_label, iters=5, reps=2)
        dev_ms = profile(torch.no_grad()(lambda: zmodel(za[0], ze[0], n_label)), n=2)[1]
        phase("throughput", f"TS-VAD {zt} bf16 batch {ZOO_BATCH} x 4 s: {tpz['ms_per_forward']:.3f} ms/forward, "
              f"{tpz['audio_s_per_s']:.1f} audio-s/s (checksum {tpz['witness']:.6e}, reps "
              f"{[round(r, 4) for r in tpz['reps_s']]}), device {dev_ms:.3f} ms/forward, busy "
              f"{dev_ms / tpz['ms_per_forward']:.3f} | {smi}")
        if zt in zoo_train:
            zb = make_train_batches(zcfg, ZOO_BATCH, 4.0, 2, seed=60 + zi, device=dev)
            fixed = Trainer(zmodel, make_tsvad_loss(n_label),
                            TrainerConfig(optimizer="adam", schedule="const", learning_rate=1e-4))
            zlosses, zlt = fixed_batch_steps(fixed, zb[0], want(fbank=1 if fbank_enc else 0), f"TS-VAD {zt}")
            zoo_launches[f"tsvad_{zt}_train_step"] = zlt
            del fixed
            ztrainer = recipe_trainer(zmodel, n_label)
            ztt = train_throughput(ztrainer, zb, iters=3, reps=2)
            _, zstep_ms = profile(lambda: ztrainer.train_step(zb[0]), n=1)
            phase("train", f"TS-VAD {zt}: 5 adam steps at 1e-4 on one batch (bf16, {ZOO_BATCH} x 4 s): losses "
                  f"{[round(v, 5) for v in zlosses]}; launches per step {zlt}; recipe step "
                  f"{ztt['ms_per_step']:.3f} ms, profiler device time {zstep_ms:.3f} ms/step, busy share "
                  f"{zstep_ms / ztt['ms_per_step']:.3f} | {smi}")
            del ztrainer, zb
        del zmodel, za, ze
        torch.cuda.empty_cache()
    phase("zoo", f"{len(zoo_types)} speech encoders in {time.perf_counter() - t_zoo:.1f} s")
    return zoo_launches


def orbax_phase(dev, smi, plain_forward, want, reset_counts):
    """[orbax]: a TS-VAD run of the JAX trainer, its Orbax directory
    (tests/fixtures/torch_orbax_tsvad, written by the JAX package's
    CheckpointManager on the CPU: a GPU host without JAX cannot) read by
    utils/orbax.py and restored through the CLI's `_model_from_exp_dir` on
    the card (the config from the fixture's --set list, as the JAX CLI
    rebuilds it). The eval forward on the fixture's input through K1, K2 (x3)
    and K4: fp32 within 1e-3 x max(1, max|ref|) of the JAX forward's logits
    (computed on the CPU) and of the plain twins; bf16 within 5e-2 mean-abs
    of both. → the launches of the two forwards."""
    import numpy as np
    import torch

    from speaker_diarization_tpu_torch.cli.main import _model_from_exp_dir, build_parser
    from speaker_diarization_tpu_torch.train.checkpoints import CheckpointManager

    t_phase = time.perf_counter()
    fixture = os.path.join(REPO, "tests", "fixtures", "torch_orbax_tsvad")
    step_dir = os.path.join(fixture, "step_0000000001")
    with open(os.path.join(fixture, "sets.json")) as f:
        sets = [a for kv in json.load(f) for a in ("--set", kv)]
    mgr = CheckpointManager(fixture)
    t0 = time.perf_counter()
    state = mgr.restore(1, select=("params", "mutable"))
    decode_s = time.perf_counter() - t0
    arrays = []
    stack = [state]
    while stack:
        node = stack.pop()
        for v in (node.values() if isinstance(node, dict) else node):
            (stack.append(v) if isinstance(v, (dict, list)) else arrays.append(v))
    n_bytes = sum(np.asarray(a).nbytes for a in arrays)
    on_disk = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(step_dir) for f in fs)
    phase("orbax", f"decode of the JAX Orbax step (params and batch_stats: {len(arrays)} arrays, "
          f"{n_bytes / 1e6:.3f} MB from {on_disk / 1e6:.3f} MB on disk, zstd through ctypes): "
          f"{decode_s * 1e3:.1f} ms, {n_bytes / 1e6 / decode_s:.1f} MB/s | {smi}")
    with np.load(os.path.join(fixture, "jax_logits.npz")) as z:
        audio = torch.from_numpy(z["pcm"].astype(np.float32) / 32768.0).to(dev)
        embs, n_label = torch.from_numpy(z["embs"]).to(dev), int(z["n_label"])
        ref = torch.from_numpy(z["logits"]).to(dev)
    sites = {}
    for dtype in ("fp32", "bf16"):
        args = build_parser().parse_args(["infer", "--family", "tsvad", "--exp-dir", fixture, "--data-dir", "-",
                                          "--out", "-", *sets] + (["--bf16"] if dtype == "bf16" else []))
        t0 = time.perf_counter()
        model, _ = _model_from_exp_dir(args, dev)
        restore_s = time.perf_counter() - t0
        model.eval()
        with torch.no_grad():
            model(audio, embs, n_label)  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            got = model(audio, embs, n_label).float()
            torch.cuda.synchronize()
            launches = launch_counts()
            twin = plain_forward(model, audio, embs, n_label).float()
        line = f"TS-VAD {dtype} from the JAX run (restore {restore_s:.2f} s) {tuple(audio.shape)} -> {tuple(got.shape)}; " \
               f"launches {launches}; "
        if dtype == "fp32":
            e_ref, e_twin = (got - ref).abs().max().item(), (got - twin).abs().max().item()
            bar = 1e-3 * max(1.0, ref.abs().max().item())
            line += f"max-abs {e_ref:.3e} vs JAX's logits, {e_twin:.3e} vs the plain twins (bar {bar:.3e})"
        else:
            e_ref, e_twin = (got - ref).abs().mean().item(), (got - twin).abs().mean().item()
            bar = 5e-2 * max(1.0, ref.abs().mean().item())
            line += f"mean-abs {e_ref:.3e} vs JAX's fp32 logits, {e_twin:.3e} vs the plain twins (bar {bar:.3e})"
        phase("orbax", line)
        if launches != want(fbank=1, cam_block=3, fcm=1) or tuple(got.shape) != tuple(ref.shape) \
                or not torch.isfinite(got).all() or not (e_ref <= bar and e_twin <= bar):
            raise AssertionError(f"[orbax] {dtype}: launches {launches}, {e_ref} vs JAX, {e_twin} vs the twins")
        sites[f"orbax_tsvad_{dtype}"] = launches
        del model
    torch.cuda.empty_cache()
    phase("orbax", f"done in {time.perf_counter() - t_phase:.1f} s")
    return sites


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_phase(dev, smi, reset_counts, want):
    """[parallel]: the parallel layer at world size 1 on NCCL (one H100 holds
    one rank; the multi-rank behaviour is held on the CPU over gloo by
    tests/test_torch_parallel.py). Three full-width TS-VAD train steps
    (TSVADConfig(), bf16, batch 64 x 4 s at 16 kHz, the recipe's settings as
    `bench.py --train` runs them) through Trainer(mesh=...) in both reduce
    modes, each bitwise equal to the plain trainer's from the same weights;
    fbank 1 a step. The synced BatchNorm at world size 1 bitwise equal to the
    plain one; ring attention (B 2, T 4096, H 20, D 64, fp32) forward and
    backward against full attention. → the launches of a mesh step."""
    import torch
    import torch.distributed as dist

    from speaker_diarization_tpu_torch.bench import make_train_batches, recipe_trainer
    from speaker_diarization_tpu_torch.models.layers import BatchNorm
    from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
    from speaker_diarization_tpu_torch.parallel.collectives import data_parallel
    from speaker_diarization_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from speaker_diarization_tpu_torch.parallel.ring_attention import ring_self_attention
    from speaker_diarization_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    init_distributed(dev, init_method=f"tcp://127.0.0.1:{_free_port()}")
    deterministic_cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the plain control must repeat itself bit for bit
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"process group {dist.get_backend()} x {dist.get_world_size()}, want nccl x 1")
        mesh = make_mesh()
        phase("parallel", f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))} at world size 1 on a "
              f"tcp://127.0.0.1 init; mesh {mesh.shape}")
        cfg, n_label = TSVADConfig(), 100
        model = TSVADModel(cfg, dtype="bf16", device=dev, seed=0)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        batches = make_train_batches(cfg, 64, 4.0, 3, seed=90, device=dev)
        runs = {}
        for name in ("plain", "mesh all_reduce", "mesh deterministic_reduce", "plain again"):
            model.load_state_dict(init)
            trainer = recipe_trainer(model, n_label)
            if name.startswith("mesh"):
                trainer = Trainer(model, trainer.loss_fn, dataclasses.replace(
                    trainer.cfg, deterministic_reduce=name.endswith("deterministic_reduce")), mesh=mesh)
            times, losses = [], []
            torch.cuda.synchronize()
            reset_counts()
            for b in batches:
                t0 = time.perf_counter()
                losses.append(trainer.train_step(b)["loss"].item())  # .item() drains the device
                times.append(1e3 * (time.perf_counter() - t0))
            launches = launch_counts()
            if launches != want(fbank=3):
                raise AssertionError(f"{name}: three steps launched {launches}, want fbank 3")
            runs[name] = ({k: v.clone() for k, v in model.state_dict().items()}, losses, times)
            del trainer
        ref = runs["plain"][0]
        for name, (sd, losses, times) in runs.items():
            same = all(torch.equal(sd[k], ref[k]) for k in ref)
            phase("parallel", f"TS-VAD bf16 64 x 4 s, 3 recipe steps, {name}: losses {[round(v, 6) for v in losses]}; "
                  f"ms per step {[round(t, 3) for t in times]} (steps 2-3 mean {sum(times[1:]) / 2:.3f}); "
                  f"fbank 1 a step; weights and statistics bitwise equal to the plain run: {same} | {smi}")
            if not same:
                raise AssertionError(f"{name}: the weights after three steps differ from the plain trainer's")
        del runs, ref, init, batches, model
        torch.cuda.empty_cache()

        # the synced BatchNorm at world size 1 against the plain one
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn(64, 256, 400, device=dev, generator=g)
        w = torch.randn(64, 256, 400, device=dev, generator=g)
        outs = []
        for synced in (False, True):
            bn = BatchNorm(256).to(dev).train()
            xi = x.clone().requires_grad_()
            with data_parallel(mesh.data if synced else None):
                y = bn(xi)
            (y * w).sum().backward()
            outs.append((y.detach(), xi.grad, bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var))
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        phase("parallel", f"synced BatchNorm (64, 256, 400) fp32 at world size 1: output, input and affine "
              f"gradients and running statistics bitwise equal to the plain BatchNorm: {same}")
        if not same:
            raise AssertionError("the synced BatchNorm differs from the plain one at world size 1")
        del x, w, outs

        # ring attention at world size 1 against full attention
        B, T, H, D = 2, 4096, 20, 64
        q, k, v, w = (torch.randn(B, T, H, D, device=dev, generator=g) for _ in range(4))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        out = ring_self_attention(q, k, v, mesh)
        (out * w).sum().backward()
        got = [out.detach(), q.grad.clone(), k.grad.clone(), v.grad.clone()]
        for t in (q, k, v):
            t.grad = None
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D**-0.5
        ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        (ref * w).sum().backward()
        want_t = [ref.detach(), q.grad, k.grad, v.grad]
        errs = [(a - b).abs().max().item() for a, b in zip(got, want_t)]
        bars = [5e-5 * max(1.0, want_t[0].abs().max().item())] + [1e-4 * max(1.0, t.abs().max().item()) for t in
                                                                   want_t[1:]]

        def ring_step():
            o = ring_self_attention(q, k, v, mesh)
            (o * w).sum().backward()

        ms = cuda_ms(ring_step, iters=3, warmup=1)
        phase("parallel", f"ring attention fp32 ({B}, {T}, {H}, {D}) at world size 1: max-abs out {errs[0]:.3e}, "
              f"dq {errs[1]:.3e}, dk {errs[2]:.3e}, dv {errs[3]:.3e} against full attention (bars "
              f"{', '.join(f'{b:.1e}' for b in bars)}); forward + backward {ms:.3f} ms | {smi}")
        if not all(e <= b for e, b in zip(errs, bars)):
            raise AssertionError(f"ring attention against full attention: {errs} (bars {bars})")
        del q, k, v, w, out, ref, s, got, want_t
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic_cudnn
        if dist.is_initialized():
            dist.destroy_process_group()
    phase("parallel", f"done in {time.perf_counter() - t_phase:.1f} s")
    return {"tsvad_mesh_train_step": want(fbank=1)}


# DiCoW v3 (BUT-FIT/DiCoW_v3, fine-tuned from openai/whisper-large-v3-turbo):
# the large-v3 encoder, 128 mels, FDDT before every layer, a CTC head and the
# turbo decoder (4 layers) over Whisper's 51,866 tokens
DICOW_V3 = dict(n_mels=128, n_ctx=1500, d_model=1280, n_heads=20, n_layers=32, d_ff=5120)
WHISPER_VOCAB = 51866


def dicow_phase(dev, smi):
    """[dicow]: DiCoW at DiCoW v3's widths with seeded weights, 2 recordings
    x 2 speakers = 4 streams of 30 s, STNO masks from a seeded diarization:
    the bf16 forward within 5e-2 mean-abs of the fp32 forward (the same
    weights, fp32 compute), timed with the profiler's busy share; five adam
    steps at 1e-4 on one batch lower the CTC loss, the step timed; the
    Whisper decoder (4 x 1280) decodes 32 tokens greedily over the four
    streams' states. No kernel: the encoder is plain torch, as in JAX."""
    import numpy as np
    import torch

    from speaker_diarization_tpu_torch.bench import profile
    from speaker_diarization_tpu_torch.models.dicow import DiCoWConfig, DiCoWEncoder, ctc_loss
    from speaker_diarization_tpu_torch.models.whisper_decoder import (WhisperDecoder, WhisperDecoderConfig,
                                                                      greedy_decode)
    from speaker_diarization_tpu_torch.models.whisper_encoder import WhisperEncoderConfig
    from speaker_diarization_tpu_torch.postproc.stno import stno_masks_for_all
    from speaker_diarization_tpu_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = DiCoWConfig(whisper=WhisperEncoderConfig(**DICOW_V3), vocab_size=WHISPER_VOCAB)
    model = DiCoWEncoder(cfg, dtype="bf16", device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(5)
    rec = (0.1 * rng.standard_normal((2, 30 * 16000))).astype(np.float32)
    audio = torch.from_numpy(np.repeat(rec, 2, axis=0)).to(dev)  # each recording once per target speaker
    masks = []
    for _ in range(2):
        diar = np.zeros((2, 1500), np.float32)
        for s in range(2):
            for start in rng.integers(0, 1400, 6):
                diar[s, start:start + int(rng.integers(20, 120))] = 1.0
        masks.append(stno_masks_for_all(diar))
    stno = torch.from_numpy(np.concatenate(masks)).to(dev)  # (4, 4, 1500)
    phase("dicow", f"DiCoW v3 widths ({n_params / 1e6:.1f} M params: 32 x 1280, 20 heads, d_ff 5120, 128 mels, FDDT "
          f"on all 33 places, CTC over {WHISPER_VOCAB}); 4 streams of 30 s built in "
          f"{time.perf_counter() - t_phase:.1f} s")
    with torch.no_grad():
        logits, h = model(audio, stno)
        model.dtype = torch.float32  # the same weights at fp32 compute
        ref, _ = model(audio, stno)
        model.dtype = torch.bfloat16
        torch.cuda.synchronize()
        mean_err = (logits - ref).abs().mean().item()
        scale = max(1.0, ref.abs().mean().item())
        phase("dicow", f"bf16 {tuple(audio.shape)} -> logits {tuple(logits.shape)}, hidden {tuple(h.shape)}: "
              f"mean-abs {mean_err:.3e} against the fp32 forward (bar 5e-2 x {scale:.3f})")
        if tuple(logits.shape) != (4, 1500, WHISPER_VOCAB) or not torch.isfinite(logits).all() \
                or not mean_err <= 5e-2 * scale:
            raise AssertionError(f"DiCoW bf16 forward: mean-abs {mean_err} against fp32")
        del ref

        def forward():
            return model(audio, stno)[0]

        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        dev_ms = profile(forward, n=2)[1]
        fwd_ms = sorted(walls)[1]
        phase("throughput", f"DiCoW v3 bf16 forward, 4 x 30 s: {fwd_ms:.3f} ms (runs {[round(t, 3) for t in walls]}), "
              f"device {dev_ms:.3f} ms, busy {dev_ms / fwd_ms:.3f}; {4 * 30 / (fwd_ms / 1e3):.1f} audio-s/s | {smi}")

    labels = torch.from_numpy(rng.integers(1, WHISPER_VOCAB, (4, 120)).astype(np.int32)).to(dev)
    label_pad = torch.from_numpy((np.arange(120)[None] >= np.array([120, 90, 60, 100])[:, None]).astype(np.float32)).to(dev)
    batch = dict(audio=audio, stno=stno, labels=labels, label_pad=label_pad)

    def loss_fn(m, b, generator, train):
        lo, _ = m(b["audio"], b["stno"])
        return ctc_loss(lo, torch.zeros(lo.shape[:2], device=lo.device), b["labels"], b["label_pad"]), {}

    trainer = Trainer(model, loss_fn, TrainerConfig(optimizer="adam", schedule="const", learning_rate=1e-4))
    losses, steps = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batch)["loss"].item())
        steps.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_dev = profile(lambda: trainer.train_step(batch), n=1)[1]
    step_ms = sum(steps[1:]) / 4
    phase("dicow", f"5 adam steps at 1e-4 on one batch (bf16, CTC over 4 x 1500 frames, labels of 120/90/60/100): "
          f"losses {[round(v, 3) for v in losses]}; step {step_ms:.3f} ms (steps 2-5), device {step_dev:.3f} ms, "
          f"busy {step_dev / step_ms:.3f}; peak memory {peak:.1f} GiB | {smi}")
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"the DiCoW CTC loss did not fall on a fixed batch: {losses}")
    del trainer
    model.eval()
    with torch.no_grad():
        states = model(audio, stno)[1]
    del model
    torch.cuda.empty_cache()
    dec = WhisperDecoder(WhisperDecoderConfig(vocab_size=WHISPER_VOCAB, d_model=1280, n_heads=20, n_layers=4,
                                              d_ff=5120, max_positions=448), dtype="bf16", device=dev, seed=1)
    start = np.full((4, 1), 50258, np.int32)  # <|startoftranscript|>
    greedy_decode(dec, states, start, 2, eos_id=-1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = greedy_decode(dec, states, start, 32, eos_id=-1)  # no eos id: all 32 tokens are decoded
    dec_ms = 1e3 * (time.perf_counter() - t0)
    phase("dicow", f"Whisper decoder (4 x 1280, bf16) greedy_decode of 32 tokens for 4 streams over 1500 states: "
          f"{dec_ms:.1f} ms ({dec_ms / 32:.2f} ms a token, the prefix re-scored each step); tokens "
          f"{tuple(toks.shape)} | {smi}")
    if toks.shape != (4, 33) or not ((toks >= 0) & (toks < WHISPER_VOCAB)).all():
        raise AssertionError(f"greedy_decode gave {toks.shape}")
    del dec, states
    torch.cuda.empty_cache()
    phase("dicow", f"done in {time.perf_counter() - t_phase:.1f} s")


def token_error_rate(hyps, labels, mask) -> float:
    """Token errors over reference tokens (JAX tests/test_dicow_hermetic.py:
    difflib's matching blocks)."""
    import difflib

    e = t = 0
    for h, ref, m in zip(hyps, labels, mask):
        r = [int(x) for x, mm in zip(ref, m) if mm > 0]
        sm = difflib.SequenceMatcher(a=r, b=list(h))
        e += max(len(r), len(h)) - sum(bl.size for bl in sm.get_matching_blocks())
        t += len(r)
    return e / max(t, 1)


def dicow_hermetic(dev, steps1=400, steps2=300):
    """JAX tests/test_dicow_hermetic.py on the port: a small DiCoW (2 x 64,
    40 mels, 10 tokens + blank) trained on synthetic token speech
    (data/asr_sim.py). Stage 1, `steps1` adam steps at 2e-3 of unconditioned
    CTC on single-speaker utterances of two voices; stage 2, `steps2` steps
    at 5e-4, fresh optimizer, of STNO-conditioned CTC on two-speaker mixtures
    whose labels are the target's tokens (the FDDT transforms, unused in
    stage 1, still at their identity init). → (held-out conditioned TER, the
    same with an all-target mask, seconds)."""
    import numpy as np
    import torch

    from speaker_diarization_tpu_torch.data.asr_sim import conditioned_batches, token_batches
    from speaker_diarization_tpu_torch.models.dicow import DiCoWConfig, DiCoWEncoder, ctc_greedy_decode, ctc_loss
    from speaker_diarization_tpu_torch.models.whisper_encoder import WhisperEncoderConfig
    from speaker_diarization_tpu_torch.train.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    V, rate = 10, 16000
    cfg = DiCoWConfig(whisper=WhisperEncoderConfig(n_mels=40, d_model=64, n_heads=2, n_layers=2, d_ff=128, n_ctx=256),
                      vocab_size=V + 1)
    model = DiCoWEncoder(cfg, device=dev, seed=0)

    def t(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    def make_loss(conditioned):
        def loss_fn(m, b, generator, train):
            lo, _ = m(b["audio"], b["stno"] if conditioned else None)
            return ctc_loss(lo, torch.zeros(lo.shape[:2], device=lo.device), b["labels"], 1.0 - b["label_mask"]), {}

        return loss_fn

    def trainer(conditioned, lr):
        return Trainer(model, make_loss(conditioned), TrainerConfig(optimizer="adam", schedule="const",
                                                                    learning_rate=lr, grad_clip_norm=None))

    it_a = token_batches(V, rate, batch_size=4, utt_s=3.0, speaker_shift=1.0, seed=0)
    it_b = token_batches(V, rate, batch_size=4, utt_s=3.0, speaker_shift=1.35, seed=1)
    tr = trainer(False, 2e-3)
    for _ in range(steps1):
        a, c = next(it_a), next(it_b)
        loss1 = tr.train_step(t({k: np.concatenate([a[k], c[k]]) for k in a}))["loss"]
    itc = conditioned_batches(V, rate, batch_size=8, seed=0)
    tr = trainer(True, 5e-4)
    for _ in range(steps2):
        loss2 = tr.train_step(t(next(itc)))["loss"]
    held = next(conditioned_batches(V, rate, batch_size=16, seed=777))
    model.eval()

    def ter_of(stno):
        with torch.no_grad():
            logits, _ = model(torch.from_numpy(held["audio"]).to(dev), torch.from_numpy(stno).to(dev))
        return token_error_rate(ctc_greedy_decode(logits), held["labels"], held["label_mask"])

    stno_all = np.zeros_like(held["stno"])
    stno_all[:, 1] = 1.0
    return ter_of(held["stno"]), ter_of(stno_all), float(loss1), float(loss2), time.perf_counter() - t0


def dicow_hermetic_phase(dev, smi):
    """[dicow_hermetic]: the hermetic DiCoW check on the card, held to the
    JAX test's own bars: conditioned TER < 0.15, the all-target ablation
    above the conditioned TER + 0.2."""
    ter, ter_all, loss1, loss2, secs = dicow_hermetic(dev)
    phase("dicow_hermetic", f"stage 1: 400 unconditioned steps (last loss {loss1:.4f}); stage 2: 300 conditioned "
          f"steps (last loss {loss2:.4f}); held-out conditioned TER {ter:.4f} (bar < 0.15), all-target TER "
          f"{ter_all:.4f} (bar > {ter + 0.2:.4f}); {secs:.1f} s | {smi}")
    if not (ter < 0.15 and ter_all > ter + 0.2):
        raise AssertionError(f"hermetic DiCoW: conditioned TER {ter}, all-target TER {ter_all}")


def zoo_cli_chain():
    """The zoo through the CLI, in this process: `train --family tsvad --set
    speech_encoder_type=wavlm` (4 steps, bf16, batch 32 x 4 s, with
    validation, checkpoints and the flax npz) → `infer --threshold-sweep` →
    `score` on a generated 16 kHz corpus. → its kernel launches."""
    from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus

    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as tmp:
        tr = write_synthetic_corpus(os.path.join(tmp, "train"), n_recs=2, seconds=70.0, rate=16000, n_speakers=3,
                                    seed=70, prefix="tr")
        va = write_synthetic_corpus(os.path.join(tmp, "valid"), n_recs=2, seconds=70.0, rate=16000, n_speakers=3,
                                    seed=71, prefix="va")  # 34 windows: one whole validation batch
        exp = os.path.join(tmp, "exp")
        sets = ["speech_encoder_type=wavlm", "sample_rate=16000", "rs_len=4.0", "segment_shift=2.0", "batch_size=32",
                "num_steps=4", "optimizer=adam", "schedule=poly", "learning_rate=2e-4", "warmup_steps=400",
                "bf16=true", "log_every=2", "valid_every=2", "n_layers=2"]
        t0 = time.perf_counter()
        before = launch_counts()
        cli("train", "--family", "tsvad", "--train-dir", tr["data_dir"], "--valid-dir", va["data_dir"],
            "--emb-store", f"{tr['emb_store']},{va['emb_store']}", "--exp-dir", exp,
            *[a for kv in sets for a in ("--set", kv)])
        trains, valids, ckpts = read_metrics(exp)
        t_train = time.perf_counter() - t0
        if len(trains) != 2 or len(valids) != 2 or not all(math.isfinite(r["loss"]) for r in trains + valids) \
                or not ckpts or not os.path.exists(os.path.join(exp, "flax_params.npz")):
            raise AssertionError(f"zoo CLI train (wavlm) did not log, validate, checkpoint and export: {trains}, "
                                 f"{valids}, {ckpts}")
        t0 = time.perf_counter()
        out = cli("infer", "--family", "tsvad", "--data-dir", va["data_dir"], "--emb-store", va["emb_store"],
                  "--exp-dir", exp, "--out", os.path.join(tmp, "hyp"), "--threshold-sweep", "--ref", va["rttm"])
        best = re.search(r"best threshold ([0-9.]+) \(DER ([0-9.]+)%\)", out)
        n_rttm = sum(fn.startswith("hyp_") for fn in os.listdir(tmp))
        if not best or n_rttm != 18:
            raise AssertionError(f"zoo CLI infer (wavlm) wrote {n_rttm} RTTMs:\n{out[-2000:]}")
        line = cli("score", "--ref", va["rttm"], "--sys", os.path.join(tmp, f"hyp_{float(best.group(1)):.2f}"))
        line = line.strip().splitlines()[-1]
        if not re.fullmatch(r"[0-9.]+/[0-9.]+/[0-9.]+/[0-9.]+", line):
            raise AssertionError(f"zoo CLI score (wavlm) printed {line!r}")
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        phase("cli", f"zoo chain: train --family tsvad --set speech_encoder_type=wavlm (bf16, batch 32 x 4 s, 4 "
              f"steps): {t_train:.1f} s, last log {trains[-1]}, valid losses {[round(r['loss'], 5) for r in valids]}; "
              f"infer --threshold-sweep: best threshold {best.group(1)} DER {best.group(2)}% "
              f"({time.perf_counter() - t0:.1f} s); score DER/MS/FA/SC {line}; launches {launches}")
    return {"cli_zoo_wavlm": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "speaker_diarization_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)

    from speaker_diarization_tpu_torch.bench import make_inputs, profile, throughput
    from speaker_diarization_tpu_torch.kernels import _build
    from speaker_diarization_tpu_torch.kernels import cam_block as K2
    from speaker_diarization_tpu_torch.kernels import cam_block_fused as CF
    from speaker_diarization_tpu_torch.kernels import fbank as K1
    from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
    from speaker_diarization_tpu_torch.ops import features as FE
    from speaker_diarization_tpu_torch.utils.device import resolve_device

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    phase("device", f"{name} | {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    prev_fbank_build = start_prev("fbank")
    prev_scan_build = start_prev("selective_scan")
    built = _build.build_all()
    phase("build", f"{json.dumps({k: round(v, 2) for k, v in built.items()})} wall {time.perf_counter() - t0:.2f} s "
          f"(cached: {sorted(set(_build.sources()) - set(built))})")
    for src in _build.sources():
        fn = "?"  # the kernel (mangled name) the next lines describe
        for line in _build.build_log(src).splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
            fn = m.group(1) if m else fn
            if re.search(r"registers|spill", line):
                phase("ptxas", f"{src} {fn}: {line.split(':', 1)[-1].strip()}")
    gen = torch.Generator(device="cpu").manual_seed(0)
    records = {}

    # ---- K1: fbank kernel vs its plain twin (fp32), at the TS-VAD shape, the
    # recipe's 8 kHz front end, 48 kHz (n_fft 2048: a frame of two warps) and
    # the embedding batches of `cluster` and `estimate-plda` (64 windows of
    # 1.5 s at 8 kHz, and a short last batch); two runs must give the same
    # bits; the previous kernel (build/prev, where a call put it) is timed
    # beside it at 16 and 8 kHz
    prev1 = prev_fbank(prev_fbank_build)
    phase("prev", "the previous K1/K1′ built from build/prev/fbank.cu for timing" if prev1 else
          "no build/prev/fbank.cu: the previous K1/K1′ is not timed")
    for inst, lines in ptxas_props(_build.build_log("fbank"), "fbank_kernel").items():
        phase("K1", f"fbank_kernel<{inst}> (n_fft {2 * int(inst.split(',')[0])}): {' | '.join(lines)}")
    k1lib = K1._lib()
    # (ReDimNet's fbank widths: 72 bins for b1-b6, 60 for b0, at the [zoo] batch)
    for sr, n_mels, shape in ((16000, 80, (64, 64000)), (8000, 80, (64, 32000)), (48000, 80, (8, 96000)),
                              (8000, 80, (64, 12000)), (8000, 80, (20, 12000)), (16000, 72, (32, 64000)),
                              (16000, 60, (32, 64000))):
        x = (0.1 * torch.randn(shape, generator=gen)).to(dev)
        win, shift, n_fft = FE.frame_params(sr)
        T = 1 + (shape[1] - win) // shift
        mel_len = K1._host_consts(sr, n_mels, win, n_fft)["mel_w"].shape[1]
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = K1.launch_plan(shape[0], T, win, shift, n_fft, n_mels, mel_len, n_sm)
        c_smem = k1lib.sdt_fbank_smem_bytes(plan.frames_per_tile, win, shift, n_fft, n_mels, mel_len)
        if c_smem != plan.smem or plan.grid < min(132, plan.tiles):
            raise AssertionError(f"K1 plan at {shape}: {plan}, kernel smem {c_smem}")
        got = K1.fbank_cuda(x, sample_rate=sr, num_mel_bins=n_mels)
        again = K1.fbank_cuda(x, sample_rate=sr, num_mel_bins=n_mels)
        ref = FE.kaldi_fbank_torch(x, sample_rate=sr, num_mel_bins=n_mels, mean_norm=False)
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        err = (got - ref).abs().max().item()
        old = prev1 if sr != 48000 else None
        ms, prev_ms = paired_ms(lambda: K1.fbank_cuda(x, sample_rate=sr, num_mel_bins=n_mels),
                                (lambda: old["fbank"](x, sr, n_mels)) if old else None)
        eager = cuda_ms(lambda: K1.fbank_cuda(x, sample_rate=sr, num_mel_bins=n_mels))
        prev_err = (old["fbank"](x, sr, n_mels) - ref).abs().max().item() if old else None
        plain = cuda_ms(lambda: FE.kaldi_fbank_torch(x, sample_rate=sr, num_mel_bins=n_mels, mean_norm=False))
        work = K1.fbank_work(shape[0], shape[1], sr, n_mels)
        bms, by = bound(work, H100_FP32_FLOPS)
        phase("K1", f"fbank {sr} Hz/{n_mels} {tuple(shape)} -> {tuple(got.shape)} ({plan.grid} CTAs, "
              f"{plan.tiles} tiles of {plan.frames_per_tile} frames, {plan.smem} B smem): max-abs {err:.3e} "
              f"(bar 5e-3), two runs bitwise equal: {same}; kernel {ms:.4f} ms (device; {eager:.4f} ms a call "
              f"from the host), previous kernel "
              f"{'not measured' if prev_ms is None else f'{prev_ms:.4f} ms (max-abs {prev_err:.3e})'}, "
              f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by})")
        if not (err <= 5e-3 and same and torch.isfinite(got).all()):
            raise AssertionError(f"K1 disagrees with its twin at {sr} Hz: max-abs {err}, bitwise equal runs {same}")
        if sr == 16000 and n_mels == 80:
            records["fbank"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, err=err)

    # ---- K1′: the EEND log-mel entry vs its plain twin (fp32, log10 units;
    # bar 2e-3 = K1's 5e-3 natural-log bar / ln 10). The main shape is the
    # EEND bench's: batch 32 × one 50 s chunk at 8 kHz; then 16 kHz, 48 kHz
    # (frame_size 1200, n_fft 2048) and ragged lengths (not a multiple of the
    # shift; shorter than n_fft); two runs must give the same bits; the
    # previous kernel is timed beside it; (16, 40000) is EEND-M2F's batch of
    # 500 frames, read at subsampling 1 and context 0
    k1p = dict(err=0.0)
    for sr, fs, sh, shape in ((8000, 200, 80, (32, 400000)), (8000, 200, 80, (16, 40000)), (16000, 400, 160, (8, 160000)),
                              (48000, 1200, 480, (4, 96000)), (8000, 200, 80, (3, 8123)), (8000, 200, 80, (2, 100)),
                              (16000, 400, 160, (2, 16010))):
        x = (0.1 * torch.randn(shape, generator=gen)).to(dev)
        T = FE.count_frames(shape[1], sh)
        got = K1.logmel_cuda(x, T, fs, sh, sr, 23)
        again = K1.logmel_cuda(x, T, fs, sh, sr, 23)
        ref = FE.logmel_frames_torch(x, T, fs, sh, sr, 23, mean_norm=False)
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        err = (got - ref).abs().max().item()
        k1p["err"] = max(k1p["err"], err)
        line = (f"logmel {sr} Hz/{fs}/{sh}/23 {tuple(shape)} -> {tuple(got.shape)}: max-abs {err:.3e} (bar 2e-3), "
                f"two runs bitwise equal: {same}")
        if shape == (32, 400000):
            ms, prev_ms = paired_ms(lambda: K1.logmel_cuda(x, T, fs, sh, sr, 23),
                                    (lambda: prev1["logmel"](x, T, fs, sh, sr, 23)) if prev1 else None)
            eager = cuda_ms(lambda: K1.logmel_cuda(x, T, fs, sh, sr, 23))
            prev_err = (prev1["logmel"](x, T, fs, sh, sr, 23) - ref).abs().max().item() if prev1 else None
            plain = cuda_ms(lambda: FE.logmel_frames_torch(x, T, fs, sh, sr, 23, mean_norm=False), iters=5)
            bms, by = bound(K1.logmel_work(*shape, fs, sh, sr, 23), H100_FP32_FLOPS)
            k1p.update(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)
            line += (f", kernel {ms:.4f} ms (device; {eager:.4f} ms a call from the host), previous kernel "
                     f"{'not measured' if prev_ms is None else f'{prev_ms:.4f} ms (max-abs {prev_err:.3e})'}, "
                     f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by})")
        phase("K1′", line)
        if not (got.shape == (shape[0], T, 23) and err <= 2e-3 and same and torch.isfinite(got).all()):
            raise AssertionError(f"K1′ disagrees with its twin at {sr} Hz {tuple(shape)}: max-abs {err}, "
                                 f"bitwise equal runs {same}")
    records["logmel"] = k1p
    # EEND-M2F's front-end through K1′: eend_frontend_auto at subsampling 1,
    # context 0 (the mean-normed log-mel itself) vs the twin's, 2e-3 bar
    xm = (0.1 * torch.randn((16, 40000), generator=gen)).to(dev)
    got = FE.eend_frontend_auto(xm, 40000, 200, 80, 8000, 23, 0, 1)
    ref = FE.logmel_frames_torch(xm, FE.count_frames(40000, 80), 200, 80, 8000, 23, mean_norm=True)
    err = (got - ref).abs().max().item()
    phase("K1′", f"EEND-M2F front-end (16, 40000) at subsampling 1, context 0 -> {tuple(got.shape)}: max-abs "
          f"{err:.3e} (bar 2e-3)")
    if got.shape != (16, 500, 23) or not err <= 2e-3:
        raise AssertionError(f"K1′ at EEND-M2F's front-end disagrees with its twin: {tuple(got.shape)}, {err}")
    # the neural VAD's front-end: neural_sad's batch of 30 s chunks at 16 kHz
    # 400/160 (NeuralVADConfig()) and at 8 kHz 200/80 (`cluster --sad neural
    # --rate 8000`), 40 mels, no mean-norm; 2e-3 bar, two runs the same bits
    for sr, fs, sh in ((16000, 400, 160), (8000, 200, 80)):
        xv = (0.1 * torch.randn((16, 30 * sr), generator=gen)).to(dev)
        T = FE.count_frames(30 * sr, sh)
        got = K1.logmel_cuda(xv, T, fs, sh, sr, 40)
        again = K1.logmel_cuda(xv, T, fs, sh, sr, 40)
        ref = FE.logmel_frames_torch(xv, T, fs, sh, sr, 40, mean_norm=False)
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        err = (got - ref).abs().max().item()
        k1p["err"] = max(k1p["err"], err)
        phase("K1′", f"neural VAD front-end {sr} Hz/{fs}/{sh}/40 (16, {30 * sr}) -> {tuple(got.shape)}: max-abs "
              f"{err:.3e} (bar 2e-3), two runs bitwise equal: {same}")
        if got.shape != (16, T, 40) or not (err <= 2e-3 and same and torch.isfinite(got).all()):
            raise AssertionError(f"K1′ at the VAD's front-end ({sr} Hz) disagrees with its twin: {err}, same {same}")
        del xv, got, again, ref

    # ---- K2: dense-block kernel vs its plain twin, the three flagship blocks.
    # bf16 at the main shape: the tensor-core kernel with T split over a
    # cluster (launch_plan: 2 CTAs per item, 128 CTAs); two runs must give
    # the same bits (the cluster's sums are added in a fixed order); the
    # previous version (build/prev, where a call put it) is timed beside it
    cfg = TSVADConfig()
    model = TSVADModel(cfg, dtype="bf16", device=dev, seed=0)
    camp = model.speech_encoder
    fp_bf16 = CF.fused_params(camp, torch.bfloat16)
    blocks, c0 = [], camp.init_channels
    for i, (L, dil) in enumerate(zip(camp.block_layers, camp.block_dilations)):
        blocks.append((i + 1, c0, L, dil))
        c0 = (c0 + 32 * L) // 2
    prev = prev_kernels()
    phase("prev", "the previous K2 and K4 built from build/prev for timing" if prev else
          "no build/prev sources: the previous kernels are not timed")
    k2 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, bytes=0.0, flops=0.0, prev_ms=0.0)
    B, T = 64, 199
    k2lib = K2._lib()
    for idx, c0, L, dil in blocks:
        bp = fp_bf16[f"block{idx}"]
        plan = K2.launch_plan(B, T, dil, c0 + 32 * L)
        c_smem = k2lib.sdt_cam_block_tc_smem_bytes(c0 + 32 * L, plan.u_rows, plan.nls)
        if plan.u_global or B * plan.cl < 128 or c_smem != plan.smem:
            raise AssertionError(f"K2 plan at the main path's (B, T) = ({B}, {T}): {plan}, kernel smem {c_smem}")
        x = torch.randn((B, T, c0), generator=gen).to(dev, torch.bfloat16)
        got = K2.cam_dense_block_cuda(x, bp, dil)
        again = K2.cam_dense_block_cuda(x, bp, dil)
        ref = K2.cam_dense_block_infer(x, bp, dil, dtype=torch.bfloat16)
        same = torch.equal(got, again)
        d = (got.float() - ref.float()).abs()
        mean_err, max_err = d.mean().item(), d.max().item()
        # the grown channels only (the first c0 are copied): mean-abs and a
        # max-abs of 4 bf16 steps at the largest magnitude of the twin's output
        grown = d[..., c0:]
        top = ref[..., c0:].float().abs().max().item()
        max_bar = 4 * 2.0 ** (math.floor(math.log2(max(top, 2.0 ** -30))) - 7)
        grown_mean = grown.mean().item()
        ms = cuda_ms(lambda: K2.cam_dense_block_cuda(x, bp, dil), iters=10)
        prev_ms = cuda_ms(lambda: prev["cam_block"](x, bp, dil), iters=10) if prev else None
        plain = cuda_ms(lambda: K2.cam_dense_block_infer(x, bp, dil, dtype=torch.bfloat16), iters=5)
        work = K2.cam_block_work(B, T, c0, L, elem_bytes=2)
        bms, _ = bound(work, H100_BF16_FLOPS)
        phase("K2", f"block{idx} bf16 B={B} T={T} c0={c0} L={L} d={dil} ({B * plan.cl} CTAs, clusters of "
              f"{plan.cl}): mean-abs {mean_err:.3e} (bar 5e-2), max-abs {max_err:.3e}; grown channels mean-abs "
              f"{grown_mean:.3e} (bar 1e-3, rounding bar {K2_ROUNDING_BAR:.0e}), max-abs {grown.max().item():.3e} "
              f"(bar {max_bar:.3e}, max|twin| {top:.3f}); two runs bitwise equal: {same}; kernel {ms:.4f} ms, "
              f"previous kernel {'not measured' if prev_ms is None else f'{prev_ms:.4f} ms'}, plain {plain:.4f} ms, "
              f"bound {bms:.4f} ms")
        if not (mean_err <= 5e-2 and grown_mean <= min(1e-3, K2_ROUNDING_BAR) and grown.max().item() <= max_bar
                and same and torch.isfinite(got.float()).all()):
            raise AssertionError(f"K2 block{idx} bf16 disagrees with its twin: mean-abs {mean_err}, "
                                 f"grown mean-abs {grown_mean}, grown max-abs {grown.max().item()} (bar {max_bar}), "
                                 f"bitwise equal runs {same}")
        k2["ms"] += ms
        k2["prev_ms"] = None if prev_ms is None or k2["prev_ms"] is None else k2["prev_ms"] + prev_ms
        k2["plain_ms"] += plain
        k2["bound_ms"] += bms
        k2["err"] = max(k2["err"], max_err)
        k2["bytes"] += work["bytes"]
        k2["flops"] += work["flops"]
        fp32 = CF.prepare_block_params(getattr(camp.xvector, f"block{idx}"), c0, c0 + 32 * L, torch.float32)
        for T32 in (199, 200):
            x32 = torch.randn((16, T32, c0), generator=gen).to(dev)
            err = (K2.cam_dense_block_cuda(x32, fp32, dil) - K2.cam_dense_block_infer(x32, fp32, dil, dtype=torch.float32)).abs().max().item()
            phase("K2", f"block{idx} fp32 B=16 T={T32}: max-abs {err:.3e} (bar 2e-4)")
            if not err <= 2e-4:
                raise AssertionError(f"K2 block{idx} fp32 T={T32} disagrees with its twin: max-abs {err}")
    if k2["prev_ms"] is not None:
        phase("K2", f"three blocks at (64, 199): kernel {k2['ms']:.4f} ms, previous kernel "
              f"{k2['prev_ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms")

    def bf16_grown_ok(got, ref, c0):
        """bf16 bars on the grown channels: mean-abs 1e-3 and the rounding
        bar, max-abs 4 bf16 steps."""
        d = (got.float() - ref.float()).abs()[..., c0:]
        top = ref[..., c0:].float().abs().max().item()
        bar = 4 * 2.0 ** (math.floor(math.log2(max(top, 2.0 ** -30))) - 7)
        ok = d.mean().item() <= min(1e-3, K2_ROUNDING_BAR) and d.max().item() <= bar \
            and bool(torch.isfinite(got.float()).all())
        return ok, (f"grown max-abs {d.max().item():.3e} (bar {bar:.3e}), mean-abs {d.mean().item():.3e} "
                    f"(bar 1e-3, rounding bar {K2_ROUNDING_BAR:.0e})")

    # any B and T: a short window (one partial segment), a 3-segment one and
    # one shorter than the dilation's halo, fp32 and bf16 (clusters of 3, 8
    # and 1, CTA edges inside segments)
    for idx, Bx, Tx in ((1, 3, 57), (1, 5, 250), (2, 2, 1)):
        _, c0, L, dil = blocks[idx - 1]
        fp32 = CF.prepare_block_params(getattr(camp.xvector, f"block{idx}"), c0, c0 + 32 * L, torch.float32)
        x32 = torch.randn((Bx, Tx, c0), generator=gen).to(dev)
        err = (K2.cam_dense_block_cuda(x32, fp32, dil) - K2.cam_dense_block_infer(x32, fp32, dil, dtype=torch.float32)).abs().max().item()
        xb = x32.to(torch.bfloat16)
        ok, line = bf16_grown_ok(K2.cam_dense_block_cuda(xb, fp_bf16[f"block{idx}"], dil),
                                 K2.cam_dense_block_infer(xb, fp_bf16[f"block{idx}"], dil, dtype=torch.bfloat16), c0)
        plan = K2.launch_plan(Bx, Tx, dil, c0 + 32 * L)
        phase("K2", f"block{idx} B={Bx} T={Tx}: fp32 max-abs {err:.3e} (bar 2e-4); bf16 (clusters of {plan.cl}, "
              f"{plan.tc} frames per CTA) {line}")
        if not (err <= 2e-4 and ok):
            raise AssertionError(f"K2 block{idx} B={Bx} T={Tx} disagrees with its twin: fp32 max-abs {err}; bf16 {line}")
    # input widths that are not a multiple of 32, bf16 at (8, 199): the blocks
    # of shallower encoders (2/2/2: c0 96 and 80; 3/3/3: 112 and 104, so last
    # k-slices of 8 to 48 channels), and of one with 100 initial channels
    # (100, 98, 97: the wrapper's zero-padded channels)
    from speaker_diarization_tpu_torch.models.campplus import CAMPPlus
    from speaker_diarization_tpu_torch.models.layers import init_weights_

    for init_c, layers in ((128, (2, 2, 2)), (128, (3, 3, 3)), (100, (3, 3, 3))):
        small = CAMPPlus(init_channels=init_c, block_layers=layers, with_dense=False)
        init_weights_(small, torch.Generator().manual_seed(init_c + sum(layers)))
        small = small.to(dev)
        cx = init_c
        for idx, (L, dil) in enumerate(zip(layers, small.block_dilations), start=1):
            bp = CF.prepare_block_params(getattr(small.xvector, f"block{idx}"), cx, cx + 32 * L, torch.bfloat16)
            xb = torch.randn((8, 199, cx), generator=gen).to(dev, torch.bfloat16)
            ok, line = bf16_grown_ok(K2.cam_dense_block_cuda(xb, bp, dil),
                                     K2.cam_dense_block_infer(xb, bp, dil, dtype=torch.bfloat16), cx)
            phase("K2", f"encoder {init_c} + {layers} block{idx} bf16 B=8 T=199 c0={cx} L={L} d={dil}: {line}")
            if not ok:
                raise AssertionError(f"K2 bf16 at c0={cx} L={L} disagrees with its twin: {line}")
            cx = (cx + 32 * L) // 2
    # long windows: fp32 T = 400 keeps u in the fp32 kernel's global scratch;
    # bf16 T = 700 at B = 4 splits over clusters of 8 and keeps u in shared
    # memory; bf16 T = 700 at B = 136 (one CTA per item) takes the bf16
    # kernel's global-scratch instance
    for idx, Bx, Tx, dt, bar in ((2, 4, 400, torch.float32, 2e-4), (3, 4, 700, torch.bfloat16, None),
                                 (1, 136, 700, torch.bfloat16, None)):
        _, c0, L, dil = blocks[idx - 1]
        glob = K2.u_in_global(Bx, Tx, dt, dil, c0 + 32 * L)
        if glob != (Bx != 4 or dt == torch.float32):
            raise AssertionError(f"K2 at B={Bx} T={Tx} {dt}: u in the global scratch is {glob}")
        if dt == torch.float32 and any(k2lib.sdt_cam_block_smem_bytes(t, 100, int(g)) != K2.smem_bytes_f32(t, 100, g)
                                       for t in (199, Tx) for g in (False, True)):
            raise AssertionError("K2's fp32 shared-memory sizes in Python and in the kernel disagree")
        bp = fp_bf16[f"block{idx}"] if dt == torch.bfloat16 else CF.prepare_block_params(
            getattr(camp.xvector, f"block{idx}"), c0, c0 + 32 * L, torch.float32)
        x = torch.randn((Bx, Tx, c0), generator=gen).to(dev, dt)
        got, ref = K2.cam_dense_block_cuda(x, bp, dil), K2.cam_dense_block_infer(x, bp, dil, dtype=dt)
        if bar is None:
            ok, line = bf16_grown_ok(got, ref, c0)
        else:
            err = (got - ref).abs()[..., c0:].max().item()
            ok, line = err <= bar and bool(torch.isfinite(got).all()), f"grown max-abs {err:.3e} (bar {bar:.0e})"
        phase("K2", f"block{idx} {str(dt)[6:]} B={Bx} T={Tx} (u in {'global scratch' if glob else 'shared memory'}): "
              + line)
        if not ok:
            raise AssertionError(f"K2 block{idx} B={Bx} T={Tx} {dt} disagrees with its twin: {line}")
    k2["bound_by"] = bound(k2, H100_BF16_FLOPS)[1]
    records["cam_block"] = k2

    # ---- K4: the FCM head kernel vs its plain twin on the flagship's CAM++
    # head. bf16 at the main path's (64, 398) (the fused-residual tensor-core
    # instance, timed beside the previous version where build/prev holds it)
    # and at three ragged shapes (T = 57: one partial window; 237: the end one
    # frame into the second 256-frame window; 798: the 8 s window): mean-abs
    # 1e-3 and the rounding bar, which must lie below the reading of the twin
    # with a planted rounding fault, and max-abs of four bf16 steps at the
    # twin's largest magnitude (K2's bar); fp32 at four shapes (T = 57: one
    # partial tile; 200: two tiles; 798: the 8 s window) within 2e-4 (the JAX
    # fp32 bar, tests/test_fcm_pallas.py) of the twin and of `_fcm_infer`,
    # the cuDNN head K4 replaces (TF32 off: resolve_device)
    from speaker_diarization_tpu_torch.kernels import fcm as K4

    k4lib = K4._lib()
    tiling = {dt: (k4lib.sdt_fcm_window(int(dt == torch.bfloat16)), k4lib.sdt_fcm_halo()) for dt in K4.WINDOW}
    if any(t != (K4.WINDOW[dt], K4.HALO) for dt, t in tiling.items()):
        raise AssertionError(f"K4's tiling in Python ({K4.WINDOW}, halo {K4.HALO}) and in the kernel {tiling} disagree")

    def unrounded_residual_twin(xb, params):
        """The twin with a planted rounding fault: each residual block's conv
        B output is added to the residual before it is rounded to bf16."""
        conv = K4._conv3x3_folded
        K4._conv3x3_folded = lambda h, w, sb, stride, dtype, relu=True: conv(
            h, w, sb, stride, dtype if relu else torch.float32, relu)
        try:
            return K4.fcm_folded_torch(xb, params, torch.bfloat16)
        finally:
            K4._conv3x3_folded = conv

    B4, T4 = 64, 398
    flat = fp_bf16["head.fcm"]
    x = torch.randn((B4, T4, 80), generator=gen).to(dev, torch.bfloat16)
    with torch.no_grad():
        got, ref = K4.fcm_cuda(x, flat), K4.fcm_folded_torch(x, flat, torch.bfloat16)
        fault = (unrounded_residual_twin(x, flat).float() - ref.float()).abs().mean().item()
    torch.cuda.synchronize()
    d = (got.float() - ref.float()).abs()
    mean_err, max_err, top = d.mean().item(), d.max().item(), ref.float().abs().max().item()
    max_bar = 4 * 2.0 ** (math.floor(math.log2(max(top, 2.0 ** -30))) - 7)
    phase("K4", f"window {tiling[torch.bfloat16][0]} (fp32 {tiling[torch.float32][0]}), halo {K4.HALO} as in "
          f"kernels/fcm.py; the twin with a planted rounding fault (conv B unrounded before the residual) reads "
          f"mean-abs {fault:.3e}, above the rounding bar {K4_ROUNDING_BAR:.0e}")
    if not fault > K4_ROUNDING_BAR:
        raise AssertionError(f"K4's rounding bar {K4_ROUNDING_BAR} would pass a planted rounding fault ({fault})")
    with torch.no_grad():
        ms = cuda_ms(lambda: K4.fcm_cuda(x, flat), iters=10)
        prev_ms = cuda_ms(lambda: prev["fcm"](x, flat), iters=10) if prev else None
        plain = cuda_ms(lambda: K4.fcm_folded_torch(x, flat, torch.bfloat16), iters=3, warmup=1)
        cudnn = cuda_ms(lambda: CF._fcm_infer(x, camp.head, fp_bf16), iters=10)
    bms, by = bound(K4.fcm_work(B4, T4, elem_bytes=2), H100_BF16_FLOPS)
    phase("K4", f"fcm bf16 ({B4}, {T4}, 80) -> {tuple(got.shape)}: mean-abs {mean_err:.3e} (bar 1e-3, rounding "
          f"bar {K4_ROUNDING_BAR:.0e}), max-abs {max_err:.3e} (bar {max_bar:.3e}, max|twin| {top:.3f}); kernel "
          f"{ms:.4f} ms, previous kernel {'not measured' if prev_ms is None else f'{prev_ms:.4f} ms'}, plain twin "
          f"{plain:.4f} ms, cuDNN head (_fcm_infer) {cudnn:.4f} ms, bound {bms:.4f} ms ({by}, bf16 tensor-core peak)")
    if not (mean_err <= min(1e-3, K4_ROUNDING_BAR) and max_err <= max_bar and torch.isfinite(got.float()).all()):
        raise AssertionError(f"K4 bf16 disagrees with its twin: mean-abs {mean_err}, max-abs {max_err} (bar {max_bar})")
    records["fcm"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, err=max_err, prev_ms=prev_ms)
    for Bx, Tx in ((3, 57), (2, 237), (4, 798)):
        xb = torch.randn((Bx, Tx, 80), generator=gen).to(dev, torch.bfloat16)
        with torch.no_grad():
            got, ref = K4.fcm_cuda(xb, flat), K4.fcm_folded_torch(xb, flat, torch.bfloat16)
        d = (got.float() - ref.float()).abs()
        bar = 4 * 2.0 ** (math.floor(math.log2(max(ref.float().abs().max().item(), 2.0 ** -30))) - 7)
        phase("K4", f"fcm bf16 ({Bx}, {Tx}, 80): mean-abs {d.mean().item():.3e} (bar 1e-3, rounding bar "
              f"{K4_ROUNDING_BAR:.0e}), max-abs {d.max().item():.3e} (bar {bar:.3e})")
        if not (d.mean().item() <= min(1e-3, K4_ROUNDING_BAR) and d.max().item() <= bar
                and torch.isfinite(got.float()).all()):
            raise AssertionError(f"K4 bf16 ({Bx}, {Tx}) disagrees with its twin")
    flat32 = K4.prepare_fcm_params(camp.head, torch.float32)
    fp_f32 = CF.fused_params(camp, torch.float32)
    for Bx, Tx in ((16, 398), (3, 57), (2, 200), (4, 798)):
        x32 = torch.randn((Bx, Tx, 80), generator=gen).to(dev)
        with torch.no_grad():
            got = K4.fcm_cuda(x32, flat32)
            e_twin = (got - K4.fcm_folded_torch(x32, flat32, torch.float32)).abs().max().item()
            e_cudnn = (got - CF._fcm_infer(x32, camp.head, fp_f32)).abs().max().item()
        line = f"fcm fp32 ({Bx}, {Tx}, 80): max-abs {e_twin:.3e} vs the twin, {e_cudnn:.3e} vs _fcm_infer (bar 2e-4)"
        if (Bx, Tx) == (16, 398):
            line += f"; kernel {cuda_ms(lambda: K4.fcm_cuda(x32, flat32), iters=5):.4f} ms (fp32 on CUDA cores)"
        phase("K4", line)
        if not (e_twin <= 2e-4 and e_cudnn <= 2e-4 and torch.isfinite(got).all()):
            raise AssertionError(f"K4 fp32 ({Bx}, {Tx}) disagrees: {e_twin} vs the twin, {e_cudnn} vs _fcm_infer")

    # ---- K3a/K3b/K3c: the selective-scan kernels vs their plain twins; the
    # previous kernels (build/prev, where a call put it) are timed beside them
    prev3 = prev_scan(prev_scan_build)
    records.update(scan_phase(gen, dev, prev3))

    # ---- the main path: full-width TS-VAD forward through the kernels
    from speaker_diarization_tpu_torch.kernels import selective_scan as K3
    from speaker_diarization_tpu_torch.models import mamba as MB
    from speaker_diarization_tpu_torch.ops.mamba_scan import selective_scan_sequential

    wrappers = kernel_wrappers()

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    read_counts = launch_counts

    def want(**nonzero):
        return {k: nonzero.get(k, 0) for k in wrappers}

    def in_turns(attr, prev_fn, measure):
        """`measure()` in turns current, previous, previous, current, with
        K3.<attr> replaced by `prev_fn` in the previous turns. → a line of
        each kernel's mean (wall, device) ms and its two runs."""
        cur, runs = getattr(K3, attr), {"current": [], "previous": []}
        for which in ("current", "previous", "previous", "current"):
            setattr(K3, attr, cur if which == "current" else prev_fn)
            try:
                runs[which].append(measure())
            finally:
                setattr(K3, attr, cur)
        return "; ".join(f"{k} {sum(w for w, _ in v) / 2:.3f} ms (runs {[round(w, 3) for w, _ in v]}), device "
                         f"{sum(d for _, d in v) / 2:.3f} ms (runs {[round(d, 3) for _, d in v]})"
                         for k, v in runs.items())

    def fixed_batch_steps(trainer, batch, launches, what):
        """Five train steps on one batch, each launching exactly `launches`;
        the loss must fall. → (losses, the launches of a step)."""
        losses = []
        for i in range(5):
            torch.cuda.synchronize()
            reset_counts()
            aux = trainer.train_step(batch)
            torch.cuda.synchronize()
            got = read_counts()
            losses.append(aux["loss"].item())
            if got != launches:
                raise AssertionError(f"{what} train step {i} launches {got}, want {launches}")
        if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
            raise AssertionError(f"the {what} loss did not fall on a fixed batch: {losses}")
        return losses, got

    audios, embss = make_inputs(cfg, 64, 4.0, 8, seed=0, device=dev)
    n_label = int(4.0 * cfg.label_rate)
    with torch.no_grad():
        model(audios[0], embss[0], n_label)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        logits = model(audios[1], embss[1], n_label)
        torch.cuda.synchronize()
        launches = read_counts()
        phase("forward", f"TS-VAD bf16 (64, 64000) -> {tuple(logits.shape)}; launches {launches}")
        if launches != want(fbank=1, cam_block=3, fcm=1):
            raise AssertionError(f"main path launches {launches}, want fbank 1, cam_block 3 and fcm 1")
        if tuple(logits.shape) != (64, 100, 4) or not torch.isfinite(logits).all():
            raise AssertionError("bad logits from the main path")

        def plain_forward(fn, *args):
            """fn(*args) with every kernel replaced by its plain twin."""
            saved = (FE.kaldi_fbank_auto, FE.eend_frontend_auto, CF._dense_block_auto, CF._fcm_auto,
                     MB.selective_scan_auto)
            FE.kaldi_fbank_auto = lambda w, sample_rate, num_mel_bins, mean_norm: FE.kaldi_fbank_torch(
                w, sample_rate=sample_rate, num_mel_bins=num_mel_bins, mean_norm=mean_norm)
            FE.eend_frontend_auto = lambda a, n, fs, sh, sr, n_mels, c, ss, mn: FE.splice_subsample(
                FE.logmel_frames_torch(a, FE.count_frames(n, sh), fs, sh, sr, n_mels, mn), c, ss)
            CF._dense_block_auto = lambda h, bp, dil, dtype: K2.cam_dense_block_infer(h, bp, dil, dtype=dtype)
            CF._fcm_auto = lambda fb, head, fp, dtype: K4.fcm_folded_torch(fb.to(dtype), fp["head.fcm"], dtype)
            MB.selective_scan_auto = selective_scan_sequential
            try:
                return fn(*args)
            finally:
                (FE.kaldi_fbank_auto, FE.eend_frontend_auto, CF._dense_block_auto, CF._fcm_auto,
                 MB.selective_scan_auto) = saved

        ref = plain_forward(model, audios[1], embss[1], n_label)
        mean_err = (logits - ref).abs().mean().item()
        scale = max(1.0, ref.abs().mean().item())
        phase("forward", f"bf16 logits vs plain twins: mean-abs {mean_err:.3e} (bar 5e-2 x {scale:.3f}), "
              f"max-abs {(logits - ref).abs().max().item():.3e}")
        if not mean_err <= 5e-2 * scale:
            raise AssertionError(f"bf16 main path disagrees with the plain twins: mean-abs {mean_err}")
        m32 = TSVADModel(cfg, dtype="fp32", device=dev, seed=0)
        a8, e8 = audios[2][:8], embss[2][:8]
        got32, ref32 = m32(a8, e8, n_label), plain_forward(m32, a8, e8, n_label)
        err32, scale32 = (got32 - ref32).abs().max().item(), max(1.0, ref32.abs().max().item())
        phase("forward", f"fp32 logits (B=8) vs plain twins: max-abs {err32:.3e} (bar 1e-3 x {scale32:.3f})")
        if not err32 <= 1e-3 * scale32:
            raise AssertionError(f"fp32 forward disagrees with the plain twins: max-abs {err32}")
        # 8 s windows: T = 399 after the TDNN, so K2 keeps u in its global scratch (fp32)
        a_long, e_long = make_inputs(cfg, 4, 8.0, 1, seed=1, device=dev)
        got_l, ref_l = m32(a_long[0], e_long[0], 200), plain_forward(m32, a_long[0], e_long[0], 200)
        err_l, scale_l = (got_l - ref_l).abs().max().item(), max(1.0, ref_l.abs().max().item())
        phase("forward", f"fp32 logits, 8 s windows (B=4) -> {tuple(got_l.shape)} vs plain twins: "
              f"max-abs {err_l:.3e} (bar 1e-3 x {scale_l:.3f})")
        if tuple(got_l.shape) != (4, 200, 4) or not err_l <= 1e-3 * scale_l:
            raise AssertionError(f"fp32 8 s forward disagrees with the plain twins: max-abs {err_l}")
        del m32
        # shallower encoders, whose dense blocks take input widths that are
        # not a multiple of 32 (1/1/1: 128, 80, 56; 2/2/2: 128, 96, 80)
        for layers in ((1, 1, 1), (2, 2, 2)):
            ms_ = TSVADModel(dataclasses.replace(cfg, encoder_block_layers=layers), dtype="bf16", device=dev, seed=0)
            got_s, ref_s = ms_(a8, e8, n_label), plain_forward(ms_, a8, e8, n_label)
            err_s, scale_s = (got_s - ref_s).abs().mean().item(), max(1.0, ref_s.abs().mean().item())
            phase("forward", f"bf16 logits, encoder blocks {layers} (B=8) vs plain twins: mean-abs {err_s:.3e} "
                  f"(bar 5e-2 x {scale_s:.3f})")
            if not (err_s <= 5e-2 * scale_s and torch.isfinite(got_s).all()):
                raise AssertionError(f"bf16 forward at encoder blocks {layers} disagrees: mean-abs {err_s}")
            del ms_

    tp = throughput(model, audios, embss, n_label, iters=20, reps=3)
    phase("throughput", f"TS-VAD bf16 batch 64 x 4 s: {tp['ms_per_forward']:.3f} ms/forward, "
          f"{tp['audio_s_per_s']:.1f} audio-s/s (checksum {tp['witness']:.6e}, reps {[round(r, 4) for r in tp['reps_s']]})")

    # ---- the Mamba main path: the same forward with BiMamba backends (K3a)
    mcfg = TSVADConfig(single_backend_type="mamba", multi_backend_type="mamba")
    mmodel = TSVADModel(mcfg, dtype="bf16", device=dev, seed=0)
    with torch.no_grad():
        mmodel(audios[0], embss[0], n_label)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        mlogits = mmodel(audios[1], embss[1], n_label)
        torch.cuda.synchronize()
        mlaunches = read_counts()
        phase("mamba", f"TS-VAD-Mamba bf16 (64, 64000) -> {tuple(mlogits.shape)}; launches {mlaunches}")
        if mlaunches != want(fbank=1, cam_block=3, fcm=1, selective_scan_fwd=8):
            raise AssertionError(f"Mamba path launches {mlaunches}, want fbank 1, cam_block 3, fcm 1, "
                                 "selective_scan_fwd 8")
        if tuple(mlogits.shape) != (64, 100, 4) or not torch.isfinite(mlogits).all():
            raise AssertionError("bad logits from the Mamba path")
        ref = plain_forward(mmodel, audios[1], embss[1], n_label)
        mean_err, scale = (mlogits - ref).abs().mean().item(), max(1.0, ref.abs().mean().item())
        phase("mamba", f"bf16 logits vs plain twins: mean-abs {mean_err:.3e} (bar 5e-2 x {scale:.3f}), "
              f"max-abs {(mlogits - ref).abs().max().item():.3e}")
        if not mean_err <= 5e-2 * scale:
            raise AssertionError(f"bf16 Mamba path disagrees with the plain twins: mean-abs {mean_err}")
        m32 = TSVADModel(mcfg, dtype="fp32", device=dev, seed=0)
        got32, ref32 = m32(audios[2][:8], embss[2][:8], n_label), plain_forward(m32, audios[2][:8], embss[2][:8], n_label)
        err32, scale32 = (got32 - ref32).abs().max().item(), max(1.0, ref32.abs().max().item())
        phase("mamba", f"fp32 logits (B=8) vs plain twins: max-abs {err32:.3e} (bar 1e-3 x {scale32:.3f})")
        if not err32 <= 1e-3 * scale32:
            raise AssertionError(f"fp32 Mamba forward disagrees with the plain twins: max-abs {err32}")
        del m32
    tpm = throughput(mmodel, audios, embss, n_label, iters=20, reps=3)
    phase("throughput", f"TS-VAD-Mamba bf16 batch 64 x 4 s: {tpm['ms_per_forward']:.3f} ms/forward, "
          f"{tpm['audio_s_per_s']:.1f} audio-s/s (checksum {tpm['witness']:.6e}, reps {[round(r, 4) for r in tpm['reps_s']]})")
    if prev3:  # K3a against the previous K3a on the whole forward (wall from the host, device from the profiler)
        mfwd = torch.no_grad()(lambda: mmodel(audios[0], embss[0], n_label))
        phase("throughput", "TS-VAD-Mamba bf16 forward in turns (K3a, previous, previous, K3a): " + in_turns(
            "selective_scan_fwd", prev3["fwd"],
            lambda: (throughput(mmodel, audios, embss, n_label, iters=20, reps=3)["ms_per_forward"], profile(mfwd)[1])))
    del mmodel

    # ---- the training path: Mamba TS-VAD train steps (K1, K3b, K3c); the
    # recipe step is timed with the previous K3b, then the previous K3c, too
    # where build/prev holds them, in turns (wall from the host, device time
    # from the profiler), one kernel swapped at a time
    from speaker_diarization_tpu_torch.bench import make_train_batches, recipe_trainer, train_throughput
    from speaker_diarization_tpu_torch.train.tasks import make_tsvad_loss
    from speaker_diarization_tpu_torch.train.trainer import Trainer, TrainerConfig

    tmodel = TSVADModel(mcfg, dtype="bf16", device=dev, seed=1)
    batches = make_train_batches(mcfg, 64, 4.0, 4, seed=2, device=dev)
    # five adam steps at a constant 1e-3 on one fixed batch: the loss must fall
    fixed = Trainer(tmodel, make_tsvad_loss(n_label), TrainerConfig(optimizer="adam", schedule="const", learning_rate=1e-3))
    losses, tlaunches = fixed_batch_steps(fixed, batches[0], want(fbank=1, selective_scan_fwd_states=8,
                                                                  selective_scan_bwd=8), "Mamba")
    phase("train", f"5 steps on one batch (bf16, 64 x 4 s): losses {[round(v, 5) for v in losses]}; "
          f"launches per step {tlaunches}")
    trainer = recipe_trainer(tmodel, n_label)
    tt = train_throughput(trainer, batches, iters=5, reps=3)
    dev_ms = profile(lambda: trainer.train_step(batches[0]))[1]
    phase("throughput", f"TS-VAD-Mamba train step (recipe: adam, poly, bf16, batch 64 x 4 s): "
          f"{tt['ms_per_step']:.3f} ms/step (loss checksum {tt['witness']:.6e}, reps {[round(r, 4) for r in tt['reps_s']]}), "
          f"device {dev_ms:.3f} ms/step, busy {dev_ms / tt['ms_per_step']:.3f}")
    if prev3:
        step = lambda: (train_throughput(trainer, batches, iters=5, reps=3)["ms_per_step"],  # noqa: E731
                        profile(lambda: trainer.train_step(batches[0]))[1])
        for kernel, attr, key in (("K3b", "selective_scan_fwd_states", "fwd_states"), ("K3c", "selective_scan_bwd", "bwd")):
            phase("throughput", f"TS-VAD-Mamba train step in turns ({kernel}, previous, previous, {kernel}; a step): "
                  + in_turns(attr, prev3[key], step))
    del tmodel, fixed, batches, trainer

    # ---- TS-VAD with BiMamba-2 (SSD) backends, the second hermetic recipe's
    # stages 5-6: d_state 64, expand 2, so 12 heads of P = N = 64; the scan is
    # plain torch einsums (ops/ssd.py), the JAX scan has no Pallas kernel
    from speaker_diarization_tpu_torch.ops.ssd import ssd_chunked, ssd_sequential

    m2cfg = TSVADConfig(single_backend_type="mamba2", multi_backend_type="mamba2")
    m2model = TSVADModel(m2cfg, dtype="bf16", device=dev, seed=0)
    with torch.no_grad():
        m2model(audios[0], embss[0], n_label)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        m2logits = m2model(audios[1], embss[1], n_label)
        torch.cuda.synchronize()
        m2launches = read_counts()
        phase("mamba2", f"TS-VAD-Mamba2 bf16 (64, 64000) -> {tuple(m2logits.shape)}; launches {m2launches}")
        if m2launches != want(fbank=1, cam_block=3, fcm=1):
            raise AssertionError(f"Mamba-2 path launches {m2launches}, want fbank 1, cam_block 3 and fcm 1")
        if tuple(m2logits.shape) != (64, 100, 4) or not torch.isfinite(m2logits).all():
            raise AssertionError("bad logits from the Mamba-2 path")
        ref = plain_forward(m2model, audios[1], embss[1], n_label)
        mean_err, scale = (m2logits - ref).abs().mean().item(), max(1.0, ref.abs().mean().item())
        phase("mamba2", f"bf16 logits vs plain twins: mean-abs {mean_err:.3e} (bar 5e-2 x {scale:.3f}), "
              f"max-abs {(m2logits - ref).abs().max().item():.3e}")
        if not mean_err <= 5e-2 * scale:
            raise AssertionError(f"bf16 Mamba-2 path disagrees with the plain twins: mean-abs {mean_err}")
        m32 = TSVADModel(m2cfg, dtype="fp32", device=dev, seed=0)
        got32, ref32 = m32(audios[2][:8], embss[2][:8], n_label), plain_forward(m32, audios[2][:8], embss[2][:8], n_label)
        err32, scale32 = (got32 - ref32).abs().max().item(), max(1.0, ref32.abs().max().item())
        phase("mamba2", f"fp32 logits (B=8) vs plain twins: max-abs {err32:.3e} (bar 1e-3 x {scale32:.3f})")
        if not err32 <= 1e-3 * scale32:
            raise AssertionError(f"fp32 Mamba-2 forward disagrees with the plain twins: max-abs {err32}")
        del m32
        # the port's chunked SSD against its per-step recurrence, fp32, at the
        # single backend's shape (B·S = 256 rows, T = 100 in two chunks of 64);
        # JAX's bar (tests/test_ssd.py): |a - b| <= 1e-4 + 1e-4 |b|
        Hs, Ps, Ns = 12, 64, 64
        xs = torch.randn((256, 100, Hs, Ps), generator=gen).to(dev)
        dts = (0.001 + 0.499 * torch.rand((256, 100, Hs), generator=gen)).to(dev)
        As = -(0.5 + 3.5 * torch.rand(Hs, generator=gen)).to(dev)
        Bs_, Cs_ = (torch.randn((256, 100, 1, Ns), generator=gen).to(dev) for _ in range(2))
        Ds = torch.randn(Hs, generator=gen).to(dev)
        ys, ys_ref = ssd_chunked(xs, dts, As, Bs_, Cs_, Ds), ssd_sequential(xs, dts, As, Bs_, Cs_, Ds)
        excess = ((ys - ys_ref).abs() - 1e-4 * ys_ref.abs()).max().item()
        ssd_ms = cuda_ms(lambda: ssd_chunked(xs, dts, As, Bs_, Cs_, Ds), iters=10)
        ssd_seq_ms = cuda_ms(lambda: ssd_sequential(xs, dts, As, Bs_, Cs_, Ds), iters=2, warmup=1)
        phase("mamba2", f"ssd_chunked vs ssd_sequential fp32 (256, 100, {Hs}, {Ps}), N {Ns}: max-abs "
              f"{(ys - ys_ref).abs().max().item():.3e}, max(|a-b| - 1e-4|b|) {excess:.3e} (bar 1e-4), "
              f"max|y| {ys_ref.abs().max().item():.3f}; chunked {ssd_ms:.4f} ms, sequential {ssd_seq_ms:.4f} ms")
        if not (excess <= 1e-4 and torch.isfinite(ys).all()):
            raise AssertionError(f"ssd_chunked disagrees with ssd_sequential on the card: {excess}")
        del xs, dts, Bs_, Cs_, ys, ys_ref
    tpm2 = throughput(m2model, audios, embss, n_label, iters=20, reps=3)
    phase("throughput", f"TS-VAD-Mamba2 bf16 batch 64 x 4 s: {tpm2['ms_per_forward']:.3f} ms/forward, "
          f"{tpm2['audio_s_per_s']:.1f} audio-s/s (checksum {tpm2['witness']:.6e}, reps "
          f"{[round(r, 4) for r in tpm2['reps_s']]})")
    del m2model
    # train steps at the recipe's 8 kHz settings: CAM++ trains on its module
    # path, so K1 is the step's only kernel
    m2cfg8 = dataclasses.replace(m2cfg, sample_rate=8000)
    tmodel = TSVADModel(m2cfg8, dtype="bf16", device=dev, seed=1)
    batches = make_train_batches(m2cfg8, 64, 4.0, 4, seed=3, device=dev)
    fixed = Trainer(tmodel, make_tsvad_loss(n_label), TrainerConfig(optimizer="adam", schedule="const", learning_rate=1e-3))
    losses, m2tlaunches = fixed_batch_steps(fixed, batches[0], want(fbank=1), "Mamba-2")
    phase("train", f"Mamba-2: 5 steps on one batch (bf16, 64 x 4 s at 8 kHz): losses {[round(v, 5) for v in losses]}; "
          f"launches per step {m2tlaunches}")
    tt2 = train_throughput(recipe_trainer(tmodel, n_label), batches, iters=5, reps=3)
    phase("throughput", f"TS-VAD-Mamba2 train step (recipe: adam, poly, bf16, batch 64 x 4 s at 8 kHz): "
          f"{tt2['ms_per_step']:.3f} ms/step (loss checksum {tt2['witness']:.6e}, reps "
          f"{[round(r, 4) for r in tt2['reps_s']]})")
    del tmodel, fixed, batches

    # ---- streaming TS-VAD at the second hermetic recipe's stream_cfg (8 kHz,
    # 80 bins, d_model 256, d_ff 1024, 2 layers of 4 heads, chunk 16, 4 left
    # chunks), batch 64 x 4 s: the window decode `infer` runs, against the
    # offline chunk-masked forward over the same window padded to whole
    # chunks (7 chunks, 112 frames), fp32, JAX's bar 2e-4 on probabilities
    from speaker_diarization_tpu_torch.bench import streaming_model, streaming_throughput
    from speaker_diarization_tpu_torch.infer.chunked import streaming_window_logits
    from speaker_diarization_tpu_torch.train.tasks import make_streaming_tsvad_loss

    stmodel32 = streaming_model(dev, seed=0, bf16=False)
    stcfg = stmodel32.cfg
    sa, se = make_inputs(stcfg, 64, 4.0, 4, seed=4, device=dev)
    with torch.no_grad():
        streaming_window_logits(stmodel32, sa[0], se[0], n_label)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        dec = streaming_window_logits(stmodel32, sa[1], se[1], n_label)
        torch.cuda.synchronize()
        dlaunches = read_counts()
        off = stmodel32(sa[1], se[1], 112)
        p_dec, p_off = torch.sigmoid(dec), torch.sigmoid(off[:, :n_label])
        err_p, err_l = (p_dec - p_off).abs().max().item(), (dec - off[:, :n_label]).abs().max().item()
        whole = stmodel32(sa[1], se[1], n_label)[:, :96]
        err_w = (p_dec[:, :96] - torch.sigmoid(whole)).abs().max().item()
    phase("streaming", f"decode fp32 (64, 32000) -> {tuple(dec.shape)} in 7 chunks; launches {dlaunches}; vs the "
          f"offline forward padded to 112 frames: probabilities max-abs {err_p:.3e} (bar 2e-4), logits {err_l:.3e}; "
          f"the first 96 frames vs the 100-frame forward {err_w:.3e}")
    if dlaunches != want(fbank=1):
        raise AssertionError(f"streaming decode launches {dlaunches}, want fbank 1")
    if tuple(dec.shape) != (64, 100, 4) or not torch.isfinite(dec).all() or not (err_p <= 2e-4 and err_w <= 2e-4):
        raise AssertionError(f"the streaming decode disagrees with the offline forward: {err_p}, {err_w}")
    del stmodel32
    stmodel = streaming_model(dev, seed=0)
    tps = streaming_throughput(stmodel, sa, se, n_label, iters=20, reps=3)
    phase("throughput", f"streaming TS-VAD decode bf16 batch 64 x 4 s at 8 kHz: {tps['ms_per_forward']:.3f} ms/window "
          f"batch, {tps['audio_s_per_s']:.1f} audio-s/s (checksum {tps['witness']:.6e}, reps "
          f"{[round(r, 4) for r in tps['reps_s']]})")
    tpo = throughput(stmodel, sa, se, n_label, iters=20, reps=3)
    phase("throughput", f"streaming TS-VAD offline chunk-masked forward bf16 batch 64 x 4 s: "
          f"{tpo['ms_per_forward']:.3f} ms/forward, {tpo['audio_s_per_s']:.1f} audio-s/s (checksum "
          f"{tpo['witness']:.6e})")
    batches = make_train_batches(stcfg, 64, 4.0, 4, seed=5, device=dev)
    fixed = Trainer(stmodel, make_streaming_tsvad_loss(n_label),
                    TrainerConfig(optimizer="adam", schedule="const", learning_rate=1e-3))
    losses, stlaunches = fixed_batch_steps(fixed, batches[0], want(fbank=1), "streaming")
    phase("train", f"streaming: 5 steps on one batch (bf16, 64 x 4 s at 8 kHz): losses "
          f"{[round(v, 5) for v in losses]}; launches per step {stlaunches}")
    tts = train_throughput(recipe_trainer(stmodel, n_label), batches, iters=5, reps=3)
    phase("throughput", f"streaming TS-VAD train step (recipe: adam, poly, bf16, batch 64 x 4 s at 8 kHz): "
          f"{tts['ms_per_step']:.3f} ms/step (loss checksum {tts['witness']:.6e}, reps "
          f"{[round(r, 4) for r in tts['reps_s']]})")
    del stmodel, fixed, batches

    # ---- the EEND family's main path: full-width bf16 EEND forward and
    # EendEdaModel.infer through K1′ (TrainCliConfig widths, 8 kHz, batch 32
    # × one 500-frame chunk = 50 s)
    from speaker_diarization_tpu_torch.bench import (EEND_BATCH, eend_forward, eend_model, eend_recipe_trainer,
                                                     eend_throughput, make_eend_batches)
    from speaker_diarization_tpu_torch.train.tasks import make_eda_loss, make_eend_loss

    eend_launches = {}
    for fam, tag, over in (("eend", "eend", {}), ("eend_eda", "eda", {}),
                           ("eend_eda", "eda_conformer", dict(encoder_type="conformer"))):
        emodel, ecfg = eend_model(fam, dev, seed=3, **over)
        eb = make_eend_batches(ecfg, EEND_BATCH, 3, seed=4, device=dev)
        fwd = eend_forward(emodel)
        want_shape = (EEND_BATCH, ecfg.chunk_frames, ecfg.n_speakers if fam == "eend" else ecfg.max_attractors)
        with torch.no_grad():
            fwd(eb[0]["audio"], eb[0]["frame_mask"])  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            if fam == "eend":
                out, probs = emodel(eb[1]["audio"], eb[1]["frame_mask"]), None
            else:
                out, probs = emodel.infer(eb[1]["audio"], eb[1]["frame_mask"])
            torch.cuda.synchronize()
            eend_launches[tag] = read_counts()
            phase(tag, f"{fam} ({ecfg.encoder_type} encoder) bf16 {tuple(eb[1]['audio'].shape)} -> logits "
                  f"{tuple(out.shape)}" + (f", exist probs {tuple(probs.shape)}" if probs is not None else "")
                  + f"; launches {eend_launches[tag]}")
            if eend_launches[tag] != want(logmel=1):
                raise AssertionError(f"{tag} forward launches {eend_launches[tag]}, want logmel 1")
            if tuple(out.shape) != want_shape or not torch.isfinite(out).all() or (
                    probs is not None and (tuple(probs.shape) != (EEND_BATCH, ecfg.max_attractors)
                                           or not torch.isfinite(probs).all())):
                raise AssertionError(f"bad {fam} outputs")
            if fam == "eend":
                ref, ref_p = plain_forward(emodel, eb[1]["audio"], eb[1]["frame_mask"]), None
            else:
                ref, ref_p = plain_forward(emodel.infer, eb[1]["audio"], eb[1]["frame_mask"])
            mean_err, scale = (out - ref).abs().mean().item(), max(1.0, ref.abs().mean().item())
            p_err = 0.0 if probs is None else (probs - ref_p).abs().mean().item()
            phase(tag, f"bf16 logits vs plain twin: mean-abs {mean_err:.3e} (bar 5e-2 x {scale:.3f}), max-abs "
                  f"{(out - ref).abs().max().item():.3e}" + ("" if probs is None else
                                                           f"; exist probs mean-abs {p_err:.3e} (bar 5e-2)"))
            if not (mean_err <= 5e-2 * scale and p_err <= 5e-2):
                raise AssertionError(f"bf16 {fam} forward disagrees with the plain twin: {mean_err}, {p_err}")
            m32, _ = eend_model(fam, dev, seed=3, bf16=False, **over)
            a8, f8 = eb[2]["audio"][:8], eb[2]["frame_mask"][:8]
            f8 = f8.clone()
            f8[1, 400:] = 0.0  # padded frames too
            f32 = eend_forward(m32)
            got32, ref32 = f32(a8, f8), plain_forward(f32, a8, f8)
            err32, scale32 = (got32 - ref32).abs().max().item(), max(1.0, ref32.abs().max().item())
            phase(tag, f"fp32 logits (B=8, one item half padded) vs plain twin: max-abs {err32:.3e} "
                  f"(bar 1e-3 x {scale32:.3f})")
            if not err32 <= 1e-3 * scale32:
                raise AssertionError(f"fp32 {fam} forward disagrees with the plain twin: max-abs {err32}")
            del m32
        tpe = eend_throughput(emodel, eb, iters=5 if fam == "eend_eda" else 10, reps=3)
        phase("throughput", f"{tag} bf16 batch {EEND_BATCH} x 50 s: {tpe['ms_per_forward']:.3f} ms/forward, "
              f"{tpe['audio_s_per_s']:.1f} audio-s/s (checksum {tpe['witness']:.6e}, "
              f"reps {[round(r, 4) for r in tpe['reps_s']]})")

        # five adam steps at a constant rate on one fixed batch: the loss must
        # fall. Dropout off and (EDA) no frame shuffle, so that the loss moves
        # only with the weights; random full-width EDA weights make the
        # 500-step LSTM chaotic, and a first adam step above a few 1e-6 (every
        # weight moves by lr) throws the attractors about before it helps
        fmodel, _ = eend_model(fam, dev, seed=3, dropout=0.0, **over)
        loss = make_eend_loss() if fam == "eend" else make_eda_loss(shuffle_frames=False)
        lr = 1e-4 if fam == "eend" else 3e-6
        fixed = Trainer(fmodel, loss, TrainerConfig(optimizer="adam", schedule="const", learning_rate=lr))
        elosses, etl = fixed_batch_steps(fixed, eb[0], want(logmel=1), tag)
        phase("train", f"{tag}: 5 adam steps at {lr:g} on one batch (bf16, dropout 0, {EEND_BATCH} x 50 s): losses "
              f"{[round(v, 5) for v in elosses]}; launches per step {etl}")
        tte = train_throughput(eend_recipe_trainer(emodel, fam), eb, iters=3, reps=3)
        phase("throughput", f"{tag} train step (recipe: adam, noam, lr 1.0, warmup 800, clip 5, bf16, batch "
              f"{EEND_BATCH} x 50 s): {tte['ms_per_step']:.3f} ms/step (loss checksum {tte['witness']:.6e}, "
              f"reps {[round(r, 4) for r in tte['reps_s']]})")
        del emodel, fmodel, fixed, eb

    # ---- the hermetic recipe's speaker encoder (K1): pretraining steps of the
    # full-width classifier and the embedding forward of extract-embeddings
    from speaker_diarization_tpu_torch.bench import (EMB_BATCH, EMB_WINDOW_S, SPK_BATCH, SPK_DUR_S, embed_forward,
                                                     embed_throughput, make_spk_batches, spk_model,
                                                     spk_recipe_trainer)
    from speaker_diarization_tpu_torch.train.tasks import make_spk_loss

    smodel, scfg = spk_model(dev, seed=5)
    sb = make_spk_batches(SPK_BATCH, 3, seed=6, device=dev)
    # five adam steps at a constant 1e-4 on one fixed batch: the loss must fall
    fixed = Trainer(smodel, make_spk_loss(sample_rate=scfg.sample_rate),
                    TrainerConfig(optimizer="adam", schedule="const", learning_rate=1e-4))
    slosses, slaunches = fixed_batch_steps(fixed, sb[0], want(fbank=1), "spk")
    phase("spk", f"5 adam steps at 1e-4 on one batch (CAM++ 12/24/16 + AAM over {scfg.all_n_speakers} speakers, "
          f"margin {scfg.aam_margin}, bf16, {SPK_BATCH} x {SPK_DUR_S} s at 8 kHz): losses "
          f"{[round(v, 5) for v in slosses]}; launches per step {slaunches}")
    st = train_throughput(spk_recipe_trainer(smodel), sb, iters=5, reps=3)
    phase("throughput", f"spk train step (recipe: adam, poly, lr 1e-3, warmup 200, clip 5, bf16, batch {SPK_BATCH} x "
          f"{SPK_DUR_S} s at 8 kHz): {st['ms_per_step']:.3f} ms/step (loss checksum {st['witness']:.6e}, "
          f"reps {[round(r, 4) for r in st['reps_s']]})")
    del smodel, fixed
    encoder = spk_model(dev, seed=5, bf16=False)[0].speech_encoder
    ea = [b["audio"] for b in make_spk_batches(EMB_BATCH, 3, seed=7, device=dev, seconds=EMB_WINDOW_S)]
    efwd = embed_forward(encoder)
    with torch.no_grad():
        efwd(ea[0])  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        emb = efwd(ea[1])
        torch.cuda.synchronize()
        elaunches = read_counts()
    phase("spk", f"embedding forward fp32 {tuple(ea[1].shape)} -> {tuple(emb.shape)}; launches {elaunches}")
    if elaunches != want(fbank=1) or tuple(emb.shape) != (EMB_BATCH, 192) or not torch.isfinite(emb).all():
        raise AssertionError(f"bad embedding forward: launches {elaunches}, shape {tuple(emb.shape)}")
    et = embed_throughput(encoder, ea, iters=10, reps=3)
    phase("throughput", f"spk embedding forward (extract-embeddings: fp32, batch {EMB_BATCH} x {EMB_WINDOW_S} s at "
          f"8 kHz): {et['ms_per_forward']:.3f} ms/forward, {et['windows_per_s']:.1f} windows/s (checksum "
          f"{et['witness']:.6e}, reps {[round(r, 4) for r in et['reps_s']]})")
    del encoder

    # ---- TS-VAD with the conformer and BiLSTM backends at TSVADConfig()
    # widths (bf16, batch 64 x 4 s, 16 kHz): the inference forward runs the
    # fused CAM++ path (fbank 1, cam_block 3, fcm 1), held to the plain
    # twins; five adam steps at 1e-4 on one fixed batch (CAM++ on its module
    # path in train mode, so fbank 1 a step) must lower the loss (at 1e-3 the
    # fresh conformer's loss jumps about: 0.89, 1.74, 1.20, 0.73, 0.99)
    for single, multi in (("conformer", "conformer"), ("transformer", "lstm")):
        tag = f"{single}/{multi}"
        bcfg = dataclasses.replace(cfg, single_backend_type=single, multi_backend_type=multi)
        bmodel = TSVADModel(bcfg, dtype="bf16", device=dev, seed=0)
        with torch.no_grad():
            bmodel(audios[0], embss[0], n_label)  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            blogits = bmodel(audios[1], embss[1], n_label)
            torch.cuda.synchronize()
            blaunches = read_counts()
            ref = plain_forward(bmodel, audios[1], embss[1], n_label)
        mean_err, scale = (blogits - ref).abs().mean().item(), max(1.0, ref.abs().mean().item())
        phase("backends", f"TS-VAD {tag} bf16 (64, 64000) -> {tuple(blogits.shape)}; launches {blaunches}; vs "
              f"plain twins mean-abs {mean_err:.3e} (bar 5e-2 x {scale:.3f})")
        if blaunches != want(fbank=1, cam_block=3, fcm=1) or tuple(blogits.shape) != (64, 100, 4) \
                or not torch.isfinite(blogits).all() or not mean_err <= 5e-2 * scale:
            raise AssertionError(f"TS-VAD {tag}: launches {blaunches}, mean-abs {mean_err} against the twins")
        tpb = throughput(bmodel, audios, embss, n_label, iters=10, reps=3)
        dev_ms = profile(torch.no_grad()(lambda: bmodel(audios[0], embss[0], n_label)))[1]
        phase("throughput", f"TS-VAD {tag} bf16 batch 64 x 4 s: {tpb['ms_per_forward']:.3f} ms/forward, "
              f"{tpb['audio_s_per_s']:.1f} audio-s/s (checksum {tpb['witness']:.6e}, reps "
              f"{[round(r, 4) for r in tpb['reps_s']]}), device {dev_ms:.3f} ms/forward, busy "
              f"{dev_ms / tpb['ms_per_forward']:.3f}")
        bbatches = make_train_batches(bcfg, 64, 4.0, 2, seed=8, device=dev)
        fixed = Trainer(bmodel, make_tsvad_loss(n_label),
                        TrainerConfig(optimizer="adam", schedule="const", learning_rate=1e-4))
        losses, blt = fixed_batch_steps(fixed, bbatches[0], want(fbank=1), f"TS-VAD {tag}")
        tt = train_throughput(recipe_trainer(bmodel, n_label), bbatches, iters=3, reps=2)
        phase("train", f"TS-VAD {tag}: 5 adam steps at 1e-4 on one batch (bf16, 64 x 4 s): losses "
              f"{[round(v, 5) for v in losses]}; launches per step {blt}; recipe step {tt['ms_per_step']:.3f} ms")
        del bmodel, fixed, bbatches

    # ---- TS-VAD with ECAPA-TDNN (1024 channels, frames at 100 Hz, a stride-4
    # conv to 25 Hz) at the leaderboard's ecapa stage settings: 8 kHz, 80
    # bins, batch 32 x 4 s, bf16; the encoder has no kernel of its own, so
    # fbank 1 a forward and a step; then a ResNet34 forward (12.5 Hz frames
    # upsampled x2 by the flax-SAME transposed conv)
    ecfg8 = dataclasses.replace(cfg, speech_encoder_type="ecapa", sample_rate=8000)
    ea8, ee8 = make_inputs(ecfg8, 32, 4.0, 3, seed=9, device=dev)
    for enc_type in ("ecapa", "resnet34"):
        ccfg = dataclasses.replace(ecfg8, speech_encoder_type=enc_type)
        cmodel = TSVADModel(ccfg, dtype="bf16", device=dev, seed=0)
        with torch.no_grad():
            cmodel(ea8[0], ee8[0], n_label)  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            clogits = cmodel(ea8[1], ee8[1], n_label)
            torch.cuda.synchronize()
            claunches = read_counts()
            ref = plain_forward(cmodel, ea8[1], ee8[1], n_label)
        mean_err, scale = (clogits - ref).abs().mean().item(), max(1.0, ref.abs().mean().item())
        phase("encoders", f"TS-VAD {enc_type} bf16 (32, 32000) at 8 kHz -> {tuple(clogits.shape)}; launches "
              f"{claunches}; vs plain twins mean-abs {mean_err:.3e} (bar 5e-2 x {scale:.3f})")
        if claunches != want(fbank=1) or tuple(clogits.shape) != (32, 100, 4) or not torch.isfinite(clogits).all() \
                or not mean_err <= 5e-2 * scale:
            raise AssertionError(f"TS-VAD {enc_type}: launches {claunches}, mean-abs {mean_err} against the twins")
        tpc = throughput(cmodel, ea8, ee8, n_label, iters=10, reps=3)
        phase("throughput", f"TS-VAD {enc_type} bf16 batch 32 x 4 s at 8 kHz: {tpc['ms_per_forward']:.3f} "
              f"ms/forward, {tpc['audio_s_per_s']:.1f} audio-s/s (checksum {tpc['witness']:.6e})")
        if enc_type == "ecapa":
            cb = make_train_batches(ccfg, 32, 4.0, 2, seed=10, device=dev)
            fixed = Trainer(cmodel, make_tsvad_loss(n_label),
                            TrainerConfig(optimizer="adam", schedule="const", learning_rate=1e-4))
            losses, clt = fixed_batch_steps(fixed, cb[0], want(fbank=1), "TS-VAD ECAPA")
            tt = train_throughput(recipe_trainer(cmodel, n_label), cb, iters=3, reps=2)
            phase("train", f"TS-VAD ECAPA: 5 adam steps at 1e-4 on one batch (bf16, 32 x 4 s at 8 kHz): losses "
                  f"{[round(v, 5) for v in losses]}; launches per step {clt}; recipe step {tt['ms_per_step']:.3f} ms")
            del fixed, cb
        del cmodel

    zoo_launches = zoo_phase(dev, smi, plain_forward, want, reset_counts, fixed_batch_steps)
    zoo_launches.update(zoo_cli_chain())

    # ---- speaker-encoder pretraining with ECAPA (512 channels) and ResNet34
    # at stage 2's settings (AAM over 32 speakers, margin 0.3, bf16, batch 64
    # x 2 s at 8 kHz): fbank 1 a step; five adam steps on one batch must lower
    # the loss
    from speaker_diarization_tpu_torch.cli.main import build_model

    for enc_type in ("ecapa", "resnet34"):
        zcfg = dataclasses.replace(scfg, speech_encoder_type=enc_type)
        zmodel = build_model(zcfg, dev)
        fixed = Trainer(zmodel, make_spk_loss(sample_rate=zcfg.sample_rate),
                        TrainerConfig(optimizer="adam", schedule="const", learning_rate=1e-4))
        zlosses, zl = fixed_batch_steps(fixed, sb[0], want(fbank=1), f"spk {enc_type}")
        zt = train_throughput(spk_recipe_trainer(zmodel), sb, iters=3, reps=2)
        phase("spk", f"{enc_type}: 5 adam steps at 1e-4 on one batch (bf16, {SPK_BATCH} x {SPK_DUR_S} s at 8 kHz): "
              f"losses {[round(v, 5) for v in zlosses]}; launches per step {zl}; recipe step {zt['ms_per_step']:.3f} ms")
        del zmodel, fixed

    # ---- remat: a TS-VAD train step (recipe settings, 8 kHz, bf16, batch 64
    # x 4 s, dropout 0.1) with CAM++'s dense layers recomputed in the backward
    # pass and without: the same loss from the same dropout generator, and the
    # peak memory of each
    rcfg = dataclasses.replace(cfg, sample_rate=8000)
    rb = make_train_batches(rcfg, 64, 4.0, 1, seed=11, device=dev)[0]
    peaks, rlosses = {}, {}
    for remat in (False, True):
        rmodel = TSVADModel(rcfg, dtype="bf16", device=dev, seed=1, remat_encoder=remat).train()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = make_tsvad_loss(n_label)(rmodel, rb, torch.Generator(device=dev).manual_seed(3), True)
        loss.backward()
        torch.cuda.synchronize()
        peaks[remat], rlosses[remat] = torch.cuda.max_memory_allocated() / 2**30, loss.item()
        del rmodel, loss
    phase("remat", f"TS-VAD train step (bf16, 64 x 4 s at 8 kHz): loss {rlosses[False]:.7f} without remat, "
          f"{rlosses[True]:.7f} with; max_memory_allocated {peaks[False]:.3f} GiB without, {peaks[True]:.3f} GiB with")
    if not (math.isfinite(rlosses[True]) and abs(rlosses[True] - rlosses[False]) <= 1e-6 * abs(rlosses[False])):
        raise AssertionError(f"remat changed the TS-VAD loss: {rlosses}")
    del rb

    # ---- the seventh and eighth slices at full width, each forward held to
    # its plain twin (bf16 mean-abs, fp32 max-abs), five adam steps on one
    # batch that must lower the loss, and the forward and the leaderboard's
    # train step timed, with the device's busy share from the profiler:
    # SOND (SONDConfig(): 16 profiles, 2517 classes, bf16, 16 x 4 s at
    # 16 kHz; fbank 1), TS-VAD3 (TSVAD3Config(): CAM++ 12/24/16 on both
    # sides, 4 x 6 s enrollment, frame fusion; fbank 2), EEND-VC (the CLI's
    # widths, 32 x 200 frames at 8 kHz; logmel 1), SSND (SSNDConfig(): CAM++
    # 12/24/16 extractor, 4 slots, 1000 global speakers, 16 x 4 s at 16 kHz;
    # fbank 1), EEND-M2F (the CLI's widths, 8 queries, conformer k49, 16 x 500
    # frames at subsampling 1 at 8 kHz; logmel 1), FS-EEND (the CLI's widths,
    # 5 channels, 16 x 500 subsampled frames at 8 kHz; logmel 1) and OTS-VAD
    # (OTSVADConfig(): ResNet34 3,4,6,3, 16 x 4 s at 16 kHz a forward, fbank
    # 1; 16 x (4 s + 4 s) a step, fbank 2)
    from speaker_diarization_tpu_torch.bench import (make_slice_batches, slice_forward, slice_loss, slice_model,
                                                     slice_recipe_trainer, slice_throughput)

    slice_launches = {}
    for fam, per_pass, per_step in (
            ("sond", want(fbank=1), want(fbank=1)), ("tsvad3", want(fbank=2), want(fbank=2)),
            ("eend_vc", want(logmel=1), want(logmel=1)), ("ssnd", want(fbank=1), want(fbank=1)),
            ("eend_m2f", want(logmel=1), want(logmel=1)), ("fs_eend", want(logmel=1), want(logmel=1)),
            ("ots_vad", want(fbank=1), want(fbank=2))):
        smodel7, _ = slice_model(fam, dev, seed=21)
        sb = make_slice_batches(fam, smodel7, 3, seed=22, device=dev)
        fwd = slice_forward(fam, smodel7)
        with torch.no_grad():
            fwd(sb[0])  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            out = fwd(sb[1])
            torch.cuda.synchronize()
            got_launches = read_counts()
            slice_launches[f"{fam}_embed" if fam == "ots_vad" else fam] = got_launches
            outs = out if isinstance(out, tuple) else (out,)
            phase(fam, f"bf16 {tuple(sb[1]['audio'].shape)} -> {[tuple(o.shape) for o in outs]}; launches "
                  f"{got_launches}")
            if got_launches != per_pass or not all(torch.isfinite(o).all() for o in outs):
                raise AssertionError(f"{fam} forward launches {got_launches}, want {per_pass}, or non-finite")
            refs = plain_forward(fwd, sb[1])
            refs = refs if isinstance(refs, tuple) else (refs,)
            errs = [((o.float() - r.float()).abs().mean().item(), max(1.0, r.float().abs().mean().item()))
                    for o, r in zip(outs, refs)]
            phase(fam, "bf16 outputs vs plain twin: mean-abs " + ", ".join(f"{e:.3e} (bar 5e-2 x {sc:.3f})"
                                                                         for e, sc in errs))
            if not all(e <= 5e-2 * sc for e, sc in errs):
                raise AssertionError(f"bf16 {fam} forward disagrees with the plain twin: {errs}")
            m32, _ = slice_model(fam, dev, seed=21, bf16=False)
            b8 = {k: v[:8] for k, v in sb[2].items()}
            if fam in ("eend_vc", "fs_eend"):
                b8["frame_mask"] = b8["frame_mask"].clone()
                b8["frame_mask"][1, 120:] = 0.0  # padded frames too
            f32 = slice_forward(fam, m32)
            got32, ref32 = f32(b8), plain_forward(f32, b8)
            got32 = got32 if isinstance(got32, tuple) else (got32,)
            ref32 = ref32 if isinstance(ref32, tuple) else (ref32,)
            errs32 = [((o - r).abs().max().item(), max(1.0, r.abs().max().item())) for o, r in zip(got32, ref32)]
            phase(fam, "fp32 outputs (B=8) vs plain twin: max-abs " + ", ".join(f"{e:.3e} (bar 1e-3 x {sc:.3f})"
                                                                              for e, sc in errs32))
            if not all(e <= 1e-3 * sc for e, sc in errs32):
                raise AssertionError(f"fp32 {fam} forward disagrees with the plain twin: {errs32}")
            del m32
            table, dev_ms = profile(lambda: fwd(sb[0]))
        tp7 = slice_throughput(fam, smodel7, sb, iters=10, reps=3)
        phase("throughput", f"{fam} bf16 forward, batch {tuple(sb[0]['audio'].shape)}: {tp7['ms_per_forward']:.3f} "
              f"ms/forward, {tp7['audio_s_per_s']:.1f} audio-s/s; profiler device time {dev_ms:.3f} ms/forward, "
              f"busy share {dev_ms / tp7['ms_per_forward']:.3f} (checksum {tp7['witness']:.6e}, reps "
              f"{[round(r, 4) for r in tp7['reps_s']]})")
        # five adam steps on one batch, dropout off, so that the loss moves
        # only with the weights. Adam's first step moves every weight by the
        # rate: at 1e-4 the fresh SOND's loss jumped before it fell and
        # EEND-VC's ended above its start, so these two step at 1e-5
        lr7 = 1e-4 if fam in ("tsvad3", "ssnd", "ots_vad") else 1e-5
        fmodel7, _ = slice_model(fam, dev, seed=21, dropout=0.0)
        fixed = Trainer(fmodel7, slice_loss(fam), TrainerConfig(optimizer="adam", schedule="const",
                                                                learning_rate=lr7))
        losses7, tl7 = fixed_batch_steps(fixed, sb[0], per_step, fam)
        if fam == "ots_vad":
            slice_launches[fam] = tl7
        phase("train", f"{fam}: 5 adam steps at {lr7:g} on one batch (bf16, dropout 0): losses "
              f"{[round(v, 5) for v in losses7]}; launches per step {tl7}")
        del fmodel7, fixed
        if fam == "eend_m2f":  # the matching's host round trip, once a step: every level and batch row
            from speaker_diarization_tpu_torch.ops.hungarian import hungarian_assign

            cost = torch.randn(2 * sb[0]["audio"].shape[0], 3, smodel7.cfg.num_queries, generator=gen).to(dev)
            walls = []
            for _ in range(21):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hungarian_assign(cost)
                walls.append(1e3 * (time.perf_counter() - t0))
            phase(fam, f"Hungarian matching of a step ({tuple(cost.shape)}: 2 decoder levels x the batch, one "
                  f"device-to-host copy, SciPy): median {sorted(walls)[10]:.3f} ms, max {max(walls):.3f} ms")
        rtrainer = slice_recipe_trainer(fam, smodel7)
        tt7 = train_throughput(rtrainer, sb, iters=3, reps=3)
        # one profiled step: the profiler's key_averages over a step's tens of
        # thousands of events costs more host time than the step itself
        _, step_ms = profile(lambda: rtrainer.train_step(sb[0]), n=1)
        phase("throughput", f"{fam} train step (leaderboard settings, bf16, batch {tuple(sb[0]['audio'].shape)}): "
              f"{tt7['ms_per_step']:.3f} ms/step; profiler device time {step_ms:.3f} ms/step, busy share "
              f"{step_ms / tt7['ms_per_step']:.3f} (loss checksum {tt7['witness']:.6e}, reps "
              f"{[round(r, 4) for r in tt7['reps_s']]})")
        del smodel7, rtrainer, sb
        torch.cuda.empty_cache()

    # ---- the ninth slice at full width: the neural VAD (NeuralVADConfig(),
    # fp32 as the vad family trains, batch 16 x 30 s at 16 kHz, neural_sad's
    # chunks: logmel 1 a forward and a step, then 3,000 LSTM steps) and the
    # learned enhancer (EnhancerConfig(), bf16 as the leaderboard's enhance
    # stage trains, batch 16 x 2 s at 8 kHz: no kernel, the STFT, convs and
    # GRUs are plain torch as in JAX). The VAD's forward is held to its plain
    # twin (fp32 max-abs), each forward's launches are checked, five adam
    # steps on one batch must lower the loss, and the forward and the train
    # step are timed with the profiler's busy share
    from speaker_diarization_tpu_torch.bench import SLICE_DTYPES, slice_audio

    for fam, per_pass, lr9 in (("vad", want(logmel=1), 1e-3), ("enhance", want(), 3e-4)):
        bf16 = SLICE_DTYPES.get(fam, "bf16") == "bf16"
        model9, _ = slice_model(fam, dev, seed=31, bf16=bf16)
        sb = make_slice_batches(fam, model9, 3, seed=32, device=dev)
        fwd = slice_forward(fam, model9)
        with torch.no_grad():
            fwd(sb[0])  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            out = fwd(sb[1])
            torch.cuda.synchronize()
            got_launches = read_counts()
            slice_launches[fam] = got_launches
            phase(fam, f"{'bf16' if bf16 else 'fp32'} {tuple(slice_audio(fam, sb[1]).shape)} -> {tuple(out.shape)}; "
                  f"launches {got_launches}")
            if got_launches != per_pass or not torch.isfinite(out).all():
                raise AssertionError(f"{fam} forward launches {got_launches}, want {per_pass}, or non-finite")
            if per_pass != want():  # the enhancer launches no kernel: its twin would run the same code
                ref = plain_forward(fwd, sb[1])
                err, sc = (out - ref).abs().max().item(), max(1.0, ref.abs().max().item())
                phase(fam, f"fp32 output vs plain twin: max-abs {err:.3e} (bar 1e-3 x {sc:.3f})")
                if bf16 or not err <= 1e-3 * sc:
                    raise AssertionError(f"fp32 {fam} forward disagrees with the plain twin: {err} (bf16 {bf16})")
            table, dev_ms = profile(lambda: fwd(sb[0]), n=1, family=fam)
        tp9 = slice_throughput(fam, model9, sb, iters=2 if fam == "vad" else 10, reps=3)
        phase("throughput", f"{fam} {'bf16' if bf16 else 'fp32'} forward, batch {tuple(slice_audio(fam, sb[0]).shape)}: "
              f"{tp9['ms_per_forward']:.3f} ms/forward, {tp9['audio_s_per_s']:.1f} audio-s/s; profiler device time "
              f"{dev_ms:.3f} ms/forward, busy share {dev_ms / tp9['ms_per_forward']:.3f} (checksum "
              f"{tp9['witness']:.6e}, reps {[round(r, 4) for r in tp9['reps_s']]})")
        fixed = Trainer(model9, slice_loss(fam), TrainerConfig(optimizer="adam", schedule="const", learning_rate=lr9))
        losses9, tl9 = fixed_batch_steps(fixed, sb[0], per_pass, fam)
        phase("train", f"{fam}: 5 adam steps at {lr9:g} on one batch ({'bf16' if bf16 else 'fp32'}): losses "
              f"{[round(v, 5) for v in losses9]}; launches per step {tl9}")
        del fixed
        model9, _ = slice_model(fam, dev, seed=31, bf16=bf16)
        rtrainer = slice_recipe_trainer(fam, model9)
        tt9 = train_throughput(rtrainer, sb, iters=1 if fam == "vad" else 3, reps=2 if fam == "vad" else 3)
        _, step_ms = profile(lambda: rtrainer.train_step(sb[0]), n=1, family=fam)
        phase("throughput", f"{fam} train step ({'CLI defaults' if fam == 'vad' else 'leaderboard settings'}, "
              f"{'bf16' if bf16 else 'fp32'}, batch {tuple(slice_audio(fam, sb[0]).shape)}): {tt9['ms_per_step']:.3f} "
              f"ms/step; profiler device time {step_ms:.3f} ms/step, busy share {step_ms / tt9['ms_per_step']:.3f} "
              f"(loss checksum {tt9['witness']:.6e}, reps {[round(r, 4) for r in tt9['reps_s']]})")
        del model9, rtrainer, sb
        torch.cuda.empty_cache()

    # ---- the entry point answers requests: CLI infer + score on a generated corpus
    from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
    from speaker_diarization_tpu_torch.utils.convert import save_flax_npz, tsvad_to_flax

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        corpus = write_synthetic_corpus(os.path.join(tmp, "corpus"), n_recs=3, seconds=30.0, rate=16000,
                                        n_speakers=3, emb_dim=cfg.speaker_embed_dim, seed=0)
        params = os.path.join(tmp, "params.npz")
        save_flax_npz(params, tsvad_to_flax(model.state_dict(), cfg.num_attention_head))
        out = os.path.join(tmp, "hyp")
        cmd = [sys.executable, "-m", "speaker_diarization_tpu_torch.cli", "infer", "--family", "tsvad",
               "--data-dir", corpus["data_dir"], "--emb-store", corpus["emb_store"], "--params", params,
               "--out", out, "--threshold-sweep", "--ref", corpus["rttm"], "--bf16"]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"CLI infer failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        best = re.search(r"best threshold ([0-9.]+) \(DER ([0-9.]+)%\)", res.stdout)
        if not best:
            raise AssertionError(f"CLI infer printed no best threshold:\n{res.stdout}")
        from speaker_diarization_tpu_torch.data.rttm import read_rttm

        sizes = {}
        for fn in sorted(os.listdir(tmp)):
            if fn.startswith("hyp_"):
                sizes[fn] = len(read_rttm(os.path.join(tmp, fn)))
        if len(sizes) != 18 or not any(sizes.values()):
            raise AssertionError(f"threshold sweep RTTMs missing or all empty: {sizes}")
        phase("cli", f"infer --family tsvad: {len(sizes)} RTTMs, turns {list(sizes.values())}, "
              f"best threshold {best.group(1)} DER {best.group(2)}% (random weights), {time.perf_counter() - t0:.1f} s")
        sys_rttm = out + f"_{float(best.group(1)):.2f}"
        res = subprocess.run([sys.executable, "-m", "speaker_diarization_tpu_torch.cli", "score", "--ref", corpus["rttm"],
                              "--sys", sys_rttm], cwd=REPO, capture_output=True, text=True, timeout=300)
        line = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
        if res.returncode != 0 or not re.fullmatch(r"[0-9.]+/[0-9.]+/[0-9.]+/[0-9.]+", line):
            raise RuntimeError(f"CLI score failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        phase("cli", f"score: DER/MS/FA/SC {line}")

    # ---- the training entry point: cli train (Mamba, recipe settings) then infer --exp-dir
    from speaker_diarization_tpu_torch.data.kaldi_io import save_data_dir
    from speaker_diarization_tpu_torch.data.wav import write_wav

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tr = write_synthetic_corpus(os.path.join(tmp, "train"), n_recs=3, seconds=90.0, rate=16000, n_speakers=3,
                                    emb_dim=mcfg.speaker_embed_dim, seed=10, prefix="tr")
        va = write_synthetic_corpus(os.path.join(tmp, "valid"), n_recs=2, seconds=140.0, rate=16000, n_speakers=3,
                                    emb_dim=mcfg.speaker_embed_dim, seed=11, prefix="va")
        tr2 = write_synthetic_corpus(os.path.join(tmp, "train2"), n_recs=1, seconds=60.0, rate=16000, n_speakers=3,
                                     emb_dim=mcfg.speaker_embed_dim, seed=12, prefix="tb")
        noise_wav = os.path.join(tmp, "noise", "n0.wav")
        os.makedirs(os.path.dirname(noise_wav))
        write_wav(noise_wav, (0.1 * torch.randn(160000, generator=gen)).numpy(), 16000)
        save_data_dir(os.path.dirname(noise_wav), {"n0": noise_wav})
        exp = os.path.join(tmp, "exp")
        sets = ["sample_rate=16000", "n_mels=80", "encoder_blocks=12,24,16", "rs_len=4.0", "segment_shift=2.0",
                "batch_size=64", "num_steps=4", "optimizer=adam", "schedule=poly", "learning_rate=2e-4",
                "warmup_steps=400", "bf16=true", "log_every=2", "valid_every=2", "n_layers=2",
                "single_backend_type=mamba", "multi_backend_type=mamba"]
        t0 = time.perf_counter()
        cli("train", "--family", "tsvad", "--train-dir", f"{tr['data_dir']},{tr2['data_dir']}", "--valid-dir",
            va["data_dir"], "--exp-dir", exp, "--emb-store", f"{tr['emb_store']},{tr2['emb_store']},{va['emb_store']}",
            "--noise-dir", os.path.dirname(noise_wav), *[a for kv in sets for a in ("--set", kv)])
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        trains = [r for r in recs if r["kind"] == "train"]
        valids = [r for r in recs if r["kind"] == "valid"]
        ckpts = sorted(fn for fn in os.listdir(exp) if fn.startswith("step_"))
        phase("cli", f"train --family tsvad (Mamba, two --train-dir corpora, bf16, batch 64 x 4 s, 4 steps): "
              f"{time.perf_counter() - t0:.1f} s; "
              f"last log {trains[-1] if trains else None}; valid losses {[round(r['loss'], 5) for r in valids]}; "
              f"checkpoints {ckpts}")
        if len(trains) != 2 or len(valids) != 2 or not all(math.isfinite(r["loss"]) for r in recs) or not ckpts:
            raise AssertionError(f"CLI train did not log, validate and checkpoint as asked: {recs}, {ckpts}")
        out = os.path.join(tmp, "hyp")
        t0 = time.perf_counter()
        stdout = cli("infer", "--family", "tsvad", "--data-dir", va["data_dir"], "--emb-store", va["emb_store"],
                     "--exp-dir", exp, "--out", out, "--threshold-sweep", "--ref", va["rttm"])
        best = re.search(r"best threshold ([0-9.]+) \(DER ([0-9.]+)%\)", stdout)
        n_rttm = sum(fn.startswith("hyp_") for fn in os.listdir(tmp))
        phase("cli", f"infer --exp-dir: {n_rttm} RTTMs, best threshold {best.group(1) if best else None} "
              f"DER {best.group(2) if best else None}% (4 steps of training), {time.perf_counter() - t0:.1f} s")
        if not best or n_rttm != 18:
            raise AssertionError(f"CLI infer --exp-dir wrote {n_rttm} RTTMs:\n{stdout}")

    # ---- the EEND training and inference entry points: cli train (a few
    # steps, validation, checkpoints) → infer --exp-dir --threshold-sweep → score
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eend_") as tmp:
        tr = write_synthetic_corpus(os.path.join(tmp, "train"), n_recs=3, seconds=100.0, rate=8000, n_speakers=2,
                                    seed=20, prefix="tr")
        va = write_synthetic_corpus(os.path.join(tmp, "valid"), n_recs=2, seconds=110.0, rate=8000, n_speakers=2,
                                    seed=21, prefix="va")
        for fam in ("eend", "eend_eda"):
            exp = os.path.join(tmp, "exp_" + fam)
            sets = ["batch_size=32", "bf16=true", "warmup_steps=800", "num_steps=4", "log_every=2", "valid_every=2"]
            t0 = time.perf_counter()
            cli("train", "--family", fam, "--train-dir", tr["data_dir"], "--valid-dir", va["data_dir"], "--exp-dir",
                exp, *[a for kv in sets for a in ("--set", kv)])
            with open(os.path.join(exp, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            trains = [r for r in recs if r["kind"] == "train"]
            valids = [r for r in recs if r["kind"] == "valid"]
            ckpts = sorted(fn for fn in os.listdir(exp) if fn.startswith("step_"))
            phase("cli", f"train --family {fam} (bf16, 6 chunks of 50 s, 4 steps): {time.perf_counter() - t0:.1f} s; "
                  f"last log {trains[-1] if trains else None}; valid losses {[round(r['loss'], 5) for r in valids]}; "
                  f"checkpoints {ckpts}")
            if len(trains) != 2 or len(valids) != 2 or not all(math.isfinite(r["loss"]) for r in recs) or not ckpts:
                raise AssertionError(f"CLI train --family {fam} did not log, validate and checkpoint as asked: {recs}")
            out = os.path.join(tmp, "hyp_" + fam)
            t0 = time.perf_counter()
            stdout = cli("infer", "--data-dir", va["data_dir"], "--exp-dir", exp, "--out", out, "--threshold-sweep",
                         "--ref", va["rttm"])
            best = re.search(r"best threshold ([0-9.]+) \(DER ([0-9.]+)%\)", stdout)
            n_rttm = sum(fn.startswith(f"hyp_{fam}_") for fn in os.listdir(tmp))
            phase("cli", f"infer --exp-dir ({fam}): {n_rttm} RTTMs, best threshold {best.group(1) if best else None} "
                  f"DER {best.group(2) if best else None}% (4 steps of training), {time.perf_counter() - t0:.1f} s")
            if not best or n_rttm != 18:
                raise AssertionError(f"CLI infer --exp-dir ({fam}) wrote {n_rttm} RTTMs:\n{stdout}")
            stdout = cli("score", "--ref", va["rttm"], "--sys", f"{out}_{float(best.group(1)):.2f}")
            line = stdout.strip().splitlines()[-1] if stdout.strip() else ""
            if not re.fullmatch(r"[0-9.]+/[0-9.]+/[0-9.]+/[0-9.]+", line):
                raise RuntimeError(f"CLI score ({fam}) printed no DER line:\n{stdout}")
            phase("cli", f"score ({fam}): DER/MS/FA/SC {line}")

    # ---- the hermetic TS-VAD recipe on the port (recipes/hermetic_tsvad_full_stack.sh,
    # every stage through the CLI at full width, on a small corpus)
    cli_sites = recipe_chain()

    # ---- the parallel layer at world size 1, DiCoW at DiCoW v3's widths, the hermetic DiCoW check
    parallel_sites = parallel_phase(dev, smi, reset_counts, want)
    dicow_phase(dev, smi)
    dicow_hermetic_phase(dev, smi)
    orbax_sites = orbax_phase(dev, smi, plain_forward, want, reset_counts)

    # where each kernel launched, per path driven above (counts of one forward
    # or step; of a whole run for the CLI verbs of recipe_chain)
    sites = {"tsvad": launches, "tsvad_mamba": mlaunches, "tsvad_mamba_train_step": tlaunches, **eend_launches,
             **slice_launches, **zoo_launches, **cli_sites, **parallel_sites, **orbax_sites}
    kernels = []
    scan_src, scan_tpu = "speaker_diarization_tpu_torch/csrc/selective_scan.cu", "speaker_diarization_tpu/kernels/selective_scan_pallas.py"
    for key, src, replaces, path_launches in (
        ("fbank", "speaker_diarization_tpu_torch/csrc/fbank.cu", "speaker_diarization_tpu/kernels/fbank_pallas.py:43", mlaunches),
        ("logmel", "speaker_diarization_tpu_torch/csrc/fbank.cu", "speaker_diarization_tpu/kernels/fbank_pallas.py:195",
         eend_launches["eend"]),
        ("cam_block", "speaker_diarization_tpu_torch/csrc/cam_block.cu", "speaker_diarization_tpu/kernels/cam_block_pallas.py:43", mlaunches),
        ("selective_scan_fwd", scan_src, f"{scan_tpu}:50", mlaunches),
        ("selective_scan_fwd_states", scan_src, f"{scan_tpu}:148", tlaunches),
        ("selective_scan_bwd", scan_src, f"{scan_tpu}:190", tlaunches),
        ("fcm", "speaker_diarization_tpu_torch/csrc/fcm.cu", "speaker_diarization_tpu/kernels/fcm_pallas.py:243",
         launches),
    ):
        r = records[key]
        # no single PyTorch call computes any of these functions, so library_ms is null
        kernels.append(dict(
            name=key, route="cuda", source=src, replaces=replaces, launches=path_launches[key], max_abs_err=r["err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            launch_sites={path: c[key] for path, c in sites.items() if c[key]},
        ))
    phase("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
