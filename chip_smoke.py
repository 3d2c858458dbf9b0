#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ and holds each one (K1 fbank, K2
CAM++ dense block, K3a/K3b/K3c selective scan) against its plain PyTorch
twin on the card at the shapes of the main paths. Then drives, each with the
launch counts set to 0 just before and read just after:
- the full-width TS-VAD forward (TSVADConfig(), bf16, batch 64 × 4 s, seeded
  random weights): fbank 1, cam_block 3;
- the same with BiMamba backends (d_state 64): fbank 1, cam_block 3,
  selective_scan_fwd 8;
- a Mamba TS-VAD train step at the hermetic recipe's settings: fbank 1,
  selective_scan_fwd_states 8, selective_scan_bwd 8; five steps on one
  fixed batch must lower the loss;
then the CLI: `infer --family tsvad` + `score` from flax-layout weights, and
`train --family tsvad` (Mamba, batch 64 × 4 s, bf16, with validation and
checkpoints) followed by `infer --exp-dir` on generated corpora. Each phase
prints one line and raises on failure. The last lines are the kernels' JSON
record, the card's name and power limit, and {"ok": true, "device": ...}.
Needs one CUDA device; imports nothing of JAX.
"""

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


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "speaker_diarization_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)

    from speaker_diarization_tpu_torch.bench import make_inputs, throughput
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
    built = _build.build_all()
    phase("build", f"{json.dumps({k: round(v, 2) for k, v in built.items()})} wall {time.perf_counter() - t0:.2f} s "
          f"(cached: {sorted(set(_build.sources()) - set(built))})")
    for src in _build.sources():
        for line in _build.build_log(src).splitlines():
            if re.search(r"registers|spill", line):
                phase("ptxas", f"{src}: {line.strip()}")

    gen = torch.Generator(device="cpu").manual_seed(0)
    records = {}

    # ---- K1: fbank kernel vs its plain twin (fp32)
    for sr, n_mels, shape in ((16000, 80, (64, 64000)), (8000, 80, (64, 32000))):
        x = (0.1 * torch.randn(shape, generator=gen)).to(dev)
        got = K1.fbank_cuda(x, sample_rate=sr, num_mel_bins=n_mels)
        ref = FE.kaldi_fbank_torch(x, sample_rate=sr, num_mel_bins=n_mels, mean_norm=False)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        ms = cuda_ms(lambda: K1.fbank_cuda(x, sample_rate=sr, num_mel_bins=n_mels))
        plain = cuda_ms(lambda: FE.kaldi_fbank_torch(x, sample_rate=sr, num_mel_bins=n_mels, mean_norm=False))
        work = K1.fbank_work(shape[0], shape[1], sr, n_mels)
        bms, by = bound(work, H100_FP32_FLOPS)
        phase("K1", f"fbank {sr} Hz/{n_mels} {tuple(shape)} -> {tuple(got.shape)}: max-abs {err:.3e} (bar 5e-3), "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms ({by})")
        if not (err <= 5e-3 and torch.isfinite(got).all()):
            raise AssertionError(f"K1 disagrees with its twin at {sr} Hz: max-abs {err}")
        if sr == 16000:
            records["fbank"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, err=err)

    # ---- K2: dense-block kernel vs its plain twin, the three flagship blocks
    cfg = TSVADConfig()
    model = TSVADModel(cfg, dtype="bf16", device=dev, seed=0)
    camp = model.speech_encoder
    fp_bf16 = CF.fused_params(camp, torch.bfloat16)
    blocks, c0 = [], camp.init_channels
    for i, (L, dil) in enumerate(zip(camp.block_layers, camp.block_dilations)):
        blocks.append((i + 1, c0, L, dil))
        c0 = (c0 + 32 * L) // 2
    k2 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, bytes=0.0, flops=0.0)
    B, T = 64, 199
    if K2.u_in_global(T, torch.bfloat16):
        raise AssertionError(f"K2 at the main path's T={T} should keep u in shared memory")
    for idx, c0, L, dil in blocks:
        bp = fp_bf16[f"block{idx}"]
        x = torch.randn((B, T, c0), generator=gen).to(dev, torch.bfloat16)
        got = K2.cam_dense_block_cuda(x, bp, dil)
        ref = K2.cam_dense_block_infer(x, bp, dil, dtype=torch.bfloat16)
        d = (got.float() - ref.float()).abs()
        mean_err, max_err = d.mean().item(), d.max().item()
        # the grown channels only (the first c0 are copied): mean-abs and a
        # max-abs of 4 bf16 steps at the largest magnitude of the twin's output
        grown = d[..., c0:]
        top = ref[..., c0:].float().abs().max().item()
        max_bar = 4 * 2.0 ** (math.floor(math.log2(max(top, 2.0 ** -30))) - 7)
        grown_mean = grown.mean().item()
        ms = cuda_ms(lambda: K2.cam_dense_block_cuda(x, bp, dil), iters=10)
        plain = cuda_ms(lambda: K2.cam_dense_block_infer(x, bp, dil, dtype=torch.bfloat16), iters=5)
        work = K2.cam_block_work(B, T, c0, L, elem_bytes=2)
        bms, _ = bound(work, H100_BF16_FLOPS)
        phase("K2", f"block{idx} bf16 B={B} T={T} c0={c0} L={L} d={dil}: mean-abs {mean_err:.3e} (bar 5e-2), "
              f"max-abs {max_err:.3e}; grown channels mean-abs {grown_mean:.3e} (bar 1e-3), max-abs "
              f"{grown.max().item():.3e} (bar {max_bar:.3e}, max|twin| {top:.3f}); "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms")
        if not (mean_err <= 5e-2 and grown_mean <= 1e-3 and grown.max().item() <= max_bar
                and torch.isfinite(got.float()).all()):
            raise AssertionError(f"K2 block{idx} bf16 disagrees with its twin: mean-abs {mean_err}, "
                                 f"grown mean-abs {grown_mean}, grown max-abs {grown.max().item()} (bar {max_bar})")
        k2["ms"] += ms
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
    # any B and T: a short window (one partial segment) and a 3-segment one
    _, c0, L, dil = blocks[0]
    fp32 = CF.prepare_block_params(camp.xvector.block1, c0, c0 + 32 * L, torch.float32)
    for Bx, Tx in ((3, 57), (5, 250)):
        x32 = torch.randn((Bx, Tx, c0), generator=gen).to(dev)
        err = (K2.cam_dense_block_cuda(x32, fp32, dil) - K2.cam_dense_block_infer(x32, fp32, dil, dtype=torch.float32)).abs().max().item()
        phase("K2", f"block1 fp32 B={Bx} T={Tx}: max-abs {err:.3e} (bar 2e-4)")
        if not err <= 2e-4:
            raise AssertionError(f"K2 block1 fp32 B={Bx} T={Tx} disagrees with its twin: max-abs {err}")
    # windows too long for u to fit shared memory: the kernel's global-scratch instance
    for idx, Bx, Tx, dt, bar in ((2, 4, 400, torch.float32, 2e-4), (3, 4, 700, torch.bfloat16, None)):
        _, c0, L, dil = blocks[idx - 1]
        if not K2.u_in_global(Tx, dt):
            raise AssertionError(f"K2 at T={Tx} {dt} should keep u in the global scratch")
        bp = fp_bf16[f"block{idx}"] if dt == torch.bfloat16 else CF.prepare_block_params(
            getattr(camp.xvector, f"block{idx}"), c0, c0 + 32 * L, torch.float32)
        x = torch.randn((Bx, Tx, c0), generator=gen).to(dev, dt)
        got, ref = K2.cam_dense_block_cuda(x, bp, dil), K2.cam_dense_block_infer(x, bp, dil, dtype=dt)
        d = (got.float() - ref.float()).abs()[..., c0:]
        if bar is None:  # bf16: 4 steps at the twin's largest magnitude, and the mean
            top = ref[..., c0:].float().abs().max().item()
            bar = 4 * 2.0 ** (math.floor(math.log2(max(top, 2.0 ** -30))) - 7)
            ok = d.mean().item() <= 1e-3
        else:
            ok = True
        phase("K2", f"block{idx} {str(dt)[6:]} B={Bx} T={Tx} (u in global scratch): grown max-abs "
              f"{d.max().item():.3e} (bar {bar:.3e}), mean-abs {d.mean().item():.3e}")
        if not (ok and d.max().item() <= bar and torch.isfinite(got.float()).all()):
            raise AssertionError(f"K2 block{idx} T={Tx} {dt} (global scratch) disagrees with its twin")
    k2["bound_by"] = bound(k2, H100_BF16_FLOPS)[1]
    records["cam_block"] = k2

    # ---- K3a/K3b/K3c: the selective-scan kernels vs their plain twins (fp32)
    # at the Mamba main path's two shapes, T = 100, d_inner 768, d_state 64:
    # the single backend's B·S = 256 rows and the multi backend's 64. Each
    # forward or train step launches each kernel 4 times at each shape, so
    # the records are per forward (K3a) or per train step (K3b, K3c).
    # Bars: y and h0 within 1e-4 · max(1, max|twin|) (a few ulp of exp per
    # step over 100 steps); each gradient within 1e-3 · max|twin gradient|
    # (dA and dD sum 25,600 rows in another order).
    from speaker_diarization_tpu_torch.kernels import selective_scan as K3
    from speaker_diarization_tpu_torch.ops.mamba_scan import selective_scan_sequential

    k3 = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, bytes=0.0, flops=0.0, exps=0.0)
          for k in ("selective_scan_fwd", "selective_scan_fwd_states", "selective_scan_bwd")}
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
        y2, h0 = K3.selective_scan_fwd_states(*a3)
        yr, h0r = K3.selective_scan_states_ref(*a3)
        grads = K3.selective_scan_bwd(*a3, h0, gy)
        grads_r = K3.selective_scan_bwd_ref(*a3, h0r, gy)
        torch.cuda.synchronize()
        y_bar, h_bar = 1e-4 * max(1.0, yr.abs().max().item()), 1e-4 * max(1.0, h0r.abs().max().item())
        e_fwd = (y - yr).abs().max().item()
        e_y2, e_h0 = (y2 - yr).abs().max().item(), (h0 - h0r).abs().max().item()
        g_errs = {n: ((p - q).abs().max().item(), 1e-3 * q.abs().max().item())
                  for n, p, q in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), grads, grads_r)}
        phase("K3", f"({Bs}, {T3}, {D3}, {N3}) fwd max-abs {e_fwd:.3e} (bar {y_bar:.3e}); fwd_states y {e_y2:.3e}, "
              f"h0 {e_h0:.3e} (bar {h_bar:.3e}); bwd " + ", ".join(f"{n} {e:.3e} (bar {b:.3e})" for n, (e, b) in g_errs.items()))
        if not (e_fwd <= y_bar and e_y2 <= y_bar and e_h0 <= h_bar and all(e <= b for e, b in g_errs.values())
                and all(torch.isfinite(t).all() for t in (y, y2, h0, *grads))):
            raise AssertionError(f"K3 disagrees with its twins at B={Bs}")
        times = {
            "selective_scan_fwd": (cuda_ms(lambda: K3.selective_scan_fwd(*a3)),
                                   cuda_ms(lambda: selective_scan_sequential(*a3), iters=3, warmup=1), "fwd", e_fwd),
            "selective_scan_fwd_states": (cuda_ms(lambda: K3.selective_scan_fwd_states(*a3)),
                                          cuda_ms(lambda: K3.selective_scan_states_ref(*a3), iters=3, warmup=1),
                                          "states", max(e_y2, e_h0)),
            "selective_scan_bwd": (cuda_ms(lambda: K3.selective_scan_bwd(*a3, h0, gy), iters=5),
                                   cuda_ms(lambda: K3.selective_scan_bwd_ref(*a3, h0r, gy), iters=2, warmup=1),
                                   "bwd", max(e for e, _ in g_errs.values())),
        }
        for key, (ms, plain, kind, err) in times.items():
            work = K3.scan_work(kind, Bs, T3, D3, N3)
            bms, by = bound(work, H100_FP32_FLOPS)
            phase("K3", f"{key} ({Bs}, {T3}, {D3}, {N3}): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"bound {bms:.4f} ms ({by}) per launch")
            r = k3[key]
            r["ms"] += 4 * ms
            r["plain_ms"] += 4 * plain
            r["bound_ms"] += 4 * bms
            r["err"] = max(r["err"], err)
            for q in ("bytes", "flops", "exps"):
                r[q] += 4 * work[q]
    # ragged shapes: T not a multiple of the chunk or the time tile, d_inner
    # not a multiple of the block, every built d_state
    for Bs, Tx, Dx, Nx in ((3, 37, 100, 8), (2, 50, 200, 16), (4, 33, 130, 32)):
        x = torch.randn((Bs, Tx, Dx), generator=gen).to(dev)
        dt = (0.01 + 0.1 * torch.rand((Bs, Tx, Dx), generator=gen)).to(dev)
        A = -torch.exp(torch.randn((Dx, Nx), generator=gen)).to(dev)
        a3 = (x, dt, A, torch.randn((Bs, Tx, Nx), generator=gen).to(dev),
              torch.randn((Bs, Tx, Nx), generator=gen).to(dev), torch.randn(Dx, generator=gen).to(dev))
        gy = torch.randn((Bs, Tx, Dx), generator=gen).to(dev)
        yr, h0r = K3.selective_scan_states_ref(*a3)
        y2, h0 = K3.selective_scan_fwd_states(*a3)
        e = max((K3.selective_scan_fwd(*a3) - yr).abs().max().item(), (y2 - yr).abs().max().item())
        ge = max(((p - q).abs().max() / q.abs().max()).item()
                 for p, q in zip(K3.selective_scan_bwd(*a3, h0, gy), K3.selective_scan_bwd_ref(*a3, h0r, gy)))
        phase("K3", f"({Bs}, {Tx}, {Dx}, {Nx}): y max-abs {e:.3e} (bar {1e-4 * max(1.0, yr.abs().max().item()):.3e}), "
              f"gradients max-abs / max|twin| {ge:.3e} (bar 1e-3)")
        if not (e <= 1e-4 * max(1.0, yr.abs().max().item()) and ge <= 1e-3):
            raise AssertionError(f"K3 disagrees with its twins at ({Bs}, {Tx}, {Dx}, {Nx})")
    for r in k3.values():
        r["bound_by"] = bound(r, H100_FP32_FLOPS)[1]
    records.update(k3)

    # ---- the main path: full-width TS-VAD forward through the kernels
    from speaker_diarization_tpu_torch.models import mamba as MB

    wrappers = {"fbank": K1.fbank_cuda, "cam_block": K2.cam_dense_block_cuda,
                "selective_scan_fwd": K3.selective_scan_fwd, "selective_scan_fwd_states": K3.selective_scan_fwd_states,
                "selective_scan_bwd": K3.selective_scan_bwd}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in wrappers.items()}

    def want(**nonzero):
        return {k: nonzero.get(k, 0) for k in wrappers}

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
        if launches != want(fbank=1, cam_block=3):
            raise AssertionError(f"main path launches {launches}, want fbank 1 and cam_block 3")
        if tuple(logits.shape) != (64, 100, 4) or not torch.isfinite(logits).all():
            raise AssertionError("bad logits from the main path")

        def plain_forward(m, a, e, n_label=n_label):
            """The same model with every kernel replaced by its plain twin."""
            saved = (FE.kaldi_fbank_auto, CF._dense_block_auto, MB.selective_scan_auto)
            FE.kaldi_fbank_auto = lambda w, sample_rate, num_mel_bins, mean_norm: FE.kaldi_fbank_torch(
                w, sample_rate=sample_rate, num_mel_bins=num_mel_bins, mean_norm=mean_norm)
            CF._dense_block_auto = lambda h, bp, dil, dtype: K2.cam_dense_block_infer(h, bp, dil, dtype=dtype)
            MB.selective_scan_auto = selective_scan_sequential
            try:
                return m(a, e, n_label)
            finally:
                FE.kaldi_fbank_auto, CF._dense_block_auto, MB.selective_scan_auto = saved

        ref = plain_forward(model, audios[1], embss[1])
        mean_err = (logits - ref).abs().mean().item()
        scale = max(1.0, ref.abs().mean().item())
        phase("forward", f"bf16 logits vs plain twins: mean-abs {mean_err:.3e} (bar 5e-2 x {scale:.3f}), "
              f"max-abs {(logits - ref).abs().max().item():.3e}")
        if not mean_err <= 5e-2 * scale:
            raise AssertionError(f"bf16 main path disagrees with the plain twins: mean-abs {mean_err}")
        m32 = TSVADModel(cfg, dtype="fp32", device=dev, seed=0)
        a8, e8 = audios[2][:8], embss[2][:8]
        got32, ref32 = m32(a8, e8, n_label), plain_forward(m32, a8, e8)
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
        if mlaunches != want(fbank=1, cam_block=3, selective_scan_fwd=8):
            raise AssertionError(f"Mamba path launches {mlaunches}, want fbank 1, cam_block 3, selective_scan_fwd 8")
        if tuple(mlogits.shape) != (64, 100, 4) or not torch.isfinite(mlogits).all():
            raise AssertionError("bad logits from the Mamba path")
        ref = plain_forward(mmodel, audios[1], embss[1])
        mean_err, scale = (mlogits - ref).abs().mean().item(), max(1.0, ref.abs().mean().item())
        phase("mamba", f"bf16 logits vs plain twins: mean-abs {mean_err:.3e} (bar 5e-2 x {scale:.3f}), "
              f"max-abs {(mlogits - ref).abs().max().item():.3e}")
        if not mean_err <= 5e-2 * scale:
            raise AssertionError(f"bf16 Mamba path disagrees with the plain twins: mean-abs {mean_err}")
        m32 = TSVADModel(mcfg, dtype="fp32", device=dev, seed=0)
        got32, ref32 = m32(audios[2][:8], embss[2][:8], n_label), plain_forward(m32, audios[2][:8], embss[2][:8])
        err32, scale32 = (got32 - ref32).abs().max().item(), max(1.0, ref32.abs().max().item())
        phase("mamba", f"fp32 logits (B=8) vs plain twins: max-abs {err32:.3e} (bar 1e-3 x {scale32:.3f})")
        if not err32 <= 1e-3 * scale32:
            raise AssertionError(f"fp32 Mamba forward disagrees with the plain twins: max-abs {err32}")
        del m32
    tpm = throughput(mmodel, audios, embss, n_label, iters=20, reps=3)
    phase("throughput", f"TS-VAD-Mamba bf16 batch 64 x 4 s: {tpm['ms_per_forward']:.3f} ms/forward, "
          f"{tpm['audio_s_per_s']:.1f} audio-s/s (checksum {tpm['witness']:.6e}, reps {[round(r, 4) for r in tpm['reps_s']]})")
    del mmodel

    # ---- the training path: Mamba TS-VAD train steps (K1, K3b, K3c)
    from speaker_diarization_tpu_torch.bench import make_train_batches, recipe_trainer, train_throughput
    from speaker_diarization_tpu_torch.train.tasks import make_tsvad_loss
    from speaker_diarization_tpu_torch.train.trainer import Trainer, TrainerConfig

    tmodel = TSVADModel(mcfg, dtype="bf16", device=dev, seed=1)
    batches = make_train_batches(mcfg, 64, 4.0, 4, seed=2, device=dev)
    # five adam steps at a constant 1e-3 on one fixed batch: the loss must fall
    fixed = Trainer(tmodel, make_tsvad_loss(n_label), TrainerConfig(optimizer="adam", schedule="const", learning_rate=1e-3))
    losses = []
    for i in range(5):
        torch.cuda.synchronize()
        reset_counts()
        aux = fixed.train_step(batches[0])
        torch.cuda.synchronize()
        tlaunches = read_counts()
        losses.append(aux["loss"].item())
        if tlaunches != want(fbank=1, selective_scan_fwd_states=8, selective_scan_bwd=8):
            raise AssertionError(f"train step {i} launches {tlaunches}, want fbank 1, "
                                 "selective_scan_fwd_states 8, selective_scan_bwd 8")
    phase("train", f"5 steps on one batch (bf16, 64 x 4 s): losses {[round(v, 5) for v in losses]}; "
          f"launches per step {tlaunches}")
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall on a fixed batch: {losses}")
    tt = train_throughput(recipe_trainer(tmodel, n_label), batches, iters=5, reps=3)
    phase("throughput", f"TS-VAD-Mamba train step (recipe: adam, poly, bf16, batch 64 x 4 s): "
          f"{tt['ms_per_step']:.3f} ms/step (loss checksum {tt['witness']:.6e}, reps {[round(r, 4) for r in tt['reps_s']]})")
    del tmodel, fixed, batches

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
        noise_wav = os.path.join(tmp, "noise", "n0.wav")
        os.makedirs(os.path.dirname(noise_wav))
        write_wav(noise_wav, (0.1 * torch.randn(160000, generator=gen)).numpy(), 16000)
        save_data_dir(os.path.dirname(noise_wav), {"n0": noise_wav})
        exp = os.path.join(tmp, "exp")
        sets = ["sample_rate=16000", "n_mels=80", "encoder_blocks=12,24,16", "rs_len=4.0", "segment_shift=2.0",
                "batch_size=64", "num_steps=4", "optimizer=adam", "schedule=poly", "learning_rate=2e-4",
                "warmup_steps=400", "bf16=true", "log_every=2", "valid_every=2", "n_layers=2",
                "single_backend_type=mamba", "multi_backend_type=mamba"]
        cmd = [sys.executable, "-m", "speaker_diarization_tpu_torch.cli", "train", "--family", "tsvad",
               "--train-dir", tr["data_dir"], "--valid-dir", va["data_dir"], "--exp-dir", exp,
               "--emb-store", f"{tr['emb_store']},{va['emb_store']}", "--noise-dir", os.path.dirname(noise_wav)]
        cmd += [a for kv in sets for a in ("--set", kv)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"CLI train failed ({res.returncode}):\n{res.stdout}\n{res.stderr[-6000:]}")
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        trains = [r for r in recs if r["kind"] == "train"]
        valids = [r for r in recs if r["kind"] == "valid"]
        ckpts = sorted(fn for fn in os.listdir(exp) if fn.startswith("step_"))
        phase("cli", f"train --family tsvad (Mamba, bf16, batch 64 x 4 s, 4 steps): {time.perf_counter() - t0:.1f} s; "
              f"last log {trains[-1] if trains else None}; valid losses {[round(r['loss'], 5) for r in valids]}; "
              f"checkpoints {ckpts}")
        if len(trains) != 2 or len(valids) != 2 or not all(math.isfinite(r["loss"]) for r in recs) or not ckpts:
            raise AssertionError(f"CLI train did not log, validate and checkpoint as asked: {recs}, {ckpts}")
        out = os.path.join(tmp, "hyp")
        cmd = [sys.executable, "-m", "speaker_diarization_tpu_torch.cli", "infer", "--family", "tsvad",
               "--data-dir", va["data_dir"], "--emb-store", va["emb_store"], "--exp-dir", exp,
               "--out", out, "--threshold-sweep", "--ref", va["rttm"]]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"CLI infer --exp-dir failed ({res.returncode}):\n{res.stdout}\n{res.stderr[-6000:]}")
        best = re.search(r"best threshold ([0-9.]+) \(DER ([0-9.]+)%\)", res.stdout)
        n_rttm = sum(fn.startswith("hyp_") for fn in os.listdir(tmp))
        phase("cli", f"infer --exp-dir: {n_rttm} RTTMs, best threshold {best.group(1) if best else None} "
              f"DER {best.group(2) if best else None}% (4 steps of training), {time.perf_counter() - t0:.1f} s")
        if not best or n_rttm != 18:
            raise AssertionError(f"CLI infer --exp-dir wrote {n_rttm} RTTMs:\n{res.stdout}")

    kernels = []
    scan_src, scan_tpu = "speaker_diarization_tpu_torch/csrc/selective_scan.cu", "speaker_diarization_tpu/kernels/selective_scan_pallas.py"
    for key, src, replaces, path_launches in (
        ("fbank", "speaker_diarization_tpu_torch/csrc/fbank.cu", "speaker_diarization_tpu/kernels/fbank_pallas.py:43", mlaunches),
        ("cam_block", "speaker_diarization_tpu_torch/csrc/cam_block.cu", "speaker_diarization_tpu/kernels/cam_block_pallas.py:43", mlaunches),
        ("selective_scan_fwd", scan_src, f"{scan_tpu}:50", mlaunches),
        ("selective_scan_fwd_states", scan_src, f"{scan_tpu}:148", tlaunches),
        ("selective_scan_bwd", scan_src, f"{scan_tpu}:190", tlaunches),
    ):
        r = records[key]
        # no single PyTorch call computes any of these functions, so library_ms is null
        kernels.append(dict(
            name=key, route="cuda", source=src, replaces=replaces, launches=path_launches[key], max_abs_err=r["err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
        ))
    phase("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
