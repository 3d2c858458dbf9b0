"""K1 and K1′ on the CPU: the kernel's decomposition, emulated in float32.

csrc/fbank.cu runs on the card only. What it computes is held here: a NumPy
emulation of its half-length FFT (the even/odd packing, the radix passes in
the kernel's order with its shared-memory indexing and twiddle table, the
register layout after the last pass and the split post-pass with its
partner lanes, through the exchange buffer where a frame spans two warps)
against np.fft.rfft; then K1 and K1′ emulated end to end, framed tile by
tile from the Python launch plan, against their plain twins.
"""

import numpy as np
import pytest
import torch

from speaker_diarization_tpu_torch.kernels import fbank as K1
from speaker_diarization_tpu_torch.kernels._build import SMEM_LIMIT
from speaker_diarization_tpu_torch.ops import features as TF

torch.set_num_threads(1)

# the kernel's W16^e = exp(-2πi e/16) literals, e < 8
W16R = np.cos(2 * np.pi * np.arange(8) / 16).astype(np.float32)
W16I = (-np.sin(2 * np.pi * np.arange(8) / 16)).astype(np.float32)


def _pad(i):
    """The exchange buffer's index: one float of padding after every 16."""
    return i + i // 16


def _dft(re, im):
    """`dft<R>` of the kernel: radix-2 decimation in time, natural order,
    W16 literals, the W = 1 and W = -i products left out."""
    R = len(re)
    if R == 1:
        return re, im
    er, ei = _dft(re[0::2], im[0::2])
    orr, oi = _dft(re[1::2], im[1::2])
    out_r, out_i = [None] * R, [None] * R
    for k in range(R // 2):
        e = k * (16 // R)
        if e == 0:
            tr, ti = orr[k], oi[k]
        elif e == 4:
            tr, ti = oi[k], -orr[k]
        else:
            tr = orr[k] * W16R[e] - oi[k] * W16I[e]
            ti = orr[k] * W16I[e] + oi[k] * W16R[e]
        out_r[k], out_i[k] = er[k] + tr, ei[k] + ti
        out_r[k + R // 2], out_i[k + R // 2] = er[k] - tr, ei[k] - ti
    return out_r, out_i


def kernel_power(x, tw_re, tw_im):
    """4·|rfft(x)|² of (F, n_fft) float32 frames, bins 0..n_fft/2, as the
    kernel computes it: z[n] = x[2n] + i·x[2n+1]; thread t of a frame's
    P = n_fft/32 holds z[t + P·r] in register r; Stockham passes of
    `fft_radices` through the padded exchange buffer; then the mirrored
    bins k = t + P·w and M - k, w < 8, from Z[k] in a register and Z[M-k]
    from lane (P - t) mod P (at P = 64, two warps a frame, through the
    exchange buffer: thread t stores its 8 partner values at
    pad(P·w + t) and reads lane (P - t) mod P's), and M/2 on thread 0."""
    F, n_fft = x.shape
    M, P = n_fft // 2, n_fft // 32
    t = np.arange(P)
    a = np.arange(M)
    wm_re = np.where(2 * a < M, tw_re[(2 * a) % M], -tw_re[(2 * a) % M]).astype(np.float32)
    wm_im = np.where(2 * a < M, tw_im[(2 * a) % M], -tw_im[(2 * a) % M]).astype(np.float32)
    # registers: 16 arrays of (F, P), one per register, across the frame's threads
    re = [x[:, 2 * (t + P * r)] for r in range(16)]
    im = [x[:, 2 * (t + P * r) + 1] for r in range(16)]
    buf_re = np.full((F, _pad(M - 1) + 1), np.nan, np.float32)
    buf_im = buf_re.copy()
    radices = K1.fft_radices(n_fft)
    ns = 1
    for p, R in enumerate(radices):
        nb = 16 // R
        js = [t + P * u for u in range(nb)]
        if p > 0:  # read the pass's inputs from the exchange buffer
            for u, j in enumerate(js):
                for q in range(R):
                    re[u * R + q] = buf_re[:, _pad(j + (M // R) * q)]
                    im[u * R + q] = buf_im[:, _pad(j + (M // R) * q)]
        for u, j in enumerate(js):
            g = slice(u * R, (u + 1) * R)
            if ns > 1:
                for q in range(1, R):
                    w = (j % ns) * q * (M // (ns * R))
                    vr, vi = re[u * R + q], im[u * R + q]
                    re[u * R + q] = vr * wm_re[w] - vi * wm_im[w]
                    im[u * R + q] = vr * wm_im[w] + vi * wm_re[w]
            re[g], im[g] = _dft(re[g], im[g])
        if p < len(radices) - 1:
            buf_re[:] = np.nan
            buf_im[:] = np.nan
            for u, j in enumerate(js):
                dst = (j // ns) * ns * R + j % ns
                for q in range(R):
                    buf_re[:, _pad(dst + ns * q)] = re[u * R + q]
                    buf_im[:, _pad(dst + ns * q)] = im[u * R + q]
        ns *= R
    assert ns == M
    nb = 16 // radices[-1]

    def reg(w):  # the register of thread t that holds Z[t + P·w]
        return (w % nb) * radices[-1] + w // nb

    def mirrored_pair(power, ar, ai, pr, pi, k):  # 4|X[k]|², 4|X[M-k]|² from E, D, V = i·W·D
        er, ei, dr, di = ar + pr, ai - pi, ar - pr, ai + pi
        vr = -(tw_re[k] * di + tw_im[k] * dr)
        vi = tw_re[k] * dr - tw_im[k] * di
        power[:, k] = (er - vr) * (er - vr) + (ei - vi) * (ei - vi)
        power[:, M - k] = (er + vr) * (er + vr) + (ei + vi) * (ei + vi)

    power = np.full((F, M + 1), np.nan, np.float32)
    partner = (P - t) % P
    if P > 32:  # the partners cross the exchange buffer, which holds nothing else now
        buf_re[:] = np.nan
        buf_im[:] = np.nan
        for w in range(8):
            buf_re[:, _pad(P * w + t)] = re[reg(15 - w)]
            buf_im[:, _pad(P * w + t)] = im[reg(15 - w)]
        partners = [(buf_re[:, _pad(P * w + partner)], buf_im[:, _pad(P * w + partner)]) for w in range(8)]
    else:  # by shuffle from lane (P - t) mod P
        partners = [(re[reg(15 - w)][:, partner], im[reg(15 - w)][:, partner]) for w in range(8)]
    for w in range(8):  # thread t: bins t + P·w and their mirrors
        pr, pi = partners[w][0].copy(), partners[w][1].copy()
        pr[:, 0], pi[:, 0] = re[reg((16 - w) % 16)][:, 0], im[reg((16 - w) % 16)][:, 0]
        mirrored_pair(power, re[reg(w)], im[reg(w)], pr, pi, t + P * w)
    ar, ai = re[reg(8)][:, :1], im[reg(8)][:, :1]  # thread 0: M/2, its own mirror
    mirrored_pair(power, ar, ai, ar, ai, np.array([M // 2]))
    return power


def emulate(x, T, consts, frame_len, shift, n_fft, n_mels, pad, scale, preemph, remove_dc, log10, floor):
    """One launch of the kernel over (B, N) audio, emulated: the plan's CTAs
    walk their tiles, stage each tile's span (zeros outside the audio),
    transform its frames, and write the mel rows; every frame is written
    once."""
    B, N = x.shape
    mel_len = consts["mel_w"].shape[1]
    assert consts["mel_band"].dtype == np.int32 and (consts["mel_band"].sum(1) <= mel_len).all()
    plan = K1.launch_plan(B, T, frame_len, shift, n_fft, n_mels, mel_len)
    frames, dest = [], []
    for cta in range(plan.grid):
        for tile in plan.cta_tiles(cta):
            b, t0, t1 = plan.tile_frames(tile, T)
            span = (t1 - t0 - 1) * shift + frame_len
            idx = t0 * shift - pad + np.arange(span)
            staged = np.where((idx >= 0) & (idx < N), x[b, np.clip(idx, 0, N - 1)], 0).astype(np.float32)
            for f in range(t1 - t0):
                frames.append(staged[f * shift : f * shift + frame_len])
                dest.append((b, t0 + f))
    raw = np.stack(frames).astype(np.float32) * np.float32(scale)
    P = n_fft // 32
    if remove_dc and P > 32:
        # a frame of two warps: thread t holds samples 2(t + P·r) and the
        # next; each warp sums its threads' samples, then the two halves add
        half = (np.arange(frame_len) // 2) % P < 32
        total = raw[:, half].sum(1, dtype=np.float32) + raw[:, ~half].sum(1, dtype=np.float32)
        mean = total / np.float32(frame_len)
    elif remove_dc:
        mean = raw.sum(1, dtype=np.float32) / np.float32(frame_len)
    else:
        mean = np.zeros(len(raw), np.float32)
    d = raw - mean[:, None]
    if preemph:
        d = np.concatenate([d[:, :1] * np.float32(1 - preemph), d[:, 1:] - np.float32(preemph) * d[:, :-1]], 1)
    v = np.zeros((len(raw), n_fft), np.float32)
    v[:, :frame_len] = d * consts["window"][None, :frame_len]
    power = kernel_power(v, consts["tw_re"], consts["tw_im"])
    # each filter over its non-zero weights only: mel_w[m, q0 : q0 + n]
    s0 = consts["mel_start"] + consts["mel_band"][:, 0]
    sums = [(power[:, s : s + n] * (np.float32(0.25) * consts["mel_w"][m, q0 : q0 + n])).sum(1, dtype=np.float32)
            for m, (s, (q0, n)) in enumerate(zip(s0, consts["mel_band"]))]
    mel = np.stack(sums, 1)
    mel = np.maximum(mel, np.float32(floor))
    feats = np.log10(mel) if log10 else np.log(mel)
    out = np.full((B, T, n_mels), np.nan, np.float32)
    seen = np.zeros((B, T), int)
    for (b, t_), row in zip(dest, feats):
        out[b, t_] = row
        seen[b, t_] += 1
    assert (seen == 1).all()
    return out


def emulate_fbank(x, sr, n_mels):
    win, shift, n_fft = TF.frame_params(sr)
    T = 1 + (x.shape[1] - win) // shift
    c = K1._host_consts(sr, n_mels, win, n_fft)
    return emulate(x, T, c, win, shift, n_fft, n_mels, 0, 32768.0, 0.97, True, False, np.finfo(np.float32).eps)


def emulate_logmel(x, fs, sh, sr, n_mels=23):
    n_fft = TF.fft_size_for(fs)
    T = TF.count_frames(x.shape[1], sh)
    c = K1._logmel_consts(sr, n_mels, fs, n_fft)
    return emulate(x, T, c, n_fft, sh, n_fft, n_mels, n_fft // 2, 1.0, 0.0, False, True, 1e-10)


@pytest.mark.parametrize("n_fft", [128, 256, 512, 1024, 2048])
def test_kernel_fft_is_the_real_input_fft(n_fft):
    rng = np.random.default_rng(n_fft)
    x = rng.standard_normal((6, n_fft)).astype(np.float32)
    x[1] *= 1e4  # kaldi's int16 scale
    x[2, n_fft // 2 :] = 0  # a zero-padded frame
    x[3] = np.cos(2 * np.pi * 5 * np.arange(n_fft) / n_fft)  # one bin
    x[4, :] = 1.0  # DC only
    x[5] = (-1.0) ** np.arange(n_fft)  # Nyquist only
    c = K1._banded(TF.kaldi_mel_banks(23, n_fft, 8000), np.ones(n_fft), n_fft)
    got = kernel_power(x, c["tw_re"], c["tw_im"]) / 4
    X = np.fft.rfft(x.astype(np.float64), axis=1)
    # |X|² within 2e-5·max|X|² ⇔ X within ~1e-5·max|X| per frame
    scale = np.abs(X).max(1, keepdims=True) ** 2
    np.testing.assert_allclose(got / scale, np.abs(X) ** 2 / scale, rtol=0, atol=2e-5)


@pytest.mark.parametrize("sr,n_mels,kind", [(16000, 80, "kaldi"), (8000, 80, "kaldi"), (8000, 40, "kaldi"),
                                             (8000, 23, "slaney"), (16000, 23, "slaney"), (8000, 80, "slaney")])
def test_mel_band_bounds_every_non_zero_weight(sr, n_mels, kind):
    win, _, n_fft = TF.frame_params(sr)
    if kind == "kaldi":
        c, dense = K1._host_consts(sr, n_mels, win, n_fft), TF.kaldi_mel_banks(n_mels, n_fft, sr)
    else:
        c, dense = K1._logmel_consts(sr, n_mels, win, n_fft), TF.mel_filterbank(sr, n_fft, n_mels)
    for m, (q0, n) in enumerate(c["mel_band"]):
        nz = np.flatnonzero(dense[m])
        s = c["mel_start"][m] + q0
        assert (nz.min(), nz.max()) == (s, s + n - 1) if len(nz) else n == 0
        np.testing.assert_array_equal(c["mel_w"][m, q0 : q0 + n], dense[m, s : s + n])


def test_pass_structure():
    sizes = (128, 256, 512, 1024, 2048)
    assert [K1.fft_radices(n) for n in sizes] == [[16, 4], [16, 8], [16, 16], [16, 16, 2], [16, 16, 4]]
    assert [K1.slots(n) for n in sizes] == [64, 32, 16, 8, 4]
    for n in (64, 400):
        with pytest.raises(ValueError):
            K1.fft_radices(n)


# 44.1 and 48 kHz take n_fft 2048: a frame of two warps
CASES = [(16000, 80, 16000), (16000, 80, 16550), (8000, 80, 12000), (8000, 40, 8123), (48000, 80, 48000),
         (44100, 80, 44100)]


@pytest.mark.parametrize("sr,n_mels,n", CASES)
def test_emulated_k1_matches_its_twin(sr, n_mels, n):
    rng = np.random.default_rng(sr + n_mels + n)
    x = (0.2 * rng.standard_normal((3, n))).astype(np.float32)
    x[2, n // 3 :] = 0.0  # silence: every bin at the log floor
    got = emulate_fbank(x, sr, n_mels)
    ref = TF.kaldi_fbank_torch(torch.from_numpy(x), sample_rate=sr, num_mel_bins=n_mels, mean_norm=False).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4)


@pytest.mark.parametrize("sr,fs,sh,shape", [(8000, 200, 80, (2, 8000)), (16000, 400, 160, (2, 16000)),
                                            (8000, 200, 80, (3, 8123)), (8000, 200, 80, (2, 100)),
                                            (16000, 400, 160, (2, 16010)), (48000, 1200, 480, (2, 48000))])
def test_emulated_k1prime_matches_its_twin(sr, fs, sh, shape):
    rng = np.random.default_rng(shape[1] + sr)
    x = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    T = TF.count_frames(shape[1], sh)
    got = emulate_logmel(x, fs, sh, sr)
    ref = TF.logmel_frames_torch(torch.from_numpy(x), T, fs, sh, sr, 23, mean_norm=False).numpy()
    assert got.shape == ref.shape == (shape[0], T, 23)
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4)


def _plans():
    """(entry, n_fft, B, T, plan) over both entries at n_fft 256, 512 and
    2048 (48 kHz)."""
    for sr in (8000, 16000, 48000):
        win, shift, n_fft = TF.frame_params(sr)
        for n_mels in (23, 40, 80):
            kal = K1._host_consts(sr, n_mels, win, n_fft)["mel_w"].shape[1]
            lm = K1._logmel_consts(sr, n_mels, win, n_fft)["mel_w"].shape[1]
            for B, T in ((1, 1), (2, 2), (3, 101), (64, 398), (64, 3998), (32, 5000), (200, 31)):
                yield "fbank", n_fft, B, T, K1.launch_plan(B, T, win, shift, n_fft, n_mels, kal)
                yield "logmel", n_fft, B, T, K1.launch_plan(B, T, n_fft, shift, n_fft, n_mels, lm)


def test_plan_covers_every_frame_once_and_fits():
    for entry, n_fft, B, T, plan in _plans():
        seen = np.zeros((B, T), int)
        for cta in range(plan.grid):
            tiles = plan.cta_tiles(cta)
            assert len(tiles) >= 1, (entry, B, T, plan)
            for tile in tiles:
                b, t0, t1 = plan.tile_frames(tile, T)
                assert t0 < t1 <= t0 + plan.frames_per_tile
                seen[b, t0:t1] += 1
        assert (seen == 1).all(), (entry, B, T, plan)
        assert plan.smem <= SMEM_LIMIT and plan.frames_per_tile == K1.slots(n_fft), (entry, n_fft, plan)
        assert plan.grid <= K1.CTAS_PER_SM * K1.N_SM
        # the CTAs' runs differ by at most one tile
        sizes = {len(plan.cta_tiles(c)) for c in range(plan.grid)}
        assert max(sizes) - min(sizes) <= 1


def test_plan_fills_the_card_at_the_main_shapes():
    win, shift, n_fft = TF.frame_params(16000)
    mel_len = K1._host_consts(16000, 80, win, n_fft)["mel_w"].shape[1]
    plan = K1.launch_plan(64, 398, win, shift, n_fft, 80, mel_len)
    assert plan.grid >= 132 and plan.tiles == 64 * 25 and plan.frames_per_tile == 16
    # the tables are staged once per CTA: three CTAs a SM, not a CTA per 8 frames
    assert plan.grid == 3 * 132
    mel_len = K1._logmel_consts(8000, 23, 200, 256)["mel_w"].shape[1]
    plan = K1.launch_plan(32, 5000, 256, 80, 256, 23, mel_len)
    assert plan.grid == 3 * 132 and plan.tiles == 32 * 157 and plan.frames_per_tile == 32
    # a smaller card's SM count sizes the grid
    assert K1.launch_plan(32, 5000, 256, 80, 256, 23, mel_len, n_sm=66).grid == 198


def test_smem_bytes_follow_the_layout():
    # 16 kHz kaldi: two spans of 15·160 + 400 samples, window 512, twiddles
    # 4·256, the banded mel table, 80 starts and counts, then the larger of
    # the exchange buffer (2 · 16 slots · 272 floats) and the tile's power
    # rows (16 · 273) with its mel rows (16 · 80)
    mel_len = K1._host_consts(16000, 80, 400, 512)["mel_w"].shape[1]
    want = 4 * (2 * 2800 + 512 + 1024 + -(-80 * mel_len // 4) * 4 + 160 + max(2 * 16 * 272, 16 * 273 + 16 * 80))
    assert K1.smem_bytes(16, 400, 160, 512, 80, mel_len) == want
    for n_fft in K1.FFT_SIZES:
        s, p = K1.pow_stride(n_fft), n_fft // 32
        assert s > n_fft // 2 and s % 2 == 1 and s % 32 == (p + 1) % 32
        # the post-pass's stores: frame g of a warp writes bins on banks
        # g·s + [0, p), at most two lanes on one bank
        banks = [(g * s + t) % 32 for g in range(max(1, 32 // p)) for t in range(min(p, 32))]
        assert max(banks.count(k) for k in banks) <= 2
