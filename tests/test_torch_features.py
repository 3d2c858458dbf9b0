"""Port parity: kaldi fbank (K1's plain twin) against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.kernels.fbank_pallas import fbank_pallas
from speaker_diarization_tpu.ops import features as JF
from speaker_diarization_tpu_torch.kernels import fbank as K1
from speaker_diarization_tpu_torch.ops import features as TF

torch.set_num_threads(1)

# (sample_rate, mel bins, samples); 16550 is not a multiple of the shift;
# 48 kHz takes n_fft 2048
CASES = [(16000, 80, 16000), (16000, 80, 16550), (8000, 80, 12000), (8000, 40, 8123), (48000, 80, 48000)]


@pytest.mark.parametrize("sr,n_mels,n", CASES)
def test_twin_matches_jax_and_host_oracle(sr, n_mels, n):
    rng = np.random.default_rng(sr + n_mels + n)
    x = (0.2 * rng.standard_normal((2, n))).astype(np.float32)
    got = TF.kaldi_fbank_torch(torch.from_numpy(x), sample_rate=sr, num_mel_bins=n_mels).numpy()
    ref = np.asarray(JF.kaldi_fbank_jax(jnp.asarray(x), sample_rate=sr, num_mel_bins=n_mels))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=5e-3)
    oracle = np.stack([JF.kaldi_fbank(xi, sample_rate=sr, num_mel_bins=n_mels, mean_norm=True) for xi in x])
    np.testing.assert_allclose(got, oracle, atol=5e-3)


# The Pallas kernel's bf16 hi/lo split misses its own 5e-3 bar against the
# host oracle at 8 kHz / 80 bins (narrow low-frequency filters near the log
# floor); the twin holds that case against the oracle above instead.
@pytest.mark.parametrize("sr,n_mels,n", [c for c in CASES if c[:2] != (8000, 80)])
def test_twin_matches_pallas_interpret(sr, n_mels, n):
    rng = np.random.default_rng(sr + n_mels + n)
    x = (0.2 * rng.standard_normal((2, n))).astype(np.float32)
    got = TF.kaldi_fbank_torch(torch.from_numpy(x), sample_rate=sr, num_mel_bins=n_mels).numpy()
    pal = np.asarray(fbank_pallas(jnp.asarray(x), sample_rate=sr, num_mel_bins=n_mels, interpret=True))
    np.testing.assert_allclose(got, pal, atol=5e-3)


@pytest.mark.parametrize("sr,n_mels,n", CASES[:3])
def test_host_oracle_is_the_same_function(sr, n_mels, n):
    rng = np.random.default_rng(7)
    x = (0.3 * rng.standard_normal(n)).astype(np.float32)
    for mean_norm in (False, True):
        a = TF.kaldi_fbank(x, sample_rate=sr, num_mel_bins=n_mels, mean_norm=mean_norm)
        b = JF.kaldi_fbank(x, sample_rate=sr, num_mel_bins=n_mels, mean_norm=mean_norm)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TF.kaldi_mel_banks(n_mels, 512, sr), JF.kaldi_mel_banks(n_mels, 512, sr))
    np.testing.assert_array_equal(TF._dft_basis(256)[1], JF._dft_basis(256)[1])


def test_auto_on_cpu_is_the_twin_with_mean_norm():
    rng = np.random.default_rng(3)
    x = torch.from_numpy((0.1 * rng.standard_normal((3, 8000))).astype(np.float32))
    a = TF.kaldi_fbank_auto(x)
    b = TF.kaldi_fbank_torch(x, mean_norm=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    # K1's wrapper on a CPU tensor is its plain twin, and launches nothing
    launches = K1.fbank_cuda.launches
    torch.testing.assert_close(K1.fbank_cuda(x), TF.kaldi_fbank_torch(x, mean_norm=False), rtol=0, atol=0)
    assert K1.fbank_cuda.launches == launches


@pytest.mark.parametrize("sr,n_mels", [(16000, 80), (8000, 80), (8000, 40)])
def test_kernel_constants_reproduce_the_dense_mel_bank(sr, n_mels):
    """The kernel's banded mel weights and FFT twiddles describe the same
    function as the dense matrices: banded power-spectrum projection equals
    the dense one, and an FFT built from the twiddles equals numpy's."""
    win, _, n_fft = TF.frame_params(sr)
    c = K1._host_consts(sr, n_mels, win, n_fft)
    rng = np.random.default_rng(0)
    p = rng.random((5, n_fft // 2 + 1)).astype(np.float32)
    dense = p @ TF.kaldi_mel_banks(n_mels, n_fft, sr).T
    band = np.stack([(p[:, s : s + c["mel_w"].shape[1]] * c["mel_w"][m]).sum(1) for m, s in enumerate(c["mel_start"])], 1)
    np.testing.assert_allclose(band, dense, rtol=1e-5, atol=1e-6)
    assert (c["mel_start"] + c["mel_w"].shape[1] <= n_fft // 2 + 1).all()
    k = np.arange(n_fft // 2)
    np.testing.assert_allclose(c["tw_re"] + 1j * c["tw_im"], np.exp(-2j * np.pi * k / n_fft), atol=1e-6)


def test_work_counts_are_from_the_shapes():
    w = K1.fbank_work(64, 64000)
    assert w["frames"] == 64 * 398
    assert w["bytes"] == 4.0 * 64 * 64000 + 4.0 * 64 * 398 * 80
    # a real-input FFT of the zero-padded 512-point frame: 2.5 · 512 · 9 per frame
    nnz = int((TF.kaldi_mel_banks(80, 512, 16000) > 0).sum())
    assert w["flops"] == 64 * 398 * (5 * 400 + 2.5 * 512 * 9 + 3 * 257 + 2 * nnz + 80)
    # on the H100 (3.35 TB/s, 67 TFLOP/s fp32) the function is bound by bytes
    assert w["flops"] / 67e12 < w["bytes"] / 3.35e12
