"""Port parity: K4's plain twin (the CAM++ FCM head) and its dispatch against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.kernels import cam_block_fused as JFused
from speaker_diarization_tpu.kernels import fcm_pallas as JFCM
from speaker_diarization_tpu.models.campplus import CAMPPlus as JCAMPPlus
from speaker_diarization_tpu.models.campplus import FCM as JFCMModule
from speaker_diarization_tpu_torch.kernels import cam_block_fused as TFused
from speaker_diarization_tpu_torch.kernels import fcm as K4
from speaker_diarization_tpu_torch.models.campplus import CAMPPlus
from speaker_diarization_tpu_torch.utils.convert import campplus_from_flax

torch.set_num_threads(1)


def _perturb_stats(variables, seed):
    """Non-trivial running statistics (init leaves mean 0 / var 1)."""
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.1 * np.abs(rng.standard_normal(v.shape)).astype(np.float32),
        variables["batch_stats"],
    )
    return {"params": variables["params"], "batch_stats": stats}


@pytest.fixture(scope="module")
def camp_pair():
    """A small JAX CAM++ (80 bins, perturbed statistics) and the port loaded from it."""
    jmodel = JCAMPPlus(block_layers=(1, 1), block_dilations=(1, 2))
    fb0 = jnp.zeros((1, 200, 80), jnp.float32)
    v = _perturb_stats(jax.jit(jmodel.init, static_argnums=(2, 3))(jax.random.PRNGKey(0), fb0, False, "frames"), 1)
    model = CAMPPlus(block_layers=(1, 1), block_dilations=(1, 2), with_dense=False).eval()
    model.load_state_dict(campplus_from_flax(v["params"], v["batch_stats"]))
    return jmodel, v, model


def _fbank(B, T, seed):
    return np.random.default_rng(seed).standard_normal((B, T, 80)).astype(np.float32)


def _jax_flat(v, dtype):
    return tuple(JFCM.prepare_fcm_params(v["params"]["head"], v["batch_stats"]["head"], dtype=dtype))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_prepare_fcm_params_matches_jax(camp_pair, dtype):
    _, v, model = camp_pair
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    ref = _jax_flat(v, jdt)
    got = K4.prepare_fcm_params(model.head, tdt)
    assert len(got) == len(ref) == 24  # twelve units: W and (scale, bias) each
    for k, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r.astype(jnp.float32))
        assert tuple(g.shape) == r.shape, k
        assert g.dtype == (tdt if k % 2 == 0 else torch.float32), k
        np.testing.assert_allclose(g.float().numpy(), r, atol=1e-6, rtol=1e-6, err_msg=f"array {k}")


@pytest.mark.parametrize("T", [57, 200])
def test_twin_matches_pallas_and_xla_folded_fp32(camp_pair, T):
    _, v, model = camp_pair
    fb = _fbank(2, T, T)
    flat = _jax_flat(v, jnp.float32)
    ref_pallas = np.asarray(JFCM.fcm_pallas(jnp.asarray(fb), flat, dtype=jnp.float32, interpret=True))
    ref_folded = np.asarray(JFCM.fcm_xla_folded(jnp.asarray(fb), flat, dtype=jnp.float32))
    got = K4.fcm_folded_torch(torch.from_numpy(fb), K4.prepare_fcm_params(model.head, torch.float32), torch.float32)
    assert got.shape == (2, T, 320) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref_pallas, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), ref_folded, atol=2e-4)


@pytest.mark.parametrize("T", [57, 200])
def test_twin_bf16_close_to_the_flax_module(camp_pair, T):
    """bf16 rounding of weights and activations (the JAX bf16 bar)."""
    _, v, model = camp_pair
    fb = _fbank(2, T, T + 1)
    variables = {"params": v["params"]["head"], "batch_stats": v["batch_stats"]["head"]}
    ref = np.asarray(JFCMModule(dtype=jnp.float32).apply(variables, jnp.asarray(fb), False))
    got = K4.fcm_folded_torch(torch.from_numpy(fb).to(torch.bfloat16),
                              K4.prepare_fcm_params(model.head, torch.bfloat16), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert np.max(np.abs(got.float().numpy() - ref)) < 0.05


def test_twin_matches_the_jax_twin_in_bf16(camp_pair):
    """Same rounding points as fcm_xla_folded: a mean-abs of 1e-3 and a max-abs of
    four bf16 steps at the largest magnitude (K2's bar; sums in another order)."""
    _, v, model = camp_pair
    fb = _fbank(2, 120, 7)
    ref = np.asarray(JFCM.fcm_xla_folded(jnp.asarray(fb), _jax_flat(v, jnp.bfloat16), dtype=jnp.bfloat16)
                     .astype(jnp.float32))
    got = K4.fcm_folded_torch(torch.from_numpy(fb).to(torch.bfloat16),
                              K4.prepare_fcm_params(model.head, torch.bfloat16), torch.bfloat16).float().numpy()
    max_bar = 4 * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert np.mean(np.abs(got - ref)) < 1e-3
    assert np.max(np.abs(got - ref)) <= max_bar, (np.max(np.abs(got - ref)), max_bar)


def test_fcm_infer_matches_jax(camp_pair):
    _, v, model = camp_pair
    fb = _fbank(2, 150, 3)
    ref = np.asarray(jax.jit(JFused._fcm_infer)(jnp.asarray(fb), v["params"]["head"], v["batch_stats"]["head"]))
    fp = TFused.fused_params(model, torch.float32)
    with torch.no_grad():
        got = TFused._fcm_infer(torch.from_numpy(fb), model.head, fp)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)


def test_fcm_auto_runs_the_twin_on_the_standard_head(camp_pair, monkeypatch):
    _, _, model = camp_pair
    fb = torch.from_numpy(_fbank(2, 90, 4))
    fp = TFused.fused_params(model, torch.float32)
    calls = []
    real = TFused.fcm_cuda
    monkeypatch.setattr(TFused, "fcm_cuda", lambda x, flat: calls.append(x.shape) or real(x, flat))
    with torch.no_grad():
        got = TFused._fcm_auto(fb, model.head, fp, torch.float32)
        ref = TFused._fcm_infer(fb, model.head, fp)
    assert calls == [(2, 90, 80)]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-4)


def test_fcm_auto_takes_fcm_infer_for_a_40_bin_head(monkeypatch):
    model = CAMPPlus(feat_dim=40, block_layers=(1,), block_dilations=(1,), with_dense=False).eval()
    from speaker_diarization_tpu_torch.models.layers import init_weights_

    init_weights_(model, torch.Generator().manual_seed(2))
    fb = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 60, 40)).astype(np.float32))
    fp = TFused.fused_params(model, torch.float32)

    def no_kernel(*a):
        raise AssertionError("a 40-bin head must not reach K4")

    monkeypatch.setattr(TFused, "fcm_cuda", no_kernel)
    with torch.no_grad():
        got = TFused._fcm_auto(fb, model.head, fp, torch.float32)
        ref = TFused._fcm_infer(fb, model.head, fp)
    assert got.shape == (2, 60, 160)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_is_the_twin(camp_pair, dtype):
    _, _, model = camp_pair
    flat = K4.prepare_fcm_params(model.head, dtype)
    x = torch.from_numpy(_fbank(3, 57, 6)).to(dtype)
    launches = K4.fcm_cuda.launches
    got = K4.fcm_cuda(x, flat)
    torch.testing.assert_close(got, K4.fcm_folded_torch(x, flat, dtype), rtol=0, atol=0)
    assert got.shape == (3, 57, 320) and got.dtype == dtype
    assert K4.fcm_cuda.launches == launches


def test_fused_frames_go_through_the_head_twin(camp_pair, monkeypatch):
    """campplus_frames_fused on the CPU: the head via _fcm_auto, frames within the JAX bar."""
    jmodel, v, model = camp_pair
    fb = _fbank(2, 200, 8)
    ref = np.asarray(jax.jit(jmodel.apply, static_argnums=(2, 3))(v, jnp.asarray(fb), False, "frames"))
    seen = []
    real = TFused._fcm_auto
    monkeypatch.setattr(TFused, "_fcm_auto", lambda *a: seen.append(1) or real(*a))
    with torch.no_grad():
        got = TFused.campplus_frames_fused(model, torch.from_numpy(fb)).numpy()
    assert seen == [1]
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)


def test_work_counts():
    w = K4.fcm_work(64, 398, elem_bytes=2)
    macs = 2_388_480 * 64 * 398
    assert 2 * macs <= w["flops"] < 2 * macs * 1.02  # 121.7 GFLOP, plus BN/ReLU work
    assert 2 * 64 * 398 * 400 <= w["bytes"] < 2 * 64 * 398 * 400 + 1e6  # fbank in, (B, T, 320) out, weights


def _tiled_fcm(fb, flat, window):
    """K4's time tiling in plain torch: tile k owns the output frames
    [k·TT, (k+1)·TT), TT = window - 2·HALO, and computes the head on its
    window [k·TT - HALO, k·TT - HALO + window) with zeros outside [0, T) and
    outside the window, as the kernel's staged rows have."""
    B, T, _ = fb.shape
    tt = window - 2 * K4.HALO
    out = torch.empty((B, T, K4.OUT_DIM))
    for k in range(-(-T // tt)):
        a, b = max(0, k * tt - K4.HALO), min(T, k * tt - K4.HALO + window)
        part = K4.fcm_folded_torch(fb[:, a:b], flat, torch.float32)
        o0, o1 = k * tt, min(T, (k + 1) * tt)
        out[:, o0:o1] = part[:, o0 - a : o1 - a]
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [57, 200, 398, 600])
def test_window_tiling_matches_the_twin(camp_pair, dtype, T):
    """Each kernel instance's window (bf16 256 frames, fp32 128) with its
    10-frame halo gives the whole head's output (fp32 arithmetic)."""
    _, _, model = camp_pair
    flat = K4.prepare_fcm_params(model.head, torch.float32)
    fb = torch.from_numpy(_fbank(2, T, T))
    with torch.no_grad():
        got = _tiled_fcm(fb, flat, K4.WINDOW[dtype])
        ref = K4.fcm_folded_torch(fb, flat, torch.float32)
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-6)
