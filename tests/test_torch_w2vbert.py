"""Port parity of the w2v-BERT 2.0 conformer (models/w2vbert.py) against
the JAX W2vBertModel on carried-over weights: the fbank pairing, the Shaw
relative-key bias at lengths past both clip distances, the causal
depthwise conv (a later frame never reaches an earlier output through the
conv module), eval and train mode, the weights both ways, and TS-VAD with
the w2vbert encoder on K1's fbank: logits, the loss and its gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_zoo_common import TINY_BACKEND, check_tsvad, flat, fp32_close, init_variables, jax_fbank, tsvad_pair

from speaker_diarization_tpu.models import w2vbert as JB
from speaker_diarization_tpu_torch.models import w2vbert as B
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

CFG = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, feature_input_dim=48, conv_kernel=7,
           left_max_pos=6, right_max_pos=3)


@pytest.mark.parametrize("T", [20, 21])
def test_fbank_pairing_matches_jax(T):
    fb = np.random.default_rng(T).standard_normal((2, T, 24)).astype(np.float32)
    got = B.fbank_to_w2vbert_features(torch.from_numpy(fb)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JB.fbank_to_w2vbert_features(jnp.asarray(fb))))
    assert got.shape == (2, T // 2, 48)


@pytest.fixture(scope="module")
def pair():
    jm = JB.W2vBertModel(cfg=JB.W2vBertConfig(**CFG))
    x = np.random.default_rng(1).standard_normal((2, 17, 48)).astype(np.float32)
    v = init_variables(jm, jnp.asarray(x), seed=2)
    m = B.W2vBertModel(B.W2vBertConfig(**CFG))
    m.load_state_dict(convert.w2vbert_from_flax(v["params"]))
    return jm, v, m.eval()


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("T", [4, 17])
def test_encoder_matches_jax(pair, train, T):
    """T 17 reaches past both clip distances (6 left, 3 right); T 4 not."""
    jm, v, m = pair
    x = np.random.default_rng(T).standard_normal((2, T, 48)).astype(np.float32)
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    m.train(train)  # no dropout, no BatchNorm: the same function
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    m.eval()
    fp32_close(got, ref)


def test_conv_module_is_causal(pair):
    _, _, m = pair
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 12, 32)).astype(np.float32))
    y = x.clone()
    y[:, 8:] += torch.from_numpy(np.random.default_rng(4).standard_normal((1, 4, 32)).astype(np.float32))
    conv = m.layer_0.conv_module
    with torch.no_grad():
        torch.testing.assert_close(conv(x)[:, :8], conv(y)[:, :8], rtol=0, atol=0)
        assert not torch.allclose(conv(x)[:, 8:], conv(y)[:, 8:])


def test_weights_both_ways(pair):
    _, v, m = pair
    sd = m.state_dict()
    assert sd["layer_0.self_attn.distance_embedding"].shape == (10, 16)
    back, want = flat(convert.w2vbert_to_flax(sd)), flat({"params": v["params"]})
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_tsvad_w2vbert_matches_jax():
    """On JAX's fbank (the port's kaldi_fbank_auto is held to it in
    tests/test_torch_features.py); paired to 50 Hz, a stride-2 conv to 25 Hz."""
    cfg = dict(TINY_BACKEND, speech_encoder_type="w2vbert", w2vbert_layers=1, w2vbert_dim=64, feat_dim=24,
               sample_rate=16000)
    audio = (0.1 * np.random.default_rng(4).standard_normal((2, 8000))).astype(np.float32)
    x = jax_fbank(audio, 16000, 24)
    embs = np.random.default_rng(5).standard_normal((2, 4, 16)).astype(np.float32)
    jm, v, model = tsvad_pair(cfg, x, embs, 12)
    got = check_tsvad(jm, v, model, x, embs, 12)
    assert got.shape == (2, 12, 4)
    with torch.no_grad():  # from audio: the port's fbank twin, then the same forward
        from_audio = model(torch.from_numpy(audio), torch.from_numpy(embs), 12)
        from_fbank = model(torch.from_numpy(x), torch.from_numpy(embs), 12)
    np.testing.assert_allclose(from_audio.numpy(), from_fbank.numpy(), rtol=0, atol=1e-3)
