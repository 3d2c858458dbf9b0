"""Port parity of the WavLM trunk (models/wavlm.py) against the JAX
WavLMModel on carried-over weights: WavLM with its gated relative position
bias and HuBERT (no bias, no gate; waveform normalisation on), in eval and
train mode, every layer's output; the T5 buckets; the parameter sets of
the two; the weights both ways; and TS-VAD with wavlm_weight_sum (the
softmax mix over layers[1:]): logits, the loss and its gradients and the
BatchNorm statistics of a train step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_zoo_common import TINY_BACKEND, check_tsvad, flat, fp32_close, init_variables, tsvad_pair

from speaker_diarization_tpu.models import wavlm as JW
from speaker_diarization_tpu_torch.models import wavlm as W
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

CONV = ((32, 10, 5), (32, 3, 2), (32, 3, 2), (32, 3, 2), (32, 3, 2), (32, 2, 2), (32, 2, 2))
TRUNK = dict(encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_attention_heads=4,
             conv_feature_layers=CONV, conv_pos=16, conv_pos_groups=4)
VARIANTS = {"wavlm": dict(TRUNK), "hubert": dict(TRUNK, relative_position_embedding=False, gru_rel_pos=False,
                                                normalize=True)}


def _audio(B, N, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal((B, N))).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def trunk(request):
    kw = VARIANTS[request.param]
    jm = JW.WavLMModel(cfg=JW.WavLMFlaxConfig(**kw))
    x = _audio(2, 6000, 1)
    v = init_variables(jm, jnp.asarray(x), seed=2)
    m = W.WavLMModel(W.WavLMFlaxConfig(**kw))
    m.load_state_dict(convert.wavlm_from_flax(v["params"]))
    ref_x, ref_layers = jax.jit(lambda a: jm.apply(v, a, ret_layer_results=True, method=jm.extract_features))(
        jnp.asarray(x))
    return request.param, m.eval(), v, x, np.asarray(ref_x), [np.asarray(r) for r in ref_layers]


def test_relative_position_bucket_is_the_jax_copy():
    rp = np.arange(300)[None, :] - np.arange(300)[:, None]
    np.testing.assert_array_equal(W.relative_position_bucket(rp, 320, 800), JW.relative_position_bucket(rp, 320, 800))


@pytest.mark.parametrize("train", [False, True])
def test_trunk_matches_jax_with_every_layer(trunk, train):
    """The trunk has no dropout and no BatchNorm: train mode computes what
    eval mode does, as JAX's apply has no train flag."""
    name, m, _, x, ref_x, ref_layers = trunk
    m.train(train)
    with torch.no_grad():
        got, layers = m.extract_features(torch.from_numpy(x), ret_layer_results=True)
    m.eval()
    assert got.shape == (2, 18, 32)  # 6000 samples → 18 frames at 50 Hz
    fp32_close(got, ref_x)
    assert len(layers) == len(ref_layers) == 3
    for g, r in zip(layers, ref_layers):
        fp32_close(g, r)


def test_parameter_sets_of_wavlm_and_hubert(trunk):
    """WavLM holds the relative bias and each layer's gate; HuBERT neither
    (tests/test_tsvad.py's TestSSLEncoderTypes pins the JAX side)."""
    name, m, v, *_ = trunk
    keys = set(m.state_dict())
    gated = {k for k in keys if "relative_attention_bias" in k or "grep" in k}
    if name == "wavlm":
        assert gated == {"relative_attention_bias", "layer_0.self_attn.grep_a", "layer_1.self_attn.grep_a",
                         *(f"layer_{i}.self_attn.grep_linear.{p}" for i in (0, 1) for p in ("weight", "bias"))}
    else:
        assert not gated
    back = flat(convert.wavlm_to_flax(m.state_dict()))
    want = flat({"params": v["params"]})
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_tsvad_wavlm_weight_sum_matches_jax():
    cfg = dict(TINY_BACKEND, speech_encoder_type="wavlm_weight_sum", wavlm_layers=2, wavlm_embed_dim=64,
               sample_rate=16000)
    x = _audio(2, 8000, 4)
    embs = np.random.default_rng(5).standard_normal((2, 4, 16)).astype(np.float32)
    jm, v, model = tsvad_pair(cfg, x, embs, 12)
    # the mix weights sit beside the encoder
    assert v["params"]["wavlm_weights"].shape == (2,) and model.wavlm_weights.shape == (2,)
    got = check_tsvad(jm, v, model, x, embs, 12)
    assert got.shape == (2, 12, 4)
