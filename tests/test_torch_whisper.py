"""Port parity of the Whisper encoder (models/whisper_encoder.py) against
the JAX WhisperEncoder on carried-over weights: the log-mel alone against
`whisper_log_mel`, the plain final output and the layer-concat mode (the
port stops after layer_ed, keeps the later blocks' weights), train mode,
the weights both ways, and TS-VAD with the Whisper encoder: logits, the
loss and its gradients (zero for the blocks after layer_ed on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_zoo_common import TINY_BACKEND, check_tsvad, flat, fp32_close, init_variables, tsvad_pair

from speaker_diarization_tpu.models import whisper_encoder as JWh
from speaker_diarization_tpu_torch.models import whisper_encoder as Wh
from speaker_diarization_tpu_torch.ops.features import count_frames
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

CFG = dict(n_mels=24, n_ctx=64, d_model=32, n_heads=4, n_layers=4, d_ff=64)


def _audio(B, N, seed, scale=0.1):
    return (scale * np.random.default_rng(seed).standard_normal((B, N))).astype(np.float32)


@pytest.mark.parametrize("N", [8000, 8123])
@pytest.mark.parametrize("n_mels", [80, 24])
def test_log_mel_matches_jax(N, n_mels):
    """Centred frames, periodic hann, slaney mel, log10, the per-utterance
    clamp at max − 8 (a quiet row clamps most bins) and (x + 4) / 4."""
    x = _audio(2, N, 1)
    x[1] *= 1e-4
    ref = np.asarray(JWh.whisper_log_mel(jnp.asarray(x), n_mels))
    got = Wh.whisper_log_mel(torch.from_numpy(x), n_mels)
    assert got.dtype == torch.float32 and got.shape == ref.shape == (2, count_frames(N, 160), n_mels)
    fp32_close(got, ref)


@pytest.fixture(scope="module", params=["plain", "concat"])
def encoder(request):
    layers = dict(layer_st=1, layer_ed=2) if request.param == "concat" else {}
    jm = JWh.WhisperEncoder(cfg=JWh.WhisperEncoderConfig(**CFG), **layers)
    x = _audio(2, 8000, 2)
    v = init_variables(jm, jnp.asarray(x), seed=3)
    m = Wh.WhisperEncoder(Wh.WhisperEncoderConfig(**CFG), **layers)
    m.load_state_dict(convert.whisper_from_flax(v["params"]))
    return request.param, jm, v, m.eval(), x


@pytest.mark.parametrize("train", [False, True])
def test_encoder_matches_jax(encoder, train):
    name, jm, v, m, x = encoder
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    m.train(train)  # no dropout, no BatchNorm: the same function
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    m.eval()
    assert got.shape == ((2, 25, 64) if name == "concat" else (2, 25, 32))
    fp32_close(got, ref)


def test_encoder_weights_both_ways(encoder):
    """Every block is held, the ones after layer_ed too, and `ln_post` or
    `ln_post2` as the mode has it; `embed_positions` is a parameter."""
    name, _, v, m, _ = encoder
    sd = m.state_dict()
    assert "block_3.fc2.weight" in sd and sd["embed_positions"].shape == (64, 32)
    assert ("ln_post2.weight" in sd) == (name == "concat") != ("ln_post.weight" in sd)
    back, want = flat(convert.whisper_to_flax(sd)), flat({"params": v["params"]})
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_embed_positions_start_sinusoidal():
    from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel

    cfg = TSVADConfig(**TINY_BACKEND, speech_encoder_type="whisper", whisper_d_model=32, whisper_n_layers=2,
                      whisper_n_heads=4, whisper_layer_st=0, whisper_layer_ed=1)
    enc = TSVADModel(cfg, device="cpu").speech_encoder
    jm = JWh.WhisperEncoder(cfg=JWh.WhisperEncoderConfig(d_model=32, n_heads=4, n_layers=2))
    want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 80))))["params"]
    assert want["embed_positions"].shape == tuple(enc.embed_positions.shape) == (1500, 32)
    from speaker_diarization_tpu.models.transformer import sinusoidal_position_encoding

    np.testing.assert_array_equal(enc.embed_positions.detach().numpy(), sinusoidal_position_encoding(1500, 32))


def test_tsvad_whisper_matches_jax():
    cfg = dict(TINY_BACKEND, speech_encoder_type="whisper", whisper_d_model=32, whisper_n_layers=4,
               whisper_n_heads=4, whisper_n_mels=80, whisper_layer_st=1, whisper_layer_ed=2, sample_rate=16000)
    x = _audio(2, 8000, 4)
    embs = np.random.default_rng(5).standard_normal((2, 4, 16)).astype(np.float32)
    jm, v, model = tsvad_pair(cfg, x, embs, 12)
    got = check_tsvad(jm, v, model, x, embs, 12)
    assert got.shape == (2, 12, 4)
