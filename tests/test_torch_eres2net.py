"""Port parity of ERes2Net and ERes2NetV2 (models/eres2net.py) against the
JAX modules on carried-over weights: every mode ('frames', ERes2NetV2's
'frames25' at 25 Hz and 'embedding') in eval mode, train mode with the
BatchNorm statistics, the frame flatten order, the weights both ways, the
zoo name `eres2net`, and TS-VAD with eres2netv2 (stage-3 frames, a stride-1
conv): logits, the train-mode loss and statistics, and the gradients of the
eval-mode loss (torch_zoo_common.check_tsvad says why not train mode's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_zoo_common import TINY_BACKEND, check_tsvad, flat, fp32_close, init_variables, jax_fbank, stats_close, tsvad_pair

from speaker_diarization_tpu.models import eres2net as JE
from speaker_diarization_tpu_torch.models import eres2net as E
from speaker_diarization_tpu_torch.models.speaker_encoders import build_speaker_encoder
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

FEAT = 16
NETS = {
    "eres2net": (dict(feat_dim=FEAT, embedding_size=12, m_channels=8, num_blocks=(1, 1, 1, 1), base_width=32),
                 JE.ERes2Net, E.ERes2Net),
    "eres2netv2": (dict(feat_dim=FEAT, embedding_size=12, m_channels=8, num_blocks=(1, 1, 2, 1), base_width=16),
                   JE.ERes2NetV2, E.ERes2NetV2),
}


def _fbank(B, T, seed):
    return np.random.default_rng(seed).standard_normal((B, T, FEAT)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(NETS))
def pair(request):
    kw, jcls, tcls = NETS[request.param]
    jm = jcls(**kw)
    v = init_variables(jm, jnp.zeros((1, 40, FEAT)), False, "embedding")
    m = tcls(**kw)
    m.load_state_dict(convert.eres2net_from_flax(v["params"], v["batch_stats"]))
    return request.param, jm, v, m.eval()


@pytest.mark.parametrize("T", [37, 40])
def test_eval_matches_jax_in_every_mode(pair, T):
    """'frames' is stage 4 fused with stage 3 at 1/8 of the fbank rate,
    ERes2NetV2's 'frames25' stage 3 at 1/4, each flattened time-major then
    F·C; ERes2Net has no 'frames25', in JAX as here."""
    name, jm, v, m = pair
    fb = _fbank(2, T, 2)
    modes = ("frames", "frames25", "embedding") if name == "eres2netv2" else ("frames", "embedding")
    refs = jax.jit(lambda x: [jm.apply(v, x, False, mode) for mode in modes])(jnp.asarray(fb))
    for mode, ref in zip(modes, refs):
        with torch.no_grad():
            got = m(torch.from_numpy(fb), mode=mode)
        fp32_close(got, ref)
        if mode != "embedding":
            k = 4 if mode == "frames25" else 8
            assert got.shape[1] == -(-T // k)
            assert got.shape[2] == -(-FEAT // k) * 8 * k * 2  # F/k frequencies of m·k·e channels


def test_train_mode_and_statistics_match_jax(pair):
    name, jm, v, m = pair
    fb = _fbank(3, 32, 3)
    ref, new = jax.jit(lambda x: jm.apply(v, x, True, "embedding", mutable=["batch_stats"]))(jnp.asarray(fb))
    m2 = NETS[name][2](**NETS[name][0])
    m2.load_state_dict(m.state_dict())
    got = m2.train()(torch.from_numpy(fb), mode="embedding")
    fp32_close(got, ref)
    assert stats_close(m2.state_dict(), convert.eres2net_from_flax(v["params"], jax.device_get(new["batch_stats"]))) > 0


def test_weights_both_ways_and_the_zoo_name(pair):
    name, _, v, m = pair
    back, want = flat(convert.eres2net_to_flax(m.state_dict())), flat(v)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    if name == "eres2net":
        z = build_speaker_encoder("eres2net", **NETS[name][0])
        assert isinstance(z, E.ERes2Net) and set(z.state_dict()) == set(m.state_dict())


def test_tsvad_eres2netv2_matches_jax():
    """ERes2NetV2 (m 64, 3/4/6/3 blocks, its first three stages) on JAX's fbank."""
    cfg = dict(TINY_BACKEND, speech_encoder_type="eres2netv2", feat_dim=FEAT, eres2net_base_width=8,
               sample_rate=16000)
    audio = (0.1 * np.random.default_rng(4).standard_normal((2, 8000))).astype(np.float32)
    x = jax_fbank(audio, 16000, FEAT)
    embs = np.random.default_rng(5).standard_normal((2, 4, 16)).astype(np.float32)
    jm, v, model = tsvad_pair(cfg, x, embs, 12)
    assert not any(k.startswith("speech_encoder.layer4") for k in model.state_dict())
    got = check_tsvad(jm, v, model, x, embs, 12, train_grads=False)
    assert got.shape == (2, 12, 4)
