"""Port parity of the ASR side (models/dicow.py, models/whisper_decoder.py
and the four NumPy copies) against the JAX package on carried-over weights:
FDDT in its three variants, the DiCoW encoder from audio and from mel, with
and without STNO and with FDDT on fewer layers, `ctc_loss` and its
gradients against `optax.ctc_loss`, the beam search and the greedy collapse,
the Whisper decoder's logits and `greedy_decode`; the copies on JAX's own
test fixtures and against the JAX modules; and JAX
test_whisper_decoder.py's DiCoW end-to-end test on the port."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_zoo_common import flat, fp32_close, init_variables

from speaker_diarization_tpu.data import asr_sim as JSim
from speaker_diarization_tpu.models import dicow as JD
from speaker_diarization_tpu.models import whisper_decoder as JWD
from speaker_diarization_tpu.models.whisper_encoder import WhisperEncoderConfig as JWConfig
from speaker_diarization_tpu.postproc import asr_fusion as JFusion
from speaker_diarization_tpu.postproc import stno as JStno
from speaker_diarization_tpu_torch.data import asr_sim
from speaker_diarization_tpu_torch.data.rttm import Turn
from speaker_diarization_tpu_torch.models import dicow as D
from speaker_diarization_tpu_torch.models import whisper_decoder as WD
from speaker_diarization_tpu_torch.models.whisper_encoder import WhisperEncoderConfig
from speaker_diarization_tpu_torch.postproc import asr_fusion, stno
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = dict(n_mels=20, n_ctx=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)


def _stno(B, T, seed):
    """Soft STNO masks: each frame's four rows sum to 1."""
    m = np.random.default_rng(seed).random((B, 4, T)).astype(np.float32)
    return m / m.sum(1, keepdims=True)


# ---------------------------------------------------------------------------
# FDDT and the encoder


@pytest.mark.parametrize("variant", ["full", "diagonal", "bias_only"])
def test_fddt_matches_jax(variant):
    """The JAX init (identity for target and overlap, the rate for silence and
    non-target, zero biases) and a perturbed transform, both against JAX."""
    kw = dict(is_diagonal=variant == "diagonal", bias_only=variant == "bias_only")
    x = np.random.default_rng(0).standard_normal((2, 7, 8)).astype(np.float32)
    m = _stno(2, 7, 1)
    jm = JD.FDDT(d_model=8, non_target_rate=0.3, **kw)
    port = D.FDDT(8, non_target_rate=0.3, **kw)
    port.reset_parameters_()
    v0 = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(m))
    back = flat(convert.dicow_to_flax(port.state_dict())["params"])
    want = flat(jax.device_get(v0["params"]))
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    with torch.no_grad():
        fp32_close(port(torch.from_numpy(x), torch.from_numpy(m)), jm.apply(v0, jnp.asarray(x), jnp.asarray(m)))
    v = init_variables(jm, jnp.asarray(x), jnp.asarray(m), seed=2)
    port.load_state_dict(convert.dicow_from_flax(v["params"]))
    with torch.no_grad():
        fp32_close(port(torch.from_numpy(x), torch.from_numpy(m)), jm.apply(v, jnp.asarray(x), jnp.asarray(m)))


ENCODERS = {
    "full": dict(),
    "diagonal_first_layer": dict(fddt_is_diagonal=True, apply_fddt_to_n_layers=1),
    "bias_only": dict(fddt_bias_only=True),
}


@pytest.fixture(scope="module", params=sorted(ENCODERS))
def encoder(request):
    cfg_kw = dict(vocab_size=11, non_target_fddt_value=0.05, **ENCODERS[request.param])
    jm = JD.DiCoWEncoder(cfg=JD.DiCoWConfig(whisper=JWConfig(**TINY), **cfg_kw))
    audio = (0.1 * np.random.default_rng(3).standard_normal((2, 8000))).astype(np.float32)
    stno_mask = _stno(2, 30, 4)  # longer than the 25 frames: cut to the frame count
    v = init_variables(jm, jnp.asarray(audio), jnp.asarray(stno_mask), seed=5)
    model = D.DiCoWEncoder(D.DiCoWConfig(whisper=WhisperEncoderConfig(**TINY), **cfg_kw), device="cpu")
    model.load_state_dict(convert.dicow_from_flax(v["params"]))
    return request.param, jm, v, model, audio, stno_mask


@pytest.mark.parametrize("inp", ["audio", "mel"])
@pytest.mark.parametrize("conditioned", [True, False])
def test_encoder_matches_jax(encoder, inp, conditioned):
    _, jm, v, model, audio, stno_mask = encoder
    x = audio if inp == "audio" else (0.5 * np.random.default_rng(6).standard_normal((2, 50, 20))).astype(np.float32)
    m = stno_mask if conditioned else None
    logits, h = jax.jit(jm.apply)(v, jnp.asarray(x), None if m is None else jnp.asarray(m))
    with torch.no_grad():
        got_l, got_h = model(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    assert got_l.dtype == torch.float32 and got_l.shape == (2, 25, 11) and got_h.shape == (2, 25, 32)
    fp32_close(got_h, h)
    fp32_close(got_l, logits)


def test_encoder_weights_both_ways_and_inits(encoder):
    """Every FDDT (initial and one per conditioned layer), the blocks and the
    CTC head map back to the same flax tree; a fresh encoder starts with the
    JAX FDDT inits and the sinusoid positions."""
    name, _, v, model, _, _ = encoder
    back, want = flat(convert.dicow_to_flax(model.state_dict())["params"]), flat(v["params"])
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    n_fddt = sum(k.startswith("fddt_") for k in v["params"])
    assert n_fddt == (1 if name == "diagonal_first_layer" else 2) and "initial_fddt" in v["params"]
    fresh = D.DiCoWEncoder(model.cfg, device="cpu", seed=9)
    jfresh = JD.DiCoWEncoder(cfg=JD.DiCoWConfig(whisper=JWConfig(**TINY), **{
        k: getattr(model.cfg, k) for k in ("fddt_is_diagonal", "fddt_bias_only", "non_target_fddt_value",
                                           "apply_fddt_to_n_layers", "vocab_size")}))
    jinit = flat(jax.device_get(jfresh.init(jax.random.PRNGKey(0), jnp.zeros((1, 8000)), jnp.zeros((1, 4, 25)))))
    got = flat(convert.dicow_to_flax(fresh.state_dict()))
    assert got.keys() == jinit.keys()
    for k, w in jinit.items():
        if "fddt" in k or "embed_positions" in k:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)


def test_conditioning_changes_the_output():
    """JAX test_dicow's semantic checks on the port: an all-target mask keeps
    the stream, an all-silence one changes it; speakers fold into the batch."""
    model = D.DiCoWEncoder(D.DiCoWConfig(whisper=WhisperEncoderConfig(**TINY), vocab_size=8), device="cpu")
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 50, 20)).astype(np.float32))
    target, silence = torch.zeros(1, 4, 25), torch.zeros(1, 4, 25)
    target[:, 1], silence[:, 0] = 1, 1
    with torch.no_grad():
        lt, ht = model(mel, target)
        _, hs = model(mel, silence)
        _, hn = model(mel, None)
    assert lt.shape == (1, 25, 8) and not torch.allclose(ht, hs, atol=1e-3)
    torch.testing.assert_close(ht, hn, rtol=1e-5, atol=1e-5)  # identity FDDT at init
    diar = np.zeros((2, 25), np.float32)
    diar[0, :10], diar[1, 8:20] = 1, 1
    masks = torch.from_numpy(stno.stno_masks_for_all(diar))
    with torch.no_grad():
        _, h = model(mel.expand(2, 50, 20), masks)
    assert not torch.allclose(h[0], h[1], atol=1e-3)


# ---------------------------------------------------------------------------
# CTC


def _ctc_case(seed):
    rng = np.random.default_rng(seed)
    B, T, V, L = 4, 18, 7, 6
    logits = (2 * rng.standard_normal((B, T, V))).astype(np.float32)
    labels = rng.integers(1, V, (B, L)).astype(np.int32)
    labels[1, 1] = labels[1, 0]  # a repeat needs a blank between
    lab_len = np.array([6, 4, 1, 0])
    label_pad = (np.arange(L)[None] >= lab_len[:, None]).astype(np.float32)
    labels = np.where(label_pad > 0, 0, labels).astype(np.int32)
    logit_pad = (np.arange(T)[None] >= np.array([18, 15, 9, 4])[:, None]).astype(np.float32)
    return logits, logit_pad, labels, label_pad


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_loss_and_gradients_match_optax(seed):
    logits, logit_pad, labels, label_pad = _ctc_case(seed)

    def jloss(x):
        return JD.ctc_loss(x, jnp.asarray(logit_pad), jnp.asarray(labels), jnp.asarray(label_pad))

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = D.ctc_loss(x, torch.from_numpy(logit_pad), torch.from_numpy(labels), torch.from_numpy(label_pad))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-6)
    per = optax.ctc_loss(jnp.asarray(logits), jnp.asarray(logit_pad), jnp.asarray(labels), jnp.asarray(label_pad))
    for b in range(4):  # each sequence's NLL alone
        one = D.ctc_loss(*(torch.from_numpy(a[b:b + 1]) for a in (logits, logit_pad, labels, label_pad)))
        np.testing.assert_allclose(one.item(), float(per[b]), rtol=1e-5)


def test_ctc_impossible_alignment_is_finite_as_in_optax():
    """4 labels (or 2 with a repeat, which need 3 frames) in 2 frames: optax's
    log(0) stand-in gives ~1e5; the port gives CTC_IMPOSSIBLE and no
    gradient, never inf or NaN."""
    logits = np.random.default_rng(0).standard_normal((2, 2, 5)).astype(np.float32)
    labels = np.array([[1, 2, 3, 4], [1, 1, 0, 0]], np.int32)
    label_pad = np.array([[0, 0, 0, 0], [0, 0, 1, 1]], np.float32)
    pad = np.zeros((2, 2), np.float32)
    want = optax.ctc_loss(jnp.asarray(logits), jnp.asarray(pad), jnp.asarray(labels), jnp.asarray(label_pad))
    x = torch.from_numpy(logits).requires_grad_()
    for b in range(2):
        got = D.ctc_loss(x[b:b + 1], torch.from_numpy(pad[b:b + 1]), torch.from_numpy(labels[b:b + 1]),
                         torch.from_numpy(label_pad[b:b + 1]))
        np.testing.assert_allclose(got.item(), float(want[b]), rtol=1e-4)
        got.backward()
        assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("seed", range(4))
def test_beam_search_and_greedy_identical_to_jax(seed):
    rng = np.random.default_rng(seed)
    lp = np.log(rng.dirichlet(np.ones(5) * 0.5, size=12))
    assert D.ctc_prefix_beam_search(lp, beam_size=6) == JD.ctc_prefix_beam_search(lp, beam_size=6)
    got = D.ctc_prefix_beam_search(lp, beam_size=6, return_nbest=True)
    want = JD.ctc_prefix_beam_search(lp, beam_size=6, return_nbest=True)
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_array_equal([p for _, p in got], [p for _, p in want])
    batch = rng.standard_normal((3, 15, 5)).astype(np.float32)
    batch[0, 3:6] = 10.0 * (np.arange(5) == 0)  # blanks between repeats
    assert D.ctc_greedy_decode(torch.from_numpy(batch)) == JD.ctc_greedy_decode(jnp.asarray(batch))
    assert D.ctc_greedy_decode(batch[1]) == JD.ctc_greedy_decode(jnp.asarray(batch[1]))


# ---------------------------------------------------------------------------
# the Whisper decoder

DEC = dict(vocab_size=40, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_positions=24)


@pytest.fixture(scope="module")
def decoder():
    jm = JWD.WhisperDecoder(cfg=JWD.WhisperDecoderConfig(**DEC))
    enc = np.random.default_rng(7).standard_normal((2, 11, 32)).astype(np.float32)
    v = init_variables(jm, jnp.zeros((2, 5), jnp.int32), jnp.asarray(enc), seed=8)
    v["params"]["embed_tokens"]["embedding"] *= 4.0  # logits spread wide enough that argmax ties cannot occur
    model = WD.WhisperDecoder(WD.WhisperDecoderConfig(**DEC), device="cpu")
    model.load_state_dict(convert.whisper_decoder_from_flax(v["params"]))
    return jm, v, model.eval(), enc


@pytest.mark.parametrize("offset", [0, 3])
def test_decoder_logits_match_jax(decoder, offset):
    jm, v, model, enc = decoder
    tokens = np.random.default_rng(offset).integers(0, 40, (2, 7)).astype(np.int32)
    mask = np.ones((2, 11), bool)
    mask[1, 8:] = False
    for m in (None, mask):
        want = jm.apply(v, jnp.asarray(tokens), jnp.asarray(enc), None if m is None else jnp.asarray(m),
                        position_offset=offset)
        with torch.no_grad():
            got = model(torch.from_numpy(tokens), torch.from_numpy(enc), None if m is None else torch.from_numpy(m),
                        position_offset=offset)
        assert got.dtype == torch.float32
        fp32_close(got, want)


def test_decoder_weights_both_ways(decoder):
    _, v, model, _ = decoder
    back, want = flat(convert.whisper_decoder_to_flax(model.state_dict())["params"]), flat(v["params"])
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_greedy_decode_tokens_identical_to_jax(decoder):
    jm, v, model, enc = decoder
    start = np.array([[1], [1]], np.int32)
    want = JWD.greedy_decode(jm, v["params"], jnp.asarray(enc), start, max_new_tokens=8, eos_id=2)
    got = WD.greedy_decode(model, torch.from_numpy(enc), start, max_new_tokens=8, eos_id=2)
    np.testing.assert_array_equal(got, want)
    # a row that emits eos is padded with it; the loop stops once all have
    eos_first = torch.zeros(2, 11, 32)
    out = WD.greedy_decode(_eos_decoder(), eos_first, start, max_new_tokens=5, eos_id=2)
    assert out.shape == (2, 2) and (out[:, 1] == 2).all()


def _eos_decoder():
    m = WD.WhisperDecoder(WD.WhisperDecoderConfig(**DEC), device="cpu")
    with torch.no_grad():
        m.embed_tokens.weight.zero_()
        m.embed_tokens.weight[2] = 1.0
        m.ln.bias.fill_(1.0)
    return m


# ---------------------------------------------------------------------------
# the four copies


def _ported_tests(name: str) -> types.ModuleType:
    """JAX's own test module `name`, its imports pointed at the port's copies."""
    with open(os.path.join(HERE, name)) as f:
        src = f.read().replace("speaker_diarization_tpu.", "speaker_diarization_tpu_torch.")
    mod = types.ModuleType(f"port_{name[:-3]}")
    exec(compile(src, os.path.join(HERE, name), "exec"), mod.__dict__)
    return mod


_stno_tests, _fusion_tests, _textgrid_tests = (_ported_tests(n) for n in (
    "test_stno_pahc.py", "test_asr_fusion.py", "test_textgrid.py"))


class TestSTNOOnThePort(_stno_tests.TestSTNO):
    pass


class TestFuseWordsOnThePort(_fusion_tests.TestFuseWords):
    pass


class TestTextNormalizationAndSrtOnThePort(_fusion_tests.TestTextNormalizationAndSrt):
    pass


class TestTextGridParseOnThePort(_textgrid_tests.TestParse):
    pass


class TestTextGridPrepOnThePort(_textgrid_tests.TestPrep):
    pass


def test_copies_give_the_jax_outputs():
    rng = np.random.default_rng(0)
    diar = (rng.random((3, 40)) < 0.4).astype(np.float32)
    np.testing.assert_array_equal(stno.stno_masks_for_all(diar), JStno.stno_masks_for_all(diar))
    turns = [Turn("r", 0.3, 1.2, "A"), Turn("r", 1.0, 0.9, "B"), Turn("r", 3.1, 0.5, "A")]
    np.testing.assert_array_equal(stno.diarization_mask(turns, ["A", "B"], 250),
                                  JStno.diarization_mask(turns, ["A", "B"], 250))
    words = [asr_fusion.Word(word=f"w{i}", start=0.37 * i, end=0.37 * i + 0.2) for i in range(12)]
    jwords = [JFusion.Word(word=w.word, start=w.start, end=w.end) for w in words]
    got = asr_fusion.fuse_words(words, turns)
    want = JFusion.fuse_words(jwords, turns)
    assert [(w.word, w.speaker, w.start, w.end) for w in got] == [(w.word, w.speaker, w.start, w.end) for w in want]
    for port_it, jax_it in ((asr_sim.token_batches(8, 16000, batch_size=3, utt_s=1.5, seed=4),
                             JSim.token_batches(8, 16000, batch_size=3, utt_s=1.5, seed=4)),
                            (asr_sim.conditioned_batches(8, 16000, batch_size=3, seed=5),
                             JSim.conditioned_batches(8, 16000, batch_size=3, seed=5))):
        for _ in range(2):
            a, b = next(port_it), next(jax_it)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# JAX test_whisper_decoder.py::TestDiCoWEndToEnd on the port


def test_conditioned_generation_feeds_asr_fusion():
    """STNO-conditioned encoder states → the decoder's greedy tokens per
    speaker stream → asr_fusion's speaker-attributed words."""
    rng = np.random.default_rng(0)
    enc = D.DiCoWEncoder(D.DiCoWConfig(whisper=WhisperEncoderConfig(n_mels=24, d_model=32, n_heads=2, n_layers=1,
                                                                    d_ff=64, n_ctx=64)), device="cpu")
    mel = torch.from_numpy(rng.standard_normal((2, 64, 24)).astype(np.float32))
    mask = torch.zeros(2, 4, 32)
    mask[0, 1, :16], mask[0, 2, 16:], mask[1, 1, 16:], mask[1, 2, :16] = 1, 1, 1, 1
    with torch.no_grad():
        _, states = enc(mel, mask)
    assert states.shape[0] == 2 and torch.isfinite(states).all()
    dec = WD.WhisperDecoder(WD.WhisperDecoderConfig(vocab_size=16, d_model=states.shape[-1], n_heads=2, n_layers=1,
                                                    d_ff=64, max_positions=16), device="cpu", seed=1)
    toks = WD.greedy_decode(dec, states, np.full((2, 1), 1, np.int32), max_new_tokens=5, eos_id=2)
    assert toks.shape[0] == 2 and toks.shape[1] <= 6 and (toks >= 0).all() and (toks < 16).all()
    vocab = [f"w{i}" for i in range(16)]
    words = []
    for spk, stream in enumerate(toks):
        for j, tid in enumerate(stream[1:]):
            if tid == 2:
                break
            words.append(asr_fusion.Word(word=vocab[tid], start=spk * 2.0 + 0.2 * j, end=spk * 2.0 + 0.2 * j + 0.15))
    fused = asr_fusion.fuse_words(words, [Turn("toy", 0.0, 2.0, "A"), Turn("toy", 2.0, 2.0, "B")])
    assert fused and {w.speaker for w in fused} <= {"A", "B"}
