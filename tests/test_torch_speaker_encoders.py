"""Port parity of the speaker-encoder zoo: ECAPA-TDNN, ResNet34 and
SimAM-ResNet34 frames and embeddings (eval mode, and train mode with the
BatchNorm statistics), the pooling functions, TS-VAD's transposed-conv
upsampling at odd and even frame counts, TS-VAD logits with each encoder,
the speaker classifier with ECAPA and ResNet34, the export-encoder npz both
ways and `extract-embeddings` from such an npz, against the JAX package."""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.cli import main as JCLI
from speaker_diarization_tpu.models import speaker_encoders as JS
from speaker_diarization_tpu.models import spk_embed as JEmb
from speaker_diarization_tpu.models.tsvad import SpeechFeatUpsample as JUpsample
from speaker_diarization_tpu.models.tsvad import TSVADConfig as JConfig
from speaker_diarization_tpu.models.tsvad import TSVADModel as JModel
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.models import speaker_encoders as S
from speaker_diarization_tpu_torch.models import spk_embed as E
from speaker_diarization_tpu_torch.models.tsvad import SpeechFeatUpsample, TSVADConfig, TSVADModel
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

FEAT = 24
ENCODERS = {
    "ecapa": (lambda: JS.ECAPA_TDNN(channels=64, feat_dim=FEAT, embed_dim=16),
              lambda: S.ECAPA_TDNN(channels=64, feat_dim=FEAT, embed_dim=16)),
    "resnet34": (lambda: JS.ResNet34(feat_dim=FEAT, embed_dim=16, m_channels=8, num_blocks=(1, 2, 1, 1)),
                 lambda: S.ResNet34(feat_dim=FEAT, embed_dim=16, m_channels=8, num_blocks=(1, 2, 1, 1))),
    "simam_resnet34": (lambda: JS.SimAMResNet34(feat_dim=FEAT, embed_dim=16, m_channels=8, num_blocks=(1, 2, 1, 1)),
                       lambda: S.SimAMResNet34(feat_dim=FEAT, embed_dim=16, m_channels=8, num_blocks=(1, 2, 1, 1))),
}


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturb(variables, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + scale * rng.standard_normal(a.shape).astype(np.float32), variables)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])  # positive variances
    return v


def _fp32_close(got, ref):
    """fp32 modules: max-abs 1e-4 · max(1, max|ref|)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def _fbank(B, T, seed):
    return np.random.default_rng(seed).standard_normal((B, T, FEAT)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(ENCODERS))
def encoder_pair(request):
    make_j, make_t = ENCODERS[request.param]
    jm = make_j()
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 40, FEAT)), False, "embedding"), 1)
    m = make_t()
    m.load_state_dict(convert.named_from_flax(v["params"], v["batch_stats"]))
    return request.param, jm, v, m.eval()


@pytest.mark.parametrize("mode", ["frames", "embedding"])
@pytest.mark.parametrize("T", [61, 64])
def test_encoder_eval_matches_jax(encoder_pair, mode, T):
    name, jm, v, m = encoder_pair
    fb = _fbank(3, T, 2)
    ref = jm.apply(v, jnp.asarray(fb), False, mode)
    with torch.no_grad():
        got = m(torch.from_numpy(fb), mode=mode)
    assert got.shape == ref.shape
    if mode == "frames":  # ECAPA at the fbank rate; ResNets at 1/8 in time, (F/8)·C frequency-major
        assert got.shape[1] == (T if name == "ecapa" else -(-T // 8))
    _fp32_close(got, ref)


def test_encoder_train_mode_and_statistics_match_jax(encoder_pair):
    """Train mode: batch statistics everywhere, the running ones moved as
    flax moves them."""
    name, jm, v, m = encoder_pair
    fb = _fbank(4, 48, 3)
    ref, new = jm.apply(v, jnp.asarray(fb), True, "embedding", mutable=["batch_stats"])
    m2 = ENCODERS[name][1]()  # a fresh copy: train mode moves the running statistics
    m2.load_state_dict(m.state_dict())
    m2.train()
    got = m2(torch.from_numpy(fb), mode="embedding")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    want = convert.named_from_flax(v["params"], jax.device_get(new["batch_stats"]))
    sd = m2.state_dict()
    for k, t in want.items():
        if "running_" in k:
            np.testing.assert_allclose(sd[k].numpy(), t.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_encoder_weights_round_trip(encoder_pair):
    _, _, v, m = encoder_pair
    back = convert.named_to_flax(m.state_dict())
    a, b = _flat(v), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pooling_functions_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 5)).astype(np.float32)
    for unbiased in (False, True):
        _fp32_close(S.stats_pool_time(torch.from_numpy(x), unbiased), JS.stats_pool_time(jnp.asarray(x), unbiased))
    x4 = rng.standard_normal((2, 3, 7, 5)).astype(np.float32)  # (B, C, T, F); JAX takes (B, T, F, C)
    got = S.simam(torch.from_numpy(x4)).numpy()
    _fp32_close(got.transpose(0, 2, 3, 1), JS.simam(jnp.asarray(x4.transpose(0, 2, 3, 1))))


def test_astp_global_context_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 11, 6)).astype(np.float32)
    jm = JS.ASTP(bottleneck=4, global_context=True)
    v = _perturb({"params": jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], "batch_stats": {}}, 6, 0.3)
    m = S.ASTP(6, bottleneck=4, global_context=True)
    m.load_state_dict(convert.named_from_flax(v["params"], {}))
    with torch.no_grad():
        _fp32_close(m(torch.from_numpy(x)), jm.apply({"params": v["params"]}, jnp.asarray(x)))


@pytest.mark.parametrize("T", [7, 8])
@pytest.mark.parametrize("train", [False, True])
def test_speech_feat_upsample_matches_flax_conv_transpose(T, train):
    """flax ConvTranspose(k 5, stride 2, "SAME") does not flip its kernel and
    pads (3, 2) around the dilated input; the torch transposed conv is held
    to it at odd and even frame counts, with its BatchNorm and ReLU."""
    x = np.random.default_rng(T).standard_normal((2, T, 8)).astype(np.float32)
    jm = JUpsample(6)
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 7, 0.3)
    m = SpeechFeatUpsample(8, 6)
    m.load_state_dict(convert.named_from_flax(v["params"], v["batch_stats"]))
    m.train(train)
    if train:
        ref, _ = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        ref = jm.apply(v, jnp.asarray(x))
    got = m(torch.from_numpy(x)).detach()
    assert got.shape == (2, 2 * T, 6)
    _fp32_close(got, ref)
    # the transposed conv alone, before the BatchNorm, against lax.conv_transpose
    up_ref = jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(v["params"]["up"]["kernel"]), (2,), "SAME",
                                    dimension_numbers=("NWC", "WIO", "NWC")) + v["params"]["up"]["bias"]
    with torch.no_grad():
        _fp32_close(m.up(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2), up_ref)


TINY = dict(transformer_embed_dim=32, transformer_ffn_embed_dim=64, num_attention_head=2, speaker_embed_dim=16,
            num_transformer_layer=1, dropout=0.0, sample_rate=8000, feat_dim=FEAT)


@pytest.mark.parametrize("enc", ["ecapa", "resnet34", "simam_resnet34"])
def test_tsvad_logits_with_each_encoder_match_jax(enc):
    """ECAPA-1024 at 100 Hz with a stride-4 conv; the ResNets at 12.5 Hz
    upsampled ×2 (the frames flattened frequency-major)."""
    cfg = dict(TINY, speech_encoder_type=enc)
    jmodel = JModel(cfg=JConfig(**cfg))
    rng = np.random.default_rng(8)
    audio = (0.1 * rng.standard_normal((2, 12000))).astype(np.float32)
    embs = rng.standard_normal((2, 4, 16)).astype(np.float32)
    v = _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(audio), jnp.asarray(embs)), 9)
    ref = np.asarray(jmodel.apply(v, jnp.asarray(audio), jnp.asarray(embs)))
    model = TSVADModel(TSVADConfig(**cfg), device="cpu")
    model.load_state_dict(convert.tsvad_from_flax(v))
    with torch.no_grad():
        got = model(torch.from_numpy(audio), torch.from_numpy(embs)).numpy()
    assert got.shape == ref.shape == (2, 37, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)
    back = _flat(convert.tsvad_to_flax(model.state_dict(), num_heads=2))
    for k, a in _flat(v).items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


# ---------------------------------------------------------------------------
# the speaker classifier, the export-encoder npz and extract-embeddings
# ---------------------------------------------------------------------------

SPK = {"ecapa": dict(n_classes=5, encoder="ecapa", feat_dim=FEAT, emb_dim=16, ecapa_channels=64),
       "resnet34": dict(n_classes=5, encoder="resnet34", feat_dim=FEAT, emb_dim=16)}


@pytest.fixture(scope="module", params=sorted(SPK))
def classifier(request):
    kw = SPK[request.param]
    jmodel = JEmb.SpeakerClassifier(cfg=JEmb.SpkEmbedConfig(**kw))
    v = _perturb(jax.jit(jmodel.init, static_argnums=3)(jax.random.PRNGKey(0), jnp.zeros((1, 40, FEAT)), None, False),
                 1)
    model = E.SpeakerClassifier(E.SpkEmbedConfig(**kw), device="cpu")
    model.load_state_dict(convert.spk_from_flax(v))
    return kw, jmodel, v, model


@pytest.mark.parametrize("with_labels", [False, True])
def test_spk_classifier_logits_match_jax(classifier, with_labels):
    _, jmodel, v, model = classifier
    fb = _fbank(4, 56, 10)
    labels = np.array([0, 3, 4, 3], np.int32)
    ref = np.asarray(jmodel.apply(v, jnp.asarray(fb), jnp.asarray(labels) if with_labels else None, False))
    with torch.no_grad():
        got = model(torch.from_numpy(fb), torch.from_numpy(labels) if with_labels else None)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * 32)  # cosines × AAM scale 32
    back = _flat(convert.spk_to_flax(model.state_dict()))
    for k, a in _flat(v).items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


def test_encoder_npz_round_trip_both_ways(classifier, tmp_path):
    """A port export read by the JAX load_encoder, and a JAX export read by
    the port's, give the exporting side's embeddings; both files hold the
    same arrays under the same keys."""
    kw, _, v, model = classifier
    fb = _fbank(2, 50, 11)
    port_npz, jax_npz = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    sd = {k[len("speech_encoder."):]: t for k, t in model.state_dict().items() if k.startswith("speech_encoder.")}
    E.save_encoder(port_npz, E.SpkEmbedConfig(**kw), sd)
    jenc, jvars = JEmb.load_encoder(port_npz)
    with torch.no_grad():
        want = model.speech_encoder(torch.from_numpy(fb), mode="embedding").numpy()
    _fp32_close(np.asarray(jenc.apply(jvars, jnp.asarray(fb), False, "embedding")), want)
    enc_vars = {"params": v["params"]["speech_encoder"], "batch_stats": v["batch_stats"]["speech_encoder"]}
    JEmb.save_encoder(jax_npz, JEmb.SpkEmbedConfig(**kw), enc_vars)
    enc, cfg = E.load_encoder(jax_npz, device="cpu")
    assert cfg.encoder == kw["encoder"] and not enc.training
    with torch.no_grad():
        _fp32_close(enc(torch.from_numpy(fb), mode="embedding"), want)
    with np.load(port_npz) as a, np.load(jax_npz) as b:
        assert set(a.files) == set(b.files)
        assert json.loads(str(a["__cfg__"])) == json.loads(str(b["__cfg__"]))
        for k in a.files:
            if k != "__cfg__":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_extract_embeddings_from_an_ecapa_npz_matches_jax(tmp_path):
    """`extract-embeddings --encoder-ckpt ecapa.npz` (fbank at 80 bins, the
    ECAPA in embedding mode) held to the JAX CLI's store."""
    kw = dict(SPK["ecapa"], feat_dim=80)
    jmodel = JEmb.SpeakerClassifier(cfg=JEmb.SpkEmbedConfig(**kw))
    v = _perturb(jax.jit(jmodel.init, static_argnums=3)(jax.random.PRNGKey(0), jnp.zeros((1, 40, 80)), None, False), 2)
    npz = str(tmp_path / "ecapa.npz")
    JEmb.save_encoder(npz, JEmb.SpkEmbedConfig(**kw),
                      {"params": v["params"]["speech_encoder"], "batch_stats": v["batch_stats"]["speech_encoder"]})
    c = write_synthetic_corpus(str(tmp_path / "targets"), n_recs=2, seconds=4.0, rate=8000, n_speakers=1,
                               emb_dim=16, seed=3, prefix="t")
    store, jstore = str(tmp_path / "embs.npz"), str(tmp_path / "jax_embs.npz")
    assert port_cli(["extract-embeddings", "--data-dir", c["data_dir"], "--out", store, "--encoder-ckpt", npz,
                     "--rate", "8000", "--window", "2.0", "--hop", "1.0", "--device", "cpu"]) == 0
    JCLI.cmd_extract_embeddings(argparse.Namespace(data_dir=c["data_dir"], out=jstore, encoder_ckpt=npz, rate=8000,
                                                   window=2.0, hop=1.0))
    with np.load(store) as got, np.load(jstore) as want:
        assert set(got.files) == set(want.files) and len(got.files) == 2
        for k in want.files:
            assert got[k].shape == want[k].shape and got[k].shape[1:] == (16,), k
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


def test_build_speaker_encoder_names():
    """All eight names of the JAX zoo build the port's module of the same
    class name; an unknown name raises KeyError, as in JAX."""
    assert set(S.SPEAKER_ENCODERS) == set(JS.SPEAKER_ENCODERS)
    assert isinstance(S.build_speaker_encoder("ecapa_tdnn", channels=16, feat_dim=FEAT), S.ECAPA_TDNN)
    assert isinstance(S.build_speaker_encoder("simam_resnet34", feat_dim=FEAT, m_channels=4), S.SimAMResNet34)
    with torch.device("meta"):
        for name in JS.SPEAKER_ENCODERS:
            enc = S.build_speaker_encoder(name)
            assert type(enc).__name__ == JS.SPEAKER_ENCODERS[name].split(":")[1], name
    with pytest.raises(KeyError):
        S.build_speaker_encoder("wavlm_large")
