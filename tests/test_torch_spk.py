"""Port parity of the hermetic TS-VAD recipe's front half: the speaker
classifier (AAM softmax over CAM++ with its dense head), its loss and
trainer steps, the export-encoder npz both ways, the copied numpy modules
(simulate, room, spk_dataset, prep), and the CLI chain simulate → train spk
→ export-encoder → prepare-targets → extract-embeddings, against the JAX
package."""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.cli import main as JCLI
from speaker_diarization_tpu.data import prep as JPrep
from speaker_diarization_tpu.data import room as JRoom
from speaker_diarization_tpu.data import simulate as JSim
from speaker_diarization_tpu.data import spk_dataset as JSpk
from speaker_diarization_tpu.models import spk_embed as JEmb
from speaker_diarization_tpu.ops import features as JF
from speaker_diarization_tpu.ops import losses as JL
from speaker_diarization_tpu.train import tasks as JT
from speaker_diarization_tpu.train.trainer import Trainer as JTrainer
from speaker_diarization_tpu.train.trainer import TrainerConfig as JTrainerConfig
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data import prep, room, simulate, spk_dataset
from speaker_diarization_tpu_torch.models import spk_embed as E
from speaker_diarization_tpu_torch.ops import features as F
from speaker_diarization_tpu_torch.ops.losses import l2_normalize
from speaker_diarization_tpu_torch.train.tasks import make_spk_loss
from speaker_diarization_tpu_torch.train.trainer import Trainer, TrainerConfig
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

N_CLASSES = 7
SMALL = dict(n_classes=N_CLASSES, encoder_blocks=(1, 1), margin=0.3)


@pytest.fixture(scope="module")
def classifier():
    """The JAX SpeakerClassifier (small depth, perturbed weights and
    statistics) and the port loaded from it."""
    jmodel = JEmb.SpeakerClassifier(cfg=JEmb.SpkEmbedConfig(**SMALL))
    v = jax.jit(jmodel.init, static_argnums=3)(jax.random.PRNGKey(0), jnp.zeros((1, 120, 80)), None, False)
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])  # positive variances
    model = E.SpeakerClassifier(E.SpkEmbedConfig(**SMALL), device="cpu")
    model.load_state_dict(convert.spk_from_flax(v))
    return jmodel, v, model


def _fbank(B, T, seed):
    return np.random.default_rng(seed).standard_normal((B, T, 80)).astype(np.float32)


def test_l2_normalize_matches_jax_and_is_finite_at_zero():
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    x[1] = 0.0
    np.testing.assert_allclose(l2_normalize(torch.from_numpy(x)).numpy(), np.asarray(JL.l2_normalize(jnp.asarray(x))),
                               atol=1e-7)
    t = torch.from_numpy(x).requires_grad_()
    l2_normalize(t).sum().backward()
    assert torch.isfinite(t.grad).all()


@pytest.mark.parametrize("with_labels", [False, True])
def test_eval_logits_match_jax(classifier, with_labels):
    jmodel, v, model = classifier
    fb = _fbank(4, 150, 2)
    labels = np.array([0, 3, 6, 3], np.int32)
    ref = np.asarray(jmodel.apply(v, jnp.asarray(fb), jnp.asarray(labels) if with_labels else None, False))
    with torch.no_grad():
        got = model(torch.from_numpy(fb), torch.from_numpy(labels) if with_labels else None)
    assert got.shape == (4, N_CLASSES) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_embed_matches_jax(classifier):
    jmodel, v, model = classifier
    fb = _fbank(3, 130, 3)
    ref = np.asarray(jmodel.apply(v, jnp.asarray(fb), method=jmodel.embed))
    with torch.no_grad():
        got = model.embed(torch.from_numpy(fb))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)


def test_train_mode_logits_and_batch_statistics_match_jax(classifier):
    """BatchNorm on batch statistics, the running ones updated as flax does."""
    jmodel, v, model = classifier
    fb = _fbank(6, 140, 4)
    labels = np.array([1, 2, 3, 4, 5, 6], np.int32)
    ref, new = jmodel.apply(v, jnp.asarray(fb), jnp.asarray(labels), True, mutable=["batch_stats"])
    m = E.SpeakerClassifier(E.SpkEmbedConfig(**SMALL), device="cpu")
    m.load_state_dict(model.state_dict())
    m.train()
    got = m(torch.from_numpy(fb), torch.from_numpy(labels))
    # the batch variance E[x²] - E[x]² over six items, summed in another
    # order, moves the logits (cosines x 32) by a few 1e-5 relative
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    want = convert.spk_from_flax({"params": v["params"], "batch_stats": jax.device_get(new["batch_stats"])})
    sd = m.state_dict()
    for k, t in want.items():
        if "running_" in k:
            np.testing.assert_allclose(sd[k].numpy(), t.numpy(), atol=1e-5, err_msg=k)


def test_margin_applies_to_the_target_class_only(classifier):
    _, _, model = classifier
    fb = torch.from_numpy(_fbank(3, 120, 5))
    labels = torch.tensor([2, 0, 5])
    with torch.no_grad():
        plain, aam = model(fb), model(fb, labels)
    hit = torch.zeros_like(plain, dtype=torch.bool)
    hit[torch.arange(3), labels] = True
    assert torch.all(aam[hit] < plain[hit])
    torch.testing.assert_close(aam[~hit], plain[~hit], rtol=0, atol=0)


def test_spk_loss_and_accuracy_match_jax(classifier):
    """make_spk_loss from audio (fbank on both sides), eval mode."""
    jmodel, v, model = classifier
    rng = np.random.default_rng(6)
    batch = dict(audio=(0.1 * rng.standard_normal((4, 12000))).astype(np.float32),
                 label=np.array([0, 1, 2, 3], np.int32))
    jloss, (jaux, _) = JT.make_spk_loss(jmodel, sample_rate=8000)(
        v["params"], {"batch_stats": v["batch_stats"]}, {k: jnp.asarray(a) for k, a in batch.items()}, None, False)
    with torch.no_grad():
        loss, aux = make_spk_loss(sample_rate=8000)(model, {k: torch.from_numpy(a) for k, a in batch.items()}, None, False)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    assert aux["acc"].item() == pytest.approx(float(jaux["acc"]))


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("opt", ["sgd", "adam_poly_clip"])
def test_trainer_steps_match_jax(classifier, opt, monkeypatch):
    """Three train steps on fbank batches (the fbank stage is held by
    test_torch_features; train-mode BatchNorm over a small batch amplifies the
    two frameworks' fbank rounding past these bars): losses, weights and
    BatchNorm statistics, tolerances as tests/test_torch_train.py states them."""
    jmodel, v, _ = classifier
    monkeypatch.setattr(JF, "kaldi_fbank_auto", lambda x, num_mel_bins, sample_rate, mean_norm: x)
    monkeypatch.setattr(F, "kaldi_fbank_auto", lambda x, sample_rate, num_mel_bins, mean_norm: x)
    if opt == "sgd":
        # gradient norms are ~250 (AAM scale 32); at a larger rate, train-mode
        # BatchNorm over six items turns rounding into another trajectory
        kw = dict(optimizer="sgd", schedule="const", learning_rate=1e-5, grad_clip_norm=None)
        loss_tol, p_tol = dict(rtol=1e-5, atol=0), dict(rtol=1e-4, atol=1e-6)
    else:
        kw = dict(optimizer="adam", schedule="poly", learning_rate=1e-3, warmup_steps=2, total_steps=10,
                  grad_clip_norm=5.0)
        loss_tol, p_tol = dict(rtol=1e-4, atol=0), dict(rtol=0, atol=2 * 1e-3 * 3)
    rng = np.random.default_rng(7)
    batches = [dict(audio=rng.standard_normal((6, 110, 80)).astype(np.float32),
                    label=rng.integers(0, N_CLASSES, 6).astype(np.int32)) for _ in range(3)]
    jtrainer = JTrainer(JT.make_spk_loss(jmodel, sample_rate=8000), JTrainerConfig(**kw), has_mutable=True)
    state = jtrainer.init_state(v["params"], mutable={"batch_stats": v["batch_stats"]})
    model = E.SpeakerClassifier(E.SpkEmbedConfig(**SMALL), device="cpu")
    model.load_state_dict(convert.spk_from_flax(v))
    trainer = Trainer(model, make_spk_loss(sample_rate=8000), TrainerConfig(**kw))
    for b in batches:
        state, jaux = jtrainer.train_step(state, {k: jnp.asarray(a) for k, a in b.items()})
        aux = trainer.train_step({k: torch.from_numpy(a) for k, a in b.items()})
        np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]), **loss_tol)
        assert aux["acc"].item() == pytest.approx(float(jaux["acc"]))
    got = _flat(convert.spk_to_flax(model.state_dict()))
    want = _flat({"params": state.params, "batch_stats": state.mutable["batch_stats"]})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **p_tol)


def _jax_embed(jenc, jvars, fb):
    return np.asarray(jenc.apply(jvars, jnp.asarray(fb), False, "embedding"))


def test_encoder_npz_round_trip_both_ways(classifier, tmp_path):
    """A port export read by the JAX load_encoder, and a JAX export read by the
    port's load_encoder, give the same embeddings as the exporting side."""
    jmodel, v, model = classifier
    fb = _fbank(2, 160, 8)
    cfg = E.SpkEmbedConfig(**SMALL)
    port_npz = str(tmp_path / "port_encoder.npz")
    sd = {k[len("speech_encoder."):]: t for k, t in model.state_dict().items() if k.startswith("speech_encoder.")}
    E.save_encoder(port_npz, cfg, sd)
    jenc, jvars = JEmb.load_encoder(port_npz)
    with torch.no_grad():
        want = model.speech_encoder(torch.from_numpy(fb), mode="embedding").numpy()
    np.testing.assert_allclose(_jax_embed(jenc, jvars, fb), want, atol=1e-4)

    jax_npz = str(tmp_path / "jax_encoder.npz")
    enc_vars = {"params": v["params"]["speech_encoder"], "batch_stats": v["batch_stats"]["speech_encoder"]}
    JEmb.save_encoder(jax_npz, JEmb.SpkEmbedConfig(**SMALL), enc_vars)
    enc, got_cfg = E.load_encoder(jax_npz, device="cpu")
    assert got_cfg.encoder_blocks == (1, 1) and got_cfg.emb_dim == 192 and not enc.training
    with torch.no_grad():
        got = enc(torch.from_numpy(fb), mode="embedding").numpy()
    np.testing.assert_allclose(got, _jax_embed(*JEmb.load_encoder(jax_npz), fb), atol=1e-4)
    # the two files hold the same arrays under the same keys
    with np.load(port_npz) as a, np.load(jax_npz) as b:
        assert set(a.files) == set(b.files)
        assert json.loads(str(a["__cfg__"])) == json.loads(str(b["__cfg__"]))
        for k in a.files:
            if k != "__cfg__":
                np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=k)


def test_unported_encoders_raise():
    """ECAPA and ResNet34 are ported now (tests/test_torch_speaker_encoders.py);
    any other encoder name raises as the JAX classifier does
    (spk_embed.py:63), and the zoo builds all eight of its names."""
    from speaker_diarization_tpu_torch.models.eres2net import ERes2Net
    from speaker_diarization_tpu_torch.models.speaker_encoders import build_speaker_encoder

    for name in ("wavlm", "eres2net"):
        with pytest.raises(ValueError, match="unknown encoder"):
            E.SpeakerClassifier(E.SpkEmbedConfig(encoder=name), device="cpu")
    assert isinstance(build_speaker_encoder("eres2net", m_channels=4, num_blocks=(1, 1, 1, 1)), ERes2Net)


# ---------------------------------------------------------------------------
# the copied numpy modules: both copies give the same files and arrays
# ---------------------------------------------------------------------------


def _tree(root):
    """{relative path: bytes} of every file under root, with root in text files
    replaced so that absolute paths compare."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                data = fh.read()
            out[os.path.relpath(p, root)] = data.replace(root.encode(), b"<root>")
    return out


def test_simulate_copy_matches(tmp_path):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(n_mixtures=2, n_speakers=2, rate=8000, seed=3, with_rir=True, rir_method="image_source",
              src_speakers=3, utts_per_speaker=3)
    JSim.simulate_corpus(a, **kw)
    simulate.simulate_corpus(b, **kw)
    ta, tb = _tree(a), _tree(b)
    assert ta.keys() == tb.keys() and any(k.endswith("rttm") for k in ta)
    for k in ta:
        assert ta[k] == tb[k], k


def test_room_copy_matches():
    ja = JRoom.RandomRoomSimulator(fs=8000, seed=4).rirs(2)
    pa = room.RandomRoomSimulator(fs=8000, seed=4).rirs(2)
    for x, y in zip(ja, pa):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def voice_pool(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voice_pool"))
    src = simulate.synthesize_speaker_corpus(os.path.join(root, "src"), n_speakers=3, utts_per_speaker=4, seed=2)
    noise = simulate.synthesize_noise_corpus(os.path.join(root, "noise"), n_noises=2, dur=3.0, seed=3)
    specs = simulate.random_mixture_specs(src, noise, None, n_mixtures=2, n_speakers=3, min_utts=2, max_utts=3,
                                          sil_scale=1.5, noise_snrs=(10.0, 20.0), speech_rvb_probability=0.0, seed=4)
    data = simulate.make_mixtures(specs, os.path.join(root, "mix", "data"), os.path.join(root, "mix", "wav"), 8000)
    return dict(root=root, src=src, noise=noise, data=data)


def test_spk_dataset_copy_matches(voice_pool):
    kw = dict(dur=1.5, rate=8000, is_train=True, seed=5, noise_dir=voice_pool["noise"], aug_prob=0.7)
    jds, pds = JSpk.SpeakerUttDataset(voice_pool["src"], **kw), spk_dataset.SpeakerUttDataset(voice_pool["src"], **kw)
    assert pds.n_speakers == jds.n_speakers == 3
    for epoch in (0, 1):
        got = list(spk_dataset.spk_batch_iterator(pds, 4, True, seed=5, epoch=epoch))
        want = list(JSpk.spk_batch_iterator(jds, 4, True, seed=5, epoch=epoch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["audio"], w["audio"])
            np.testing.assert_array_equal(g["label"], w["label"])


def test_prep_copy_matches(voice_pool, tmp_path):
    rttm = os.path.join(voice_pool["data"], "rttm")
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    JPrep.prepare_targets_from_rttm(rttm, voice_pool["data"], a, min_target_s=0.2)
    prep.prepare_targets_from_rttm(rttm, voice_pool["data"], b, min_target_s=0.2)
    ta, tb = _tree(a), _tree(b)
    assert ta.keys() == tb.keys() and "labels.jsonl" in ta
    for k in ta:
        assert ta[k] == tb[k], k


# ---------------------------------------------------------------------------
# the CLI chain on the CPU, held to the JAX extract-embeddings
# ---------------------------------------------------------------------------


def test_cli_chain_matches_jax_extract_embeddings(tmp_path):
    root = str(tmp_path)
    pool = os.path.join(root, "pool")
    assert port_cli(["simulate", "--out", pool, "--n-mixtures", "1", "--n-speakers", "2", "--seed", "0"]) == 0
    mix = os.path.join(root, "mix")
    assert port_cli(["simulate", "--out", mix, "--source-dir", f"{pool}/src", "--noise-dir", f"{pool}/noise",
                     "--n-mixtures", "2", "--n-speakers", "3", "--seed", "1"]) == 0
    exp = os.path.join(root, "spk")
    sets = ["encoder_blocks=1,1", "n_mels=80", "batch_size=8", "num_steps=2", "log_every=1", "valid_every=1000",
            "schedule=poly", "learning_rate=1e-3", "warmup_steps=1", "aam_margin=0.3"]
    assert port_cli(["train", "--family", "spk", "--train-dir", f"{pool}/src", "--noise-dir", f"{pool}/noise",
                     "--exp-dir", exp, "--device", "cpu"] + [a for kv in sets for a in ("--set", kv)]) == 0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2] and all(np.isfinite(r["loss"]) and "acc" in r for r in recs)
    with open(os.path.join(exp, "train_config.json")) as f:
        assert json.load(f)["all_n_speakers"] == 8  # from the corpus
    enc = os.path.join(root, "encoder.npz")
    assert port_cli(["export-encoder", "--exp-dir", exp, "--out", enc]) == 0
    targets = os.path.join(root, "targets")
    assert port_cli(["prepare-targets", "--rttm", f"{mix}/data/rttm", "--data-dir", f"{mix}/data",
                     "--out", targets]) == 0
    store = os.path.join(root, "embs.npz")
    assert port_cli(["extract-embeddings", "--data-dir", targets, "--out", store, "--encoder-ckpt", enc,
                     "--rate", "8000", "--window", "2.0", "--hop", "1.0", "--device", "cpu"]) == 0
    jstore = os.path.join(root, "jax_embs.npz")
    JCLI.cmd_extract_embeddings(argparse.Namespace(data_dir=targets, out=jstore, encoder_ckpt=enc, rate=8000,
                                                   window=2.0, hop=1.0))
    with np.load(store) as got, np.load(jstore) as want:
        assert set(got.files) == set(want.files) and len(got.files) == 6
        for k in want.files:
            assert got[k].shape == want[k].shape and got[k].shape[1:] == (192,), k
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


def test_export_encoder_refuses_a_run_without_an_embedding_head(tmp_path):
    from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
    from speaker_diarization_tpu_torch.train.checkpoints import CheckpointManager

    model = TSVADModel(TSVADConfig(encoder_block_layers=(1, 1), transformer_embed_dim=32,
                                   transformer_ffn_embed_dim=64, num_attention_head=2, speaker_embed_dim=16,
                                   num_transformer_layer=1), device="cpu")

    class _T:
        step = 1

        def state_dict(self):
            return {"model": model.state_dict()}

    CheckpointManager(str(tmp_path)).save(_T())
    with pytest.raises(SystemExit, match="not a spk run"):
        port_cli(["export-encoder", "--exp-dir", str(tmp_path), "--out", str(tmp_path / "e.npz")])
