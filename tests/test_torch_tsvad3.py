"""Port parity of TS-VAD3: CAM++ in 'both' mode, AttFuse, TSVAD3Model logits
for each fusion setting (eval and train mode), the loss and its gradients,
the TS-VAD dataset's enrollment waveforms, the weight converters both ways,
and a port-only `train` → `infer --threshold-sweep` → `score` chain, against
the JAX package.

Tolerances: outputs 1e-4·max(1, max|ref|) in fp32; losses 1e-5 relative;
dataset items bit for bit. Train-mode logits are held at 1e-3·max(1,
max|ref|) and running statistics at 1e-4: BatchNorm on batch statistics
takes E[x²] − E[x]² in fp32, summed in another order in each framework, and
the logits move by up to 1.3e-4 of their size (8e-6 in eval mode), as the
TS-VAD train-mode tests found.

Gradients are held at 3e-3·max|ref grad| (the max over the whole gradient)
in eval mode and 3e-2 in train mode, against 1e-4 elsewhere. The speaker
encoder's gradient is not continuous at float32 resolution: CAM++'s ReLUs
flip with the rounding, and JAX's own gradient moves by 1.39e-3 of
max|grad| (eval) and up to 1.8e-2 (train, through BatchNorm's batch
statistics) when the audio is scaled by 1 + 1e-7 noise; the port differs
from JAX by the same 1.39e-3 in eval mode. Both sides read JAX's fbank for
the gradients (the port's kaldi_fbank_auto patched to return it), as the
twin differs from it by ~1e-5; the loss from raw audio is held to JAX's
from raw audio."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.data.tsvad_dataset import TSVADChunkDataset as JDataset
from speaker_diarization_tpu.data.tsvad_dataset import tsvad_batch_iterator as j_batches
from speaker_diarization_tpu.infer.embeddings import EmbeddingStore as JStore
from speaker_diarization_tpu.models.campplus import CAMPPlus as JCAMPPlus
from speaker_diarization_tpu.models.tsvad import TSVADConfig as JConfig
from speaker_diarization_tpu.models.tsvad3 import AttFuse as JAttFuse
from speaker_diarization_tpu.models.tsvad3 import TSVAD3Config as J3Config
from speaker_diarization_tpu.models.tsvad3 import TSVAD3Model as JModel
from speaker_diarization_tpu.ops import features as JF
from speaker_diarization_tpu.train import tasks as JT
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.data.tsvad_dataset import TSVADChunkDataset, tsvad_batch_iterator
from speaker_diarization_tpu_torch.infer.embeddings import EmbeddingStore
from speaker_diarization_tpu_torch.models.campplus import CAMPPlus
from speaker_diarization_tpu_torch.models.spk_embed import SpkEmbedConfig, save_encoder
from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig
from speaker_diarization_tpu_torch.models.tsvad3 import AttFuse, TSVAD3Config, TSVAD3Model
from speaker_diarization_tpu_torch.ops import features as TF
from speaker_diarization_tpu_torch.train.checkpoints import CheckpointManager
from speaker_diarization_tpu_torch.train.tasks import make_tsvad3_loss
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

RATE = 8000
BASE = dict(max_num_speaker=4, speaker_embed_dim=16, transformer_embed_dim=32, transformer_ffn_embed_dim=64,
            num_attention_head=2, num_transformer_layer=1, dropout=0.0, encoder_block_layers=(1, 1), sample_rate=RATE)
FUSIONS = [(False, True), (True, True), (False, False), (True, False)]  # (fuse_fbank_feat, fuse_speaker_embedding_feat)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturb(variables, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + scale * rng.standard_normal(a.shape).astype(np.float32), variables)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])  # positive variances
    return v


def _fp32_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def _grads_close(got: dict, want: dict, tol: float):
    """tol·max|ref grad|, the max over the whole gradient (see the module docstring)."""
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol * top, err_msg=k)


def _inputs(B=2, seed=0, absent=True):
    rng = np.random.default_rng(seed)
    audio = (0.1 * rng.standard_normal((B, 2 * RATE))).astype(np.float32)
    enroll = (0.1 * rng.standard_normal((B, 4, RATE))).astype(np.float32)
    if absent:
        enroll[-1, 3] = 0.0  # an absent speaker slot
    return audio, enroll


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_campplus_both_mode_matches_jax():
    jm = JCAMPPlus(embedding_size=16, block_layers=(1, 2), block_dilations=(1, 2))
    fb = np.random.default_rng(1).standard_normal((3, 57, 80)).astype(np.float32)
    v = _perturb(jax.jit(jm.init, static_argnums=(2, 3))(jax.random.PRNGKey(0), jnp.asarray(fb), False, "both"), 2)
    m = CAMPPlus(embedding_size=16, block_layers=(1, 2), block_dilations=(1, 2)).eval()
    m.load_state_dict(convert.campplus_from_flax(v["params"], v["batch_stats"]))
    e_ref, h_ref = jm.apply(v, jnp.asarray(fb), False, "both")
    with torch.no_grad():
        e, h = m(torch.from_numpy(fb), mode="both")
        e1 = m(torch.from_numpy(fb), mode="embedding")
    assert e.shape == (3, 16) and h.shape == h_ref.shape == (3, 29, m.out_channels)
    _fp32_close(e, e_ref)
    _fp32_close(h, h_ref)
    assert torch.equal(e, e1)


def test_att_fuse_matches_jax():
    rng = np.random.default_rng(3)
    spk = rng.standard_normal((2, 30, 12)).astype(np.float32)
    sp = rng.standard_normal((2, 11, 12)).astype(np.float32)
    jm = JAttFuse(out_dim=7)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(spk), jnp.asarray(sp)))
    m = AttFuse(12, 7)
    m.load_state_dict(convert.named_from_flax(v["params"], {}))
    with torch.no_grad():
        _fp32_close(m(torch.from_numpy(spk), torch.from_numpy(sp)), jm.apply(v, jnp.asarray(spk), jnp.asarray(sp)))


# ---------------------------------------------------------------------------
# TSVAD3Model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pair(fuse_fbank, fuse_frames):
    kw = dict(ts_len=1.0, fuse_fbank_feat=fuse_fbank, fuse_speaker_embedding_feat=fuse_frames,
              speaker_encoder_layers=(1, 1))
    jm = JModel(cfg=J3Config(base=JConfig(**BASE), **kw))
    audio, enroll = _inputs(B=1)
    v = _perturb(jax.jit(jm.init, static_argnums=3)(jax.random.PRNGKey(0), jnp.asarray(audio),
                                                    jnp.asarray(enroll), 50), 1)
    m = TSVAD3Model(TSVAD3Config(base=TSVADConfig(**BASE), **kw), device="cpu")
    m.load_state_dict(convert.tsvad3_from_flax(v))
    return jm, v, m


@pytest.fixture(scope="module", params=FUSIONS, ids=lambda f: f"fbank{int(f[0])}-frames{int(f[1])}")
def pair(request):
    return _pair(*request.param)


def test_tsvad3_eval_logits_match_jax(pair):
    jm, v, m = pair
    audio, enroll = _inputs(seed=4)
    ref = jax.jit(jm.apply, static_argnums=3)(v, jnp.asarray(audio), jnp.asarray(enroll), 50)
    with torch.no_grad():
        got = m(torch.from_numpy(audio), torch.from_numpy(enroll), 50)
    assert got.shape == ref.shape == (2, 50, 4)
    _fp32_close(got, ref)


def test_tsvad3_train_mode_logits_and_statistics_match_jax(pair):
    jm, v, m = pair
    audio, enroll = _inputs(seed=5)
    apply = jax.jit(functools.partial(jm.apply, mutable=["batch_stats"]), static_argnums=(3, 4))
    ref, new = apply(v, jnp.asarray(audio), jnp.asarray(enroll), 50, True)
    m2 = TSVAD3Model(m.cfg, device="cpu")
    m2.load_state_dict(m.state_dict())
    m2.train()
    got = m2(torch.from_numpy(audio), torch.from_numpy(enroll), 50)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0,
                               atol=1e-3 * max(1.0, float(np.abs(ref).max())))
    want = convert.tsvad3_from_flax({"params": v["params"], "batch_stats": jax.device_get(new["batch_stats"])})
    sd = m2.state_dict()
    for k, t in want.items():
        if "running_" in k:
            np.testing.assert_allclose(sd[k].numpy(), t.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)


def test_tsvad3_weights_round_trip(pair):
    _, v, m = pair
    back = convert.tsvad3_to_flax(m.state_dict(), num_heads=2)
    a, b = _flat(v), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_tsvad3_loss_and_gradients_match_jax(monkeypatch, train):
    """With both fusions on, so every module has a gradient. Without an
    absent (all-zero) enrollment: its CAM++ frames are nearly constant in
    time, and the std pooling's gradient 1/(2·sqrt(var + 1e-10)) there
    scales rounding noise by up to 5e4 in either framework."""
    jm, v, m = _pair(True, True)
    audio, enroll = _inputs(seed=6, absent=False)
    labels = (np.random.default_rng(7).random((2, 50, 4)) < 0.3).astype(np.float32)
    batch = dict(audio=audio, enroll_audio=enroll, target_embs=np.zeros((2, 4, 16), np.float32), labels=labels)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    jloss_fn = JT.make_tsvad3_loss(jm, 50)

    def jl(params):
        loss, (aux, _) = jloss_fn(params, {"batch_stats": v["batch_stats"]}, jb, jax.random.PRNGKey(0), train)
        return loss, aux

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jl, has_aux=True))(v["params"])
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}

    def fresh():
        m2 = TSVAD3Model(m.cfg, device="cpu")
        m2.load_state_dict(m.state_dict())
        return m2.train(train)

    loss, aux = make_tsvad3_loss(50)(fresh(), tb, None, train)  # fbank from raw audio
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux["frame_der"].item(), float(jaux["frame_der"]), rtol=1e-6)

    def jax_fbank(wave, sample_rate, num_mel_bins, mean_norm=True):
        return torch.from_numpy(np.array(JF.kaldi_fbank_auto(jnp.asarray(wave.numpy()), sample_rate, num_mel_bins,
                                                              mean_norm)))

    monkeypatch.setattr(TF, "kaldi_fbank_auto", jax_fbank)
    m2 = fresh()
    loss, _ = make_tsvad3_loss(50)(m2, tb, None, train)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = {n: p.grad for n, p in m2.named_parameters()}
    _grads_close(_flat(convert.tsvad3_to_flax(grads, num_heads=2)["params"]), _flat(jgrads), 3e-2 if train else 3e-3)


def test_use_spk_embed_mode_matches_jax():
    """`use_spk_embed`: stored embeddings in, as TS-VAD (no speaker encoder)."""
    kw = dict(use_spk_embed=True, fuse_speaker_embedding_feat=False)
    jm = JModel(cfg=J3Config(base=JConfig(**BASE), **kw))
    audio, _ = _inputs(seed=8)
    embs = np.random.default_rng(9).standard_normal((2, 4, 16)).astype(np.float32)
    v = _perturb(jax.jit(jm.init, static_argnums=3)(jax.random.PRNGKey(0), jnp.asarray(audio), jnp.asarray(embs), 50), 1)
    m = TSVAD3Model(TSVAD3Config(base=TSVADConfig(**BASE), **kw), device="cpu")
    m.load_state_dict(convert.tsvad3_from_flax(v))
    assert not hasattr(m, "speaker_encoder")
    with torch.no_grad():
        _fp32_close(m(torch.from_numpy(audio), torch.from_numpy(embs), 50), jm.apply(v, jnp.asarray(audio),
                                                                                    jnp.asarray(embs), 50))


def test_freezing_an_encoder_stops_its_gradient():
    _, _, m = _pair(False, True)
    audio, enroll = _inputs(seed=10)
    for freeze in (False, True):
        m2 = TSVAD3Model(m.cfg, device="cpu")
        m2.load_state_dict(m.state_dict())
        m2.train()
        m2(torch.from_numpy(audio), torch.from_numpy(enroll), 50, freeze_speech_encoder=freeze,
           freeze_speaker_encoder=freeze).sum().backward()
        for enc in (m2.speech_encoder, m2.speaker_encoder):
            grads = [p.grad for p in enc.parameters()]
            assert all(g is None for g in grads) if freeze else any(g is not None and g.abs().max() > 0 for g in grads)


# ---------------------------------------------------------------------------
# dataset, CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tsvad3"))
    out = {}
    for name, seed in (("train", 1), ("valid", 2)):
        c = write_synthetic_corpus(os.path.join(root, name), n_recs=2 if name == "train" else 1, seconds=10.0,
                                   rate=RATE, n_speakers=3, emb_dim=16, seed=seed, prefix=name)
        targets = os.path.join(root, name, "targets")
        assert port_cli(["prepare-targets", "--rttm", c["rttm"], "--data-dir", c["data_dir"], "--out", targets]) == 0
        c["target_audio"] = os.path.join(targets, "target_audio")
        out[name] = c
    out["root"] = root
    return out


@pytest.mark.parametrize("is_train", [True, False])
def test_dataset_enrollment_matches_jax(corpus, is_train):
    """Items and batches with target_audio_dir: the mixture crops and
    augmentations, labels, embeddings and enrollment waveforms bit for bit,
    two epochs at train."""
    c = corpus["train"]
    kw = dict(rs_len=2.0, segment_shift=1.0, rate=RATE, is_train=is_train, seed=3, target_audio_dir=c["target_audio"],
              enroll_len_s=1.5, noise_dir=c["data_dir"] if is_train else None)
    port = TSVADChunkDataset(c["data_dir"], EmbeddingStore.load(c["emb_store"]), **kw)
    ref = JDataset(c["data_dir"], JStore.load(c["emb_store"]), **kw)
    assert len(port) == len(ref) > 8
    for epoch in (0, 1) if is_train else (0,):
        got = list(tsvad_batch_iterator(port, 4, is_train, seed=3, epoch=epoch))
        want = list(j_batches(ref, 4, is_train, seed=3, epoch=epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys() and "enroll_audio" in g and g["enroll_audio"].shape == (4, 4, 12000)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"epoch {epoch} {k}")
    # without a store (TS-VAD3 from enrollment waveforms alone): zero target
    # embeddings, and no embedding draws from the item's RNG, as in JAX
    got, want = TSVADChunkDataset(c["data_dir"], None, **kw)[1], JDataset(c["data_dir"], None, **kw)[1]
    assert (got["target_embs"] == 0).all() and got["target_embs"].shape == (4, 192)
    for k in ("audio", "target_embs", "labels", "enroll_audio"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


SETS = ["sample_rate=8000", "n_mels=80", "encoder_blocks=1,1", "n_layers=1", "d_ff=32", "rs_len=2.0",
        "segment_shift=1.0", "ts_len=1.0", "batch_size=4", "log_every=1", "valid_every=2", "schedule=poly",
        "learning_rate=1e-3", "warmup_steps=1"]


def _train_argv(corpus, exp, extra=()):
    t, va = corpus["train"], corpus["valid"]
    return (["train", "--family", "tsvad3", "--train-dir", t["data_dir"], "--target-audio-dir", t["target_audio"],
             "--valid-dir", va["data_dir"], "--valid-target-audio-dir", va["target_audio"], "--exp-dir", exp,
             "--device", "cpu", *extra] + [a for kv in SETS for a in ("--set", kv)])


def test_cli_train_infer_score(corpus, capsys):
    va = corpus["valid"]
    exp, hyp = os.path.join(corpus["root"], "exp"), os.path.join(corpus["root"], "hyp.rttm")
    assert port_cli(_train_argv(corpus, exp, ["--set", "num_steps=2"])) == 0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if r["kind"] == "train"] == [1, 2] and any(r["kind"] == "valid" for r in recs)
    assert all(np.isfinite(r["loss"]) for r in recs)
    capsys.readouterr()
    assert port_cli(["infer", "--data-dir", va["data_dir"], "--exp-dir", exp, "--target-audio-dir",
                     va["target_audio"], "--out", hyp, "--device", "cpu", "--threshold-sweep", "--ref", va["rttm"]]) == 0
    out = capsys.readouterr().out
    assert sum(ln.startswith("threshold ") for ln in out.splitlines()) == 18 and "best threshold" in out
    assert port_cli(["score", "--ref", va["rttm"], "--sys", f"{hyp}_0.50"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()[-1].split("/")) == 4


def test_cli_needs_target_audio_and_loads_the_encoder_into_both_sides(corpus, tmp_path):
    t = corpus["train"]
    with pytest.raises(SystemExit, match="--target-audio-dir"):
        port_cli(["train", "--family", "tsvad3", "--train-dir", t["data_dir"], "--emb-store", t["emb_store"],
                  "--exp-dir", str(tmp_path / "x"), "--device", "cpu"])
    camp = CAMPPlus(embedding_size=192, block_layers=(1, 1), block_dilations=(1, 2))
    convert_init = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in camp.parameters():
            p.copy_(torch.randn(p.shape, generator=convert_init) * 0.1)
    enc = str(tmp_path / "enc.npz")
    save_encoder(enc, SpkEmbedConfig(n_classes=1, feat_dim=80, encoder_blocks=(1, 1)), camp.state_dict())
    exp = str(tmp_path / "exp")
    assert port_cli(_train_argv(corpus, exp, ["--encoder-ckpt", enc, "--set", "num_steps=1", "--set",
                                              "schedule=const", "--set", "learning_rate=0"])) == 0
    with pytest.raises(SystemExit, match="--target-audio-dir"):
        port_cli(["infer", "--data-dir", t["data_dir"], "--exp-dir", exp, "--out", str(tmp_path / "o"),
                  "--device", "cpu"])
    sd = CheckpointManager(exp).restore()["model"]
    for name, t_ in camp.state_dict().items():
        if "running_" in name or "num_batches" in name:
            continue
        assert torch.equal(sd[f"speaker_encoder.{name}"], t_), name
        if not name.startswith("xvector.dense"):
            assert torch.equal(sd[f"speech_encoder.{name}"], t_), name
