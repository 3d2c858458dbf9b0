"""Port parity of the learned enhancer and the enhancement hooks: stft /
istft, MaskDenoiser (both GRU directions) with JAX weights carried across
and back, si_snr, make_enhance_loss and three trainer steps, the enhancer
npz and the JAX package's (read bit for bit), `neural_enhancer_fn`, the port's
copy of data/enhance.py (spectral_gate_denoise, noisy_pair_batches,
enhance_corpus), the TS-VAD dataset's enhancer hooks (the same items, so
the same order of rng draws, at eval, in training with enhance_prob 0.5 and
with enhanced_audio_dir), and the CLI's `train --family enhance` →
`export-enhancer` → `infer --family tsvad --set enhancer=neural:…`, against
the JAX package.

Tolerances: the STFT 1e-5·max|X|; its round trip 1e-5; outputs
1e-4·max(1, max|ref|) in fp32; losses 1e-5 relative; weights after three
sgd steps 1e-5 absolute; the data copies bitwise."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.data import enhance as JE
from speaker_diarization_tpu.data.tsvad_dataset import TSVADChunkDataset as JDataset
from speaker_diarization_tpu.infer.embeddings import EmbeddingStore as JStore
from speaker_diarization_tpu.models import enhancer as JM
from speaker_diarization_tpu.train.trainer import Trainer as JTrainer
from speaker_diarization_tpu.train.trainer import TrainerConfig as JTrainerConfig
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data import enhance as E
from speaker_diarization_tpu_torch.data import simulate
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.data.tsvad_dataset import TSVADChunkDataset
from speaker_diarization_tpu_torch.data.wav import read_wav
from speaker_diarization_tpu_torch.infer.embeddings import EmbeddingStore
from speaker_diarization_tpu_torch.models import enhancer as M
from speaker_diarization_tpu_torch.train.trainer import Trainer, TrainerConfig
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

TINY = dict(n_fft=64, hop=16, hidden=8, conv_channels=8, n_convs=1)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _fp32_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=1e-4 * max(1.0, float(np.abs(ref).max())))


@pytest.fixture(scope="module")
def pair():
    jm = JM.MaskDenoiser(cfg=JM.EnhancerConfig(**TINY))
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal((2, 3000))).astype(np.float32)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(audio)))
    model = M.MaskDenoiser(M.EnhancerConfig(**TINY), device="cpu")
    model.load_state_dict(convert.enhancer_from_flax(v))
    return jm, v, model, audio


def test_stft_istft_match_jax_and_round_trip():
    x = (0.1 * np.random.default_rng(1).standard_normal((2, 4000))).astype(np.float32)
    for n_fft, hop in ((512, 128), (60, 25)):  # hop dividing n_fft or not
        want = np.asarray(JM.stft(jnp.asarray(x), n_fft, hop))
        got = M.stft(torch.from_numpy(x), n_fft, hop)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
        y = M.istft(got, n_fft, hop, 4000)
        _fp32_close(y.numpy(), np.asarray(JM.istft(jnp.asarray(want), n_fft, hop, 4000)))
        np.testing.assert_allclose(y.numpy(), x, rtol=0, atol=1e-5)


def test_mask_denoiser_matches_jax(pair):
    jm, v, model, audio = pair
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(audio)))
    with torch.no_grad():
        got = model(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == audio.shape
    _fp32_close(got, want)
    # the backward GRU reads the future: a change late in the clip moves the
    # early output, in both packages alike
    late = audio.copy()
    late[:, 800:] += 0.3
    with torch.no_grad():
        moved = model(torch.from_numpy(late)).numpy()
    assert np.abs(moved[:, :600] - got[:, :600]).max() > 1e-6
    _fp32_close(moved, np.asarray(jax.jit(jm.apply)(v, jnp.asarray(late))))


def test_enhancer_weights_round_trip(pair):
    _, v, model, _ = pair
    got, want = _flat(convert.enhancer_to_flax(model.state_dict())), _flat(v)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_si_snr_loss_and_trainer_steps_match_jax(pair):
    jm, v0, _, _ = pair
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(3):
        clean = (0.1 * np.sin(np.cumsum(rng.uniform(0.05, 0.3, (2, 3000)), axis=1))).astype(np.float32)
        batches.append(dict(clean=clean, noisy=(clean + 0.05 * rng.standard_normal((2, 3000))).astype(np.float32)))
    b = batches[0]
    np.testing.assert_allclose(M.si_snr(torch.from_numpy(b["noisy"]), torch.from_numpy(b["clean"])).numpy(),
                               np.asarray(JM.si_snr(jnp.asarray(b["noisy"]), jnp.asarray(b["clean"]))), rtol=1e-5)
    model = M.MaskDenoiser(M.EnhancerConfig(**TINY), device="cpu")
    model.load_state_dict(convert.enhancer_from_flax(v0))
    jloss = JM.make_enhance_loss(jm)
    want, _ = jax.jit(jloss, static_argnums=(2, 3))(v0, {k: jnp.asarray(a) for k, a in b.items()}, None, False)
    got, aux = M.make_enhance_loss()(model, {k: torch.from_numpy(a) for k, a in b.items()}, None, False)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    kw = dict(optimizer="sgd", schedule="const", learning_rate=0.05, grad_clip_norm=None)
    jtrainer = JTrainer(jloss, JTrainerConfig(**kw))
    state = jtrainer.init_state(v0)
    trainer = Trainer(model, M.make_enhance_loss(), TrainerConfig(**kw))
    for b in batches:
        state, jaux = jtrainer.train_step(state, {k: jnp.asarray(a) for k, a in b.items()})
        aux = trainer.train_step({k: torch.from_numpy(a) for k, a in b.items()})
        np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]), rtol=1e-5)
    got, want, start = _flat(convert.enhancer_to_flax(model.state_dict())), _flat(state.params), _flat(v0)
    for k in want:
        assert np.abs(want[k] - start[k]).max() > 1e-7, k  # every weight trained
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


def test_enhancer_npz_and_neural_enhancer_fn_match_jax(pair, tmp_path):
    jm, v, model, audio = pair
    path, jpath = str(tmp_path / "enh.npz"), str(tmp_path / "jax_enh.npz")
    M.save_enhancer(path, model)
    JM.save_enhancer(jpath, v, JM.EnhancerConfig(**TINY))
    with np.load(path) as z:
        assert all(int(z[k]) == TINY[k] for k in M.CONFIG_KEYS)
    # the JAX package's npz (flax msgpack bytes under 'params') reads too, to
    # the weights enhancer_from_flax gives: the same forward, bit for bit
    from_jax = M.load_enhancer(jpath, "cpu")
    converted = M.MaskDenoiser(M.EnhancerConfig(**TINY), device="cpu", seed=5)
    converted.load_state_dict(convert.enhancer_from_flax(v))
    with torch.no_grad():
        assert torch.equal(from_jax(torch.from_numpy(audio)), converted(torch.from_numpy(audio)))
    got = M.neural_enhancer_fn(path, "cpu")(audio[0], 8000)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(audio[:1])))[0]  # what JAX's neural_enhancer_fn computes
    assert got.dtype == np.float32 and got.shape == audio[0].shape
    _fp32_close(got, want)
    assert np.array_equal(E.get_enhancer(f"neural:{path}", "cpu")(audio[0], 8000), got)


# ---------------------------------------------------------------------------
# data/enhance.py and the dataset hooks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("enh_corpus"))
    c = write_synthetic_corpus(os.path.join(d, "c"), n_recs=2, seconds=8.0, rate=8000, n_speakers=2, emb_dim=16,
                               seed=5)
    c["noise"] = simulate.synthesize_noise_corpus(os.path.join(d, "noise"), n_noises=2, dur=3.0, seed=6)
    c["src"] = simulate.synthesize_speaker_corpus(os.path.join(d, "src"), n_speakers=2, utts_per_speaker=2, seed=7)
    c["root"] = d
    return c


def test_enhance_copies_match_jax(corpus):
    x = (0.1 * np.random.default_rng(3).standard_normal(5000)).astype(np.float32)
    assert np.array_equal(E.spectral_gate_denoise(x, 8000), JE.spectral_gate_denoise(x, 8000))
    a = E.noisy_pair_batches(corpus["src"], corpus["noise"], 8000, dur_s=0.5, batch_size=3, seed=4)
    b = JE.noisy_pair_batches(corpus["src"], corpus["noise"], 8000, dur_s=0.5, batch_size=3, seed=4)
    for _ in range(3):
        x, y = next(a), next(b)
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
    out, jout = os.path.join(corpus["root"], "enh"), os.path.join(corpus["root"], "jenh")
    E.enhance_corpus(corpus["data_dir"], out)
    JE.enhance_corpus(corpus["data_dir"], jout)
    for rec in ("rec00", "rec01"):
        assert np.array_equal(read_wav(os.path.join(out, "wav", f"{rec}.wav"))[0],
                              read_wav(os.path.join(jout, "wav", f"{rec}.wav"))[0])


@pytest.mark.parametrize("mode", ["eval", "train", "offline"])
def test_dataset_enhancer_hooks_match_jax(corpus, mode):
    """The same items as JAX's dataset: the online spectral gate always at
    eval and at enhance_prob 0.5 in training (with noise augmentation, so
    every rng draw is exercised), and the offline substitution from an
    enhanced copy."""
    kw = dict(rs_len=2.0, segment_shift=1.0, rate=8000)
    if mode == "offline":
        enh = os.path.join(corpus["root"], "offline")
        E.enhance_corpus(corpus["data_dir"], enh)
        kw.update(enhanced_audio_dir=enh, enhance_prob=0.5, is_train=True, seed=3)
    elif mode == "train":
        kw.update(enhancer="spectral_gate", enhance_prob=0.5, is_train=True, seed=2, noise_dir=corpus["noise"],
                  aug_prob=0.7)
    else:
        kw.update(enhancer="spectral_gate", is_train=False)
    a = TSVADChunkDataset(corpus["data_dir"], EmbeddingStore.load(corpus["emb_store"]), **kw)
    b = JDataset(corpus["data_dir"], JStore.load(corpus["emb_store"]), **kw)
    plain = TSVADChunkDataset(corpus["data_dir"], EmbeddingStore.load(corpus["emb_store"]), rs_len=2.0,
                              segment_shift=1.0, rate=8000)
    assert len(a) == len(b) > 4
    changed = 0
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], np.ndarray):
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{mode} item {i} {k}")
            else:
                assert x[k] == y[k], k
        changed += not np.array_equal(x["audio"], plain[i]["audio"])
    if mode == "eval":
        assert changed == len(a)
    elif mode == "train":
        assert 0 < changed < len(a)
    else:
        assert changed > 0


def test_cli_train_export_then_enhanced_tsvad_infer(corpus, tmp_path, capsys):
    """`train --family enhance` (2 steps) → `export-enhancer` → `infer
    --family tsvad --set enhancer=neural:… --set enhance_prob=1.0` from a
    TS-VAD run; each chunk the dataset reads is the enhancer's output."""
    from speaker_diarization_tpu_torch.cli.main import TRAIN_CONFIG, TrainCliConfig, build_model
    from speaker_diarization_tpu_torch.train.checkpoints import CheckpointManager
    from speaker_diarization_tpu_torch.train.tasks import make_tsvad_loss

    root = str(tmp_path)
    sets = ["sample_rate=8000", "batch_size=2", "num_steps=2", "log_every=1", "optimizer=adam", "schedule=poly",
            "learning_rate=1e-3", "warmup_steps=1", "spk_dur=0.5", "bf16=true"]
    exp = os.path.join(root, "enh")
    assert port_cli(["train", "--family", "enhance", "--train-dir", corpus["src"], "--noise-dir", corpus["noise"],
                     "--exp-dir", exp, "--device", "cpu"] + [a for kv in sets for a in ("--set", kv)]) == 0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2] and all(np.isfinite(r["si_snr"]) for r in recs)
    npz = os.path.join(root, "enhancer.npz")
    assert port_cli(["export-enhancer", "--exp-dir", exp, "--out", npz]) == 0
    with pytest.raises(SystemExit, match="export-enhancer"):
        port_cli(["infer", "--data-dir", corpus["data_dir"], "--exp-dir", exp, "--out", "o", "--device", "cpu"])
    # a TS-VAD run (untrained weights, one checkpoint) to infer from
    cfg = TrainCliConfig(family="tsvad", sample_rate=8000, encoder_blocks="1,1", n_layers=1, d_ff=32, n_mels=80)
    model = build_model(cfg, torch.device("cpu"))
    ts_exp = os.path.join(root, "tsvad")
    CheckpointManager(ts_exp).save(Trainer(model, make_tsvad_loss(100), TrainerConfig()))
    with open(os.path.join(ts_exp, TRAIN_CONFIG), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    store = os.path.join(root, "embs.npz")
    emb = EmbeddingStore.load(corpus["emb_store"])
    big = EmbeddingStore()
    for rec, spks in emb.speakers().items():
        for spk in spks:
            big.put(rec, spk, np.tile(emb.get(rec, spk), (1, 12)))  # the 192-d embeddings TSVADConfig() reads
    big.save(store)
    argv = ["infer", "--family", "tsvad", "--data-dir", corpus["data_dir"], "--exp-dir", ts_exp, "--emb-store", store,
            "--device", "cpu", "--threshold-sweep", "--ref", corpus["rttm"]]
    assert port_cli(argv + ["--out", os.path.join(root, "enh.rttm"), "--set", f"enhancer=neural:{npz}",
                            "--set", "enhance_prob=1.0"]) == 0
    assert "best threshold" in capsys.readouterr().out
    assert sum(fn.startswith("enh.rttm_") for fn in os.listdir(root)) == 18
    fn = M.neural_enhancer_fn(npz, "cpu")
    ds = TSVADChunkDataset(corpus["data_dir"], big, rate=8000, enhancer=fn)
    raw = TSVADChunkDataset(corpus["data_dir"], big, rate=8000)
    np.testing.assert_array_equal(ds[0]["audio"], fn(raw[0]["audio"], 8000))


def test_enhancer_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.MaskDenoiser(M.EnhancerConfig(**TINY))
    assert M.MaskDenoiser(M.EnhancerConfig(**TINY), device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["train", "--family", "enhance", "--train-dir", str(tmp_path), "--exp-dir", str(tmp_path)])
