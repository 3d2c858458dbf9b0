"""Port parity of the neural VAD: NeuralVAD with JAX weights carried across
(and back), its causality, `neural_sad`, the copied label and timestamp
helpers, `make_vad_loss` and three trainer steps, the npz format and the
JAX package's msgpack file (read bit for bit), and the CLI's `train --family
vad` → `export-vad` → `cluster --sad neural` held to the JAX CLI's cluster
on the same weights, against the JAX package.

Tolerances: outputs 1e-4·max(1, max|ref|) in fp32; losses 1e-5 relative;
weights after three sgd steps 1e-5 absolute; segment times 1e-9."""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.cli import main as JCLI
from speaker_diarization_tpu.models import vad as JV
from speaker_diarization_tpu.train import tasks as JT
from speaker_diarization_tpu.train.trainer import Trainer as JTrainer
from speaker_diarization_tpu.train.trainer import TrainerConfig as JTrainerConfig
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data import simulate
from speaker_diarization_tpu_torch.data.rttm import read_rttm
from speaker_diarization_tpu_torch.models import vad as V
from speaker_diarization_tpu_torch.train.tasks import make_vad_loss
from speaker_diarization_tpu_torch.train.trainer import Trainer, TrainerConfig
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

TINY = dict(sample_rate=8000, frame_size=200, frame_shift=80, n_mels=16, conv_channels=(8,), conv_kernel=5,
            lstm_hidden=12)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _fp32_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=1e-4 * max(1.0, float(np.abs(ref).max())))


@pytest.fixture(scope="module")
def pair():
    jm = JV.NeuralVAD(cfg=JV.NeuralVADConfig(**TINY))
    audio = (0.1 * np.random.default_rng(0).standard_normal((2, 12000))).astype(np.float32)
    v = _np(jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(audio)))
    model = V.NeuralVAD(V.NeuralVADConfig(**TINY), device="cpu")
    model.load_state_dict(convert.vad_from_flax(v))
    return jm, v, model, audio


def test_vad_forward_matches_jax(pair):
    jm, v, model, audio = pair
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(audio)))
    with torch.no_grad():
        got = model(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (2, 150)
    _fp32_close(got, want)


def test_vad_weights_round_trip(pair):
    jm, v, model, _ = pair
    back = convert.vad_to_flax(model.state_dict())
    want = _flat(v)
    got = _flat(back)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_vad_is_causal(pair):
    """A change at sample n leaves every frame whose window ends before n
    bitwise equal; the frame that holds n changes."""
    _, _, model, audio = pair
    n = 6000
    moved = audio.copy()
    moved[:, n] += 0.5
    with torch.no_grad():
        a, b = model(torch.from_numpy(audio)), model(torch.from_numpy(moved))
    first = (n - 256 // 2) // 80 + 1  # frames are centred: frame t spans [80 t − 128, 80 t + 128)
    assert torch.equal(a[:, :first], b[:, :first])
    assert not torch.equal(a[:, first:], b[:, first:])


def test_label_and_timestamp_helpers_match_jax():
    sad = [(0.12, 0.9), (1.5, 1.51), (2.0, 3.3)]
    assert np.array_equal(V.make_vad_labels(sad, 400, 0.01), JV.make_vad_labels(sad, 400, 0.01))
    rng = np.random.default_rng(1)
    probs = np.clip(np.repeat(rng.random(60), 8) + 0.1 * rng.standard_normal(480), 0, 1)
    for th in (0.3, 0.5, 0.7):
        assert V.get_speech_timestamps(probs, 0.01, threshold=th) == JV.get_speech_timestamps(probs, 0.01,
                                                                                               threshold=th)


def test_neural_sad_matches_jax(pair):
    """Chunks of 0.5 s, the last zero-padded, run by both sides; the head
    scaled, and the threshold taken where no frame's probability lies within
    1e-3 of it or of its release level 0.15 below (the two sides' ~1e-6
    differences then cannot move a segment)."""
    jm, v, model, _ = pair
    rng = np.random.default_rng(2)
    gate = np.repeat(rng.random(13) < 0.5, 1000)
    audio = (0.002 * rng.standard_normal(13000) + 0.1 * gate * np.sin(np.arange(13000) * 0.2)).astype(np.float32)
    rows = torch.from_numpy(np.pad(audio, (0, 3000)).reshape(4, 4000))
    with torch.no_grad():
        lo = model(rows).numpy().reshape(-1)[:163]
    # logit' = c·(logit − median): the frames spread over ±5 between the deciles
    p10, med, p90 = np.percentile(lo, [10, 50, 90])
    c = 10.0 / (p90 - p10)
    v = jax.tree_util.tree_map(lambda x: x, v)
    head = v["params"]["Dense_0"]
    head["kernel"], head["bias"] = head["kernel"] * c, (head["bias"] - med) * c
    model.load_state_dict(convert.vad_from_flax(v))
    with torch.no_grad():
        probs = torch.sigmoid(model(rows)).numpy().reshape(-1)[:163]
    gaps = {th: min(np.abs(probs - th).min(), np.abs(probs - max(th - 0.15, 0.01)).min())
            for th in np.round(np.arange(0.2, 0.81, 0.01), 2)}
    th = max((t for t in gaps if (probs >= t).any() and (probs < t - 0.15).any()), key=gaps.get)
    assert gaps[th] > 1e-3, gaps[th]
    want = JV.neural_sad(audio, 8000, jm, v, threshold=th, chunk_s=0.5)
    got = V.neural_sad(audio, 8000, model, threshold=th, chunk_s=0.5)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-9)


def _batches(seed=4, B=2, T=100):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        mask = np.ones((B, T), np.float32)
        mask[1, 70:] = 0.0
        out.append(dict(audio=(0.1 * rng.standard_normal((B, T * 80))).astype(np.float32),
                        labels=(rng.random((B, T, 2)) < 0.3).astype(np.float32), frame_mask=mask))
    return out


def test_vad_loss_and_trainer_steps_match_jax(pair):
    jm, v0, _, _ = pair
    batches = _batches()
    jloss = JT.make_vad_loss(jm)
    want, jaux = jax.jit(jloss, static_argnums=(2, 3))(v0, {k: jnp.asarray(a) for k, a in batches[0].items()}, None,
                                                        False)
    model = V.NeuralVAD(V.NeuralVADConfig(**TINY), device="cpu")
    model.load_state_dict(convert.vad_from_flax(v0))
    got, aux = make_vad_loss()(model, {k: torch.from_numpy(a) for k, a in batches[0].items()}, None, False)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(aux["vad_acc"].item(), float(jaux["vad_acc"]), rtol=1e-6)
    kw = dict(optimizer="sgd", schedule="const", learning_rate=0.5, grad_clip_norm=None)
    jtrainer = JTrainer(jloss, JTrainerConfig(**kw))
    state = jtrainer.init_state(v0)
    trainer = Trainer(model, make_vad_loss(), TrainerConfig(**kw))
    for b in batches:
        state, jaux = jtrainer.train_step(state, {k: jnp.asarray(a) for k, a in b.items()})
        aux = trainer.train_step({k: torch.from_numpy(a) for k, a in b.items()})
        np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]), rtol=1e-5)
    got, want = _flat(convert.vad_to_flax(model.state_dict())), _flat(state.params)
    moved = _flat(v0)
    for k in want:
        assert np.abs(want[k] - moved[k]).max() > 1e-6, k  # every weight trained
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


def test_vad_npz_round_trip_and_msgpack_refusal(pair, tmp_path):
    """The npz both ways; the JAX package's msgpack file reads to the
    weights vad_from_flax gives (the same forward, bit for bit); bytes that
    are neither are refused, saying what they hold."""
    _, v, model, audio = pair
    path = str(tmp_path / "vad.npz")
    V.save_vad_params(path, model)
    other = V.load_vad_params(path, V.NeuralVAD(V.NeuralVADConfig(**TINY), device="cpu", seed=9))
    with torch.no_grad():
        assert torch.equal(other(torch.from_numpy(audio)), model(torch.from_numpy(audio)))
    jpath = str(tmp_path / "vad.msgpack")
    JV.save_vad_params(jpath, v)  # the JAX package's writer: flax msgpack
    from_jax = V.load_vad_params(jpath, V.NeuralVAD(V.NeuralVADConfig(**TINY), device="cpu", seed=9))
    converted = V.NeuralVAD(V.NeuralVADConfig(**TINY), device="cpu", seed=8)
    converted.load_state_dict(convert.vad_from_flax(v))
    with torch.no_grad():
        assert torch.equal(from_jax(torch.from_numpy(audio)), converted(torch.from_numpy(audio)))
    bad = str(tmp_path / "vad.bin")
    with open(bad, "wb") as f:
        f.write(b"\xc1not a checkpoint")
    with pytest.raises(ValueError, match="neither an npz nor a flax msgpack file.*c1 6e 6f 74"):
        V.load_vad_params(bad, model)


def test_cli_train_export_then_cluster_neural_matches_jax_cluster(tmp_path, capsys):
    """`train --family vad` (subsampling forced to 1, 2 steps) → `export-vad`
    → `cluster --sad neural`; the JAX CLI's cluster, given the same weights
    as its msgpack, writes the same turns, and so does the port's given that
    msgpack."""
    root = str(tmp_path)
    data = simulate.simulate_corpus(os.path.join(root, "c"), n_mixtures=2, n_speakers=2, rate=8000, seed=3,
                                    src_speakers=4, utts_per_speaker=3)
    exp = os.path.join(root, "vad")
    sets = ["sample_rate=8000", "chunk_frames=150", "batch_size=2", "num_steps=2", "log_every=1", "valid_every=2",
            "optimizer=adam", "schedule=poly", "learning_rate=1e-3", "warmup_steps=1"]
    assert port_cli(["train", "--family", "vad", "--train-dir", data, "--exp-dir", exp,
                     "--device", "cpu"] + [a for kv in sets for a in ("--set", kv)]) == 0
    import json

    with open(os.path.join(exp, "train_config.json")) as f:
        assert json.load(f)["subsampling"] == 1
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    trains = [r for r in recs if r["kind"] == "train"]
    assert [r["step"] for r in trains] == [1, 2] and all("vad_acc" in r for r in trains)
    npz = os.path.join(root, "vad.npz")
    assert port_cli(["export-vad", "--exp-dir", exp, "--out", npz]) == 0
    variables = convert.load_flax_npz(npz)
    # a VAD of two steps sits near 0.5: move its bias so that it finds speech
    # and silence, the same weights on both sides
    w = variables["params"]["Dense_0"]
    w["kernel"] = w["kernel"] * 50.0
    vm = V.load_vad_params(npz, V.NeuralVAD(V.NeuralVADConfig(sample_rate=8000, frame_size=200, frame_shift=80),
                                             device="cpu"))
    vm.load_state_dict(convert.vad_from_flax(variables))
    from speaker_diarization_tpu_torch.data.kaldi_io import KaldiData

    kd = KaldiData(data)
    with torch.no_grad():
        lo = torch.cat([vm(torch.from_numpy(kd.load_wav(r)[0][None].astype(np.float32)))[0] for r in sorted(kd.wavs)])
    w["bias"] = w["bias"] - float(lo.median())
    convert.save_flax_npz(npz, variables)
    jm = JV.NeuralVAD(cfg=JV.NeuralVADConfig(sample_rate=8000, frame_size=200, frame_shift=80))
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8000), jnp.float32))
    msg = os.path.join(root, "vad.msgpack")
    with open(msg, "wb") as f:
        f.write(flax.serialization.to_bytes(jax.tree_util.tree_map(
            lambda t, x: jnp.asarray(x, t.dtype), template, variables)))
    common = ["--data-dir", data, "--sad", "neural", "--encoder", "spectrum", "--rate", "8000", "--num-spks", "2"]
    assert port_cli(["cluster", "--out", f"{root}/hyp.rttm", "--vad-ckpt", npz, "--device", "cpu"] + common) == 0
    ja = JCLI.build_parser().parse_args(["cluster", "--out", f"{root}/jhyp.rttm", "--vad-ckpt", msg] + common)
    assert ja.fn(ja) == 0
    got, want = read_rttm(f"{root}/hyp.rttm"), read_rttm(f"{root}/jhyp.rttm")
    assert got and [(t.rec, round(t.start, 6), round(t.dur, 6)) for t in got] == \
        [(t.rec, round(t.start, 6), round(t.dur, 6)) for t in want]
    # the port's cluster reads the JAX msgpack as well, to the same turns
    assert port_cli(["cluster", "--out", f"{root}/mhyp.rttm", "--vad-ckpt", msg, "--device", "cpu"] + common) == 0
    assert [(t.rec, t.start, t.dur) for t in read_rttm(f"{root}/mhyp.rttm")] == [(t.rec, t.start, t.dur) for t in got]


def test_vad_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.NeuralVAD(V.NeuralVADConfig(**TINY))
    assert V.NeuralVAD(V.NeuralVADConfig(**TINY), device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["train", "--family", "vad", "--train-dir", str(tmp_path), "--exp-dir", str(tmp_path)])
