"""Port parity of OTS-VAD: OTSVADModel (eval and train mode with the
BatchNorm statistics), its masked target embeddings and online step, the
loss on left and right halves and its gradients, the weight converters both
ways (the BiLSTM's gates), the online decode `ots_vad_infer_dataset` on a
seeded recording, and a port-only `train` → `infer --threshold-sweep` →
`score` chain, against the JAX package.

Tolerances: outputs 1e-4·max(1, max|ref|) in fp32; losses 1e-5 relative;
gradients 1e-4·max|ref grad| of each tensor. Where the comparison is of
gradients or of the online decode (whose slot rules threshold the
probabilities), the port reads JAX's fbank (its kaldi_fbank_auto patched):
the twin differs from it by ~1e-5, which can flip a ReLU of the ResNet34
trunk."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.data.kaldi_io import KaldiData as JKaldiData
from speaker_diarization_tpu.infer import ots_vad as JI
from speaker_diarization_tpu.models import ots_vad as JO
from speaker_diarization_tpu.ops import features as JFeat
from speaker_diarization_tpu.train import tasks as JT
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data import simulate
from speaker_diarization_tpu_torch.data.kaldi_io import KaldiData
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.infer.ots_vad import ots_vad_infer_dataset
from speaker_diarization_tpu_torch.models import ots_vad as O
from speaker_diarization_tpu_torch.ops import features as TF
from speaker_diarization_tpu_torch.train.tasks import make_ots_vad_loss
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

TINY = dict(num_speakers=3, d_model=16, conformer_layers=1, n_heads=2, d_ff=24, lstm_hidden=8, feat_dim=24,
            sample_rate=8000, encoder_m_channels=4, encoder_blocks=(1, 1, 1, 1), dropout=0.0)
RATE = 8000


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _fp32_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def _grads_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for k in want:
        scale = np.abs(want[k]).max()
        if scale < 1e-6 * top:
            assert np.abs(got[k]).max() < 1e-6 * top, k
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 * scale, err_msg=k)


def _jax_fbank(audio, sample_rate=16000, num_mel_bins=80, mean_norm=True):
    """JAX's kaldi_fbank_auto as the port's (the patch of the module docstring)."""
    fb = JFeat.kaldi_fbank_auto(jnp.asarray(audio.cpu().numpy()), sample_rate=sample_rate, num_mel_bins=num_mel_bins,
                                mean_norm=mean_norm)
    return torch.from_numpy(np.array(fb))


def _halves(seed=3, B=2):
    rng = np.random.default_rng(seed)
    left, right = ((0.1 * rng.standard_normal((B, RATE))).astype(np.float32) for _ in range(2))
    y = (rng.random((B, 3, 13)) < 0.4).astype(np.float32)
    y[1, 2] = 0.0  # a slot never active on the left: its target is the zero mean
    return left, right, y


@pytest.fixture(scope="module")
def pair():
    jm = JO.OTSVADModel(JO.OTSVADConfig(**TINY))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), *map(jnp.asarray, _halves()))
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    m = O.OTSVADModel(O.OTSVADConfig(**TINY), device="cpu")
    m.load_state_dict(convert.ots_vad_from_flax(v))
    return jm, v, m


def test_ots_vad_forward_matches_jax(pair):
    jm, v, m = pair
    left, right, y = _halves(seed=4)
    ref = jax.jit(jm.apply)(v, jnp.asarray(left), jnp.asarray(right), jnp.asarray(y))
    with torch.no_grad():
        got = m(torch.from_numpy(left), torch.from_numpy(right), torch.from_numpy(y))
    assert got.shape == ref.shape == (2, 3, 13)
    _fp32_close(got, ref)
    fb = np.random.default_rng(5).standard_normal((2, 100, 24)).astype(np.float32)
    ref = jax.jit(lambda a: jm.apply(v, a, method=jm.embed_frames))(jnp.asarray(fb))
    with torch.no_grad():
        _fp32_close(m.embed_frames(torch.from_numpy(fb)), ref)


def test_ots_vad_train_mode_and_statistics_match_jax(pair):
    jm, v, m = pair
    left, right, y = _halves(seed=6)
    ref, new = jax.jit(lambda *a: jm.apply(v, *a, True, mutable=["batch_stats"]))(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(y))
    m2 = O.OTSVADModel(m.cfg, device="cpu")
    m2.load_state_dict(m.state_dict())
    m2.train()
    _fp32_close(m2(torch.from_numpy(left), torch.from_numpy(right), torch.from_numpy(y)).detach(), ref)
    want = convert.ots_vad_from_flax({"params": v["params"], "batch_stats": jax.device_get(new["batch_stats"])})
    sd = m2.state_dict()
    for k, t in want.items():
        if "running_" in k:
            np.testing.assert_allclose(sd[k].numpy(), t.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_ots_vad_weights_round_trip(pair):
    _, v, m = pair
    back = convert.ots_vad_to_flax(m.state_dict(), num_heads=2)
    a, b = _flat(v), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    m2 = O.OTSVADModel(m.cfg, device="cpu", seed=5)
    m2.load_state_dict(convert.ots_vad_from_flax(back))
    for k, t in m.state_dict().items():
        assert torch.equal(t, m2.state_dict()[k]), k


def test_ots_vad_targets_and_online_step_match_jax(pair):
    """masked_target_embeddings (a slot with no activity → zeros), and two
    online steps from online_init, the accumulators carried."""
    jm, v, m = pair
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((2, 13, 16)).astype(np.float32)
    _, _, y = _halves(seed=7)
    want = JO.OTSVADModel.masked_target_embeddings(jnp.asarray(emb), jnp.asarray(y))
    got = O.OTSVADModel.masked_target_embeddings(torch.from_numpy(emb), torch.from_numpy(y))
    _fp32_close(got, want)
    assert (got[1, 2] == 0).all()
    jstate, state = jm.apply(v, 2, method=jm.online_init), m.online_init(2)
    jstep = jax.jit(lambda b, s: jm.apply(v, b, s, 0.5, method=jm.online_step))
    for seed in (8, 9):
        block = (0.1 * np.random.default_rng(seed).standard_normal((2, RATE))).astype(np.float32)
        jl, jstate = jstep(jnp.asarray(block), jstate)
        with torch.no_grad():
            pl, state = m.online_step(torch.from_numpy(block), state)
        _fp32_close(pl, jl)
        for k in ("sums", "counts"):
            _fp32_close(state[k], jstate[k])
    assert float(jnp.sum(jstate["counts"])) > 0


@pytest.mark.parametrize("train", [False, True])
def test_ots_vad_loss_and_gradients_match_jax(pair, train, monkeypatch):
    """The loss on a 2 s chunk (left and right halves, labels every other
    frame) against JAX's make_ots_vad_loss, and its gradients against
    jax.value_and_grad; the port reads JAX's fbank."""
    jm, v, m = pair
    rng = np.random.default_rng(10)
    batch = dict(audio=(0.1 * rng.standard_normal((2, 2 * RATE))).astype(np.float32),
                 labels=(rng.random((2, 50, 3)) < 0.4).astype(np.float32))
    mut = {"batch_stats": v["batch_stats"]}
    loss_fn = JT.make_ots_vad_loss(jm)
    (jloss, (jaux, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, mut, {k: jnp.asarray(a) for k, a in batch.items()}, jax.random.PRNGKey(0), train),
        has_aux=True))(v["params"])
    monkeypatch.setattr(TF, "kaldi_fbank_auto", _jax_fbank)
    m2 = O.OTSVADModel(m.cfg, device="cpu")
    m2.load_state_dict(m.state_dict())
    m2.train(train)
    loss, aux = make_ots_vad_loss()(m2, {k: torch.from_numpy(a) for k, a in batch.items()}, None, train)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux["frame_der"].item(), float(jaux["frame_der"]), rtol=1e-6)
    grads = {n: p.grad for n, p in m2.named_parameters()}
    _grads_close(_flat(convert.ots_vad_to_flax(grads, num_heads=2)["params"]), _flat(jgrads))


def test_ots_vad_infer_dataset_matches_jax(pair, tmp_path, monkeypatch):
    """Two seeded recordings (1 s blocks, 0.8 s shift) through both decoders.
    fc2's bias is pulled down to −3 on both sides, so the first slot goes
    quiet after the bootstrap and the new-speaker rule fires."""
    jm, v, m = pair
    v = jax.tree_util.tree_map(np.asarray, v)
    v["params"]["fc2"]["bias"] = np.full((1,), -3.0, np.float32)
    m = O.OTSVADModel(m.cfg, device="cpu")
    m.load_state_dict(convert.ots_vad_from_flax(v))
    c = write_synthetic_corpus(str(tmp_path / "c"), n_recs=2, seconds=6.0, rate=RATE, n_speakers=3, seed=11)
    want = JI.ots_vad_infer_dataset(jm, v, JKaldiData(c["data_dir"]), rate=RATE, rs_len=1.0)
    monkeypatch.setattr(TF, "kaldi_fbank_auto", _jax_fbank)
    got = ots_vad_infer_dataset(m, KaldiData(c["data_dir"]), rate=RATE, rs_len=1.0)
    assert got.keys() == want.keys()
    for rec in want:
        assert got[rec].shape == want[rec].shape == (150, 3)
        np.testing.assert_allclose(got[rec], want[rec], rtol=0, atol=1e-4, err_msg=rec)
    assert any((w[:, 1:] > 0).any() for w in want.values())  # the new-speaker rule fired


def test_cli_train_infer_score(tmp_path, capsys):
    """No embedding store: training reads 2·rs_len chunks with noise
    augmentation; inference names the slots spk1…spkS."""
    data = simulate.simulate_corpus(str(tmp_path / "c"), n_mixtures=2, n_speakers=3, rate=RATE, seed=1,
                                    src_speakers=4, utts_per_speaker=3)
    exp, hyp = str(tmp_path / "exp"), str(tmp_path / "hyp.rttm")
    model_sets = ["sample_rate=8000", "n_mels=24", "n_speakers=4", "rs_len=1.0", "encoder_blocks=1,1,1,1",
                  "d_model=16", "n_layers=2", "n_heads=2", "d_ff=24"]
    sets = model_sets + ["segment_shift=1.0", "batch_size=2", "num_steps=2", "log_every=1", "valid_every=2",
                         "optimizer=adam", "schedule=poly", "learning_rate=2e-4", "warmup_steps=1"]
    argv = ["train", "--family", "ots_vad", "--train-dir", data, "--valid-dir", data, "--exp-dir", exp,
            "--noise-dir", str(tmp_path / "c" / "noise"), "--device", "cpu"]
    assert port_cli(argv + [a for kv in sets for a in ("--set", kv)]) == 0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if r["kind"] == "train"] == [1, 2] and any(r["kind"] == "valid" for r in recs)
    assert all(np.isfinite(r["loss"]) for r in recs)
    capsys.readouterr()
    assert port_cli(["infer", "--data-dir", data, "--exp-dir", exp, "--out", hyp, "--device", "cpu",
                     "--threshold-sweep", "--ref", os.path.join(data, "rttm")]) == 0
    out = capsys.readouterr().out
    assert sum(ln.startswith("threshold ") for ln in out.splitlines()) == 18 and "best threshold" in out
    with open(f"{hyp}_0.20") as f:
        assert {ln.split()[7] for ln in f} <= {"spk1", "spk2", "spk3", "spk4"}
    assert port_cli(["score", "--ref", os.path.join(data, "rttm"), "--sys", f"{hyp}_0.50"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(line.split("/")) == 4


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        O.OTSVADModel(O.OTSVADConfig(**TINY))
    assert O.OTSVADModel(O.OTSVADConfig(**TINY), device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["train", "--family", "ots_vad", "--train-dir", str(tmp_path), "--exp-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["infer", "--family", "ots_vad", "--data-dir", str(tmp_path), "--exp-dir", str(tmp_path),
                  "--out", "o"])


def test_jax_cli_slot_count_fault_is_pinned(tmp_path):
    """A fault of the JAX reference, kept out of the port: the JAX CLI builds
    OTS-VAD with n_speakers slots (3 here, as `--set n_speakers=3` gives) but
    its TSVADChunkDataset at the default 4 label columns, so its loss cannot
    broadcast the 4 left-half targets against 3 slots. The port's dataset
    takes the model's slot count."""
    from speaker_diarization_tpu.data.tsvad_dataset import TSVADChunkDataset as JDataset
    from speaker_diarization_tpu_torch.cli.main import TrainCliConfig, _slots, build_model
    from speaker_diarization_tpu_torch.data.tsvad_dataset import TSVADChunkDataset

    c = write_synthetic_corpus(str(tmp_path / "c"), n_recs=1, seconds=6.0, rate=RATE, n_speakers=3, seed=12)
    item = JDataset(c["data_dir"], None, rs_len=2.0, segment_shift=1.0, rate=RATE, is_train=True)[0]
    assert item["labels"].shape == (50, 4)
    jm = JO.OTSVADModel(JO.OTSVADConfig(**TINY))  # num_speakers 3
    batch = {"audio": jnp.asarray(item["audio"][None]), "labels": jnp.asarray(item["labels"][None])}
    y0 = jnp.zeros((1, 3, 12))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), batch["audio"][:, :RATE], batch["audio"][:, RATE:], y0)
    with pytest.raises((TypeError, ValueError)):
        JT.make_ots_vad_loss(jm)(v["params"], {"batch_stats": v["batch_stats"]}, batch, jax.random.PRNGKey(0), False)
    cfg = TrainCliConfig(family="ots_vad", n_speakers=3, d_model=16, n_layers=2, n_heads=2, d_ff=24, n_mels=24,
                         encoder_blocks="1,1,1,1")
    model = build_model(cfg, "cpu")
    ds = TSVADChunkDataset(c["data_dir"], None, rs_len=2.0, segment_shift=1.0, rate=RATE, is_train=True,
                           max_speakers=_slots(model))
    b = {k: torch.from_numpy(ds[0][k][None]) for k in ("audio", "labels")}
    loss, _ = make_ots_vad_loss()(model, b, None, False)
    assert _slots(model) == 3 and b["labels"].shape == (1, 50, 3) and torch.isfinite(loss)
