"""Port parity of SSND: SSNDModel (eval and train mode with the BatchNorm
statistics, from audio and from fbank), ArcFace logits, the speaker lookup,
the loss on the deterministic `aux_embs` batch and its gradients, the
weight converters both ways, the query construction of the training batch,
the port's copy of infer/ssnd_online.py against the JAX module (online and
offline rescoring, with the JAX model's predictor and with the port's), and
a port-only `train` → `infer --threshold-sweep --ssnd-rescore` → `score`
chain, against the JAX package.

Tolerances: outputs 1e-4·max(1, max|ref|) in fp32; losses 1e-5 relative;
gradients 1e-4·max|ref grad| of each tensor. The JAX SSNDModel builds its
ConformerEncoder at dropout 0.1 with no way to set it; train-mode
comparisons rebuild it at 0 (`_jax_conformer_dropout_0`, around the JAX
calls only) and the port's model is built with dropout=0.0."""

import contextlib
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.infer import ssnd_online as JO
from speaker_diarization_tpu.models import ssnd as JS
from speaker_diarization_tpu.train import tasks as JT
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data import simulate
from speaker_diarization_tpu_torch.infer import ssnd_online as PO
from speaker_diarization_tpu_torch.models import ssnd as S
from speaker_diarization_tpu_torch.ops import features as TF
from speaker_diarization_tpu_torch.train.tasks import make_ssnd_loss
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

TINY = dict(feat_dim=24, emb_dim=16, d_model=32, n_heads=2, d_ff=48, num_layers=1, max_speakers=3, vad_out_len=20,
            pos_emb_dim=8, max_seq_len=60, n_all_speakers=7, sample_rate=8000, extractor_blocks=(1, 1))
RATE, N = 8000, 6400  # 0.8 s blocks: 80 fbank frames, 40 extractor frames, vad_out_len 20


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturb(variables, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + scale * rng.standard_normal(a.shape).astype(np.float32), variables)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])  # positive variances
    return v


def _fp32_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def _grads_close(got: dict, want: dict):
    """1e-4·max|ref grad| per tensor; a tensor whose exact gradient is zero
    (rounding noise on both sides) stays below 1e-6 of the largest one."""
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for k in want:
        scale = np.abs(want[k]).max()
        if scale < 1e-6 * top:
            assert np.abs(got[k]).max() < 1e-6 * top, k
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 * scale, err_msg=k)


@contextlib.contextmanager
def _jax_conformer_dropout_0():
    """The JAX SSNDModel's ConformerEncoder at dropout 0 while the block runs
    (its setup looks the class up on every init/apply)."""
    orig = JS.ConformerEncoder
    JS.ConformerEncoder = functools.partial(orig, dropout=0.0)
    try:
        yield
    finally:
        JS.ConformerEncoder = orig


def _inputs(seed=3, B=2):
    rng = np.random.default_rng(seed)
    audio = (0.1 * rng.standard_normal((B, N))).astype(np.float32)
    aux = rng.standard_normal((B, 3, 16)).astype(np.float32)
    aux[1, 2] = 0.0  # an all-zero query row stays finite through l2_normalize
    return audio, aux


@pytest.fixture(scope="module")
def pair():
    jm = JS.SSNDModel(JS.SSNDConfig(**TINY))
    audio, aux = _inputs()
    v = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(audio), jnp.asarray(aux)), 1)
    m = S.SSNDModel(S.SSNDConfig(**TINY), device="cpu", dropout=0.0)
    m.load_state_dict(convert.ssnd_from_flax(v))
    return jm, v, m


def test_ssnd_eval_forward_matches_jax(pair):
    """From raw audio (the port's fbank twin against JAX's kaldi_fbank_auto)
    and from a given fbank."""
    jm, v, m = pair
    audio, aux = _inputs()
    ref = jax.jit(jm.apply)(v, jnp.asarray(audio), jnp.asarray(aux))
    with torch.no_grad():
        got = m(torch.from_numpy(audio), torch.from_numpy(aux))
    assert got[0].shape == ref[0].shape == (2, 3, 20) and got[1].shape == ref[1].shape == (2, 3, 16)
    for g, r in zip(got, ref):
        _fp32_close(g, r)
    fb = np.random.default_rng(5).standard_normal((2, 80, 24)).astype(np.float32)
    ref = jax.jit(jm.apply)(v, jnp.asarray(fb), jnp.asarray(aux))
    with torch.no_grad():
        got = m(torch.from_numpy(fb), torch.from_numpy(aux))
    for g, r in zip(got, ref):
        _fp32_close(g, r)


def test_ssnd_teacher_forced_and_parts_match_jax(pair):
    """The representation decoder on given VAD labels, the speaker lookup
    (pseudo speaker for gid −1) and the ArcFace logits."""
    jm, v, m = pair
    audio, aux = _inputs(seed=4)
    labels = (np.random.default_rng(6).random((2, 3, 20)) < 0.4).astype(np.float32)
    ref = jax.jit(lambda *a: jm.apply(v, *a[:2], vad_labels=a[2]))(*map(jnp.asarray, (audio, aux, labels)))
    with torch.no_grad():
        got = m(torch.from_numpy(audio), torch.from_numpy(aux), vad_labels=torch.from_numpy(labels))
    for g, r in zip(got, ref):
        _fp32_close(g, r)
    gids = np.array([[0, 6, -1], [-1, 3, 2]], np.int32)
    ref = jm.apply(v, jnp.asarray(gids), method=jm.lookup_speaker_embs)
    np.testing.assert_array_equal(m.lookup_speaker_embs(torch.from_numpy(gids)).detach().numpy(), np.asarray(ref))
    emb = np.random.default_rng(7).standard_normal((6, 16)).astype(np.float32)
    lab = np.array([0, 1, 6, 3, 3, 5], np.int32)
    ref = jax.jit(lambda e, l: jm.apply(v, e, l, method=jm.arcface_logits))(jnp.asarray(emb), jnp.asarray(lab))
    with torch.no_grad():
        _fp32_close(m.arcface_logits(torch.from_numpy(emb), torch.from_numpy(lab)), ref)


def test_ssnd_train_mode_forward_and_statistics_match_jax(pair):
    jm, v, m = pair
    audio, aux = _inputs(seed=8)
    with _jax_conformer_dropout_0():
        ref, new = jax.jit(lambda a, x: jm.apply(v, a, x, True, mutable=["batch_stats"]))(jnp.asarray(audio),
                                                                                          jnp.asarray(aux))
    m2 = S.SSNDModel(m.cfg, device="cpu", dropout=0.0)
    m2.load_state_dict(m.state_dict())
    m2.train()
    got = m2(torch.from_numpy(audio), torch.from_numpy(aux))
    for g, r in zip(got, ref):
        _fp32_close(g.detach(), r)
    want = convert.ssnd_from_flax({"params": v["params"], "batch_stats": jax.device_get(new["batch_stats"])})
    sd = m2.state_dict()
    for k, t in want.items():
        if "running_" in k:
            np.testing.assert_allclose(sd[k].numpy(), t.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_ssnd_weights_round_trip(pair):
    _, v, m = pair
    back = convert.ssnd_to_flax(m.state_dict(), num_heads=2)
    a, b = _flat(v), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    m2 = S.SSNDModel(m.cfg, device="cpu", seed=5)
    m2.load_state_dict(convert.ssnd_from_flax(back))
    for k, t in m.state_dict().items():
        assert torch.equal(t, m2.state_dict()[k]), k


@pytest.mark.parametrize("train", [False, True])
def test_ssnd_loss_and_gradients_match_jax(pair, train, monkeypatch):
    """JAX's make_ssnd_loss on the deterministic aux_embs batch (slot gids
    with −1 among them), the loss and its aux against the port's, and the
    gradients against jax.value_and_grad. Both sides read JAX's fbank (the
    port's kaldi_fbank_auto patched to return it): the twin differs from it
    by ~1e-5, which can flip a ReLU of CAM++'s trunk."""
    jm, v, m = pair
    rng = np.random.default_rng(9)
    audio, aux = _inputs(seed=10)
    batch = dict(audio=audio, aux_embs=aux, labels=(rng.random((2, 3, 20)) < 0.4).astype(np.float32),
                 spk_gids=np.array([[1, 4, -1], [6, -1, 0]], np.int32))
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    fb = jax.jit(functools.partial(JS.F.kaldi_fbank_auto, sample_rate=RATE, num_mel_bins=24))(jb["audio"])
    monkeypatch.setattr(TF, "kaldi_fbank_auto", lambda *a, **k: torch.from_numpy(np.array(fb)))
    monkeypatch.setattr(JS.F, "kaldi_fbank_auto", lambda *a, **k: fb)
    mut = {"batch_stats": v["batch_stats"]}
    with _jax_conformer_dropout_0():
        loss_fn = JT.make_ssnd_loss(jm, arcface_weight=0.05)
        (jloss, (jaux, _)), jgrads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, mut, jb, jax.random.PRNGKey(0), train), has_aux=True))(v["params"])
    m2 = S.SSNDModel(m.cfg, device="cpu", dropout=0.0)
    m2.load_state_dict(m.state_dict())
    m2.train(train)
    loss, aux_out = make_ssnd_loss(arcface_weight=0.05)(m2, {k: torch.from_numpy(a) for k, a in batch.items()},
                                                         None, train)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("bce_loss", "arcface_loss", "arcface_acc", "frame_der"):
        np.testing.assert_allclose(aux_out[k].item(), float(jaux[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in m2.named_parameters()}  # e_pse, e_non
    _grads_close(_flat(convert.ssnd_to_flax(grads, num_heads=2)["params"]), _flat(jgrads))


def test_ssnd_training_queries(pair):
    """Without aux_embs the slot queries follow the reference protocol: a
    present slot carries its E_all row unless it is the one slot masked to
    e_pse (in training only, at most one per sample), an empty slot e_non
    or an E_all row; the draws come from the generator."""
    _, _, m = pair
    queries = []
    orig = S.SSNDModel.forward

    def spy(self, audio, aux, vad_labels=None, generator=None):
        queries.append(aux.detach().clone())
        return orig(self, audio, aux, vad_labels, generator)

    audio, _ = _inputs(seed=11, B=4)
    gids = torch.tensor([[1, 4, -1], [6, -1, -1], [0, 2, 5], [-1, -1, -1]])
    batch = dict(audio=torch.from_numpy(audio), labels=torch.zeros(4, 3, 20), spk_gids=gids)
    loss_fn = make_ssnd_loss()
    S.SSNDModel.forward = spy
    try:
        with torch.no_grad():
            for train in (True, True, False):
                loss_fn(m, batch, torch.Generator().manual_seed(3), train)
    finally:
        S.SSNDModel.forward = orig
    assert torch.equal(queries[0], queries[1])  # the same generator state, the same queries
    E, pse, non = m.E_all.detach(), m.e_pse.detach()[0], m.e_non.detach()[0]
    for q, train in zip(queries, (True, True, False)):
        for b in range(4):
            masked = 0
            for s in range(3):
                row = q[b, s]
                if gids[b, s] >= 0:
                    if torch.equal(row, pse):
                        masked += 1
                    else:
                        assert torch.equal(row, E[gids[b, s]])
                else:
                    assert torch.equal(row, non) or any(torch.equal(row, e) for e in E)
            assert masked <= (1 if train else 0)


def test_ssnd_online_copies_match(pair):
    """The port's copy of infer/ssnd_online.py against the JAX module on a
    seeded recording, driven by the JAX model's predictor and by the port's
    (make_ssnd_predict), online and with the offline rescoring. The seeded
    weights put e_pse's slot over the discovery threshold, so speakers are
    found and the memory is updated."""
    jm, v, m = pair
    audio = (0.1 * np.random.default_rng(12).standard_normal(int(3.5 * N))).astype(np.float32)
    e_pse, e_non = np.asarray(v["params"]["e_pse"])[0], np.asarray(v["params"]["e_non"])[0]
    japply = jax.jit(jm.apply)

    def jpredict(a, x):
        return japply(v, jnp.asarray(a), jnp.asarray(x))

    ppredict = PO.make_ssnd_predict(m)
    args = (audio, N, 20, 3, e_pse, e_non)
    for kw in (dict(), dict(active_threshold=0.2, new_speaker_threshold=0.2)):
        want, mem = JO.ssnd_online_infer(jpredict, *args, return_memory=True, **kw)
        got, pmem = PO.ssnd_online_infer(jpredict, *args, return_memory=True, **kw)
        np.testing.assert_array_equal(got, want)
        assert pmem.counts == mem.counts
        got2, pmem2 = PO.ssnd_online_infer(ppredict, *args, return_memory=True, **kw)
        assert got2.shape == want.shape and pmem2.counts == mem.counts
        np.testing.assert_allclose(got2, want, rtol=0, atol=1e-4)
        want = JO.ssnd_offline_rescore(jpredict, *args, **kw)
        np.testing.assert_array_equal(PO.ssnd_offline_rescore(jpredict, *args, **kw), want)
        np.testing.assert_allclose(PO.ssnd_offline_rescore(ppredict, *args, **kw), want, rtol=0, atol=1e-4)
    assert len(mem) >= 1 and want.shape[0] == 4 * 20


def test_cli_train_infer_score(tmp_path, capsys):
    """simulate's voice pool (single-speaker --train-dir) and mixtures of its
    speakers (--real-data-dir), train 2 steps, then infer with the offline
    rescoring and the threshold sweep, and score."""
    data = simulate.simulate_corpus(str(tmp_path / "c"), n_mixtures=2, n_speakers=2, rate=RATE, seed=1,
                                    src_speakers=4, utts_per_speaker=3)
    exp, hyp = str(tmp_path / "exp"), str(tmp_path / "hyp.rttm")
    sets = ["sample_rate=8000", "rs_len=2.0", "encoder_blocks=1,1", "batch_size=2", "num_steps=2", "log_every=1",
            "valid_every=100", "schedule=poly", "learning_rate=1e-3", "warmup_steps=1", "ssnd_arcface_weight=0.05"]
    argv = ["train", "--family", "ssnd", "--train-dir", str(tmp_path / "c" / "src"), "--real-data-dir", data,
            "--noise-dir", str(tmp_path / "c" / "noise"), "--exp-dir", exp, "--device", "cpu"]
    assert port_cli(argv + [a for kv in sets for a in ("--set", kv)]) == 0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if r["kind"] == "train"] == [1, 2] and all(np.isfinite(r["loss"]) for r in recs)
    with open(os.path.join(exp, "train_config.json")) as f:
        assert json.load(f)["all_n_speakers"] == 4  # the mixer's speakers
    capsys.readouterr()
    assert port_cli(["infer", "--data-dir", data, "--exp-dir", exp, "--out", hyp, "--device", "cpu",
                     "--threshold-sweep", "--ssnd-rescore", "--ref", os.path.join(data, "rttm"),
                     "--set", "all_n_speakers=0"]) == 0
    out = capsys.readouterr().out
    assert sum(ln.startswith("threshold ") for ln in out.splitlines()) == 18 and "best threshold" in out
    assert port_cli(["score", "--ref", os.path.join(data, "rttm"), "--sys", f"{hyp}_0.50"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(line.split("/")) == 4


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.SSNDModel(S.SSNDConfig(**TINY))
    assert S.SSNDModel(S.SSNDConfig(**TINY), device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["train", "--family", "ssnd", "--train-dir", str(tmp_path), "--exp-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["infer", "--family", "ssnd", "--data-dir", str(tmp_path), "--exp-dir", str(tmp_path), "--out", "o"])
