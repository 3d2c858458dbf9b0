"""Port parity of FS-EEND: FSEENDModel (with and without a padded frame mask,
at two look-aheads), its causality up to the conv look-ahead, the channel
label protocol (silent speakers and speakers that start on the same frame:
the stable sort), the consistency loss, the training loss and its
gradients, the weight converters both ways, and a port-only `train` →
`infer --threshold-sweep` → `score` chain, against the JAX package.

Tolerances: outputs 1e-4·max(1, max|ref|) in fp32; losses 1e-5 relative;
gradients 1e-4·max|ref grad| of each tensor; labels exact."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.models import fs_eend as JF
from speaker_diarization_tpu.models.eend import FrontendConfig as JFrontend
from speaker_diarization_tpu.train import tasks as JT
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.models import fs_eend as F
from speaker_diarization_tpu_torch.train.tasks import make_fs_eend_loss
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

TINY = dict(n_speakers=3, d_model=16, enc_layers=2, dec_layers=1, n_heads=2, d_ff=32, dec_d_ff=24, dropout=0.0)
DELAYS = {"causal": dict(conv_delay=2, mask_delay=0), "lookahead": dict(conv_delay=1, mask_delay=3)}


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


def _audio(seed=3, B=2, n=24000):  # 3 s: 300 frames, 30 after subsampling
    return (0.1 * np.random.default_rng(seed).standard_normal((B, n))).astype(np.float32)


@pytest.fixture(scope="module", params=list(DELAYS))
def pair(request):
    kw = dict(TINY, **DELAYS[request.param])
    jm = JF.FSEENDModel(**kw, frontend=JFrontend())
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(_audio()))
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), v)
    m = F.FSEENDModel(**kw, device="cpu")
    m.load_state_dict(convert.fs_eend_from_flax(v))
    return jm, v, m


def test_fs_eend_forward_matches_jax(pair):
    jm, v, m = pair
    audio = _audio(seed=4)
    fm = np.ones((2, 30), np.float32)
    fm[1, 17:] = 0.0
    for mask in (None, fm):
        jfm = None if mask is None else jnp.asarray(mask)
        ref = jax.jit(jm.apply)(v, jnp.asarray(audio), jfm)
        with torch.no_grad():
            got = m(torch.from_numpy(audio), None if mask is None else torch.from_numpy(mask))
        assert got[0].shape == (2, 30, 5) and got[1].shape == (2, 30, 16)
        for g, r in zip(got, ref):
            _fp32_close(g, r)
    assert (got[0][1, 17:] == 0).all()


def test_fs_eend_is_causal_up_to_its_lookahead(pair):
    """Changing the features from frame t on moves no logit before
    t − conv_delay − mask_delay·(layers) (here one fusion layer and the
    encoder's own look-ahead per layer)."""
    _, _, m = pair
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 40, 345)).astype(np.float32))
    y = x.clone()
    y[:, 30:] += 1.0
    with torch.no_grad():
        a, b = m(x)[0], m(y)[0]
    reach = m.lookahead_conv.padding[0] + m.mask_delay * (len([n for n in m.encoder.state_dict() if n.endswith(
        "attn.query.weight")]) + 1)
    assert torch.equal(a[:, : 30 - reach], b[:, : 30 - reach]) and not torch.equal(a, b)


def test_fs_eend_weights_round_trip(pair):
    _, v, m = pair
    back = convert.fs_eend_to_flax(m.state_dict(), num_heads=2)
    a, b = _flat(v), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    m2 = F.FSEENDModel(**TINY, conv_delay=m.lookahead_conv.padding[0], mask_delay=m.mask_delay, device="cpu", seed=5)
    m2.load_state_dict(convert.fs_eend_from_flax(back))
    for k, t in m.state_dict().items():
        assert torch.equal(t, m2.state_dict()[k]), k


def _label_cases():
    rng = np.random.default_rng(6)
    labels = (rng.random((4, 30, 3)) < 0.3).astype(np.float32)
    labels[0, :, 1] = 0.0  # a silent speaker (first frame inf)
    labels[1, :, :] = 0.0  # all silent: the order stays 0, 1, 2
    labels[2, :5] = 0.0
    labels[2, 5, :] = 1.0  # all three start on frame 5
    labels[3, :, 0] = 0.0
    labels[3, :, 2] = 0.0  # two silent speakers
    labels[3, :3, 1] = 0.0
    fm = np.ones((4, 30), np.float32)
    fm[1, 20:] = 0.0
    return labels, fm


def test_fs_eend_labels_match_jax():
    labels, fm = _label_cases()
    for mask in (None, fm):
        want = np.asarray(JF.fs_eend_labels(jnp.asarray(labels), None if mask is None else jnp.asarray(mask)))
        got = F.fs_eend_labels(torch.from_numpy(labels), None if mask is None else torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2, :, 1:4], labels[2])  # ties keep the speakers' order
    np.testing.assert_array_equal(got[0, :, 3], np.zeros(30))  # the silent speaker sorts last


def test_consistency_loss_matches_jax():
    labels, fm = _label_cases()
    ch = np.array(JF.fs_eend_labels(jnp.asarray(labels), jnp.asarray(fm)))
    emb = np.random.default_rng(7).standard_normal((4, 30, 16)).astype(np.float32)
    for mask in (None, fm):
        want = JF.consistency_loss(jnp.asarray(emb), jnp.asarray(ch), None if mask is None else jnp.asarray(mask))
        got = F.consistency_loss(torch.from_numpy(emb), torch.from_numpy(ch),
                                 None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_fs_eend_loss_and_gradients_match_jax(pair):
    jm, v, m = pair
    labels, _ = _label_cases()
    fm = np.ones((2, 30), np.float32)
    fm[0, 25:] = 0.0
    batch = dict(audio=_audio(seed=8), labels=labels[2:], frame_mask=fm)
    loss_fn = JT.make_fs_eend_loss(jm)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, {k: jnp.asarray(a) for k, a in batch.items()}, jax.random.PRNGKey(0), False),
        has_aux=True))(v)
    m2 = F.FSEENDModel(**TINY, conv_delay=m.lookahead_conv.padding[0], mask_delay=m.mask_delay, device="cpu")
    m2.load_state_dict(m.state_dict())
    loss, aux = make_fs_eend_loss()(m2, {k: torch.from_numpy(a) for k, a in batch.items()}, None, False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in jaux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, err_msg=k)
    grads = {n: p.grad for n, p in m2.named_parameters()}
    _grads_close(_flat(convert.fs_eend_to_flax(grads, num_heads=2)["params"]), _flat(jgrads["params"]))


def test_cli_train_infer_score(tmp_path, capsys):
    tr = write_synthetic_corpus(str(tmp_path / "train"), n_recs=2, seconds=10.0, rate=8000, n_speakers=3, seed=1,
                                prefix="tr")
    va = write_synthetic_corpus(str(tmp_path / "valid"), n_recs=1, seconds=10.0, rate=8000, n_speakers=3, seed=2,
                                prefix="va")
    exp, hyp = str(tmp_path / "exp"), str(tmp_path / "hyp.rttm")
    sets = ["sample_rate=8000", "n_speakers=3", "n_mels=23", "d_model=16", "d_ff=32", "n_layers=2", "n_heads=2",
            "chunk_frames=50", "batch_size=2", "num_steps=2", "log_every=1", "valid_every=2", "optimizer=adam",
            "schedule=noam", "learning_rate=1.0", "warmup_steps=10"]
    argv = ["train", "--family", "fs_eend", "--train-dir", tr["data_dir"], "--valid-dir", va["data_dir"], "--exp-dir",
            exp, "--device", "cpu"]
    assert port_cli(argv + [a for kv in sets for a in ("--set", kv)]) == 0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if r["kind"] == "train"] == [1, 2] and any(r["kind"] == "valid" for r in recs)
    assert all(np.isfinite(r["loss"]) for r in recs)
    capsys.readouterr()
    assert port_cli(["infer", "--data-dir", va["data_dir"], "--exp-dir", exp, "--out", hyp, "--device", "cpu",
                     "--threshold-sweep", "--ref", va["rttm"]]) == 0
    out = capsys.readouterr().out
    assert sum(ln.startswith("threshold ") for ln in out.splitlines()) == 18 and "best threshold" in out
    assert port_cli(["score", "--ref", va["rttm"], "--sys", f"{hyp}_0.50"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(line.split("/")) == 4


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        F.FSEENDModel(**TINY)
    assert F.FSEENDModel(**TINY, device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["train", "--family", "fs_eend", "--train-dir", str(tmp_path), "--exp-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["infer", "--family", "fs_eend", "--data-dir", str(tmp_path), "--exp-dir", str(tmp_path),
                  "--out", "o"])
