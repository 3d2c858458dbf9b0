"""Port parity of EEND-M2F: the Hungarian matcher (scipy on the host behind
the JAX package's input sanitising) against JAX's on-device solver on 300
seeded cost matrices, the dice loss, EENDM2FModel (the conformer backbone,
the transformer behind the backbone, the flat variant with a padded frame
mask), the set criterion with both matchers and its gradients, the
inference activity with a tie at the k-th value, the weight converters both
ways, and a port-only `train` → `infer --threshold-sweep` → `score` chain,
against the JAX package.

Tolerances: outputs 1e-4·max(1, max|ref|) in fp32; losses 1e-5 relative;
gradients 1e-4·max|ref grad| of each tensor; assignments exact where the
minimum is unique, equal total cost where it is not."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.models import eend_m2f as JM
from speaker_diarization_tpu.models.eend import FrontendConfig as JFrontend
from speaker_diarization_tpu.ops import hungarian as JH
from speaker_diarization_tpu.train import tasks as JT
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.models import eend_m2f as M
from speaker_diarization_tpu_torch.ops import hungarian as H
from speaker_diarization_tpu_torch.train.tasks import make_m2f_loss
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

TINY = dict(num_queries=5, d_model=16, n_heads=2, d_ff=24, enc_layers=1, dec_layers=2, dropout=0.0, conv_kernel=7)
VARIANTS = {"conformer": {}, "flat": dict(use_backbone=False), "transformer": dict(encoder_type="transformer")}
JFE = dataclasses.replace(JFrontend(), subsampling=1, context_size=0)


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


# ---------------------------------------------------------------------------
# Hungarian
# ---------------------------------------------------------------------------


def _cost_sets():
    """300 seeded (B, S, Q) matrices, S ≤ Q: continuous costs (a unique
    minimum), the same with pad-sentinel columns at real_max + 1 and with
    sparse inf/−inf/nan entries, and integer costs full of ties."""
    rng = np.random.default_rng(0)
    sets = []
    for S, Q in ((3, 8), (4, 4), (2, 16)):
        c = rng.standard_normal((25, S, Q)).astype(np.float32) * rng.uniform(0.1, 100, (25, 1, 1)).astype(np.float32)
        sets.append(("unique", c))
        p = c.copy()
        p[:, -1, :] = p[:, :-1, :].max(axis=(1, 2))[:, None] + 1.0  # an absent speaker's sentinel row
        sets.append(("pad", p))
        n = c.copy()
        bad = rng.random(n.shape) < 0.08
        n[bad] = rng.choice(np.array([np.inf, -np.inf, np.nan], np.float32), bad.sum())
        n[0, :, :] = np.nan  # nothing finite: every entry the sentinel 0
        sets.append(("nonfinite", n))
        sets.append(("ties", rng.integers(0, 3, (25, S, Q)).astype(np.float32)))
    return sets


def _total(cost, assign):
    return np.take_along_axis(cost, assign[..., None], axis=-1)[..., 0].sum(-1)


def test_hungarian_matches_jax_solver():
    n = 0
    for kind, cost in _cost_sets():
        want = np.asarray(jax.jit(JH.hungarian_assign)(jnp.asarray(cost)))
        got = H.hungarian_assign(torch.from_numpy(cost)).numpy()
        n += len(cost)
        assert got.shape == want.shape and all(len(set(r)) == len(r) for r in got), kind
        clean = H.sanitize_costs(torch.from_numpy(cost)).numpy()
        np.testing.assert_allclose(_total(clean, got), _total(clean, want), rtol=1e-6, atol=1e-5, err_msg=kind)
        if kind in ("unique", "pad"):
            np.testing.assert_array_equal(got, want, err_msg=kind)
        elif kind == "nonfinite":  # unique wherever the optimum avoids the sentinel entries
            avoid = np.isfinite(np.take_along_axis(cost, want[..., None], axis=-1)[..., 0]).all(-1)
            assert avoid.sum() > 10
            np.testing.assert_array_equal(got[avoid], want[avoid], err_msg=kind)
    assert n == 300


def test_hungarian_sanitizing_matches_jax_formula():
    """The sentinel is max + max(max − min, 1) of the finite entries and the
    matrix is shifted by its finite minimum; all-nonfinite → zeros."""
    cost = np.array([[[1.0, np.inf, 3.0], [np.nan, -2.0, -np.inf]], [[np.nan] * 3, [np.inf] * 3]], np.float32)
    got = H.sanitize_costs(torch.from_numpy(cost)).numpy()
    np.testing.assert_array_equal(got[0], np.array([[3.0, 10.0, 5.0], [10.0, 0.0, 10.0]], np.float32))
    np.testing.assert_array_equal(got[1], np.ones((2, 3), np.float32))
    with pytest.raises(ValueError, match="N <= M"):
        H.hungarian_assign(torch.zeros(1, 3, 2))


def test_dice_loss_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 50)).astype(np.float32)
    y = (rng.random((3, 4, 50)) < 0.3).astype(np.float32)
    np.testing.assert_allclose(H.dice_loss(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(JH.dice_loss(jnp.asarray(x), jnp.asarray(y))), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# EENDM2FModel
# ---------------------------------------------------------------------------


def _audio(seed=3, B=2, n=8000):
    return (0.1 * np.random.default_rng(seed).standard_normal((B, n))).astype(np.float32)


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    kw = dict(TINY, **VARIANTS[request.param])
    jm = JM.EENDM2FModel(cfg=JM.M2FConfig(**kw), frontend=JFE)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(_audio()))
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), v)
    m = M.EENDM2FModel(M.M2FConfig(**kw), device="cpu")
    m.load_state_dict(convert.m2f_from_flax(v))
    return request.param, jm, v, m


def test_m2f_forward_matches_jax(pair):
    """Every decoder level's masks and class logits; the flat variant also
    with a half-padded frame mask (the only variant that reads it)."""
    name, jm, v, m = pair
    audio = _audio(seed=4, n=8123)  # 102 frames: the pixel decoder's 100 padded back to 102
    fm = np.ones((2, 102), np.float32)
    fm[1, 50:] = 0.0
    for mask in (None, fm) if name == "flat" else (None,):
        jfm = None if mask is None else jnp.asarray(mask)
        ref = jax.jit(jm.apply)(v, jnp.asarray(audio), jfm)
        with torch.no_grad():
            got = m(torch.from_numpy(audio), None if mask is None else torch.from_numpy(mask))
        assert got["mask_logits"].shape == (2, 5, 102) and len(got["aux_mask_logits"]) == 1
        for k in ("mask_logits", "class_logits"):
            _fp32_close(got[k], ref[k])
        for g, r in zip(got["aux_mask_logits"] + got["aux_class_logits"],
                        ref["aux_mask_logits"] + ref["aux_class_logits"]):
            _fp32_close(g, r)


def test_m2f_weights_round_trip(pair):
    _, _, v, m = pair
    back = convert.m2f_to_flax(m.state_dict(), num_heads=2)
    a, b = _flat(v), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    m2 = M.EENDM2FModel(m.cfg, device="cpu", seed=5)
    m2.load_state_dict(convert.m2f_from_flax(back))
    for k, t in m.state_dict().items():
        assert torch.equal(t, m2.state_dict()[k]), k


MATCHERS = {"conformer": ("mask2former", "fastinst"), "flat": ("fastinst",), "transformer": ("mask2former",)}


def test_m2f_loss_and_gradients_match_jax(pair):
    """JAX's make_m2f_loss (its matcher on the device) against the port's
    (scipy on the host) on an EEND batch at subsampling 1 with a speaker
    absent from one item and a padded frame mask, with each matcher; the
    gradients against jax.value_and_grad."""
    name, jm, v, m = pair
    for matcher in MATCHERS[name]:
        _loss_and_gradients_match(jm, v, m, matcher)


def _loss_and_gradients_match(jm, v, m, matcher):
    rng = np.random.default_rng(6)
    labels = (rng.random((2, 100, 3)) < 0.3).astype(np.float32)
    labels[1, :, 2] = 0.0
    fm = np.ones((2, 100), np.float32)
    fm[0, 80:] = 0.0
    batch = dict(audio=_audio(seed=7), labels=labels, frame_mask=fm)
    cfg = dataclasses.replace(m.cfg, matcher=matcher)
    jm2 = JM.EENDM2FModel(cfg=JM.M2FConfig(**dataclasses.asdict(cfg)), frontend=JFE)
    loss_fn = JT.make_m2f_loss(jm2)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, {k: jnp.asarray(a) for k, a in batch.items()}, jax.random.PRNGKey(0), False),
        has_aux=True))(v)
    m2 = M.EENDM2FModel(cfg, device="cpu")
    m2.load_state_dict(m.state_dict())
    loss, aux = make_m2f_loss()(m2, {k: torch.from_numpy(a) for k, a in batch.items()}, None, False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in jaux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, err_msg=k)
    grads = {n: p.grad for n, p in m2.named_parameters()}
    _grads_close(_flat(convert.m2f_to_flax(grads, num_heads=2)["params"]), _flat(jgrads["params"]))


@pytest.mark.parametrize("k", [0, 1, 2, 5])
def test_m2f_predict_activity_keeps_ties(k):
    """Kept queries and the per-frame top-k against JAX; frame 0 has three
    activities equal at the 2nd value, all kept (>=)."""
    rng = np.random.default_rng(8)
    masks = rng.standard_normal((2, 5, 30)).astype(np.float32)
    masks[0, 1:4, 0] = 0.7
    masks[0, 0, 0] = 2.0
    classes = np.array([[2.0, 1.0, 0.5, 0.3, -1.0], [0.1, -0.2, 3.0, 0.0, 1.0]], np.float32)
    out = {"mask_logits": masks, "class_logits": classes}
    want, wkeep = JM.m2f_predict_activity({k2: jnp.asarray(a) for k2, a in out.items()}, 0.5, k)
    got, keep = M.m2f_predict_activity({k2: torch.from_numpy(a) for k2, a in out.items()}, 0.5, k)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(wkeep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    if k == 2:
        assert (got[0, :4, 0] > 0).sum() == 4  # the top value and the three tied at the 2nd


# ---------------------------------------------------------------------------
# CLI: train → infer --threshold-sweep → score (port only)
# ---------------------------------------------------------------------------


def test_cli_train_infer_score(tmp_path, capsys):
    """The front-end is forced to subsampling 1 and context 0 whatever --set
    says, as in JAX; infer with the query threshold and the concurrency cap."""
    tr = write_synthetic_corpus(str(tmp_path / "train"), n_recs=2, seconds=6.0, rate=8000, n_speakers=3, seed=1,
                                prefix="tr")
    va = write_synthetic_corpus(str(tmp_path / "valid"), n_recs=1, seconds=6.0, rate=8000, n_speakers=3, seed=2,
                                prefix="va")
    exp, hyp = str(tmp_path / "exp"), str(tmp_path / "hyp.rttm")
    model_sets = ["sample_rate=8000", "n_speakers=3", "d_model=16", "d_ff=32", "n_layers=2", "n_heads=2",
                  "chunk_frames=200", "subsampling=10", "context_size=7"]
    sets = model_sets + ["batch_size=2", "num_steps=2", "log_every=1", "valid_every=2", "optimizer=adam",
                         "schedule=poly", "learning_rate=2e-4", "warmup_steps=1"]
    argv = ["train", "--family", "eend_m2f", "--train-dir", tr["data_dir"], "--valid-dir", va["data_dir"], "--exp-dir",
            exp, "--device", "cpu"]
    assert port_cli(argv + [a for kv in sets for a in ("--set", kv)]) == 0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if r["kind"] == "train"] == [1, 2] and any(r["kind"] == "valid" for r in recs)
    assert all(np.isfinite(r["loss"]) for r in recs)
    with open(os.path.join(exp, "train_config.json")) as f:
        saved = json.load(f)
    assert (saved["subsampling"], saved["context_size"]) == (1, 0)
    capsys.readouterr()
    assert port_cli(["infer", "--data-dir", va["data_dir"], "--exp-dir", exp, "--out", hyp, "--device", "cpu",
                     "--threshold-sweep", "--ref", va["rttm"], "--class-threshold", "0.3",
                     "--m2f-max-concurrent", "2"]) == 0
    out = capsys.readouterr().out
    assert sum(ln.startswith("threshold ") for ln in out.splitlines()) == 18 and "best threshold" in out
    assert port_cli(["score", "--ref", va["rttm"], "--sys", f"{hyp}_0.50"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(line.split("/")) == 4


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.EENDM2FModel(M.M2FConfig(**TINY))
    assert M.EENDM2FModel(M.M2FConfig(**TINY), device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["train", "--family", "eend_m2f", "--train-dir", str(tmp_path), "--exp-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["infer", "--family", "eend_m2f", "--data-dir", str(tmp_path), "--exp-dir", str(tmp_path),
                  "--out", "o"])
