"""Port parity of EEND-VC: the model's logits, chunk vectors and speaker-table
distance logits, the loss (speaker ids with −1 among them) and its
gradients, the weight converters both ways, the constrained AHC on SciPy
against the JAX module's scikit-learn one, whole-recording inference up to a
permutation of the output channels, and a port-only `train` → `infer
--threshold-sweep` → `score` chain, against the JAX package.

Tolerances: outputs 1e-4·max(1, max|ref|) in fp32; losses 1e-5 relative;
gradients 1e-4·max|ref grad| of each tensor; AHC partitions exact."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.infer import eend_vc as JI
from speaker_diarization_tpu.models.eend import FrontendConfig as JFrontend
from speaker_diarization_tpu.models.eend_vc import EENDVCModel as JModel
from speaker_diarization_tpu.train import tasks as JT
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.infer import eend_vc as I
from speaker_diarization_tpu_torch.models.eend import FrontendConfig
from speaker_diarization_tpu_torch.models.eend_vc import EENDVCModel
from speaker_diarization_tpu_torch.train.tasks import make_eend_vc_loss
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

SMALL = dict(n_speakers=3, vec_dim=8, all_n_speakers=5, d_model=32, n_layers=2, n_heads=4, d_ff=64, dropout=0.0)
CHUNK = 30  # subsampled frames: 3 s at 8 kHz


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _fp32_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=1e-4 * max(1.0, float(np.abs(ref).max())))


@pytest.fixture(scope="module")
def pair():
    jm = JModel(frontend=JFrontend(), **SMALL)
    x = jnp.zeros((1, FrontendConfig().chunk_samples(CHUNK)))
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32) + 0.1 * rng.standard_normal(a.shape).astype(
        np.float32), jax.jit(lambda k, a: jm.init(k, a, method=jm.init_all))(jax.random.PRNGKey(0), x))
    m = EENDVCModel(frontend=FrontendConfig(), device="cpu", **SMALL)
    m.load_state_dict(convert.eend_vc_from_flax(v))
    return jm, v, m


def _batch(seed=2, B=3):
    rng = np.random.default_rng(seed)
    n = FrontendConfig().chunk_samples(CHUNK)
    mask = (np.arange(CHUNK)[None] < np.array([[CHUNK], [CHUNK], [17]][:B])).astype(np.float32)
    labels = (rng.random((B, CHUNK, 3)) < 0.35).astype(np.float32) * mask[..., None]
    labels[1, :, 2] = 0.0  # a channel without speech
    return dict(audio=(0.1 * rng.standard_normal((B, n))).astype(np.float32), frame_mask=mask, labels=labels,
                spk_mask=np.ones((B, 3), np.float32), spk_ids=np.array([[0, 3, 4], [2, 1, -1], [-1, 4, 0]][:B], np.int32))


def test_logits_vectors_and_distance_logits_match_jax(pair):
    jm, v, m = pair
    b = _batch()
    ref_l, ref_v = jax.jit(jm.apply)(v, jnp.asarray(b["audio"]), jnp.asarray(b["frame_mask"]))
    with torch.no_grad():
        lo, vecs = m(torch.from_numpy(b["audio"]), torch.from_numpy(b["frame_mask"]))
    assert lo.shape == (3, CHUNK, 3) and vecs.shape == (3, 3, 8)
    _fp32_close(lo, ref_l)
    _fp32_close(vecs, ref_v)
    np.testing.assert_allclose(vecs.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    with torch.no_grad():
        d = m.spk_distance_logits(vecs)
    ref_d = jm.apply(v, ref_v, method=jm.spk_distance_logits)
    assert d.shape == (3, 3, 5)
    _fp32_close(d, ref_d)


def test_weights_round_trip(pair):
    _, v, m = pair
    back = convert.eend_vc_to_flax(m.state_dict(), num_heads=4)
    a, b = _flat(v), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_seeded_model_starts_alpha_and_beta_at_one():
    m = EENDVCModel(frontend=FrontendConfig(), device="cpu", seed=3, **SMALL)
    assert m.alpha.item() == 1.0 and m.beta.item() == 1.0
    assert not hasattr(EENDVCModel(frontend=FrontendConfig(), device="cpu", **dict(SMALL, all_n_speakers=0)),
                       "spk_table")


def test_loss_and_gradients_match_jax(pair):
    """PIT-BCE plus the speaker CE under the best permutation; the channels
    with id −1 and the channel without speech are left out of the CE."""
    jm, v, m = pair
    b = _batch(seed=4)
    jb = {k: jnp.asarray(a) for k, a in b.items()}
    jloss_fn = JT.make_eend_vc_loss(jm)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, jb, jax.random.PRNGKey(0), False), has_aux=True))(v)
    m.zero_grad()
    loss, aux = make_eend_vc_loss()(m, {k: torch.from_numpy(a) for k, a in b.items()}, None, False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("pit_loss", "spk_loss", "frame_der"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, err_msg=k)
    grads = _flat(convert.eend_vc_to_flax({n: p.grad for n, p in m.named_parameters()}, num_heads=4))
    want = _flat(jgrads)
    assert grads.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for k in want:
        scale = np.abs(want[k]).max()
        if scale < 1e-6 * top:  # zero in exact arithmetic (the attention key bias): rounding noise
            assert np.abs(grads[k]).max() < 1e-6 * top, k
            continue
        np.testing.assert_allclose(grads[k], want[k], rtol=0, atol=1e-4 * scale, err_msg=k)


def _same_partition(a, b):
    return len(set(zip(a.tolist(), b.tolist()))) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("mode", ["count", "threshold"])
def test_constrained_ahc_matches_jax_sklearn(mode):
    """SciPy average linkage against the JAX module's sklearn
    AgglomerativeClustering: the same partition (labels from 0) on 200
    seeded sets of unit vectors with cannot-link pairs, some with every pair
    linked (tied merge heights)."""
    rng = np.random.default_rng(0 if mode == "count" else 1)
    for t in range(200):
        n = int(rng.integers(2, 24))
        x = rng.standard_normal((n, 6))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        if t % 10 == 0:
            links = [(i, j) for i in range(n) for j in range(i + 1, n)]
        else:
            links = [(int(a), int(b)) for a, b in rng.integers(0, n, (int(rng.integers(0, 2 * n)), 2)) if a != b]
        k = int(rng.integers(1, 6)) if mode == "count" else None
        th = float(rng.uniform(0.5, 1.5))
        got = I.constrained_ahc(x, links, k, th)
        want = JI.constrained_ahc(x, links, k, th)
        assert got.dtype == np.int32 and got.min() == 0 and got.max() == len(set(got.tolist())) - 1
        assert _same_partition(got, want), (t, got, want)
        if k is None:  # an average over fewer than 24² pairs with one at 1e4 stays above any threshold here
            assert all(got[a] != got[b] for a, b in links)
        if k is not None and len(links) == n * (n - 1) // 2:
            assert len(set(got.tolist())) == min(k, n)


def test_infer_recording_matches_jax_up_to_channel_order(pair):
    """A 10 s recording in 4 chunks: chunk posteriors and vectors → AHC →
    stitched tracks, with the JAX predictor and the port's, to an oracle
    count and by the distance threshold."""
    jm, v, m = pair
    fe = FrontendConfig()
    audio = (0.1 * np.random.default_rng(5).standard_normal(80000)).astype(np.float32)

    @jax.jit
    def jpredict(a, mask):
        lo, vecs = jm.apply(v, a, frame_mask=mask)
        return jax.nn.sigmoid(lo) * mask[..., None], vecs

    for k in (2, None):
        # writable copies: the JAX module merges same-label channels in place
        want = JI.eend_vc_infer_recording(lambda a, mk: tuple(np.array(t) for t in jpredict(jnp.asarray(a),
                                                                                          jnp.asarray(mk))),
                                          audio, JFrontend(), CHUNK, n_clusters=k, sil_spk_th=0.05)
        got = I.eend_vc_infer_recording(I.make_eend_vc_predict(m), audio, fe, CHUNK, n_clusters=k, sil_spk_th=0.05)
        assert got.shape == want.shape and got.shape[0] == 100
        used = [c for c in range(want.shape[1]) if want[:, c].any()]
        perm = []
        for c in range(got.shape[1]):  # each port track is one JAX track
            d = [np.abs(got[:, c] - want[:, j]).max() for j in range(want.shape[1])]
            perm.append(int(np.argmin(d)))
        assert sorted(perm) == list(range(want.shape[1])) and used
        _fp32_close(got, want[:, perm])


def test_cli_train_infer_score(tmp_path, capsys):
    tr = write_synthetic_corpus(str(tmp_path / "train"), n_recs=2, seconds=12.0, rate=8000, n_speakers=3, seed=1,
                                prefix="tr")
    # 9 valid speakers, none of them in the 6-row training table: their ids
    # must not index the table (JAX's take_along_axis reads NaN there)
    va = write_synthetic_corpus(str(tmp_path / "valid"), n_recs=3, seconds=12.0, rate=8000, n_speakers=3, seed=2,
                                prefix="va")
    exp, hyp = str(tmp_path / "exp"), str(tmp_path / "hyp.rttm")
    sets = ["n_speakers=3", "d_model=16", "n_layers=1", "n_heads=2", "d_ff=32", "chunk_frames=30", "batch_size=2",
            "num_steps=2", "log_every=1", "valid_every=2"]
    assert port_cli(["train", "--family", "eend_vc", "--train-dir", tr["data_dir"], "--valid-dir", va["data_dir"],
                     "--exp-dir", exp, "--device", "cpu"] + [a for kv in sets for a in ("--set", kv)]) == 0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if r["kind"] == "train"] == [1, 2] and any(r["kind"] == "valid" for r in recs)
    assert all(np.isfinite(r["loss"]) and "spk_loss" in r for r in recs if r["kind"] == "train")
    assert all(np.isfinite(r["loss"]) for r in recs if r["kind"] == "valid")
    with open(os.path.join(exp, "train_config.json")) as f:
        assert json.load(f)["all_n_speakers"] == 6  # the training corpus's speakers
    for num_spks in ("-1", "0", "2"):
        capsys.readouterr()
        assert port_cli(["infer", "--data-dir", va["data_dir"], "--exp-dir", exp, "--out", hyp, "--device", "cpu",
                         "--threshold-sweep", "--ref", va["rttm"], "--num-spks", num_spks, "--sil-spk-th", "0.2"]) == 0
        out = capsys.readouterr().out
        assert sum(ln.startswith("threshold ") for ln in out.splitlines()) == 18 and "best threshold" in out
    assert port_cli(["score", "--ref", va["rttm"], "--sys", f"{hyp}_0.50"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()[-1].split("/")) == 4
