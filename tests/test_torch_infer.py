"""Port parity: the inference pipeline (data → overlap voting → RTTM → DER)."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.data import rttm as JRttm
from speaker_diarization_tpu.data.tsvad_dataset import TSVADChunkDataset as JDataset
from speaker_diarization_tpu.infer.chunked import tsvad_infer_dataset as j_infer
from speaker_diarization_tpu.infer.embeddings import EmbeddingStore as JStore
from speaker_diarization_tpu.models.tsvad import TSVADConfig as JConfig
from speaker_diarization_tpu.models.tsvad import TSVADModel as JModel
from speaker_diarization_tpu.postproc import probs_to_turns as j_probs_to_turns
from speaker_diarization_tpu.score import score_der as j_score_der
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data import rttm as TRttm
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.data.tsvad_dataset import TSVADChunkDataset
from speaker_diarization_tpu_torch.infer.chunked import make_tsvad_predict, tsvad_infer_dataset
from speaker_diarization_tpu_torch.infer.embeddings import EmbeddingStore
from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
from speaker_diarization_tpu_torch.postproc import probs_to_turns
from speaker_diarization_tpu_torch.score import score_der
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
SMALL = dict(
    encoder_block_layers=(1, 1, 1), transformer_embed_dim=64, transformer_ffn_embed_dim=128,
    num_attention_head=4, speaker_embed_dim=32, num_transformer_layer=1,
)
RS_LEN, SHIFT = 4.0, 1.0  # the CLI's window and the JAX CLI's --infer-shift default


def test_read_rttm_and_probs_to_turns_match():
    for name in ("ref.rttm", "hyp.rttm"):
        assert TRttm.read_rttm(os.path.join(FIX, name)) == [
            TRttm.Turn(t.rec, t.start, t.dur, t.speaker) for t in JRttm.read_rttm(os.path.join(FIX, name))
        ]
    rng = np.random.default_rng(0)
    probs = rng.random((400, 3)).astype(np.float32)
    for kw in (dict(threshold=0.5, median=11), dict(threshold=0.3, median=1, fill_gap=5, min_dur=3)):
        a = probs_to_turns(probs, "r1", 0.04, speakers=["a", "b", "c"], **kw)
        b = j_probs_to_turns(probs, "r1", 0.04, speakers=["a", "b", "c"], **kw)
        assert [tuple(vars(t).values()) for t in a] == [tuple(vars(t).values()) for t in b]


@pytest.mark.parametrize("collar", ["0.0", "0.25"])
def test_score_der_matches_mdeval_golden(collar):
    with open(os.path.join(FIX, "mdeval_golden.json")) as f:
        golden = json.load(f)[collar]
    res = score_der(os.path.join(FIX, "ref.rttm"), os.path.join(FIX, "hyp.rttm"), collar=float(collar))
    ref = j_score_der(os.path.join(FIX, "ref.rttm"), os.path.join(FIX, "hyp.rttm"), collar=float(collar))
    assert abs(100 * res.der - golden["der"]) < 0.015
    assert abs(100 * res.miss_rate - golden["ms"]) < 0.015
    assert abs(100 * res.falarm_rate - golden["fa"]) < 0.015
    assert abs(100 * res.confusion_rate - golden["sc"]) < 0.015
    assert res.der == pytest.approx(ref.der, abs=1e-12)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    return write_synthetic_corpus(d, n_recs=2, seconds=8.0, rate=16000, n_speakers=3, emb_dim=32, seed=3)


@pytest.fixture(scope="module")
def weights(corpus, tmp_path_factory):
    """JAX TS-VAD variables (perturbed statistics), saved as a flax npz."""
    jmodel = JModel(cfg=JConfig(**SMALL))
    v = jax.jit(jmodel.init, static_argnums=3)(jax.random.PRNGKey(0), jnp.zeros((1, 16000)), jnp.zeros((1, 4, 32)), 25)
    rng = np.random.default_rng(1)
    v = {
        "params": jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), v["params"]),
        "batch_stats": jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float32) + 0.1 * np.abs(rng.standard_normal(x.shape)).astype(np.float32),
            v["batch_stats"],
        ),
    }
    path = os.path.join(str(tmp_path_factory.mktemp("w")), "params.npz")
    convert.save_flax_npz(path, v)
    return jmodel, v, path


def test_dataset_eval_items_match(corpus):
    a = TSVADChunkDataset(corpus["data_dir"], EmbeddingStore.load(corpus["emb_store"]), rs_len=RS_LEN, segment_shift=SHIFT)
    b = JDataset(corpus["data_dir"], JStore.load(corpus["emb_store"]), rs_len=RS_LEN, segment_shift=SHIFT, is_train=False)
    assert len(a) == len(b) > 0
    assert a.rec_speakers == b.rec_speakers
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], np.ndarray):
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            else:
                assert x[k] == y[k], k
    # the JAX CLI's comment offers a 'dsp' enhancer that its get_enhancer refuses (ROADMAP §3); the port refuses it too
    with pytest.raises(ValueError, match="unknown enhancer: 'dsp'"):
        TSVADChunkDataset(corpus["data_dir"], EmbeddingStore.load(corpus["emb_store"]), is_train=True, enhancer="dsp")
    with pytest.raises(ValueError, match="unknown enhancer: 'dsp'"):
        JDataset(corpus["data_dir"], JStore.load(corpus["emb_store"]), is_train=True, enhancer="dsp")


def _jax_probs(jmodel, v, corpus):
    T = int(RS_LEN * 25)
    fn = jax.jit(lambda a, e: jax.nn.sigmoid(jmodel.apply(v, a, e, T, train=False)))
    ds = JDataset(corpus["data_dir"], JStore.load(corpus["emb_store"]), rs_len=RS_LEN, segment_shift=SHIFT, is_train=False)
    return j_infer(lambda a, e: np.asarray(fn(jnp.asarray(a), jnp.asarray(e))), ds), ds


def test_overlap_voted_probs_and_cli_der_match_jax(corpus, weights, tmp_path, capsys):
    jmodel, v, params_path = weights
    ref_probs, jds = _jax_probs(jmodel, v, corpus)

    model = TSVADModel(TSVADConfig(**SMALL), device="cpu")
    model.load_state_dict(convert.tsvad_from_flax(convert.load_flax_npz(params_path)))
    ds = TSVADChunkDataset(corpus["data_dir"], EmbeddingStore.load(corpus["emb_store"]), rs_len=RS_LEN, segment_shift=SHIFT)
    probs = tsvad_infer_dataset(make_tsvad_predict(model, int(RS_LEN * 25)), ds)
    assert probs.keys() == ref_probs.keys()
    for rec in probs:
        np.testing.assert_allclose(probs[rec], ref_probs[rec], atol=1e-4)

    # JAX library path: sweep thresholds, best DER
    best_ref = None
    for th in [round(0.2 + 0.05 * i, 2) for i in range(16)] + [0.97, 0.98]:
        turns = []
        for rec, p in ref_probs.items():
            turns += j_probs_to_turns(p, rec, 0.04, threshold=th, median=11, speakers=jds.rec_speakers.get(rec))
        out = str(tmp_path / f"jax_{th:.2f}")
        JRttm.write_rttm(out, turns)
        der = j_score_der(corpus["rttm"], out, collar=0.25).der
        best_ref = der if best_ref is None else min(best_ref, der)

    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(SMALL, f)
    rc = port_cli([
        "infer", "--family", "tsvad", "--data-dir", corpus["data_dir"], "--emb-store", corpus["emb_store"],
        "--params", params_path, "--config", cfg_path, "--out", str(tmp_path / "hyp"),
        "--threshold-sweep", "--ref", corpus["rttm"], "--device", "cpu",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    m = re.search(r"best threshold ([0-9.]+) \(DER ([0-9.]+)%\)", out)
    assert m, out
    assert abs(float(m.group(2)) / 100 - best_ref) < 1e-3 + 5e-5  # printed with 2 decimals
    assert os.path.getsize(str(tmp_path / f"hyp_{float(m.group(1)):.2f}")) > 0

    rc = port_cli(["score", "--ref", corpus["rttm"], "--sys", str(tmp_path / "hyp_0.50")])
    assert rc == 0
    assert re.search(r"^[0-9.]+/[0-9.]+/[0-9.]+/[0-9.]+$", capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_window_follows_rs_len(corpus, weights, tmp_path):
    """`--rs-len` sets the window: the CLI's RTTM equals the library path's at 2 s windows."""
    _, _, params_path = weights
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(SMALL, f)
    out = str(tmp_path / "hyp.rttm")
    rc = port_cli([
        "infer", "--family", "tsvad", "--data-dir", corpus["data_dir"], "--emb-store", corpus["emb_store"],
        "--params", params_path, "--config", cfg_path, "--out", out, "--rs-len", "2.0", "--device", "cpu",
    ])
    assert rc == 0

    model = TSVADModel(TSVADConfig(**SMALL), device="cpu")
    model.load_state_dict(convert.tsvad_from_flax(convert.load_flax_npz(params_path)))
    ds = TSVADChunkDataset(corpus["data_dir"], EmbeddingStore.load(corpus["emb_store"]), rs_len=2.0, segment_shift=SHIFT)
    probs = tsvad_infer_dataset(make_tsvad_predict(model, 50), ds, batch_size=16)
    turns = []
    for rec, p in probs.items():
        turns += probs_to_turns(p, rec, 0.04, threshold=0.5, median=11, speakers=ds.rec_speakers.get(rec))
    want = str(tmp_path / "want.rttm")
    TRttm.write_rttm(want, turns)
    assert TRttm.read_rttm(out) == TRttm.read_rttm(want)
    assert TRttm.read_rttm(want)
