"""The CLI gaps the port closes, against the JAX package's CLI: the default
family (eend in both), `config-dump` in its three formats, the carried-over
CDER scorer with `score --cder` and `infer --threshold-sweep --cder`,
`simulate-meetings`, several comma-separated `--train-dir` corpora for
TS-VAD, and a `train` → `infer --threshold-sweep --cder` → `score --cder`
chain for each newly ported backend, speech encoder and EEND-EDA encoder."""

import argparse
import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

from speaker_diarization_tpu.cli import main as JCLI
from speaker_diarization_tpu.data.eend_dataset import ConcatChunkDataset as JConcat
from speaker_diarization_tpu.data.tsvad_dataset import TSVADChunkDataset as JDataset
from speaker_diarization_tpu.data.tsvad_dataset import tsvad_batch_iterator as j_batches
from speaker_diarization_tpu.infer.embeddings import EmbeddingStore as JStore
from speaker_diarization_tpu.score import cder as JCder
from speaker_diarization_tpu_torch.cli import main as C
from speaker_diarization_tpu_torch.data import simulate
from speaker_diarization_tpu_torch.data.eend_dataset import ConcatChunkDataset
from speaker_diarization_tpu_torch.data.rttm import Turn, write_rttm
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.data.tsvad_dataset import TSVADChunkDataset, tsvad_batch_iterator
from speaker_diarization_tpu_torch.infer.embeddings import EmbeddingStore
from speaker_diarization_tpu_torch.score import cder

torch.set_num_threads(1)

# TrainCliConfig fields of the JAX CLI that belong to what the port has not
# ported yet: the mesh
JAX_ONLY = {"n_data"}
SETS = [[], ["family=tsvad", "remat=true", "d_ff=512", "learning_rate=1e-3", "encoder_blocks=12,24,16"],
        ["encoder_type=conformer", "bf16=true", "rs_len=4.0", "speech_encoder_type=ecapa"],
        ["family=ssnd", "ssnd_overlap_prob=0.4", "ssnd_sil_scale=2.0", "ssnd_arcface_weight=0.05",
         "ssnd_real_ratio=0.25"]]


def _jax_dump(capsys, sets, fmt):
    JCLI.cmd_config_dump(argparse.Namespace(config=None, set=list(sets), format=fmt))
    return capsys.readouterr().out


def _port_dump(capsys, sets, fmt):
    assert C.main(["config-dump", "--format", fmt] + [a for kv in sets for a in ("--set", kv)]) == 0
    return capsys.readouterr().out


def _lines_by_key(text, sep):
    return {line.split(sep, 1)[0]: line for line in text.strip().splitlines()}


@pytest.mark.parametrize("fmt", ["json", "bash", "yaml"])
@pytest.mark.parametrize("sets", SETS, ids=["defaults", "tsvad", "conformer", "ssnd"])
def test_config_dump_matches_jax(capsys, fmt, sets):
    """The same argv prints the same value for every key the port has; the
    keys only JAX prints are those of its unported families."""
    want, got = _jax_dump(capsys, sets, fmt), _port_dump(capsys, sets, fmt)
    if fmt == "json":
        w, g = json.loads(want), json.loads(got)
        assert set(w) - set(g) == JAX_ONLY and set(g) <= set(w)
        assert {k: w[k] for k in g} == g
        return
    sep = "=" if fmt == "bash" else ": "
    w, g = _lines_by_key(want, sep), _lines_by_key(got, sep)
    assert set(w) - set(g) == JAX_ONLY and set(g) <= set(w)
    for k in g:
        assert g[k] == w[k], k
    # the printed order is the dataclass's, with the JAX-only keys left out
    assert list(g) == [k for k in w if k not in JAX_ONLY]


@pytest.mark.parametrize("family", ["vad", "enhance"])
@pytest.mark.parametrize("verb", ["infer"])
def test_families_not_ported_are_refused(tmp_path, family, verb):
    """`infer` has no port of the system SAD and the enhancer (the JAX CLI
    has no infer for them either): it refuses such a run by name, not as
    another family, and names the verb that exports it."""
    with open(tmp_path / C.TRAIN_CONFIG, "w") as f:
        json.dump(dataclasses.asdict(C.TrainCliConfig(family=family)), f)
    want = {"vad": "export-vad", "enhance": "export-enhancer"}[family]
    with pytest.raises(SystemExit, match=f"is a {family} run, which is not inferred: export it with {want}"):
        C.main([verb, "--data-dir", str(tmp_path), "--exp-dir", str(tmp_path), "--out", "o", "--device", "cpu"])


@pytest.mark.parametrize("family", ["vad", "enhance"])
def test_vad_and_enhance_train_build_their_models(tmp_path, family, monkeypatch):
    """`train` builds the system SAD's and the enhancer's models (NeuralVAD,
    MaskDenoiser) by name, not another family's."""
    from speaker_diarization_tpu_torch.models.enhancer import MaskDenoiser
    from speaker_diarization_tpu_torch.models.vad import NeuralVAD
    from speaker_diarization_tpu_torch.train import loop

    seen = []
    monkeypatch.setattr(loop, "run_training", lambda trainer, *a, **k: seen.append(trainer.model))
    if family == "vad":
        c = write_synthetic_corpus(str(tmp_path / "c"), n_recs=1, seconds=6.0, rate=8000, n_speakers=2, emb_dim=8,
                                   seed=1)
        argv = ["--train-dir", c["data_dir"], "--set", "chunk_frames=200", "--set", "sample_rate=8000"]
    else:
        from speaker_diarization_tpu_torch.data import simulate

        src = simulate.synthesize_speaker_corpus(str(tmp_path / "src"), n_speakers=2, utts_per_speaker=1, seed=1)
        noise = simulate.synthesize_noise_corpus(str(tmp_path / "noise"), n_noises=1, dur=2.0, seed=2)
        argv = ["--train-dir", src, "--noise-dir", noise]
    assert C.main(["train", "--exp-dir", str(tmp_path / "x"), "--set", f"family={family}", "--device", "cpu"]
                  + argv) == 0
    assert len(seen) == 1 and isinstance(seen[0], {"vad": NeuralVAD, "enhance": MaskDenoiser}[family])


def test_default_family_is_eend_as_in_jax(tmp_path, monkeypatch):
    """No --family and no --config: both CLIs resolve eend, and `train`
    builds an EENDModel."""
    from speaker_diarization_tpu_torch.models.eend import EENDModel
    from speaker_diarization_tpu_torch.train import loop

    assert C.TrainCliConfig().family == JCLI.TrainCliConfig().family == "eend"
    args = C.build_parser().parse_args(["train", "--train-dir", "x", "--exp-dir", "y"])
    assert args.family is None and C._cli_config(args, C.TrainCliConfig()).family == "eend"
    c = write_synthetic_corpus(str(tmp_path / "train"), n_recs=2, seconds=8.0, rate=8000, n_speakers=2, emb_dim=16,
                               seed=1, prefix="tr")
    seen = []
    monkeypatch.setattr(loop, "run_training", lambda trainer, *a, **k: seen.append(trainer.model))
    sets = ["d_model=16", "n_layers=1", "n_heads=2", "d_ff=32", "chunk_frames=30", "batch_size=2", "num_steps=1"]
    assert C.main(["train", "--train-dir", c["data_dir"], "--exp-dir", str(tmp_path / "exp"), "--device", "cpu"]
                  + [a for kv in sets for a in ("--set", kv)]) == 0
    assert len(seen) == 1 and isinstance(seen[0], EENDModel)


# ---------------------------------------------------------------------------
# CDER
# ---------------------------------------------------------------------------


def _rttms(tmp_path, seed):
    """A reference and a hypothesis with misses, splits, false alarms and a
    wrong speaker over two recordings."""
    rng = np.random.default_rng(seed)
    ref, hyp = [], []
    for rec in ("r1", "r2"):
        t = 0.0
        for i in range(12):
            d = float(rng.uniform(0.5, 3.0))
            spk = "ABC"[int(rng.integers(3))]
            ref.append(Turn(rec, round(t, 2), round(d, 2), spk))
            u = rng.random()
            if u < 0.6:
                hyp.append(Turn(rec, round(t + rng.uniform(-0.2, 0.2), 2), round(d, 2), "s" + spk.lower()))
            elif u < 0.75:
                hyp.append(Turn(rec, round(t, 2), round(d / 2, 2), "sx"))
            elif u < 0.9:
                hyp.append(Turn(rec, round(t + d + 5, 2), 0.7, "sa"))
            t += d + float(rng.uniform(-0.3, 1.0))
    r, h = str(tmp_path / "ref.rttm"), str(tmp_path / "hyp.rttm")
    write_rttm(r, ref)
    write_rttm(h, hyp)
    return r, h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cder_copies_agree(tmp_path, seed):
    r, h = _rttms(tmp_path, seed)
    got, want = cder.score_cder(r, h), JCder.score_cder(r, h)
    assert got == want and 0.0 < got["avg"] < 1.0
    assert cder.score_cder(r, r)["avg"] == JCder.score_cder(r, r)["avg"] == 0.0


def test_score_cder_prints_as_jax(tmp_path, capsys):
    r, h = _rttms(tmp_path, 3)
    JCLI.cmd_score(argparse.Namespace(ref=r, sys=h, collar=0.25, overlap_limit=False, regions="all", uem=None,
                                      per_file=True, cder=True))
    want = capsys.readouterr().out
    assert C.main(["score", "--ref", r, "--sys", h, "--per-file", "--cder"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.strip().splitlines()[-1].startswith("CDER avg = ")


# ---------------------------------------------------------------------------
# simulate-meetings and several --train-dir corpora
# ---------------------------------------------------------------------------


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read().replace(root.encode(), b"<root>")
    return out


def test_simulate_meetings_matches_jax(tmp_path):
    src = simulate.synthesize_speaker_corpus(str(tmp_path / "src"), n_speakers=5, utts_per_speaker=3, rate=8000,
                                             seed=0)
    noise = simulate.synthesize_noise_corpus(str(tmp_path / "noise"), n_noises=2, rate=8000, dur=3.0)
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    JCLI.cmd_simulate_meetings(argparse.Namespace(out=a, source_dir=src, noise_dir=noise, rir_dir=None, dynamics=None,
                                                  rate=8000, seed=4))
    assert C.main(["simulate-meetings", "--out", b, "--source-dir", src, "--noise-dir", noise, "--seed", "4"]) == 0
    ta, tb = _tree(a), _tree(b)
    assert ta.keys() == tb.keys() and "data/rttm" in ta
    for k in ta:
        assert ta[k] == tb[k], k


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_gaps"))
    out = {}
    for name, seed, n in (("a", 3, 2), ("b", 4, 1), ("valid", 5, 1)):
        out[name] = write_synthetic_corpus(os.path.join(root, name), n_recs=n, seconds=12.0, rate=8000, n_speakers=3,
                                           emb_dim=192, seed=seed, prefix=name)
    out["root"] = root
    return out


def test_two_train_dirs_batch_as_jax_concat(corpora):
    """Two corpora concatenated: the same items, augmentation and batch
    order as the JAX ConcatChunkDataset, two epochs."""
    a, b = corpora["a"], corpora["b"]
    kw = dict(rs_len=2.0, segment_shift=1.0, rate=8000, is_train=True, seed=3)
    store = EmbeddingStore.load(f"{a['emb_store']},{b['emb_store']}")
    jstores = [JStore.load(p) for p in (a["emb_store"], b["emb_store"])]
    jstores[0].data.update(jstores[1].data)
    port = ConcatChunkDataset([TSVADChunkDataset(c["data_dir"], store, **kw) for c in (a, b)])
    ref = JConcat([JDataset(c["data_dir"], jstores[0], **kw) for c in (a, b)])
    assert len(port) == len(ref) > len(port.datasets[0])
    for epoch in (0, 1):
        got = list(tsvad_batch_iterator(port, 4, True, seed=3, epoch=epoch))
        want = list(j_batches(ref, 4, True, seed=3, epoch=epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for k in ("audio", "target_embs", "labels"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"epoch {epoch} {k}")


# ---------------------------------------------------------------------------
# train → infer --threshold-sweep --cder → score --cder, per new model part
# ---------------------------------------------------------------------------

TSVAD_SETS = ["encoder_blocks=1,1", "n_layers=1", "d_ff=32", "batch_size=4", "log_every=1", "valid_every=2",
              "schedule=poly", "learning_rate=1e-3", "warmup_steps=1", "n_mels=80", "rs_len=2.0", "segment_shift=1.0",
              "num_steps=2"]
CHAINS = {
    "tsvad_conformer": ("tsvad", ["single_backend_type=conformer", "multi_backend_type=conformer"]),
    "tsvad_lstm": ("tsvad", ["multi_backend_type=lstm"]),
    "tsvad_ecapa": ("tsvad", ["speech_encoder_type=ecapa", "n_mels=24"]),
    "tsvad_resnet34": ("tsvad", ["speech_encoder_type=resnet34", "n_mels=24"]),
    "tsvad_simam_resnet34": ("tsvad", ["speech_encoder_type=simam_resnet34", "n_mels=24"]),
    "eda_conformer": ("eend_eda", ["encoder_type=conformer", "d_model=16", "n_layers=1", "n_heads=2", "d_ff=32",
                                   "chunk_frames=30", "batch_size=2", "num_steps=2", "log_every=1",
                                   "valid_every=2", "n_speakers=3"]),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_cli_chain_with_cder(corpora, name, capsys):
    family, sets = CHAINS[name]
    a, b, v = corpora["a"], corpora["b"], corpora["valid"]
    exp = os.path.join(corpora["root"], name)
    argv = ["train", "--family", family, "--valid-dir", v["data_dir"], "--exp-dir", exp, "--device", "cpu"]
    if family == "tsvad":  # two corpora at once
        sets = TSVAD_SETS + sets
        argv += ["--train-dir", f"{a['data_dir']},{b['data_dir']}",
                 "--emb-store", f"{a['emb_store']},{b['emb_store']},{v['emb_store']}"]
    else:
        argv += ["--train-dir", a["data_dir"]]
    assert C.main(argv + [a for kv in sets for a in ("--set", kv)]) == 0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if r["kind"] == "train"] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
    out = os.path.join(corpora["root"], f"hyp_{name}")
    infer = ["infer", "--data-dir", v["data_dir"], "--exp-dir", exp, "--out", out, "--device", "cpu",
             "--threshold-sweep", "--ref", v["rttm"], "--cder"]
    if family == "tsvad":
        infer += ["--emb-store", v["emb_store"]]
    capsys.readouterr()
    assert C.main(infer) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("threshold ")]
    assert len(lines) == 18
    for ln in lines:  # the JAX sweep's line: "threshold 0.50: <DER summary>  CDER 0.123"
        m = re.fullmatch(r"threshold (\d\.\d\d): .+  CDER (\d+\.\d{3}|nan)", ln)  # nan: an empty RTTM
        assert m, ln
        hyp = f"{out}_{m.group(1)}"
        assert m.group(2) == f"{JCder.score_cder(v['rttm'], hyp)['avg']:.3f}"
    assert C.main(["score", "--ref", v["rttm"], "--sys", f"{out}_0.50", "--cder"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("CDER avg = ")
