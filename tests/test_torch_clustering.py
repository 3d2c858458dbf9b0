"""Port parity of the clustering back-ends: the port's copies of the
numpy-only JAX modules (infer/vbx.py, infer/umap_native.py,
infer/hdbscan_native.py and the copied parts of infer/clustering.py), its
own k-means in place of scikit-learn's, `spectral_cluster` with the
eigendecomposition on a torch device, `cluster_recording` by VBx and by
spectral clustering, and the CLI's `estimate-plda` → `cluster`, against the
JAX package.

Tolerances: the copies bitwise, or 1e-12 where float64 sums may reorder;
k-means by partition (equal up to relabelling on every separated set) and
by inertia (within 1e-6 relative of scikit-learn's on at least 95% of the
unclustered sets, never more than 1% above); turns and PLDA arrays to
1e-9 and 1e-12."""

import importlib
import os

import numpy as np
import pytest
import torch
from sklearn.cluster import k_means

from speaker_diarization_tpu.cli import main as JCLI
from speaker_diarization_tpu.infer import clustering as JC
from speaker_diarization_tpu.infer import hdbscan_native as JH
from speaker_diarization_tpu.infer import umap_native as JU
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data import simulate
from speaker_diarization_tpu_torch.data.rttm import Turn, read_rttm, write_rttm
from speaker_diarization_tpu_torch.infer import clustering as C
from speaker_diarization_tpu_torch.infer import hdbscan_native as H
from speaker_diarization_tpu_torch.infer import umap_native as U
from speaker_diarization_tpu_torch.infer import vbx as V
from speaker_diarization_tpu_torch.score import score_der

# the JAX package's infer/__init__ exports the function `vbx` under the module's name
JV = importlib.import_module("speaker_diarization_tpu.infer.vbx")
torch.set_num_threads(1)


def _same_partition(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def _separated(seed: int):
    """2-6 clusters of 5-60 cosine-similar 32-d embeddings."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 7))
    centers = rng.standard_normal((k, 32))
    sizes = rng.integers(5, 61, k)
    X = np.concatenate([c + 0.15 * np.linalg.norm(c) / np.sqrt(32) * rng.standard_normal((n, 32))
                        for c, n in zip(centers, sizes)])
    return X, np.repeat(np.arange(k), sizes), k


def _plda_case(seed=0, n_spk=5, per=30, dim=12):
    rng = np.random.default_rng(seed)
    means = 3.0 * rng.standard_normal((n_spk, dim))
    labels = np.repeat(np.arange(n_spk), per)
    return means[labels] + rng.standard_normal((len(labels), dim)), labels


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------


def test_vbx_copy_matches_jax():
    embs, labels = _plda_case()
    want, got = JV.estimate_plda(embs, labels, dim=8), V.estimate_plda(embs, labels, dim=8)
    for k in ("mu", "tr", "psi"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=0, atol=1e-12, err_msg=k)
    rng = np.random.default_rng(1)
    log_p = rng.standard_normal((40, 3))
    log_tr = np.log(np.full((3, 3), 0.05) + 0.85 * np.eye(3))
    log_pi = np.log(np.full(3, 1 / 3))
    for g, w in zip(V.forward_backward_log(log_p, log_tr, log_pi), JV.forward_backward_log(log_p, log_tr, log_pi)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    X = want.transform(embs)
    r1 = V.vbx(X, want.psi, max_speakers=5, max_iters=5)
    r2 = JV.vbx(X, want.psi, max_speakers=5, max_iters=5)
    np.testing.assert_allclose(r1.gamma, r2.gamma, rtol=0, atol=1e-12)
    np.testing.assert_allclose(r1.pi, r2.pi, rtol=0, atol=1e-12)
    init = (labels + (rng.random(len(labels)) < 0.2)) % 5  # a perturbed start
    (l1, res1), (l2, res2) = V.vbx_resegment(embs, init, want), JV.vbx_resegment(embs, init, want)
    assert np.array_equal(l1, l2) and _same_partition(l1, labels)
    np.testing.assert_allclose(res1.elbos, res2.elbos, rtol=0, atol=1e-9)


def test_umap_and_hdbscan_copies_match_jax():
    """Small sets: the native UMAP's SGD is a Python loop (~0.1 s a point)."""
    rng = np.random.default_rng(3)
    X = np.concatenate([c + 0.1 * rng.standard_normal((8, 16)) for c in rng.standard_normal((3, 16))])
    kw = dict(n_components=4, metric="cosine", n_epochs=60, seed=0)
    Z1, Z2 = U.umap_embed(X, **kw), JU.umap_embed(X, **kw)
    assert np.array_equal(Z1, Z2)
    h1, h2 = H.hdbscan_cluster(Z1, min_cluster_size=4), JH.hdbscan_cluster(Z2, min_cluster_size=4)
    assert np.array_equal(h1, h2)
    # the JAX module runs these natives when the umap and hdbscan packages are absent
    got = C.density_cluster(X)
    assert np.array_equal(got, JC.density_cluster(X)) and _same_partition(got, np.repeat(np.arange(3), 8))
    noisy = rng.integers(0, 6, len(X))
    assert np.array_equal(C.pahc_merge(X, noisy), JC.pahc_merge(X, noisy))


def test_sad_and_subsegments_copies_match_jax():
    rng = np.random.default_rng(5)
    rate = 8000
    gate = np.repeat(rng.random(40) < 0.5, rate // 4)
    audio = (0.0003 * rng.standard_normal(len(gate)) + 0.2 * gate * np.sin(np.arange(len(gate)) * 0.3)).astype(
        np.float32)
    sad = C.energy_vad(audio, rate)
    assert sad == JC.energy_vad(audio, rate) and len(sad) >= 2
    subs = C.make_subsegments(sad + [(12.0, 12.1), (13.0, 16.3)])
    assert [(s.start, s.end) for s in subs] == [(s.start, s.end) for s in JC.make_subsegments(sad + [(12.0, 12.1),
                                                                                                    (13.0, 16.3)])]
    turns = [Turn("r", 0.5, 1.0, "a"), Turn("r", 1.2, 2.0, "b"), Turn("r", 5.0, 0.0, "a")]
    assert C.oracle_sad(turns) == JC.oracle_sad(turns) == [(0.5, 3.2)]


# ---------------------------------------------------------------------------
# k-means without scikit-learn
# ---------------------------------------------------------------------------


def test_spectral_partitions_match_jax_on_separated_sets():
    """The port's spectral_cluster (its own k-means) and the JAX one
    (scikit-learn's k_means) give the same partition on 200 seeded sets."""
    for seed in range(200):
        X, _, _ = _separated(seed)
        got, want = C.spectral_cluster(X), JC.spectral_cluster(X)
        assert _same_partition(got, want), seed


def test_kmeans_inertia_matches_sklearn_on_unclustered_sets():
    """On 100 seeded sets of Gaussian features (no cluster structure, many
    local optima) the port's inertia is within 1e-6 relative of
    scikit-learn's on at least 95 and never more than 1% above."""
    close, worst = 0, -np.inf
    for seed in range(100):
        rng = np.random.default_rng(1000 + seed)
        n, k = int(rng.integers(10, 120)), int(rng.integers(2, 7))
        X = rng.standard_normal((n, k))
        _, labels, inertia = C.kmeans(X, k)
        _, _, want = k_means(X, k, n_init=10, random_state=0)
        rel = (inertia - want) / want
        close += abs(rel) <= 1e-6
        worst = max(worst, rel)
        assert labels.dtype == np.int32 and len(set(labels.tolist())) == k
    assert close >= 95 and worst <= 0.01, (close, worst)


# ---------------------------------------------------------------------------
# cluster_recording and the CLI
# ---------------------------------------------------------------------------


def _spectrum(b):
    sp = np.abs(np.fft.rfft(b, axis=-1))[:, :512]
    return sp / (np.linalg.norm(sp, axis=-1, keepdims=True) + 1e-9)


def _recording(seed=7, rate=8000, seconds=30.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    audio = 0.005 * rng.standard_normal(len(t))
    turns, s = [], 0.0
    while s < seconds - 1.0:
        spk = int(rng.integers(0, 3))
        d = float(rng.uniform(1.5, 4.0))
        e = min(s + d, seconds)
        f0 = 120.0 + 90.0 * spk
        seg = slice(int(s * rate), int(e * rate))
        audio[seg] += sum(0.1 / h * np.sin(2 * np.pi * f0 * h * t[seg]) for h in range(1, 5))
        turns.append(Turn("rec", s, e - s, f"s{spk}"))
        s = e + float(rng.uniform(0.0, 0.6))
    return audio.astype(np.float32), rate, turns


def _canonical(turns):
    names = {}
    for t in turns:
        names.setdefault(t.speaker, len(names))
    return [(round(t.start, 9), round(t.dur, 9), names[t.speaker]) for t in turns]


@pytest.mark.parametrize("method", ["vbx", "spectral"])
def test_cluster_recording_matches_jax(method, tmp_path):
    audio, rate, ref = _recording()
    sad = C.oracle_sad(ref)
    plda = None
    if method == "vbx":
        subs = C.make_subsegments(sad)
        wins = np.stack([np.pad(audio[int(s.start * rate): int(s.end * rate)], (0, int(1.5 * rate)))[: int(1.5 * rate)]
                         for s in subs])
        mid = [(s.start + s.end) / 2 for s in subs]
        lab = [next((int(t.speaker[1:]) for t in ref if t.start <= m < t.end), 0) for m in mid]
        plda = V.estimate_plda(_spectrum(wins), np.asarray(lab), dim=16)
    got = C.cluster_recording(audio, rate, _spectrum, "rec", sad=sad, method=method, plda=plda)
    want = JC.cluster_recording(audio, rate, _spectrum, "rec", sad=sad, method=method, plda=plda)
    assert len(got) > 3 and _canonical(got) == _canonical(want)
    write_rttm(str(tmp_path / "got.rttm"), got)
    write_rttm(str(tmp_path / "want.rttm"), want)
    assert score_der(str(tmp_path / "want.rttm"), str(tmp_path / "got.rttm"), collar=0.0).der == 0.0


def test_cli_estimate_plda_then_cluster_vbx_matches_jax(tmp_path, capsys):
    """`estimate-plda` on the labelled voice pool, then `cluster --method vbx`
    (and spectral) with oracle SAD and the spectrum encoder: the PLDA and the
    RTTMs equal the JAX CLI's (UMAP's recordings are too slow for this file:
    test_umap_and_hdbscan_copies_match_jax holds density_cluster)."""
    root = str(tmp_path)
    data = simulate.simulate_corpus(os.path.join(root, "c"), n_mixtures=2, n_speakers=2, rate=8000, seed=1,
                                    src_speakers=4, utts_per_speaker=3)
    src = os.path.join(root, "c", "src")
    common = ["--encoder", "spectrum", "--rate", "8000"]
    assert port_cli(["estimate-plda", "--data-dir", src, "--out", f"{root}/plda.npz", "--plda-dim", "16",
                     "--device", "cpu"] + common) == 0
    jp = JCLI.build_parser().parse_args(["estimate-plda", "--data-dir", src, "--out", f"{root}/jplda.npz",
                                         "--plda-dim", "16"] + common)
    assert jp.fn(jp) == 0
    with np.load(f"{root}/plda.npz") as g, np.load(f"{root}/jplda.npz") as w:
        assert sorted(g.files) == sorted(w.files) == ["mu", "psi", "tr"] and g["tr"].shape == (16, 512)
        for k in w.files:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-12, err_msg=k)
    for method in ("vbx", "spectral"):
        argv = ["cluster", "--data-dir", data, "--method", method, "--plda", f"{root}/plda.npz", "--sad", "oracle",
                "--ref", f"{data}/rttm"] + common
        capsys.readouterr()
        assert port_cli(argv + ["--out", f"{root}/{method}.rttm", "--device", "cpu"]) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert line.startswith("DER ") and " SC " in line
        ja = JCLI.build_parser().parse_args(argv + ["--out", f"{root}/j_{method}.rttm"])
        assert ja.fn(ja) == 0
        got, want = read_rttm(f"{root}/{method}.rttm"), read_rttm(f"{root}/j_{method}.rttm")
        assert got and _canonical(got) == _canonical(want), method


def test_cluster_refusals_and_isolation(tmp_path, monkeypatch):
    """vbx needs --plda; the entry points need the card unless asked for
    the CPU; no scikit-learn is reached."""
    data = simulate.simulate_corpus(str(tmp_path / "c"), n_mixtures=1, n_speakers=2, rate=8000, seed=2,
                                    src_speakers=2, utts_per_speaker=2)
    with pytest.raises(SystemExit, match="requires --plda"):
        port_cli(["cluster", "--data-dir", data, "--out", str(tmp_path / "o"), "--method", "vbx", "--encoder",
                  "spectrum", "--rate", "8000", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["cluster", "--data-dir", data, "--out", str(tmp_path / "o")],
                 ["estimate-plda", "--data-dir", data, "--out", str(tmp_path / "p.npz")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli(argv)
    import sys

    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    X, truth, _ = _separated(9)
    assert _same_partition(C.spectral_cluster(X), truth)
