"""The JAX trainer's Orbax directories, read by the port (utils/orbax.py:
zstd through ctypes, the OCDBT manifest and B-tree, zarr v2 chunks; no
orbax, tensorstore or zarr) against orbax's own restore (the JAX package's
CheckpointManager):

- a small TrainState (adam state, averaged parameters, BatchNorm
  statistics), leaf for leaf and dtype for dtype, `step` included;
- a full-width TS-VAD TrainState (`TSVADConfig()`, adam state): `params`
  and `batch_stats` equal, `opt_state` not read unless asked;
- a multi-chunk array and a bf16 leaf; a B-tree of many levels written by
  tensorstore with small nodes;
- the errors for a missing or corrupt chunk, a missing data file and no
  zstd library.

Then the CLI: a JAX exp dir with two steps and metrics.json read by the
port's `infer --exp-dir` (best step, --step, --avg-last 2), `export-vad`,
`export-enhancer` and `export-encoder`, each held to the JAX verb on the
same directory; EEND-M2F and FS-EEND stitched probabilities from one JAX
checkpoint against JAX `infer`; and the committed fixture of the smoke's
`[orbax]` phase. Run this file as a script to rewrite that fixture:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_orbax.py
"""

import ctypes
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.cli import main as JCLI
from speaker_diarization_tpu.train.checkpoints import CheckpointManager as JManager
from speaker_diarization_tpu.train.trainer import Trainer as JTrainer
from speaker_diarization_tpu.train.trainer import TrainerConfig as JTrainerConfig
from speaker_diarization_tpu.utils.config import apply_overrides as japply
from speaker_diarization_tpu_torch.cli import main as PCLI
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.train.checkpoints import CheckpointManager
from speaker_diarization_tpu_torch.utils import orbax as O

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_orbax_tsvad")
# the JAX CLI's TS-VAD at its narrowest: one layer a CAM++ block (K2 still runs per block), one
# backend layer of d_ff 32 (the backend width, 384, is no CLI field in either package)
FIXTURE_SETS = ["sample_rate=16000", "encoder_blocks=1,1,1", "n_layers=1", "n_heads=2", "d_ff=32"]
DENSITY = 0.02


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)


def assert_same_tree(mine, ref):
    """The port's tree equals orbax's: the same structure, every leaf equal
    and of the same dtype (bfloat16 leaves come back as float32)."""
    (a, ta), (b, tb) = _flat(mine), _flat(ref)
    assert ta == tb, (ta, tb)
    for (path, x), (_, y) in zip(a, b):
        y = np.asarray(y)
        if y.dtype == jnp.bfloat16:
            y = y.astype(np.float32)
        x = np.asarray(x)
        assert x.dtype == y.dtype and x.shape == y.shape, (jax.tree_util.keystr(path), x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=jax.tree_util.keystr(path))


def _seeded(shapes, seed: int, scale: float = 1.0):
    """Seeded values in the shapes of a flax variables tree: kernels
    N(0, 1/fan_in), positive variances, scales near 1."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if name == "var":
            return (1.0 + 0.2 * rng.random(shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "kernel":
            return (scale * rng.standard_normal(shape) / np.sqrt(max(1, int(np.prod(shape[:-1]))))).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(shapes))


def _jax_cfg(family: str, sets):
    return JCLI._normalize_cfg(japply(JCLI.TrainCliConfig(family=family), list(sets)))


def _save_jax_steps(exp: str, variables: dict, steps: dict, seed: int = 0, whole: bool = False):
    """One TrainState a step (adam state) through the JAX CheckpointManager,
    the weights moved by seeded noise per step; `steps` maps step → metric.
    `whole`: the state's `params` are the whole variables, as the JAX CLI
    keeps them for the EEND families, the VAD and the enhancer."""
    mgr = JManager(exp)
    trainer = JTrainer(lambda p, b, r, t: (0.0, {}), JTrainerConfig(optimizer="adam"))
    rng = np.random.default_rng(seed)
    for step, metric in steps.items():
        params = jax.tree_util.tree_map(
            lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
            variables if whole else variables["params"])
        mutable = {"batch_stats": variables["batch_stats"]} if variables.get("batch_stats") and not whole else None
        state = trainer.init_state(params, mutable=mutable)
        mgr.save(state.replace(step=jnp.asarray(step, jnp.int32)), metric=metric)
    return mgr


def _jax_run(args: list) -> int:
    a = JCLI.build_parser().parse_args(args)
    return a.fn(a)


# ---------------------------------------------------------------------------
# the reader


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    """A TrainState after one adam step, with Polyak-averaged parameters,
    BatchNorm statistics, an int and a uint32 leaf and a 64 x 96 kernel,
    whose chunk lies out of line in a data file."""
    exp = str(tmp_path_factory.mktemp("small"))
    rng = np.random.default_rng(0)
    params = {"dense": {"kernel": rng.standard_normal((64, 96)).astype(np.float32),
                        "bias": rng.standard_normal(96).astype(np.float32)},
              "emb": {"embedding": rng.standard_normal((5, 3)).astype(np.float32)}}
    mutable = {"batch_stats": {"bn": {"mean": rng.standard_normal(96).astype(np.float32),
                                      "var": rng.random(96).astype(np.float32)}}}

    def loss_fn(p, batch, rng_, train):
        return jnp.sum((batch["x"] @ p["dense"]["kernel"] + p["dense"]["bias"]) ** 2) + jnp.sum(
            p["emb"]["embedding"] ** 2), {}

    trainer = JTrainer(loss_fn, JTrainerConfig(optimizer="adam", learning_rate=1e-2, schedule="const"))
    state = trainer.init_state(params, mutable=mutable)
    state, _ = trainer.train_step(state, {"x": jnp.asarray(rng.standard_normal((4, 64)).astype(np.float32))})
    # the JAX trainer cannot step with model_avg_decay under buffer donation (ROADMAP §3): set the copy
    state = state.replace(avg_params=jax.tree_util.tree_map(lambda a: 0.9 * a, state.params))
    mgr = JManager(exp)
    mgr.save(state, metric=1.0)
    return exp, int(state.step)


def test_small_train_state_equals_orbax_restore(small_run):
    exp, step = small_run
    ref = JManager(exp).restore(step)
    mine = O.restore(os.path.join(exp, f"step_{step:010d}"))
    assert_same_tree(mine, ref)
    assert int(mine["step"]) == step == 1 and mine["rng"].dtype == np.uint32
    assert isinstance(mine["opt_state"], list) and mine["opt_state"][1][0]["mu"]["dense"]["kernel"].any()
    mgr = CheckpointManager(exp)  # the port's manager lists and restores the JAX step, read-only
    assert mgr.all_steps() == [step] and mgr.best_step() == step and mgr.is_orbax(step)
    assert_same_tree(mgr.restore(step, select=("params",)), {"params": ref["params"]})


def test_multichunk_and_bf16_leaves(tmp_path):
    """A kernel cut into 4 KB chunks, a bf16 leaf (float32 here, exactly),
    a Python int, and a typed PRNG key, which comes back as its raw uint32
    key data."""
    import orbax.checkpoint as ocp

    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((300, 70)).astype(np.float32), "h": jnp.asarray(rng.standard_normal((5, 7)),
                                                                                    jnp.bfloat16),
            "i": np.arange(12, dtype=np.int64).reshape(3, 4), "count": 3, "key": jax.random.key(3)}
    path = str(tmp_path / "step_0000000001")
    save_args = {k: ocp.SaveArgs(chunk_byte_size=4096 if k == "w" else None) for k in tree}
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, tree, save_args=save_args)
    ckptr.wait_until_finished()
    ref = ckptr.restore(path)
    ck = O.OrbaxCheckpoint(path)
    assert json.loads(ck.store.get("w/.zarray"))["chunks"][0] < 300  # the kernel is cut into chunks
    mine = ck.tree()
    assert_same_tree({k: mine[k] for k in ("w", "h", "i")}, {k: ref[k] for k in ("w", "h", "i")})
    assert mine["count"] == ref["count"] == 3
    assert json.loads(ck.store.get("h/.zarray"))["dtype"] == "bfloat16" and mine["h"].dtype == np.float32
    np.testing.assert_array_equal(mine["key"], np.asarray(jax.random.key_data(tree["key"])))
    assert mine["key"].dtype == np.uint32 and not ck.skipped


def test_many_level_btree_from_tensorstore(tmp_path):
    """A database of 200 keys in nodes of at most 200 bytes: interior nodes
    of several levels, subtree prefixes, inline and out-of-line values."""
    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 200, "max_inline_value_bytes": 16}}).result()
    rng = np.random.default_rng(2)
    want = {f"group{i % 7}/item.{i:04d}/{'x' * (i % 5)}": rng.bytes(int(rng.integers(0, 40))) for i in range(200)}
    txn = ts.Transaction()
    for k, v in want.items():
        kv.with_transaction(txn)[k] = v
    txn.commit_async().result()
    for i in range(5):  # later versions: the reader takes the newest root
        want[f"late{i}"] = rng.bytes(5)
        kv[f"late{i}"] = want[f"late{i}"]
    store = O.OcdbtStore(str(tmp_path))
    assert set(store.index) == {k.encode() for k in want}
    assert all(store.get(k) == v for k, v in want.items())


def test_missing_or_corrupt_chunk_missing_file_and_no_zstd(small_run, tmp_path, monkeypatch):
    exp, step = small_run
    src = os.path.join(exp, f"step_{step:010d}")
    ck = O.OrbaxCheckpoint(src)
    del ck.store.index[b"params.dense.kernel/0.0"]
    with pytest.raises(O.OrbaxFormatError, match=r"chunk 'params.dense.kernel/0.0' is missing"):
        ck.tree(select=("params",))

    bad = str(tmp_path / "bad")
    shutil.copytree(src, bad)
    (base, rel), offset, length = O.OcdbtStore(bad).index[b"params.dense.kernel/0.0"]
    with open(os.path.join(bad, base + rel), "r+b") as f:
        f.seek(offset)
        f.write(b"\0\0\0\0")  # the zstd frame's magic
    with pytest.raises(O.OrbaxFormatError, match=r"chunk 'params.dense.kernel/0.0': zstd error"):
        O.restore(bad, select=("params",))
    os.remove(os.path.join(bad, base + rel))
    with pytest.raises(FileNotFoundError, match="OCDBT data file .*" + rel[2:]):
        O.restore(bad, select=("params",))

    monkeypatch.setattr(O, "_LIBZSTD", None)
    monkeypatch.setattr(O.ctypes.util, "find_library", lambda name: None)

    def no_lib(name, *a, **k):
        raise OSError(name)

    monkeypatch.setattr(O.ctypes, "CDLL", no_lib)
    with pytest.raises(OSError, match=r"zstd C library \(libzstd.so.1\)"):
        O.restore(src)
    monkeypatch.undo()
    assert isinstance(O.libzstd(), ctypes.CDLL)


def test_full_width_tsvad_train_state(tmp_path):
    """TSVADConfig() at full width (17.2 M parameters) with its adam state:
    the port decodes `params` and `batch_stats` equal to orbax's restore and
    reads no `opt_state` chunk, then loads them into its TSVADModel."""
    from speaker_diarization_tpu.models.tsvad import TSVADConfig as JConfig
    from speaker_diarization_tpu.models.tsvad import TSVADModel as JModel
    from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
    from speaker_diarization_tpu_torch.utils.convert import tsvad_from_flax

    jm = JModel(cfg=JConfig())
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16000)), jnp.zeros((1, 4, 192)), 25))
    v = _seeded(shapes, 3)
    exp = str(tmp_path)
    _save_jax_steps(exp, v, {7: 0.5})
    ref = JManager(exp).restore(7)
    ck = O.OrbaxCheckpoint(os.path.join(exp, "step_0000000007"))
    read, get = [], ck.store.get
    ck.store.get = lambda key: read.append(key) or get(key)
    mine = ck.tree(select=("step", "params", "mutable"))
    assert_same_tree(mine, {k: ref[k] for k in ("step", "params", "mutable")})
    assert read and not any(k.startswith("opt_state") for k in read)
    assert any(k.startswith(b"opt_state.1.0.mu.") for k in ck.store.index)
    model = TSVADModel(TSVADConfig(), device="cpu")
    model.load_state_dict(tsvad_from_flax({"params": mine["params"], "batch_stats": mine["mutable"]["batch_stats"]}))
    assert sum(p.numel() for p in model.parameters()) > 17_000_000


# ---------------------------------------------------------------------------
# the CLI on JAX exp dirs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return write_synthetic_corpus(str(root / "data"), n_recs=1, seconds=6.0, rate=8000, n_speakers=2, seed=5,
                                  prefix="or")


EEND_SETS = ["sample_rate=8000", "n_speakers=2", "d_model=16", "n_layers=1", "n_heads=2", "d_ff=32",
             "chunk_frames=200"]


@pytest.fixture(scope="module")
def eend_exp(tmp_path_factory):
    """A JAX EEND run: steps 1 and 2 and metrics.json, step 1 the best."""
    exp = str(tmp_path_factory.mktemp("eend_exp"))
    model = JCLI._build_model(_jax_cfg("eend", EEND_SETS))
    v = _seeded(jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8000)))), 4, scale=2.0)
    v["params"]["head"]["bias"] += 1.5  # probabilities cross the sweep's thresholds, not all below 0.2
    _save_jax_steps(exp, v, {1: 0.25, 2: 0.5}, seed=1, whole=True)
    return exp


def _infer_both(monkeypatch, corpus, exp: str, family: str, sets, extra, out_dir: str):
    """(JAX probabilities, port probabilities, {name: (JAX RTTM, port RTTM)})
    of one `infer --threshold-sweep` (18 thresholds) from the same --exp-dir."""
    import speaker_diarization_tpu.infer as JI

    got = {}
    jax_infer = JI.infer_dataset

    def catch_jax(*a, **k):
        got["jax"] = jax_infer(*a, **k)
        return got["jax"]

    port_probs = PCLI._eend_probs

    def catch_port(*a, **k):
        out = port_probs(*a, **k)
        got["port"] = out[0]
        return out

    monkeypatch.setattr(JI, "infer_dataset", catch_jax)
    monkeypatch.setattr(PCLI, "_eend_probs", catch_port)
    sets = [a for kv in sets for a in ("--set", kv)]
    common = ["--family", family, "--data-dir", corpus["data_dir"], "--exp-dir", exp, "--threshold-sweep"]
    common += sets + extra
    jout, pout = os.path.join(out_dir, "jax.rttm"), os.path.join(out_dir, "port.rttm")
    assert _jax_run(["infer", "--out", jout] + common) == 0
    assert PCLI.main(["infer", "--out", pout, "--device", "cpu"] + common) == 0
    rttms = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("jax.rttm_"):
            with open(os.path.join(out_dir, name)) as f, open(os.path.join(out_dir, "port" + name[3:])) as g:
                rttms[name[9:]] = (f.read(), g.read())
    assert len(rttms) == 18
    return got["jax"], got["port"], rttms


@pytest.mark.parametrize("extra", [[], ["--step", "2"], ["--avg-last", "2"]], ids=["best", "step", "avg_last"])
def test_infer_from_jax_exp_dir_matches_jax_infer(eend_exp, corpus, extra, monkeypatch, tmp_path):
    jp, pp, rttms = _infer_both(monkeypatch, corpus, eend_exp, "eend", EEND_SETS, extra, str(tmp_path))
    assert jp.keys() == pp.keys()
    for rec in jp:
        np.testing.assert_allclose(pp[rec], np.asarray(jp[rec]), rtol=0, atol=1e-4, err_msg=rec)
    assert all(j == p for j, p in rttms.values())
    assert any(j.strip() for j, _ in rttms.values()) and not all(j.strip() for j, _ in rttms.values())


def test_port_manager_never_writes_or_prunes_jax_steps(eend_exp, corpus, tmp_path):
    exp = str(tmp_path / "exp")
    shutil.copytree(eend_exp, exp)
    mgr = CheckpointManager(exp, max_to_keep=1, best_k=0)
    assert mgr.all_steps() == [1, 2] and mgr.best_step() == 1 and mgr.latest_step() == 2
    mgr._prune()
    assert sorted(os.listdir(exp)) == ["metrics.json", "step_0000000001", "step_0000000002"]
    with pytest.raises(SystemExit, match="does not resume"):
        PCLI.main(["train", "--family", "eend", "--train-dir", corpus["data_dir"], "--exp-dir", exp, "--resume",
                   "--device", "cpu"] + [a for kv in EEND_SETS + ["chunk_frames=50"] for a in ("--set", kv)])


@pytest.mark.parametrize("family", ["eend_m2f", "fs_eend"])
def test_m2f_and_fs_eend_stitching_match_jax(family, corpus, monkeypatch, tmp_path):
    """One JAX checkpoint, JAX `infer` and the port's `infer --exp-dir` on
    the same corpus: the chunk-stitched probabilities within 1e-4 and the
    RTTMs of the threshold sweep identical, 0.5 among them (ROADMAP §3: the
    m2f and fs_eend DER gaps are not at inference)."""
    sets = ["sample_rate=8000", "n_speakers=2", "d_model=16", "n_layers=2", "n_heads=2", "d_ff=32",
            "chunk_frames=150" if family == "eend_m2f" else "chunk_frames=40"]
    if family == "fs_eend":
        sets.append("n_mels=23")
    model = JCLI._build_model(_jax_cfg(family, sets))
    v = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8000))))
    exp = str(tmp_path / "exp")
    _save_jax_steps(exp, _seeded(v, 6, scale=2.0), {3: 0.5}, seed=2, whole=True)
    # seeded weights put every query's class probability near 0.13: keep them all, two a frame
    extra = ["--class-threshold", "0.1"] if family == "eend_m2f" else []
    jp, pp, rttms = _infer_both(monkeypatch, corpus, exp, family, sets, extra, str(tmp_path))
    for rec in jp:
        ref = np.asarray(jp[rec])
        assert pp[rec].shape == ref.shape and ref.shape[0] > int(sets[-1].split("=")[1])  # several chunks
        np.testing.assert_allclose(pp[rec], ref, rtol=0, atol=1e-4, err_msg=rec)
        assert (ref > 0.5).any() and (ref < 0.5).any()
    assert all(j == p for j, p in rttms.values()) and rttms["0.50"][0].strip()


def test_exports_from_jax_exp_dirs_match_jax_exports(tmp_path):
    """export-vad, export-enhancer and export-encoder on JAX runs: the port's
    files, read back by the port's readers, equal the JAX verbs' files read
    by the same readers (msgpack for the VAD, npz for the enhancer and the
    encoder)."""
    from speaker_diarization_tpu_torch.models.enhancer import load_enhancer
    from speaker_diarization_tpu_torch.models.spk_embed import load_encoder
    from speaker_diarization_tpu_torch.models.vad import NeuralVAD, NeuralVADConfig, load_vad_params

    key = jax.random.PRNGKey(0)
    runs = {"vad": ([], lambda m: jax.jit(lambda x: m.init(key, x))(jnp.zeros((1, 8000)))),
            "enhance": ([], lambda m: jax.jit(lambda x: m.init(key, x))(jnp.zeros((1, 8000)))),
            "spk": (["encoder_blocks=1,1,1", "n_mels=80", "all_n_speakers=5"],
                    lambda m: jax.jit(lambda x: m.init(key, x, None, False))(jnp.zeros((1, 150, 80))))}
    out = {}
    for i, (family, (sets, init)) in enumerate(runs.items()):
        exp = str(tmp_path / family)
        v = jax.device_get(init(JCLI._build_model(_jax_cfg(family, sets))))
        _save_jax_steps(exp, _seeded(v, 10 + i), {5: 0.1}, seed=i, whole=family != "spk")
        verb = {"vad": "export-vad", "enhance": "export-enhancer", "spk": "export-encoder"}[family]
        set_args = [a for kv in sets for a in ("--set", kv)]
        jpath, ppath = str(tmp_path / f"{family}_jax.npz"), str(tmp_path / f"{family}_port.npz")
        assert _jax_run([verb, "--exp-dir", exp, "--out", jpath] + set_args) == 0
        assert PCLI.main([verb, "--exp-dir", exp, "--out", ppath] + set_args) == 0
        out[family] = (jpath, ppath)

    def vad(path):
        return load_vad_params(path, NeuralVAD(NeuralVADConfig(sample_rate=8000, frame_size=200, frame_shift=80),
                                               device="cpu")).state_dict()

    readers = {"vad": vad, "enhance": lambda p: load_enhancer(p, "cpu").state_dict(),
               "spk": lambda p: load_encoder(p, "cpu")[0].state_dict()}
    with open(out["vad"][0], "rb") as f:
        assert f.read(1)[0] & 0xF0 == 0x80  # the JAX file is flax msgpack (a map), the port's an npz
    for family, (jpath, ppath) in out.items():
        a, b = readers[family](jpath), readers[family](ppath)
        assert a.keys() == b.keys() and len(a) > 4, family
        for k in a:
            torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=f"{family} {k}")


# ---------------------------------------------------------------------------
# the committed fixture of chip_smoke.py [orbax]


def _fixture_input():
    z = np.load(os.path.join(FIXTURE, "jax_logits.npz"))
    return (z["pcm"].astype(np.float32) / 32768.0), z["embs"], int(z["n_label"]), z["logits"]


def test_committed_fixture_matches_jax_restore_and_logits():
    from speaker_diarization_tpu_torch.cli.main import _model_from_exp_dir, build_parser

    with open(os.path.join(FIXTURE, "sets.json")) as f:
        sets = json.load(f)
    assert sets == FIXTURE_SETS
    assert_same_tree(O.restore(os.path.join(FIXTURE, "step_0000000001")), JManager(FIXTURE).restore(1))
    args = build_parser().parse_args(["infer", "--family", "tsvad", "--exp-dir", FIXTURE, "--data-dir", "-",
                                      "--out", "-", "--device", "cpu"] + [a for kv in sets for a in ("--set", kv)])
    model, cfg = _model_from_exp_dir(args, torch.device("cpu"))
    audio, embs, n_label, ref = _fixture_input()
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(audio), torch.from_numpy(embs), n_label).numpy()
    assert got.shape == ref.shape == (2, 100, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * max(1.0, float(np.abs(ref).max())))
    assert sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(FIXTURE) for f in fs) < 2_000_000


def write_fixture(out: str = FIXTURE) -> None:
    """The JAX package writes a TS-VAD TrainState (the JAX CLI's model at
    FIXTURE_SETS, seeded weights; tensors of over 50 000 values keep
    DENSITY of their entries, every value at bf16 precision, and sgd's
    optimizer state, so the directory stays under 2 MB) through its
    CheckpointManager, and the logits of its CPU forward on a seeded input."""
    shutil.rmtree(out, ignore_errors=True)
    cfg = _jax_cfg("tsvad", FIXTURE_SETS)
    model = JCLI._build_model(cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64000)), jnp.zeros((1, 4, 192)),
                                               100))
    rng = np.random.default_rng(2026)
    v = _seeded(shapes, 2026)

    def sparse(a):
        a = np.asarray(a, np.float32)
        if a.size > 50_000:
            a = np.where(rng.random(a.shape) < DENSITY, a / np.sqrt(DENSITY), 0.0).astype(np.float32)
        return (a.view(np.uint32) & 0xFFFF0000).view(np.float32)

    v = jax.tree_util.tree_map(sparse, v)
    mgr = JManager(out)
    trainer = JTrainer(lambda p, b, r, t: (0.0, {}), JTrainerConfig(optimizer="sgd"))
    state = trainer.init_state(v["params"], mutable={"batch_stats": v["batch_stats"]})
    mgr.save(state.replace(step=jnp.asarray(1, jnp.int32)), metric=0.5)
    pcm = rng.integers(-4000, 4000, (2, 64000), dtype=np.int16)
    embs = rng.standard_normal((2, 4, 192)).astype(np.float32)
    logits = model.apply(v, jnp.asarray(pcm.astype(np.float32) / 32768.0), jnp.asarray(embs), 100, train=False)
    np.savez(os.path.join(out, "jax_logits.npz"), pcm=pcm, embs=embs, n_label=np.int32(100),
             logits=np.asarray(logits, np.float32))
    with open(os.path.join(out, "sets.json"), "w") as f:
        json.dump(FIXTURE_SETS, f)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_fixture(sys.argv[1] if len(sys.argv) > 1 else FIXTURE)
    print(FIXTURE)
