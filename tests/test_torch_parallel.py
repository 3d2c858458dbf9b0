"""The port's parallel layer on gloo CPU processes, held to the JAX package's
contracts: the multihost test (`deterministic_reduce`, bitwise), the
data-parallel e2e test (EEND, and a TS-VAD whose synced BatchNorm and masked
loss need the global batch), `__graft_entry__.dryrun_multichip` on 2 data ×
2 model ranks, ring attention on 4 ranks, and the CLI's `n_data` under a
2-rank launch; then `utils/profiling`.

Each launch runs all its scenarios in one set of processes
(tests/torch_parallel_worker.py) with its own timeout."""

import json
import os
import re
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from speaker_diarization_tpu.cli import main as JCLI
from speaker_diarization_tpu.models.eend import EENDModel as JEEND
from speaker_diarization_tpu.train import tasks as JT
from speaker_diarization_tpu.train.trainer import Trainer as JTrainer
from speaker_diarization_tpu.train.trainer import TrainerConfig as JTrainerConfig
from speaker_diarization_tpu_torch.cli import main as C
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.models.eend import EENDModel
from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
from speaker_diarization_tpu_torch.parallel.collectives import data_parallel
from speaker_diarization_tpu_torch.parallel.mesh import Mesh
from speaker_diarization_tpu_torch.train.checkpoints import CheckpointManager
from speaker_diarization_tpu_torch.train.tasks import make_eend_loss
from speaker_diarization_tpu_torch.train.trainer import Trainer, TrainerConfig
from speaker_diarization_tpu_torch.utils import convert, profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(group: str, world: int, outdir: str, timeout: int = 240) -> list:
    """Run the worker's `group` on `world` gloo ranks → each rank's results."""
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, W.__file__, group, str(r), str(world), port, outdir],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    return [dict(np.load(os.path.join(outdir, f"{group}_{r}.npz"))) for r in range(world)]


def _params(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# data parallelism: 2 ranks


@pytest.fixture(scope="module")
def jax_eend(tmp_path_factory):
    """JAX multihost_worker's EEND, its init written for the ranks, and the
    JAX single-device Trainer's losses on the global batches."""
    outdir = str(tmp_path_factory.mktemp("dp"))
    jmodel = JEEND(**W.EEND_WIDTHS, frontend=None)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(W.eend_batch(0)["audio"][:1])))
    convert.save_flax_npz(os.path.join(outdir, "eend_init.npz"), variables)
    trainer = JTrainer(JT.make_eend_loss(jmodel), JTrainerConfig(optimizer="adam", schedule="const",
                                                                  learning_rate=1e-3, seed=0))
    state = trainer.init_state(variables)
    losses = []
    for s in range(W.EEND_STEPS):
        state, aux = trainer.train_step(state, {k: jnp.asarray(v) for k, v in W.eend_batch(s).items()})
        losses.append(float(aux["loss"]))
    return outdir, variables, np.array(losses)


@pytest.fixture(scope="module")
def dp_run(jax_eend):
    return _launch("dp", 2, jax_eend[0])


def test_deterministic_reduce_ranks_bitwise_equal(dp_run):
    a, b = (_params(r, "det/param/") for r in dp_run)
    assert a.keys() == b.keys() and len(a) > 0
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(dp_run[0]["det/losses"], dp_run[1]["det/losses"])


class _TwoEqualShards:
    """The data axis of a one-process run that computes the two shards in
    turn: two ranks whose counts are equal (the unmasked batch), summed in
    rank order."""

    size, deterministic = 2, True

    def sum(self, x):
        return x + x


def test_deterministic_reduce_matches_one_process_fixed_order(dp_run, jax_eend):
    """The 2-rank run is bitwise the one-process run that computes the two
    shards' gradients in turn and sums them in rank order, then / 2."""
    model = EENDModel(**W.EEND_WIDTHS, device="cpu")
    model.load_state_dict(convert.eend_from_flax(jax_eend[1]))
    loss_fn = make_eend_loss()
    trainer = Trainer(model, loss_fn, TrainerConfig(optimizer="adam", schedule="const", learning_rate=1e-3, seed=0))
    losses = []
    for s in range(W.EEND_STEPS):
        gb = W.eend_batch(s)
        grads, shard_losses = [], []
        model.train()
        for r in range(2):
            with data_parallel(_TwoEqualShards()):
                loss, _ = loss_fn(model, _t({k: v[4 * r:4 * r + 4] for k, v in gb.items()}), trainer.generator, True)
            g = torch.autograd.grad(loss, trainer.params, allow_unused=True)
            grads.append([torch.zeros_like(p) if x is None else x for p, x in zip(trainer.params, g)])
            shard_losses.append(loss.detach())
        trainer._apply([(a + b) / 2 for a, b in zip(*grads)])
        trainer.step += 1
        losses.append(((shard_losses[0] + shard_losses[1]) / 2).item())
    np.testing.assert_array_equal(np.array(losses), dp_run[0]["det/losses"])
    got = _params(dp_run[0], "det/param/")
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(got[n], p.detach().numpy(), err_msg=n)


def test_deterministic_reduce_losses_match_jax_single_device(dp_run, jax_eend):
    np.testing.assert_allclose(dp_run[0]["det/losses"], jax_eend[2], rtol=2e-4)


def _single_device(family: str):
    """The port's plain Trainer on the global batches of the `family` scenario
    → (losses, model, the batch the predictions are read on)."""
    cfg = TrainerConfig(optimizer="adam", schedule="const", learning_rate=1e-3)
    if family == "eend":
        model = EENDModel(**W.EEND_WIDTHS, device="cpu", seed=3)
        trainer = Trainer(model, make_eend_loss(), cfg)
        batches = [W.eend_batch(s, True) for s in range(W.DP_STEPS)]
        probe = W.eend_batch(0, True)
    else:
        model = TSVADModel(TSVADConfig(**W.TSVAD_TINY), device="cpu", seed=4)
        trainer = Trainer(model, W.tsvad_masked_loss(25, freeze_encoder=True), TrainerConfig(**W.TSVAD_DP_CFG))
        batches = [W.tsvad_batch(8, 1.0, 4, 16, 50 + s, masked=True) for s in range(W.DP_STEPS)]
        probe = W.tsvad_batch(8, 1.0, 4, 16, 99, masked=True)
    losses = [trainer.train_step(_t(b))["loss"].item() for b in batches]
    return np.array(losses), trainer, probe


def _predict(family: str, model, probe: dict):
    model.eval()
    with torch.no_grad():
        if family == "eend":
            return model(torch.from_numpy(probe["audio"]), torch.from_numpy(probe["frame_mask"])).numpy()
        return model(torch.from_numpy(probe["audio"]), torch.from_numpy(probe["target_embs"]), 25).numpy()


@pytest.mark.parametrize("family", ["eend", "tsvad"])
def test_data_parallel_matches_single_device(dp_run, family):
    """JAX test_e2e's bar: losses within rtol 2e-4 / atol 2e-5 and the final
    predictions within 2e-3. The shards' frame masks differ, so the masked
    mean needs the global count; TS-VAD's BatchNorm (`speech_down`) needs the
    global statistics, its running ones too, which the two ranks must hold
    bit for bit. CAM++ runs frozen: its stack of train-mode BatchNorms on a
    batch of 8 × 1 s has an fp32 gradient so ill-conditioned that one device
    given the same rows in reverse order strays from itself by more than
    these bars within three steps."""
    losses, trainer, probe = _single_device(family)
    np.testing.assert_allclose(dp_run[0][f"{family}/losses"], losses, rtol=2e-4, atol=2e-5)
    a, b = (_params(r, f"{family}/state/") for r in dp_run)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)  # the ranks stay in step
    model = trainer.model
    sd = {k: torch.from_numpy(v) for k, v in a.items()}
    ref = _predict(family, model, probe)
    if family == "tsvad":  # eval reads the running statistics the synced steps moved
        np.testing.assert_allclose(dp_run[0]["tsvad/eval_loss"], trainer.eval_step(_t(probe))["loss"].item(),
                                   rtol=1e-4)
    model.load_state_dict(sd)
    np.testing.assert_allclose(_predict(family, model, probe), ref, atol=2e-3)


# ---------------------------------------------------------------------------
# tensor parallelism (2 data x 2 model) and ring attention (4 ranks)


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    return _launch("tp", 4, str(tmp_path_factory.mktemp("tp")))


TP_NAMES = re.compile(r"\.ff\.dense0\.(weight|bias)$|\.ff\.dense1\.weight$|\.attn\.(query|key|value)\.(weight|bias)$"
                      r"|\.attn\.out\.weight$")


def test_tensor_parallel_forward_matches_unsharded(tp_run):
    for r in tp_run:
        ref = r["tp/ref"]
        np.testing.assert_allclose(r["tp/got"], ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_tensor_parallel_shards_what_the_rules_shard(tp_run):
    """The FFN's first Linear and bias, its second Linear's weight, the
    attention's q/k/v weights and biases and its out weight are halved over
    'model'; every other parameter keeps its shape and is the same on the
    two model ranks."""
    model = TSVADModel(TSVADConfig(**W.TSVAD_TP), device="cpu")
    want = sorted(n for n, _ in model.named_parameters() if TP_NAMES.search(n))
    assert len(want) == 2 * 10  # one layer in each of the two backends
    for r in tp_run:
        assert sorted(r["tp/sharded"].tolist()) == want
        assert bool(r["tp/spec_ok"]) and bool(r["tp/shrunk_ok"])
    for d in (0, 1):  # ranks 2d and 2d + 1 share the data index d
        a, b = (_params(tp_run[2 * d + m], "tp/param/") for m in (0, 1))
        for n in a:
            if n not in want:
                np.testing.assert_array_equal(a[n], b[n], err_msg=n)
            else:
                assert not np.array_equal(a[n], b[n]), n
    for m in (0, 1):  # the data ranks of one model index hold the same shard
        a, b = (_params(tp_run[2 * d + m], "tp/param/") for d in (0, 1))
        for n in a:
            np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def test_tensor_parallel_training_lowers_loss(tp_run):
    losses = tp_run[0]["tp/losses"]
    assert np.isfinite(losses).all() and len(losses) == W.TP_STEPS
    assert losses[-3:].mean() < 0.9 * losses[:3].mean(), losses
    for r in tp_run[1:]:
        np.testing.assert_array_equal(r["tp/losses"], losses)


def _full_attention(q, k, v):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("T", [64, 128])
def test_ring_attention_matches_full_attention(tp_run, T):
    """The 4 ranks' blocks joined: within 5e-5 of full attention (JAX
    test_ring_attention's bar), and dq, dk, dv within 1e-4 of autograd through
    full attention."""
    B, _, H, D = next(s for s in W.RING_SHAPES if s[1] == T)
    q, k, v, w = (torch.from_numpy(x).requires_grad_(i < 3) for i, x in enumerate(W.ring_inputs(B, T, H, D)))
    ref = _full_attention(q, k, v)
    (ref * w).sum().backward()
    out = np.concatenate([r[f"ring{T}/out"] for r in tp_run], axis=1)
    np.testing.assert_allclose(out, ref.detach().numpy(), rtol=0, atol=5e-5)
    for name, t in (("dq", q), ("dk", k), ("dv", v)):
        got = np.concatenate([r[f"ring{T}/{name}"] for r in tp_run], axis=1)
        np.testing.assert_allclose(got, t.grad.numpy(), rtol=0, atol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# the CLI: n_data under a 2-rank launch


@pytest.mark.parametrize("n_data", [2, 4])
@pytest.mark.parametrize("batch_size", [1, 2, 3, 5, 8])
def test_fit_batch_to_mesh_matches_jax(n_data, batch_size):
    cfg, jcfg = C.TrainCliConfig(batch_size=batch_size), JCLI.TrainCliConfig(batch_size=batch_size)
    got_cfg, got_mesh = C._fit_batch_to_mesh(cfg, Mesh(n_data, 1, 0, None, None))
    want_cfg, want_mesh = JCLI._fit_batch_to_mesh(jcfg, types.SimpleNamespace(shape={"data": n_data}))
    assert got_cfg.batch_size == want_cfg.batch_size
    assert (got_mesh is None) == (want_mesh is None)


EEND_SETS = ["d_model=16", "n_layers=1", "n_heads=2", "d_ff=32", "chunk_frames=30", "batch_size=4", "num_steps=3",
             "log_every=1", "valid_every=3", "dropout=0.0", "warmup_steps=10"]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """`train --family eend --set n_data=2` on 2 gloo ranks (the torchrun
    environment set by hand), the same one-process, then `infer` on the
    2-rank run."""
    tmp = tmp_path_factory.mktemp("cli")
    tr = write_synthetic_corpus(str(tmp / "train"), n_recs=2, seconds=12.0, rate=8000, n_speakers=2, seed=3,
                                prefix="tr")
    va = write_synthetic_corpus(str(tmp / "valid"), n_recs=1, seconds=12.0, rate=8000, n_speakers=2, seed=4,
                                prefix="va")
    args = ["-m", "speaker_diarization_tpu_torch.cli", "train", "--family", "eend", "--train-dir", tr["data_dir"],
            "--valid-dir", va["data_dir"], "--device", "cpu"]
    args += [a for kv in EEND_SETS for a in ("--set", kv)]
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE="2")
    dp_dir, one_dir = str(tmp / "exp_dp"), str(tmp / "exp_one")
    procs = [subprocess.Popen([sys.executable, *args, "--exp-dir", dp_dir, "--set", "n_data=2"], cwd=REPO,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    one = subprocess.Popen([sys.executable, *args, "--exp-dir", one_dir], cwd=REPO,
                           env={k: v for k, v in env.items() if k != "WORLD_SIZE"}, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    outs = []
    try:
        for p in procs + [one]:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs + [one]:
            p.kill()
    for p, (o, e) in zip(procs + [one], outs):
        assert p.returncode == 0, (o + e)[-6000:]
    hyp = str(tmp / "hyp")
    assert C.main(["infer", "--data-dir", va["data_dir"], "--exp-dir", dp_dir, "--out", hyp, "--device", "cpu"]) == 0
    return dict(dp=dp_dir, one=one_dir, logs=outs, hyp=hyp, valid=va)


def test_cli_data_parallel_rank0_alone_writes(cli_run):
    """The ranks share the exp dir; one metrics record a log step (not one a
    rank), as in the one-process run; rank 1 logs nothing at INFO."""
    def records(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    dp, one = records(cli_run["dp"]), records(cli_run["one"])
    assert [(r["kind"], r["step"]) for r in dp] == [(r["kind"], r["step"]) for r in one]
    assert sorted(os.listdir(cli_run["dp"])) == sorted(os.listdir(cli_run["one"]))
    assert "INFO" in cli_run["logs"][0][1] and "INFO" not in cli_run["logs"][1][1]
    with open(os.path.join(cli_run["dp"], C.TRAIN_CONFIG)) as f:
        assert json.load(f)["n_data"] == 2


def test_cli_data_parallel_predictions_match_one_process(cli_run):
    from speaker_diarization_tpu_torch.data.eend_dataset import EendChunkDataset, batch_iterator

    with open(os.path.join(cli_run["one"], C.TRAIN_CONFIG)) as f:
        cfg = C.TrainCliConfig(**json.load(f))
    preds = []
    for d in ("dp", "one"):
        mgr = CheckpointManager(cli_run[d])
        model = C.build_model(cfg, torch.device("cpu"))
        model.load_state_dict(mgr.restore(mgr.latest_step())["model"])
        ds = EendChunkDataset(cli_run["valid"]["data_dir"], cfg.chunk_frames, C.frontend_config(cfg), cfg.n_speakers)
        b = next(batch_iterator(ds, 4, False))
        with torch.no_grad():
            preds.append(model.eval()(torch.from_numpy(b["audio"]), torch.from_numpy(b["frame_mask"])).numpy())
    np.testing.assert_allclose(preds[0], preds[1], atol=2e-3)


def test_cli_infer_after_data_parallel_train(cli_run):
    d = os.path.dirname(cli_run["hyp"])
    assert any(fn.startswith("hyp") for fn in os.listdir(d))


# ---------------------------------------------------------------------------
# utils/profiling


def test_step_timer_drains_the_device_before_the_clock_stops(monkeypatch):
    events = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: events.append(("sync", dev)))
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: events.append(("clock", None)) or float(len(events)))
    timer = profiling.StepTimer()
    timer.start()
    gpu_tensor = types.SimpleNamespace(device=torch.device("cuda", 0))
    timer.stop({"loss": gpu_tensor, "host": torch.zeros(1)})
    assert [e[0] for e in events] == ["clock", "sync", "clock"]
    assert events[1][1] == torch.device("cuda", 0)
    assert timer.summary()["steps"] == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        assert "traceEvents" in json.load(f)
    s = profiling.profile_fn(lambda x: x @ x, torch.ones(8, 8), iters=3, warmup=1, log_dir=str(tmp_path / "fn"))
    assert s["steps"] == 3 and s["mean_ms"] > 0 and os.path.exists(tmp_path / "fn" / profiling.TRACE_FILE)
