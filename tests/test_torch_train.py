"""Port parity of the training slice: losses, DER statistics, schedules,
BatchNorm train mode, the optimizer semantics, the TS-VAD dataset's training
batches, three TS-VAD-Mamba trainer steps, and `cli train` → `cli infer
--exp-dir`, against the JAX package."""

import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speaker_diarization_tpu.data.tsvad_dataset import TSVADChunkDataset as JDataset
from speaker_diarization_tpu.data.tsvad_dataset import tsvad_batch_iterator as j_batches
from speaker_diarization_tpu.infer.embeddings import EmbeddingStore as JStore
from speaker_diarization_tpu.models.tsvad import TSVADConfig as JConfig
from speaker_diarization_tpu.models.tsvad import TSVADModel as JModel
from speaker_diarization_tpu.ops import losses as JL
from speaker_diarization_tpu.ops import metrics as JM
from speaker_diarization_tpu.train import schedules as JS
from speaker_diarization_tpu.train import tasks as JT
from speaker_diarization_tpu.train.trainer import Trainer as JTrainer
from speaker_diarization_tpu.train.trainer import TrainerConfig as JTrainerConfig
from speaker_diarization_tpu.train.trainer import build_optimizer as j_build_optimizer
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.data.tsvad_dataset import TSVADChunkDataset, tsvad_batch_iterator
from speaker_diarization_tpu_torch.data.wav import write_wav
from speaker_diarization_tpu_torch.infer.embeddings import EmbeddingStore
from speaker_diarization_tpu_torch.models.layers import BatchNorm
from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
from speaker_diarization_tpu_torch.ops import losses as L
from speaker_diarization_tpu_torch.ops import metrics as M
from speaker_diarization_tpu_torch.train import schedules as S
from speaker_diarization_tpu_torch.train.checkpoints import CheckpointManager, average_checkpoints
from speaker_diarization_tpu_torch.train.tasks import make_tsvad_loss
from speaker_diarization_tpu_torch.train.trainer import Trainer, TrainerConfig
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)


@pytest.mark.parametrize("masked", [False, True])
def test_bce_and_der_stats_match_jax(masked):
    rng = np.random.default_rng(int(masked))
    logits = (2 * rng.standard_normal((3, 20, 4))).astype(np.float32)
    labels = (rng.random((3, 20, 4)) < 0.4).astype(np.float32)
    fm = (rng.random((3, 20)) < 0.8).astype(np.float32) if masked else None
    sm = np.array([[1, 1, 1, 0], [1, 1, 0, 0], [1, 1, 1, 1]], np.float32) if masked else None
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    np.testing.assert_allclose(L.bce_with_logits(t(logits), t(labels)).numpy(),
                               np.asarray(JL.bce_with_logits(j(logits), j(labels))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(L.standard_bce(t(logits), t(labels), t(fm), t(sm)).item(),
                               float(JL.standard_bce(j(logits), j(labels), j(fm), j(sm))), rtol=1e-6)
    got, ref = M.diarization_error_stats(t(logits), t(labels), t(fm)), JM.diarization_error_stats(j(logits), j(labels), j(fm))
    assert got.keys() == ref.keys()
    for k in ref:
        assert int(got[k]) == int(ref[k]), k
    np.testing.assert_allclose(float(M.der_from_stats(got)), float(JM.der_from_stats(ref)), rtol=1e-6)


@pytest.mark.parametrize("kind", ["noam", "poly"])
def test_schedules_match_jax(kind):
    if kind == "noam":
        got, ref = S.noam_schedule(1.0, 256, 400), JS.noam_schedule(1.0, 256, 400)
    else:
        got, ref = S.polynomial_decay_schedule(2e-4, 400, 4000, 1e-6), JS.polynomial_decay_schedule(2e-4, 400, 4000, 1e-6)
    for step in (0, 1, 2, 57, 399, 400, 401, 2500, 3999, 4000, 9000):
        # JAX evaluates in float32, the port in float64: a few float32 ulps apart
        np.testing.assert_allclose(got(step), float(ref(jnp.asarray(step, jnp.int32))), rtol=1e-5, err_msg=str(step))


def test_batchnorm_train_mode_matches_flax():
    """Biased batch variance for normalising and for the running statistics,
    flax momentum 0.9, over two train-mode calls; then eval mode."""
    rng = np.random.default_rng(0)
    C = 6
    xs = [(1.5 * rng.standard_normal((4, 9, C)) + 0.3).astype(np.float32) for _ in range(2)]
    scale = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    mean0 = (0.1 * rng.standard_normal(C)).astype(np.float32)
    var0 = (1 + 0.2 * rng.random(C)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    port = BatchNorm(C)
    with torch.no_grad():
        for n, a in (("weight", scale), ("bias", bias), ("running_mean", mean0), ("running_var", var0)):
            getattr(port, n).copy_(torch.from_numpy(a))
    port.train()
    for x in xs:
        ref, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
        got = port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(v["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(v["batch_stats"]["var"]), rtol=1e-6, atol=1e-7)
    port.eval()
    ref = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5).apply(v, jnp.asarray(xs[0]))
    got = port(torch.from_numpy(xs[0]).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


class _Toy(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(b.copy()))


def _toy_loss(model, batch, generator, train):
    """sum(w·gw) + sum(b·gb): the gradients are exactly the batch's gw, gb."""
    loss = (model.w * batch["gw"]).sum() + (model.b * batch["gb"]).sum()
    return loss, {}


OPT_CASES = {
    "adam_noam_clip": dict(optimizer="adam", schedule="noam", learning_rate=0.5, d_model=64, warmup_steps=3, grad_clip_norm=1.0),
    "adamw_poly_clip": dict(optimizer="adamw", schedule="poly", learning_rate=1e-2, warmup_steps=2, total_steps=6,
                            weight_decay=0.1, grad_clip_norm=2.0),
    "sgd_const": dict(optimizer="sgd", schedule="const", learning_rate=0.1, grad_clip_norm=None),
    "adam_autoclip": dict(optimizer="adam", schedule="const", learning_rate=1e-2, auto_clip_percentile=50.0,
                          grad_history_size=3),
    "adam_skip_nonfinite": dict(optimizer="adam", schedule="const", learning_rate=1e-2, skip_nonfinite=True),
    "adam_accum2": dict(optimizer="adam", schedule="poly", learning_rate=1e-2, warmup_steps=2, total_steps=6,
                        grad_accum_steps=2),
    "sgd_polyak": dict(optimizer="sgd", schedule="const", learning_rate=0.1, model_avg_decay=0.8),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_trainer_update_semantics_match_optax(case):
    """Five steps with known gradients: the port's Trainer against the JAX
    package's optax chain (build_optimizer) step by step."""
    kw = OPT_CASES[case]
    rng = np.random.default_rng(len(case))
    w0, b0 = rng.standard_normal((3, 4)).astype(np.float32), rng.standard_normal(5).astype(np.float32)
    grads = [(3 * rng.standard_normal((3, 4))).astype(np.float32) for _ in range(5)]
    gbs = [(3 * rng.standard_normal(5)).astype(np.float32) for _ in range(5)]
    if kw.get("skip_nonfinite"):
        grads[1][0, 0] = np.nan
    tx, _ = j_build_optimizer(JTrainerConfig(**kw))
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    opt_state = tx.init(params)
    avg = dict(params)
    trainer = Trainer(_Toy(w0, b0), _toy_loss, TrainerConfig(**kw))
    for gw, gb in zip(grads, gbs):
        upd, opt_state = tx.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb)}, opt_state, params)
        params = optax.apply_updates(params, upd)
        if kw.get("model_avg_decay"):
            d = kw["model_avg_decay"]
            avg = {k: avg[k] * d + params[k] * (1 - d) for k in avg}
        trainer.train_step({"gw": torch.from_numpy(gw), "gb": torch.from_numpy(gb)})
        for k in ("w", "b"):
            np.testing.assert_allclose(getattr(trainer.model, k).detach().numpy(), np.asarray(params[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{case} step {trainer.step} {k}")
    if kw.get("model_avg_decay"):
        for k in ("w", "b"):
            np.testing.assert_allclose(trainer.avg_params[k].numpy(), np.asarray(avg[k]), rtol=1e-5, atol=1e-6)


def test_trainer_state_round_trip_resumes_exactly():
    """Four steps in one go equal two steps, a save/restore into a fresh
    Trainer, and two more (optimizer moments, counters, averaged weights)."""
    rng = np.random.default_rng(9)
    w0, b0 = rng.standard_normal((3, 4)).astype(np.float32), rng.standard_normal(5).astype(np.float32)
    batches = [{"gw": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)),
                "gb": torch.from_numpy(rng.standard_normal(5).astype(np.float32))} for _ in range(4)]
    cfg = TrainerConfig(optimizer="adam", schedule="noam", learning_rate=0.5, d_model=64, warmup_steps=3,
                        model_avg_decay=0.9, grad_accum_steps=3)
    a = Trainer(_Toy(w0, b0), _toy_loss, cfg)
    for bt in batches:
        a.train_step(bt)
    b = Trainer(_Toy(w0, b0), _toy_loss, cfg)
    for bt in batches[:2]:
        b.train_step(bt)
    c = Trainer(_Toy(np.zeros_like(w0), np.zeros_like(b0)), _toy_loss, cfg)
    c.load_state_dict(b.state_dict())
    for bt in batches[2:]:
        c.train_step(bt)
    assert (c.step, c.n_updates) == (a.step, a.n_updates) == (4, 1)
    for k in ("w", "b"):
        torch.testing.assert_close(getattr(c.model, k), getattr(a.model, k), rtol=0, atol=0)
        torch.testing.assert_close(c.avg_params[k], a.avg_params[k], rtol=0, atol=0)


def test_checkpoint_retention_and_averaging(tmp_path):
    """max_to_keep newest plus the best_k by the validation metric; best and
    latest step; the average of named parameters."""

    class Dummy:
        def __init__(self, step):
            self.step = step

        def state_dict(self):
            return {"model": {"p": torch.full((2,), float(self.step)), "buf": torch.zeros(1)}, "step": self.step}

    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, best_k=1)
    for step, metric in zip(range(1, 6), (5.0, 1.0, 4.0, 3.0, 2.0)):
        mgr.save(Dummy(step), metric)
    assert mgr.all_steps() == [2, 4, 5]
    assert (mgr.best_step(), mgr.latest_step()) == (2, 5)
    assert mgr.restore()["step"] == 5
    again = CheckpointManager(str(tmp_path))  # metrics.json is read back
    assert again.best_step() == 2
    avg = average_checkpoints(mgr, [4, 5], ["p"])
    assert set(avg) == {"p"} and torch.equal(avg["p"], torch.full((2,), 4.5))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_corpus"))
    c = write_synthetic_corpus(os.path.join(root, "train"), n_recs=2, seconds=16.0, rate=8000, n_speakers=3,
                               emb_dim=192, seed=3, prefix="tr")
    v = write_synthetic_corpus(os.path.join(root, "valid"), n_recs=1, seconds=16.0, rate=8000, n_speakers=3,
                               emb_dim=192, seed=4, prefix="va")
    rng = np.random.default_rng(5)
    for name, n in (("noise", 8000 * 3), ("rir", 800)):
        d = os.path.join(root, name)
        os.makedirs(d)
        sig = rng.standard_normal(n) * (np.exp(-np.arange(n) / 150.0) if name == "rir" else 0.1)
        write_wav(os.path.join(d, f"{name}0.wav"), sig.astype(np.float32), 8000)
        with open(os.path.join(d, "wav.scp"), "w") as f:
            f.write(f"{name}0 {os.path.join(d, name + '0.wav')}\n")
    return dict(train=c, valid=v, noise=os.path.join(root, "noise"), rir=os.path.join(root, "rir"), root=root)


def test_dataset_train_batches_match_jax(corpus):
    """Training items (shuffled speakers, random embedding rows, distractors,
    RIR + noise augmentation) and the batch order, two epochs, one seed."""
    kw = dict(rs_len=2.0, segment_shift=1.0, rate=8000, is_train=True, seed=3, noise_dir=corpus["noise"],
              rir_dir=corpus["rir"], aug_prob=0.8)
    c = corpus["train"]
    port = TSVADChunkDataset(c["data_dir"], EmbeddingStore.load(c["emb_store"]), **kw)
    ref = JDataset(c["data_dir"], JStore.load(c["emb_store"]), **kw)
    assert len(port) == len(ref) > 8
    for epoch in (0, 1):
        got = list(tsvad_batch_iterator(port, 4, True, seed=3, epoch=epoch))
        want = list(j_batches(ref, 4, True, seed=3, epoch=epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for k in ("audio", "target_embs", "labels"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"epoch {epoch} {k}")


SMALL = dict(encoder_block_layers=(1, 1), transformer_embed_dim=32, transformer_ffn_embed_dim=64,
             num_attention_head=2, speaker_embed_dim=16, num_transformer_layer=1, d_state=8, dropout=0.0,
             single_backend_type="mamba", multi_backend_type="mamba_add")


@pytest.fixture(scope="module")
def tsvad_mamba():
    jmodel = JModel(cfg=JConfig(**SMALL))
    v = jax.jit(jmodel.init, static_argnums=3)(jax.random.PRNGKey(0), jnp.zeros((1, 8000)), jnp.zeros((1, 4, 16)), 12)
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])  # positive variances
    # The model is fed fbank features (1 s at 16 kHz: 48 frames), not audio:
    # the two frameworks' fbanks differ by float rounding (test_torch_features
    # holds them), and train-mode BatchNorm over a batch of two amplifies
    # that far past the 1e-5 this test holds the training semantics to.
    batches = []
    for i in range(3):
        batches.append(dict(
            audio=rng.standard_normal((2, 48, 80)).astype(np.float32),
            target_embs=rng.standard_normal((2, 4, 16)).astype(np.float32),
            labels=(rng.random((2, 12, 4)) < 0.4).astype(np.float32),
        ))
    return jmodel, v, batches


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("opt", ["sgd", "adam_noam_clip_polyak"])
def test_tsvad_mamba_trainer_steps_match_jax(tsvad_mamba, opt):
    """Three train steps of a small TS-VAD-Mamba (dropout 0): (a) sgd, with
    losses, weights and BatchNorm statistics to 1e-5 relative; (b) adam +
    noam + clip + Polyak, losses to 1e-4 relative and weights and statistics
    to an absolute 2·lr·steps (adam's first step moves a weight by about lr·sign(g), so a
    near-zero gradient whose sign differs moves it by 2·lr)."""
    jmodel, v, batches = tsvad_mamba
    if opt == "sgd":
        # at lr 5e-2 train-mode BatchNorm over two items turns rounding into
        # another trajectory within three steps (4% apart in some weights)
        kw = dict(optimizer="sgd", schedule="const", learning_rate=3e-3, grad_clip_norm=None)
        loss_tol, p_tol = dict(rtol=1e-5, atol=0), dict(rtol=1e-5, atol=1e-6)
    else:
        kw = dict(optimizer="adam", schedule="noam", learning_rate=5e-3, d_model=32, warmup_steps=4,
                  grad_clip_norm=1.0, model_avg_decay=0.9)
        lr_max = max(S.noam_schedule(5e-3, 32, 4)(s) for s in range(3))
        loss_tol, p_tol = dict(rtol=1e-4, atol=0), dict(rtol=0, atol=2 * lr_max * 3)
    T = 12
    jtrainer = JTrainer(JT.make_tsvad_loss(jmodel, T), JTrainerConfig(**kw), has_mutable=True)
    state = jtrainer.init_state(v["params"], mutable={"batch_stats": v["batch_stats"]})
    if state.avg_params is not None:  # init_state aliases them to params, which train_step donates twice
        state = state.replace(avg_params=jax.tree_util.tree_map(jnp.array, state.avg_params))
    model = TSVADModel(TSVADConfig(**SMALL), device="cpu")
    model.load_state_dict(convert.tsvad_from_flax(v))
    trainer = Trainer(model, make_tsvad_loss(T), TrainerConfig(**kw))
    for b in batches:
        state, jaux = jtrainer.train_step(state, {k: jnp.asarray(a) for k, a in b.items()})
        aux = trainer.train_step({k: torch.from_numpy(a) for k, a in b.items()})
        np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]), **loss_tol)
    got = _flat(convert.tsvad_to_flax(model.state_dict(), num_heads=2))
    want = _flat({"params": state.params, "batch_stats": state.mutable["batch_stats"]})
    assert got.keys() == want.keys()
    for k in want:
        # adam: a running mean follows the bias before it, which may differ by 2·lr·steps
        tol = dict(rtol=1e-5, atol=1e-6) if "batch_stats" in k and opt == "sgd" else p_tol
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    if opt == "sgd":  # the weights' total update, not only their values
        start = _flat({"params": v["params"]})
        for k in start:
            step = want[k] - start[k]
            np.testing.assert_allclose(got[k] - start[k], step, rtol=0, atol=1e-3 * np.abs(step).max() + 1e-7,
                                       err_msg=k)
    if opt != "sgd":
        got_avg = _flat(convert.tsvad_to_flax({**model.state_dict(), **trainer.avg_params}, num_heads=2)["params"])
        for k, w in _flat(state.avg_params).items():
            np.testing.assert_allclose(got_avg[k], w, rtol=0, atol=p_tol["atol"], err_msg=k)


def test_encoder_npz_loads_into_the_speech_encoder(tsvad_mamba, tmp_path):
    """`train --encoder-ckpt` reads the JAX export-encoder npz into CAM++
    exactly as the JAX CLI grafts it into TSVADModel's speech_encoder."""
    from speaker_diarization_tpu.models.spk_embed import SpkEmbedConfig, save_encoder
    from speaker_diarization_tpu_torch.cli.main import _load_encoder

    _, v, _ = tsvad_mamba
    path = str(tmp_path / "encoder.npz")
    enc_vars = {"params": v["params"]["speech_encoder"], "batch_stats": v["batch_stats"]["speech_encoder"]}
    save_encoder(path, SpkEmbedConfig(encoder_blocks=SMALL["encoder_block_layers"]), enc_vars)
    model = TSVADModel(TSVADConfig(**SMALL), device="cpu", seed=5)
    _load_encoder(model, path)
    want = convert.campplus_from_flax(enc_vars["params"], enc_vars["batch_stats"])
    got = model.speech_encoder.state_dict()
    assert set(got) <= set(want)
    for k, t in got.items():
        torch.testing.assert_close(t, want[k], rtol=0, atol=0, msg=k)


def test_cli_train_then_infer_exp_dir(corpus):
    """`cli train --device cpu` (Mamba backends, validation, checkpoints,
    then a resumed run), then `cli infer --exp-dir` writes the RTTMs."""
    c, v = corpus["train"], corpus["valid"]
    exp = os.path.join(corpus["root"], "exp")
    sets = ["encoder_blocks=1,1", "n_layers=1", "d_ff=32", "single_backend_type=mamba", "multi_backend_type=mamba",
            "d_state=8", "batch_size=4", "log_every=1", "valid_every=2", "schedule=poly", "learning_rate=1e-3",
            "warmup_steps=1", "n_mels=80", "rs_len=2.0", "segment_shift=1.0"]
    argv = ["train", "--family", "tsvad", "--train-dir", c["data_dir"], "--valid-dir", v["data_dir"], "--exp-dir", exp,
            "--emb-store", f"{c['emb_store']},{v['emb_store']}", "--noise-dir", corpus["noise"], "--device", "cpu"]
    sets_args = [a for kv in sets for a in ("--set", kv)]
    assert port_cli(argv + sets_args + ["--set", "num_steps=2", "--set", "seed=1"]) == 0
    with open(os.path.join(exp, "train_config.json")) as f:
        assert json.load(f)["num_steps"] == 2
    assert port_cli(argv + ["--resume"] + sets_args + ["--set", "num_steps=3", "--set", "seed=1"]) == 0
    assert CheckpointManager(exp).all_steps() == [2, 3]
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if r["kind"] == "train"] == [1, 2, 3]
    assert [r["step"] for r in recs if r["kind"] == "valid"] == [2]
    assert all(np.isfinite(r["loss"]) for r in recs)
    out = os.path.join(corpus["root"], "hyp")
    assert port_cli(["infer", "--family", "tsvad", "--data-dir", v["data_dir"], "--emb-store", v["emb_store"],
                     "--exp-dir", exp, "--out", out, "--device", "cpu", "--threshold-sweep", "--ref", v["rttm"],
                     "--avg-last", "2"]) == 0
    assert len([f for f in os.listdir(corpus["root"]) if f.startswith("hyp_")]) == 18
