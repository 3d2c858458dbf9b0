"""Port parity of streaming TS-VAD against the JAX package: the chunk mask,
the offline chunk-masked forward, the cache-based chunk steps, the window
predictor, the loss and its gradients and the weight converters. Then the
second hermetic recipe's CLI on a tiny corpus (`train` → `infer
--threshold-sweep` for tsvad_streaming and for TS-VAD with BiMamba-2
backends) and the slot count at `--set n_speakers=3`.

Bars: logits 2e-4 absolute + 2e-3 relative (test_torch_tsvad.py's), the
streaming decode against the offline forward 2e-4 (JAX
tests/test_streaming.py), gradients 1e-4 relative to the largest."""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.infer.chunked import make_streaming_window_predict as j_window_predict
from speaker_diarization_tpu.models.streaming_tsvad import StreamingTSVADConfig as JConfig
from speaker_diarization_tpu.models.streaming_tsvad import StreamingTSVADModel as JModel
from speaker_diarization_tpu.models.transformer import make_chunk_mask as j_chunk_mask
from speaker_diarization_tpu.train import tasks as JT
from speaker_diarization_tpu_torch.cli import main as C
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.infer.chunked import make_streaming_window_predict
from speaker_diarization_tpu_torch.models.streaming_tsvad import StreamingTSVADConfig, StreamingTSVADModel
from speaker_diarization_tpu_torch.models.transformer import make_chunk_mask
from speaker_diarization_tpu_torch.train.tasks import make_streaming_tsvad_loss
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

SMALL = dict(max_num_speaker=4, speaker_embed_dim=16, d_model=48, d_ff=64, n_heads=2, n_layers=2, dropout=0.0,
             chunk_size=8, num_left_chunks=2)
T = 40  # label frames: five chunks of 8 (1.6 s at 16 kHz)


@pytest.mark.parametrize("T_,chunk,left", [(40, 8, 2), (37, 16, -1), (100, 16, 4), (10, 4, 0)])
def test_chunk_mask_matches_jax(T_, chunk, left):
    np.testing.assert_array_equal(make_chunk_mask(T_, chunk, left).numpy(), np.asarray(j_chunk_mask(T_, chunk, left)))


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its perturbed variables, the port's model with them, audio, embeddings)."""
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal((2, T * 640))).astype(np.float32)
    embs = rng.standard_normal((2, 4, SMALL["speaker_embed_dim"])).astype(np.float32)
    jmodel = JModel(cfg=JConfig(**SMALL))
    v = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(audio), jnp.asarray(embs), T)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32) + 0.05 * rng.standard_normal(a.shape).astype(
        np.float32), v)
    model = StreamingTSVADModel(StreamingTSVADConfig(**SMALL), device="cpu")
    model.load_state_dict(convert.streaming_tsvad_from_flax(v))
    return jmodel, v, model, audio, embs


def test_converters_round_trip(pair):
    _, v, model, _, _ = pair
    a, b = _flat(v), _flat(convert.streaming_tsvad_to_flax(model.state_dict(), num_heads=SMALL["n_heads"]))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("n_label", [T, 37])
def test_offline_forward_matches_jax(pair, n_label):
    """Audio in (kaldi fbank → conv subsampling → chunk-masked backends);
    37 frames cut the mix mid-chunk."""
    jmodel, v, model, audio, embs = pair
    ref = np.asarray(jmodel.apply(v, audio, embs, n_label))
    with torch.no_grad():
        got = model(torch.from_numpy(audio), torch.from_numpy(embs), n_label).numpy()
    assert got.shape == (2, n_label, 4)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)


def test_streaming_steps_match_jax_and_offline(pair):
    """Chunk by chunk through the caches on the same 25 Hz features: each
    step against JAX's `streaming_step_mix`, and the concatenated chunks
    against the port's offline chunk-masked forward."""
    jmodel, v, model, audio, embs = pair
    e = torch.from_numpy(embs)
    with torch.no_grad():
        mix = model.encode_frames(torch.from_numpy(audio))[:, :T]
        cat = model._fuse(mix, e)
        B, S, T_, D = cat.shape
        kw = dict(chunk_size=SMALL["chunk_size"], num_left_chunks=SMALL["num_left_chunks"])
        x = model._down(model.single_backend(cat.reshape(B * S, T_, D), **kw), B)
        offline = model.fc(model.multi_backend(x, **kw)).numpy()
        state, jstate, outs = model.streaming_state(2), jmodel.apply(v, 2, method=jmodel.streaming_state), []
        for c in range(0, T, SMALL["chunk_size"]):
            chunk = mix[:, c : c + SMALL["chunk_size"]]
            logits, state = model.streaming_step_mix(chunk, e, state)
            jlogits, jstate = jmodel.apply(v, jnp.asarray(chunk.numpy()), jnp.asarray(embs), jstate,
                                           method=jmodel.streaming_step_mix)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=2e-4, rtol=2e-3)
            outs.append(logits.numpy())
    assert (state["pos"], state["valid"]) == (T, SMALL["chunk_size"] * SMALL["num_left_chunks"])
    np.testing.assert_allclose(np.concatenate(outs, axis=1), offline, atol=2e-4)


def test_streaming_step_on_fbank_chunks_matches_jax(pair):
    """`streaming_step` on raw fbank chunks (the conv front-end sees each
    chunk alone), two chunks, against JAX on the same fbank."""
    jmodel, v, model, _, embs = pair
    fb = np.random.default_rng(1).standard_normal((2, 64, 80)).astype(np.float32)
    state, jstate = model.streaming_state(2), jmodel.apply(v, 2, method=jmodel.streaming_state)
    with torch.no_grad():
        for c in (0, 32):
            logits, state = model.streaming_step(torch.from_numpy(fb[:, c : c + 32]), torch.from_numpy(embs), state)
            jlogits, jstate = jmodel.apply(v, jnp.asarray(fb[:, c : c + 32]), jnp.asarray(embs), jstate,
                                           method=jmodel.streaming_step)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("n_label", [T, 37])
def test_window_predict_matches_jax_and_offline(pair, n_label):
    """The CLI's window predictor against JAX's (at 37 frames the last
    chunk is zero-padded to 40 and its queries attend to the padding, in
    both frameworks); on whole chunks, against the sigmoid of the offline
    forward."""
    jmodel, v, model, audio, embs = pair
    got = make_streaming_window_predict(model, n_label)(audio, embs)
    want = np.asarray(j_window_predict(jmodel, v, n_label)(jnp.asarray(audio), jnp.asarray(embs)))
    assert got.shape == (2, n_label, 4)
    np.testing.assert_allclose(got, want, atol=2e-4)
    if n_label % SMALL["chunk_size"] == 0:
        with torch.no_grad():
            offline = torch.sigmoid(model(torch.from_numpy(audio), torch.from_numpy(embs), n_label)).numpy()
        np.testing.assert_allclose(got, offline, atol=2e-4)


def test_loss_and_grads_match_jax(pair):
    """`make_streaming_tsvad_loss` in train mode (dropout 0): the value, the
    frame DER and every weight's gradient against jax.value_and_grad."""
    jmodel, v, model, audio, embs = pair
    labels = (np.random.default_rng(2).random((2, T, 4)) < 0.4).astype(np.float32)
    batch = dict(audio=audio, target_embs=embs, labels=labels)
    jloss = JT.make_streaming_tsvad_loss(jmodel, T)
    (want, jaux), jgrads = jax.value_and_grad(lambda p: jloss(p, {k: jnp.asarray(a) for k, a in batch.items()},
                                                              jax.random.PRNGKey(0), True), has_aux=True)(v)
    model.train()
    try:
        loss, aux = make_streaming_tsvad_loss(T)(model, {k: torch.from_numpy(a) for k, a in batch.items()}, None, True)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
    finally:
        model.eval()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(aux["frame_der"].item(), float(jaux["frame_der"]), rtol=1e-5)
    got = _flat(convert.streaming_tsvad_to_flax(dict(zip(names, grads)), num_heads=SMALL["n_heads"]))
    want_g = _flat(jgrads)
    assert got.keys() == want_g.keys()
    scale = max(np.abs(g).max() for g in want_g.values())
    for k in want_g:
        np.testing.assert_allclose(got[k], want_g[k], rtol=2e-3, atol=1e-4 * scale, err_msg=k)


# ---------------------------------------------------------------------------
# the second hermetic recipe's CLI, and the slot count
# ---------------------------------------------------------------------------

STREAM_SETS = ["d_model=32", "d_ff=32", "n_layers=1", "n_heads=2", "streaming_chunk_size=4", "streaming_left_chunks=2"]
MAMBA2_SETS = ["encoder_blocks=1,1", "n_layers=1", "d_ff=32", "single_backend_type=mamba2",
               "multi_backend_type=mamba2_add", "d_state=8"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stream_corpus"))
    c = write_synthetic_corpus(os.path.join(root, "train"), n_recs=2, seconds=12.0, rate=8000, n_speakers=3,
                               emb_dim=192, seed=31, prefix="tr")
    v = write_synthetic_corpus(os.path.join(root, "valid"), n_recs=1, seconds=12.0, rate=8000, n_speakers=3,
                               emb_dim=192, seed=32, prefix="va")
    return dict(train=c, valid=v, root=root)


@pytest.mark.parametrize("family,sets", [("tsvad_streaming", STREAM_SETS), ("tsvad", MAMBA2_SETS)],
                         ids=["tsvad_streaming", "tsvad_mamba2"])
def test_cli_train_then_infer_threshold_sweep(corpus, family, sets):
    """`cli train --device cpu` (two steps, validation, checkpoints), then
    `cli infer --exp-dir --threshold-sweep --ref` writes one RTTM per
    threshold and prints the best DER."""
    c, v, root = corpus["train"], corpus["valid"], corpus["root"]
    exp = os.path.join(root, "exp_" + family)
    sets = sets + ["batch_size=4", "num_steps=2", "log_every=1", "valid_every=2", "schedule=poly",
                   "learning_rate=1e-3", "warmup_steps=1", "n_mels=80", "rs_len=2.0", "segment_shift=1.0"]
    argv = ["train", "--family", family, "--train-dir", c["data_dir"], "--valid-dir", v["data_dir"], "--exp-dir", exp,
            "--emb-store", f"{c['emb_store']},{v['emb_store']}", "--device", "cpu"]
    assert C.main(argv + [a for kv in sets for a in ("--set", kv)]) == 0
    assert sorted(f for f in os.listdir(exp) if f.startswith("step_"))
    assert C.main(["infer", "--data-dir", v["data_dir"], "--emb-store", v["emb_store"], "--exp-dir", exp, "--out",
                   os.path.join(exp, "hyp"), "--device", "cpu", "--threshold-sweep", "--ref", v["rttm"]]) == 0
    assert len([f for f in os.listdir(exp) if f.startswith("hyp_")]) == 18


def test_streaming_train_refuses_encoder_ckpt(corpus):
    c = corpus["train"]
    with pytest.raises(SystemExit, match="encoder-ckpt"):
        C.main(["train", "--family", "tsvad_streaming", "--train-dir", c["data_dir"], "--exp-dir",
                os.path.join(corpus["root"], "refused"), "--emb-store", c["emb_store"], "--encoder-ckpt", "enc.npz",
                "--device", "cpu"])


@pytest.mark.parametrize("family,sets", [("tsvad_streaming", STREAM_SETS), ("tsvad", MAMBA2_SETS)],
                         ids=["tsvad_streaming", "tsvad_mamba2"])
def test_three_speaker_slots(corpus, family, sets):
    """`--set n_speakers=3` gives the model three slots and the datasets
    three: the embeddings, the labels and the logits all have 3 speakers
    (the JAX CLI's datasets keep 4 here, ROADMAP §3)."""
    from speaker_diarization_tpu_torch.utils.config import apply_overrides

    c, v = corpus["train"], corpus["valid"]
    cfg = apply_overrides(C.TrainCliConfig(family=family), sets + ["n_speakers=3", "n_mels=80", "rs_len=2.0",
                                                                   "batch_size=2", "dropout=0.0"])
    model = C.build_model(cfg, "cpu")
    assert model.cfg.max_num_speaker == 3
    args = argparse.Namespace(emb_store=f"{c['emb_store']},{v['emb_store']}", train_dir=c["data_dir"],
                              valid_dir=v["data_dir"], encoder_ckpt=None, noise_dir=None, rir_dir=None)
    loss_fn, make_train, make_valid, _ = C._tsvad_data(args, cfg, model)
    for batch in (next(make_train(0)), next(make_valid())):
        assert batch["target_embs"].shape == (2, 3, 192) and batch["labels"].shape == (2, 50, 3)
        b = {k: torch.from_numpy(a) for k, a in batch.items() if k in ("audio", "target_embs", "labels")}
        with torch.no_grad():
            logits = model(b["audio"], b["target_embs"], 50)
            loss, _ = loss_fn(model, b, None, False)
        assert logits.shape == (2, 50, 3) and torch.isfinite(loss)
