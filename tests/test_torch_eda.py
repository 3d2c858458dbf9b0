"""Port parity of EEND-EDA: the flax LSTM recurrences, the attractor module,
EendEdaModel.__call__ (with an explicit frame order) and .infer, the
existence loss, the train loss, chunked EDA inference, three trainer steps
and `cli train --family eend_eda` → `cli infer --exp-dir`, against the JAX
package."""

import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.infer import eda as JI
from speaker_diarization_tpu.models.eda import EendEdaModel as JModel
from speaker_diarization_tpu.models.eda import EncoderDecoderAttractor as JEda
from speaker_diarization_tpu.models.eend import FrontendConfig as JFrontend
from speaker_diarization_tpu.ops import losses as JL
from speaker_diarization_tpu.train import tasks as JT
from speaker_diarization_tpu.train.trainer import Trainer as JTrainer
from speaker_diarization_tpu.train.trainer import TrainerConfig as JTrainerConfig
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data.rttm import read_rttm
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.infer import eda as I
from speaker_diarization_tpu_torch.models.eda import LSTM, EendEdaModel, EncoderDecoderAttractor
from speaker_diarization_tpu_torch.models.eend import FrontendConfig
from speaker_diarization_tpu_torch.ops import losses as L
from speaker_diarization_tpu_torch.train import schedules as S
from speaker_diarization_tpu_torch.train.tasks import make_eda_loss
from speaker_diarization_tpu_torch.train.trainer import Trainer, TrainerConfig
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

SMALL = dict(d_model=32, n_layers=2, n_heads=4, d_ff=64, dropout=0.0, max_attractors=5)
FP32_TOL = dict(atol=2e-4, rtol=2e-3)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturb(variables, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), variables)


def test_lstm_matches_flax_rnn_with_seq_lengths():
    """OptimizedLSTMCell under nn.RNN: outputs, and the carry frozen at each
    row's last valid step (length 0 keeps the carry after all steps)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 9, 6)).astype(np.float32)
    lengths = np.array([9, 4, 1, 0], np.int32)
    cell = fnn.OptimizedLSTMCell(8)
    rnn = fnn.RNN(cell, return_carry=True)
    v = _perturb(rnn.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    (c_ref, h_ref), out_ref = rnn.apply(v, jnp.asarray(x), seq_lengths=jnp.asarray(lengths))
    lstm = LSTM(6, 8)
    lstm.load_state_dict({k[len("l."):]: t for k, t in convert._lstm_from_flax(v["params"]["cell"], "l").items()})
    with torch.no_grad():
        (c, h), out = lstm(torch.from_numpy(x), seq_lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_attractor_module_matches_jax(dtype):
    """Shuffled, masked encoder input; zero-input decoder from its carry;
    existence logits. bf16: the gates in bf16, the carry and attractors fp32."""
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((3, 11, 16)).astype(np.float32)
    fm = np.ones((3, 11), np.float32)
    fm[1, 5:] = 0.0
    fm[2] = 0.0
    order = np.stack([rng.permutation(11) for _ in range(3)]).astype(np.int32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jm = JEda(d_model=16, dtype=jdt)
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(emb), 4), 4)
    att_r, ex_r = jm.apply(v, jnp.asarray(emb, jdt), 4, frame_mask=jnp.asarray(fm), order=jnp.asarray(order))
    assert att_r.dtype == jnp.float32  # JAX promotes the bf16 gates into the fp32 carry
    m = EncoderDecoderAttractor(16)
    m.load_state_dict({k[len("e."):]: t for k, t in convert._attractor_from_flax(v["params"], "e").items()})
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    with torch.no_grad():
        att, ex = m(torch.from_numpy(emb).to(tdt), 4, torch.from_numpy(fm), torch.from_numpy(order).long())
    assert att.dtype == torch.float32 and ex.dtype == torch.float32
    tol = FP32_TOL if dtype == "fp32" else dict(atol=3e-2, rtol=0)
    np.testing.assert_allclose(att.numpy(), np.asarray(att_r), **tol)
    np.testing.assert_allclose(ex.numpy(), np.asarray(ex_r), **tol)


@pytest.fixture(scope="module")
def eda_pair():
    jmodel = JModel(**SMALL)
    v = _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8000))), 1)
    model = EendEdaModel(**SMALL, device="cpu")
    model.load_state_dict(convert.eda_from_flax(v))
    return jmodel, v, model


def _audio_and_mask(seed, B=3, n=8000):
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((B, n))).astype(np.float32)
    fm = np.ones((B, FrontendConfig().n_frames(n)), np.float32)
    fm[1, 6:] = 0.0
    return x, fm


@pytest.mark.parametrize("with_order", [False, True])
def test_eda_call_matches_jax(eda_pair, with_order):
    jmodel, v, model = eda_pair
    x, fm = _audio_and_mask(7)
    rng = np.random.default_rng(8)
    order = None
    if with_order:  # valid frames first, as the train-time shuffle orders them
        order = np.argsort(rng.random(fm.shape) - fm, axis=-1).astype(np.int32)
    lo_r, ex_r = jmodel.apply(v, jnp.asarray(x), frame_mask=jnp.asarray(fm),
                              order=None if order is None else jnp.asarray(order))
    with torch.no_grad():
        lo, ex = model(torch.from_numpy(x), torch.from_numpy(fm), None if order is None else torch.from_numpy(order).long())
    assert lo.shape == (3, fm.shape[1], 2) and ex.shape == (3, 3)
    np.testing.assert_allclose(lo.numpy(), np.asarray(lo_r), **FP32_TOL)
    np.testing.assert_allclose(ex.numpy(), np.asarray(ex_r), **FP32_TOL)


@pytest.mark.parametrize("n", [8000, 12345])
def test_eda_infer_matches_jax(eda_pair, n):
    jmodel, v, model = eda_pair
    x, fm = _audio_and_mask(n, n=n)
    lo_r, p_r = jmodel.apply(v, jnp.asarray(x), frame_mask=jnp.asarray(fm), method=jmodel.infer)
    with torch.no_grad():
        lo, p = model.infer(torch.from_numpy(x), torch.from_numpy(fm))
    assert lo.shape == (3, fm.shape[1], 5) and p.shape == (3, 5)
    np.testing.assert_allclose(lo.numpy(), np.asarray(lo_r), **FP32_TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_r), **FP32_TOL)


def test_eda_bf16_close(eda_pair):
    _, v, _ = eda_pair
    jb = JModel(**SMALL, dtype=jnp.bfloat16)
    x, fm = _audio_and_mask(9)
    lo_r, ex_r = jb.apply(v, jnp.asarray(x), frame_mask=jnp.asarray(fm))
    model = EendEdaModel(**SMALL, dtype="bf16", device="cpu")
    model.load_state_dict(convert.eda_from_flax(v))
    with torch.no_grad():
        lo, ex = model(torch.from_numpy(x), torch.from_numpy(fm))
    assert lo.dtype == torch.float32
    assert np.mean(np.abs(lo.numpy() - np.asarray(lo_r))) < 5e-2 * max(1.0, np.mean(np.abs(np.asarray(lo_r))))
    assert np.mean(np.abs(ex.numpy() - np.asarray(ex_r))) < 5e-2


def test_eda_weight_conversion_round_trips(eda_pair):
    _, v, model = eda_pair
    sd = model.state_dict()
    back = convert.eend_to_flax(sd, num_heads=4)
    again = convert.eda_from_flax(back)
    assert set(again) == set(sd)
    for k in sd:
        torch.testing.assert_close(again[k], sd[k], rtol=0, atol=0)
    a, b = _flat(v), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_conformer_encoder_is_not_ported():
    """The conformer encoder is ported now (tests/test_torch_conformer.py
    holds it to JAX): it builds, and an unknown encoder type raises as the
    JAX model does."""
    from speaker_diarization_tpu_torch.models.conformer import ConformerEncoder

    model = EendEdaModel(**SMALL, encoder_type="conformer", device="cpu")
    assert isinstance(model.encoder, ConformerEncoder)
    with pytest.raises(ValueError, match="transformer|conformer"):
        EendEdaModel(**SMALL, encoder_type="lstm", device="cpu")


def test_attractor_existence_loss_matches_jax():
    rng = np.random.default_rng(4)
    ex = rng.standard_normal((5, 4)).astype(np.float32)
    sm = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0], [0, 0, 0], [1, 1, 1]], np.float32)
    got = L.attractor_existence_loss(torch.from_numpy(ex), torch.from_numpy(sm)).item()
    np.testing.assert_allclose(got, float(JL.attractor_existence_loss(jnp.asarray(ex), jnp.asarray(sm))), rtol=1e-5)


def _batches(n_batches, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        x, fm = _audio_and_mask(seed + i, B=2)
        sm = np.array([[1, 1], [1, 0]], np.float32)
        labels = (rng.random((2, fm.shape[1], 2)) < 0.4).astype(np.float32) * sm[:, None, :] * fm[..., None]
        out.append(dict(audio=x, frame_mask=fm, labels=labels, spk_mask=sm))
    return out


def test_eda_eval_loss_matches_jax(eda_pair):
    """The train loss in eval mode (no shuffle): total, PIT, existence, frame DER."""
    jmodel, v, model = eda_pair
    b = _batches(1, 30)[0]
    jloss, jaux = JT.make_eda_loss(jmodel)(v, {k: jnp.asarray(a) for k, a in b.items()}, jax.random.PRNGKey(0), False)
    with torch.no_grad():
        loss, aux = make_eda_loss()(model, {k: torch.from_numpy(a) for k, a in b.items()}, None, False)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    for k in ("pit_loss", "attractor_loss"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(aux["frame_der"].item(), float(jaux["frame_der"]), rtol=1e-6)


def test_eda_train_shuffle_puts_valid_frames_first(eda_pair):
    """In training the EDA encoder reads a per-sample permutation of the
    frames with every valid frame before every padded one, drawn from the
    generator (the same seed gives the same order)."""
    _, _, model = eda_pair
    b = {k: torch.from_numpy(a) for k, a in _batches(1, 40)[0].items()}
    seen = []

    class Spy(torch.nn.Module):
        def forward(self, x, fm, order, generator=None):
            seen.append(order)
            return model(x, fm, order)

    loss_fn = make_eda_loss()
    for _ in range(2):
        loss_fn(Spy(), b, torch.Generator().manual_seed(5), True)
    order = seen[0]
    fm = b["frame_mask"]
    assert torch.equal(seen[0], seen[1])
    for o, m in zip(order, fm):
        assert sorted(o.tolist()) == list(range(len(m)))
        n = int(m.sum())
        assert bool(m[o[:n]].all()) and not bool(m[o[n:]].any())


def _eda_predict(a, m):
    """A deterministic stand-in: probabilities from frame energy; existence
    probabilities that keep 1 to 3 attractors depending on the chunk."""
    B, T = m.shape
    e = np.abs(a).reshape(B, T, -1).mean(-1)
    p = 1.0 / (1.0 + np.exp(-(e[..., None] - 0.05 * np.arange(1, 5)) * 40.0))
    k = 1 + int(np.abs(a).sum() * 1e3) % 3
    ex = np.where(np.arange(4) < k, 0.9, 0.1)[None].repeat(B, 0)
    return (p * m[..., None]).astype(np.float32), ex.astype(np.float32)


@pytest.mark.parametrize("n,max_speakers", [(8000 * 7 + 123, None), (8000 * 5, 2), (500, None)])
def test_eda_infer_recording_matches_jax(n, max_speakers):
    audio = (0.1 * np.random.default_rng(n).standard_normal(n)).astype(np.float32)
    got = I.eda_infer_recording(_eda_predict, audio, FrontendConfig(), chunk_frames=20, max_speakers=max_speakers)
    ref = JI.eda_infer_recording(_eda_predict, audio, JFrontend(), chunk_frames=20, max_speakers=max_speakers)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    for probs in (np.array([0.9, 0.8, 0.2, 0.7]), np.array([0.6, 0.6]), np.array([0.1])):
        assert I.select_speakers(probs, 0.5, max_speakers) == JI.select_speakers(probs, 0.5, max_speakers)


@pytest.mark.parametrize("opt", ["sgd", "adam_noam_clip"])
def test_eda_trainer_steps_match_jax(eda_pair, opt):
    """Three train steps of a small EEND-EDA (dropout 0, no frame shuffle):
    losses and weights, at test_torch_train's tolerances."""
    jmodel, v, _ = eda_pair
    if opt == "sgd":
        kw = dict(optimizer="sgd", schedule="const", learning_rate=3e-2, grad_clip_norm=None)
        loss_tol, p_tol = dict(rtol=1e-5, atol=0), dict(rtol=1e-5, atol=1e-6)
    else:
        kw = dict(optimizer="adam", schedule="noam", learning_rate=5e-3, d_model=32, warmup_steps=4, grad_clip_norm=1.0)
        lr_max = max(S.noam_schedule(5e-3, 32, 4)(s) for s in range(3))
        loss_tol, p_tol = dict(rtol=1e-4, atol=0), dict(rtol=0, atol=2 * lr_max * 3)
    jtrainer = JTrainer(JT.make_eda_loss(jmodel, shuffle_frames=False), JTrainerConfig(**kw))
    state = jtrainer.init_state(v)
    model = EendEdaModel(**SMALL, device="cpu")
    model.load_state_dict(convert.eda_from_flax(v))
    trainer = Trainer(model, make_eda_loss(shuffle_frames=False), TrainerConfig(**kw))
    for b in _batches(3, 50):
        state, jaux = jtrainer.train_step(state, {k: jnp.asarray(a) for k, a in b.items()})
        aux = trainer.train_step({k: torch.from_numpy(a) for k, a in b.items()})
        np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]), **loss_tol)
    got, want = _flat(convert.eend_to_flax(model.state_dict(), num_heads=4)), _flat(state.params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **p_tol)


def test_cli_train_then_infer_eda(tmp_path):
    """`cli train --family eend_eda --device cpu` then `cli infer --exp-dir`
    with the threshold sweep: 18 RTTMs, scored against the reference."""
    root = str(tmp_path)
    c = write_synthetic_corpus(os.path.join(root, "train"), n_recs=2, seconds=10.0, rate=8000, n_speakers=2,
                               seed=12, prefix="tr")
    v = write_synthetic_corpus(os.path.join(root, "valid"), n_recs=1, seconds=8.0, rate=8000, n_speakers=2,
                               seed=13, prefix="va")
    exp = os.path.join(root, "exp")
    sets = ["d_model=16", "n_layers=1", "n_heads=2", "d_ff=32", "chunk_frames=30", "batch_size=2", "num_steps=2",
            "log_every=1", "valid_every=2", "max_attractors=4"]
    argv = ["train", "--family", "eend_eda", "--train-dir", c["data_dir"], "--valid-dir", v["data_dir"],
            "--exp-dir", exp, "--device", "cpu"] + [a for kv in sets for a in ("--set", kv)]
    assert port_cli(argv) == 0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if r["kind"] == "train"] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs if r["kind"] == "train")
    assert {"pit_loss", "attractor_loss", "frame_der"} <= set(recs[0])
    out = os.path.join(root, "hyp")
    assert port_cli(["infer", "--family", "eend_eda", "--data-dir", v["data_dir"], "--exp-dir", exp, "--out", out,
                     "--device", "cpu", "--threshold-sweep", "--ref", v["rttm"], "--attractor-threshold", "0.3"]) == 0
    hyps = sorted(f for f in os.listdir(root) if f.startswith("hyp_"))
    assert len(hyps) == 18
    assert all(t.rec == "va00" for h in hyps for t in read_rttm(os.path.join(root, h)))
