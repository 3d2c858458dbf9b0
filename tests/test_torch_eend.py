"""Port parity of the EEND slice: the log-mel front-end (K1′'s plain twin),
the masked TransformerEncoder, EENDModel, PIT loss and DER statistics, the
chunk dataset, chunked inference, three trainer steps and `cli train` →
`cli infer --exp-dir`, against the JAX package."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.data.eend_dataset import EendChunkDataset as JDataset
from speaker_diarization_tpu.data.eend_dataset import batch_iterator as j_batches
from speaker_diarization_tpu.infer import chunked as JC
from speaker_diarization_tpu.kernels.fbank_pallas import logmel_pallas
from speaker_diarization_tpu.models.eend import EENDModel as JModel
from speaker_diarization_tpu.models.eend import FrontendConfig as JFrontend
from speaker_diarization_tpu.models.transformer import TransformerEncoder as JEncoder
from speaker_diarization_tpu.ops import features as JF
from speaker_diarization_tpu.ops import losses as JL
from speaker_diarization_tpu.ops import metrics as JM
from speaker_diarization_tpu.train import tasks as JT
from speaker_diarization_tpu.train.trainer import Trainer as JTrainer
from speaker_diarization_tpu.train.trainer import TrainerConfig as JTrainerConfig
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data.eend_dataset import EendChunkDataset, batch_iterator
from speaker_diarization_tpu_torch.data.rttm import read_rttm
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.infer import chunked as C
from speaker_diarization_tpu_torch.kernels import fbank as K1
from speaker_diarization_tpu_torch.models.eend import EENDModel, FrontendConfig
from speaker_diarization_tpu_torch.models.transformer import TransformerEncoder
from speaker_diarization_tpu_torch.ops import features as TF
from speaker_diarization_tpu_torch.ops import losses as L
from speaker_diarization_tpu_torch.ops import metrics as M
from speaker_diarization_tpu_torch.train import schedules as S
from speaker_diarization_tpu_torch.train.tasks import make_eend_loss
from speaker_diarization_tpu_torch.train.trainer import Trainer, TrainerConfig
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

SMALL = dict(d_model=32, n_layers=2, n_heads=4, d_ff=64, dropout=0.0)
FP32_TOL = dict(atol=2e-4, rtol=2e-3)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturb(variables, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), variables)


# ---------------------------------------------------------------------------
# front-end
# ---------------------------------------------------------------------------

# (sample_rate, frame_size, frame_shift, samples): 8123 and 16550 are not
# multiples of the shift, 8000 and 16000 are (the last frame is dropped)
LOGMEL_CASES = [(8000, 200, 80, 8000), (8000, 200, 80, 8123), (16000, 400, 160, 16000), (16000, 400, 160, 16550)]


@pytest.mark.parametrize("sr,fs,sh,n", LOGMEL_CASES)
def test_logmel_twin_matches_jax_and_pallas_interpret(sr, fs, sh, n):
    rng = np.random.default_rng(n + sr)
    x = (0.2 * rng.standard_normal((2, n))).astype(np.float32)
    T = TF.count_frames(n, sh)
    assert T == JF.count_frames(n, sh)
    got = TF.logmel_frames_torch(torch.from_numpy(x), T, fs, sh, sr, 23, mean_norm=False).numpy()
    ref = np.asarray(JF.logmel_frames_jax(jnp.asarray(x), T, fs, sh, sr, 23, mean_norm=False))
    pal = np.asarray(logmel_pallas(jnp.asarray(x), T, fs, sh, sr, 23, mean_norm=False, interpret=True))
    assert got.shape == ref.shape == (2, T, 23)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_allclose(got, pal, atol=1e-4)
    # with mean-norm, and the wrapper on a CPU tensor is the same twin
    mn = TF.logmel_frames_torch(torch.from_numpy(x), T, fs, sh, sr, 23).numpy()
    np.testing.assert_allclose(mn, np.asarray(JF.logmel_frames_jax(jnp.asarray(x), T, fs, sh, sr, 23)), atol=1e-4)
    torch.testing.assert_close(K1.logmel_cuda(torch.from_numpy(x), T, fs, sh, sr, 23), torch.from_numpy(got),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,context,ss", [(8000, 7, 10), (8123, 7, 10), (4000, 0, 1), (8000, 2, 3)])
def test_eend_frontend_on_cpu_matches_jax(n, context, ss):
    rng = np.random.default_rng(n + context)
    x = (0.1 * rng.standard_normal((3, n))).astype(np.float32)
    x[2, n // 2 :] = 0.0  # a zero tail: near-floor frames in the mean
    got = TF.eend_frontend_auto(torch.from_numpy(x), n, 200, 80, 8000, 23, context, ss).numpy()
    ref = np.asarray(JF.eend_frontend_jax(jnp.asarray(x), n, 200, 80, 8000, 23, context, ss))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)
    sp = TF.splice_subsample(torch.from_numpy(ref[0].copy()), 3, 4).numpy()
    np.testing.assert_array_equal(sp, JF.splice(ref[0], 3)[::4])


@pytest.mark.parametrize("sr,fs", [(8000, 200), (16000, 400)])
def test_slaney_band_constants_reproduce_the_dense_bank(sr, fs):
    """K1′'s banded slaney weights, window and twiddles describe the same
    function as the dense matrices of logmel_frames_jax."""
    n_fft = TF.fft_size_for(fs)
    c = K1._logmel_consts(sr, 23, fs, n_fft)
    dense_mel = JF.mel_filterbank(sr, n_fft, 23)
    np.testing.assert_array_equal(TF.mel_filterbank(sr, n_fft, 23), dense_mel)
    rng = np.random.default_rng(1)
    p = rng.random((5, n_fft // 2 + 1)).astype(np.float32)
    band = np.stack([(p[:, s : s + c["mel_w"].shape[1]] * c["mel_w"][m]).sum(1) for m, s in enumerate(c["mel_start"])], 1)
    np.testing.assert_allclose(band, p @ dense_mel.T, rtol=1e-5, atol=1e-7)
    assert (c["mel_start"] + c["mel_w"].shape[1] <= n_fft // 2 + 1).all()
    assert int(c["mel_nnz"]) == int((dense_mel > 0).sum())
    np.testing.assert_array_equal(c["window"], JF.pad_center(JF.hann_window(fs), n_fft).astype(np.float32))
    k = np.arange(n_fft // 2)
    np.testing.assert_allclose(c["tw_re"] + 1j * c["tw_im"], np.exp(-2j * np.pi * k / n_fft), atol=1e-6)


def test_numpy_helpers_are_copies():
    for n, sh in ((8000, 80), (8001, 80), (79, 80), (0, 80)):
        assert TF.count_frames(n, sh) == JF.count_frames(n, sh)
    np.testing.assert_array_equal(TF.pad_center(TF.hann_window(200), 256), JF.pad_center(JF.hann_window(200), 256))
    for htk in (False, True):
        np.testing.assert_array_equal(TF.mel_filterbank(8000, 256, 23, htk=htk), JF.mel_filterbank(8000, 256, 23, htk=htk))


def test_logmel_work_counts_are_from_the_shapes():
    w = K1.logmel_work(32, 400000)
    assert w["frames"] == 32 * 5000  # count_frames drops the last frame at N % shift == 0
    assert w["bytes"] == 4.0 * 32 * 400000 + 4.0 * 32 * 5000 * 23
    nnz = int((TF.mel_filterbank(8000, 256, 23) > 0).sum())
    assert w["flops"] == 32 * 5000 * (256 + 2.5 * 256 * 8 + 3 * 129 + 2 * nnz + 23)
    # on the H100 (3.35 TB/s, 67 TFLOP/s fp32) the function is bound by bytes
    assert w["flops"] / 67e12 < w["bytes"] / 3.35e12


# ---------------------------------------------------------------------------
# encoder and model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("has_pos", [False, True])
def test_masked_transformer_encoder_matches_flax(has_pos):
    """Padded query rows get flax's uniform softmax (finfo.min, not -inf):
    finite everywhere, zero on padded frames at the output."""
    rng = np.random.default_rng(int(has_pos))
    x = rng.standard_normal((3, 12, 20)).astype(np.float32)
    fm = np.ones((3, 12), np.float32)
    fm[1, 7:] = 0.0
    fm[2] = 0.0  # an all-padded item
    je = JEncoder(d_model=32, n_layers=2, n_heads=4, d_ff=64, dropout=0.0, has_pos=has_pos, max_len=64)
    v = _perturb(je.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    ref = np.asarray(je.apply(v, jnp.asarray(x), frame_mask=jnp.asarray(fm)))
    enc = TransformerEncoder(20, 32, 2, 4, 64, has_pos=has_pos, max_len=64).eval()
    enc.load_state_dict({k[len("e."):]: t for k, t in convert._encoder_from_flax(v["params"], "e").items()})
    with torch.no_grad():
        got = enc(torch.from_numpy(x), torch.from_numpy(fm)).numpy()
    assert np.isfinite(got).all() and not got[2].any() and not got[1, 7:].any()
    np.testing.assert_allclose(got, ref, **FP32_TOL)


@pytest.fixture(scope="module")
def eend_pair():
    jmodel = JModel(**SMALL)
    v = _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8000))), 1)
    model = EENDModel(**SMALL, device="cpu")
    model.load_state_dict(convert.eend_from_flax(v))
    return jmodel, v, model


def _audio_and_mask(seed, B=3, n=8000):
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((B, n))).astype(np.float32)
    fm = np.ones((B, FrontendConfig().n_frames(n)), np.float32)
    fm[1, 6:] = 0.0
    return x, fm


@pytest.mark.parametrize("n", [8000, 12345])
def test_eend_logits_match_jax(eend_pair, n):
    jmodel, v, model = eend_pair
    x, fm = _audio_and_mask(n, n=n)
    ref = np.asarray(jax.jit(lambda v, a, m: jmodel.apply(v, a, frame_mask=m))(v, jnp.asarray(x), jnp.asarray(fm)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(fm)).numpy()
    assert got.shape == ref.shape == (3, fm.shape[1], 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **FP32_TOL)
    with torch.no_grad():  # features in, no mask
        feats = TF.eend_frontend_auto(torch.from_numpy(x), n)
        np.testing.assert_allclose(model(feats).numpy(), np.asarray(jmodel.apply(v, jnp.asarray(feats.numpy()))),
                                   **FP32_TOL)


def test_eend_bf16_close(eend_pair):
    _, v, _ = eend_pair
    jb = JModel(**SMALL, dtype=jnp.bfloat16)
    x, fm = _audio_and_mask(5)
    ref = np.asarray(jb.apply(v, jnp.asarray(x), frame_mask=jnp.asarray(fm)))
    model = EENDModel(**SMALL, dtype="bf16", device="cpu")
    model.load_state_dict(convert.eend_from_flax(v))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(fm)).numpy()
    assert got.dtype == np.float32
    assert np.mean(np.abs(got - ref)) < 5e-2 * max(1.0, np.mean(np.abs(ref)))


def test_eend_weight_conversion_round_trips(eend_pair):
    _, v, model = eend_pair
    sd = model.state_dict()
    again = convert.eend_from_flax(convert.eend_to_flax(sd, num_heads=4))
    assert set(again) == set(sd)
    for k in sd:
        torch.testing.assert_close(again[k], sd[k], rtol=0, atol=0)
    a, b = _flat(v), _flat(convert.eend_to_flax(sd, num_heads=4))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# losses and statistics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C,masked", [(2, False), (2, True), (3, True), (4, True)])
def test_pit_loss_and_der_stats_match_jax(C, masked):
    rng = np.random.default_rng(C * 10 + masked)
    logits = (2 * rng.standard_normal((4, 25, C))).astype(np.float32)
    labels = (rng.random((4, 25, C)) < 0.4).astype(np.float32)
    fm = sm = None
    if masked:
        fm = (rng.random((4, 25)) < 0.8).astype(np.float32)
        fm[3] = 0.0  # a padded batch item: every permutation ties
        sm = np.ones((4, C), np.float32)
        sm[1, C - 1 :] = 0.0
        sm[2, 1:] = 0.0
        labels = labels * sm[:, None, :]
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    loss, lp, bp = L.pit_loss(t(logits), t(labels), t(fm), t(sm))
    jloss, jlp, jbp = JL.pit_loss(j(logits), j(labels), j(fm), j(sm))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(lp.numpy(), np.asarray(jlp))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(jbp))
    np.testing.assert_array_equal(L.permutation_table(C), JL.permutation_table(C))
    np.testing.assert_allclose(L.pairwise_bce_cost(t(logits), t(labels), t(fm)).numpy(),
                               np.asarray(JL.pairwise_bce_cost(j(logits), j(labels), j(fm))), rtol=1e-5, atol=1e-5)
    got, ref = M.diarization_error_stats(t(logits), lp, t(fm)), JM.diarization_error_stats(j(logits), jlp, j(fm))
    assert got.keys() == ref.keys()
    for k in ref:
        assert int(got[k]) == int(ref[k]), k
    np.testing.assert_allclose(float(M.der_from_stats(got)), float(JM.der_from_stats(ref)), rtol=1e-6)


# ---------------------------------------------------------------------------
# data and inference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eend_corpus"))
    c = write_synthetic_corpus(os.path.join(root, "train"), n_recs=2, seconds=12.0, rate=8000, n_speakers=3,
                               seed=6, prefix="tr")
    v = write_synthetic_corpus(os.path.join(root, "valid"), n_recs=1, seconds=9.0, rate=8000, n_speakers=2,
                               seed=7, prefix="va")
    return dict(train=c, valid=v, root=root)


def test_synthetic_corpus_segments_hold_the_rttm_speakers(corpus):
    """The generated segments/utt2spk describe the RTTM's turns, so the EEND
    dataset finds every RTTM speaker of a recording."""
    c = corpus["train"]
    ds = EendChunkDataset(c["data_dir"], chunk_frames=30)
    by_rec = {}
    for tu in read_rttm(c["rttm"]):
        by_rec.setdefault(tu.rec, set()).add(tu.speaker)
    assert {r: set(s) for r, s in ds.rec_speakers.items()} == by_rec
    n_segs = sum(len(s) for s in ds.kd.segments.values())
    assert n_segs == len(read_rttm(c["rttm"])) == len(ds.kd.utt2spk)


@pytest.mark.parametrize("last_partial", [False, True])
def test_chunk_dataset_and_batches_match_jax(corpus, last_partial):
    c = corpus["train"]
    port = EendChunkDataset(c["data_dir"], 40, FrontendConfig(), 2, use_last_partial=last_partial)
    ref = JDataset(c["data_dir"], 40, JFrontend(), 2, use_last_partial=last_partial)
    assert len(port) == len(ref) > 2
    assert port.chunks == [type(port.chunks[0])(e.rec, e.start_sub, e.end_sub) for e in ref.chunks]
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"item {i} {k}")
    for epoch in (0, 1):
        got = list(batch_iterator(port, 2, True, seed=3, drop_last=False, epoch=epoch))
        want = list(j_batches(ref, 2, True, seed=3, drop_last=False, epoch=epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"epoch {epoch} {k}")


def _predict(a, m):
    """A deterministic stand-in model: per-frame energy → two probabilities."""
    B, T = m.shape
    e = np.abs(a).reshape(B, T, -1).mean(-1)
    p = 1.0 / (1.0 + np.exp(-(e - 0.05) * 40.0))
    return np.stack([p, 1.0 - p], -1).astype(np.float32) * m[..., None]


@pytest.mark.parametrize("n", [8000 * 7 + 123, 800 * 3, 500])
def test_infer_recording_matches_jax(n):
    audio = (0.1 * np.random.default_rng(n).standard_normal(n)).astype(np.float32)
    got = C.infer_recording(_predict, audio, FrontendConfig(), chunk_frames=20, batch_size=3)
    ref = JC.infer_recording(_predict, audio, JFrontend(), chunk_frames=20, batch_size=3)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_infer_dataset_with_the_model_matches_jax(corpus, eend_pair):
    """`make_eend_predict` over a corpus against the JAX model through the JAX
    infer_dataset (the tail chunk padded and mean-normed with its zeros)."""
    jmodel, v, model = eend_pair
    d = corpus["valid"]["data_dir"]
    fn = jax.jit(lambda a, m: jax.nn.sigmoid(jmodel.apply(v, a, frame_mask=m)) * m[..., None])
    ref = JC.infer_dataset(lambda a, m: fn(jnp.asarray(a), jnp.asarray(m)), d, JFrontend(), chunk_frames=40, batch_size=2)
    got = C.infer_dataset(C.make_eend_predict(model), d, FrontendConfig(), chunk_frames=40, batch_size=2)
    assert got.keys() == ref.keys()
    for rec in ref:
        assert got[rec].shape == ref[rec].shape
        np.testing.assert_allclose(got[rec], ref[rec], atol=1e-4)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt", ["sgd", "adam_noam_clip"])
def test_eend_trainer_steps_match_jax(eend_pair, opt):
    """Three train steps of a small EEND (dropout 0): losses and weights, as
    test_torch_train holds TS-VAD (sgd to 1e-5 relative; adam to 2·lr·steps)."""
    jmodel, v, _ = eend_pair
    if opt == "sgd":
        kw = dict(optimizer="sgd", schedule="const", learning_rate=3e-2, grad_clip_norm=None)
        loss_tol, p_tol = dict(rtol=1e-5, atol=0), dict(rtol=1e-5, atol=1e-6)
    else:
        kw = dict(optimizer="adam", schedule="noam", learning_rate=5e-3, d_model=32, warmup_steps=4, grad_clip_norm=1.0)
        lr_max = max(S.noam_schedule(5e-3, 32, 4)(s) for s in range(3))
        loss_tol, p_tol = dict(rtol=1e-4, atol=0), dict(rtol=0, atol=2 * lr_max * 3)
    rng = np.random.default_rng(11)
    batches = []
    for i in range(3):
        x, fm = _audio_and_mask(20 + i, B=2)
        sm = np.array([[1, 1], [1, 0]], np.float32)
        labels = (rng.random((2, fm.shape[1], 2)) < 0.4).astype(np.float32) * sm[:, None, :] * fm[..., None]
        batches.append(dict(audio=x, frame_mask=fm, labels=labels, spk_mask=sm))
    jtrainer = JTrainer(JT.make_eend_loss(jmodel), JTrainerConfig(**kw))
    state = jtrainer.init_state(v)
    model = EENDModel(**SMALL, device="cpu")
    model.load_state_dict(convert.eend_from_flax(v))
    trainer = Trainer(model, make_eend_loss(), TrainerConfig(**kw))
    for b in batches:
        state, jaux = jtrainer.train_step(state, {k: jnp.asarray(a) for k, a in b.items()})
        aux = trainer.train_step({k: torch.from_numpy(a) for k, a in b.items()})
        np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]), **loss_tol)
        np.testing.assert_allclose(aux["frame_der"].item(), float(jaux["frame_der"]), rtol=1e-6)
    got, want = _flat(convert.eend_to_flax(model.state_dict(), num_heads=4)), _flat(state.params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **p_tol)


def test_cli_train_then_infer_eend(corpus):
    """`cli train --family eend --device cpu` (validation, checkpoints) then
    `cli infer --exp-dir` (family from the run) writes the RTTM."""
    c, v = corpus["train"], corpus["valid"]
    exp = os.path.join(corpus["root"], "exp_eend")
    sets = ["d_model=16", "n_layers=1", "n_heads=2", "d_ff=32", "chunk_frames=30", "batch_size=2", "num_steps=3",
            "log_every=1", "valid_every=2", "n_speakers=3"]
    argv = ["train", "--family", "eend", "--train-dir", c["data_dir"], "--valid-dir", v["data_dir"], "--exp-dir", exp,
            "--device", "cpu"] + [a for kv in sets for a in ("--set", kv)]
    assert port_cli(argv) == 0
    with open(os.path.join(exp, "train_config.json")) as f:
        saved = json.load(f)
    assert (saved["family"], saved["n_speakers"], saved["chunk_frames"]) == ("eend", 3, 30)
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if r["kind"] == "train"] == [1, 2, 3]
    assert [r["step"] for r in recs if r["kind"] == "valid"] == [2]
    assert all(np.isfinite(r["loss"]) for r in recs)
    out = os.path.join(corpus["root"], "hyp_eend.rttm")
    assert port_cli(["infer", "--data-dir", v["data_dir"], "--exp-dir", exp, "--out", out, "--device", "cpu"]) == 0
    turns = read_rttm(out)
    assert turns and {t.rec for t in turns} <= {"va00"} and {t.speaker for t in turns} <= {"va00_0", "va00_1", "va00_2"}
