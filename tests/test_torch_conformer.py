"""Port parity of the conformer slice: ConformerEncoder (batch and group
conv norms, eval and train mode, padding masks), EEND-EDA with a conformer
encoder (__call__, infer, loss and gradients), the TS-VAD conformer and
BiLSTM backends (the LSTM reversed as flax's nn.RNN(reverse=True,
keep_order=True)), and the weights both ways, against the JAX package."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.models.conformer import ConformerEncoder as JEncoder
from speaker_diarization_tpu.models.eda import EendEdaModel as JEda
from speaker_diarization_tpu.models.tsvad import TSVADConfig as JConfig
from speaker_diarization_tpu.models.tsvad import TSVADModel as JModel
from speaker_diarization_tpu.train import tasks as JT
from speaker_diarization_tpu_torch.models.conformer import ConformerEncoder
from speaker_diarization_tpu_torch.models.eda import LSTM, EendEdaModel
from speaker_diarization_tpu_torch.models.eend import FrontendConfig
from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
from speaker_diarization_tpu_torch.train.tasks import make_eda_loss
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturb(variables, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + scale * rng.standard_normal(a.shape).astype(np.float32), variables)
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])  # positive variances
    return v


def _fp32_close(got, ref):
    """fp32 modules: max-abs 1e-4 · max(1, max|ref|)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def _grads_close(got: dict, want: dict):
    """Gradients: 1e-3 · max|ref grad| per tensor. A gradient that is zero
    in exact arithmetic (the attention key bias: softmax ignores a shift
    along a row) is rounding noise on both sides: both stay below 1e-6 of
    the largest gradient."""
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for k in want:
        scale = np.abs(want[k]).max()
        if scale < 1e-6 * top:
            assert np.abs(got[k]).max() < 1e-6 * top, k
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3 * scale, err_msg=k)


# ---------------------------------------------------------------------------
# ConformerEncoder
# ---------------------------------------------------------------------------

ENC = dict(d_model=32, n_layers=2, n_heads=4, d_ff=48, conv_kernel=7, dropout=0.0)


def _encoder_pair(conv_norm):
    jm = JEncoder(**ENC, conv_norm=conv_norm)
    x = np.zeros((1, 9, 20), np.float32)
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.ones((1, 9))), 1)
    m = ConformerEncoder(20, **ENC, conv_norm=conv_norm)
    m.load_state_dict(convert.named_from_flax(v["params"], v.get("batch_stats", {})))
    return jm, v, m.eval()


def _encoder_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 17, 20)).astype(np.float32)
    fm = np.ones((3, 17), np.float32)
    fm[1, 11:] = 0.0
    fm[2, 4:] = 0.0
    return x, fm


@pytest.mark.parametrize("conv_norm", ["batch", "group"])
def test_conformer_encoder_eval_matches_jax(conv_norm):
    jm, v, m = _encoder_pair(conv_norm)
    x, fm = _encoder_inputs(2)
    ref = jm.apply(v, jnp.asarray(x), jnp.asarray(fm))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(fm))
    assert got.shape == (3, 17, 32)
    assert np.all(got.numpy()[fm == 0] == 0.0)  # padded frames zeroed
    _fp32_close(got, ref)
    with torch.no_grad():  # no mask: every frame attends everywhere
        _fp32_close(m(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("conv_norm", ["batch", "group"])
def test_conformer_encoder_train_matches_jax(conv_norm):
    """Train mode (dropout 0): batch statistics in the conv module's
    BatchNorm, the running ones moved as flax moves them."""
    jm, v, m = _encoder_pair(conv_norm)
    x, fm = _encoder_inputs(3)
    ref, new = jm.apply(v, jnp.asarray(x), jnp.asarray(fm), train=True, mutable=["batch_stats"])
    m.train()
    got = m(torch.from_numpy(x), torch.from_numpy(fm), torch.Generator().manual_seed(0))
    _fp32_close(got.detach(), ref)
    if conv_norm == "batch":
        want = convert.named_from_flax(v["params"], jax.device_get(new["batch_stats"]))
        sd = m.state_dict()
        for k, t in want.items():
            if "running_" in k:
                np.testing.assert_allclose(sd[k].numpy(), t.numpy(), atol=1e-5, err_msg=k)
    else:
        assert not new.get("batch_stats")


def test_conformer_dropout_draws_from_the_generator():
    _, _, m = _encoder_pair("group")
    m.train()
    for mod in m.modules():
        if hasattr(mod, "dropout"):
            mod.dropout = 0.3
    x = torch.from_numpy(_encoder_inputs(4)[0])
    a = m(x, None, torch.Generator().manual_seed(7))
    b = m(x, None, torch.Generator().manual_seed(7))
    c = m(x, None, torch.Generator().manual_seed(8))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


# ---------------------------------------------------------------------------
# EEND-EDA with a conformer encoder
# ---------------------------------------------------------------------------

EDA = dict(d_model=32, n_layers=2, n_heads=4, d_ff=64, dropout=0.0, max_attractors=5, encoder_type="conformer")


@pytest.fixture(scope="module", params=["group", "batch"])
def eda_pair(request):
    kw = dict(EDA, conv_norm=request.param)
    jmodel = JEda(**kw)
    v = _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8000))), 1)
    model = EendEdaModel(**kw, device="cpu")
    model.load_state_dict(convert.eda_from_flax(v))
    return jmodel, v, model


def _audio_and_mask(seed, B=3, n=8000):
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((B, n))).astype(np.float32)
    fm = np.ones((B, FrontendConfig().n_frames(n)), np.float32)
    fm[1, 6:] = 0.0
    return x, fm


@pytest.mark.parametrize("with_order", [False, True])
def test_eda_conformer_call_matches_jax(eda_pair, with_order):
    jmodel, v, model = eda_pair
    x, fm = _audio_and_mask(7)
    order = None
    if with_order:
        rng = np.random.default_rng(8)
        order = np.argsort(rng.random(fm.shape) - fm, axis=-1).astype(np.int32)
    lo_r, ex_r = jmodel.apply(v, jnp.asarray(x), frame_mask=jnp.asarray(fm),
                              order=None if order is None else jnp.asarray(order))
    with torch.no_grad():
        lo, ex = model(torch.from_numpy(x), torch.from_numpy(fm), None if order is None else torch.from_numpy(order).long())
    assert lo.shape == (3, fm.shape[1], 2) and ex.shape == (3, 3)
    _fp32_close(lo, lo_r)
    _fp32_close(ex, ex_r)


def test_eda_conformer_infer_matches_jax(eda_pair):
    jmodel, v, model = eda_pair
    x, fm = _audio_and_mask(9, n=12345)
    lo_r, p_r = jmodel.apply(v, jnp.asarray(x), frame_mask=jnp.asarray(fm), method=jmodel.infer)
    with torch.no_grad():
        lo, p = model.infer(torch.from_numpy(x), torch.from_numpy(fm))
    assert lo.shape == (3, fm.shape[1], 5) and p.shape == (3, 5)
    _fp32_close(lo, lo_r)
    _fp32_close(p, p_r)


def test_eda_conformer_weights_round_trip(eda_pair):
    _, v, model = eda_pair
    sd = model.state_dict()
    back = convert.eend_to_flax(sd, num_heads=4)
    a, b = _flat(v), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    again = convert.eda_from_flax(back)
    assert set(again) == set(sd)


def test_eda_conformer_loss_and_gradients_match_jax():
    """The CLI's conformer (GroupNorm, no batch statistics) in train mode
    (dropout 0, no frame shuffle): the loss and every parameter's gradient."""
    kw = dict(EDA, conv_norm="group")
    jmodel = JEda(**kw)
    v = _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8000))), 2)
    model = EendEdaModel(**kw, device="cpu")
    model.load_state_dict(convert.eda_from_flax(v))
    x, fm = _audio_and_mask(11, B=2)
    sm = np.array([[1, 1], [1, 0]], np.float32)
    labels = (np.random.default_rng(12).random((2, fm.shape[1], 2)) < 0.4).astype(np.float32) * sm[:, None] * fm[..., None]
    batch = dict(audio=x, frame_mask=fm, labels=labels, spk_mask=sm)
    jloss_fn = JT.make_eda_loss(jmodel, shuffle_frames=False)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    jloss, jgrads = jax.value_and_grad(lambda p: jloss_fn(p, jb, jax.random.PRNGKey(0), True)[0])(v)
    model.train()
    loss, _ = make_eda_loss(shuffle_frames=False)(model, {k: torch.from_numpy(a) for k, a in batch.items()},
                                                  torch.Generator().manual_seed(0), True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    grads = {n: p.grad for n, p in model.named_parameters()}
    _grads_close(_flat(convert.eend_to_flax(grads, num_heads=4)), _flat(jgrads))


# ---------------------------------------------------------------------------
# TS-VAD backends
# ---------------------------------------------------------------------------

TINY = dict(encoder_block_layers=(1, 1), transformer_embed_dim=32, transformer_ffn_embed_dim=64,
            num_attention_head=4, speaker_embed_dim=16, num_transformer_layer=2, dropout=0.0, sample_rate=8000)
BACKENDS = [("conformer", "conformer"), ("transformer", "lstm")]


def test_lstm_reverse_matches_flax_keep_order():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 6)).astype(np.float32)
    rnn = fnn.RNN(fnn.OptimizedLSTMCell(5), reverse=True, keep_order=True, return_carry=True)
    v = _perturb(rnn.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    (c_ref, h_ref), out_ref = rnn.apply(v, jnp.asarray(x))
    lstm = LSTM(6, 5, reverse=True)
    lstm.load_state_dict({k[len("l."):]: t for k, t in convert._lstm_from_flax(v["params"]["cell"], "l").items()})
    with torch.no_grad():
        (c, h), out = lstm(torch.from_numpy(x))
    for got, ref in ((out, out_ref), (c, c_ref), (h, h_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def _tsvad_pair(single, multi):
    cfg = dict(TINY, single_backend_type=single, multi_backend_type=multi)
    jmodel = JModel(cfg=JConfig(**cfg))
    v = jax.jit(jmodel.init, static_argnums=3)(jax.random.PRNGKey(0), jnp.zeros((1, 8000)), jnp.zeros((1, 4, 16)), 13)
    model = TSVADModel(TSVADConfig(**cfg), device="cpu")
    v = _perturb(v, 3, 0.05)
    model.load_state_dict(convert.tsvad_from_flax(v))
    return jmodel, v, model


def _tsvad_inputs(seed, B=2, n=16000):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((B, n))).astype(np.float32), rng.standard_normal((B, 4, 16)).astype(np.float32)


@pytest.mark.parametrize("single,multi", BACKENDS)
def test_tsvad_backend_logits_match_jax(single, multi):
    jmodel, v, model = _tsvad_pair(single, multi)
    audio, embs = _tsvad_inputs(4)
    ref = np.asarray(jmodel.apply(v, jnp.asarray(audio), jnp.asarray(embs)))
    with torch.no_grad():
        got = model(torch.from_numpy(audio), torch.from_numpy(embs)).numpy()
    assert got.shape == ref.shape == (2, 50, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)


@pytest.mark.parametrize("single,multi", BACKENDS)
def test_tsvad_backend_bf16_close(single, multi):
    _, v, _ = _tsvad_pair(single, multi)
    cfg = JConfig(**TINY, single_backend_type=single, multi_backend_type=multi)
    ref = np.asarray(JModel(cfg=cfg, dtype=jnp.bfloat16).apply(v, *map(jnp.asarray, _tsvad_inputs(5))))
    model = TSVADModel(TSVADConfig(**TINY, single_backend_type=single, multi_backend_type=multi), dtype="bf16",
                       device="cpu")
    model.load_state_dict(convert.tsvad_from_flax(v))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, _tsvad_inputs(5))).numpy()
    assert np.mean(np.abs(got - ref)) < 5e-2


def test_tsvad_conformer_train_mode_matches_jax():
    """Train mode (dropout 0): logits and the batch statistics of every
    BatchNorm, the conformer conv modules' among them, as flax moves them."""
    jmodel, v, model = _tsvad_pair("conformer", "conformer")
    audio, embs = _tsvad_inputs(6)
    ref, new = jmodel.apply(v, jnp.asarray(audio), jnp.asarray(embs), train=True, mutable=["batch_stats"])
    model.train()
    got = model(torch.from_numpy(audio), torch.from_numpy(embs), generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=2e-3)
    want = convert.tsvad_from_flax({"params": v["params"], "batch_stats": jax.device_get(new["batch_stats"])})
    sd = model.state_dict()
    conv_stats = [k for k in want if "running_" in k and ".conformer." in k]
    assert conv_stats
    for k in conv_stats:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=1e-4, err_msg=k)


@pytest.mark.parametrize("single,multi", BACKENDS)
def test_tsvad_backend_weights_round_trip(single, multi):
    _, v, model = _tsvad_pair(single, multi)
    sd = model.state_dict()
    back = convert.tsvad_to_flax(sd, num_heads=4)
    a, b = _flat(v), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    again = convert.tsvad_from_flax(back)
    assert set(again) == set(sd)
    for k in sd:
        torch.testing.assert_close(again[k], sd[k], rtol=0, atol=0)
