"""`remat` in the port: activations recomputed in the backward pass
(torch.utils.checkpoint) where JAX rematerialises, each CAM++ dense layer
(TS-VAD's `remat_encoder`) and each transformer layer of EEND and EEND-EDA.
A step with remat on must equal the step with it off bit for bit in fp32 on
the CPU: loss, gradients and BatchNorm running statistics. Two traps are
pinned: the recomputation must draw the same dropout masks from the
caller's torch.Generator, and a train-mode BatchNorm must move its running
statistics once. Against JAX with remat on, at the usual tolerances."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.models.eend import EENDModel as JEend
from speaker_diarization_tpu.models.tsvad import TSVADConfig as JConfig
from speaker_diarization_tpu.models.tsvad import TSVADModel as JModel
from speaker_diarization_tpu.train import tasks as JT
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.models import layers
from speaker_diarization_tpu_torch.models.eda import EendEdaModel
from speaker_diarization_tpu_torch.models.eend import EENDModel, FrontendConfig
from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
from speaker_diarization_tpu_torch.train.tasks import make_eda_loss, make_eend_loss, make_tsvad_loss
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

TSVAD = dict(encoder_block_layers=(2, 2), transformer_embed_dim=32, transformer_ffn_embed_dim=64,
             num_attention_head=2, speaker_embed_dim=16, num_transformer_layer=1, sample_rate=8000)
EEND = dict(d_model=32, n_layers=2, n_heads=4, d_ff=64)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tsvad_batch(seed, B=3):
    rng = np.random.default_rng(seed)
    return dict(audio=torch.from_numpy((0.1 * rng.standard_normal((B, 8000))).astype(np.float32)),
                target_embs=torch.from_numpy(rng.standard_normal((B, 4, 16)).astype(np.float32)),
                labels=torch.from_numpy((rng.random((B, 25, 4)) < 0.4).astype(np.float32)))


def _eend_batch(seed, B=2, n=8000):
    rng = np.random.default_rng(seed)
    T = FrontendConfig().n_frames(n)
    fm = np.ones((B, T), np.float32)
    fm[1, 6:] = 0.0
    sm = np.array([[1, 1], [1, 0]], np.float32)[:B]
    labels = (rng.random((B, T, 2)) < 0.4).astype(np.float32) * sm[:, None] * fm[..., None]
    return dict(audio=torch.from_numpy((0.1 * rng.standard_normal((B, n))).astype(np.float32)),
                frame_mask=torch.from_numpy(fm), labels=torch.from_numpy(labels), spk_mask=torch.from_numpy(sm))


def _step(model, loss_fn, batch, seed):
    """One train-mode forward and backward: (loss, {name: grad}, {name: buffer})."""
    model.train()
    model.zero_grad()
    loss, _ = loss_fn(model, batch, torch.Generator().manual_seed(seed), True)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return loss.detach(), grads, {n: b.clone() for n, b in model.named_buffers()}


def _assert_same_step(a, b):
    (la, ga, ba), (lb, gb, bb) = a, b
    torch.testing.assert_close(la, lb, rtol=0, atol=0)
    assert ga.keys() == gb.keys() and ga
    for k in ga:
        torch.testing.assert_close(ga[k], gb[k], rtol=0, atol=0, msg=k)
    assert ba.keys() == bb.keys()
    for k in ba:
        torch.testing.assert_close(ba[k], bb[k], rtol=0, atol=0, msg=k)


def _grads_close(got: dict, want: dict):
    """Gradients: 1e-3 · max|ref grad| per tensor. A gradient that is zero
    in exact arithmetic (the attention key bias; a conv bias before a
    train-mode BatchNorm) is rounding noise on both sides: both stay below
    1e-6 of the largest gradient."""
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for k in want:
        scale = np.abs(want[k]).max()
        if scale < 1e-6 * top:
            assert np.abs(got[k]).max() < 1e-6 * top, k
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3 * scale, err_msg=k)


def _pair(make):
    """The same model built twice, remat off and on, with the same weights."""
    off, on = make(False), make(True)
    on.load_state_dict(off.state_dict())
    return off, on


def test_tsvad_remat_encoder_step_is_bitwise_the_plain_step():
    """CAM++ dense layers rematerialised in train mode, dropout on in the
    backends: loss, every gradient and every BatchNorm's running statistics
    (moved once, not again by the recomputation) equal bit for bit."""
    off, on = _pair(lambda r: TSVADModel(TSVADConfig(**TSVAD, dropout=0.1), device="cpu", seed=2, remat_encoder=r))
    assert all(b.remat for b in on.speech_encoder.xvector if hasattr(b, "remat"))
    batch = _tsvad_batch(1)
    before = {k: t.clone() for k, t in on.state_dict().items() if "running_mean" in k and ".block1." in k}
    a, b = _step(off, make_tsvad_loss(25), batch, 3), _step(on, make_tsvad_loss(25), batch, 3)
    _assert_same_step(a, b)
    assert before and all(not torch.equal(b[2][k], t) for k, t in before.items())  # they moved, once


@pytest.mark.parametrize("family", ["eend", "eend_eda"])
def test_eend_remat_step_with_dropout_is_bitwise_the_plain_step(family):
    """Transformer layers rematerialised with dropout 0.1: the recomputation
    draws the masks of the forward from the caller's generator again."""
    if family == "eend":
        make, loss_fn = (lambda r: EENDModel(n_speakers=2, dropout=0.1, **EEND, device="cpu", seed=4, remat=r)), \
            make_eend_loss()
    else:
        make, loss_fn = (lambda r: EendEdaModel(n_speakers=2, dropout=0.1, **EEND, device="cpu", seed=4, remat=r)), \
            make_eda_loss(shuffle_frames=False)
    off, on = _pair(make)
    batch = _eend_batch(5)
    _assert_same_step(_step(off, loss_fn, batch, 6), _step(on, loss_fn, batch, 6))


class _Noisy(torch.nn.Module):
    """A layer that draws dropout from the generator and has a train-mode
    BatchNorm: the two things a recomputation must not change."""

    def __init__(self):
        super().__init__()
        self.lin = layers.Linear(6, 6)
        self.bn = layers.BatchNorm(6)

    def forward(self, x, generator):
        h = layers.dropout(self.lin(x), 0.5, True, generator)
        return self.bn(h.transpose(1, 2)).transpose(1, 2)


def test_remat_replays_the_dropout_masks_and_moves_statistics_once():
    torch.manual_seed(0)
    plain, ckpt = _Noisy(), _Noisy()
    ckpt.load_state_dict(plain.state_dict())
    x = torch.randn(3, 5, 6)
    outs = []
    for mod, use in ((plain, False), (ckpt, True)):
        g = torch.Generator().manual_seed(11)
        xi = x.clone().requires_grad_()
        y = layers.remat(mod, xi, g, generator=g) if use else mod(xi, g)
        tail = torch.empty(4).uniform_(generator=g)  # the draws after the layer are the same too
        (y * torch.arange(6.0)).sum().backward()
        outs.append((y.detach(), xi.grad, tail, mod.bn.running_mean.clone(), mod.bn.running_var.clone(),
                     mod.lin.weight.grad, g.get_state()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_tsvad_remat_matches_jax():
    """TS-VAD with remat_encoder (dropout 0, train mode) against the JAX
    function: the loss and every parameter's gradient, fed fbank features.
    The JAX model's own remat_encoder raises (its nn.remat of the CAM++
    layer marks x static instead of `train`, flax counting self as argument
    0; ROADMAP §3), so the JAX side runs without remat, which computes the
    same function. At 48 fbank frames: the fp32 gradients of this small
    CAM++ in train mode are well conditioned there (at 100 frames both
    frameworks' fp32 head gradients stray ~1% from a float64 run)."""
    cfg = dict(TSVAD, dropout=0.0)
    rng = np.random.default_rng(7)
    fb = rng.standard_normal((3, 48, 80)).astype(np.float32)
    embs = rng.standard_normal((3, 4, 16)).astype(np.float32)
    labels = (rng.random((3, 12, 4)) < 0.4).astype(np.float32)
    with pytest.raises(jax.errors.TracerBoolConversionError):
        JModel(cfg=JConfig(**cfg), remat_encoder=True).init(jax.random.PRNGKey(0), jnp.asarray(fb), jnp.asarray(embs),
                                                             12)
    jmodel = JModel(cfg=JConfig(**cfg))
    v = jax.jit(jmodel.init, static_argnums=3)(jax.random.PRNGKey(0), jnp.asarray(fb), jnp.asarray(embs), 12)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    jloss_fn = JT.make_tsvad_loss(jmodel, 12)
    jb = dict(audio=jnp.asarray(fb), target_embs=jnp.asarray(embs), labels=jnp.asarray(labels))

    def jl(p):
        return jloss_fn(p, {"batch_stats": v["batch_stats"]}, jb, jax.random.PRNGKey(0), True)[0]

    jloss, jgrads = jax.value_and_grad(jl)(v["params"])
    model = TSVADModel(TSVADConfig(**cfg), device="cpu", remat_encoder=True)
    model.load_state_dict(convert.tsvad_from_flax(v))
    batch = {k: torch.from_numpy(a) for k, a in dict(audio=fb, target_embs=embs, labels=labels).items()}
    loss, grads, _ = _step(model, make_tsvad_loss(12), batch, 0)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    _grads_close(_flat(convert.tsvad_to_flax(grads, num_heads=2)["params"]), _flat(jgrads))


def test_eend_remat_matches_jax_remat():
    """EEND with remat on both sides (dropout 0: the JAX layer's nn.remat
    traces `deterministic`, so JAX's remat raises at any dropout above 0,
    ROADMAP §3): loss and gradients."""
    kw = dict(n_speakers=2, dropout=0.0, **EEND)
    jmodel = JEend(**kw, remat=True)
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8000)))
    rng = np.random.default_rng(8)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), v)
    batch = _eend_batch(9)
    jb = {k: jnp.asarray(t.numpy()) for k, t in batch.items()}
    jloss, jgrads = jax.value_and_grad(lambda p: JT.make_eend_loss(jmodel)(p, jb, jax.random.PRNGKey(0), True)[0])(v)
    model = EENDModel(**kw, device="cpu", remat=True)
    model.load_state_dict(convert.eend_from_flax(v))
    loss, grads, _ = _step(model, make_eend_loss(), batch, 0)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    _grads_close(_flat(convert.eend_to_flax(grads, num_heads=4)), _flat(jgrads))


def test_cli_train_with_remat(tmp_path):
    """`train --set remat=true` runs (it raised before) and records remat."""
    root = str(tmp_path)
    c = write_synthetic_corpus(os.path.join(root, "train"), n_recs=2, seconds=10.0, rate=8000, n_speakers=2,
                               emb_dim=192, seed=3, prefix="tr")
    exp = os.path.join(root, "exp")
    sets = ["remat=true", "d_model=16", "n_layers=2", "n_heads=2", "d_ff=32", "chunk_frames=30", "batch_size=2",
            "num_steps=2", "log_every=1", "valid_every=100"]
    assert port_cli(["train", "--family", "eend", "--train-dir", c["data_dir"], "--exp-dir", exp, "--device", "cpu"]
                    + [a for kv in sets for a in ("--set", kv)]) == 0
    with open(os.path.join(exp, "train_config.json")) as f:
        assert json.load(f)["remat"] is True
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        assert all(np.isfinite(json.loads(line)["loss"]) for line in f)
