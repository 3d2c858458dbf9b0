"""Shared parts of the speech-encoder zoo's parity tests (test_torch_wavlm,
_whisper, _w2vbert, _eres2net, _redimnet): seeded JAX variables carried to
the port, the stated tolerances, and one TS-VAD forward, loss and gradient
step held to the JAX TSVADModel."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from speaker_diarization_tpu.models.tsvad import TSVADConfig as JConfig
from speaker_diarization_tpu.models.tsvad import TSVADModel as JModel
from speaker_diarization_tpu.ops import features as JF
from speaker_diarization_tpu.train import tasks as JT
from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
from speaker_diarization_tpu_torch.train.tasks import make_tsvad_loss
from speaker_diarization_tpu_torch.utils import convert

# TS-VAD backends cut to a layer of width 32, so the encoder dominates
TINY_BACKEND = dict(transformer_embed_dim=32, transformer_ffn_embed_dim=64, num_attention_head=2,
                    speaker_embed_dim=16, num_transformer_layer=1, dropout=0.0)


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def perturb(variables, seed, scale=0.05):
    """Seeded noise on every weight and statistic (positive variances), so
    no initializer's zeros or ones hide a mapping fault."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + scale * rng.standard_normal(a.shape).astype(np.float32), variables)
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    return v


def init_variables(module, *args, seed: int = 1, **kwargs):
    """Seeded random variables in the shapes `module.init(*args)` gives,
    without compiling the init: kernels N(0, 1/fan_in), biases and means
    N(0, 0.01), scales 1 + N(0, 0.01), variances 1 + U(0, 0.2), the
    parameters a module holds directly N(0, 0.01)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if name == "kernel":
            return (rng.standard_normal(shape) / np.sqrt(max(1, int(np.prod(shape[:-1]))))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "var":
            return (1.0 + 0.2 * rng.random(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(shapes))


def fp32_close(got, ref):
    """fp32 modules: max-abs 1e-4 · max(1, max|ref|)."""
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def stats_close(got_sd: dict, want_sd: dict):
    """Train-mode BatchNorm running statistics: 1e-4, relative where they
    are larger than 1 (as tests/test_torch_speaker_encoders.py holds them)."""
    n = 0
    for k, t in want_sd.items():
        if "running_" in k:
            np.testing.assert_allclose(got_sd[k].numpy(), t.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)
            n += 1
    return n


def grads_close(got: dict, want: dict):
    """Gradients: 1e-3 · max|ref grad| per tensor. A gradient that is zero
    in exact arithmetic (a conv bias before a train-mode BatchNorm, a block
    no output reads) is rounding noise on both sides: both stay below 1e-6
    of the largest gradient."""
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))[:6]
    top = max(np.abs(w).max() for w in want.values())
    for k in want:
        scale = np.abs(want[k]).max()
        if scale < 1e-6 * top:
            assert np.abs(got[k]).max() < 1e-6 * top, k
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3 * scale, err_msg=k)


def jax_fbank(audio: np.ndarray, rate: int, bins: int) -> np.ndarray:
    """The JAX package's mean-normed kaldi fbank, fed to both sides where a
    ReLU would flip on the twins' ~1e-5 difference."""
    return np.array(JF.kaldi_fbank_jax(jnp.asarray(audio), rate, bins, mean_norm=True))


def tsvad_pair(cfg: dict, x: np.ndarray, embs: np.ndarray, n_label: int, seed: int = 1):
    """(JAX model, perturbed variables, the port's TSVADModel on the CPU with
    those weights) for TSVADConfig(**cfg); `x` is audio or fbank."""
    jmodel = JModel(cfg=JConfig(**cfg))
    v = init_variables(jmodel, jnp.asarray(x), jnp.asarray(embs), n_label, seed=seed)
    model = TSVADModel(TSVADConfig(**cfg), device="cpu")
    model.load_state_dict(convert.tsvad_from_flax(v))
    return jmodel, v, model


def check_tsvad(jmodel, v, model, x, embs, n_label: int, seed: int = 3, train_grads: bool = True):
    """The eval logits, then one train-mode loss and the moved BatchNorm
    statistics, and the loss's gradients, against the JAX TSVADModel; the
    weights round-trip to the same flax tree. → the eval logits.

    `train_grads=False` takes the gradients of the eval-mode loss instead:
    through a deep stack of train-mode BatchNorms (ERes2NetV2's 13 blocks,
    ReDimNet's stages) the fp32 gradient is ill-conditioned in both
    frameworks (JAX's own fp32 gradient strays up to 11% from its float64
    one at these shapes), while the eval-mode gradient agrees with float64
    to ~1e-5 in both."""
    labels = (np.random.default_rng(seed).random((x.shape[0], n_label, jmodel.cfg.max_num_speaker)) < 0.4)
    labels = labels.astype(np.float32)
    jb = dict(audio=jnp.asarray(x), target_embs=jnp.asarray(embs), labels=jnp.asarray(labels))
    jloss_fn = JT.make_tsvad_loss(jmodel, n_label)
    stats = {"batch_stats": v["batch_stats"]}

    def jl(p, train):
        loss, (_, new) = jloss_fn(p, stats, jb, jax.random.PRNGKey(0), train)
        return loss, new

    @jax.jit
    def reference(p):
        """(eval logits, train loss, its new statistics, the loss whose
        gradients are compared, those gradients), in one compile."""
        logits = jmodel.apply({"params": p, **stats}, jb["audio"], jb["target_embs"], n_label)
        (tloss, tnew), tgrads = jax.value_and_grad(jl, has_aux=True)(p, True) if train_grads else (jl(p, True), None)
        if train_grads:
            return logits, tloss, tnew, tloss, tgrads
        (eloss, _), egrads = jax.value_and_grad(jl, has_aux=True)(p, False)
        return logits, tloss, tnew, eloss, egrads

    ref, jloss, jnew, jgloss, jgrads = reference(v["params"])
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(embs), n_label)
    fp32_close(got, ref)
    batch = {k: torch.from_numpy(a) for k, a in dict(audio=x, target_embs=embs, labels=labels).items()}

    def port_step(train: bool):
        model.train(train)
        model.zero_grad()
        loss, _ = make_tsvad_loss(n_label)(model, batch, torch.Generator().manual_seed(0), train)
        loss.backward()
        model.eval()
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad) for n, p in model.named_parameters()}
        return loss.item(), flat(convert.tsvad_to_flax(grads, num_heads=jmodel.cfg.num_attention_head)["params"])

    loss, grads = port_step(True)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
    want = convert.tsvad_from_flax({"params": v["params"], "batch_stats": jax.device_get(jnew["batch_stats"])})
    assert stats_close(model.state_dict(), want) > 0
    if not train_grads:
        model.load_state_dict({k: t for k, t in convert.tsvad_from_flax(v).items() if "running_" in k}, strict=False)
        loss, grads = port_step(False)
        np.testing.assert_allclose(loss, float(jgloss), rtol=1e-4)
    grads_close(grads, flat(jgrads))
    back = flat(convert.tsvad_to_flax(
        {**model.state_dict(), **{k: t for k, t in convert.tsvad_from_flax(v).items() if "running_" in k}},
        num_heads=jmodel.cfg.num_attention_head))
    a = flat(v)
    assert back.keys() == a.keys()
    for k in a:
        np.testing.assert_array_equal(back[k], a[k], err_msg=k)
    return got
