"""Port parity: transformer layer and TS-VAD logits against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.models.transformer import TransformerEncoderLayer as JLayer
from speaker_diarization_tpu.models.tsvad import TSVADConfig as JConfig
from speaker_diarization_tpu.models.tsvad import TSVADModel as JModel
from speaker_diarization_tpu_torch.models.transformer import TransformerEncoderLayer
from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

SMALL = dict(
    encoder_block_layers=(1, 1, 1), transformer_embed_dim=64, transformer_ffn_embed_dim=128,
    num_attention_head=4, speaker_embed_dim=32, num_transformer_layer=2,
)


def _perturb(variables, seed=0):
    rng = np.random.default_rng(seed)
    to_np = lambda v: np.asarray(v, np.float32)  # noqa: E731
    stats = jax.tree_util.tree_map(
        lambda v: to_np(v) + 0.1 * np.abs(rng.standard_normal(v.shape)).astype(np.float32), variables["batch_stats"]
    )
    return {"params": jax.tree_util.tree_map(to_np, variables["params"]), "batch_stats": stats}


def test_post_norm_layer_matches_flax():
    D, H, Dff = 64, 4, 128
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 17, D)).astype(np.float32)
    jl = JLayer(n_heads=H, d_ff=Dff, dropout=0.0)
    params = jax.tree_util.tree_map(np.asarray, jl.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    # non-trivial LayerNorm parameters
    for ln in ("LayerNorm_0", "LayerNorm_1"):
        params[ln]["scale"] = params[ln]["scale"] + 0.1 * rng.standard_normal(D).astype(np.float32)
        params[ln]["bias"] = 0.1 * rng.standard_normal(D).astype(np.float32)
    ref = np.asarray(jl.apply({"params": params}, jnp.asarray(x)))
    layer = TransformerEncoderLayer(D, H, Dff).eval()
    sd = convert._backend_from_flax({"layer_0": params}, "b")
    layer.load_state_dict({k[len("b.layer_0."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-4)


@pytest.fixture(scope="module")
def tsvad_pair():
    jcfg = JConfig(**SMALL)
    jmodel = JModel(cfg=jcfg)
    audio0 = jnp.zeros((1, 16000), jnp.float32)
    v = _perturb(jax.jit(jmodel.init, static_argnums=3)(jax.random.PRNGKey(0), audio0, jnp.zeros((1, 4, 32)), 25), 1)
    model = TSVADModel(TSVADConfig(**SMALL), device="cpu")
    model.load_state_dict(convert.tsvad_from_flax(v))
    return jmodel, v, model


def _jax_logits(jmodel, v, audio, embs, n_label=None):
    fn = jax.jit(lambda v, a, e: jmodel.apply(v, a, e, n_label, train=False))
    return np.asarray(fn(v, jnp.asarray(audio), jnp.asarray(embs)))


@pytest.mark.parametrize("n_samples,n_label", [(32000, None), (24000, 20), (24000, 45)])
def test_tsvad_logits_match_jax(tsvad_pair, n_samples, n_label):
    """fp32 logits, including n_label_frames shorter and longer than the encoder output."""
    jmodel, v, model = tsvad_pair
    rng = np.random.default_rng(n_samples + (n_label or 0))
    audio = (0.1 * rng.standard_normal((2, n_samples))).astype(np.float32)
    embs = rng.standard_normal((2, 4, 32)).astype(np.float32)
    embs[1, 3] = 0.0  # an absent speaker slot
    ref = _jax_logits(jmodel, v, audio, embs, n_label)
    with torch.no_grad():
        got = model(torch.from_numpy(audio), torch.from_numpy(embs), n_label).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)


def test_tsvad_bf16_close(tsvad_pair):
    jmodel, v, _ = tsvad_pair
    model = TSVADModel(TSVADConfig(**SMALL), dtype="bf16", device="cpu")
    model.load_state_dict(convert.tsvad_from_flax(v))
    rng = np.random.default_rng(5)
    audio = (0.1 * rng.standard_normal((2, 16000))).astype(np.float32)
    embs = rng.standard_normal((2, 4, 32)).astype(np.float32)
    ref = _jax_logits(jmodel, v, audio, embs)
    with torch.no_grad():
        got = model(torch.from_numpy(audio), torch.from_numpy(embs)).numpy()
    assert np.mean(np.abs(got - ref)) < 5e-2 * max(1.0, np.mean(np.abs(ref)))


def test_weight_conversion_round_trips(tsvad_pair, tmp_path):
    _, v, model = tsvad_pair
    path = str(tmp_path / "params.npz")
    convert.save_flax_npz(path, v)
    back = convert.load_flax_npz(path)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(t)[0]}  # noqa: E731
    a, b = flat(v), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    # port state dict -> flax layout -> port state dict is exact
    sd = model.state_dict()
    again = convert.tsvad_from_flax(convert.tsvad_to_flax(sd, num_heads=4))
    assert set(again) == set(sd)
    for k in sd:
        torch.testing.assert_close(again[k], sd[k].cpu(), rtol=0, atol=0)
    c = flat(convert.tsvad_to_flax(sd, num_heads=4))
    for k in a:
        np.testing.assert_allclose(c[k], a[k], rtol=0, atol=0, err_msg=k)


def test_unported_encoders_and_backends_raise():
    for kw in (dict(speech_encoder_type="wavlm"), dict(single_backend_type="mamba2"), dict(multi_backend_type="lstm")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TSVADModel(TSVADConfig(**SMALL, **kw), device="cpu")
