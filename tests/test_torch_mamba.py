"""Port parity: the selective-scan twins (K3a/K3b/K3c), SelectiveScanFn, the
Mamba and Mamba-2 layers and TS-VAD with BiMamba and BiMamba-2 backends,
against the JAX package."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.models.mamba import BiMamba2Block as JBiMamba2
from speaker_diarization_tpu.models.mamba import BiMambaBlock as JBiMamba
from speaker_diarization_tpu.models.mamba import Mamba2Layer as JMamba2Layer
from speaker_diarization_tpu.models.mamba import MambaLayer as JMambaLayer
from speaker_diarization_tpu.models.tsvad import TSVADConfig as JConfig
from speaker_diarization_tpu.models.tsvad import TSVADModel as JModel
from speaker_diarization_tpu.ops.mamba_scan import selective_scan as j_assoc
from speaker_diarization_tpu.ops.mamba_scan import selective_scan_sequential as j_seq
from speaker_diarization_tpu_torch.kernels import selective_scan as K3
from speaker_diarization_tpu_torch.models.layers import init_weights_
from speaker_diarization_tpu_torch.models.mamba import BiMamba2Block, BiMambaBlock, Mamba2Layer, MambaLayer
from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
from speaker_diarization_tpu_torch.ops.mamba_scan import selective_scan_auto, selective_scan_sequential
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

# the package re-exports a function of the same name, so import the module by path
jssp = importlib.import_module("speaker_diarization_tpu.kernels.selective_scan_pallas")
NAMES = ("x", "delta", "A", "B", "C", "D")


def _rand(B=2, T=37, D=128, N=8, seed=0):
    """The inputs of tests/test_mamba.py's scan tests."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    delta = np.abs(rng.standard_normal((B, T, D))).astype(np.float32) * 0.1
    A = -np.abs(rng.standard_normal((D, N))).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    C = rng.standard_normal((B, T, N)).astype(np.float32)
    Dp = rng.standard_normal(D).astype(np.float32)
    return x, delta, A, Bm, C, Dp


def _t(args, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in args]


@pytest.mark.parametrize("T,chunk,seed", [(37, 16, 0), (16, 64, 1)])
def test_fwd_twin_matches_pallas_and_sequential(T, chunk, seed):
    """K3a's twin: multi-chunk (37 = 3 chunks of 16 with a padded tail) and single chunk."""
    args = _rand(T=T, seed=seed)
    want_seq = np.asarray(j_seq(*map(jnp.asarray, args)))
    want_pallas = np.asarray(jssp.selective_scan_pallas(*map(jnp.asarray, args), chunk=chunk, interpret=True))
    got = K3.selective_scan_fwd(*_t(args)).numpy()  # a CPU tensor: the twin
    np.testing.assert_allclose(got, want_pallas, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, want_seq, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("chunk", [8, 16, 128])
def test_states_twin_matches_pallas_fwd_with_states(chunk):
    """K3b's twin: y and every chunk's initial state at the JAX kernel's L
    (chunk 8 → L = 8, 5 chunks; chunk 16, the CUDA kernel's CHUNK → L = 16,
    3 chunks, the last ragged; chunk 128 → L = 40, one chunk)."""
    args = _rand(T=37, seed=3)
    x, delta, A, Bm, C, Dp = map(jnp.asarray, args)
    xp, dp, bp, cp, L, n_chunks, T = jssp._pad_args(x, delta, Bm, C, chunk)
    y, h0 = jssp._pallas_fwd_with_states(xp, dp, bp, cp, A.T, Dp.reshape(1, -1), L, n_chunks, interpret=True)
    got_y, got_h0 = K3.selective_scan_states_ref(*_t(args), chunk=L)
    assert got_h0.shape == h0.shape
    np.testing.assert_allclose(got_y.numpy(), np.asarray(y)[:, :T], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got_h0.numpy(), np.asarray(h0), atol=2e-5, rtol=2e-5)


def _port_grads(args, chunk):
    t = _t(args)
    y, h0 = K3.selective_scan_states_ref(*t, chunk=chunk)
    return [g.numpy() for g in K3.selective_scan_bwd_ref(*t, h0, 2.0 * y, chunk=chunk)]  # d sum(y²)


def _jax_grads(fn, args):
    return jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=tuple(range(6)))(*map(jnp.asarray, args))


def test_bwd_twin_matches_jax_grads():
    """K3c's twin: all six gradients against jax.grad of the fused Pallas
    scan (its default chunk) and of the associative scan."""
    args = _rand(T=20, D=64, seed=2)
    got = _port_grads(args, K3.CHUNK)
    for ref_fn in (jssp.selective_scan_fused, j_assoc):
        for name, g, r in zip(NAMES, got, _jax_grads(ref_fn, args)):
            np.testing.assert_allclose(g, np.asarray(r), atol=3e-4, rtol=3e-4, err_msg=name)


def test_bwd_twin_multichunk_carry():
    """The dh carry across chunk boundaries: T = 37 over 5 chunks of 8 with a
    padded tail, against the Pallas backward forced to the same chunks and
    against the associative scan."""
    args = _rand(T=37, D=128, N=8, seed=4)
    got = _port_grads(args, 8)
    orig = jssp._pad_args
    jssp._pad_args = lambda x, d, b, c, chunk: orig(x, d, b, c, chunk=8)
    try:
        fused = _jax_grads(jssp.selective_scan_fused, args)
    finally:
        jssp._pad_args = orig
    for refs in (fused, _jax_grads(j_assoc, args)):
        for name, g, r in zip(NAMES, got, refs):
            np.testing.assert_allclose(g, np.asarray(r), atol=3e-4, rtol=3e-4, err_msg=name)


@pytest.mark.parametrize("ref", ["fused", "assoc"])
def test_bwd_twin_at_the_kernel_shape_family(ref):
    """K3c's twin at the main path's state size and length, which the card
    holds K3c to: N = 64, T = 100 (6 chunks of 16 and a 4-step tail), A =
    -(1..N) and Δ = softplus(randn - 2) as chip_smoke.py draws them; every
    gradient within the smoke's bar, 1e-3 · max|JAX gradient|, of jax.grad
    of the fused Pallas scan (interpret) or of the associative scan."""
    rng = np.random.default_rng(11)
    B, T, D, N = 2, 100, 32, 64
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    delta = np.log1p(np.exp(rng.standard_normal((B, T, D)) - 2.0)).astype(np.float32)
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (D, 1))
    Bm, C = (rng.standard_normal((B, T, N)).astype(np.float32) for _ in range(2))
    Dp = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    args = (x, delta, A, Bm, C, Dp)
    got = _port_grads(args, K3.CHUNK)
    want = _jax_grads(jssp.selective_scan_fused if ref == "fused" else j_assoc, args)
    for name, g, r in zip(NAMES, got, want):
        r = np.asarray(r)
        assert g.shape == r.shape, name
        err, bar = np.abs(g - r).max(), 1e-3 * np.abs(r).max()
        assert err <= bar, f"{name}: max-abs {err:.3e} > {bar:.3e}"


def test_selective_scan_fn_grads_match_autograd_of_sequential():
    """SelectiveScanFn (K3b twin forward, K3c twin backward) against
    torch.autograd through the sequential twin, in float64."""
    args = _rand(B=2, T=37, D=24, N=8, seed=5)
    a = [t.requires_grad_() for t in _t(args, torch.float64)]
    b = [t.detach().clone().requires_grad_() for t in a]
    gy = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 37, 24)))
    y_fn = K3.SelectiveScanFn.apply(*a)
    y_ref = selective_scan_sequential(*b)
    torch.testing.assert_close(y_fn, y_ref, rtol=1e-12, atol=1e-12)
    ga = torch.autograd.grad(y_fn, a, gy)
    gb = torch.autograd.grad(y_ref, b, gy)
    for name, p, q in zip(NAMES, ga, gb):
        torch.testing.assert_close(p, q, rtol=1e-10, atol=1e-10, msg=name)


def test_auto_dispatch_and_cpu_wrappers_count_no_launch():
    """selective_scan_auto takes the forward kernel without gradients and
    SelectiveScanFn with them; on CPU tensors the wrappers run their twins
    and count no launch."""
    t = _t(_rand(B=1, T=9, D=16, N=8, seed=7))
    before = (K3.selective_scan_fwd.launches, K3.selective_scan_fwd_states.launches, K3.selective_scan_bwd.launches)
    with torch.no_grad():
        y0 = selective_scan_auto(*t)
    t[0].requires_grad_()
    y1 = selective_scan_auto(*t)
    assert y0.grad_fn is None and type(y1.grad_fn).__name__ == "SelectiveScanFnBackward"
    y1.sum().backward()
    torch.testing.assert_close(y0, y1.detach())
    after = (K3.selective_scan_fwd.launches, K3.selective_scan_fwd_states.launches, K3.selective_scan_bwd.launches)
    assert after == before


def _perturb(params, seed):
    """Non-trivial values for the leaves flax initialises to constants."""
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), params)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("A_log", "D", "conv_bias", "bias", "scale"):
                node[k] = v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)

    walk(p)
    return p


def test_mamba_layer_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 19, 32)).astype(np.float32)
    jl = JMambaLayer(d_model=32, d_state=8)
    p = _perturb(jl.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    ref = np.asarray(jl.apply({"params": p}, jnp.asarray(x)))
    layer = MambaLayer(32, d_state=8)
    sd = convert._mamba_backend_from_flax({"fwd_0": p}, "b")
    layer.load_state_dict({k[len("b.fwd_0."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("merge", ["concat", "add"])
def test_bimamba_block_matches_flax(merge):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 17, 32)).astype(np.float32)
    jb = JBiMamba(d_model=32, n_layer=2, d_state=8, merge=merge)
    p = _perturb(jb.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"], 3)
    ref = np.asarray(jb.apply({"params": p}, jnp.asarray(x)))
    block = BiMambaBlock(32, n_layer=2, d_state=8, merge=merge)
    block.load_state_dict({k[2:]: v for k, v in convert._mamba_backend_from_flax(p, "b").items()})
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    assert ("merge_0.weight" in block.state_dict()) == (merge == "concat")


SMALL = dict(
    encoder_block_layers=(1, 1, 1), transformer_embed_dim=64, transformer_ffn_embed_dim=128,
    num_attention_head=4, speaker_embed_dim=32, num_transformer_layer=2, d_state=8,
)


def test_tsvad_mamba_logits_match_jax():
    """fp32 TS-VAD-Mamba logits (concat merge in the single backend, add in
    the multi backend) at the tolerance of test_torch_tsvad.py, and the
    weights' round trip through the flax layout."""
    kw = dict(SMALL, single_backend_type="mamba", multi_backend_type="mamba_add")
    jmodel = JModel(cfg=JConfig(**kw))
    v = jax.jit(jmodel.init, static_argnums=3)(jax.random.PRNGKey(0), jnp.zeros((1, 16000)), jnp.zeros((1, 4, 32)), 25)
    v = {"params": _perturb(v["params"], 4), "batch_stats": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05, v["batch_stats"])}
    model = TSVADModel(TSVADConfig(**kw), device="cpu")
    model.load_state_dict(convert.tsvad_from_flax(v))
    rng = np.random.default_rng(8)
    audio = (0.1 * rng.standard_normal((2, 24000))).astype(np.float32)
    embs = rng.standard_normal((2, 4, 32)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, a, e: jmodel.apply(v, a, e, None, train=False))(v, audio, embs))
    with torch.no_grad():
        got = model(torch.from_numpy(audio), torch.from_numpy(embs)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)
    back = convert.tsvad_to_flax(model.state_dict(), num_heads=4)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(t)[0]}  # noqa: E731
    a, b = flat(v), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mamba2_layer_matches_flax():
    """One Mamba-2 mixer (four heads of 16 over d_inner 64, T = 77 over two
    SSD chunks of 64 with a padded tail) and its flax weights."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 77, 32)).astype(np.float32)
    jl = JMamba2Layer(d_model=32, d_state=8, headdim=16)
    p = _perturb(jl.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"], 5)
    ref = np.asarray(jl.apply({"params": p}, jnp.asarray(x)))
    layer = Mamba2Layer(32, d_state=8, headdim=16)
    sd = convert._mamba2_backend_from_flax({"fwd_0": p}, "b")
    layer.load_state_dict({k[len("b.fwd_0."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("merge", ["concat", "add"])
def test_bimamba2_block_matches_flax(merge):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 70, 32)).astype(np.float32)  # 70 frames: two chunks of 64
    jb = JBiMamba2(d_model=32, n_layer=2, d_state=8, headdim=16, merge=merge)
    p = _perturb(jb.init(jax.random.PRNGKey(7), jnp.asarray(x))["params"], 8)
    ref = np.asarray(jb.apply({"params": p}, jnp.asarray(x)))
    block = BiMamba2Block(32, n_layer=2, d_state=8, headdim=16, merge=merge)
    block.load_state_dict({k[2:]: v for k, v in convert._mamba2_backend_from_flax(p, "b").items()})
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    assert ("merge_0.weight" in block.state_dict()) == (merge == "concat")


def test_mamba2_seeded_init_follows_jax_ranges():
    """`init_weights_` draws A from U[1, 16] and softplus(dt_bias) from a
    log-uniform [1e-3, 1e-1], as the JAX Mamba2Layer's initialisers; D is 1."""
    layer = Mamba2Layer(128, d_state=8, headdim=1)  # 256 heads of one channel
    init_weights_(layer, torch.Generator().manual_seed(0))
    A = torch.exp(layer.A_log.detach())
    dt = torch.nn.functional.softplus(layer.dt_bias.detach())
    assert 1.0 <= A.min() and A.max() <= 16.0 and A.std() > 3.0
    assert 1e-3 * (1 - 1e-5) <= dt.min() and dt.max() <= 1e-1 * (1 + 1e-5)
    assert torch.log10(dt).std() > 0.4  # spread over both decades
    torch.testing.assert_close(layer.D.detach(), torch.ones(256))


@pytest.mark.parametrize("single,multi", [("mamba2", "mamba2_add"), ("mamba2_add", "mamba2")])
def test_tsvad_mamba2_logits_match_jax(single, multi):
    """fp32 TS-VAD logits with BiMamba-2 backends (both merges, each in both
    positions) at the tolerance of test_torch_tsvad.py, and the weights'
    round trip through the flax layout."""
    kw = dict(SMALL, single_backend_type=single, multi_backend_type=multi, d_state=16)
    jmodel = JModel(cfg=JConfig(**kw))  # d_inner 128: two heads of 64
    v = jax.jit(jmodel.init, static_argnums=3)(jax.random.PRNGKey(0), jnp.zeros((1, 16000)), jnp.zeros((1, 4, 32)), 25)
    v = {"params": _perturb(v["params"], 9), "batch_stats": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05, v["batch_stats"])}
    model = TSVADModel(TSVADConfig(**kw), device="cpu")
    model.load_state_dict(convert.tsvad_from_flax(v))
    rng = np.random.default_rng(10)
    audio = (0.1 * rng.standard_normal((2, 24000))).astype(np.float32)
    embs = rng.standard_normal((2, 4, 32)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, a, e: jmodel.apply(v, a, e, None, train=False))(v, audio, embs))
    with torch.no_grad():
        got = model(torch.from_numpy(audio), torch.from_numpy(embs)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)
    back = convert.tsvad_to_flax(model.state_dict(), num_heads=4)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(t)[0]}  # noqa: E731
    a, b = flat(v), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
