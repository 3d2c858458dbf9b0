"""The port's reference-checkpoint loaders (utils/torch_convert.py), each
checked two ways: the port's module, loaded through its `*_from_torch` /
`load_*_checkpoint`, gives the reference module's forward (or, where the
reference source is not importable, the JAX model's on JAX's converted
tree), and the port's copy of each name and layout mapping gives the flax
tree of the JAX package's utils/torch_convert.py, key for key and array for
array, on the same state dict.

- transformers (HuBERT, wav2vec2, the Whisper encoder and decoder, w2v-BERT):
  seeded modules at the widths of the JAX package's own tests;
- unilm WavLM, ReDimNet and ERes2Net, whose sources live only in the
  reference tree: a `skipif` test against those sources, and an always-run
  one on a seeded state dict under the reference names at a tiny width
  (written out below from the JAX model's variables; JAX's `apply` fails on
  a missing parameter, so the name list must be complete), both WavLM
  pos_conv serialisations, ERes2Net and ERes2NetV2;
- CAM++: `load_campplus_checkpoint` on a `torch.save`d wespeaker-named file,
  with and without `state_dict`, and with a prefix.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_wavlm import REF_DIR  # where the JAX package's parity tests find the reference sources
from torch_zoo_common import init_variables

from speaker_diarization_tpu.utils import torch_convert as JTC
from speaker_diarization_tpu_torch.utils import torch_convert as TC

torch.set_num_threads(1)

def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def same_tree(mine, ref):
    a, b = dict(_flat(mine)), dict(_flat(ref))
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))[:6]
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def close(got, ref, tol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = ref.detach().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


def _sd(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


# ---------------------------------------------------------------------------
# transformers


def _hubert(kind):
    from transformers import HubertConfig, Wav2Vec2Config
    from transformers.models.hubert.modeling_hubert import HubertModel
    from transformers.models.wav2vec2.modeling_wav2vec2 import Wav2Vec2Model

    from speaker_diarization_tpu_torch.models.wavlm import WavLMFlaxConfig, WavLMModel

    kw = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128, conv_dim=[32] * 7,
              do_stable_layer_norm=False, feat_extract_norm="group", hidden_dropout=0.0, attention_dropout=0.0,
              activation_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0, num_conv_pos_embeddings=16,
              num_conv_pos_embedding_groups=4)
    tm = (HubertModel(HubertConfig(**kw)) if kind == "hubert" else Wav2Vec2Model(Wav2Vec2Config(**kw))).eval()
    conv = tuple((32, k, s) for k, s in zip([10, 3, 3, 3, 3, 2, 2], [5, 2, 2, 2, 2, 2, 2]))
    pm = WavLMModel(WavLMFlaxConfig(encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
                                    encoder_attention_heads=4, conv_feature_layers=conv, conv_pos=16,
                                    conv_pos_groups=4, relative_position_embedding=False, gru_rel_pos=False))
    x = (0.1 * np.random.default_rng(0).standard_normal((2, 8000))).astype(np.float32)
    return tm, pm, "hubert", (torch.from_numpy(x),), lambda m, a: m(*a).last_hidden_state, lambda m, a: m(*a)


def _whisper():
    from transformers import WhisperConfig
    from transformers.models.whisper.modeling_whisper import WhisperEncoder as HFEncoder

    from speaker_diarization_tpu_torch.models.whisper_encoder import WhisperEncoder, WhisperEncoderConfig

    tm = HFEncoder(WhisperConfig(num_mel_bins=24, d_model=64, encoder_layers=2, encoder_attention_heads=4,
                                 encoder_ffn_dim=128, max_source_positions=200)).eval()
    pm = WhisperEncoder(WhisperEncoderConfig(n_mels=24, n_ctx=200, d_model=64, n_heads=4, n_layers=2, d_ff=128))
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 400, 24)).astype(np.float32))
    return (tm, pm, "whisper", (mel,), lambda m, a: m(a[0].transpose(1, 2)).last_hidden_state,
            lambda m, a: m(a[0]))


def _whisper_decoder():
    from transformers import WhisperConfig
    from transformers.models.whisper.modeling_whisper import WhisperDecoder as HFDecoder

    from speaker_diarization_tpu_torch.models.whisper_decoder import WhisperDecoder, WhisperDecoderConfig

    tm = HFDecoder(WhisperConfig(vocab_size=64, d_model=32, decoder_layers=2, decoder_attention_heads=2,
                                 decoder_ffn_dim=64, max_target_positions=48, num_mel_bins=24, encoder_layers=1,
                                 encoder_attention_heads=2, encoder_ffn_dim=64, pad_token_id=0, bos_token_id=1,
                                 eos_token_id=2, decoder_start_token_id=1)).eval()
    pm = WhisperDecoder(WhisperDecoderConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                                             max_positions=48), device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 64, (2, 7)))
    enc = torch.from_numpy(rng.standard_normal((2, 11, 32)).astype(np.float32))

    def ref(m, a):
        return m(input_ids=a[0], encoder_hidden_states=a[1]).last_hidden_state @ m.embed_tokens.weight.T

    return tm, pm, "whisper_decoder", (tokens, enc), ref, lambda m, a: m(a[0], a[1])


def _w2vbert():
    from transformers import Wav2Vec2BertConfig
    from transformers.models.wav2vec2_bert.modeling_wav2vec2_bert import Wav2Vec2BertModel

    from speaker_diarization_tpu_torch.models.w2vbert import W2vBertConfig, W2vBertModel

    tm = Wav2Vec2BertModel(Wav2Vec2BertConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
        feature_projection_input_dim=160, position_embeddings_type="relative_key", conv_depthwise_kernel_size=31,
        hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0, conformer_conv_dropout=0.0,
        hidden_act="swish", add_adapter=False)).eval()
    pm = W2vBertModel(W2vBertConfig(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 50, 160)).astype(np.float32))
    return tm, pm, "w2vbert", (x,), lambda m, a: m(*a).last_hidden_state, lambda m, a: m(*a)


TRANSFORMERS = {"hubert": lambda: _hubert("hubert"), "wav2vec2": lambda: _hubert("wav2vec2"), "whisper": _whisper,
                "whisper_decoder": _whisper_decoder, "w2vbert": _w2vbert}


@pytest.mark.parametrize("name", sorted(TRANSFORMERS))
def test_transformers_module_loads_into_the_port(name):
    torch.manual_seed(0)
    tm, pm, conv, args, ref_fwd, port_fwd = TRANSFORMERS[name]()
    sd = _sd(tm)
    pm.load_state_dict(getattr(TC, f"{conv}_from_torch")(sd))
    with torch.no_grad():
        close(port_fwd(pm.eval(), args), ref_fwd(tm, args), tol=2e-4 if name == "whisper_decoder" else 1e-4)
    same_tree(getattr(TC, f"{conv}_torch_to_flax")(sd), getattr(JTC, f"{conv}_torch_to_flax")(sd))
    # a prefix strips its scope and leaves out the names without it
    scoped = {**{f"speech_encoder.{k}": v for k, v in sd.items()}, "other.weight": torch.zeros(3)}
    same_tree(getattr(TC, f"{conv}_torch_to_flax")(scoped, prefix="speech_encoder."),
              getattr(JTC, f"{conv}_torch_to_flax")(sd))


# ---------------------------------------------------------------------------
# reference-named state dicts written out from the JAX variables


def _t(w):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w, np.float32)))


def _conv(sd, name, p):
    w = np.asarray(p["kernel"])
    sd[f"{name}.weight"] = _t(w.transpose(2, 1, 0) if w.ndim == 3 else w.transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _dense(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _norm(sd, name, p, s=None):
    sd[f"{name}.weight"], sd[f"{name}.bias"] = _t(p["scale"]), _t(p["bias"])
    if s is not None:
        sd[f"{name}.running_mean"], sd[f"{name}.running_var"] = _t(s["mean"]), _t(s["var"])
        sd[f"{name}.num_batches_tracked"] = torch.tensor(3)


def wavlm_reference_state_dict(p: dict, layers: int, serialisation: str, seed: int = 0) -> dict:
    """unilm WavLM names (wavlm.py): the feature extractor's 7 convs and
    GroupNorm, post_extract_proj, the weight-normed pos_conv (g over dim 2),
    the layers' projections, gated relative bias and norms."""
    sd = {}
    for i in range(7):
        w = np.asarray(p["feature_extractor"][f"conv_{i}"]["kernel"])
        sd[f"feature_extractor.conv_layers.{i}.0.weight"] = _t(w.transpose(2, 1, 0))
    _norm(sd, "feature_extractor.conv_layers.0.2", p["feature_extractor"]["gn0"])
    _norm(sd, "layer_norm", p["layer_norm"])
    _dense(sd, "post_extract_proj", p["post_extract_proj"])
    w = np.asarray(p["pos_conv"]["kernel"]).transpose(2, 1, 0)  # (out, in/groups, k)
    s = np.random.default_rng(seed).uniform(0.5, 2.0, (1, 1, w.shape[2])).astype(np.float32)
    g, v = np.sqrt((w.astype(np.float64) ** 2).sum(axis=(0, 1), keepdims=True)).astype(np.float32), w * s
    if serialisation == "parametrizations":
        sd["encoder.pos_conv.0.parametrizations.weight.original0"] = _t(g)
        sd["encoder.pos_conv.0.parametrizations.weight.original1"] = _t(v)
    else:
        sd["encoder.pos_conv.0.weight_g"], sd["encoder.pos_conv.0.weight_v"] = _t(g), _t(v)
    sd["encoder.pos_conv.0.bias"] = _t(p["pos_conv"]["bias"])
    _norm(sd, "encoder.layer_norm", p["encoder_layer_norm"])
    sd["encoder.layers.0.self_attn.relative_attention_bias.weight"] = _t(p["relative_attention_bias"])
    for i in range(layers):
        lp, base = p[f"layer_{i}"], f"encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj", "grep_linear"):
            _dense(sd, f"{base}.self_attn.{proj}", lp["self_attn"][proj])
        sd[f"{base}.self_attn.grep_a"] = _t(lp["self_attn"]["grep_a"])
        _norm(sd, f"{base}.self_attn_layer_norm", lp["self_attn_layer_norm"])
        _norm(sd, f"{base}.final_layer_norm", lp["final_layer_norm"])
        _dense(sd, f"{base}.fc1", lp["fc1"])
        _dense(sd, f"{base}.fc2", lp["fc2"])
    sd["mask_emb"] = torch.zeros(w.shape[0])  # a pretraining tensor the loaders leave out
    return sd


@pytest.mark.parametrize("serialisation", ["parametrizations", "weight_g"])
def test_wavlm_reference_names_match_jax(serialisation):
    from speaker_diarization_tpu.models import wavlm as JW
    from speaker_diarization_tpu_torch.models import wavlm as W

    conv = ((32, 10, 5), (32, 3, 2), (32, 3, 2), (32, 3, 2), (32, 3, 2), (32, 2, 2), (32, 2, 2))
    kw = dict(encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_attention_heads=4,
              conv_feature_layers=conv, conv_pos=16, conv_pos_groups=4, num_buckets=32, max_distance=80)
    jm = JW.WavLMModel(cfg=JW.WavLMFlaxConfig(**kw))
    x = (0.1 * np.random.default_rng(1).standard_normal((2, 6000))).astype(np.float32)
    v = init_variables(jm, jnp.asarray(x), seed=2)
    sd = wavlm_reference_state_dict(v["params"], 2, serialisation)
    jtree = JTC.wavlm_torch_to_flax(sd)
    same_tree(TC.wavlm_torch_to_flax(sd), jtree)
    m = W.WavLMModel(W.WavLMFlaxConfig(**kw))
    m.load_state_dict(TC.wavlm_from_torch(sd))
    ref = jax.jit(lambda a: jm.apply({"params": jtree}, a, method=jm.extract_features))(jnp.asarray(x))
    with torch.no_grad():
        close(m.eval().extract_features(torch.from_numpy(x)), ref)


def eres2net_reference_state_dict(p: dict, s: dict) -> dict:
    """3D-Speaker ERes2Net(V2) names: conv1/bn1; layer{k}.{i}.{conv1, bn1,
    convs.j, bns.j, fuse_models.j.local_att.{0,1,3,4}, conv3, bn3,
    shortcut.{0,1}}; layer{1,2,3}_downsample or layer3_ds; fuse_mode12/123/
    1234 or fuse34 `.local_att`; seg_1, its rows in the (part, channel,
    freq) order of the TSTP statistics."""
    sd = {}

    def aff(name, ap, as_):
        for sub, idx in (("conv1", 0), ("bn1", 1), ("conv2", 3), ("bn2", 4)):
            if sub.startswith("conv"):
                _conv(sd, f"{name}.local_att.{idx}", ap[sub])
            else:
                _norm(sd, f"{name}.local_att.{idx}", ap[sub], as_[sub])

    _conv(sd, "conv1", p["conv1"])
    _norm(sd, "bn1", p["bn1"], s["bn1"])
    n_channels = None
    for top in sorted(p):
        m = re.fullmatch(r"layer(\d)_(\d+)", top)
        if m:
            base, bp, bs = f"layer{m[1]}.{m[2]}", p[top], s[top]
            for sub in bp:
                if sub in ("conv1", "conv3"):
                    _conv(sd, f"{base}.{sub}", bp[sub])
                elif sub in ("bn1", "bn3"):
                    _norm(sd, f"{base}.{sub}", bp[sub], bs[sub])
                elif sub.startswith("conv_"):
                    _conv(sd, f"{base}.convs.{sub[5:]}", bp[sub])
                elif sub.startswith("bn_"):
                    _norm(sd, f"{base}.bns.{sub[3:]}", bp[sub], bs[sub])
                elif sub.startswith("aff_"):
                    aff(f"{base}.fuse_models.{sub[4:]}", bp[sub], bs[sub])
                elif sub == "shortcut_conv":
                    _conv(sd, f"{base}.shortcut.0", bp[sub])
                elif sub == "shortcut_bn":
                    _norm(sd, f"{base}.shortcut.1", bp[sub], bs[sub])
            if m[1] == "4":
                n_channels = np.asarray(bp["conv3"]["kernel"]).shape[-1]
        elif re.fullmatch(r"layer[1-3]_downsample|layer3_ds", top):
            _conv(sd, top, p[top])
        elif top.startswith("fuse"):
            aff({"fuse12": "fuse_mode12", "fuse123": "fuse_mode123", "fuse1234": "fuse_mode1234"}.get(top, top),
                p[top], s[top])
    k = np.asarray(p["seg_1"]["kernel"])  # (2·F·C, emb), frames flattened (freq, channel)
    CF = k.shape[0] // 2
    F8 = CF // n_channels
    perm = np.array([part * CF + c * F8 + f for part in range(2) for f in range(F8) for c in range(n_channels)])
    W = np.empty((k.shape[1], 2 * CF), np.float32)
    W[:, perm] = k.T
    sd["seg_1.weight"], sd["seg_1.bias"] = _t(W), _t(p["seg_1"]["bias"])
    return sd


@pytest.mark.parametrize("version", ["ERes2Net", "ERes2NetV2"])
def test_eres2net_reference_names_match_jax(version, tmp_path):
    from speaker_diarization_tpu.models import eres2net as JE
    from speaker_diarization_tpu_torch.models import eres2net as E

    kw = dict(feat_dim=16, embedding_size=8, m_channels=4, num_blocks=(1, 1, 1, 1), base_width=32 if
              version == "ERes2Net" else 26)
    jm = getattr(JE, version)(**kw)
    x = np.random.default_rng(3).standard_normal((2, 40, 16)).astype(np.float32)
    v = init_variables(jm, jnp.asarray(x), False, "embedding", seed=4)
    sd = eres2net_reference_state_dict(v["params"], v["batch_stats"])
    jp, js = JTC.eres2net_torch_to_flax(sd)
    same_tree(TC.eres2net_torch_to_flax(sd)[0], jp)
    same_tree(TC.eres2net_torch_to_flax(sd)[1], js)
    same_tree(jp, jax.device_get(v["params"]))  # the written-out names carry every parameter back
    torch.save({"state_dict": sd}, str(tmp_path / "eres2net.pt"))
    m = getattr(E, version)(**kw).eval()
    m.load_state_dict(TC.load_eres2net_checkpoint(str(tmp_path / "eres2net.pt")))
    for mode in ("embedding", "frames"):
        ref = jax.jit(lambda a: jm.apply({"params": jp, "batch_stats": js}, a, False, mode))(jnp.asarray(x))
        with torch.no_grad():
            close(m(torch.from_numpy(x), mode=mode), ref)


REDIMNET = {
    "conv+att": dict(feat_dim=16, C=8, stages_setup=((1, 1, 2, ((3, 3),), 8), (2, 1, 1, ((3, 3),), 8)),
                     block_1d_type="conv+att", block_2d_type="convnext_like", group_divisor=1, embed_dim=24),
    "att_fwse": dict(feat_dim=16, C=8, stages_setup=((1, 1, 2, ((3, 3),), 8), (2, 1, 1, ((3, 3),), 8)),
                     block_1d_type="att", block_2d_type="basic_resnet_fwse", group_divisor=1, embed_dim=24),
    "fc": dict(feat_dim=16, C=8, stages_setup=((1, 1, 1, ((3, 3),), 8), (2, 1, 1, ((3, 3),), 8)),
               block_1d_type="fc", block_2d_type="basic_resnet", group_divisor=1, embed_dim=24),
}


def redimnet_reference_state_dict(p: dict, s: dict, stages_setup, block_1d_type: str) -> dict:
    """The reference ReDimNet names (redimnet.py): backbone.stem.{0,1},
    backbone.inputs_weights.i (1, i+1, C·F, 1), backbone.stage{si}.{index}
    (0 the pool conv, 1..n the blocks' conv_block, then with conv_exp > 1
    the squeeze (0 conv, 1 bn, 2 pointwise), then the time-context block:
    red_dim_conv.{0,1}, tcm.*, exp_dim_conv), backbone.mfa.{0,1},
    pool.linear{1,2} (Conv1d, kernel 1) and seg_1."""
    sd = {}
    bp, bs = p["backbone"], s.get("backbone", {})

    def transformer(base, tp):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(sd, f"{base}.attention.{proj}", tp["attention"][proj])
        _norm(sd, f"{base}.layer_norm", tp["layer_norm"])
        _norm(sd, f"{base}.final_layer_norm", tp["final_layer_norm"])
        _dense(sd, f"{base}.feed_forward.intermediate_dense", tp["ff_intermediate"])
        _dense(sd, f"{base}.feed_forward.output_dense", tp["ff_output"])

    def convnext(base, cp, cs):
        for sub in cp:
            if sub.startswith("dwconv_"):
                _conv(sd, f"{base}.dwconvs.{sub[7:]}", cp[sub])
            elif sub == "norm":
                _norm(sd, f"{base}.norm", cp[sub], cs[sub])
            else:
                _conv(sd, f"{base}.{sub}", cp[sub])

    def block2d(base, cp, cs):
        for sub in cp:
            if sub in ("conv1", "conv1pw", "conv2", "conv2pw", "pwconv1"):
                _conv(sd, f"{base}.{sub}", cp[sub])
            elif sub in ("bn1", "bn2", "norm"):
                _norm(sd, f"{base}.{sub}", cp[sub], cs[sub])
            elif sub.startswith("dwconv_"):
                _conv(sd, f"{base}.dwconvs.{sub[7:]}", cp[sub])
            elif sub == "se":
                for lin in cp["se"]:
                    _dense(sd, f"{base}.se.{lin}", cp["se"][lin])
            elif sub == "downsample_conv":
                _conv(sd, f"{base}.downsample.0", cp[sub])
            elif sub == "downsample_bn":
                _norm(sd, f"{base}.downsample.1", cp[sub], cs[sub])

    _conv(sd, "backbone.stem.0", bp["stem_conv"])
    _norm(sd, "backbone.stem.1", bp["stem_norm"])
    CF = np.asarray(bp["inputs_weights_1"]).shape[1]
    sd["backbone.inputs_weights.0"] = torch.ones(1, 1, CF, 1)
    for si, (stride, nb, conv_exp, _ks, _att) in enumerate(stages_setup):
        w = np.asarray(bp[f"inputs_weights_{si + 1}"])
        sd[f"backbone.inputs_weights.{si + 1}"] = _t(w[None, :, :, None])
        sp, ss, base = bp[f"stage{si}"], bs.get(f"stage{si}", {}), f"backbone.stage{si}"
        _conv(sd, f"{base}.0", sp["pool_conv"])
        for b in range(nb):
            block2d(f"{base}.{b + 1}.conv_block", sp[f"block_{b}"]["conv_block"],
                    ss.get(f"block_{b}", {}).get("conv_block", {}))
        if conv_exp != 1:
            _conv(sd, f"{base}.{nb + 1}.0", sp["squeeze_conv"])
            _norm(sd, f"{base}.{nb + 1}.1", sp["squeeze_bn"], ss["squeeze_bn"])
            _conv(sd, f"{base}.{nb + 1}.2", sp["squeeze_pw"])
        t, tp, ts = f"{base}.{nb + (2 if conv_exp != 1 else 1) + 1}", sp["tcb"], ss.get("tcb", {})
        _conv(sd, f"{t}.red_dim_conv.0", tp["red_dim_conv"])
        _norm(sd, f"{t}.red_dim_conv.1", tp["red_dim_norm"])
        _conv(sd, f"{t}.exp_dim_conv", tp["exp_dim_conv"])
        if block_1d_type == "conv+att":
            for i in range(4):
                convnext(f"{t}.tcm.{i}", tp[f"tcm_conv_{i}"], ts.get(f"tcm_conv_{i}", {}))
            transformer(f"{t}.tcm.4", tp["tcm_att"])
        elif block_1d_type == "att":
            _conv(sd, f"{t}.tcm.0.conv", tp["tcm_pos"]["conv"])
            _norm(sd, f"{t}.tcm.0.norm", tp["tcm_pos"]["norm"])
            transformer(f"{t}.tcm.1", tp["tcm_att"])
        else:  # fc
            _conv(sd, f"{t}.tcm.0", tp["tcm_fc1"])
            _norm(sd, f"{t}.tcm.1", tp["tcm_norm"])
            _conv(sd, f"{t}.tcm.2", tp["tcm_fc2"])
    if "mfa_conv" in bp:
        _conv(sd, "backbone.mfa.0", bp["mfa_conv"])
        _norm(sd, "backbone.mfa.1", bp["mfa_bn"], bs["mfa_bn"])
    for lin in ("linear1", "linear2"):
        sd[f"pool.{lin}.weight"] = _t(np.asarray(p[f"pool_{lin}"]["kernel"]).T[:, :, None])
        sd[f"pool.{lin}.bias"] = _t(p[f"pool_{lin}"]["bias"])
    _dense(sd, "seg_1", p["seg_1"])
    return sd


@pytest.mark.parametrize("variant", sorted(REDIMNET))
def test_redimnet_reference_names_match_jax(variant):
    from speaker_diarization_tpu.models.redimnet import ReDimNet as JReDimNet
    from speaker_diarization_tpu_torch.models.redimnet import ReDimNet

    kw = REDIMNET[variant]
    jm = JReDimNet(size=None, **kw)
    x = np.random.default_rng(5).standard_normal((2, 60, 16)).astype(np.float32)
    v = init_variables(jm, jnp.asarray(x), False, "embedding", seed=6)
    sd = redimnet_reference_state_dict(v["params"], v["batch_stats"], kw["stages_setup"], kw["block_1d_type"])
    jp, js = JTC.redimnet_torch_to_flax(sd, kw["stages_setup"])
    mp, ms = TC.redimnet_torch_to_flax(sd, kw["stages_setup"])
    same_tree(mp, jp)
    same_tree(ms, js)
    same_tree(jp, jax.device_get(v["params"]))
    m = ReDimNet(size=None, **kw).eval()
    m.load_state_dict(TC.redimnet_from_torch(sd, kw["stages_setup"]))
    for mode in ("frames", "embedding"):
        ref = jax.jit(lambda a: jm.apply({"params": jp, "batch_stats": js}, a, False, mode))(jnp.asarray(x))
        with torch.no_grad():
            close(m(torch.from_numpy(x), mode=mode), ref, tol=2e-4)


# ---------------------------------------------------------------------------
# the reference sources, where they are mounted


@pytest.mark.skipif(not os.path.exists(os.path.join(REF_DIR, "wavlm.py")), reason="reference not mounted")
def test_wavlm_against_the_reference_source():
    import importlib.util

    from speaker_diarization_tpu_torch.models import wavlm as W

    if REF_DIR not in sys.path:
        sys.path.insert(0, REF_DIR)
    spec = importlib.util.spec_from_file_location("ref_wavlm", os.path.join(REF_DIR, "wavlm.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    torch.manual_seed(0)
    tm = ref.WavLM(ref.WavLMConfig(dict(
        encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128, encoder_attention_heads=4,
        relative_position_embedding=True, num_buckets=32, max_distance=80, gru_rel_pos=True, dropout=0.0,
        attention_dropout=0.0, activation_dropout=0.0, encoder_layerdrop=0.0, dropout_input=0.0,
        dropout_features=0.0, conv_pos=16, conv_pos_groups=4))).eval()
    m = W.WavLMModel(W.WavLMFlaxConfig(encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
                                       encoder_attention_heads=4, num_buckets=32, max_distance=80, conv_pos=16,
                                       conv_pos_groups=4))
    sd = _sd(tm)
    m.load_state_dict(TC.wavlm_from_torch(sd))
    same_tree(TC.wavlm_torch_to_flax(sd), JTC.wavlm_torch_to_flax(sd))
    x = torch.from_numpy((0.1 * np.random.default_rng(0).standard_normal((2, 8000))).astype(np.float32))
    with torch.no_grad():
        (want, _), _ = tm.extract_features(x, output_layer=2, ret_layer_results=True)
        close(m.eval().extract_features(x), want)


@pytest.mark.skipif(not os.path.exists(os.path.join(REF_DIR, "redimnet.py")), reason="reference not mounted")
def test_redimnet_against_the_reference_source():
    from test_redimnet import _load_ref_redimnet

    from speaker_diarization_tpu_torch.models.redimnet import ReDimNet

    ref = _load_ref_redimnet()
    torch.manual_seed(1)
    stages = [(1, 1, 2, [(3, 3)], 8), (2, 1, 1, [(3, 3)], 8)]
    tm = ref.ReDimNet(feat_dim=16, C=8, block_1d_type="att", block_2d_type="basic_resnet_fwse", stages_setup=stages,
                      group_divisor=1, out_channels=None, embed_dim=24, pooling_func="ASTP",
                      global_context_att=True).eval()
    m = ReDimNet(size=None, feat_dim=16, C=8, stages_setup=tuple((a, b, c, tuple(map(tuple, d)), e)
                                                                  for a, b, c, d, e in stages),
                 block_1d_type="att", block_2d_type="basic_resnet_fwse", group_divisor=1, embed_dim=24).eval()
    sd = _sd(tm)
    m.load_state_dict(TC.redimnet_from_torch(sd, stages))
    same_tree(TC.redimnet_torch_to_flax(sd, stages)[0], JTC.redimnet_torch_to_flax(sd, stages)[0])
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 60, 16)).astype(np.float32))
    with torch.no_grad():
        close(m(x, mode="frames"), tm.get_frame_level_feat(x), tol=2e-4)
        close(m(x), tm(x)[1], tol=5e-4)


@pytest.mark.skipif(not os.path.isdir(REF_DIR), reason="reference not mounted")
def test_eres2netv2_against_the_reference_source():
    from test_eres2net_parity import _load_ref

    from speaker_diarization_tpu_torch.models.eres2net import ERes2NetV2

    ref = _load_ref("ERes2NetV2.py", "ref_eres2netv2")
    tm = ref.ERes2NetV2(feat_dim=32, embedding_size=48, m_channels=16, num_blocks=[1, 1, 1, 1], baseWidth=26,
                        scale=2, expansion=2).eval()
    m = ERes2NetV2(feat_dim=32, embedding_size=48, m_channels=16, num_blocks=(1, 1, 1, 1), base_width=26).eval()
    sd = _sd(tm)
    m.load_state_dict(TC.eres2net_from_torch(sd))
    same_tree(TC.eres2net_torch_to_flax(sd)[0], JTC.eres2net_torch_to_flax(sd)[0])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 64, 32)).astype(np.float32))
    with torch.no_grad():
        close(m(x), tm(x), tol=2e-4)


# ---------------------------------------------------------------------------
# CAM++


@pytest.mark.parametrize("layout", ["plain", "state_dict", "prefixed"])
def test_load_campplus_checkpoint(layout, tmp_path):
    """The port's CAM++ carries the wespeaker names, so a seeded port module's
    state dict is a wespeaker-named file: `load_campplus_checkpoint` gives it
    back, and its forward equals the JAX CAMPPlus on JAX's conversion."""
    from speaker_diarization_tpu.models.campplus import CAMPPlus as JCAMPPlus
    from speaker_diarization_tpu_torch.models.campplus import CAMPPlus
    from speaker_diarization_tpu_torch.models.layers import init_weights_

    src = CAMPPlus(block_layers=(1, 1, 1)).eval()
    init_weights_(src, torch.Generator().manual_seed(7))
    with torch.no_grad():
        for name, buf in src.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.8, 1.2)
            elif name.endswith("running_mean"):
                buf.normal_(0.0, 0.1)
    sd = _sd(src)
    obj = {"plain": sd, "state_dict": {"state_dict": sd, "epoch": 3},
           "prefixed": {"state_dict": {**{f"speech_encoder.{k}": v for k, v in sd.items()},
                                       "projection.weight": torch.zeros(2, 2)}}}[layout]
    path = str(tmp_path / "campplus.pt")
    torch.save(obj, path)
    got = TC.load_campplus_checkpoint(path, prefix="speech_encoder." if layout == "prefixed" else "")
    m = CAMPPlus(block_layers=(1, 1, 1)).eval()
    m.load_state_dict(got)
    for k, t in sd.items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(got[k], t, rtol=0, atol=0, msg=k)
    jp, js = JTC.campplus_torch_to_flax({k: v.numpy() for k, v in sd.items()})
    mp, ms = TC.campplus_torch_to_flax(sd)
    same_tree(mp, jp)
    same_tree(ms, js)
    x = np.random.default_rng(8).standard_normal((2, 60, 80)).astype(np.float32)
    jm = JCAMPPlus(block_layers=(1, 1, 1))
    ref = jax.jit(lambda a: jm.apply({"params": jp, "batch_stats": js}, a, False, "embedding"))(jnp.asarray(x))
    with torch.no_grad():
        close(m(torch.from_numpy(x), mode="embedding"), ref)
