"""Reference PyTorch checkpoints → this package's modules.

The port's counterpart of the JAX package's utils/torch_convert.py: its own
copy of each reference name and layout mapping (a reference state dict →
the flax variables of the JAX module, `*_torch_to_flax`), composed with the
flax → state-dict converters of utils/convert.py, so each `*_from_torch`
and `load_*_checkpoint` returns the state dict of this package's module:

  campplus   wespeaker CAM++ `head.*`, `xvector.*`     models/campplus.CAMPPlus
  wavlm      unilm WavLM (pos_conv's weight norm folded, either
             serialisation: parametrizations…original0/1 or weight_g/_v)
                                                      models/wavlm.WavLMModel
  hubert     transformers HubertModel / Wav2Vec2Model (also MMS)
                                                      models/wavlm.WavLMModel
  whisper    transformers WhisperEncoder              models/whisper_encoder.WhisperEncoder
  w2vbert    transformers Wav2Vec2BertModel           models/w2vbert.W2vBertModel
  redimnet   the reference ReDimNet (needs its `stages_setup`)
                                                      models/redimnet.ReDimNet
  eres2net   ERes2Net, ERes2Net_huge, ERes2NetV2 (the TSTP `seg_1` rows
             permuted to this package's frame order)  models/eres2net.ERes2Net(V2)
  whisper_decoder
             transformers WhisperDecoder (the head tied to embed_tokens)
                                                      models/whisper_decoder.WhisperDecoder

Layout rules (reference → flax; utils/convert.py takes flax → state dict):

  Conv1d (out, in, k)      → flax Conv kernel (k, in, out)
  Conv2d (out, in, kh, kw) → flax Conv kernel (kh, kw, in, out)
  Linear (out, in)         → flax Dense kernel (in, out)
  BatchNorm weight/bias/running_mean/running_var
                           → params …/bn{scale,bias} + batch_stats …/bn{mean,var}

The file loaders read `.pt`/`.bin` files with `torch.load(...,
weights_only=True)`, with or without a `state_dict` key; `prefix` strips a
leading scope (e.g. 'speech_encoder.') and leaves out the names without it.

    from speaker_diarization_tpu_torch.utils.torch_convert import load_campplus_checkpoint
    camp.load_state_dict(load_campplus_checkpoint("cam++.pt"))
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from . import convert


def _np(t):
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().float().numpy() if t.is_floating_point() else t.detach().cpu().numpy()


def _set(tree: dict, path: Tuple[str, ...], value: np.ndarray):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def campplus_torch_to_flax(state_dict: Dict[str, "np.ndarray"], prefix: str = "") -> Tuple[dict, dict]:
    """Convert a reference CAMPPlus state_dict to (params, batch_stats).

    `prefix` strips a leading scope (e.g. 'speech_encoder.'). Tensor names
    follow cam_pplus_wespeaker.py; our module names mirror them
    (models/campplus.py).
    """
    params: dict = {}
    stats: dict = {}

    def conv_k(w):
        w = _np(w)
        if w.ndim == 3:
            return w.transpose(2, 1, 0)
        if w.ndim == 4:
            return w.transpose(2, 3, 1, 0)
        raise ValueError(w.shape)

    for name, w in state_dict.items():
        if prefix:
            if not name.startswith(prefix):
                continue
            name = name[len(prefix):]
        w = _np(w)
        parts = name.split(".")

        # ---- FCM head ----
        if parts[0] == "head":
            if parts[1] in ("conv1", "conv2"):
                _set(params, ("head", parts[1], "kernel"), conv_k(w))
            elif parts[1] in ("bn1", "bn2"):
                _map_bn(params, stats, ("head", parts[1]), parts[2], w)
            elif parts[1] in ("layer1", "layer2"):
                blk = f"{parts[1]}_{parts[2]}"
                sub = parts[3]
                if sub in ("conv1", "conv2"):
                    _set(params, ("head", blk, sub, "kernel"), conv_k(w))
                elif sub in ("bn1", "bn2"):
                    _map_bn(params, stats, ("head", blk, sub), parts[4], w)
                elif sub == "shortcut":
                    if parts[4] == "0":
                        _set(params, ("head", blk, "shortcut_conv", "kernel"), conv_k(w))
                    else:
                        _map_bn(params, stats, ("head", blk, "shortcut_bn"), parts[5], w)
            continue

        # ---- xvector trunk ----
        if parts[0] == "xvector":
            rest = parts[1:]
            if rest[0] == "tdnn":
                if rest[1] == "linear":
                    _set(params, ("tdnn", "conv", "kernel"), conv_k(w))
                else:  # nonlinear.batchnorm.*
                    _map_bn(params, stats, ("tdnn", "nonlinear", "bn"), rest[-1], w)
            elif re.match(r"block\d+", rest[0]):
                blk, layer = rest[0], rest[1]  # tdnndN
                sub = rest[2]
                if sub in ("nonlinear1", "nonlinear2"):
                    _map_bn(params, stats, (blk, layer, sub, "bn"), rest[-1], w)
                elif sub == "linear1":
                    _set(params, (blk, layer, "linear1", "kernel"), conv_k(w))
                elif sub == "cam_layer":
                    which = rest[3]
                    if rest[4] == "weight":
                        _set(params, (blk, layer, "cam_layer", which, "kernel"), conv_k(w))
                    else:
                        _set(params, (blk, layer, "cam_layer", which, "bias"), w)
            elif re.match(r"transit\d+", rest[0]):
                if rest[1] == "linear":
                    _set(params, (rest[0], "linear", "kernel"), conv_k(w))
                else:
                    _map_bn(params, stats, (rest[0], "nonlinear", "bn"), rest[-1], w)
            elif rest[0] == "out_nonlinear":
                _map_bn(params, stats, ("out_nonlinear", "bn"), rest[-1], w)
            elif rest[0] == "dense":
                if rest[1] == "linear":
                    _set(params, ("dense_linear", "kernel"), _np(w)[:, :, 0].T)
                else:  # nonlinear.batchnorm: affine=False → stats only
                    _map_bn(params, stats, ("dense_nonlinear", "bn"), rest[-1], w)
            continue
    return params, stats


def _map_bn(params, stats, path, leaf, w):
    if leaf == "weight":
        _set(params, path + ("scale",), _np(w))
    elif leaf == "bias":
        _set(params, path + ("bias",), _np(w))
    elif leaf == "running_mean":
        _set(stats, path + ("mean",), _np(w))
    elif leaf == "running_var":
        _set(stats, path + ("var",), _np(w))
    # num_batches_tracked: ignored


def wavlm_torch_to_flax(state_dict: Dict[str, "np.ndarray"], prefix: str = "") -> dict:
    """Convert a reference WavLM state_dict to flax params (models/wavlm.py).

    The conv positional embedding's weight-norm parametrization
    (original0 = g along dim 2, original1 = v) is folded into a dense
    kernel here.
    """
    params: dict = {}
    sd = {}
    for k, v in state_dict.items():
        if prefix:
            if not k.startswith(prefix):
                continue
            k = k[len(prefix):]
        sd[k] = _np(v)

    # fold pos_conv weight norm: w = g * v / ||v|| over dims (0, 1)
    g = sd.get("encoder.pos_conv.0.parametrizations.weight.original0")
    v = sd.get("encoder.pos_conv.0.parametrizations.weight.original1")
    if g is None:  # older serialization: weight_g / weight_v
        g = sd.get("encoder.pos_conv.0.weight_g")
        v = sd.get("encoder.pos_conv.0.weight_v")
    if g is not None and v is not None:
        norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
        w = g * v / np.maximum(norm, 1e-12)  # (out, in/groups, k)
        _set(params, ("pos_conv", "kernel"), w.transpose(2, 1, 0))
    if "encoder.pos_conv.0.bias" in sd:
        _set(params, ("pos_conv", "bias"), sd["encoder.pos_conv.0.bias"])

    for name, w in sd.items():
        parts = name.split(".")
        if name.startswith("feature_extractor.conv_layers."):
            i = parts[2]
            if parts[3] == "0" and parts[-1] == "weight":  # conv
                _set(params, ("feature_extractor", f"conv_{i}", "kernel"), w.transpose(2, 1, 0))
            elif parts[3] == "2":  # group norm (layer 0, 'default' mode)
                leaf = "scale" if parts[-1] == "weight" else "bias"
                _set(params, ("feature_extractor", "gn0", leaf), w)
        elif name in ("layer_norm.weight", "layer_norm.bias"):
            _set(params, ("layer_norm", "scale" if parts[-1] == "weight" else "bias"), w)
        elif name.startswith("post_extract_proj."):
            _set(params, ("post_extract_proj", "kernel" if parts[-1] == "weight" else "bias"),
                 w.T if parts[-1] == "weight" else w)
        elif name in ("encoder.layer_norm.weight", "encoder.layer_norm.bias"):
            _set(params, ("encoder_layer_norm", "scale" if parts[-1] == "weight" else "bias"), w)
        elif name == "encoder.layers.0.self_attn.relative_attention_bias.weight":
            _set(params, ("relative_attention_bias",), w)
        elif name.startswith("encoder.layers."):
            i = parts[2]
            sub = parts[3]
            if sub == "self_attn":
                which = parts[4]
                if which in ("q_proj", "k_proj", "v_proj", "out_proj", "grep_linear"):
                    _set(
                        params,
                        (f"layer_{i}", "self_attn", which, "kernel" if parts[-1] == "weight" else "bias"),
                        w.T if parts[-1] == "weight" else w,
                    )
                elif which == "grep_a":
                    _set(params, (f"layer_{i}", "self_attn", "grep_a"), w)
            elif sub in ("self_attn_layer_norm", "final_layer_norm"):
                _set(params, (f"layer_{i}", sub, "scale" if parts[-1] == "weight" else "bias"), w)
            elif sub in ("fc1", "fc2"):
                _set(params, (f"layer_{i}", sub, "kernel" if parts[-1] == "weight" else "bias"),
                     w.T if parts[-1] == "weight" else w)
    return params


def whisper_torch_to_flax(state_dict: Dict[str, "np.ndarray"], prefix: str = "") -> dict:
    """Convert a transformers WhisperEncoder state_dict to flax params
    (models/whisper_encoder.py). Official OpenAI checkpoints use the same
    tensor shapes with different names; rename before calling."""
    params: dict = {}
    for name, w in state_dict.items():
        if prefix:
            if not name.startswith(prefix):
                continue
            name = name[len(prefix):]
        w = _np(w)
        parts = name.split(".")
        if parts[0] in ("conv1", "conv2"):
            leaf = "kernel" if parts[1] == "weight" else "bias"
            _set(params, (parts[0], leaf), w.transpose(2, 1, 0) if leaf == "kernel" else w)
        elif parts[0] == "embed_positions":
            _set(params, ("embed_positions",), w)
        elif parts[0] == "layer_norm":
            _set(params, ("ln_post", "scale" if parts[1] == "weight" else "bias"), w)
        elif parts[0] == "layers":
            i, sub = parts[1], parts[2]
            blk = f"block_{i}"
            if sub == "self_attn":
                which = parts[3]
                _set(params, (blk, "attn", which, "kernel" if parts[-1] == "weight" else "bias"),
                     w.T if parts[-1] == "weight" else w)
            elif sub == "self_attn_layer_norm":
                _set(params, (blk, "attn_ln", "scale" if parts[-1] == "weight" else "bias"), w)
            elif sub == "final_layer_norm":
                _set(params, (blk, "mlp_ln", "scale" if parts[-1] == "weight" else "bias"), w)
            elif sub in ("fc1", "fc2"):
                _set(params, (blk, sub, "kernel" if parts[-1] == "weight" else "bias"),
                     w.T if parts[-1] == "weight" else w)
    return params


def w2vbert_torch_to_flax(state_dict: Dict[str, "np.ndarray"], prefix: str = "") -> dict:
    """Convert a transformers Wav2Vec2BertModel state_dict to flax params
    (models/w2vbert.py)."""
    params: dict = {}
    for name, w in state_dict.items():
        if prefix:
            if not name.startswith(prefix):
                continue
            name = name[len(prefix):]
        w = _np(w)
        parts = name.split(".")
        if parts[0] == "masked_spec_embed":
            continue
        if parts[0] == "feature_projection":
            if parts[1] == "layer_norm":
                _set(params, ("fp_layer_norm", "scale" if parts[-1] == "weight" else "bias"), w)
            else:
                _set(params, ("fp_projection", "kernel" if parts[-1] == "weight" else "bias"),
                     w.T if parts[-1] == "weight" else w)
            continue
        if parts[0] == "encoder" and parts[1] == "layers":
            i, sub = parts[2], parts[3]
            blk = f"layer_{i}"
            if sub in ("ffn1_layer_norm", "ffn2_layer_norm", "self_attn_layer_norm", "final_layer_norm"):
                _set(params, (blk, sub, "scale" if parts[-1] == "weight" else "bias"), w)
            elif sub in ("ffn1", "ffn2"):
                which = parts[4]  # intermediate_dense | output_dense
                _set(params, (blk, sub, which, "kernel" if parts[-1] == "weight" else "bias"),
                     w.T if parts[-1] == "weight" else w)
            elif sub == "self_attn":
                which = parts[4]
                if which == "distance_embedding":
                    _set(params, (blk, "self_attn", "distance_embedding"), w)
                else:
                    _set(params, (blk, "self_attn", which, "kernel" if parts[-1] == "weight" else "bias"),
                         w.T if parts[-1] == "weight" else w)
            elif sub == "conv_module":
                which = parts[4]
                if which in ("layer_norm", "depthwise_layer_norm"):
                    _set(params, (blk, "conv_module", which, "scale" if parts[-1] == "weight" else "bias"), w)
                elif which in ("pointwise_conv1", "pointwise_conv2"):
                    # torch Conv1d (out, in, 1) → flax (1, in, out)
                    _set(params, (blk, "conv_module", which, "kernel"), w.transpose(2, 1, 0))
                elif which == "depthwise_conv":
                    # torch depthwise (out, 1, k) → flax (k, 1, out)
                    _set(params, (blk, "conv_module", which, "kernel"), w.transpose(2, 1, 0))
    return params


def hubert_torch_to_flax(state_dict: Dict[str, "np.ndarray"], prefix: str = "") -> dict:
    """Convert a transformers HubertModel / Wav2Vec2Model state_dict to the
    flax WavLM trunk (models/wavlm.py with relative_position_embedding=False,
    gru_rel_pos=False — HuBERT/wav2vec2 are that architecture minus the
    gated relative bias)."""
    params: dict = {}
    sd = {}
    for k, v in state_dict.items():
        if prefix:
            if not k.startswith(prefix):
                continue
            k = k[len(prefix):]
        sd[k] = _np(v)

    g = sd.get("encoder.pos_conv_embed.conv.parametrizations.weight.original0")
    v = sd.get("encoder.pos_conv_embed.conv.parametrizations.weight.original1")
    if g is None:
        g = sd.get("encoder.pos_conv_embed.conv.weight_g")
        v = sd.get("encoder.pos_conv_embed.conv.weight_v")
    if g is not None and v is not None:
        norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
        w = g * v / np.maximum(norm, 1e-12)
        _set(params, ("pos_conv", "kernel"), w.transpose(2, 1, 0))
    if "encoder.pos_conv_embed.conv.bias" in sd:
        _set(params, ("pos_conv", "bias"), sd["encoder.pos_conv_embed.conv.bias"])

    for name, w in sd.items():
        parts = name.split(".")
        if name.startswith("feature_extractor.conv_layers."):
            i = parts[2]
            if parts[3] == "conv" and parts[-1] == "weight":
                _set(params, ("feature_extractor", f"conv_{i}", "kernel"), w.transpose(2, 1, 0))
            elif parts[3] == "layer_norm":  # GroupNorm on layer 0 ('group' mode)
                _set(params, ("feature_extractor", "gn0", "scale" if parts[-1] == "weight" else "bias"), w)
        elif name.startswith("feature_projection.layer_norm."):
            _set(params, ("layer_norm", "scale" if parts[-1] == "weight" else "bias"), w)
        elif name.startswith("feature_projection.projection."):
            _set(params, ("post_extract_proj", "kernel" if parts[-1] == "weight" else "bias"),
                 w.T if parts[-1] == "weight" else w)
        elif name in ("encoder.layer_norm.weight", "encoder.layer_norm.bias"):
            _set(params, ("encoder_layer_norm", "scale" if parts[-1] == "weight" else "bias"), w)
        elif name.startswith("encoder.layers."):
            i, sub = parts[2], parts[3]
            blk = f"layer_{i}"
            if sub == "attention":
                which = parts[4]
                _set(params, (blk, "self_attn", which, "kernel" if parts[-1] == "weight" else "bias"),
                     w.T if parts[-1] == "weight" else w)
            elif sub == "layer_norm":
                _set(params, (blk, "self_attn_layer_norm", "scale" if parts[-1] == "weight" else "bias"), w)
            elif sub == "final_layer_norm":
                _set(params, (blk, "final_layer_norm", "scale" if parts[-1] == "weight" else "bias"), w)
            elif sub == "feed_forward":
                which = "fc1" if parts[4] == "intermediate_dense" else "fc2"
                _set(params, (blk, which, "kernel" if parts[-1] == "weight" else "bias"),
                     w.T if parts[-1] == "weight" else w)
    return params


def redimnet_torch_to_flax(state_dict: Dict[str, "np.ndarray"], stages_setup, prefix: str = "") -> Tuple[dict, dict]:
    """Convert a reference ReDimNet state_dict (redimnet.py) to
    (params, batch_stats) for models/redimnet.py::ReDimNet.

    `stages_setup` is needed to decode the per-stage nn.Sequential indices
    (pool conv / blocks / squeeze-back / to1d / time-context block).
    """
    params: dict = {}
    stats: dict = {}

    def conv_k(w):
        w = _np(w)
        if w.ndim == 3:
            return w.transpose(2, 1, 0)
        if w.ndim == 4:
            return w.transpose(2, 3, 1, 0)
        raise ValueError(w.shape)

    def dense_k(w):
        return _np(w).T

    def put_conv(path, leaf, w):
        _set(params, path + ("kernel" if leaf == "weight" else "bias",), conv_k(w) if leaf == "weight" else _np(w))

    def put_dense(path, leaf, w):
        _set(params, path + ("kernel" if leaf == "weight" else "bias",), dense_k(w) if leaf == "weight" else _np(w))

    def put_ln(path, leaf, w):
        _set(params, path + ("scale" if leaf == "weight" else "bias",), _np(w))

    def map_transformer(base, rest, leaf, w):
        sub = rest[0]
        if sub == "attention":
            put_dense(base + ("attention", rest[1]), leaf, w)
        elif sub == "layer_norm":
            put_ln(base + ("layer_norm",), leaf, w)
        elif sub == "final_layer_norm":
            put_ln(base + ("final_layer_norm",), leaf, w)
        elif sub == "feed_forward":
            name = "ff_intermediate" if rest[1] == "intermediate_dense" else "ff_output"
            put_dense(base + (name,), leaf, w)

    def map_convnext(base, rest, leaf, w):
        if rest[0] == "dwconvs":
            put_conv(base + (f"dwconv_{rest[1]}",), leaf, w)
        elif rest[0] == "norm":
            _map_bn(params, stats, base + ("norm",), leaf, w)
        elif rest[0] == "pwconv1":
            put_conv(base + ("pwconv1",), leaf, w)

    def map_tcb(base, rest, leaf, w, block_1d_type):
        if rest[0] == "red_dim_conv":
            if rest[1] == "0":
                put_conv(base + ("red_dim_conv",), leaf, w)
            else:
                put_ln(base + ("red_dim_norm",), leaf, w)
        elif rest[0] == "exp_dim_conv":
            put_conv(base + ("exp_dim_conv",), leaf, w)
        elif rest[0] == "tcm":
            idx = rest[1]
            if block_1d_type == "conv+att":
                if idx in ("0", "1", "2", "3"):
                    map_convnext(base + (f"tcm_conv_{idx}",), rest[2:], leaf, w)
                else:
                    map_transformer(base + ("tcm_att",), rest[2:], leaf, w)
            elif block_1d_type == "att":
                if idx == "0":
                    if rest[2] == "conv":
                        put_conv(base + ("tcm_pos", "conv"), leaf, w)
                    else:
                        put_ln(base + ("tcm_pos", "norm"), leaf, w)
                else:
                    map_transformer(base + ("tcm_att",), rest[2:], leaf, w)
            elif block_1d_type == "fc":
                if idx == "0":
                    put_conv(base + ("tcm_fc1",), leaf, w)
                elif idx == "1":
                    put_ln(base + ("tcm_norm",), leaf, w)
                else:
                    put_conv(base + ("tcm_fc2",), leaf, w)

    def map_block2d(base, rest, leaf, w):
        # rest starts after 'conv_block.'
        sub = rest[0]
        if sub in ("conv1", "conv1pw", "conv2", "conv2pw", "pwconv1"):
            put_conv(base + (sub,), leaf, w)
        elif sub in ("bn1", "bn2", "norm"):
            _map_bn(params, stats, base + (sub,), leaf, w)
        elif sub == "dwconvs":
            put_conv(base + (f"dwconv_{rest[1]}",), leaf, w)
        elif sub == "se":
            put_dense(base + ("se", rest[1]), leaf, w)
        elif sub == "downsample":
            if rest[1] == "0":
                put_conv(base + ("downsample_conv",), leaf, w)
            else:
                _map_bn(params, stats, base + ("downsample_bn",), leaf, w)

    for name, w in state_dict.items():
        if prefix:
            if not name.startswith(prefix):
                continue
            name = name[len(prefix):]
        parts = name.split(".")
        leaf = parts[-1]
        if leaf == "num_batches_tracked":
            continue
        if parts[0] == "backbone":
            rest = parts[1:]
            if rest[0] == "inputs_weights":
                i = int(rest[1])
                if i == 0:
                    continue  # fixed ones; softmax over one input is identity
                _set(params, ("backbone", f"inputs_weights_{i}"), _np(w)[0, :, :, 0])
            elif rest[0] == "stem":
                if rest[1] == "0":
                    put_conv(("backbone", "stem_conv"), leaf, w)
                else:
                    put_ln(("backbone", "stem_norm"), leaf, w)
            elif rest[0] == "mfa":
                if rest[1] == "0":
                    put_conv(("backbone", "mfa_conv"), leaf, w)
                else:
                    _map_bn(params, stats, ("backbone", "mfa_bn"), leaf, w)
            elif rest[0].startswith("stage"):
                si = int(rest[0][5:])
                stride, num_blocks, conv_exp, _ks, att_red = stages_setup[si]
                idx = int(rest[1])
                base = ("backbone", f"stage{si}")
                squeeze_at = num_blocks + 1 if conv_exp != 1 else None
                tcb_at = num_blocks + (2 if conv_exp != 1 else 1) + 1
                if idx == 0:
                    put_conv(base + ("pool_conv",), leaf, w)
                elif 1 <= idx <= num_blocks:
                    # parts: backbone.stageN.idx.conv_block.<rest>
                    map_block2d(base + (f"block_{idx - 1}", "conv_block"), parts[4:], leaf, w)
                elif squeeze_at is not None and idx == squeeze_at:
                    which = parts[3]
                    if which == "0":
                        put_conv(base + ("squeeze_conv",), leaf, w)
                    elif which == "1":
                        _map_bn(params, stats, base + ("squeeze_bn",), leaf, w)
                    else:
                        put_conv(base + ("squeeze_pw",), leaf, w)
                elif idx == tcb_at:
                    # infer block_1d_type from key names
                    map_tcb(base + ("tcb",), parts[3:], leaf, w,
                            "conv+att" if any(f"{rest[0]}.{idx}.tcm.4." in k for k in state_dict) or
                                          any(f"{rest[0]}.{idx}.tcm.3.dwconvs" in k for k in state_dict)
                            else ("att" if any(f"{rest[0]}.{idx}.tcm.0.conv." in k for k in state_dict) else "fc"))
        elif parts[0] == "pool":
            put_dense((f"pool_{parts[1]}",), leaf, _np(w)[:, :, 0] if leaf == "weight" else w)
        elif parts[0] == "seg_1":
            put_dense(("seg_1",), leaf, w)
    return params, stats


def eres2net_torch_to_flax(state_dict: Dict[str, "np.ndarray"], prefix: str = "") -> Tuple[dict, dict]:
    """Convert a reference ERes2Net / ERes2Net_huge / ERes2NetV2 state_dict
    to (params, batch_stats) for models/eres2net.py.

    Handles both topologies: the base GFF cascade
    (layer{1,2,3}_downsample + fuse_mode{12,123,1234}, ERes2Net.py) and the
    pruned V2 (layer3_ds + fuse34, ERes2NetV2.py). The TSTP stats vector is
    ordered (part, channel, freq) in torch but (part, freq, channel) here
    (frames are flattened freq-major), so seg_1 rows are permuted.
    """
    params: dict = {}
    stats: dict = {}

    def conv_k(w):
        w = _np(w)
        return w.transpose(2, 3, 1, 0)

    def put_aff(base: Tuple[str, ...], rest, w):
        # local_att: 0=conv,1=bn,2=silu,3=conv,4=bn
        idx, leaf = rest[0], rest[1]
        if idx == "0":
            _set(params, base + ("conv1", "kernel" if leaf == "weight" else "bias"),
                 conv_k(w) if leaf == "weight" else _np(w))
        elif idx == "1":
            _map_bn(params, stats, base + ("bn1",), leaf, w)
        elif idx == "3":
            _set(params, base + ("conv2", "kernel" if leaf == "weight" else "bias"),
                 conv_k(w) if leaf == "weight" else _np(w))
        elif idx == "4":
            _map_bn(params, stats, base + ("bn2",), leaf, w)

    items = {}
    for name, w in state_dict.items():
        if prefix:
            if not name.startswith(prefix):
                continue
            name = name[len(prefix):]
        items[name] = w

    # stats-channel count for the seg_1 permutation: conv3 of the last
    # layer4 block (= m_channels·8·expansion)
    n_channels = None
    for name, w in items.items():
        if re.match(r"layer4\.\d+\.conv3\.weight", name):
            n_channels = _np(w).shape[0]

    for name, w in items.items():
        parts = name.split(".")
        if parts[0] == "conv1":
            _set(params, ("conv1", "kernel"), conv_k(w))
        elif parts[0] == "bn1":
            _map_bn(params, stats, ("bn1",), parts[1], w)
        elif re.match(r"layer[1-4]$", parts[0]):
            blk = f"{parts[0]}_{parts[1]}"
            sub = parts[2]
            if sub in ("conv1", "conv3"):
                _set(params, (blk, sub, "kernel"), conv_k(w))
            elif sub in ("bn1", "bn3"):
                _map_bn(params, stats, (blk, sub), parts[3], w)
            elif sub == "convs":
                _set(params, (blk, f"conv_{parts[3]}", "kernel"), conv_k(w))
            elif sub == "bns":
                _map_bn(params, stats, (blk, f"bn_{parts[3]}"), parts[4], w)
            elif sub == "fuse_models":
                put_aff((blk, f"aff_{parts[3]}"), parts[5:], w)
            elif sub == "shortcut":
                if parts[3] == "0":
                    _set(params, (blk, "shortcut_conv", "kernel"), conv_k(w))
                else:
                    _map_bn(params, stats, (blk, "shortcut_bn"), parts[4], w)
        elif re.match(r"layer[1-3]_downsample", parts[0]) or parts[0] == "layer3_ds":
            _set(params, (parts[0], "kernel"), conv_k(w))
        elif parts[0].startswith("fuse_mode") or parts[0] == "fuse34":
            flax_name = parts[0].replace("fuse_mode", "fuse")
            put_aff((flax_name,), parts[2:], w)
        elif parts[0] == "seg_1":
            if parts[1] == "bias":
                _set(params, ("seg_1", "bias"), _np(w))
            else:
                W = _np(w)  # (emb, 2·C·F)
                CF = W.shape[1] // 2
                C = n_channels
                F8 = CF // C
                perm = np.empty(2 * CF, np.int64)
                for part in range(2):
                    for f in range(F8):
                        for c in range(C):
                            perm[part * CF + f * C + c] = part * CF + c * F8 + f
                _set(params, ("seg_1", "kernel"), W[:, perm].T)
    return params, stats


def whisper_decoder_torch_to_flax(state_dict: Dict[str, "np.ndarray"], prefix: str = "") -> dict:
    """Convert a transformers WhisperDecoder state_dict to flax params
    (models/whisper_decoder.py). The lm head is tied to embed_tokens."""
    params: dict = {}
    attn_name = {"self_attn": "self_attn", "encoder_attn": "cross_attn"}
    ln_name = {
        "self_attn_layer_norm": "self_attn_ln",
        "encoder_attn_layer_norm": "cross_attn_ln",
        "final_layer_norm": "mlp_ln",
    }
    for name, w in state_dict.items():
        if prefix:
            if not name.startswith(prefix):
                continue
            name = name[len(prefix):]
        w = _np(w)
        parts = name.split(".")
        if parts[0] == "embed_tokens":
            _set(params, ("embed_tokens", "embedding"), w)
        elif parts[0] == "embed_positions":
            _set(params, ("embed_positions",), w)
        elif parts[0] == "layer_norm":
            _set(params, ("ln", "scale" if parts[1] == "weight" else "bias"), w)
        elif parts[0] == "layers":
            i, sub = parts[1], parts[2]
            blk = f"block_{i}"
            if sub in attn_name:
                which = parts[3]
                _set(params, (blk, attn_name[sub], which, "kernel" if parts[-1] == "weight" else "bias"),
                     w.T if parts[-1] == "weight" else w)
            elif sub in ln_name:
                _set(params, (blk, ln_name[sub], "scale" if parts[-1] == "weight" else "bias"), w)
            elif sub in ("fc1", "fc2"):
                _set(params, (blk, sub, "kernel" if parts[-1] == "weight" else "bias"),
                     w.T if parts[-1] == "weight" else w)
    return params


def _state_dict(path: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def campplus_from_torch(state_dict: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A wespeaker CAM++ state dict → models/campplus.CAMPPlus's."""
    return convert.campplus_from_flax(*campplus_torch_to_flax(state_dict, prefix))


def wavlm_from_torch(state_dict: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """An unilm WavLM state dict → models/wavlm.WavLMModel's."""
    return convert.wavlm_from_flax(wavlm_torch_to_flax(state_dict, prefix))


def hubert_from_torch(state_dict: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A transformers HuBERT / wav2vec2 / MMS state dict → models/wavlm.WavLMModel's
    (relative_position_embedding=False, gru_rel_pos=False)."""
    return convert.wavlm_from_flax(hubert_torch_to_flax(state_dict, prefix))


def whisper_from_torch(state_dict: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A transformers WhisperEncoder state dict → models/whisper_encoder.WhisperEncoder's."""
    return convert.whisper_from_flax(whisper_torch_to_flax(state_dict, prefix))


def w2vbert_from_torch(state_dict: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A transformers Wav2Vec2BertModel state dict → models/w2vbert.W2vBertModel's."""
    return convert.w2vbert_from_flax(w2vbert_torch_to_flax(state_dict, prefix))


def redimnet_from_torch(state_dict: dict, stages_setup, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A reference ReDimNet state dict → models/redimnet.ReDimNet's."""
    return convert.redimnet_from_flax(*redimnet_torch_to_flax(state_dict, stages_setup, prefix))


def eres2net_from_torch(state_dict: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A reference ERes2Net / ERes2Net_huge / ERes2NetV2 state dict →
    models/eres2net.ERes2Net's (ERes2NetV2's)."""
    return convert.eres2net_from_flax(*eres2net_torch_to_flax(state_dict, prefix))


def whisper_decoder_from_torch(state_dict: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A transformers WhisperDecoder state dict → models/whisper_decoder.WhisperDecoder's."""
    return convert.whisper_decoder_from_flax(whisper_decoder_torch_to_flax(state_dict, prefix))


def load_campplus_checkpoint(path: str, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A wespeaker CAM++ `.pt`/`.bin` file → models/campplus.CAMPPlus's state dict."""
    return campplus_from_torch(_state_dict(path), prefix)


def load_eres2net_checkpoint(path: str, prefix: str = "") -> Dict[str, torch.Tensor]:
    """An ERes2Net(/V2/huge) `.pt`/`.bin` file → models/eres2net's state dict."""
    return eres2net_from_torch(_state_dict(path), prefix)
