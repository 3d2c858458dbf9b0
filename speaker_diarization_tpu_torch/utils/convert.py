"""Weights carried across from the JAX package: flax variables → state_dict.

The JAX TS-VAD model's variables are nested dicts (`params` + `batch_stats`)
of arrays. `save_flax_npz` / `load_flax_npz` keep them as one .npz whose
keys are the `/`-joined paths ("params/speech_encoder/tdnn/conv/kernel"),
and `tsvad_from_flax` / `campplus_from_flax` map them to this package's
state dicts. Layout rules (the inverse of the JAX package's
utils/torch_convert.py):

  flax Conv kernel (K, Cin, Cout)        → Conv1d weight (Cout, Cin, K)
  flax Conv kernel (KH, KW, Cin, Cout)   → Conv2d weight (Cout, Cin, KH, KW)
  flax Dense kernel (Cin, Cout)          → Linear weight (Cout, Cin)
  flax MHA query/key/value (D, H, Dh)    → Linear weight (H·Dh, D), bias (H·Dh,)
  flax MHA out (H, Dh, D)                → Linear weight (D, H·Dh)
  BatchNorm scale/bias + mean/var        → weight/bias + running_mean/running_var
  LayerNorm scale/bias                   → weight/bias
  Mamba conv_kernel (d_conv, 1, d_inner) → conv.weight (d_inner, 1, d_conv)
  Mamba conv_bias, A_log, D              → conv.bias, A_log, D
  Mamba-2 conv_kernel (d_conv, 1, d_xbc)  → conv.weight (d_xbc, 1, d_conv);
  Mamba-2 dt_bias, RMSNorm scale          → dt_bias, norm.weight
  LSTM ii|if|ig|io kernels (Din, D) each → input.weight (4D, Din), gate rows i, f, g, o
  LSTM hi|hf|hg|ho kernels and biases    → hidden.weight (4D, D), hidden.bias (4D,)

`eend_from_flax` / `eda_from_flax` map the JAX EENDModel / EendEdaModel
variables, `eend_to_flax` maps either model's state dict back.
`spk_from_flax` / `spk_to_flax` map the JAX SpeakerClassifier (CAM++ with its
dense head, plus `aam_weight`), and `campplus_to_flax` a CAM++ state dict.

`streaming_tsvad_from_flax` / `streaming_tsvad_to_flax` map the JAX
StreamingTSVADModel (its Conv2d front-end, Dense layers, and KV encoder
layers whose q/k/v/out are DenseGeneral kernels as in the MHA rows above).

`load_encoder_npz` reads the JAX `export-encoder` npz (models/spk_embed.py
`save_encoder`: "/"-joined variable paths and a JSON `__cfg__`).

Modules ported with the flax module names (models/conformer.py,
models/speaker_encoders.py) map by name through `named_from_flax` /
`named_to_flax`: the path is the state-dict name, with the layout rules
above and two more:

  flax ConvTranspose kernel (K, Cin, Cout) → ConvTranspose1d weight
      (Cin, Cout, K) flipped in time (models/tsvad.ConvTransposeSame)
  GroupNorm scale/bias                   → weight/bias

`sond_from_flax` / `sond_to_flax`, `tsvad3_from_flax` / `tsvad3_to_flax`
and `eend_vc_from_flax` / `eend_vc_to_flax` map the JAX SONDModel,
TSVAD3Model and EENDVCModel: SOND by name (its depthwise FSMN kernels
(k, 1, d) → Conv1d weight (d, 1, k)) with vanilla CD layers as transformer
layers; TS-VAD3 as TS-VAD plus its speaker-side CAM++ and the AttFuse
projections; EEND-VC as EEND plus the `vec_head_i` Linears, the speaker
table (nn.Embed `embedding` → `spk_table.weight`) and the scalars `alpha`
and `beta`.

`ssnd_from_flax` / `ssnd_to_flax`, `m2f_from_flax` / `m2f_to_flax`,
`fs_eend_from_flax` / `fs_eend_to_flax` and `ots_vad_from_flax` /
`ots_vad_to_flax` map the JAX SSNDModel (its CAM++ extractor as above; the
parameters it holds directly, pos_emb, E_all, e_pse, e_non, det_query and
rep_query, as they are), EENDM2FModel (`query_emb` as it is; the
ConvTransposes `up2`/`up5` flipped), FSEENDModel (the EEND encoder as
above) and OTSVADModel (its nn.RNN LSTMs' `cell` gates as the EDA's);
their other modules map by name, attention kernels as DenseGeneral.

`vad_from_flax` / `vad_to_flax` and `enhancer_from_flax` /
`enhancer_to_flax` map the JAX NeuralVAD (its OptimizedLSTMCell `lstm` as
the EDA's) and MaskDenoiser; their convs, LayerNorms and Denses map by
name. A module's two flax GRUCells under nn.RNN (the enhancer's, ReDimNet's
GRU block), `GRUCell_0` forward and `GRUCell_1` reversed, map by name to
`gru_fwd`/`gru_bwd` (models/enhancer.GRU): ir|iz|in kernels (Din, D) each
and biases → input.weight (3D, Din), input.bias (3D,); hr|hz → hidden
.weight (2D, D); hn → hidden_n.

The speech-encoder zoo is ported with the flax names too:
`wavlm_from_flax`, `whisper_from_flax`, `w2vbert_from_flax`,
`eres2net_from_flax` and `redimnet_from_flax` (each with its `_to_flax`)
are `named_from_flax` (`named_to_flax`) under the trunk's name. The
parameters a module holds directly (WavLM's `grep_a` and
`relative_attention_bias`, Whisper's `embed_positions`, w2v-BERT's
`distance_embedding`, ReDimNet's `inputs_weights_i`; TS-VAD's
`wavlm_weights`) keep their name and shape.

`conformer`, the speech encoders but CAM++, the TS-VAD
`conformer` and BiLSTM (`lstm_fwd`/`lstm_bwd` for flax's
OptimizedLSTMCell_0/_1) backends and the upsampling `speech_down` go
through them inside `tsvad_from_flax`/`tsvad_to_flax`, `eda_from_flax`/
`eend_to_flax` and `spk_from_flax`/`spk_to_flax`; `encoder_from_flax` /
`encoder_to_flax` map any speech encoder by its export-encoder or zoo name.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _t(w) -> torch.Tensor:
    return torch.from_numpy(np.array(w, dtype=np.float32))  # a writable copy


def _flatten(tree: dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def save_flax_npz(path: str, variables: dict, **extra: np.ndarray) -> None:
    """Write flax variables ({'params': ..., 'batch_stats': ...}) as one npz,
    with `extra` arrays (a config) under their own top-level keys."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = {"/".join(p): np.asarray(v) for p, v in _flatten(variables)}
    np.savez(path, **flat, **extra)


def load_flax_npz(path: str) -> dict:
    """Read an npz written by `save_flax_npz` back into nested dicts."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return out


def _kernel(w: np.ndarray) -> np.ndarray:
    if w.ndim == 3:  # Conv1d
        return w.transpose(2, 1, 0)
    if w.ndim == 4:  # Conv2d
        return w.transpose(3, 2, 0, 1)
    if w.ndim == 2:  # Dense
        return w.T
    raise ValueError(f"unexpected kernel shape {w.shape}")


def _campplus_module(path: Tuple[str, ...]) -> str:
    """flax module path inside CAMPPlus → wespeaker module name."""
    if path[0] == "head":
        out = ["head"]
        for p in path[1:]:
            m = re.fullmatch(r"(layer\d+)_(\d+)", p)
            if m:
                out += [m.group(1), m.group(2)]
            elif p == "shortcut_conv":
                out += ["shortcut", "0"]
            elif p == "shortcut_bn":
                out += ["shortcut", "1"]
            else:
                out.append(p)
        return ".".join(out)
    if path[0] == "dense_linear":
        return "xvector.dense.linear"
    if path[0] == "dense_nonlinear":
        return "xvector.dense.nonlinear.batchnorm"
    ren = {"conv": "linear", "bn": "batchnorm"}
    return "xvector." + ".".join(ren.get(p, p) for p in path)


def campplus_from_flax(params: dict, stats: dict) -> Dict[str, torch.Tensor]:
    """JAX CAMPPlus (params, batch_stats) → this package's CAMPPlus state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for coll in (params, stats):
        for path, w in _flatten(coll):
            mod, leaf = _campplus_module(path[:-1]), path[-1]
            if leaf == "kernel":
                w = _kernel(w)
                if mod == "xvector.dense.linear":
                    w = w[:, :, None]
                sd[f"{mod}.weight"] = _t(w)
                continue
            is_bn = mod.endswith("batchnorm") or re.search(r"\.(bn\d|shortcut\.1)$", mod)
            name = _BN_LEAF[leaf] if is_bn else leaf
            sd[f"{mod}.{name}"] = _t(w)
            if is_bn and leaf == "mean":
                sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def _backend_from_flax(params: dict, prefix: str) -> Dict[str, torch.Tensor]:
    sd: Dict[str, np.ndarray] = {}
    for layer, lp in params.items():  # layer_i
        base = f"{prefix}.{layer}" if prefix else layer
        att = lp["MultiHeadDotProductAttention_0"]
        for n in ("query", "key", "value"):
            k = att[n]["kernel"]  # (D, H, Dh)
            sd[f"{base}.attn.{n}.weight"] = k.reshape(k.shape[0], -1).T
            sd[f"{base}.attn.{n}.bias"] = att[n]["bias"].reshape(-1)
        k = att["out"]["kernel"]  # (H, Dh, D)
        sd[f"{base}.attn.out.weight"] = k.reshape(-1, k.shape[-1]).T
        sd[f"{base}.attn.out.bias"] = att["out"]["bias"]
        for flax_n, n in (("LayerNorm_0", "ln1"), ("LayerNorm_1", "ln2")):
            sd[f"{base}.{n}.weight"] = lp[flax_n]["scale"]
            sd[f"{base}.{n}.bias"] = lp[flax_n]["bias"]
        for i in range(2):
            d = lp["FeedForward_0"][f"Dense_{i}"]
            sd[f"{base}.ff.dense{i}.weight"] = d["kernel"].T
            sd[f"{base}.ff.dense{i}.bias"] = d["bias"]
    return {k: _t(v) for k, v in sd.items()}


def _mamba_backend_from_flax(params: dict, prefix: str) -> Dict[str, torch.Tensor]:
    """flax BiMambaBlock params → this package's BiMambaBlock state dict."""
    sd: Dict[str, np.ndarray] = {}
    for name, sub in params.items():
        base = f"{prefix}.{name}"
        if name.startswith("norm_"):
            sd[f"{base}.weight"], sd[f"{base}.bias"] = sub["scale"], sub["bias"]
        elif name.startswith("merge_"):
            sd[f"{base}.weight"] = sub["kernel"].T
        else:  # fwd_i / bwd_i: one MambaLayer
            for lin in ("in_proj", "x_proj", "dt_proj", "out_proj"):
                sd[f"{base}.{lin}.weight"] = sub[lin]["kernel"].T
            sd[f"{base}.dt_proj.bias"] = sub["dt_proj"]["bias"]
            sd[f"{base}.conv.weight"] = sub["conv_kernel"].transpose(2, 1, 0)
            sd[f"{base}.conv.bias"] = sub["conv_bias"]
            sd[f"{base}.A_log"], sd[f"{base}.D"] = sub["A_log"], sub["D"]
    return {k: _t(v) for k, v in sd.items()}


def _mamba2_backend_from_flax(params: dict, prefix: str) -> Dict[str, torch.Tensor]:
    """flax BiMamba2Block params → this package's BiMamba2Block state dict."""
    sd: Dict[str, np.ndarray] = {}
    for name, sub in params.items():
        base = f"{prefix}.{name}"
        if name.startswith("norm_"):  # norm_i and norm_out: RMSNorm, a scale only
            sd[f"{base}.weight"] = sub["scale"]
        elif name.startswith("merge_"):
            sd[f"{base}.weight"] = sub["kernel"].T
        else:  # fwd_i / bwd_i: one Mamba2Layer
            for lin in ("in_proj", "out_proj"):
                sd[f"{base}.{lin}.weight"] = sub[lin]["kernel"].T
            sd[f"{base}.conv.weight"] = sub["conv_kernel"].transpose(2, 1, 0)
            sd[f"{base}.conv.bias"] = sub["conv_bias"]
            sd[f"{base}.norm.weight"] = sub["norm"]["scale"]
            for leaf in ("dt_bias", "A_log", "D"):
                sd[f"{base}.{leaf}"] = sub[leaf]
    return {k: _t(v) for k, v in sd.items()}


_ATT = ("query", "key", "value")
# the ConvTransposes: models/tsvad.SpeechFeatUpsample's `up`, models/eend_m2f's `up2` and `up5`
_TRANSPOSED = ("up", "up2", "up5")


# parameters a module holds directly (flax `self.param`), kept as they are:
# WavLM's `grep_a` and `relative_attention_bias`, Whisper's `embed_positions`,
# w2v-BERT's `distance_embedding`, ReDimNet's `inputs_weights_i`
_RAW_LEAF = re.compile(r"grep_a|relative_attention_bias|embed_positions|distance_embedding|inputs_weights_\d+")
# a module's two flax GRUCells under nn.RNN, forward and reversed (the
# enhancer's, ReDimNet's GRU block): `GRUCell_0|1/{ir,iz,in,hr,hz,hn}` → the
# GRU Linears of models/enhancer.GRU, `gru_fwd|gru_bwd.{input,hidden,hidden_n}`
_GRU_CELLS = {"GRUCell_0": "gru_fwd", "GRUCell_1": "gru_bwd"}
_GRU_LINEARS = {"input": ("ir", "iz", "in"), "hidden": ("hr", "hz"), "hidden_n": ("hn",)}


def _gru_from_flax(p: dict, prefix: str) -> Dict[str, torch.Tensor]:
    """flax GRUCell params (ir|iz|in with bias, hr|hz without, hn with) →
    GRU input/hidden/hidden_n Linears under `prefix`."""
    sd = {}
    for linear, gates in _GRU_LINEARS.items():
        g = [p[x] for x in gates]
        sd[f"{prefix}.{linear}.weight"] = _t(np.concatenate([x["kernel"] for x in g], 1).T)
        if "bias" in g[0]:
            sd[f"{prefix}.{linear}.bias"] = _t(np.concatenate([x["bias"] for x in g]))
    return sd


def _gru_to_flax(params: dict, path: Tuple[str, ...], linear: str, leaf: str, w: np.ndarray) -> None:
    """One GRU Linear split into the cell's gate Denses under `path`; the inverse of `_gru_from_flax`."""
    gates = _GRU_LINEARS[linear]
    for gate, wg in zip(gates, np.split(w, len(gates), axis=0)):
        _put(params, (*path, gate, "kernel" if leaf == "weight" else "bias"), wg.T if leaf == "weight" else wg)


def _split_gru_cells(params: dict, prefix: Tuple[str, ...] = ()):
    """(params without the GRU cells, [(state-dict path of the GRU, cell params)])."""
    rest, cells = {}, []
    for k, v in params.items():
        if k in _GRU_CELLS and isinstance(v, dict) and "ir" in v:
            cells.append((prefix + (_GRU_CELLS[k],), v))
        elif isinstance(v, dict):
            rest[k], more = _split_gru_cells(v, prefix + (k,))
            cells += more
        else:
            rest[k] = v
    return rest, cells


def named_from_flax(params: dict, stats: Optional[dict] = None, prefix: str = "") -> Dict[str, torch.Tensor]:
    """flax variables (params, and batch_stats if any) of a module ported
    with the flax names → state-dict entries under `prefix`."""
    sd: Dict[str, torch.Tensor] = {}
    pre = (prefix,) if prefix else ()
    params, cells = _split_gru_cells(params)
    for path, p in cells:
        sd.update(_gru_from_flax(p, ".".join(pre + path)))
    for path, w in _flatten(params):
        mod, leaf = path[:-1], path[-1]
        name = ".".join(pre + mod)
        if _RAW_LEAF.fullmatch(leaf):
            sd[".".join(pre + path)] = _t(w)
        elif leaf == "kernel":
            if mod[-1] in _ATT and w.ndim == 3:  # (D, H, Dh)
                w = w.reshape(w.shape[0], -1).T
            elif mod[-1] == "out" and w.ndim == 3:  # (H, Dh, D)
                w = w.reshape(-1, w.shape[-1]).T
            elif mod[-1] in _TRANSPOSED:
                w = w.transpose(1, 2, 0)[..., ::-1]
            else:
                w = _kernel(w)
            sd[f"{name}.weight"] = _t(w)
        elif leaf == "scale":
            sd[f"{name}.weight"] = _t(w)
        else:
            sd[f"{name}.{leaf}"] = _t(w.reshape(-1))
    for path, w in _flatten(stats or {}):
        name = ".".join(pre + path[:-1])
        sd[f"{name}.{_BN_LEAF[path[-1]]}"] = _t(w)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def named_to_flax(state_dict: Dict[str, torch.Tensor], num_heads: int = 0) -> dict:
    """The inverse of `named_from_flax` for state-dict entries named from
    the module down → JAX variables as numpy ({'params', 'batch_stats'})."""
    out: dict = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        if name.endswith("num_batches_tracked"):
            continue
        w = t.detach().cpu().float().numpy()
        mod, leaf = tuple(name.split(".")[:-1]), name.split(".")[-1]
        if _RAW_LEAF.fullmatch(leaf):
            _put(out["params"], (*mod, leaf), w)
        elif len(mod) >= 2 and mod[-2] in _GRU_CELLS.values() and mod[-1] in _GRU_LINEARS:
            cell = {v: k for k, v in _GRU_CELLS.items()}[mod[-2]]
            _gru_to_flax(out["params"], (*mod[:-2], cell), mod[-1], leaf, w)
        elif leaf in ("running_mean", "running_var"):
            _put(out["batch_stats"], (*mod, "mean" if leaf == "running_mean" else "var"), w)
        elif leaf == "bias":
            _put(out["params"], (*mod, "bias"), w.reshape(num_heads, -1) if mod[-1] in _ATT and num_heads else w)
        elif w.ndim == 1:  # a norm's scale
            _put(out["params"], (*mod, "scale"), w)
        elif mod[-1] in _ATT and num_heads:  # (H·Dh, D) → (D, H, Dh)
            _put(out["params"], (*mod, "kernel"), w.T.reshape(w.shape[1], num_heads, -1))
        elif mod[-1] == "out" and num_heads:  # (D, H·Dh) → (H, Dh, D)
            _put(out["params"], (*mod, "kernel"), w.T.reshape(num_heads, -1, w.shape[0]))
        elif mod[-1] in _TRANSPOSED:
            _put(out["params"], (*mod, "kernel"), w[..., ::-1].transpose(2, 0, 1))
        else:  # Dense, Conv1d, Conv2d
            _put(out["params"], (*mod, "kernel"), w.transpose({2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}[w.ndim]))
    return out


_BILSTM = {"OptimizedLSTMCell_0": "lstm_fwd", "OptimizedLSTMCell_1": "lstm_bwd"}


def _bilstm_from_flax(params: dict, prefix: str) -> Dict[str, torch.Tensor]:
    sd = {f"{prefix}.proj.weight": _t(params["proj"]["kernel"].T), f"{prefix}.proj.bias": _t(params["proj"]["bias"])}
    for cell, name in _BILSTM.items():
        sd.update(_lstm_from_flax(params[cell], f"{prefix}.{name}"))
    return sd


def _bilstm_to_flax(parts: list, w: np.ndarray, params: dict, top: str) -> None:
    """One BiLSTM backend tensor ([module, ..., leaf] below the backend) into params."""
    mod, leaf = parts[0], parts[-1]
    if mod == "proj":
        _put(params, (top, "proj", "kernel" if leaf == "weight" else "bias"), w.T if leaf == "weight" else w)
        return
    cell = {v: k for k, v in _BILSTM.items()}[mod]
    _lstm_to_flax(params, (top, cell), parts[1], leaf, w)


def _backend_from_flax_any(params: dict, stats: dict, prefix: str) -> Dict[str, torch.Tensor]:
    """A TS-VAD backend of any ported kind, told apart by its own keys: a
    conformer has `conformer`, a BiLSTM its two cells, a transformer
    layer_i, a BiMamba-2 layer a dt_bias, a BiMamba layer an x_proj."""
    if "conformer" in params:
        return named_from_flax(params, stats, prefix)
    if "OptimizedLSTMCell_0" in params:
        return _bilstm_from_flax(params, prefix)
    if "fwd_0" not in params:
        return _backend_from_flax(params, prefix)
    if "dt_bias" in params["fwd_0"]:
        return _mamba2_backend_from_flax(params, prefix)
    return _mamba_backend_from_flax(params, prefix)


def _mamba_to_flax(parts: list, w: np.ndarray) -> Tuple[Tuple[str, ...], np.ndarray]:
    """Inverse of `_mamba_backend_from_flax` and `_mamba2_backend_from_flax`
    for one tensor: parts are the state-dict name below the backend
    ([module, ..., leaf])."""
    mod, leaf = parts[0], parts[-1]
    if mod.startswith("norm_"):
        return (mod, "scale" if leaf == "weight" else "bias"), w
    if parts[1] == "norm":  # a Mamba-2 layer's gated RMSNorm
        return (mod, "norm", "scale"), w
    if mod.startswith("merge_"):
        return (mod, "kernel"), w.T
    if parts[1] == "conv":
        return ((mod, "conv_kernel"), w.transpose(2, 1, 0)) if leaf == "weight" else ((mod, "conv_bias"), w)
    if len(parts) == 2:  # A_log, D
        return (mod, leaf), w
    return (mod, parts[1], "kernel" if leaf == "weight" else "bias"), w.T if leaf == "weight" else w


def load_encoder_npz(path: str) -> Tuple[dict, dict]:
    """JAX export-encoder npz → (its config dict, {'params', 'batch_stats'})."""
    out: dict = {}
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__cfg__"]))
        for key in z.files:
            if key == "__cfg__":
                continue
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return meta, {"params": out.get("params", {}), "batch_stats": out.get("batch_stats", {})}


def _speech_encoder_from_flax(params: dict, stats: dict) -> Dict[str, torch.Tensor]:
    """CAM++ (it has the FCM `head`) or an encoder ported with the flax names."""
    if "head" in params:
        return campplus_from_flax(params, stats)
    return named_from_flax(params, stats)


# The zoo's trunks carry the flax names (their own parameters and ReDimNet's
# GRU cells included), so their converters are the named ones.
wavlm_from_flax = whisper_from_flax = w2vbert_from_flax = eres2net_from_flax = redimnet_from_flax = named_from_flax
wavlm_to_flax = whisper_to_flax = w2vbert_to_flax = eres2net_to_flax = redimnet_to_flax = named_to_flax


def encoder_from_flax(name: str, params: dict, stats: dict) -> Dict[str, torch.Tensor]:
    """A speech encoder's flax variables → its state dict, by the
    export-encoder or zoo name (campplus | ecapa | resnet34 | simam_resnet34
    | eres2net | redimnet | wavlm | whisper); all but CAM++ map by name."""
    return campplus_from_flax(params, stats) if name == "campplus" else named_from_flax(params, stats)


def encoder_to_flax(name: str, state_dict: Dict[str, torch.Tensor]) -> dict:
    """The inverse of `encoder_from_flax`."""
    return campplus_to_flax(state_dict) if name == "campplus" else named_to_flax(state_dict)


def tsvad_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX TSVADModel variables ({'params', 'batch_stats'}, arrays) →
    this package's TSVADModel state_dict (any speech encoder, with
    `wavlm_weights` for wavlm_weight_sum; transformer, conformer, BiLSTM,
    BiMamba or BiMamba-2 backends)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    enc = _speech_encoder_from_flax(p["speech_encoder"], s.get("speech_encoder", {}))
    sd.update({f"speech_encoder.{k}": v for k, v in enc.items()})
    for name in ("speech_down", "backend_down"):  # ConvBnRelu, or SpeechFeatUpsample
        sd.update(named_from_flax(p[name], s[name], name))
    if "proj_layer" in p:
        sd["proj_layer.weight"] = _t(p["proj_layer"]["kernel"].T)
        sd["proj_layer.bias"] = _t(p["proj_layer"]["bias"])
    if "wavlm_weights" in p:
        sd["wavlm_weights"] = _t(p["wavlm_weights"])
    for name in ("single_backend", "multi_backend"):
        sd.update(_backend_from_flax_any(p[name], s.get(name, {}), name))
    sd["fc.weight"] = _t(p["fc"]["kernel"].T)
    sd["fc.bias"] = _t(p["fc"]["bias"])
    return sd


def _put(tree: dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = np.ascontiguousarray(value, np.float32)


_BN_LEAF_INV = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def _campplus_to_flax(mod: list, leaf: str, w: np.ndarray):
    """Inverse of `_campplus_module`: → (collection, flax path, array)."""
    if mod[0] == "head":
        path, i = ["head"], 1
        while i < len(mod):
            if re.fullmatch(r"layer\d+", mod[i]):
                path.append(f"{mod[i]}_{mod[i + 1]}")
                i += 2
            elif mod[i] == "shortcut":
                path.append("shortcut_conv" if mod[i + 1] == "0" else "shortcut_bn")
                i += 2
            else:
                path.append(mod[i])
                i += 1
        is_bn = path[-1].startswith("bn") or path[-1] == "shortcut_bn"
    elif mod[:3] == ["xvector", "dense", "linear"]:
        return "params", ("dense_linear", "kernel"), w[:, :, 0].T
    elif mod[:2] == ["xvector", "dense"]:
        path, is_bn = ["dense_nonlinear", "bn"], True
    else:
        path = [{"batchnorm": "bn"}.get(p, p) for p in mod[1:]]
        if path[:2] == ["tdnn", "linear"]:
            path[1] = "conv"
        is_bn = mod[-1] == "batchnorm"
    if is_bn:
        coll, name = _BN_LEAF_INV[leaf]
        return coll, (*path, name), w
    if leaf == "weight":
        return "params", (*path, "kernel"), w.transpose(2, 1, 0) if w.ndim == 3 else w.transpose(2, 3, 1, 0)
    return "params", (*path, leaf), w


def campplus_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """This package's CAMPPlus state_dict → JAX variables as numpy
    ({'params', 'batch_stats'}); the inverse of `campplus_from_flax`."""
    out: dict = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        if name.endswith("num_batches_tracked"):
            continue
        parts = name.split(".")
        coll, path, w = _campplus_to_flax(parts[:-1], parts[-1], t.detach().cpu().float().numpy())
        _put(out[coll], path, w)
    return out


def spk_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX SpeakerClassifier variables ({'params', 'batch_stats'}) → this
    package's SpeakerClassifier state_dict."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd = {f"speech_encoder.{k}": v for k, v in _speech_encoder_from_flax(p["speech_encoder"], s["speech_encoder"]).items()}
    sd["aam_weight"] = _t(p["aam_weight"])
    return sd


def spk_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """SpeakerClassifier state_dict → JAX variables as numpy; the inverse of `spk_from_flax`."""
    pre = "speech_encoder."
    enc_sd = {k[len(pre):]: v for k, v in state_dict.items() if k.startswith(pre)}
    enc = campplus_to_flax(enc_sd) if "head.conv1.weight" in enc_sd else named_to_flax(enc_sd)
    aam = np.ascontiguousarray(state_dict["aam_weight"].detach().cpu().float().numpy())
    return {"params": {"speech_encoder": enc["params"], "aam_weight": aam},
            "batch_stats": {"speech_encoder": enc["batch_stats"]}}


def _layer_to_flax(parts: list, w: np.ndarray, num_heads: int) -> Tuple[Tuple[str, ...], np.ndarray]:
    """Inverse of `_backend_from_flax` for one tensor of a transformer layer:
    parts are the state-dict name from the layer on ([layer_i, ..., leaf])."""
    layer, leaf = parts[0], parts[-1]
    if parts[1] == "attn":  # layer_i.attn.<n>.<leaf>
        att, n = (layer, "MultiHeadDotProductAttention_0", parts[2]), parts[2]
        if leaf == "bias":
            return (*att, "bias"), w if n == "out" else w.reshape(num_heads, -1)
        if n == "out":  # (D, H·Dh) → (H, Dh, D)
            return (*att, "kernel"), w.T.reshape(num_heads, -1, w.shape[0])
        return (*att, "kernel"), w.T.reshape(w.shape[1], num_heads, -1)  # (H·Dh, D) → (D, H, Dh)
    if parts[1] in ("ln1", "ln2"):
        ln = "LayerNorm_0" if parts[1] == "ln1" else "LayerNorm_1"
        return (layer, ln, "scale" if leaf == "weight" else "bias"), w
    # feed-forward: layer_i.ff.dense{0,1}.<leaf>
    dense = ("FeedForward_0", "Dense_" + parts[2][-1])
    return (layer, *dense, "kernel" if leaf == "weight" else "bias"), w.T if leaf == "weight" else w


def tsvad_to_flax(state_dict: Dict[str, torch.Tensor], num_heads: int) -> dict:
    """This package's TSVADModel state_dict → JAX variables as numpy
    ({'params', 'batch_stats'}); the inverse of `tsvad_from_flax`, so
    weights made here can be written with `save_flax_npz`."""
    out = {"params": {}, "batch_stats": {}}
    campplus = any(n.startswith("speech_encoder.head.") for n in state_dict)
    named: Dict[str, Dict[str, torch.Tensor]] = {}  # top → entries mapped by name
    for name, t in state_dict.items():
        if name.endswith("num_batches_tracked"):
            continue
        w = t.detach().cpu().float().numpy()
        parts = name.split(".")
        top, leaf = parts[0], parts[-1]
        if top == "wavlm_weights":
            _put(out["params"], (top,), w)
        elif (top == "speech_encoder" and not campplus) or top in ("speech_down", "backend_down") \
                or parts[1] == "conformer":
            named.setdefault(top, {})[name[len(top) + 1:]] = t
        elif top == "speech_encoder":
            coll, path, w = _campplus_to_flax(parts[1:-1], leaf, w)
            _put(out[coll], ("speech_encoder", *path), w)
        elif parts[1] in _BILSTM.values() or parts[1] == "proj":
            _bilstm_to_flax(parts[1:], w, out["params"], top)
        elif top in ("fc", "proj_layer"):
            _put(out["params"], (top, "kernel" if leaf == "weight" else "bias"), w.T if leaf == "weight" else w)
        elif not parts[1].startswith("layer_"):  # a BiMamba or BiMamba-2 backend
            path, w = _mamba_to_flax(parts[1:], w)
            _put(out["params"], (top, *path), w)
        else:  # {single,multi}_backend.layer_i.<...>
            path, w = _layer_to_flax(parts[1:], w, num_heads)
            _put(out["params"], (top, *path), w)
    for top, sd in named.items():
        for coll, tree in named_to_flax(sd, num_heads).items():
            if tree:
                out[coll][top] = tree
    return out


# ---------------------------------------------------------------------------
# Streaming TS-VAD
# ---------------------------------------------------------------------------

_HEADS = ("query", "key", "value", "out")


def streaming_tsvad_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX StreamingTSVADModel variables ({'params'}, arrays) → this
    package's StreamingTSVADModel state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for path, w in _flatten(variables["params"]):
        mod, leaf = list(path[:-1]), path[-1]
        if mod[-1].startswith("Dense_"):  # a KV layer's ff/Dense_i
            mod[-1] = "dense" + mod[-1][len("Dense_"):]
        if leaf == "kernel":
            if mod[-1] in _HEADS and w.ndim == 3:  # (D, H, Dh), or out's (H, Dh, D)
                w = (w.reshape(-1, w.shape[-1]) if mod[-1] == "out" else w.reshape(w.shape[0], -1)).T
            else:
                w = _kernel(w)
            name = "weight"
        elif leaf == "bias":
            w, name = w.reshape(-1), "bias"
        else:  # LayerNorm scale
            name = "weight"
        sd[".".join(mod + [name])] = _t(w)
    return sd


def streaming_tsvad_to_flax(state_dict: Dict[str, torch.Tensor], num_heads: int) -> dict:
    """StreamingTSVADModel state_dict → JAX variables as numpy ({'params'});
    the inverse of `streaming_tsvad_from_flax`."""
    params: dict = {}
    for name, t in state_dict.items():
        w = t.detach().cpu().float().numpy()
        parts = name.split(".")
        mod, leaf = parts[:-1], parts[-1]
        if mod[-1].startswith("dense"):
            mod[-1] = "Dense_" + mod[-1][len("dense"):]
        if mod[-1].startswith("ln"):
            _put(params, (*mod, "scale" if leaf == "weight" else "bias"), w)
        elif mod[-1] in _HEADS and mod[-2].startswith("layer_"):
            if leaf == "bias":
                w = w if mod[-1] == "out" else w.reshape(num_heads, -1)
            elif mod[-1] == "out":  # (D, H·Dh) → (H, Dh, D)
                w = w.T.reshape(num_heads, -1, w.shape[0])
            else:  # (H·Dh, D) → (D, H, Dh)
                w = w.T.reshape(w.shape[1], num_heads, -1)
            _put(params, (*mod, "kernel" if leaf == "weight" else "bias"), w)
        elif leaf == "weight":
            _put(params, (*mod, "kernel"), w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T)
        else:
            _put(params, (*mod, "bias"), w)
    return {"params": params}


# ---------------------------------------------------------------------------
# EEND family: TransformerEncoder, EENDModel head, EDA LSTMs
# ---------------------------------------------------------------------------

_GATES = ("i", "f", "g", "o")


def _encoder_from_flax(p: dict, prefix: str) -> Dict[str, torch.Tensor]:
    """flax TransformerEncoder params → `<prefix>.` state-dict entries."""
    sd = {
        f"{prefix}.input_proj.weight": _t(p["input_proj"]["kernel"].T),
        f"{prefix}.input_proj.bias": _t(p["input_proj"]["bias"]),
        f"{prefix}.input_norm.weight": _t(p["input_norm"]["scale"]),
        f"{prefix}.input_norm.bias": _t(p["input_norm"]["bias"]),
    }
    sd.update(_backend_from_flax({k: v for k, v in p.items() if k.startswith("layer_")}, prefix))
    return sd


def _lstm_to_flax(params: dict, path: Tuple[str, ...], linear: str, leaf: str, w: np.ndarray) -> None:
    """One LSTM Linear (`input` or `hidden`) split into the cell's four gate
    Denses (ii..io, hi..ho) under `path`; the inverse of `_lstm_from_flax`."""
    kind = "i" if linear == "input" else "h"
    for g, wg in zip(_GATES, np.split(w, 4, axis=0)):
        _put(params, (*path, kind + g, "kernel" if leaf == "weight" else "bias"), wg.T if leaf == "weight" else wg)


def _lstm_from_flax(p: dict, prefix: str) -> Dict[str, torch.Tensor]:
    """flax OptimizedLSTMCell params (ii..io, hi..ho) → LSTM input/hidden Linears."""
    return {
        f"{prefix}.input.weight": _t(np.concatenate([p["i" + g]["kernel"] for g in _GATES], 1).T),
        f"{prefix}.hidden.weight": _t(np.concatenate([p["h" + g]["kernel"] for g in _GATES], 1).T),
        f"{prefix}.hidden.bias": _t(np.concatenate([p["h" + g]["bias"] for g in _GATES])),
    }


def eend_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX EENDModel variables ({'params'}, arrays) → EENDModel state_dict."""
    p = variables["params"]
    sd = _encoder_from_flax(p["encoder"], "encoder")
    sd["head.weight"], sd["head.bias"] = _t(p["head"]["kernel"].T), _t(p["head"]["bias"])
    return sd


def _attractor_from_flax(p: dict, prefix: str) -> Dict[str, torch.Tensor]:
    """flax EncoderDecoderAttractor params → `<prefix>.` state-dict entries."""
    sd = {**_lstm_from_flax(p["enc_lstm"], f"{prefix}.enc_lstm"), **_lstm_from_flax(p["dec_lstm"], f"{prefix}.dec_lstm")}
    sd[f"{prefix}.exist_head.weight"] = _t(p["exist_head"]["kernel"].T)
    sd[f"{prefix}.exist_head.bias"] = _t(p["exist_head"]["bias"])
    return sd


def eda_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX EendEdaModel variables ({'params'} and, for a conformer with
    batch norms, 'batch_stats'; transformer or conformer encoder) →
    EendEdaModel state_dict."""
    p = variables["params"]
    if "block_0" in p["encoder"]:  # a conformer
        enc = named_from_flax(p["encoder"], variables.get("batch_stats", {}).get("encoder", {}), "encoder")
    else:
        enc = _encoder_from_flax(p["encoder"], "encoder")
    return {**enc, **_attractor_from_flax(p["eda"], "eda")}


def eend_to_flax(state_dict: Dict[str, torch.Tensor], num_heads: int) -> dict:
    """EENDModel or EendEdaModel state_dict → JAX variables as numpy
    ({'params'}, and 'batch_stats' for a conformer with batch norms); the
    inverse of `eend_from_flax` / `eda_from_flax`."""
    params: dict = {}
    conformer: Dict[str, torch.Tensor] = {}
    for name, t in state_dict.items():
        w = t.detach().cpu().float().numpy()
        parts = name.split(".")
        top, leaf = parts[0], parts[-1]
        if top == "encoder" and parts[1].startswith("block_"):
            conformer[name[len("encoder."):]] = t
        elif top == "head" or parts[1] in ("input_proj", "exist_head"):
            path = tuple(parts[:-1]) + ("kernel" if leaf == "weight" else "bias",)
            _put(params, path, w.T if leaf == "weight" else w)
        elif parts[1] == "input_norm":
            _put(params, ("encoder", "input_norm", "scale" if leaf == "weight" else "bias"), w)
        elif top == "encoder":  # encoder.layer_i.<...>
            path, w = _layer_to_flax(parts[1:], w, num_heads)
            _put(params, ("encoder", *path), w)
        else:  # eda.{enc,dec}_lstm.{input,hidden}.<leaf>: split the four gates
            _lstm_to_flax(params, ("eda", parts[1]), parts[2], leaf, w)
    out = {"params": params}
    if conformer:
        enc = named_to_flax(conformer, num_heads)
        params["encoder"].update(enc["params"])
        if enc["batch_stats"]:
            out["batch_stats"] = {"encoder": enc["batch_stats"]}
    return out


# ---------------------------------------------------------------------------
# SOND, TS-VAD3, EEND-VC
# ---------------------------------------------------------------------------

_VANILLA = "MultiHeadDotProductAttention_0"  # a flax TransformerEncoderLayer's attention


def sond_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX SONDModel variables ({'params', 'batch_stats'}) → SONDModel
    state_dict; the modules map by name, vanilla CD layers as transformer
    layers."""
    p, s = variables["params"], variables.get("batch_stats", {})
    vanilla = {name: sub for name, sub in p.items() if _VANILLA in sub}
    sd = named_from_flax({name: sub for name, sub in p.items() if name not in vanilla}, s)
    sd.update(_backend_from_flax(vanilla, ""))
    return sd


def sond_to_flax(state_dict: Dict[str, torch.Tensor], num_heads: int) -> dict:
    """SONDModel state_dict → JAX variables as numpy; the inverse of `sond_from_flax`."""
    vanilla = {n.split(".")[0] for n in state_dict if n.split(".")[1:2] == ["attn"]}
    out = {"params": {}, "batch_stats": {}}
    named: Dict[str, torch.Tensor] = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        if parts[0] in vanilla:
            path, w = _layer_to_flax(parts, t.detach().cpu().float().numpy(), num_heads)
            _put(out["params"], path, w)
        else:
            named[name] = t
    for coll, tree in named_to_flax(named).items():
        out[coll].update(tree)
    return out


_TSVAD3_EXTRA = ("speaker_encoder", "fuse_fbank_module", "fuse_frame_module")


def tsvad3_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX TSVAD3Model variables → TSVAD3Model state_dict: TS-VAD's modules,
    the speaker-side CAM++ with its dense head, and the AttFuse projections."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd = tsvad_from_flax(variables)
    if "speaker_encoder" in p:
        enc = campplus_from_flax(p["speaker_encoder"], s["speaker_encoder"])
        sd.update({f"speaker_encoder.{k}": v for k, v in enc.items()})
    sd.update(named_from_flax({name: p[name] for name in _TSVAD3_EXTRA[1:] if name in p}, {}))
    return sd


def tsvad3_to_flax(state_dict: Dict[str, torch.Tensor], num_heads: int) -> dict:
    """TSVAD3Model state_dict → JAX variables as numpy; the inverse of `tsvad3_from_flax`."""
    parts: Dict[str, Dict[str, torch.Tensor]] = {}
    rest = {}
    for name, t in state_dict.items():
        top = name.split(".")[0]
        if top in _TSVAD3_EXTRA:
            parts.setdefault(top, {})[name[len(top) + 1:]] = t
        else:
            rest[name] = t
    out = tsvad_to_flax(rest, num_heads)
    for top, sd in parts.items():
        tree = campplus_to_flax(sd) if top == "speaker_encoder" else named_to_flax(sd)
        for coll in ("params", "batch_stats"):
            if tree[coll]:
                out[coll][top] = tree[coll]
    return out


def eend_vc_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX EENDVCModel variables ({'params'}) → EENDVCModel state_dict."""
    p = variables["params"]
    sd = eend_from_flax(variables)
    for name, sub in p.items():
        if name.startswith("vec_head_"):
            sd[f"{name}.weight"], sd[f"{name}.bias"] = _t(sub["kernel"].T), _t(sub["bias"])
    if "spk_table" in p:
        sd["spk_table.weight"] = _t(p["spk_table"]["embedding"])
        sd["alpha"], sd["beta"] = _t(p["alpha"]), _t(p["beta"])
    return sd


def eend_vc_to_flax(state_dict: Dict[str, torch.Tensor], num_heads: int) -> dict:
    """EENDVCModel state_dict → JAX variables as numpy; the inverse of `eend_vc_from_flax`."""
    own = ("spk_table", "alpha", "beta")
    out = eend_to_flax({k: v for k, v in state_dict.items()
                        if k.split(".")[0] not in own and not k.startswith("vec_head_")}, num_heads)
    params = out["params"]
    for name, t in state_dict.items():
        w = t.detach().cpu().float().numpy()
        top, leaf = name.split(".")[0], name.split(".")[-1]
        if top.startswith("vec_head_"):
            _put(params, (top, "kernel" if leaf == "weight" else "bias"), w.T if leaf == "weight" else w)
        elif top == "spk_table":
            _put(params, ("spk_table", "embedding"), w)
        elif top in ("alpha", "beta"):
            params[top] = np.asarray(w, np.float32)
    return out


# ---------------------------------------------------------------------------
# SSND, EEND-M2F, FS-EEND, OTS-VAD
# ---------------------------------------------------------------------------


def _raw_from_flax(p: dict, names) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(the arrays a module holds directly, flax `self.param`, as tensors of
    the same name and shape; the remaining params)."""
    raw = {n: _t(p[n]) for n in names if n in p}
    return raw, {k: v for k, v in p.items() if k not in raw}


def ssnd_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX SSNDModel variables ({'params', 'batch_stats'}) → SSNDModel
    state_dict: the CAM++ extractor as `campplus_from_flax`, the raw
    parameters (pos_emb, E_all, e_pse, e_non, det_query, rep_query) as they
    are, every other module by name."""
    from ..models.ssnd import RAW_PARAMS

    p, s = variables["params"], variables.get("batch_stats", {})
    sd, rest = _raw_from_flax(p, RAW_PARAMS)
    ext = campplus_from_flax(rest.pop("extractor"), s.get("extractor", {}))
    sd.update({f"extractor.{k}": v for k, v in ext.items()})
    sd.update(named_from_flax(rest, {k: v for k, v in s.items() if k != "extractor"}))
    return sd


def _split_to_flax(state_dict: Dict[str, torch.Tensor], num_heads: int, raw_names, campplus_tops=()) -> dict:
    """State-dict entries → JAX variables: the raw parameters as they are,
    CAM++ modules (`campplus_tops`) through `campplus_to_flax`, the rest by name."""
    out: dict = {"params": {}, "batch_stats": {}}
    named: Dict[str, torch.Tensor] = {}
    camp: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in state_dict.items():
        top = name.split(".")[0]
        if name in raw_names:
            out["params"][name] = np.ascontiguousarray(t.detach().cpu().float().numpy())
        elif top in campplus_tops:
            camp.setdefault(top, {})[name[len(top) + 1:]] = t
        else:
            named[name] = t
    for coll, tree in named_to_flax(named, num_heads).items():
        out[coll].update(tree)
    for top, sd in camp.items():
        tree = campplus_to_flax(sd)
        for coll in ("params", "batch_stats"):
            if tree[coll]:
                out[coll][top] = tree[coll]
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out


def ssnd_to_flax(state_dict: Dict[str, torch.Tensor], num_heads: int) -> dict:
    """SSNDModel state_dict → JAX variables as numpy; the inverse of `ssnd_from_flax`."""
    from ..models.ssnd import RAW_PARAMS

    return _split_to_flax(state_dict, num_heads, RAW_PARAMS, ("extractor",))


def m2f_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX EENDM2FModel variables ({'params'}) → EENDM2FModel state_dict:
    `query_emb` as it is, a transformer encoder as `eend_from_flax` maps
    one, every other module by name (the ConvTransposes `up2`/`up5` flipped
    in time)."""
    sd, rest = _raw_from_flax(variables["params"], ("query_emb",))
    if "layer_0" in rest["encoder"]:
        sd.update(_encoder_from_flax(rest.pop("encoder"), "encoder"))
    sd.update(named_from_flax(rest, {}))
    return sd


def m2f_to_flax(state_dict: Dict[str, torch.Tensor], num_heads: int) -> dict:
    """EENDM2FModel state_dict → JAX variables as numpy; the inverse of `m2f_from_flax`."""
    transformer = any(n.startswith("encoder.layer_") for n in state_dict)
    enc = {n: t for n, t in state_dict.items() if transformer and n.startswith("encoder.")}
    out = _split_to_flax({n: t for n, t in state_dict.items() if n not in enc}, num_heads, ("query_emb",))
    if enc:
        out["params"].update(eend_to_flax(enc, num_heads)["params"])
    return out


def fs_eend_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX FSEENDModel variables ({'params'}) → FSEENDModel state_dict: the
    encoder as `eend_from_flax` maps one, the conv, `convert` and the fusion
    layers by name."""
    p = dict(variables["params"])
    sd = _encoder_from_flax(p.pop("encoder"), "encoder")
    sd.update(named_from_flax(p, {}))
    return sd


def fs_eend_to_flax(state_dict: Dict[str, torch.Tensor], num_heads: int) -> dict:
    """FSEENDModel state_dict → JAX variables as numpy; the inverse of `fs_eend_from_flax`."""
    enc = {n: t for n, t in state_dict.items() if n.startswith("encoder.")}
    params = named_to_flax({n: t for n, t in state_dict.items() if n not in enc}, num_heads)["params"]
    params.update(eend_to_flax(enc, num_heads)["params"])
    return {"params": params}


_OTS_LSTMS = ("lstm_fwd", "lstm_bwd")


def ots_vad_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX OTSVADModel variables ({'params', 'batch_stats'}) → OTSVADModel
    state_dict: the two nn.RNN(OptimizedLSTMCell) as LSTMs (their `cell`
    gates stacked), every other module (ResNet34 included) by name."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd = named_from_flax({k: v for k, v in p.items() if k not in _OTS_LSTMS}, s)
    for name in _OTS_LSTMS:
        sd.update(_lstm_from_flax(p[name]["cell"], name))
    return sd


def ots_vad_to_flax(state_dict: Dict[str, torch.Tensor], num_heads: int) -> dict:
    """OTSVADModel state_dict → JAX variables as numpy; the inverse of `ots_vad_from_flax`."""
    out = _split_to_flax({n: t for n, t in state_dict.items() if n.split(".")[0] not in _OTS_LSTMS}, num_heads, ())
    for name, t in state_dict.items():
        parts = name.split(".")
        if parts[0] in _OTS_LSTMS:
            _lstm_to_flax(out["params"], (parts[0], "cell"), parts[1], parts[-1], t.detach().cpu().float().numpy())
    return out


# ---------------------------------------------------------------------------
# NeuralVAD, MaskDenoiser
# ---------------------------------------------------------------------------


def _named_only_params(state_dict: Dict[str, torch.Tensor]) -> dict:
    return {"params": named_to_flax(state_dict)["params"]}


def vad_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX NeuralVAD variables ({'params'}) → NeuralVAD state_dict."""
    p = variables["params"]
    sd = named_from_flax({k: v for k, v in p.items() if k != "lstm"}, {})
    sd.update(_lstm_from_flax(p["lstm"], "lstm"))
    return sd


def vad_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """NeuralVAD state_dict → JAX variables as numpy; the inverse of `vad_from_flax`."""
    out = _named_only_params({n: t for n, t in state_dict.items() if not n.startswith("lstm.")})
    for name, t in state_dict.items():
        parts = name.split(".")
        if parts[0] == "lstm":
            _lstm_to_flax(out["params"], ("lstm",), parts[1], parts[2], t.detach().cpu().float().numpy())
    return out


def enhancer_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX MaskDenoiser variables ({'params'}) → MaskDenoiser state_dict."""
    return named_from_flax(variables["params"])


def enhancer_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """MaskDenoiser state_dict → JAX variables as numpy; the inverse of `enhancer_from_flax`."""
    return _named_only_params(state_dict)
