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

`load_encoder_npz` reads the JAX `export-encoder` npz (models/spk_embed.py
`save_encoder`: "/"-joined variable paths and a JSON `__cfg__`).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterator, Tuple

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


def save_flax_npz(path: str, variables: dict) -> None:
    """Write flax variables ({'params': ..., 'batch_stats': ...}) as one npz."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = {"/".join(p): np.asarray(v) for p, v in _flatten(variables)}
    np.savez(path, **flat)


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
        base = f"{prefix}.{layer}"
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


def _mamba_to_flax(parts: list, w: np.ndarray) -> Tuple[Tuple[str, ...], np.ndarray]:
    """Inverse of `_mamba_backend_from_flax` for one tensor: parts are the
    state-dict name below the backend ([module, ..., leaf])."""
    mod, leaf = parts[0], parts[-1]
    if mod.startswith("norm_"):
        return (mod, "scale" if leaf == "weight" else "bias"), w
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


def _conv_bn_from_flax(params: dict, stats: dict, prefix: str) -> Dict[str, torch.Tensor]:
    sd = {
        f"{prefix}.conv.weight": _kernel(params["conv"]["kernel"]),
        f"{prefix}.conv.bias": params["conv"]["bias"],
        f"{prefix}.bn.weight": params["bn"]["scale"],
        f"{prefix}.bn.bias": params["bn"]["bias"],
        f"{prefix}.bn.running_mean": stats["bn"]["mean"],
        f"{prefix}.bn.running_var": stats["bn"]["var"],
    }
    out = {k: _t(v) for k, v in sd.items()}
    out[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return out


def tsvad_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX TSVADModel variables ({'params', 'batch_stats'}, arrays) →
    this package's TSVADModel state_dict (CAM++ encoder, transformer or
    BiMamba backends)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    enc = campplus_from_flax(p["speech_encoder"], s["speech_encoder"])
    sd.update({f"speech_encoder.{k}": v for k, v in enc.items()})
    sd.update(_conv_bn_from_flax(p["speech_down"], s["speech_down"], "speech_down"))
    sd.update(_conv_bn_from_flax(p["backend_down"], s["backend_down"], "backend_down"))
    if "proj_layer" in p:
        sd["proj_layer.weight"] = _t(p["proj_layer"]["kernel"].T)
        sd["proj_layer.bias"] = _t(p["proj_layer"]["bias"])
    for name in ("single_backend", "multi_backend"):
        backend = _mamba_backend_from_flax if "norm_out" in p[name] else _backend_from_flax
        sd.update(backend(p[name], name))
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


def tsvad_to_flax(state_dict: Dict[str, torch.Tensor], num_heads: int) -> dict:
    """This package's TSVADModel state_dict → JAX variables as numpy
    ({'params', 'batch_stats'}); the inverse of `tsvad_from_flax`, so
    weights made here can be written with `save_flax_npz`."""
    out = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        if name.endswith("num_batches_tracked"):
            continue
        w = t.detach().cpu().float().numpy()
        parts = name.split(".")
        top, leaf = parts[0], parts[-1]
        if top == "speech_encoder":
            coll, path, w = _campplus_to_flax(parts[1:-1], leaf, w)
            _put(out[coll], ("speech_encoder", *path), w)
        elif top in ("speech_down", "backend_down"):
            if parts[1] == "conv":
                _put(out["params"], (top, "conv", "kernel" if leaf == "weight" else "bias"),
                     w.transpose(2, 1, 0) if leaf == "weight" else w)
            else:
                coll, n = _BN_LEAF_INV[leaf]
                _put(out[coll], (top, "bn", n), w)
        elif top in ("fc", "proj_layer"):
            _put(out["params"], (top, "kernel" if leaf == "weight" else "bias"), w.T if leaf == "weight" else w)
        elif not parts[1].startswith("layer_"):  # a BiMamba backend
            path, w = _mamba_to_flax(parts[1:], w)
            _put(out["params"], (top, *path), w)
        elif parts[2] == "attn":  # {single,multi}_backend.layer_i.attn.<n>.<leaf>
            att, n = (top, parts[1], "MultiHeadDotProductAttention_0", parts[3]), parts[3]
            if leaf == "bias":
                _put(out["params"], (*att, "bias"), w if n == "out" else w.reshape(num_heads, -1))
            elif n == "out":  # (D, H·Dh) → (H, Dh, D)
                _put(out["params"], (*att, "kernel"), w.T.reshape(num_heads, -1, w.shape[0]))
            else:  # (H·Dh, D) → (D, H, Dh)
                _put(out["params"], (*att, "kernel"), w.T.reshape(w.shape[1], num_heads, -1))
        elif parts[2] in ("ln1", "ln2"):
            ln = "LayerNorm_0" if parts[2] == "ln1" else "LayerNorm_1"
            _put(out["params"], (top, parts[1], ln, "scale" if leaf == "weight" else "bias"), w)
        else:  # feed-forward: layer_i.ff.dense{0,1}.<leaf>
            dense = ("FeedForward_0", "Dense_" + parts[3][-1])
            _put(out["params"], (top, parts[1], *dense, "kernel" if leaf == "weight" else "bias"),
                 w.T if leaf == "weight" else w)
    return out
