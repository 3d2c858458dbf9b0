"""Fused inference path for the CAM++ encoder.

Counterpart of speaker_diarization_tpu/kernels/cam_block_fused.py: the same
math as `CAMPPlus(mode='frames')` in eval mode, restated around one kernel
launch per dense block:

  * inference BatchNorm folded to per-channel (scale, bias);
  * each dense block's per-layer weights stacked and zero-padded to c_max
    (`prepare_block_params`), so the plain twin runs every layer's 1x1
    projection as one (B·T, c_max) x (c_max, 128) matmul; the CUDA kernel
    reads only each layer's live channels;
  * the standard FCM head (80 fbank bins, a 32-channel conv1) in one K4
    launch (kernels/fcm.py), any other head as plain convolutions;
  * the TDNN and the transits as plain convolutions/matmuls.

A CUDA tensor runs the FCM head through the K4 kernel and each dense block
through the K2 kernel (kernels/cam_block.py); a CPU tensor through their
plain twins.

The folded and stacked parameters depend only on the weights, so they are
prepared once per (weights, compute dtype) and cached on the model; the
cache key holds each parameter's storage pointer and version counter, so
loading or editing weights invalidates it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as Fn

from .cam_block import cam_dense_block_cuda, cam_dense_block_infer  # noqa: F401  (twin re-exported)
from .fcm import fcm_cuda, prepare_fcm_params


@torch.no_grad()
def _fold_bn(bn, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """BatchNorm (eval) → per-channel fp32 (scale, bias)."""
    mean, var = bn.running_mean.float(), bn.running_var.float()
    inv = 1.0 / torch.sqrt(var + eps)
    scale = (bn.weight.float() if bn.weight is not None else torch.ones_like(mean)) * inv
    bias = (bn.bias.float() if bn.bias is not None else torch.zeros_like(mean)) - mean * scale
    return scale, bias


@torch.no_grad()
def prepare_block_params(block, c_in0: int, c_max: int, dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Stack one dense block's per-layer weights, padded to c_max.

    Channel positions beyond each layer's true input width get scale=0 /
    bias=0 / W=0, so full-width matmuls reproduce the concat-prefix
    computation exactly. Scales and biases are fp32; the matrices
    (W1, K, Wc1, Wc2) are in `dtype`.
    """
    layers = list(block)
    growth = (c_max - c_in0) // len(layers)
    out: Dict[str, list] = {k: [] for k in ("s1", "b1", "W1", "s2", "b2", "K", "Wc1", "bc1", "Wc2", "bc2")}
    for i, lyr in enumerate(layers):
        pad = c_max - (c_in0 + i * growth)
        s1, b1 = _fold_bn(lyr.nonlinear1.batchnorm)
        out["s1"].append(Fn.pad(s1, (0, pad)))
        out["b1"].append(Fn.pad(b1, (0, pad)))
        out["W1"].append(Fn.pad(lyr.linear1.weight[:, :, 0].float().T, (0, 0, 0, pad)))  # (c_max, bn)
        s2, b2 = _fold_bn(lyr.nonlinear2.batchnorm)
        out["s2"].append(s2)
        out["b2"].append(b2)
        cam = lyr.cam_layer
        out["K"].append(cam.linear_local.weight.float().permute(2, 1, 0))  # (3, bn, growth)
        out["Wc1"].append(cam.linear1.weight[:, :, 0].float().T)  # (bn, bn//2)
        out["bc1"].append(cam.linear1.bias.float())
        out["Wc2"].append(cam.linear2.weight[:, :, 0].float().T)  # (bn//2, growth)
        out["bc2"].append(cam.linear2.bias.float())
    bp = {k: torch.stack(v) for k, v in out.items()}
    for k in ("W1", "K", "Wc1", "Wc2"):
        bp[k] = bp[k].to(dtype).contiguous()
    return bp


# ---------------------------------------------------------------------------
# Plain-tensor inference equivalents of the FCM head, TDNN and transits
# ---------------------------------------------------------------------------


def _bn_infer(x, sb, relu=True, dim=-1):
    """Folded BN in x.dtype (scale/bias cast first, as the JAX path does)."""
    scale, bias = (t.to(x.dtype) for t in sb)
    if dim != -1:
        shape = [1] * x.dim()
        shape[dim] = -1
        scale, bias = scale.reshape(shape), bias.reshape(shape)
    y = x * scale + bias
    return torch.relu(y) if relu else y


def _basic_res_block(x, blk, fp, stride):
    h = Fn.conv2d(x, fp[blk + ".conv1"], stride=(stride, 1), padding=1)
    h = _bn_infer(h, fp[blk + ".bn1"], dim=1)
    h = Fn.conv2d(h, fp[blk + ".conv2"], padding=1)
    h = _bn_infer(h, fp[blk + ".bn2"], relu=False, dim=1)
    if blk + ".shortcut.0" in fp:
        sc = Fn.conv2d(x, fp[blk + ".shortcut.0"], stride=(stride, 1))
        sc = _bn_infer(sc, fp[blk + ".shortcut.1"], relu=False, dim=1)
    else:
        sc = x
    return torch.relu(h + sc)


def _fcm_infer(fbank, head, fp):
    """(B, T, F) → (B, T, C·F/8), channels-last like the JAX path."""
    B, T, _ = fbank.shape
    h = fbank.transpose(1, 2).unsqueeze(1)  # (B, 1, F, T)
    h = Fn.conv2d(h, fp["head.conv1"], padding=1)
    h = _bn_infer(h, fp["head.bn1"], dim=1)
    for name in ("layer1", "layer2"):
        for i in range(len(getattr(head, name))):
            h = _basic_res_block(h, f"head.{name}.{i}", fp, 2 if i == 0 else 1)
    h = Fn.conv2d(h, fp["head.conv2"], stride=(2, 1), padding=1)
    h = _bn_infer(h, fp["head.bn2"], dim=1)
    return h.reshape(B, -1, T).transpose(1, 2)  # C-major, F-minor


def _fcm_auto(fbank, head, fp, dtype):
    """The FCM head: the K4 kernel for a CUDA tensor (its plain twin for a
    CPU tensor) on the standard head (80 bins in, a (3, 3) conv1 from 1 to
    32 channels); `_fcm_infer` on any other head, as the JAX _fcm_auto does."""
    if fbank.shape[-1] == 80 and tuple(head.conv1.weight.shape) == (32, 1, 3, 3):
        return fcm_cuda(fbank.to(dtype), fp["head.fcm"])
    return _fcm_infer(fbank, head, fp)


def _tdnn_infer(x, fp, stride=2, dilation=1, kernel=5):
    pad = (kernel - 1) // 2 * dilation
    h = Fn.conv1d(x.transpose(1, 2), fp["xvector.tdnn.linear"], stride=stride, padding=pad, dilation=dilation)
    return _bn_infer(h.transpose(1, 2), fp["xvector.tdnn.nonlinear.batchnorm"])


def _transit_infer(x, name, fp):
    h = _bn_infer(x, fp[f"xvector.{name}.nonlinear.batchnorm"])
    return torch.matmul(h, fp[f"xvector.{name}.linear"])


def _dense_block_auto(h, bp, dil, dtype):
    """The K2 kernel for a CUDA tensor, its plain twin for a CPU tensor."""
    return cam_dense_block_cuda(h.to(dtype), bp, dil)


def fused_params(model, dtype: torch.dtype) -> Dict[str, object]:
    """Folded BN (scale, bias) and dtype-cast weights by module name, the
    K4 head parameters ("head.fcm") and the stacked dense-block parameters;
    cached on the model."""
    tensors = list(model.parameters()) + list(model.buffers())
    key = (dtype, tuple((t.data_ptr(), t._version) for t in tensors))
    cached = getattr(model, "_fused_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    from ..models.layers import BatchNorm

    fp: Dict[str, object] = {}
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, BatchNorm):
                fp[name] = _fold_bn(mod)
            elif name.startswith("head") and isinstance(mod, torch.nn.Conv2d):
                fp[name] = mod.weight.to(dtype)
        fp["head.fcm"] = prepare_fcm_params(model.head, dtype)
        fp["xvector.tdnn.linear"] = model.xvector.tdnn.linear.weight.to(dtype)
        channels = model.init_channels
        for i, num_layers in enumerate(model.block_layers):
            c_max = channels + num_layers * model.growth_rate
            fp[f"block{i + 1}"] = prepare_block_params(getattr(model.xvector, f"block{i + 1}"), channels, c_max, dtype)
            channels = c_max // 2
            w = getattr(model.xvector, f"transit{i + 1}").linear.weight
            fp[f"xvector.transit{i + 1}.linear"] = w[:, :, 0].T.to(dtype).contiguous()
    model._fused_cache = (key, fp)
    return fp


def campplus_frames_fused(model, fbank: torch.Tensor) -> torch.Tensor:
    """Full CAM++ 'frames' forward with fused dense blocks.

    model: a CAMPPlus (eval weights); fbank (B, T, F) in the compute dtype.
    Returns (B, ceil(T/2), 512) in the compute dtype. Module-free: the FCM
    head through `_fcm_auto` (one K4 launch on CUDA), TDNN and transits as
    convolutions/matmuls, the three dense blocks through `_dense_block_auto`
    (one K2 launch each on CUDA).
    """
    dt = fbank.dtype
    fp = fused_params(model, dt)
    h = _fcm_auto(fbank, model.head, fp, dt)
    h = _tdnn_infer(h, fp)
    for i, dil in enumerate(model.block_dilations):
        h = _dense_block_auto(h, fp[f"block{i + 1}"], dil, dt)
        h = _transit_infer(h, f"transit{i + 1}", fp)
    return _bn_infer(h, fp["xvector.out_nonlinear.batchnorm"])
