"""K4: the CAM++ FCM head kernel (csrc/fcm.cu) and its plain twin.

Replaces speaker_diarization_tpu/kernels/fcm_pallas.py (`_fcm_kernel`
through `fcm_pallas`). Both functions take the flat parameter list of
`prepare_fcm_params`, in the order of the JAX `prepare_fcm_params`: twelve
conv units (conv1; per BasicResBlock conv1 and conv2, then the 1x1 shortcut
of a stride-2 block; conv2), each as

    W  (3·Cin, 3·Cout) in the compute dtype, tap-folded: W[(df, ci), (dt, co)]
       (a shortcut: (Cin, Cout))
    sb (2, 32) fp32: folded-BN scale and bias

`fcm_folded_torch` is the plain PyTorch twin of the JAX `fcm_xla_folded`
(same rounding to the compute dtype, fp32 products and sums); `fcm_cuda`
launches the kernel for a CUDA tensor and runs the twin for a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import torch
import torch.nn.functional as Fn

CHANNELS, N_BINS, N_UNITS = 32, 80, 12  # the kernel's fixed FCM widths
OUT_DIM = CHANNELS * N_BINS // 8  # 320: (B, T, 32 channels x 10 bins), channel-major
# the kernel's time tiling: a block owns a window of WINDOW frames, of which
# the middle WINDOW - 2·HALO are its output (one halo frame per time-tapped
# conv); chip_smoke.py holds them to the kernel's sdt_fcm_window/sdt_fcm_halo
HALO = 10
WINDOW = {torch.bfloat16: 256, torch.float32: 128}


@torch.no_grad()
def prepare_fcm_params(head, dtype: torch.dtype = torch.bfloat16) -> List[torch.Tensor]:
    """The port's FCM module → [W, sb] x 12 units (the JAX prepare_fcm_params).

    A torch Conv2d weight is (Cout, Cin, kF, kT); the flax kernel is (kF, kT,
    Cin, Cout), so W[(df, ci), (dt, co)] = weight[co, ci, df, dt].
    """
    from .cam_block_fused import _fold_bn

    out: List[torch.Tensor] = []

    def push(w, bn):
        s, b = _fold_bn(bn)
        out.append(w.to(dtype).contiguous())
        out.append(torch.stack([s, b]).float().contiguous())

    def wide(conv):
        w = conv.weight.float()
        co, ci = w.shape[:2]
        return w.permute(2, 1, 3, 0).reshape(3 * ci, 3 * co)

    push(wide(head.conv1), head.bn1)
    for layer in (head.layer1, head.layer2):
        for blk in layer:
            push(wide(blk.conv1), blk.bn1)
            push(wide(blk.conv2), blk.bn2)
            if len(blk.shortcut):
                push(blk.shortcut[0].weight[:, :, 0, 0].float().T, blk.shortcut[1])
    push(wide(head.conv2), head.bn2)
    return out


# ---------------------------------------------------------------------------
# The plain twin: fcm_xla_folded in PyTorch
# ---------------------------------------------------------------------------


def _tshift(a: torch.Tensor, d: int) -> torch.Tensor:
    """Zero-filled shift along time (dim 2 of (B, F, T, C)): out[t] = a[t - d]."""
    T = a.shape[2]
    if d > 0:
        return Fn.pad(a, (0, 0, d, 0))[:, :, :T]
    return Fn.pad(a, (0, 0, 0, -d))[:, :, -d:]


def _mm(a: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """dtype operands, fp32 products and sums."""
    return torch.matmul(a.to(dtype).float(), w.to(dtype).float())


def _taps(ow: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """(…, 3·C) per-time-tap products → the conv output, BN folded (fp32)."""
    co = ow.shape[-1] // 3
    out = _tshift(ow[..., :co], 1) + ow[..., co : 2 * co] + _tshift(ow[..., 2 * co :], -1)
    return out * sb[0] + sb[1]


def _conv3x3_folded(x, w, sb, stride, dtype, relu=True):
    """x (B, F, T, C) → (B, F/stride, T, Cout); the JAX _conv3x3_folded."""
    B, F, T, C = x.shape
    if stride == 1:
        rows = [Fn.pad(x, (0, 0, 0, 0, 1, 0))[:, :F], x, Fn.pad(x, (0, 0, 0, 0, 0, 1))[:, 1:]]
    else:
        Fo = F // 2
        x2 = x.reshape(B, Fo, 2, T, C)
        even, odd = x2[:, :, 0], x2[:, :, 1]
        rows = [Fn.pad(odd, (0, 0, 0, 0, 1, 0))[:, :Fo], even, odd]  # x[2f-1], x[2f], x[2f+1]
    out = _taps(_mm(torch.cat([r.to(dtype) for r in rows], dim=-1), w, dtype), sb)
    return (torch.relu(out) if relu else out).to(dtype)


def fcm_folded_torch(fbank: torch.Tensor, flat_params, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """fbank (B, T, 80) → (B, T, 320) in `dtype`; the tap-folded FCM head in
    plain PyTorch, matching the flax FCM module (exact up to sum order in fp32)."""
    w = list(flat_params)
    B, T, n_bins = fbank.shape
    if n_bins != N_BINS:
        raise ValueError(f"the FCM head kernel takes {N_BINS} fbank bins, got {n_bins}")
    x0 = fbank.float().transpose(1, 2)  # (B, 80, T)
    xm = Fn.pad(x0, (0, 0, 1, 0))[:, :N_BINS]
    xp = Fn.pad(x0, (0, 0, 0, 1))[:, 1:]
    X3 = torch.stack([xm, x0, xp], dim=-1).to(dtype)  # (B, 80, T, 3)
    h = torch.relu(_taps(_mm(X3, w[0], dtype), w[1])).to(dtype)  # (B, 80, T, 32)
    F, i = N_BINS, 2
    for stride in (2, 1, 2, 1):
        Fo = F // stride
        h1 = _conv3x3_folded(h, w[i], w[i + 1], stride, dtype, relu=True)
        if stride == 2:
            sc = _mm(h.reshape(B, Fo, 2, T, h.shape[-1])[:, :, 0], w[i + 4], dtype)
            sc = sc * w[i + 5][0] + w[i + 5][1]
        else:
            sc = h[:, :Fo].float()
        h2 = _conv3x3_folded(h1, w[i + 2], w[i + 3], 1, dtype, relu=False)
        i += 6 if stride == 2 else 4
        h = torch.relu(h2.float() + sc).to(dtype)
        F = Fo
    h = _conv3x3_folded(h, w[i], w[i + 1], 2, dtype, relu=True)  # (B, 10, T, 32)
    return h.permute(0, 2, 3, 1).reshape(B, T, OUT_DIM)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def _lib():
    from ._build import load

    lib = load("fcm")
    if not getattr(lib, "_sdt_typed", False):
        P, I, PP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)
        lib.sdt_fcm_scratch_elems.restype = ctypes.c_size_t
        lib.sdt_fcm_scratch_elems.argtypes = [I, I, I]
        lib.sdt_fcm_window.restype = I
        lib.sdt_fcm_window.argtypes = [I]
        lib.sdt_fcm_halo.restype = I
        lib.sdt_fcm_halo.argtypes = []
        for fn in (lib.sdt_fcm_f32, lib.sdt_fcm_bf16):
            fn.restype = I
            fn.argtypes = [P, P, PP, PP, P, I, I, P]
        lib._sdt_typed = True
    return lib


def fcm_cuda(fbank: torch.Tensor, flat_params) -> torch.Tensor:
    """The whole FCM head in one kernel launch, computed in fbank.dtype:
    (B, T, 80) → (B, T, 320), channel-major.

    A CPU tensor runs `fcm_folded_torch`; a CUDA tensor launches the kernel
    or raises. Counts its launches in `fcm_cuda.launches`.
    """
    if not fbank.is_cuda:
        return fcm_folded_torch(fbank, flat_params, dtype=fbank.dtype)
    if fbank.dim() != 3 or fbank.shape[-1] != N_BINS or fbank.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fcm_cuda wants (B, T, 80) float32/bfloat16, got {tuple(fbank.shape)} {fbank.dtype}")
    if len(flat_params) != 2 * N_UNITS:
        raise ValueError(f"fcm_cuda wants the {N_UNITS} units of prepare_fcm_params, got {len(flat_params)} arrays")
    shapes = [tuple(t.shape) for t in flat_params[0::2]]
    want = [(3, 3 * CHANNELS)] + [(3 * CHANNELS, 3 * CHANNELS)] * 10 + [(3 * CHANNELS, 3 * CHANNELS)]
    for u in (3, 8):
        want[u] = (CHANNELS, CHANNELS)
    if shapes != want or any(tuple(t.shape) != (2, CHANNELS) for t in flat_params[1::2]):
        raise ValueError(f"fcm_cuda supports the 32-channel CAM++ head only, got weights {shapes}")
    dev, dt = fbank.device, fbank.dtype
    ws = [t.to(device=dev, dtype=dt).contiguous() for t in flat_params[0::2]]
    sbs = [t.to(device=dev, dtype=torch.float32).contiguous() for t in flat_params[1::2]]
    x = fbank.contiguous()
    B, T, _ = x.shape
    out = torch.empty((B, T, OUT_DIM), dtype=dt, device=dev)
    if B == 0 or T == 0:
        return out
    lib = _lib()
    from ._build import check

    scratch = torch.empty(lib.sdt_fcm_scratch_elems(B, T, int(dt == torch.bfloat16)), dtype=dt, device=dev)
    w_ptrs = (ctypes.c_void_p * N_UNITS)(*[t.data_ptr() for t in ws])
    sb_ptrs = (ctypes.c_void_p * N_UNITS)(*[t.data_ptr() for t in sbs])
    fn = lib.sdt_fcm_bf16 if dt == torch.bfloat16 else lib.sdt_fcm_f32
    code = fn(x.data_ptr(), out.data_ptr(), w_ptrs, sb_ptrs, scratch.data_ptr(), B, T,
              torch.cuda.current_stream(dev).cuda_stream)
    check(lib, code, "fcm_cuda")
    fcm_cuda.launches += 1
    return out


fcm_cuda.launches = 0


def fcm_work(B: int, T: int, elem_bytes: int = 2) -> Dict[str, float]:
    """Bytes the head must move and the operations it needs.

    Operations: the MACs of the twelve conv units (2,388,480 per frame per
    item: conv1 at 80 bins, eight 3x3 convs and a 1x1 shortcut at 40 and 20
    bins, conv2 at 10 output bins), twice, plus the folded BN, ReLU and
    residual work per output. Bytes: the fbank read once, the (B, T, 320)
    output written once, and the weights read once.
    """
    c = CHANNELS
    k3 = 9 * c * c
    macs = N_BINS * 9 * c + 40 * (4 * k3 + c * c) + 20 * (4 * k3 + c * c) + 10 * k3
    outs = N_BINS * c + 40 * 5 * c + 20 * 5 * c + 10 * c  # unit outputs per frame
    flops = B * T * (2.0 * macs + 4.0 * outs)
    wbytes = elem_bytes * (9 * c + 8 * k3 + 2 * c * c + k3) + 4.0 * N_UNITS * 2 * c
    return dict(bytes=elem_bytes * B * T * (N_BINS + OUT_DIM) + wbytes, flops=flops)
