"""K2: the CAM++ dense-block kernel (csrc/cam_block.cu) and its plain twin.

Replaces speaker_diarization_tpu/kernels/cam_block_pallas.py
(`_block_kernel` through `cam_dense_block_pallas`). Both functions take the
block parameters stacked by `cam_block_fused.prepare_block_params`:

    s1, b1 (L, c_max) f32 | W1 (L, c_max, 128) | s2, b2 (L, 128) f32
    K (L, 3, 128, 32) | Wc1 (L, 128, 64) | bc1 (L, 64) f32
    Wc2 (L, 64, 32) | bc2 (L, 32) f32

with x (B, T, c0) and c_max = c0 + 32 L. `cam_dense_block_infer` is the
plain PyTorch twin of the JAX `cam_dense_block_infer` (same rounding to the
compute dtype, fp32 accumulation); `cam_dense_block_cuda` launches the
kernel for a CUDA tensor and runs the twin for a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as Fn

BOTTLENECK, GROWTH, CONTEXT_HIDDEN = 128, 32, 64  # the kernel's fixed CAM++ widths
SEG_FLOATS = 2 * BOTTLENECK + CONTEXT_HIDDEN + GROWTH  # per-segment scratch of the kernel
_WEIGHTS = ("W1", "K", "Wc1", "Wc2")  # in the compute dtype; the rest stay fp32
_ARGS = ("s1", "b1", "W1", "s2", "b2", "K", "Wc1", "bc1", "Wc2", "bc2")


def cam_dense_block_infer(
    x: torch.Tensor,
    bp: Dict[str, torch.Tensor],
    dilation: int,
    seg_len: int = 100,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """x (B, T, C_in) → (B, T, C_in + L·growth), the same math as
    CAMDenseTDNNBlock in eval mode (plain PyTorch)."""
    B, T, c0 = x.shape
    L, c_max = bp["W1"].shape[:2]
    growth = bp["K"].shape[-1]
    d = dilation

    buf = torch.zeros((B, T, c_max), dtype=dtype, device=x.device)
    buf[:, :, :c0] = x.to(dtype)

    n_seg = -(-T // seg_len)
    pad_t = n_seg * seg_len - T
    counts = torch.tensor([min(seg_len, T - s * seg_len) for s in range(n_seg)], dtype=torch.float32, device=x.device)

    def mm(a, w):  # dtype operands, fp32 products and accumulation
        return torch.matmul(a.float(), w.to(dtype).float())

    for i in range(L):
        h = torch.relu(buf * bp["s1"][i].to(dtype) + bp["b1"][i].to(dtype))
        u = mm(h, bp["W1"][i])
        u = torch.relu(u * bp["s2"][i] + bp["b2"][i]).to(dtype)  # (B, T, bn)

        # CAM context: global mean + ceil-mode segment means (seg_pooling)
        uf = u.float()
        segs = Fn.pad(uf, (0, 0, 0, pad_t)).reshape(B, n_seg, seg_len, -1).sum(dim=2)
        segs = segs / counts[None, :, None]
        gmean = uf.mean(dim=1, keepdim=True)
        ctx = (gmean + segs).to(dtype)  # (B, n_seg, bn)
        a = torch.relu(mm(ctx, bp["Wc1"][i]) + bp["bc1"][i]).to(dtype)
        m = torch.sigmoid(mm(a, bp["Wc2"][i]) + bp["bc2"][i])  # (B, n_seg, growth) f32
        m = m.repeat_interleave(seg_len, dim=1)[:, :T]

        # dilated k3 conv as three shifted matmuls
        upad = Fn.pad(u, (0, 0, d, d))
        K = bp["K"][i]
        loc = mm(upad[:, :T], K[0]) + mm(upad[:, d : T + d], K[1]) + mm(upad[:, 2 * d : T + 2 * d], K[2])
        buf[:, :, c0 + i * growth : c0 + (i + 1) * growth] = (loc * m).to(dtype)
    return buf


def _lib():
    from ._build import load

    lib = load("cam_block")
    if not getattr(lib, "_sdt_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.sdt_cam_block_smem_bytes.restype = ctypes.c_size_t
        lib.sdt_cam_block_smem_bytes.argtypes = [I, I, I, I]
        for fn in (lib.sdt_cam_block_f32, lib.sdt_cam_block_bf16):
            fn.restype = I
            fn.argtypes = [P] * 14 + [I] * 7 + [P]
        lib._sdt_typed = True
    return lib


def u_in_global(T: int, dtype: torch.dtype, seg_len: int = 100) -> bool:
    """Whether the kernel keeps u (T, 128) in a global scratch at this T:
    it does once u no longer fits shared memory (fp32 T > 290, bf16 T > 656)."""
    from ._build import SMEM_LIMIT

    return _lib().sdt_cam_block_smem_bytes(T, seg_len, int(dtype == torch.bfloat16), 0) > SMEM_LIMIT


def cam_dense_block_cuda(
    x: torch.Tensor, bp: Dict[str, torch.Tensor], dilation: int, seg_len: int = 100
) -> torch.Tensor:
    """One whole dense block in one kernel launch, computed in x.dtype.

    A CPU tensor runs `cam_dense_block_infer`; a CUDA tensor launches the
    kernel or raises. Counts its launches in `cam_dense_block_cuda.launches`.
    """
    if not x.is_cuda:
        return cam_dense_block_infer(x, bp, dilation, seg_len, dtype=x.dtype)
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cam_dense_block_cuda wants (B, T, C) float32/bfloat16, got {tuple(x.shape)} {x.dtype}")
    B, T, c0 = x.shape
    L, c_max, bn = bp["W1"].shape
    if (bn, bp["K"].shape[-1], bp["Wc1"].shape[-1]) != (BOTTLENECK, GROWTH, CONTEXT_HIDDEN):
        raise ValueError("cam_dense_block_cuda supports bottleneck 128, growth 32, context hidden 64 only")
    if c0 + GROWTH * L != c_max:
        raise ValueError(f"input width {c0} + 32·{L} layers != buffer width {c_max}")
    args = []
    for k in _ARGS:
        t = bp[k].to(device=x.device, dtype=x.dtype if k in _WEIGHTS else torch.float32).contiguous()
        args.append(t)
    x = x.contiguous()
    out = torch.empty((B, T, c_max), dtype=x.dtype, device=x.device)
    if B == 0 or T == 0:
        return out
    lib = _lib()
    from ._build import check

    scratch = []  # u and the per-segment context, when u does not fit shared memory
    if u_in_global(T, x.dtype, seg_len):
        n_seg = -(-T // seg_len)
        scratch = [
            torch.empty((B, T, BOTTLENECK), dtype=x.dtype, device=x.device),
            torch.empty((B, n_seg, SEG_FLOATS), dtype=torch.float32, device=x.device),
        ]
    scratch_ptrs = [t.data_ptr() for t in scratch] or [None, None]
    fn = lib.sdt_cam_block_bf16 if x.dtype == torch.bfloat16 else lib.sdt_cam_block_f32
    code = fn(
        x.data_ptr(), out.data_ptr(), *[a.data_ptr() for a in args], *scratch_ptrs,
        B, T, c0, c_max, L, dilation, seg_len, torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(lib, code, "cam_dense_block_cuda")
    cam_dense_block_cuda.launches += 1
    return out


cam_dense_block_cuda.launches = 0


def cam_block_work(B: int, T: int, c0: int, L: int, seg_len: int = 100, elem_bytes: int = 2) -> Dict[str, float]:
    """Bytes the block must move and the operations it needs.

    Operations count the live channels only (layer i reads c0 + 32 i):
    the 1x1 projection, the three k=3 products, the context MLP, and the
    element-wise BN/ReLU, mask and sigmoid work. Bytes: x read once, the
    (B, T, c0 + 32 L) output written once, and the live weights read once.
    """
    n_seg = -(-T // seg_len)
    flops = 0.0
    wbytes = 0.0
    for i in range(L):
        c_in = c0 + GROWTH * i
        flops += 2.0 * B * T * (c_in * BOTTLENECK + 3 * BOTTLENECK * GROWTH)
        flops += 2.0 * B * n_seg * (BOTTLENECK * CONTEXT_HIDDEN + CONTEXT_HIDDEN * GROWTH)
        flops += B * T * (3.0 * c_in + 3.0 * BOTTLENECK + 2.0 * GROWTH) + B * n_seg * 4.0 * GROWTH
        wbytes += elem_bytes * (c_in * BOTTLENECK + 3 * BOTTLENECK * GROWTH + BOTTLENECK * CONTEXT_HIDDEN + CONTEXT_HIDDEN * GROWTH)
        wbytes += 4.0 * (2 * c_in + 2 * BOTTLENECK + CONTEXT_HIDDEN + GROWTH)
    io = elem_bytes * B * T * (c0 + c0 + GROWTH * L)
    return dict(bytes=io + wbytes, flops=flops)
