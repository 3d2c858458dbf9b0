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
from typing import Dict, NamedTuple

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
        lib.sdt_cam_block_smem_bytes.argtypes = [I, I, I]
        lib.sdt_cam_block_tc_smem_bytes.restype = ctypes.c_size_t
        lib.sdt_cam_block_tc_smem_bytes.argtypes = [I, I, I]
        lib.sdt_cam_block_f32.restype = I
        lib.sdt_cam_block_f32.argtypes = [P] * 14 + [I] * 7 + [P]
        lib.sdt_cam_block_bf16.restype = I
        lib.sdt_cam_block_bf16.argtypes = [P] * 13 + [I] * 11 + [P]
        lib._sdt_typed = True
    return lib


# ---------------------------------------------------------------------------
# Shared-memory sizes and the bf16 kernel's cluster plan (mirrors of the
# kernel's own layout functions, so that the CPU tests reach them)
# ---------------------------------------------------------------------------

N_SM = 132  # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 8  # the largest portable thread-block cluster
MIN_FRAMES = 16  # fewest frames a CTA of the bf16 kernel owns
_TC_MT, _TC_KT, _TC_STAGES = 128, 64, 3  # projection rows per chunk, depth per stage, ring depth


def _align16(n: int) -> int:
    return (n + 15) & ~15


def smem_bytes_f32(T: int, seg_len: int = 100, u_global: bool = False) -> int:
    """Shared memory of the fp32 kernel (cam_block.cu `smem_bytes<float>`)."""
    n = _align16(BOTTLENECK * 4) + 4 * 104 * 32 + 4 * 32 * BOTTLENECK + _align16(3 * BOTTLENECK * GROWTH * 4)
    if not u_global:
        n += _align16(T * BOTTLENECK * 4) + 4 * (-(-T // seg_len)) * SEG_FLOATS
    return n


def smem_bytes_bf16(c_max: int, u_rows: int, nls: int) -> int:
    """Shared memory of one CTA of the bf16 kernel (cam_block.cu `k2tc::layout`)."""
    n = _TC_STAGES * _TC_MT * (_TC_KT + 8) * 2 + _TC_STAGES * _TC_KT * (BOTTLENECK + 8) * 2
    n += 3 * BOTTLENECK * (GROWTH + 8) * 2 + _align16(2 * c_max * 2) + _align16(u_rows * (BOTTLENECK + 8) * 2)
    return n + 4 * (2 * nls * BOTTLENECK + 6 * BOTTLENECK + nls * (CONTEXT_HIDDEN + GROWTH))


class LaunchPlan(NamedTuple):
    """How the bf16 kernel splits a (B, T) block: `cl` CTAs per batch item
    (one thread-block cluster), CTA r owning frames [r·tc, min(T, (r+1)·tc));
    `nls` the most segments one CTA's frames touch; `u_rows` the rows of u in
    a CTA's shared memory; `u_global` whether u lives in the global scratch."""

    cl: int
    tc: int
    nls: int
    u_rows: int
    u_global: bool
    smem: int

    def ranges(self, T: int):
        return [(r * self.tc, min(T, (r + 1) * self.tc)) for r in range(self.cl)]


def launch_plan(B: int, T: int, dilation: int, c_max: int, seg_len: int = 100) -> LaunchPlan:
    """The cluster size and frame ranges of the bf16 kernel at (B, T).

    cl is the largest size up to 8 with B·cl CTAs in one wave on N_SM SMs
    (one CTA per SM) and at least MIN_FRAMES (and dilation) frames per CTA,
    then cut while a CTA would own no frame: B = 64, T = 199 gives cl = 2,
    128 CTAs of 100 and 99 frames. u stays in shared memory unless the CTA's
    frames with their halos do not fit there; where even the global-scratch
    instance's segment arrays do not fit (windows of minutes), cl grows.
    """
    from ._build import SMEM_LIMIT

    cl = max(1, min(MAX_CLUSTER, N_SM // max(B, 1), T // max(MIN_FRAMES, dilation)))
    while True:
        tc = -(-T // cl)
        while cl > 1 and (cl - 1) * tc >= T:
            cl -= 1
            tc = -(-T // cl)
        nls = max((min(T, (r + 1) * tc) - 1) // seg_len - r * tc // seg_len + 1 for r in range(cl))
        u_rows = -(-tc // 16) * 16 + 2 * dilation
        smem = smem_bytes_bf16(c_max, u_rows, nls)
        u_global = smem > SMEM_LIMIT
        if u_global:
            u_rows = _TC_MT + 2 * dilation
            smem = smem_bytes_bf16(c_max, u_rows, nls)
        if smem <= SMEM_LIMIT:
            return LaunchPlan(cl, tc, nls, u_rows, u_global, smem)
        if cl >= MAX_CLUSTER or T // (cl + 1) < max(MIN_FRAMES, dilation):
            raise ValueError(f"cam_dense_block_cuda: no launch plan fits shared memory at T={T}, c_max={c_max}")
        cl += 1


def u_in_global(B: int, T: int, dtype: torch.dtype, dilation: int, c_max: int, seg_len: int = 100) -> bool:
    """Whether the kernel keeps u (T, 128) in a global scratch at this shape:
    fp32 once u no longer fits one block's shared memory (T > 290); bf16 once
    a CTA's share of the frames does not (only where B > 66 leaves one CTA
    per item, at T / cl above ~270)."""
    from ._build import SMEM_LIMIT

    if dtype == torch.bfloat16:
        return launch_plan(B, T, dilation, c_max, seg_len).u_global
    return smem_bytes_f32(T, seg_len) > SMEM_LIMIT


def pad_input_width(bp: Dict[str, torch.Tensor], c0: int, p: int) -> Dict[str, torch.Tensor]:
    """The block's parameters for an input of c0 + p channels whose last p
    are zeros: zero BN scale and bias and zero W1 rows there, so h is 0 on
    them and adds exact zeros to every product."""
    out = dict(bp)
    for k in ("s1", "b1", "W1"):
        t = bp[k]
        out[k] = torch.cat([t[:, :c0], t.new_zeros((t.shape[0], p) + t.shape[2:]), t[:, c0:]], dim=1)
    return out


def cam_dense_block_cuda(
    x: torch.Tensor, bp: Dict[str, torch.Tensor], dilation: int, seg_len: int = 100
) -> torch.Tensor:
    """One whole dense block in one kernel launch, computed in x.dtype.

    A CPU tensor runs `cam_dense_block_infer`; a CUDA tensor launches the
    kernel or raises (a refused cluster launch included). Counts its
    launches in `cam_dense_block_cuda.launches`.
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
    if x.dtype == torch.bfloat16 and c0 % 8:
        # the bf16 kernel copies buffer rows in 16-byte pieces: run it with
        # zero channels after x, then drop them
        p = -c0 % 8
        out = cam_dense_block_cuda(Fn.pad(x, (0, p)), pad_input_width(bp, c0, p), dilation, seg_len)
        return torch.cat([out[..., :c0], out[..., c0 + p :]], dim=-1)
    args = []
    for k in _ARGS:
        t = bp[k].to(device=x.device, dtype=x.dtype if k in _WEIGHTS else torch.float32).contiguous()
        args.append(t)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    out = torch.empty((B, T, c_max), dtype=x.dtype, device=x.device)
    if B == 0 or T == 0:
        return out
    lib = _lib()
    from ._build import check

    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [a.data_ptr() for a in args]
    if x.dtype == torch.bfloat16:
        plan = launch_plan(B, T, dilation, c_max, seg_len)
        u_g = torch.empty((B, 2, T, BOTTLENECK), dtype=x.dtype, device=x.device) if plan.u_global else None
        code = lib.sdt_cam_block_bf16(
            x.data_ptr(), out.data_ptr(), *ptrs, None if u_g is None else u_g.data_ptr(),
            B, T, c0, c_max, L, dilation, seg_len, plan.cl, plan.tc, plan.nls, plan.u_rows, stream,
        )
    else:
        scratch = []  # u and the per-segment context, when u does not fit shared memory
        if u_in_global(B, T, x.dtype, dilation, c_max, seg_len):
            n_seg = -(-T // seg_len)
            scratch = [
                torch.empty((B, T, BOTTLENECK), dtype=x.dtype, device=x.device),
                torch.empty((B, n_seg, SEG_FLOATS), dtype=torch.float32, device=x.device),
            ]
        scratch_ptrs = [t.data_ptr() for t in scratch] or [None, None]
        code = lib.sdt_cam_block_f32(
            x.data_ptr(), out.data_ptr(), *ptrs, *scratch_ptrs, B, T, c0, c_max, L, dilation, seg_len, stream,
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
