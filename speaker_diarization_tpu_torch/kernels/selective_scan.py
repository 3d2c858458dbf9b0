"""K3a/K3b/K3c: the selective-scan kernels (csrc/selective_scan.cu) and twins.

Replaces speaker_diarization_tpu/kernels/selective_scan_pallas.py:

- K3a `selective_scan_fwd` (`_scan_kernel` / `selective_scan_pallas`): y.
  Plain twin: `ops.mamba_scan.selective_scan_sequential`.
- K3b `selective_scan_fwd_states` (`_scan_kernel_with_states`): y and the
  state at the start of every chunk of CHUNK steps, h0 (B·n_chunks, N, D).
  Plain twin: `selective_scan_states_ref`.
- K3c `selective_scan_bwd` (`_scan_bwd_kernel`): dx, dΔ, dA, dB, dC, dD from
  h0 and dy. Plain twin: `selective_scan_bwd_ref`.

`SelectiveScanFn` is the autograd binding (the JAX `selective_scan_fused`
custom_vjp): K3b in forward, K3c in backward. Every input is fp32 with the
JAX layouts: x, Δ (B, T, D), A (D, N), B, C (B, T, N), D (D,). A wrapper given
CPU tensors runs the twin; given CUDA tensors it launches its kernel or
raises. Each counts its launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ..ops.mamba_scan import selective_scan_sequential

CHUNK = 16  # steps per saved state (kChunk in csrc/selective_scan.cu)
STATE_SIZES = (8, 16, 32, 64)  # the N the kernels are built for
_NAMES = ("x", "delta", "A", "B", "C", "D")


def selective_scan_states_ref(x, delta, A, Bm, C, D, chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K3b: (y, h0) with h0[b·n_chunks + c] the (N, D) state
    before step c·chunk, n_chunks = ceil(T / chunk)."""
    Bsz, T, Dd = x.shape
    h = x.new_zeros((Bsz, Dd, A.shape[1]))
    ys, starts = [], []
    for t in range(T):
        if t % chunk == 0:
            starts.append(h.transpose(1, 2))
        h = torch.exp(delta[:, t, :, None] * A) * h + (delta[:, t] * x[:, t])[:, :, None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    y = torch.stack(ys, dim=1) + x * D
    return y, torch.stack(starts, dim=1).reshape(-1, A.shape[1], Dd)


def selective_scan_bwd_ref(x, delta, A, Bm, C, D, h0, g, chunk: int = CHUNK):
    """Plain twin of K3c: the gradients (dx, dΔ, dA, dB, dC, dD) of
    sum(y · g), walking chunks in reverse and recomputing each chunk's
    states from its saved initial state."""
    Bsz, T, Dd = x.shape
    N = A.shape[1]
    n_chunks = -(-T // chunk)
    starts = h0.reshape(Bsz, n_chunks, N, Dd).transpose(2, 3)  # (B, n_chunks, D, N)
    dx, ddt = torch.zeros_like(x), torch.zeros_like(x)
    dB, dC = torch.zeros_like(Bm), torch.zeros_like(C)
    dA, dD = torch.zeros_like(A), torch.zeros_like(D)
    dh = x.new_zeros((Bsz, Dd, N))
    for c in reversed(range(n_chunks)):
        steps = range(c * chunk, min(T, (c + 1) * chunk))
        h, prev, hs, decays = starts[:, c], [], [], []
        for t in steps:
            a = torch.exp(delta[:, t, :, None] * A)
            prev.append(h)
            h = a * h + (delta[:, t] * x[:, t])[:, :, None] * Bm[:, t, None, :]
            hs.append(h)
            decays.append(a)
        for i in reversed(range(len(hs))):
            t = steps[i]
            gt = g[:, t]
            dh = dh + C[:, t, None, :] * gt[:, :, None]
            dC[:, t] = torch.einsum("bd,bdn->bn", gt, hs[i])
            dB[:, t] = torch.einsum("bdn,bd->bn", dh, delta[:, t] * x[:, t])
            adot = dh * decays[i] * prev[i]
            bdh = torch.einsum("bdn,bn->bd", dh, Bm[:, t])
            ddt[:, t] = (adot * A).sum(-1) + bdh * x[:, t]
            dx[:, t] = bdh * delta[:, t] + D * gt
            dA += (adot * delta[:, t, :, None]).sum(0)
            dD += (gt * x[:, t]).sum(0)
            dh = decays[i] * dh
    return dx, ddt, dA, dB, dC, dD


def _lib():
    from ._build import load

    lib = load("selective_scan")
    if not getattr(lib, "_sdt_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.sdt_selective_scan_chunk.restype = I
        lib.sdt_selective_scan_chunk.argtypes = []
        lib.sdt_selective_scan_bwd_tiles.restype = I
        lib.sdt_selective_scan_bwd_tiles.argtypes = [I]
        lib.sdt_selective_scan_fwd.restype = I
        lib.sdt_selective_scan_fwd.argtypes = [P] * 8 + [I] * 4 + [P]
        lib.sdt_selective_scan_bwd.restype = I
        lib.sdt_selective_scan_bwd.argtypes = [P] * 18 + [I] * 4 + [P]
        if lib.sdt_selective_scan_chunk() != CHUNK:
            raise RuntimeError("csrc/selective_scan.cu kChunk differs from kernels/selective_scan.py CHUNK")
        lib._sdt_typed = True
    return lib


def _checked(what: str, *tensors: torch.Tensor):
    """Validate the six scan inputs (and dy) for a kernel; contiguous copies."""
    x, A = tensors[0], tensors[2]
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"{what}: want x (B, T, D) and A (D, N), got {tuple(x.shape)} and {tuple(A.shape)}")
    Bsz, T, Dd = x.shape
    N = A.shape[1]
    want = [(Bsz, T, Dd), (Bsz, T, Dd), (Dd, N), (Bsz, T, N), (Bsz, T, N), (Dd,), (Bsz, T, Dd)]
    for name, t, shape in zip(_NAMES + ("dy",), tensors, want):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{what}: {name} must be float32 {shape} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if N not in STATE_SIZES:
        raise ValueError(f"{what}: d_state {N} is not one of the built sizes {STATE_SIZES}")
    return [t.contiguous() for t in tensors]


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def selective_scan_fwd(x, delta, A, Bm, C, D) -> torch.Tensor:
    """K3a: the scan's output y (B, T, D)."""
    if not x.is_cuda:
        return selective_scan_sequential(x, delta, A, Bm, C, D)
    args = _checked("selective_scan_fwd", x, delta, A, Bm, C, D)
    Bsz, T, Dd = x.shape
    y = torch.empty_like(args[0])
    if y.numel() == 0:
        return y
    lib = _lib()
    from ._build import check

    code = lib.sdt_selective_scan_fwd(*_ptrs(*args, y), None, Bsz, T, Dd, A.shape[1],
                                      torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, code, "selective_scan_fwd")
    selective_scan_fwd.launches += 1
    return y


def selective_scan_fwd_states(x, delta, A, Bm, C, D) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3b: y and the chunk-initial states h0 (B·ceil(T/CHUNK), N, D)."""
    if not x.is_cuda:
        return selective_scan_states_ref(x, delta, A, Bm, C, D, CHUNK)
    args = _checked("selective_scan_fwd_states", x, delta, A, Bm, C, D)
    Bsz, T, Dd = x.shape
    N = A.shape[1]
    y = torch.empty_like(args[0])
    h0 = torch.empty((Bsz * -(-T // CHUNK), N, Dd), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, h0
    lib = _lib()
    from ._build import check

    code = lib.sdt_selective_scan_fwd(*_ptrs(*args, y, h0), Bsz, T, Dd, N,
                                      torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, code, "selective_scan_fwd_states")
    selective_scan_fwd_states.launches += 1
    return y, h0


def selective_scan_bwd(x, delta, A, Bm, C, D, h0, g):
    """K3c: (dx, dΔ, dA, dB, dC, dD) from the saved h0 and dy = g."""
    if not x.is_cuda:
        return selective_scan_bwd_ref(x, delta, A, Bm, C, D, h0, g, CHUNK)
    x, delta, A, Bm, C, D, g = _checked("selective_scan_bwd", x, delta, A, Bm, C, D, g)
    Bsz, T, Dd = x.shape
    N = A.shape[1]
    if tuple(h0.shape) != (Bsz * -(-T // CHUNK), N, Dd) or h0.dtype != torch.float32 or h0.device != x.device:
        raise ValueError(f"selective_scan_bwd: h0 {tuple(h0.shape)} {h0.dtype} does not match the inputs")
    h0 = h0.contiguous()
    dx, ddt, dB, dC = (torch.empty_like(t) for t in (x, delta, Bm, C))
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    if x.numel() == 0:
        return dx, ddt, dA.zero_(), dB, dC, dD.zero_()
    lib = _lib()
    from ._build import check

    tiles = lib.sdt_selective_scan_bwd_tiles(Dd)
    dA_part = torch.empty((Bsz, Dd, N), dtype=torch.float32, device=x.device)
    dD_part = torch.empty((Bsz, Dd), dtype=torch.float32, device=x.device)
    dB_part = torch.empty((tiles, Bsz, T, N), dtype=torch.float32, device=x.device)
    dC_part = torch.empty_like(dB_part)
    code = lib.sdt_selective_scan_bwd(
        *_ptrs(x, delta, A, Bm, C, D, h0, g, dx, ddt, dA, dB, dC, dD, dA_part, dD_part, dB_part, dC_part),
        Bsz, T, Dd, N, torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(lib, code, "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC, dD


selective_scan_fwd.launches = 0
selective_scan_fwd_states.launches = 0
selective_scan_bwd.launches = 0


class SelectiveScanFn(torch.autograd.Function):
    """y = scan(x, Δ, A, B, C, D) with K3b in forward and K3c in backward."""

    @staticmethod
    def forward(ctx, x, delta, A, Bm, C, D):
        y, h0 = selective_scan_fwd_states(x, delta, A, Bm, C, D)
        ctx.save_for_backward(x, delta, A, Bm, C, D, h0)
        return y

    @staticmethod
    def backward(ctx, g):
        x, delta, A, Bm, C, D, h0 = ctx.saved_tensors
        return selective_scan_bwd(x, delta, A, Bm, C, D, h0, g.contiguous())


def scan_work(kind: str, B: int, T: int, D: int, N: int) -> Dict[str, float]:
    """Bytes, fp32 operations and exponentials one call needs.

    kind 'fwd' (K3a): x, Δ read and y written (B·T·D each), B and C read
    (B·T·N each), A and D read; one exponential and 5 operations per
    (b, t, d, n) (Δ·A, decay·h, +B·Δx, C·h, +). 'states' (K3b) adds the h0
    written (B·ceil(T/CHUNK)·N·D). 'bwd' (K3c) reads x, Δ, dy, B, C, h0, A, D
    and writes dx, dΔ, dB, dC, dA, dD; the decays of a chunk are recomputed
    from h0 once (one exponential per element) and used by the replay (4
    operations) and the adjoint (about 12).
    """
    n_chunks = -(-T // CHUNK)
    btd, btn, elems = B * T * D, B * T * N, B * T * D * N
    if kind == "fwd":
        return dict(bytes=4.0 * (3 * btd + 2 * btn + D * N + D), flops=5.0 * elems, exps=float(elems))
    if kind == "states":
        return dict(bytes=4.0 * (3 * btd + 2 * btn + D * N + D + B * n_chunks * N * D), flops=5.0 * elems,
                    exps=float(elems))
    if kind == "bwd":
        return dict(bytes=4.0 * (5 * btd + 4 * btn + 2 * (D * N + D) + B * n_chunks * N * D),
                    flops=16.0 * elems, exps=float(elems))
    raise ValueError(kind)
