"""Ring attention: exact self-attention with the sequence sharded over a mesh axis.

Counterpart of speaker_diarization_tpu/parallel/ring_attention.py. Each rank
of the `seq_axis` group holds one time block of q, k and v, (B, T_loc, H,
D). K and V travel round the ring (rank i sends to i + 1 and receives from
i − 1, `batch_isend_irecv`) while each rank folds every block into an fp32
online softmax over its own queries (JAX `ring_attention.py:26-58`): the
result equals full attention over the whole sequence up to rounding.

The P2P ops are not differentiable, so the backward is a second ring pass
in a `torch.autograd.Function`: the blocks go round again carrying their
dK and dV, each rank adds its queries' share, p is recomputed from the
saved per-row max m and sum l (p = exp(s − m − log l)), and after n
rotations every dK, dV block is back home. The block body is plain torch
einsums, as in JAX, which has no Pallas kernel here.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from .collectives import AxisComm
from .mesh import Mesh


def _rotate(tensors: List[torch.Tensor], comm: AxisComm) -> List[torch.Tensor]:
    """Send each tensor to the next rank of the ring and take the previous
    rank's."""
    if comm.size == 1:
        return tensors
    nxt = comm.ranks[(comm.index + 1) % comm.size]
    prv = comm.ranks[(comm.index - 1) % comm.size]
    got = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, comm.group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, g, prv, comm.group) for g in got]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, comm):
        B, Tq, H, D = q.shape
        scale = D**-0.5
        qh = q.float() * scale
        acc = torch.zeros(B, H, Tq, D, device=q.device, dtype=torch.float32)
        m = torch.full((B, H, Tq), float("-inf"), device=q.device, dtype=torch.float32)
        l = torch.zeros(B, H, Tq, device=q.device, dtype=torch.float32)
        kb, vb = k, v
        for step in range(comm.size):
            s = torch.einsum("bqhd,bkhd->bhqk", qh, kb.float())
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb.float())
            m = m_new
            if step + 1 < comm.size:
                kb, vb = _rotate([kb, vb], comm)
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        ctx.comm = comm
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        comm = ctx.comm
        scale = q.shape[-1] ** -0.5
        qh = q.float() * scale
        do = g.float().transpose(1, 2)  # (B, H, Tq, D)
        delta = (do * out).sum(-1)  # (B, H, Tq)
        dq = torch.zeros_like(qh)  # (B, Tq, H, D)
        kb, vb = k, v
        dk = torch.zeros(k.shape, device=k.device, dtype=torch.float32)
        dv = torch.zeros(v.shape, device=v.device, dtype=torch.float32)
        for step in range(comm.size):
            kf, vf = kb.float(), vb.float()
            s = torch.einsum("bqhd,bkhd->bhqk", qh, kf)
            p = torch.exp(s - lse[..., None])
            dv = dv + torch.einsum("bhqk,bhqd->bkhd", p, do)
            dp = torch.einsum("bhqd,bkhd->bhqk", do, vf)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qh)
            if step + 1 < comm.size:  # the block moves on with its gradients
                kb, vb, dk, dv = _rotate([kb, vb, dk, dv], comm)
            else:  # the n-th move brings each block's gradients home
                dk, dv = _rotate([dk, dv], comm)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                        seq_axis: str = "data") -> torch.Tensor:
    """Exact multi-head self-attention over the sequence sharded along
    `seq_axis`: q, k, v are this rank's (B, T_loc, H, D) blocks, in ring
    order; → its (B, T_loc, H, D) block of the output, in q's dtype."""
    comm = {"data": mesh.data, "model": mesh.model}[seq_axis]
    if comm is None:
        raise ValueError(f"the mesh has no {seq_axis!r} group")
    return _RingAttention.apply(q, k, v, comm)
