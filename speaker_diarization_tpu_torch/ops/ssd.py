"""State-space duality (SSD) scan: the Mamba-2 core, in chunked matmul form.

Counterpart of speaker_diarization_tpu/ops/ssd.py (reference
egs/alimeeting/ts_vad2/mamba.py:150-233, mamba_ssm's
`mamba_chunk_scan_combined`). Per batch b, head h, channel p, state n:

    h_t = exp(dt_t · A_h) · h_{t-1} + dt_t · B_t[n] · x_t[p]
    y_t = Σ_n C_t[n] · h_t[n, p] + D_h · x_t[p]

with A_h < 0 one scalar per head and B/C shared across head groups. The JAX
package computes this outside any Pallas kernel, as batched einsums over
length-L chunks plus a `lax.scan` over chunk boundaries; here the same
einsums run as torch ops and the carry is a Python loop over the NC chunks
(NC = 2 at the recipe's T = 100 with chunk 64). All math is fp32.

The intra-chunk decay is exp(where(causal, seg, -inf)), in that order, as in
JAX: above the diagonal seg is positive and exp(seg) can overflow, and an
inf times a zero mask would put NaNs into the gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as Fn


def _repeat_groups(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, G, N) → (B, T, H, N) by repeating each group H/G times."""
    g = t.shape[2]
    if g == n_heads:
        return t
    return torch.repeat_interleave(t, n_heads // g, dim=2)


def ssd_chunked(
    x: torch.Tensor,  # (B, T, H, P)
    dt: torch.Tensor,  # (B, T, H), positive (already softplus'd)
    A: torch.Tensor,  # (H,), negative
    Bm: torch.Tensor,  # (B, T, G, N)
    Cm: torch.Tensor,  # (B, T, G, N)
    D: Optional[torch.Tensor] = None,  # (H,)
    chunk: int = 64,
) -> torch.Tensor:
    """Chunked SSD scan → y (B, T, H, P); T is padded to a multiple of
    `chunk` with dt = 0 steps, which neither decay nor feed the state."""
    Bsz, T, H, P = x.shape
    pad = (-T) % chunk
    if pad:
        x = Fn.pad(x, (0, 0, 0, 0, 0, pad))
        dt = Fn.pad(dt, (0, 0, 0, pad))
        Bm = Fn.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = Fn.pad(Cm, (0, 0, 0, 0, 0, pad))
    Tp = T + pad
    NC, L = Tp // chunk, chunk
    N = Bm.shape[-1]

    xc = x.reshape(Bsz, NC, L, H, P)
    dtc = dt.reshape(Bsz, NC, L, H)
    bc = _repeat_groups(Bm, H).reshape(Bsz, NC, L, H, N)
    cc = _repeat_groups(Cm, H).reshape(Bsz, NC, L, H, N)

    cum = torch.cumsum(dtc * A, dim=2)  # (B, NC, L, H) inclusive log-decay within the chunk

    # intra-chunk: decay[i, j] = exp(cum_i - cum_j) for i >= j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, NC, Li, Lj, H)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    decay = torch.exp(torch.where(causal, seg, torch.tensor(float("-inf"), device=x.device)))
    cb = torch.einsum("bclhn,bcshn->bclsh", cc, bc)
    y = torch.einsum("bclsh,bcshp->bclhp", cb * decay * dtc[:, :, None, :, :], xc)

    # chunk states S_c = Σ_j exp(cum_last - cum_j) dt_j B_j x_j, carried across chunks
    last = cum[:, :, -1:, :]  # (B, NC, 1, H)
    w = torch.exp(last - cum) * dtc
    S_local = torch.einsum("bclhn,bclhp->bchnp", bc * w[..., None], xc)  # (B, NC, H, N, P)
    E = torch.exp(last[:, :, 0, :])  # (B, NC, H) whole-chunk decay
    S = x.new_zeros((Bsz, H, N, P))
    S_prev = []
    for c in range(NC):
        S_prev.append(S)  # the carry before chunk c
        S = E[:, c, :, None, None] * S + S_local[:, c]
    S_prev = torch.stack(S_prev, dim=1)  # (B, NC, H, N, P)

    # inter-chunk: y_l += exp(cum_l) · C_l · S_prev
    y = y + torch.einsum("bclhn,bchnp->bclhp", cc * torch.exp(cum)[..., None], S_prev)
    y = y.reshape(Bsz, Tp, H, P)[:, :T]
    if D is not None:
        y = y + x[:, :T] * D[None, None, :, None]
    return y


def ssd_sequential(x, dt, A, Bm, Cm, D=None):
    """The per-step recurrence; the oracle of `ssd_chunked`, same signature."""
    Bsz, T, H, P = x.shape
    Bh, Ch = _repeat_groups(Bm, H), _repeat_groups(Cm, H)
    h = x.new_zeros((Bsz, H, Bh.shape[-1], P))
    ys = []
    for t in range(T):
        decay = torch.exp(dt[:, t] * A)  # (B, H)
        h = decay[:, :, None, None] * h + torch.einsum("bh,bhn,bhp->bhnp", dt[:, t], Bh[:, t], x[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], h))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + x * D[None, None, :, None]
    return y
