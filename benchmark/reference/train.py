"""The reference's training steps: BCE, global-norm clipping and Adam.

Follows the recipe's optimiser as optax states it: the gradient of the mean
BCE, scaled by min(1, clip / ‖g‖) over all leaves, then Adam (b1 0.9, b2
0.999, eps 1e-8, bias-corrected) at the learning rate of the update count,
a linear warm-up from 0 to the peak and a linear decay to 0 (`poly`).
BatchNorm's running statistics move as flax moves them: by 0.1 towards
each step's batch mean and biased variance.
Imports nothing of the measured package.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import tsvad

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
BN_MOMENTUM = 0.1


def is_param(name: str) -> bool:
    return name.rsplit(".", 1)[-1] not in BUFFERS


def poly_lr(step: int, peak: float, warmup: int, total: int) -> float:
    if step < warmup:
        return peak * step / max(warmup, 1)
    return peak * (1.0 - min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0))


def follow(P0: Dict[str, torch.Tensor], cfg: dict, batches: List[dict], n_label: int, recipe: dict, seed: int,
           prec: tsvad.Precision = tsvad.Precision(), scan_rows: int = 128) -> dict:
    """Train from the weights P0 one step on each batch (audio, target_embs,
    labels); dropout masks from a generator seeded `seed` on the batches'
    device. → the loss of each step, each leaf's first (clipped) gradient
    norm, each leaf's change after the last step, and each BatchNorm running
    statistic's change."""
    if recipe["optimizer"] != "adam" or recipe["schedule"] != "poly":
        raise ValueError("the reference follows adam with the poly schedule only")
    dev = batches[0]["audio"].device
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in P0.items() if is_param(k)}
    buffers = {k: v for k, v in P0.items() if not is_param(k)}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    running = {k: v.detach().clone().float() for k, v in P0.items() if k.rsplit(".", 1)[-1] in BUFFERS[:2]}
    b1, b2, eps, clip = 0.9, 0.999, 1e-8, recipe["grad_clip_norm"]
    losses, first = [], {}
    with tsvad.exact_fp32():
        for step, batch in enumerate(batches):
            stats = {}
            logits = tsvad.forward({**buffers, **params}, cfg, batch["audio"], batch["target_embs"], n_label, prec,
                                   train=True, generator=gen, scan_rows=scan_rows, stats=stats)
            loss = tsvad.bce_loss(logits, batch["labels"])
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params.values(), grads)]
            losses.append(loss.item())
            del logits, loss
            for name, (mean, var) in stats.items():
                for key, val in (("running_mean", mean), ("running_var", var)):
                    running[f"{name}.{key}"].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * val)
            norm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads))
            scale = 1.0 if norm < clip else clip / norm
            lr = poly_lr(step, recipe["learning_rate"], recipe["warmup_steps"], recipe["total_steps"])
            t = step + 1
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    g = g * scale
                    if step == 0:
                        first[k] = float(g.norm())
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).add_(g * g, alpha=1 - b2)
                    denom = (v[k] / (1 - b2**t)).sqrt() + eps
                    p.sub_(lr * (m[k] / (1 - b1**t)) / denom)
            del grads
    change = {k: float((p.detach() - P0[k].float()).norm()) for k, p in params.items()}
    moved = {k: float((v - P0[k].float()).norm()) for k, v in running.items()}
    return dict(losses=losses, grad_norms=first, change_norms=change, stats_norms=moved)
