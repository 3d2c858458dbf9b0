"""Learning-rate schedules of the reference recipes.

Counterpart of speaker_diarization_tpu/train/schedules.py. Each schedule maps
the optimizer's update count (0 at the first update, as optax counts) to a
learning rate, as a Python float.
"""

from __future__ import annotations


def noam_schedule(base_lr: float, d_model: int, warmup_steps: int = 25000):
    """lr(step) = base_lr · d_model^-0.5 · min(s^-0.5, s · warmup^-1.5), s = step + 1."""

    def schedule(step: int) -> float:
        s = float(max(step + 1, 1))  # 1-indexed like the reference
        return base_lr * d_model**-0.5 * min(s**-0.5, s * warmup_steps**-1.5)

    return schedule


def polynomial_decay_schedule(base_lr: float, warmup_steps: int, total_steps: int, end_lr: float = 0.0,
                              power: float = 1.0):
    """Linear warmup, then polynomial decay to end_lr at total_steps."""

    def schedule(step: int) -> float:
        s = float(step)
        if s < warmup_steps:
            return base_lr * min(s / max(warmup_steps, 1), 1.0)
        frac = min(max((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return (base_lr - end_lr) * (1 - frac) ** power + end_lr

    return schedule
