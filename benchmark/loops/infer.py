"""The inference loop: one TS-VAD forward of a staged batch of windows a call.

Each call runs `TSVADModel.forward` under no_grad and a sigmoid, as the
port's chunked inference calls it, on the next batch of the ring, and
copies the probabilities to pinned host memory without blocking. A sample
of the window's calls, drawn from the seed, also keeps its probabilities on
the device. After the run the reference recomputes every batch of the ring
in float32, and each kept forward and each batch's last host copy are
compared with it: the widest gap of a probability, and the mean gap of the
worst forward. The model runs in eval mode, so its weights get BatchNorm
running statistics calibrated on a seeded batch (`weights.calibrate_bn`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import tsvad

KEEP_SHARE, KEEP_MAX = 0.25, 64  # share of the window's forwards kept for the check, and at most
REF_ROWS = 64  # windows per reference forward


class Loop:
    TRACE_CALLS = 8
    SPAN = "bench.forward"

    def __init__(self, ctx):
        self.ctx = ctx
        ctx.calibrate_bn = True

    def setup(self):
        ctx = self.ctx
        self.model = ctx.build_model()
        self.model.eval()
        self.ring = ctx.batches()
        with torch.no_grad():
            for b in self.ring:  # every shape the window meets, every batch once
                self._forward(b)
        ctx.sync()
        B, T, S = self.ring[0]["labels"].shape
        pin = ctx.device.type == "cuda"
        self.host = [torch.empty((B, T, S), pin_memory=pin) for _ in self.ring]
        self.host_from = [None] * len(self.ring)
        self.kept = torch.empty((KEEP_MAX, B, T, S), device=ctx.device)
        self.kept_slot = []
        self.sums = torch.zeros(1 << 16, device=ctx.device)
        self.keep = np.random.default_rng([ctx.seed, 5]).random(1 << 16) < KEEP_SHARE

    def _forward(self, b):
        return torch.sigmoid(self.model(b["audio"], b["target_embs"], self.ctx.n_label))

    def call(self, i, timed=True):
        slot = i % len(self.ring)
        with torch.no_grad():
            p = self._forward(self.ring[slot])
            self.host[slot].copy_(p, non_blocking=True)
            self.host_from[slot] = i
            if timed and i < len(self.sums):
                self.sums[i] = p.sum()
                if self.keep[i] and len(self.kept_slot) < KEEP_MAX:
                    self.kept[len(self.kept_slot)].copy_(p)
                    self.kept_slot.append(slot)

    def failed(self) -> int:
        n = min(self.ctx.calls, len(self.sums))
        return int((~torch.isfinite(self.sums[:n])).sum())

    def reference(self, prec=tsvad.Precision()):
        """Each ring batch's probabilities from the reference, in blocks of rows."""
        ctx = self.ctx
        P = ctx.make_weights()
        out = []
        with torch.no_grad(), tsvad.exact_fp32():
            for b in self.ring:
                rows = []
                for r in range(0, b["audio"].shape[0], REF_ROWS):
                    sl = slice(r, r + REF_ROWS)
                    logits = tsvad.forward(P, ctx.model_cfg, b["audio"][sl], b["target_embs"][sl], ctx.n_label,
                                           prec, scan_rows=REF_ROWS * ctx.model_cfg["max_num_speaker"])
                    rows.append(torch.sigmoid(logits))
                out.append(torch.cat(rows))
        return out

    def readings(self, answers, ref):
        """(widest gap, worst forward's mean gap) of `answers` [(slot, probs)] against `ref`."""
        worst_max = worst_mean = 0.0
        for slot, p in answers:
            d = (p.to(ref[slot].device).float() - ref[slot]).abs()
            worst_max, worst_mean = max(worst_max, float(d.max())), max(worst_mean, float(d.mean()))
        return dict(prob_max_abs=worst_max, prob_mean_abs=worst_mean)

    def answers(self):
        kept = [(slot, self.kept[k]) for k, slot in enumerate(self.kept_slot)]
        return kept + [(s, h) for s, h in enumerate(self.host) if self.host_from[s] is not None]

    def free_program(self):
        del self.model
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def measure(self) -> dict:
        """Every reading of the window's answers against the reference."""
        self.ctx.sync()
        self.free_program()
        return self.readings(self.answers(), self.reference())

    def check(self):
        read = self.measure()
        return {k: dict(value=read[k], limit=lim) for k, lim in self.ctx.limits.items()}
