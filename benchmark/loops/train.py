"""The training loop: one `Trainer.train_step` on a staged batch a call.

Set-up builds the measured model and the port's Trainer at the traffic's
optimiser settings, and drives that same trainer through its first three
steps on three distinct batches of the ring (they also warm every shape).
It keeps the first step's Adam first moment (0.1 × the clipped gradient)
and the weights after the third step. The window then goes on stepping the
same trainer round the ring with no host sync.

The check follows the first three steps with the reference in float32 from
the same seeded weights, batches and dropout seed, and compares the loss of
each step, each leaf's first gradient norm and each leaf's change after
three steps, and the change of each BatchNorm running statistic (which
moves with the batch each step sees). A leaf's gap is |program norm −
reference norm| over the larger of the reference's norm of that leaf and of
the median leaf. Leaves
whose reference gradient is under a thousandth of the median leaf's move
under Adam by round-off alone and are left out of the change.
"""

from __future__ import annotations

import statistics

import torch

from ..reference import train as ref_train, tsvad
from ..weights import stream

FOLLOWED = 3
B1 = 0.9  # Adam's first-moment decay: after one step the moment is (1 - B1) × the gradient


class Loop:
    TRACE_CALLS = 2
    SPAN = "bench.train_step"

    def __init__(self, ctx):
        self.ctx = ctx

    def dropout_seed(self) -> int:
        return stream(self.ctx.seed, 4)

    def setup(self):
        from speaker_diarization_tpu_torch.train.tasks import make_tsvad_loss
        from speaker_diarization_tpu_torch.train.trainer import Trainer, TrainerConfig

        ctx = self.ctx
        self.model = ctx.build_model()
        self.trainer = Trainer(self.model, make_tsvad_loss(ctx.n_label),
                               TrainerConfig(**ctx.traffic["trainer"], seed=self.dropout_seed()))
        self.ring = ctx.batches()
        names = [n for n, _ in self.trainer.named]
        self.first_losses = []
        for k in range(FOLLOWED):
            self.first_losses.append(self.trainer.train_step(self.ring[k])["loss"].detach().float())
            if k == 0:
                st = self.trainer.opt.state
                self.moment1 = {n: st[p]["exp_avg"].detach().clone() if "exp_avg" in st[p] else torch.zeros_like(p)
                                for n, p in self.trainer.named}
        self.after = {n: p.detach().clone() for n, p in zip(names, self.trainer.params)}
        self.after_stats = {n: b.detach().clone() for n, b in self.model.named_buffers()
                            if n.rsplit(".", 1)[-1] in ("running_mean", "running_var")}
        self.losses = torch.zeros(1 << 16, device=ctx.device)
        ctx.sync()

    def call(self, i, timed=True):
        loss = self.trainer.train_step(self.ring[(FOLLOWED + i) % len(self.ring)])["loss"]
        if timed and i < len(self.losses):
            self.losses[i] = loss.detach()

    def failed(self) -> int:
        n = min(self.ctx.calls, len(self.losses))
        return int((~torch.isfinite(self.losses[:n])).sum())

    def program_state(self):
        """What the program's first steps produced: losses, first gradients, changes."""
        P0 = self.ctx.make_weights()
        losses = [float(x) for x in self.first_losses]
        grads = {n: float(m.float().norm()) / (1 - B1) for n, m in self.moment1.items()}
        change = {n: float((p.float() - P0[n].float()).norm()) for n, p in self.after.items()}
        stats = {n: float((b.float() - P0[n].float()).norm()) for n, b in self.after_stats.items()}
        return dict(losses=losses, grad_norms=grads, change_norms=change, stats_norms=stats)

    def reference(self, prec=tsvad.Precision()):
        ctx = self.ctx
        return ref_train.follow(ctx.make_weights(), ctx.model_cfg, self.ring[:FOLLOWED], ctx.n_label,
                                ctx.traffic["trainer"], self.dropout_seed(), prec)

    @staticmethod
    def readings(got: dict, ref: dict) -> dict:
        """loss_rel: the worst step's relative loss gap; grad_gap, change_gap,
        stats_gap: the worst leaf's gap (first gradient, change of a weight,
        change of a BatchNorm running statistic); the `_median` ones the
        median leaf's gap; `_leaf`: which leaf was worst."""

        def gaps(a, b, names):
            floor = statistics.median(b[n] for n in names)
            return {n: abs(a[n] - b[n]) / max(b[n], floor, 1e-30) for n in names}

        g_med = statistics.median(ref["grad_norms"].values())
        moved = [n for n in ref["change_norms"] if ref["grad_norms"][n] >= 1e-3 * g_med]
        out = dict(loss_rel=max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])))
        for key, names in (("grad", list(ref["grad_norms"])), ("change", moved), ("stats", list(ref["stats_norms"]))):
            g = gaps(got[key + "_norms"], ref[key + "_norms"], names)
            worst = max(g, key=g.get)
            out.update({f"{key}_gap": g[worst], f"{key}_gap_median": statistics.median(g.values()),
                        f"{key}_leaf": worst})
        return out

    def free_program(self):
        del self.trainer, self.model
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def measure(self) -> dict:
        """Every reading of the program's first steps against the reference."""
        self.ctx.sync()
        got = self.program_state()
        self.free_program()
        return self.readings(got, self.reference())

    def check(self):
        read = self.measure()
        return {k: dict(value=read[k], limit=lim) for k, lim in self.ctx.limits.items()}
