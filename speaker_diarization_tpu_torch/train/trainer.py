"""The port's trainer: one optimizer step per batch, with optax's semantics.

Counterpart of speaker_diarization_tpu/train/trainer.py (`TrainerConfig`,
`build_optimizer`, `Trainer.train_step`/`eval_step`). The model is an
nn.Module whose BatchNorm running statistics are its mutable state; the task
plugs in as `loss_fn(model, batch, generator, train) → (loss, aux)`.

What matches optax exactly, so one run gives the same numbers in both
frameworks up to rounding:
- adam / adamw / sgd (b1 0.9, b2 0.999, eps 1e-8; adamw decays the weights
  by lr·wd from the pre-update values; sgd has no momentum), with the
  learning rate set from the schedule before every update at the update
  count (0 at the first update);
- global-norm clipping g·min(1, max/‖g‖), with no epsilon;
- AutoClip: clip at a linear-interpolated percentile of the last
  `grad_history_size` global norms;
- `skip_nonfinite`: an update with a non-finite gradient leaves the weights
  and the optimizer state as they were;
- `grad_accum_steps` k > 1 (optax.MultiSteps): the running mean of k
  gradients is applied on every k-th step; the steps between change nothing;
- Polyak `model_avg_decay`: avg ← avg·d + p·(1 − d) after every step.
Dropout masks come from `self.generator`, a torch.Generator on the model's
device seeded with `seed` (plus the data rank on a mesh).

With a mesh (`parallel.mesh.make_mesh`), `train_step` and `eval_step` take
the global batch and each data rank keeps its rows (`shard_batch`). The
model is not wrapped in DistributedDataParallel: the gradients come from
`torch.autograd.grad`, which DDP's hooks never see. They are reduced
explicitly over the data group, the data mean of every rank's gradients:
by default one flattened `all_reduce(SUM)` / n (JAX's psum); with
`deterministic_reduce` an `all_gather` and a sum over ranks 0..n−1 in that
order, then / n (JAX `trainer.py:246-280`), so the result does not depend
on how the ranks are laid out. The loss and the aux values are reduced the
same way (the data mean). The step runs inside `data_parallel`, so
train-mode BatchNorm takes the global batch's statistics and the masked
losses divide by the global batch's counts, as JAX's GSPMD step does. The
global norm, clipping, AutoClip and `skip_nonfinite` act on the reduced
gradients; where `parallel.mesh.shard_params` has split a parameter over
the model group, its squared norm is summed over that group and a
replicated one counts once. Unlike JAX, which draws one dropout mask for
the global batch, each data rank draws its own from its own generator
(seed + data rank), so a mesh run with dropout is not the single-device
run; the parity tests run at dropout 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..parallel.collectives import data_parallel
from ..parallel.mesh import Mesh, shard_batch
from .schedules import noam_schedule, polynomial_decay_schedule


@dataclass
class TrainerConfig:
    optimizer: str = "adam"  # adam | adamw | sgd
    learning_rate: float = 1.0  # noam: scale; others: peak lr
    schedule: str = "noam"  # noam | poly | const
    d_model: int = 256  # for noam
    warmup_steps: int = 25000
    total_steps: int = 100000
    end_lr: float = 0.0
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = 5.0
    auto_clip_percentile: Optional[float] = None  # overrides grad_clip_norm when set
    grad_history_size: int = 1000
    skip_nonfinite: bool = False
    grad_accum_steps: int = 1
    model_avg_decay: Optional[float] = None  # e.g. 0.999; None disables
    seed: int = 0
    # reduce over the data group by all_gather and a fixed-order sum (JAX's
    # topology-independent reduction) instead of all_reduce
    deterministic_reduce: bool = False


def build_schedule(cfg: TrainerConfig) -> Callable[[int], float]:
    if cfg.schedule == "noam":
        return noam_schedule(cfg.learning_rate, cfg.d_model, cfg.warmup_steps)
    if cfg.schedule == "poly":
        return polynomial_decay_schedule(cfg.learning_rate, cfg.warmup_steps, cfg.total_steps, cfg.end_lr)
    if cfg.schedule == "const":
        return lambda step: cfg.learning_rate
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def build_optimizer(cfg: TrainerConfig, params) -> tuple:
    """→ (torch optimizer over `params`, schedule). The optimizer's lr is set
    from the schedule by the Trainer before each update."""
    sched = build_schedule(cfg)
    lr0 = sched(0)
    if cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8)
    elif cfg.optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=lr0)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return opt, sched


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class Trainer:
    """Train and eval steps of `model` under `loss_fn`; holds the optimizer,
    the step counters, the dropout generator, the gradient accumulators and
    the averaged weights."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, cfg: TrainerConfig, mesh: Optional[Mesh] = None):
        self.model, self.loss_fn, self.cfg, self.mesh = model, loss_fn, cfg, mesh
        self.device = next(model.parameters()).device
        self.named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.params = [p for _, p in self.named]
        self.data = None
        if mesh is not None:
            if not mesh.is_member:
                raise ValueError(f"rank {mesh.rank} is outside the {mesh.n_data} x {mesh.n_model} mesh")
            self.data = mesh.data.with_order(cfg.deterministic_reduce)
        sharded = getattr(model, "tp_sharded", frozenset())
        self.sharded = [n in sharded for n, _ in self.named]
        self.opt, self.schedule = build_optimizer(cfg, self.params)
        self.step = 0  # train_step calls (JAX TrainState.step)
        self.n_updates = 0  # optimizer updates (optax's inner count)
        seed = cfg.seed + (mesh.data_rank if mesh is not None else 0)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.avg_params = None
        if cfg.model_avg_decay is not None:
            self.avg_params = {n: p.detach().clone() for n, p in self.named}
        self.acc_grads = None  # MultiSteps running mean
        self.mini_step = 0
        self.clip_history = torch.zeros(cfg.grad_history_size, device=self.device)
        self.clip_count = 0

    # ------------------------------------------------------------------
    def _norm(self, grads) -> torch.Tensor:
        """The global norm of `grads`; the squares of parameters sharded over
        the model group are summed over it."""
        if not any(self.sharded):
            return global_norm(grads)
        own = sum(torch.sum(g.float() * g.float()) for g, s in zip(grads, self.sharded) if s)
        rest = sum(torch.sum(g.float() * g.float()) for g, s in zip(grads, self.sharded) if not s)
        return torch.sqrt(self.mesh.model.sum(own) + rest)

    def _clip(self, grads) -> None:
        """Scale `grads` in place as the optax clip transformation would."""
        cfg = self.cfg
        if cfg.auto_clip_percentile is not None:
            gnorm = self._norm(grads)
            H = cfg.grad_history_size
            self.clip_history[self.clip_count % H] = gnorm
            n = min(self.clip_count + 1, H)
            self.clip_count += 1
            srt = torch.sort(self.clip_history[:n]).values  # the n recorded norms
            f = cfg.auto_clip_percentile / 100.0 * (n - 1)
            i0 = int(f)
            i1 = min(i0 + 1, n - 1)
            w = f - i0
            clip = srt[i0] * (1.0 - w) + srt[i1] * w
            scale = torch.clamp_max(clip / torch.clamp_min(gnorm, 1e-12), 1.0)
        elif cfg.grad_clip_norm is not None:
            gnorm = self._norm(grads)
            scale = torch.where(gnorm < cfg.grad_clip_norm, torch.ones_like(gnorm), cfg.grad_clip_norm / gnorm)
        else:
            return
        for g in grads:
            g.mul_(scale.to(g.dtype))

    def _apply(self, grads) -> None:
        """One optimizer update with `grads` (already accumulated)."""
        if self.cfg.skip_nonfinite and not self._finite(grads):
            return  # optax.apply_if_finite: weights and optimizer state unchanged
        self._clip(grads)
        for p, g in zip(self.params, grads):
            p.grad = g
        lr = self.schedule(self.n_updates)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.n_updates += 1

    def _finite(self, grads) -> bool:
        ok = torch.stack([torch.isfinite(g).all() for g in grads]).all().float()
        if any(self.sharded):  # every model rank takes the same decision
            return bool(self.mesh.model.sum(ok) == self.mesh.n_model)
        return bool(ok)

    def _reduce_aux(self, loss, aux: dict) -> dict:
        """The loss and the aux values (detached), as data means on a mesh."""
        aux = {k: torch.as_tensor(v, device=loss.device).detach() for k, v in aux.items()}
        aux["loss"] = loss.detach()
        if self.data is None:
            return aux
        keys = list(aux)
        vals = self.data.mean(torch.stack([aux[k].float().reshape(()) for k in keys]))
        return dict(zip(keys, vals.unbind(0)))

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Forward, backward and (every grad_accum_steps-th call) one update.
        Returns aux tensors (loss, grad_norm, lr, task metrics); no host sync.
        On a mesh `batch` is the global batch."""
        self.model.train()
        for p in self.params:
            p.grad = None
        if self.mesh is not None:
            batch = shard_batch(batch, self.mesh)
        with data_parallel(self.data):
            loss, aux = self.loss_fn(self.model, batch, self.generator, True)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        if self.data is not None:
            grads = self.data.mean_flat(grads)
        aux = self._reduce_aux(loss, aux)
        aux["grad_norm"] = self._norm(grads)
        aux["lr"] = torch.tensor(self.schedule(self.step))
        k = self.cfg.grad_accum_steps
        if k > 1:
            if self.acc_grads is None:
                self.acc_grads = [torch.zeros_like(g) for g in grads]
            for acc, g in zip(self.acc_grads, grads):
                acc.add_((g - acc) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step == k:
                self._apply(self.acc_grads)
                self.acc_grads, self.mini_step = None, 0
        else:
            self._apply(grads)
        for p in self.params:
            p.grad = None
        if self.avg_params is not None:
            d = self.cfg.model_avg_decay
            with torch.no_grad():
                for n, p in self.named:
                    self.avg_params[n].mul_(d).add_(p.detach(), alpha=1.0 - d)
        self.step += 1
        return aux

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The eval loss and aux of a batch; on a mesh the global batch, its
        rows split over the data group (a batch with fewer rows than data
        ranks is evaluated whole on every rank)."""
        self.model.eval()
        data = self.data if self.mesh is not None and len(next(iter(batch.values()))) >= self.mesh.n_data else None
        if data is not None:
            batch = shard_batch(batch, self.mesh)
        with data_parallel(data):
            loss, aux = self.loss_fn(self.model, batch, None, False)
        if data is None:
            aux = dict(aux)
            aux["loss"] = loss
            return aux
        return self._reduce_aux(loss, aux)

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        return dict(
            model=self.model.state_dict(), optimizer=self.opt.state_dict(), step=self.step,
            n_updates=self.n_updates, generator=self.generator.get_state(), avg_params=self.avg_params,
            acc_grads=self.acc_grads, mini_step=self.mini_step, clip_history=self.clip_history,
            clip_count=self.clip_count,
        )

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.opt.load_state_dict(sd["optimizer"])
        self.step, self.n_updates = int(sd["step"]), int(sd["n_updates"])
        self.generator.set_state(sd["generator"].cpu() if hasattr(sd["generator"], "cpu") else sd["generator"])
        dev = self.device
        self.avg_params = None if sd["avg_params"] is None else {k: v.to(dev) for k, v in sd["avg_params"].items()}
        self.acc_grads = None if sd["acc_grads"] is None else [g.to(dev) for g in sd["acc_grads"]]
        self.mini_step = int(sd["mini_step"])
        self.clip_history = sd["clip_history"].to(dev)
        self.clip_count = int(sd["clip_count"])
