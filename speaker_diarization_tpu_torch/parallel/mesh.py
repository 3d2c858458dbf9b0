"""The process mesh: data parallelism and tensor parallelism over torch.distributed.

Counterpart of speaker_diarization_tpu/parallel/mesh.py. The JAX package
lays its devices out as a ('data', 'model') `jax.sharding.Mesh` and lets
GSPMD shard the batch over 'data' and the transformer's weights over
'model'. Here each device is one process (torchrun's contract: `RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), and the grid is
the global ranks in row-major order, rank = d · n_model + m:

- `init_distributed(device)` joins the process group: NCCL on a CUDA
  device, gloo only when the caller asked for the CPU. NCCL is never
  replaced by gloo on the card; if it does not initialise, the run fails;
- `make_mesh(n_data, n_model)` builds one process group per axis: this
  rank's data group (the ranks with its model index) and model group;
- `shard_batch(batch, mesh)`: the data rank r keeps rows
  [r·B/n, (r+1)·B/n) of the global batch, JAX's single-process meaning, so
  the global batch and its order are the single-device ones;
- `replicate(module, mesh)` broadcasts parameters and buffers from rank 0;
- `partition_params` / `shard_params` apply `DEFAULT_TP_RULES`, the port's
  counterparts of JAX `mesh.py:84-91`, over the 'model' axis. A parameter
  whose sharded dimension does not divide by the model size stays
  replicated (JAX `mesh.py:104-117`).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .collectives import AxisComm


def init_distributed(device: Optional[Union[str, torch.device]] = None,
                     init_method: Optional[str] = None) -> torch.device:
    """Join the process group of a torchrun launch → this rank's device.

    A CUDA device (the default) becomes `cuda:LOCAL_RANK` and the backend
    NCCL; `device='cpu'` takes gloo. `init_method` defaults to `env://`
    (MASTER_ADDR, MASTER_PORT). A group already joined is kept if its
    backend is the one the device needs."""
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA device needs the NCCL backend, which this torch build lacks")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"process group already joined with {dist.get_backend()}, {dev} needs {backend}")
        return dev
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world, rank=rank, **kwargs)
    return dev


def is_main_process() -> bool:
    """True outside a process group and on its rank 0: the one process that
    writes checkpoints, metrics and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclass
class Mesh:
    """This rank's place in the ('data', 'model') grid. `data` and `model`
    are the process groups of its two axes; `model` is None at n_model 1.
    A rank past n_data · n_model (JAX uses only the first devices) has
    neither and takes no part."""

    n_data: int
    n_model: int
    rank: int
    data: Optional[AxisComm]
    model: Optional[AxisComm]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def data_rank(self) -> int:
        return self.data.index if self.data is not None else 0

    @property
    def model_rank(self) -> int:
        return self.model.index if self.model is not None else 0

    @property
    def is_member(self) -> bool:
        return self.data is not None


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """A ('data', 'model') grid over the ranks of the joined process group.
    Every rank must call it with the same arguments (each creates every
    group, in the same order)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if not (n_data >= 1 and n_model >= 1 and n_data * n_model <= world):
        raise ValueError(f"mesh {n_data} x {n_model} does not fit {world} ranks")
    grid = np.arange(n_data * n_model).reshape(n_data, n_model)
    data = model = None
    for m in range(n_model):  # one data group per model index
        ranks = grid[:, m].tolist()
        group = dist.new_group(ranks)
        if rank in ranks:
            data = AxisComm(group, ranks, ranks.index(rank))
    if n_model > 1:
        for d in range(n_data):  # one model group per data index
            ranks = grid[d].tolist()
            group = dist.new_group(ranks)
            if rank in ranks:
                model = AxisComm(group, ranks, ranks.index(rank))
    return Mesh(n_data, n_model, rank, data, model)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This data rank's rows [r·B/n, (r+1)·B/n) of every array of a global
    batch of B (tensors or numpy arrays, batch axis first)."""
    B, r, n = len(next(iter(batch.values()))), mesh.data_rank, mesh.n_data
    return {k: v[r * B // n:(r + 1) * B // n] for k, v in batch.items()}


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every rank takes rank 0's parameters and buffers."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)
    return module


# (regex on the typed path of a parameter, the dimension of the torch tensor
# that is sharded, the attribute of the owning module that counts the blocks
# the dimension splits into; None: its size). The typed path joins
# `Class:name` per module down to the leaf, as flax paths carry the module
# classes ("FeedForward_0/Dense_0/kernel"). Linear weights are (out, in):
# column-parallel shards dim 0, row-parallel dim 1. Attention splits by head.
DEFAULT_TP_RULES = (
    (r"FeedForward:[^/]+/Linear:dense0/weight$", 0, None),
    (r"FeedForward:[^/]+/Linear:dense0/bias$", 0, None),
    (r"FeedForward:[^/]+/Linear:dense1/weight$", 1, None),
    (r"MultiHeadAttention:[^/]+/Linear:(query|key|value)/weight$", 0, "n_heads"),
    (r"MultiHeadAttention:[^/]+/Linear:(query|key|value)/bias$", 0, "n_heads"),
    (r"MultiHeadAttention:[^/]+/Linear:out/weight$", 1, "n_heads"),
)


def _owned_params(module: torch.nn.Module):
    """(name, typed path, owner of the Linear or the parameter, parameter)."""
    def walk(mod, names, typed, parents):
        for leaf, p in mod.named_parameters(recurse=False):
            owner = parents[-2] if len(parents) >= 2 else mod
            yield ".".join(names + [leaf]), "/".join(typed + [leaf]), owner, p
        for name, child in mod.named_children():
            yield from walk(child, names + [name], typed + [f"{type(child).__name__}:{name}"], parents + [child])

    yield from walk(module, [], [], [module])


def partition_params(module: torch.nn.Module, mesh: Mesh, rules=DEFAULT_TP_RULES) -> Dict[str, Optional[int]]:
    """{parameter name: the dimension sharded over 'model', or None for a
    replicated parameter}. The first rule that matches decides; a sharded
    dimension whose block count does not divide by n_model is replicated."""
    out: Dict[str, Optional[int]] = {}
    for name, path, owner, p in _owned_params(module):
        out[name] = None
        for pat, dim, blocks in rules:
            if re.search(pat, path):
                n = getattr(owner, blocks) if blocks else p.shape[dim]
                if mesh.n_model > 1 and n % mesh.n_model == 0:
                    out[name] = dim
                break
    return out


@torch.no_grad()
def shard_params(module: torch.nn.Module, mesh: Mesh, rules=DEFAULT_TP_RULES) -> frozenset:
    """Keep this model rank's slice of every parameter the rules shard, and
    put the modules that own them (FeedForward, MultiHeadAttention) in
    tensor-parallel mode over the model group. → the sharded names, also
    kept as `module.tp_sharded` for the Trainer's global norm."""
    spec = partition_params(module, mesh, rules)
    sharded = frozenset(n for n, d in spec.items() if d is not None)
    owners = {}
    for name, _, owner, p in _owned_params(module):
        if name in sharded:
            p.data = torch.chunk(p.data, mesh.n_model, dim=spec[name])[mesh.model_rank].contiguous()
            owners[id(owner)] = owner
    for owner in owners.values():
        if not hasattr(type(owner), "tp"):
            raise TypeError(f"{type(owner).__name__} has no tensor-parallel mode")
        owner.tp = mesh.model
    module.tp_sharded = sharded
    return sharded
