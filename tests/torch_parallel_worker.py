"""One rank of the port's gloo tests (tests/test_torch_parallel.py).

    python tests/torch_parallel_worker.py GROUP RANK WORLD PORT OUTDIR

Joins a gloo group of WORLD ranks on localhost:PORT through the port's
`init_distributed` (the torchrun environment), runs the scenarios of GROUP
and writes this rank's results to OUTDIR/GROUP_RANK.npz:

- `dp` (2 ranks): EEND at JAX multihost_worker's widths under
  `deterministic_reduce` from the weights in OUTDIR/eend_init.npz; EEND and
  a tiny TS-VAD with BatchNorm on the default all-reduce path, their frame
  masks different on the two shards;
- `tp` (4 ranks, 2 data × 2 model): a tiny TS-VAD with its transformer
  layers sharded over 'model', the sharded against the unsharded forward and
  20 steps on one batch; then ring attention over 4 data ranks.

The batches come from the helpers below, which the test also uses.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EEND_WIDTHS = dict(n_speakers=2, d_model=32, n_layers=1, n_heads=2, d_ff=64, dropout=0.0)
EEND_STEPS = 5
DP_STEPS = 6
TP_STEPS = 20
TSVAD_TINY = dict(transformer_embed_dim=32, transformer_ffn_embed_dim=64, num_attention_head=2, speaker_embed_dim=16,
                  num_transformer_layer=1, dropout=0.0, encoder_block_layers=(1, 1), fused_encoder_inference=False)
TSVAD_TP = dict(transformer_ffn_embed_dim=256, num_transformer_layer=1, encoder_block_layers=(2, 2),
                fused_encoder_inference=False)
RING_SHAPES = [(2, 64, 4, 16), (2, 128, 4, 16)]
# SGD: the conv bias before speech_down's BatchNorm has a gradient that is 0
# in exact arithmetic, and Adam would turn its rounding noise, which differs
# with the reduction order, into whole ±lr moves of that bias
TSVAD_DP_CFG = dict(optimizer="sgd", schedule="const", learning_rate=0.1)


def eend_batch(step: int, masked: bool = False) -> dict:
    """JAX multihost_worker's global batch 8 × 50 × 345; `masked` cuts the
    frame masks to lengths that differ between the two halves."""
    r = np.random.default_rng(1000 + step)
    B, T, F = 8, 50, 345
    b = dict(audio=r.standard_normal((B, T, F)).astype(np.float32) * 0.1,
             labels=(r.random((B, T, 2)) < 0.3).astype(np.float32),
             frame_mask=np.ones((B, T), np.float32), spk_mask=np.ones((B, 2), np.float32))
    if masked:
        lengths = [50, 50, 50, 50, 12, 30, 21, 44]
        b["frame_mask"] = (np.arange(T)[None] < np.array(lengths)[:, None]).astype(np.float32)
    return b


def tsvad_batch(B: int, seconds: float, S: int, E: int, seed: int, masked: bool = False) -> dict:
    r = np.random.default_rng(seed)
    T = int(seconds * 25)
    b = dict(audio=(0.1 * r.standard_normal((B, int(seconds * 16000)))).astype(np.float32),
             target_embs=r.standard_normal((B, S, E)).astype(np.float32),
             labels=(r.random((B, T, S)) < 0.3).astype(np.float32))
    if masked:
        lengths = np.where(np.arange(B) < B // 2, T, (np.arange(B) * 7) % T + 5)
        b["frame_mask"] = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    return b


def tsvad_masked_loss(n_label: int, freeze_encoder: bool = False):
    """TS-VAD's BCE over the valid frames of a frame mask."""
    from speaker_diarization_tpu_torch.ops import losses as L

    def loss_fn(model, batch, generator, train):
        logits = model(batch["audio"], batch["target_embs"], n_label, freeze_encoder=freeze_encoder and train,
                       generator=generator)
        return L.standard_bce(logits, batch["labels"], batch.get("frame_mask")), {}

    return loss_fn


def tensors(batch: dict) -> dict:
    import torch

    return {k: torch.from_numpy(v) for k, v in batch.items()}


def params_of(model) -> dict:
    return {f"param/{n}": p.detach().numpy().copy() for n, p in model.named_parameters()}


def _dp(rank: int, out: dict) -> None:
    from speaker_diarization_tpu_torch.models.eend import EENDModel
    from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
    from speaker_diarization_tpu_torch.parallel.mesh import make_mesh
    from speaker_diarization_tpu_torch.train.tasks import make_eend_loss
    from speaker_diarization_tpu_torch.train.trainer import Trainer, TrainerConfig
    from speaker_diarization_tpu_torch.utils import convert

    mesh = make_mesh(n_data=2)
    # (a) deterministic_reduce from JAX's weights
    model = EENDModel(**EEND_WIDTHS, device="cpu")
    model.load_state_dict(convert.eend_from_flax(convert.load_flax_npz(os.path.join(OUTDIR, "eend_init.npz"))))
    cfg = TrainerConfig(optimizer="adam", schedule="const", learning_rate=1e-3, seed=0, deterministic_reduce=True)
    trainer = Trainer(model, make_eend_loss(), cfg, mesh=mesh)
    out["det/losses"] = np.array([trainer.train_step(tensors(eend_batch(s)))["loss"].item() for s in range(EEND_STEPS)])
    out.update({f"det/{k}": v for k, v in params_of(model).items()})
    # (b) the default all-reduce path, frame masks that differ between the shards
    model = EENDModel(**EEND_WIDTHS, device="cpu", seed=3)
    trainer = Trainer(model, make_eend_loss(), TrainerConfig(optimizer="adam", schedule="const", learning_rate=1e-3),
                      mesh=mesh)
    out["eend/losses"] = np.array([trainer.train_step(tensors(eend_batch(s, True)))["loss"].item()
                                   for s in range(DP_STEPS)])
    out.update({f"eend/state/{k}": v.numpy().copy() for k, v in model.state_dict().items()})
    model = TSVADModel(TSVADConfig(**TSVAD_TINY), device="cpu", seed=4)
    trainer = Trainer(model, tsvad_masked_loss(25, freeze_encoder=True), TrainerConfig(**TSVAD_DP_CFG), mesh=mesh)
    losses = []
    for s in range(DP_STEPS):
        losses.append(trainer.train_step(tensors(tsvad_batch(8, 1.0, 4, 16, 50 + s, masked=True)))["loss"].item())
    out["tsvad/losses"] = np.array(losses)
    out["tsvad/eval_loss"] = np.array(trainer.eval_step(tensors(tsvad_batch(8, 1.0, 4, 16, 99, masked=True)))["loss"])
    out.update({f"tsvad/state/{k}": v.numpy().copy() for k, v in model.state_dict().items()})


def _tp(rank: int, out: dict) -> None:
    import torch

    from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
    from speaker_diarization_tpu_torch.parallel.mesh import make_mesh, partition_params, replicate, shard_params
    from speaker_diarization_tpu_torch.parallel.ring_attention import ring_self_attention
    from speaker_diarization_tpu_torch.train.trainer import Trainer, TrainerConfig

    # (c) 2 data x 2 model: JAX __graft_entry__.dryrun_multichip's tiny TS-VAD
    mesh = make_mesh(n_data=2, n_model=2)
    model = TSVADModel(TSVADConfig(**TSVAD_TP), device="cpu", seed=rank)  # rank 0's weights are broadcast
    replicate(model, mesh)
    batch = tsvad_batch(4, 1.0, 4, 192, 7)
    a, b = mesh.data_rank * 2, mesh.data_rank * 2 + 2
    with torch.no_grad():
        ref = model(torch.from_numpy(batch["audio"][a:b]), torch.from_numpy(batch["target_embs"][a:b]), 25)
    spec = partition_params(model, mesh)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    sharded = shard_params(model, mesh)
    with torch.no_grad():
        got = model(torch.from_numpy(batch["audio"][a:b]), torch.from_numpy(batch["target_embs"][a:b]), 25)
    out["tp/ref"], out["tp/got"] = ref.numpy(), got.numpy()
    out["tp/sharded"] = np.array(sorted(sharded))
    out["tp/spec_ok"] = np.array(all(
        (tuple(p.shape) == shapes[n]) == (spec[n] is None) for n, p in model.named_parameters()))
    out["tp/shrunk_ok"] = np.array(all(
        p.shape[spec[n]] * 2 == shapes[n][spec[n]] for n, p in model.named_parameters() if spec[n] is not None))
    trainer = Trainer(model, tsvad_masked_loss(25), TrainerConfig(optimizer="adam", schedule="const",
                                                                  learning_rate=2e-3), mesh=mesh)
    out["tp/losses"] = np.array([trainer.train_step(tensors(batch))["loss"].item() for _ in range(TP_STEPS)])
    out.update({f"tp/{k}": v for k, v in params_of(model).items()})
    # (d) ring attention over 4 data ranks
    ring = make_mesh(n_data=4)
    for B, T, H, D in RING_SHAPES:
        q, k, v, w = ring_inputs(B, T, H, D)
        n = T // 4
        blk = slice(ring.data_rank * n, (ring.data_rank + 1) * n)
        qs, ks, vs = (torch.from_numpy(x[:, blk]).requires_grad_() for x in (q, k, v))
        o = ring_self_attention(qs, ks, vs, ring)
        (o * torch.from_numpy(w[:, blk])).sum().backward()
        out[f"ring{T}/out"] = o.detach().numpy()
        for name, t in (("dq", qs), ("dk", ks), ("dv", vs)):
            out[f"ring{T}/{name}"] = t.grad.numpy()


def ring_inputs(B, T, H, D):
    r = np.random.default_rng(T)
    return tuple(r.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(4))


def main():
    global OUTDIR
    group, rank, world, port, OUTDIR = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=port)
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from speaker_diarization_tpu_torch.parallel.mesh import init_distributed

    init_distributed("cpu")
    out: dict = {}
    try:
        {"dp": _dp, "tp": _tp}[group](rank, out)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(OUTDIR, f"{group}_{rank}.npz"), **out)


OUTDIR = ""

if __name__ == "__main__":
    main()
