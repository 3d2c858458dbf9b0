"""Model FLOPs of one call, counted on the reference at the cell's shapes.

Matrix products and convolutions, as `torch.utils.flop_counter` counts
them, on meta tensors (nothing is computed). The count is of the work the
model defines, whatever implements it: the fbank's DFT products, the CAM++
convolutions that the fused kernels run, the backends' products. A train
step counts three forwards.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import tsvad


def forward_flops(shapes: dict, model_cfg: dict, batch: int, samples: int, n_label: int) -> float:
    """FLOPs of one reference forward over `batch` windows of `samples`."""
    meta = torch.device("meta")
    P = {k: torch.empty(s, dtype=torch.float32 if d.is_floating_point else d, device=meta)
         for k, (s, d) in shapes.items()}
    audio = torch.empty(batch, samples, device=meta)
    embs = torch.empty(batch, model_cfg["max_num_speaker"], model_cfg["speaker_embed_dim"], device=meta)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        tsvad.forward(P, model_cfg, audio, embs, n_label, scan_rows=batch * model_cfg["max_num_speaker"])
    return float(counter.get_total_flops())


def call_flops(loop: str, shapes: dict, model_cfg: dict, batch: int, samples: int, n_label: int) -> float:
    f = forward_flops(shapes, model_cfg, batch, samples, n_label)
    return 3.0 * f if loop == "train" else f
