"""Seeded weights, made on the device in two bulk draws.

The benchmark makes every weight and BatchNorm statistic from the seed and
hands the same tensors to the measured model and to the reference. Only the
names and shapes come from the measured model's state_dict. The rules are
those of the measured package's seeded init, so activations keep their
scale through the full depth:

- matrices and kernels N(0, 1/fan_in), fan_in the size of one output row;
- biases and BatchNorm running means 0.1·N(0, 1); norm scales 1 + 0.1·N(0, 1);
- BatchNorm running variances 1 + U(0, 0.2);
- Mamba's A_log log(1..N) on every channel and D ones, as Mamba initialises them.

For a model run in eval mode, `calibrate_bn` then sets the BatchNorm running
statistics from a seeded calibration batch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def stream(seed: int, tag: int) -> int:
    """A 63-bit generator seed for one use of the run's seed."""
    return int(np.random.SeedSequence([seed, tag]).generate_state(2, np.uint32).view(np.uint64)[0] >> 1)


def make_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: (shape, dtype)} → {name: tensor} on `device`, from `seed`."""
    g = torch.Generator(device=device).manual_seed(stream(seed, 1))
    total = sum(int(np.prod(s)) for s, _ in shapes.values())
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, (shape, dtype) in shapes.items():
        n = int(np.prod(shape))
        z, u = normal[at: at + n].view(shape), uniform[at: at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            t = torch.zeros(shape, device=device)
        elif leaf == "A_log" and len(shape) == 2:
            t = torch.log(torch.arange(1, shape[1] + 1, device=device, dtype=torch.float32)).expand(shape)
        elif leaf == "D":
            t = torch.ones(shape, device=device)
        elif leaf == "running_var":
            t = 1.0 + 0.2 * u
        elif leaf in ("running_mean", "bias"):
            t = 0.1 * z
        elif leaf == "weight" and len(shape) == 1:
            t = 1.0 + 0.1 * z
        elif len(shape) >= 2:
            t = z / float(np.prod(shape[1:])) ** 0.5
        else:
            raise ValueError(f"no rule for the weight {name} of shape {shape}")
        out[name] = t.to(dtype).contiguous()
    return out


VAR_MARGIN = 1.5  # running variance over the calibration batch's variance


def calibrate_bn(P: Dict[str, torch.Tensor], model_cfg: dict, batch: Dict[str, torch.Tensor]) -> None:
    """Set every BatchNorm's running mean to the batch mean the reference
    meets on `batch`, layer by layer, and its running variance to VAR_MARGIN
    times the batch variance.

    Seeded running statistics do not match the activations: eval-mode
    BatchNorm then shrinks them layer by layer and the frames no longer
    follow the audio. Statistics that match exactly normalise every one of
    CAM++'s 52 dense layers to unit variance, where a random network is
    chaotic: a 1e-3 change of the fbank moves the frames by 3.5%, bfloat16
    rounding by 16%. At 1.5 times the variance the network is just on the
    ordered side: replacing the audio by noise moves the frames by a third
    of their norm, and bfloat16 moves them by about 1%."""
    from .reference import tsvad

    stats: dict = {}
    with torch.no_grad(), tsvad.exact_fp32():
        tsvad.forward(P, model_cfg, batch["audio"], batch["target_embs"], batch["labels"].shape[1], train=True,
                      stats=stats, scan_rows=batch["audio"].shape[0] * model_cfg["max_num_speaker"])
    for name, (mean, var) in stats.items():
        P[name + ".running_mean"].copy_(mean)
        P[name + ".running_var"].copy_(VAR_MARGIN * var)


def shapes_of(module: torch.nn.Module) -> Dict[str, tuple]:
    return {k: (tuple(v.shape), v.dtype) for k, v in module.state_dict().items()}
