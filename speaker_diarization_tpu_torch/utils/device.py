"""Device selection and numeric settings shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DTYPES = {"float32": torch.float32, "fp32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on.

    None means CUDA: with no CUDA device this raises instead of running on
    the CPU. The CPU is used only when the caller asks for it.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless device='cpu' "
                "(--device cpu) is passed explicitly"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        set_fp32_precision()
    return dev


def set_fp32_precision() -> None:
    """Full-fp32 matmuls and convolutions on the GPU.

    cuDNN convolutions default to TF32, which keeps about three decimal
    digits; the fbank and CAM++ parity contracts do not survive it.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
        return dtype
    if dtype not in DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}; one of {sorted(DTYPES)}")
    return DTYPES[dtype]
