"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the GPU.  Raises when a CUDA device is asked for (or
    implied) and none is visible: the port never falls back to the CPU on
    its own — the caller passes ``device="cpu"`` to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    return dev


def hold_f32(dev: torch.device) -> None:
    """Make f32 mean f32 on a card: cuDNN's convolutions and cuBLAS's
    products would take TF32 (a 10-bit mantissa) by PyTorch's default.
    Process-wide, as the flags are; a no-op off the card."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
