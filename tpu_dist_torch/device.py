"""Device selection for the port's entry points: CUDA unless asked
otherwise."""

from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``. A CUDA device
    without CUDA raises: there is no silent CPU fallback, the caller asks
    for the CPU by passing ``device="cpu"``."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:   # "cuda" means the current device, by index
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
