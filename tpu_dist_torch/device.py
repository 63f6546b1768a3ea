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


# dense peak FLOP/s of a card by compute dtype (NVIDIA H100 SXM data sheet),
# for the trainers' MFU columns
PEAK_FLOPS = {"H100": {torch.bfloat16: 989e12, torch.float32: 67e12}}
# peak HBM bytes/s of a card (the same data sheet), for the cost model's
# roofline (obs.attr)
PEAK_BYTES = {"H100": 3.35e12}


def peak_flops(device: torch.device, dtype: torch.dtype):
    """The card's dense peak for ``dtype``, or None off CUDA and for a card
    the table does not hold."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((p.get(dtype) for k, p in PEAK_FLOPS.items() if k in name),
                None)


def peak_bytes(device: torch.device):
    """The card's peak memory rate in bytes/s, or None off CUDA and for a
    card the table does not hold."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((p for k, p in PEAK_BYTES.items() if k in name), None)
