"""The control's precision: float8 e4m3 rounding with one scale a tensor
(its largest magnitude mapped to 448), the gradient passed straight
through."""

from __future__ import annotations

import torch

FP8_MAX = 448.0


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Round.apply(x)
