"""Mixed-precision policy for the port (``tpu_dist/ops/precision.py``
``:35-57``, ``Policy`` and ``make_policy``).

* ``fp32``: params and compute in fp32;
* ``bf16``: fp32 master params, bf16 compute (each call casts the params,
  as flax does); LayerNorm statistics, softmax and logits stay fp32;
* ``bf16_params``: params stored in bf16 as well.

The reference's dynamic loss scaling belongs to the image trainer's fp16
path and is not ported yet (no LM configuration uses it).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

PRECISIONS = ("fp32", "bf16", "bf16_params")


@dataclass(frozen=True)
class Policy:
    """Dtype policy: where params live, where compute happens."""

    name: str = "fp32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.name in ("bf16", "bf16_params")
                else torch.float32)

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.name == "bf16_params" else torch.float32


def make_policy(name: str) -> Policy:
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {name!r} (fp32|bf16|bf16_params)")
    return Policy(name)
