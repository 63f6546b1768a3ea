"""Input transforms for the port (``tpu_dist/data/pipeline.py``).

The step receives raw uint8 NHWC batches on the device and these functions
normalize (and, for ImageNet-named datasets, augment) them there, as the
reference does inside its jitted step. Each op rounds in ``dtype`` where
the reference's jnp op does.

Randomness comes from an explicit ``torch.Generator`` on the CPU: the
offsets of :func:`random_shift` and the flip mask of :func:`random_flip`
are drawn on the host and reach the device in a non-blocking copy, so
augmentation never syncs the device. JAX's PRNG cannot be matched, so the
augmented path is deterministic per generator but not comparable with the
reference; augmentation runs only for ImageNet-named datasets
(``tpu_dist/engine/loop.py:210``), so the CIFAR and MNIST paths are.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def normalize(images_u8: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
              dtype=torch.float32) -> torch.Tensor:
    """uint8 (B,H,W,C) -> normalized float, matching torchvision
    ToTensor+Normalize (``:29``)."""
    x = images_u8.to(dtype) / 255.0
    return (x - mean.to(dtype)) / std.to(dtype)


def random_flip(images: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Per-sample horizontal flip of (B,H,W,C) with probability 1/2
    (``:36``); the mask is drawn from the CPU generator ``gen``."""
    flip = torch.rand((images.shape[0], 1, 1, 1), generator=gen) < 0.5
    flip = flip.to(images.device, non_blocking=True)
    return torch.where(flip, images.flip(2), images)


def random_shift(images: torch.Tensor, gen: torch.Generator,
                 max_shift: int = 4) -> torch.Tensor:
    """One random translation of the whole (B,H,W,C) batch by up to
    ``max_shift`` pixels, edge-padded (``:42``: pad + dynamic slice); the
    offsets come from the CPU generator ``gen``."""
    if max_shift == 0:
        return images
    b, h, w, c = images.shape
    dy, dx = torch.randint(0, 2 * max_shift + 1, (2,), generator=gen).tolist()
    padded = F.pad(images.permute(0, 3, 1, 2),
                   (max_shift,) * 4, mode="replicate").permute(0, 2, 3, 1)
    return padded[:, dy:dy + h, dx:dx + w, :]


def make_transform(mean, std, augment: bool = False, max_shift: int = 4,
                   dtype=torch.float32, device=None):
    """``transform(images_u8, gen=None)`` for the train and eval steps
    (``:57``); ``mean``/``std`` are per-channel numpy arrays."""
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=device)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=device)

    def transform(images_u8: torch.Tensor,
                  gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = normalize(images_u8, mean_t, std_t, dtype)
        if augment and gen is not None:
            x = random_shift(x, gen, max_shift)
            x = random_flip(x, gen)
        return x

    return transform
