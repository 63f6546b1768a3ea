"""The one traffic generator: every mix is a data file of parameters that
these functions read.

Every size of the work comes from the mix's file, never from ``--seed``:
the seed changes token ids, images, labels and the order of the training
rows, not the work.
"""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1


def mix64(*xs: int) -> int:
    """One 64-bit seed from several integers (splitmix64 over each)."""
    h = 0x9E3779B97F4A7C15
    for x in xs:
        z = (h + (int(x) & MASK64) + 0x9E3779B97F4A7C15) & MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
        h = z ^ (z >> 31)
    return h


def token_rows(seed: int, step: int, batch: int, length: int, vocab: int,
               device):
    """(batch, length) int64 token ids of one training step, uniform over
    the vocabulary, drawn on ``device`` from (seed, step)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(
        mix64(seed, step) >> 1)
    return torch.randint(0, vocab, (batch, length), generator=gen,
                         device=device)


def image_set(seed: int, n: int, size: int, channels: int, classes: int,
              device):
    """``n`` uint8 (size, size, channels) images and int64 labels, drawn on
    ``device`` in two calls."""
    import torch

    gen = torch.Generator(device=device).manual_seed(mix64(seed, 1) >> 1)
    images = torch.randint(0, 256, (n, size, size, channels),
                           generator=gen, device=device, dtype=torch.uint8)
    labels = torch.randint(0, classes, (n,), generator=gen, device=device)
    return images, labels


def image_order(seed: int, n: int, batch: int, steps: int) -> np.ndarray:
    """(steps, batch) row indices into an ``n``-image set: one shuffle per
    pass."""
    per_pass = n // batch
    out = []
    epoch = 0
    while len(out) < steps:
        perm = np.random.default_rng(mix64(seed, 2, epoch)).permutation(n)
        for s in range(per_pass):
            out.append(perm[s * batch:(s + 1) * batch])
            if len(out) == steps:
                break
        epoch += 1
    return np.stack(out).astype(np.int64)
