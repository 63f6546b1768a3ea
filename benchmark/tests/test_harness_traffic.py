"""The one traffic generator: deterministic in ``--seed``, and the seed
changes ids, images and orders, never the sizes of the work."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import generate

BIG = 2 ** 40 + 3


def test_token_rows_are_deterministic_in_seed_and_step():
    a = generate.token_rows(BIG, 3, 2, 9, 50, "cpu")
    assert torch.equal(a, generate.token_rows(BIG, 3, 2, 9, 50, "cpu"))
    assert not torch.equal(a, generate.token_rows(BIG, 4, 2, 9, 50, "cpu"))
    assert not torch.equal(a, generate.token_rows(BIG + 1, 3, 2, 9, 50,
                                                  "cpu"))
    assert a.min() >= 0 and a.max() < 50


def test_image_set_and_order_are_deterministic():
    a = generate.image_set(BIG, 8, 4, 3, 10, "cpu")
    b = generate.image_set(BIG, 8, 4, 3, 10, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].dtype == torch.uint8 and a[0].shape == (8, 4, 4, 3)
    o = generate.image_order(BIG, 32, 4, 12)
    assert np.array_equal(o, generate.image_order(BIG, 32, 4, 12))
    assert not np.array_equal(o, generate.image_order(BIG + 1, 32, 4, 12))
    # one pass is a permutation: no row twice before every row once
    assert sorted(o[:8].ravel().tolist()) == list(range(32))
