"""The yardstick's operation and byte counts against hand counts at one
small shape each, and the published counts at the cells' shapes."""

from __future__ import annotations

import json
import math
import os

import pytest

from benchmark import weights, work
from benchmark.tests import tiny

TINY_LM = {"vocab_size": 10, "num_layers": 1, "d_model": 4, "mlp_dim": 16,
           "max_len": 8}
H100 = "NVIDIA H100 80GB HBM3"


def _config(name):
    with open(os.path.join(tiny.BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_lm_params_and_train_flops_by_hand():
    # a layer: ln1 8 + qkv 48 + proj 16 + ln2 8 + mlp_in 80 + mlp_out 68;
    # ln_f 8 and the head 40 besides
    assert work.lm_nonembedding_params(TINY_LM) == 228 + 8 + 40
    assert work.lm_train_flops_per_token(TINY_LM, 8) == 6 * 276 + 6 * 8 * 4


def test_gpt2_medium_counts_match_the_configuration():
    cfg = _config("gpt2-medium")
    model = work.lm_model(cfg["model"])
    assert (model["d_model"], model["num_heads"], model["mlp_dim"],
            model["num_layers"], model["max_len"]) == (1024, 16, 4096, 24,
                                                      1024)
    shapes = work.lm_shapes(model)
    assert sum(math.prod(s) for s in shapes.values()) == cfg["params"]
    # GPT-2 medium's published 354,823,168 less the qkv and proj biases
    # (24 x 4,096), plus the untied head (1,024 x 50,257)
    assert cfg["params"] == 354_823_168 - 24 * 4096 + 1024 * 50257
    assert work.lm_nonembedding_params(model) == 353_676_288
    assert work.lm_train_flops_per_token(model, 1024) == 2_273_052_672


def test_attention_backward_by_hand():
    # B1 H2 L3 d4: 2 x 6 kept pairs, 4 products of 2 x d each; eight
    # (1, 3, 2, 4) bf16 tensors once and the fp32 row statistics
    flops, nbytes = work.attention_bwd_work(1, 2, 3, 4)
    assert work.causal_pairs(3) == 6
    assert flops == 4 * 2 * 12 * 4
    assert nbytes == 8 * 48 + 2 * 3 * 4


def test_resnet_forward_flops_by_hand():
    model = {"image_size": 8, "in_channels": 3, "stage_sizes": [1],
             "num_classes": 2}
    stem = 3 * 49 * 64 * 16                     # 7x7/2 to 4 x 4
    block = (64 * 64 + 64 * 9 * 64 + 64 * 256 + 64 * 256) * 4   # at 2 x 2
    assert work.resnet_forward_flops(model) == 2 * (stem + block + 256 * 2)


def test_resnet50_counts_match_the_published_ones():
    cfg = _config("resnet50-in224")
    # 4.089 GMACs (torchvision's ResNet-50 at 224 px, convs and the head)
    assert work.resnet_forward_flops(cfg["model"]) == 2 * 4_089_184_256
    shapes = weights.resnet_shapes(cfg["model"])
    assert sum(math.prod(s) for s in shapes.values()) == cfg["params"]


def test_bound_is_the_larger_of_compute_and_memory():
    assert work.bound_s(1e12, 1e9, H100) == pytest.approx(1e12 / 989e12)
    assert work.bound_s(1e9, 1e12, H100) == pytest.approx(1e12 / 3.35e12)
    with pytest.raises(KeyError):
        work.peak("cpu", "bf16")
