"""MobileNetV2, ShuffleNetV2 and EfficientNet of
``tpu_dist_torch/models/cnn_zoo.py`` against the flax reference on the
CPU, fp32 and bf16 (the archs, inputs, what is held and at what
tolerance: ``tests/torch_zoo_parity.py``)."""

from functools import partial

import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from tpu_dist_torch.interop import load_flax_image_params  # noqa: E402
from torch_zoo_parity import (FAMILIES, JDT, check_family,  # noqa: E402
                              close, inputs, params_of)

torch.set_num_threads(1)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("family", ["mobilenet_v2", "shufflenet_v2_x0_5",
                                    "efficientnet_b0"])
def test_family_matches_flax(family, precision):
    check_family(family, precision)


def test_efficientnet_eval_under_stochastic_depth_matches_flax():
    """At its default sd_max the eval forward is deterministic: the same
    logits as flax's from the same params and stats."""
    jctor, pctor, px, _ = FAMILIES["efficientnet_b0"]
    port = pctor(torch.float32, seed=0)
    params, stats = params_of(port)
    x, _ = inputs((px, px, 3))
    want = jax.jit(partial(jctor(JDT["fp32"]).apply, train=False))(
        {"params": params, "batch_stats": stats}, x)
    load_flax_image_params(port, params, stats)
    port.eval()
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    close(got, want, 1e-4, "eval logits")
