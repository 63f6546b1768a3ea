"""The port's model zoo (``tpu_dist_torch/models/{cnn_zoo,inception,
mobile,vit}.py``) against the reference registry, without compiling:

* the 20 published torchvision parameter counts of
  ``tests/test_models.py`` (port only: no JAX);
* every one of the 29 image archs the port added builds a param tree and
  a ``batch_stats`` tree whose paths and shapes equal flax's, as
  ``jax.eval_shape`` of the flax init gives them (so every count is equal
  too);
* the export/load round trip is lossless for each of the 29.

Numeric parity against flax is in ``tests/test_torch_zoo_parity.py``.
"""

import numpy as np
import pytest
import torch

from tpu_dist_torch.interop import (export_flax_image_params,
                                    load_flax_image_params)
from tpu_dist_torch.models.registry import _UNPORTED, create_model

torch.set_num_threads(1)

# torchvision's published trainable-parameter counts at 1000 classes
# (tests/test_models.py's table; VGG and AlexNet have the GAP head instead)
TORCHVISION_PARAMS = {
    "densenet121": 7_978_856,
    "densenet161": 28_681_000,
    "densenet169": 14_149_480,
    "densenet201": 20_013_928,
    "squeezenet1_0": 1_248_424,
    "squeezenet1_1": 1_235_496,
    "shufflenet_v2_x0_5": 1_366_792,
    "shufflenet_v2_x1_0": 2_278_604,
    "shufflenet_v2_x1_5": 3_503_624,
    "shufflenet_v2_x2_0": 7_393_996,
    "mobilenet_v2": 3_504_872,
    "efficientnet_b0": 5_288_548,
    "googlenet": 6_624_904,
    "inception_v3": 23_834_568,   # the published count less the aux head
    "mnasnet0_5": 2_218_512,
    "mnasnet0_75": 3_170_208,
    "mnasnet1_0": 4_383_312,
    "mnasnet1_3": 6_282_256,
    "mobilenet_v3_large": 5_483_032,
    "mobilenet_v3_small": 2_542_856,
}
NEW_ARCHS = sorted(TORCHVISION_PARAMS) + [
    "vgg11", "vgg13", "vgg16", "vgg19", "alexnet", "vit_tiny", "vit_small",
    "vit_base", "vit_cifar"]


def _shape(arch):
    """A small input the arch takes (inception_v3's VALID stem needs
    75 px; the ViTs' pos_embed follows the token count)."""
    if arch == "inception_v3":
        return (96, 96, 3)
    if arch.startswith("vit") and arch != "vit_cifar":
        return (48, 48, 3)        # 16 px patches: 9 tokens + cls
    return (32, 32, 3)


def _port(arch, num_classes=10, seed=None):
    return create_model(arch, num_classes=num_classes, device="cpu",
                        image_shape=_shape(arch), seed=seed)


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(np.shape(v))
    return out


def test_only_moe_lm_stays_unported():
    # moe_lm was the last: every arch of the reference's registry is ported
    assert set(_UNPORTED) == set()
    assert len(NEW_ARCHS) == 29
    assert type(create_model("moe_lm", device="cpu", vocab_size=64,
                             max_len=16)).__name__ == "MoETransformerLM"


@pytest.mark.parametrize("arch", sorted(TORCHVISION_PARAMS))
def test_param_count_matches_published(arch):
    m = _port(arch, num_classes=1000)
    assert sum(p.numel() for p in m.parameters()) == TORCHVISION_PARAMS[arch]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_trees_match_flax_eval_shape(arch):
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    import jax.numpy as jnp

    from tpu_dist.models.registry import create_model as jax_create

    ref = jax_create(arch, num_classes=10)
    shapes = jax.eval_shape(
        lambda k: ref.init(k, jnp.zeros((1, *_shape(arch))), train=False),
        jax.random.PRNGKey(0))
    params, stats = export_flax_image_params(_port(arch))
    assert _paths(params) == _paths(shapes["params"])
    assert _paths(stats) == _paths(shapes.get("batch_stats", {}))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_export_load_round_trip_is_lossless(arch):
    src = _port(arch)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():            # every leaf distinct, stats included
        for t in [*src.parameters(), *src.buffers()]:
            t.copy_(torch.rand(t.shape, generator=gen))
    params, stats = export_flax_image_params(src)
    dst = load_flax_image_params(_port(arch), params, stats)
    for (n, a), (_, b) in zip(src.state_dict().items(),
                              dst.state_dict().items()):
        assert torch.equal(a, b), n
    # a leaf of the wrong shape is refused with its path
    first = next(iter(_paths(params)))
    node = params
    for k in first.split("/")[:-1]:
        node = node[k]
    leaf = first.split("/")[-1]
    shape = np.shape(node[leaf])
    node[leaf] = np.zeros(shape[:-1] + (shape[-1] + 1,), np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        load_flax_image_params(_port(arch), params, stats)
