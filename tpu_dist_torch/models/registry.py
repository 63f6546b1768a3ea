"""Model factory for the port (``tpu_dist/models/registry.py``).

The same names and kinds as the reference's ``_REGISTRY``. Ported: the
ResNet family, LeNet (``lenet``, ``mnist_net``) and the LM
(``transformer_lm``, ``tiny_lm`` build the port's ``TransformerLM``). Every
other arch of the reference's registry is known by name and kind, and
:func:`create_model` raises ``NotImplementedError`` naming it and its JAX
module.

Image models take ``image_shape`` (H, W, C) at construction (flax infers
the input channels at init; a torch module needs them up front), a
``device`` and a ``seed`` for their random init.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from tpu_dist_torch.models import lenet, resnet

# name -> (port constructor, kind)
_REGISTRY: Dict[str, Tuple[Callable, str]] = {
    "resnet18": (resnet.ResNet18, "image"),
    "resnet34": (resnet.ResNet34, "image"),
    "resnet50": (resnet.ResNet50, "image"),
    "resnet101": (resnet.ResNet101, "image"),
    "resnet152": (resnet.ResNet152, "image"),
    "resnext50_32x4d": (resnet.ResNeXt50_32x4d, "image"),
    "resnext101_32x8d": (resnet.ResNeXt101_32x8d, "image"),
    "wide_resnet50_2": (resnet.WideResNet50_2, "image"),
    "wide_resnet101_2": (resnet.WideResNet101_2, "image"),
    "lenet": (lenet.LeNet, "image"),
    "mnist_net": (lenet.LeNet, "image"),  # reference 5.2 'Net' alias
    "transformer_lm": (None, "lm"),
    "tiny_lm": (None, "lm"),
}

# archs of the reference registry the port has not ported: name -> the JAX
# module that holds it
_UNPORTED = {
    **{n: "tpu_dist/models/cnn_zoo.py" for n in (
        "vgg11", "vgg13", "vgg16", "vgg19", "densenet121", "densenet161",
        "densenet169", "densenet201", "alexnet", "mobilenet_v2",
        "squeezenet1_0", "squeezenet1_1", "shufflenet_v2_x0_5",
        "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
        "efficientnet_b0")},
    "googlenet": "tpu_dist/models/inception.py",
    "inception_v3": "tpu_dist/models/inception.py",
    **{n: "tpu_dist/models/mobile.py" for n in (
        "mnasnet0_5", "mnasnet0_75", "mnasnet1_0", "mnasnet1_3",
        "mobilenet_v3_large", "mobilenet_v3_small")},
    **{n: "tpu_dist/models/vit.py" for n in (
        "vit_tiny", "vit_small", "vit_base", "vit_cifar")},
    "moe_lm": "tpu_dist/models/moe.py",
}

model_names = sorted({**_REGISTRY, **_UNPORTED})


def model_kind(arch: str) -> str:
    if arch in _REGISTRY:
        return _REGISTRY[arch][1]
    if arch in _UNPORTED:
        return "lm" if arch == "moe_lm" else "image"
    raise ValueError(f"unknown arch {arch!r}; choose from {model_names}")


def create_model(arch: str, num_classes: int = 10, dtype=torch.float32,
                 pretrained=False, image_shape=(32, 32, 3), **kwargs):
    """Build ``arch``: image models on ``image_shape`` input with
    ``num_classes`` outputs; LM archs take ``TransformerLM``'s keyword
    arguments. ``pretrained`` weights are not ported (the reference
    warm-starts from a local checkpoint)."""
    kind = model_kind(arch)
    if arch in _UNPORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: its model is "
            f"{_UNPORTED[arch]} in the JAX package")
    if pretrained:
        raise NotImplementedError(
            "pretrained is not ported yet: the reference warm-starts from a "
            "local checkpoint (engine.checkpoint.load_warmstart)")
    if kind == "lm":
        from tpu_dist_torch.models.transformer import TransformerLM, tiny_lm
        ctor = tiny_lm if arch == "tiny_lm" else TransformerLM
        return ctor(dtype=dtype, **kwargs)
    ctor = _REGISTRY[arch][0]
    if ctor is lenet.LeNet:
        return ctor(num_classes=num_classes, dtype=dtype,
                    image_shape=image_shape, **kwargs)
    return ctor(num_classes=num_classes, dtype=dtype,
                in_channels=image_shape[-1], **kwargs)
