"""Model factory for the port (``tpu_dist/models/registry.py``).

The same names and kinds as the reference's ``_REGISTRY``: every image
arch (the ResNet family, the CNN zoo of ``models/cnn_zoo.py``,
``models/inception.py`` and ``models/mobile.py``, the ViTs of
``models/vit.py``, LeNet) and the LMs (``transformer_lm``, ``tiny_lm``
build the port's ``TransformerLM``, ``moe_lm`` its ``MoETransformerLM``).
Every arch of the reference's registry is ported (``_UNPORTED`` is
empty).

Image models take their input geometry at construction (flax infers it at
init; a torch module needs it up front): LeNet and the ViTs the whole
``image_shape`` (H, W, C), the CNNs its channels. They also take a
``device`` and a ``seed`` for their random init.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from tpu_dist_torch.models import (cnn_zoo, inception, lenet, mobile,
                                   resnet, vit)

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
    "vgg11": (cnn_zoo.VGG11, "image"),
    "vgg13": (cnn_zoo.VGG13, "image"),
    "vgg16": (cnn_zoo.VGG16, "image"),
    "vgg19": (cnn_zoo.VGG19, "image"),
    "densenet121": (cnn_zoo.DenseNet121, "image"),
    "densenet161": (cnn_zoo.DenseNet161, "image"),
    "densenet169": (cnn_zoo.DenseNet169, "image"),
    "densenet201": (cnn_zoo.DenseNet201, "image"),
    "alexnet": (cnn_zoo.AlexNet, "image"),
    "googlenet": (inception.GoogLeNet, "image"),
    "inception_v3": (inception.InceptionV3, "image"),
    "mnasnet0_5": (mobile.MnasNet0_5, "image"),
    "mnasnet0_75": (mobile.MnasNet0_75, "image"),
    "mnasnet1_0": (mobile.MnasNet1_0, "image"),
    "mnasnet1_3": (mobile.MnasNet1_3, "image"),
    "mobilenet_v2": (cnn_zoo.MobileNetV2, "image"),
    "mobilenet_v3_large": (mobile.MobileNetV3Large, "image"),
    "mobilenet_v3_small": (mobile.MobileNetV3Small, "image"),
    "squeezenet1_0": (cnn_zoo.SqueezeNet1_0, "image"),
    "squeezenet1_1": (cnn_zoo.SqueezeNet1_1, "image"),
    "shufflenet_v2_x0_5": (cnn_zoo.ShuffleNetV2_x0_5, "image"),
    "shufflenet_v2_x1_0": (cnn_zoo.ShuffleNetV2_x1_0, "image"),
    "shufflenet_v2_x1_5": (cnn_zoo.ShuffleNetV2_x1_5, "image"),
    "shufflenet_v2_x2_0": (cnn_zoo.ShuffleNetV2_x2_0, "image"),
    "efficientnet_b0": (cnn_zoo.EfficientNet, "image"),
    "lenet": (lenet.LeNet, "image"),
    "mnist_net": (lenet.LeNet, "image"),  # reference 5.2 'Net' alias
    "vit_tiny": (vit.ViTTiny, "image"),
    "vit_small": (vit.ViTSmall, "image"),
    "vit_base": (vit.ViTBase, "image"),
    "vit_cifar": (vit.ViTCifar, "image"),
    "transformer_lm": (None, "lm"),
    "tiny_lm": (None, "lm"),
    "moe_lm": (None, "lm"),
}

# archs of the reference registry the port has not ported: name -> the JAX
# module that holds it
_UNPORTED: Dict[str, str] = {}

model_names = sorted({**_REGISTRY, **_UNPORTED})


def model_kind(arch: str) -> str:
    if arch in _REGISTRY:
        return _REGISTRY[arch][1]
    if arch in _UNPORTED:
        return "lm"
    raise ValueError(f"unknown arch {arch!r}; choose from {model_names}")


def create_model(arch: str, num_classes: int = 10, dtype=torch.float32,
                 pretrained=False, image_shape=(32, 32, 3), **kwargs):
    """Build ``arch``: image models on ``image_shape`` input with
    ``num_classes`` outputs; LM archs take ``TransformerLM``'s keyword
    arguments. This factory builds architecture only: the trainers graft
    a ``pretrained`` checkpoint onto the fresh model (``engine.checkpoint``
    ``load_warmstart`` and ``graft_params``), so a caller passing one here
    is refused rather than handed fresh weights."""
    kind = model_kind(arch)
    if arch in _UNPORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: its model is "
            f"{_UNPORTED[arch]} in the JAX package")
    if pretrained:
        raise ValueError(
            f"create_model does not load weights (pretrained={pretrained!r}):"
            " Trainer and LMTrainer graft a local checkpoint of the port "
            "(--pretrained PATH, e.g. an {arch}-model_best.pt) onto the "
            "init; elsewhere use engine.checkpoint.load_warmstart + "
            "graft_params. Downloaded weights are not fetched.")
    if kind == "lm":
        from tpu_dist_torch.models.moe import MoETransformerLM
        from tpu_dist_torch.models.transformer import TransformerLM, tiny_lm
        ctor = {"tiny_lm": tiny_lm, "moe_lm": MoETransformerLM}.get(
            arch, TransformerLM)
        return ctor(dtype=dtype, **kwargs)
    ctor = _REGISTRY[arch][0]
    if ctor is lenet.LeNet or arch.startswith("vit"):
        return ctor(num_classes=num_classes, dtype=dtype,
                    image_shape=image_shape, **kwargs)
    return ctor(num_classes=num_classes, dtype=dtype,
                in_channels=image_shape[-1], **kwargs)
