"""Weights made by the benchmark from ``--seed``, on the device, in a few
large calls: one normal draw for every initialised leaf, cut into the
leaves and scaled. The same dict goes to the program (copied into its
parameters by name) and to the plain reference, so neither side takes
anything the other made.

Initialisers, each truncated at two standard deviations (``fmod`` folds
the tail back): the decoder's as GPT-2's (``lm_weights``); the ResNet's
conv and dense kernels lecun-normal, norm scales 1 and 0 for the last norm
of each residual block (the zero-init residual of the ImageNet recipe).
Biases and norm shifts 0.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def draw(shapes: Dict[str, Tuple[int, ...]], std: Dict[str, float],
         const: Dict[str, float], seed: int, device,
         dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Leaves of ``shapes``: those in ``std`` from one normal draw (scaled
    by their std, the tail folded at 2 std), those in ``const`` filled."""
    gen = _generator(seed, device)
    total = sum(math.prod(shapes[k]) for k in std)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    flat = torch.fmod(flat, 2.0)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name in std:
            n = math.prod(shape)
            out[name] = (flat[at:at + n].view(shape) * std[name]).to(dtype)
            at += n
        else:
            out[name] = torch.full(shape, const[name], device=device,
                                   dtype=dtype)
    return out


def lm_weights(shapes: Dict[str, Tuple[int, ...]], model: dict, seed: int,
               device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """GPT-2's initialisation: embeddings and kernels normal(0,
    ``init_std``), the residual projections (``proj``, ``mlp_out``) scaled
    by 1/sqrt(2 x layers)."""
    std, const = {}, {}
    resid = model["init_std"] / math.sqrt(2 * model["num_layers"])
    for name, shape in shapes.items():
        if name.endswith(("proj.kernel", "mlp_out.kernel")):
            std[name] = resid
        elif name.endswith(("emb.weight", ".kernel")):
            std[name] = model["init_std"]
        else:
            const[name] = 1.0 if name.endswith(".scale") else 0.0
    return draw(shapes, std, const, seed, device, dtype)


def resnet_shapes(model: dict) -> Dict[str, Tuple[int, ...]]:
    """The bottleneck ResNet's leaves by name (convs (out, in, kh, kw), the
    dense head (in, out)), in the layout of the ImageNet stem."""
    out = {"conv1.weight": (64, model["in_channels"], 7, 7),
           "bn1.scale": (64,), "bn1.bias": (64,)}
    cin = 64
    for stage, count in enumerate(model["stage_sizes"]):
        width = 64 * 2 ** stage
        cout = width * 4
        for j in range(count):
            p = f"layer{stage + 1}_block{j}."
            out[p + "Conv_0.weight"] = (width, cin, 1, 1)
            out[p + "BatchNorm_0.scale"] = (width,)
            out[p + "BatchNorm_0.bias"] = (width,)
            out[p + "Conv_1.weight"] = (width, width, 3, 3)
            out[p + "BatchNorm_1.scale"] = (width,)
            out[p + "BatchNorm_1.bias"] = (width,)
            out[p + "Conv_2.weight"] = (cout, width, 1, 1)
            out[p + "BatchNorm_2.scale"] = (cout,)
            out[p + "BatchNorm_2.bias"] = (cout,)
            if (stage > 0 and j == 0) or cin != cout:
                out[p + "downsample_conv.weight"] = (cout, cin, 1, 1)
                out[p + "downsample_bn.scale"] = (cout,)
                out[p + "downsample_bn.bias"] = (cout,)
            cin = cout
    out["fc.kernel"] = (cin, model["num_classes"])
    out["fc.bias"] = (model["num_classes"],)
    return out


def resnet_weights(model: dict, seed: int, device
                   ) -> Dict[str, torch.Tensor]:
    shapes = resnet_shapes(model)
    std, const = {}, {}
    for name, shape in shapes.items():
        if name.endswith(".weight") or name == "fc.kernel":
            fan_in = math.prod(shape[1:]) if len(shape) == 4 else shape[0]
            std[name] = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
        elif name.endswith("BatchNorm_2.scale"):
            const[name] = 0.0
        else:
            const[name] = 1.0 if name.endswith(".scale") else 0.0
    return draw(shapes, std, const, seed, device)


@torch.no_grad()
def load_into(named_params, weights: Dict[str, torch.Tensor]) -> int:
    """Copy ``weights`` into a module's parameters by name (each in its
    own dtype); every parameter must have a weight of its shape."""
    n = 0
    for name, p in named_params:
        w = weights.get(name)
        if w is None or tuple(w.shape) != tuple(p.shape):
            raise KeyError(f"no weight of shape {tuple(p.shape)} for {name}")
        p.copy_(w)
        n += 1
    if n != len(weights):
        raise KeyError(f"{len(weights) - n} weights matched no parameter")
    return n
