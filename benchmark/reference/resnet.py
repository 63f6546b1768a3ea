"""The plain reference of the bottleneck ResNet (torchvision plan, v1.5:
stride on the 3x3; ImageNet stem: 7x7/2 convolution, 3x3/2 max pool),
written from its description: BatchNorm over the batch with the fast
variance E[x^2] - E[x]^2 clipped at 0 and eps 1e-5, ReLU, global average
pool, a dense head; inputs (B, H, W, C) uint8 normalised by the
configuration's mean and std, then shifted and flipped as the
configuration's augmentation states.

It computes in float32 with TF32 off; ``mode="fp8"`` is the control:
every convolution's and the head's operands rounded to float8 (e4m3, one
scale a tensor) in the forward, the gradient passed straight through. It
imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.precision import fp8


def _q(x, mode):
    return fp8(x) if mode == "fp8" else x


def batch_norm(x, scale, bias, eps: float = 1e-5):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = torch.clamp((x * x).mean(dim=(0, 2, 3), keepdim=True)
                      - mean * mean, min=0.0)
    return ((x - mean) * torch.rsqrt(var + eps) * scale[:, None, None]
            + bias[:, None, None])


def conv(x, w, stride, pad, mode):
    return F.conv2d(_q(x, mode), _q(w, mode), None, stride, pad)


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, model: dict,
            mode: str = "fp32") -> torch.Tensor:
    """(B, H, W, C) float32 -> (B, classes) float32 logits."""
    x = x.permute(0, 3, 1, 2).contiguous()
    x = F.relu(batch_norm(conv(x, w["conv1.weight"], 2, 3, mode),
                          w["bn1.scale"], w["bn1.bias"]))
    x = F.max_pool2d(x, 3, 2, 1)
    cin = 64
    for stage, count in enumerate(model["stage_sizes"]):
        cout = 64 * 2 ** stage * 4
        for j in range(count):
            p = f"layer{stage + 1}_block{j}."
            stride = 2 if stage > 0 and j == 0 else 1

            def bn(y, k):
                return batch_norm(y, w[p + f"BatchNorm_{k}.scale"],
                                  w[p + f"BatchNorm_{k}.bias"])
            y = F.relu(bn(conv(x, w[p + "Conv_0.weight"], 1, 0, mode), 0))
            y = F.relu(bn(conv(y, w[p + "Conv_1.weight"], stride, 1, mode),
                          1))
            y = bn(conv(y, w[p + "Conv_2.weight"], 1, 0, mode), 2)
            if stride != 1 or cin != cout:
                x = batch_norm(conv(x, w[p + "downsample_conv.weight"],
                                    stride, 0, mode),
                               w[p + "downsample_bn.scale"],
                               w[p + "downsample_bn.bias"])
            x = F.relu(y + x)
            cin = cout
    x = x.mean(dim=(2, 3))
    return _q(x, mode) @ _q(w["fc.kernel"], mode) + w["fc.bias"]


def augment(images_u8: torch.Tensor, model: dict, aug_seed: int
            ) -> torch.Tensor:
    """Normalise, then (where the configuration augments) one shift of
    the whole batch by up to ``max_shift`` pixels (edge-padded) and a flip
    of each image with probability 1/2, both drawn from a CPU generator
    seeded ``aug_seed``: the shift's two offsets first, then the flip
    mask."""
    aug = model.get("augment")
    mean = torch.tensor(model["mean"], device=images_u8.device)
    std = torch.tensor(model["std"], device=images_u8.device)
    x = (images_u8.float() / 255.0 - mean) / std
    if not aug:
        return x
    gen = torch.Generator().manual_seed(aug_seed)
    s = aug["max_shift"]
    b, h, wd, _ = x.shape
    dy, dx = torch.randint(0, 2 * s + 1, (2,), generator=gen).tolist()
    x = F.pad(x.permute(0, 3, 1, 2), (s,) * 4, mode="replicate") \
        .permute(0, 2, 3, 1)[:, dy:dy + h, dx:dx + wd, :]
    flip = (torch.rand((b, 1, 1, 1), generator=gen) < 0.5).to(x.device)
    return torch.where(flip, x.flip(2), x)


def train_steps(w: Dict[str, torch.Tensor], batches: List[Tuple], model: dict,
                recipe: dict, mode: str = "fp32") -> dict:
    """SGD with momentum, the weight decay added to the gradient, on
    float32 copies of ``w`` over ``batches`` ((images, labels, aug seed)):
    each step's loss (mean over the batch), the first gradient's norm a
    leaf, and each leaf's change norm after the last step."""
    torch.backends.cudnn.benchmark = False
    names = list(w)
    params = [w[n].detach().float().clone().requires_grad_(True)
              for n in names]
    start = [p.detach().clone() for p in params]
    mom = [torch.zeros_like(p) for p in params]
    lr, mu, wd = recipe["lr"], recipe["momentum"], recipe["weight_decay"]
    losses, first = [], None
    for images, labels, aug_seed in batches:
        cur = dict(zip(names, params))
        logits = forward(cur, augment(images, model, aug_seed), model, mode)
        loss = F.cross_entropy(logits, labels)
        grads = torch.autograd.grad(loss, params)
        losses.append(loss.item())
        del logits, loss
        if first is None:
            first = {n: float(g.norm()) for n, g in zip(names, grads)}
        with torch.no_grad():
            for p, g, m in zip(params, grads, mom):
                m.mul_(mu).add_(g + wd * p)
                p.sub_(lr * m)
        del grads
    change = {n: float((p.detach() - s).norm())
              for n, p, s in zip(names, params, start)}
    return {"losses": losses, "grad_norms": first, "change_norms": change}
