"""ResNet family for the port (``tpu_dist/models/resnet.py``).

The reference is a flax NHWC model; this one takes the same (B, H, W, C)
input and runs NCHW-shaped tensors in ``channels_last`` memory, so cuDNN
gets NHWC convolutions. Modules carry flax's names (``conv1``, ``bn1``,
``layer{i}_block{j}`` with ``Conv_k``/``BatchNorm_k``/``GroupNorm_k``,
``downsample_conv``/``downsample_bn``, ``fc``), so
:func:`tpu_dist_torch.interop.load_flax_image_params` maps a flax tree onto
the model name for name. Numerics follow flax 0.12.3:

* **BatchNorm** (:class:`BatchNorm`): statistics in fp32 with the fast
  variance ``max(0, E[x^2] - E[x]^2)`` (biased, not torch's unbiased
  running variance), eps 1e-5, running stats blended as ``0.9 old + 0.1
  batch`` (flax ``momentum=0.9``: torch's ``momentum=0.1`` with the roles
  inverted), output in ``norm_dtype``. The running buffers ``mean`` and
  ``var`` are the reference's ``batch_stats``. With ``process_group`` set
  (the data-parallel ``jit`` step over several ranks) the statistics are
  those of the group's whole batch: the per-rank sums are all-reduced, and
  so are their gradients in the backward;
* **GroupNorm(32)** (:class:`GroupNorm`): the same statistics per (sample,
  group), no running state;
* convs and the dense head compute in ``dtype`` (bf16 under
  ``precision="bf16"``) over fp32 masters cast at each call, as flax does;
  padding is explicit ``[(1,1),(1,1)]`` for 3x3 and 7x7 (3) convs, the
  s2d conv is VALID, 1x1 convs need none; ``max_pool`` pads with -inf;
  the global average pool runs over the ``norm_dtype`` activations and the
  logits come out fp32;
* the last norm ``scale`` of each block is zero-initialised (``:48,83``);
  convs and dense layers are lecun-normal, biases zero.

Stems: ``imagenet`` (7x7/s2 + 3x3/s2 max pool), ``cifar`` (3x3/s1) and
``s2d`` (pad 3, 2x2 space-to-depth with channels in (u, v, c) order, 4x4
VALID conv, max pool). Bottleneck takes ``groups``/``base_width``, so the
ResNeXt and Wide-ResNet plans of ``:179-193`` come with it.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpu_dist_torch.device import resolve_device
from tpu_dist_torch.ops.quant import make_dense


class Conv(nn.Module):
    """flax ``nn.Conv`` over channels_last NCHW tensors. ``weight`` is
    (out, in/groups, kh, kw) in ``param_dtype`` (the flax HWIO kernel,
    transposed); optional ``bias``. Computes in ``dtype``. ``kernel`` and
    ``padding`` (symmetric, per side) are an int or an (h, w) pair."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride: int = 1,
                 padding=0, groups: int = 1, use_bias: bool = False,
                 dtype=torch.float32, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.weight = nn.Parameter(torch.empty(
            out_ch, in_ch // groups, kh, kw, dtype=param_dtype,
            device=device), requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(out_ch, dtype=param_dtype,
                                              device=device),
                                  requires_grad=False)
                     if use_bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's ``lecun_normal``: truncated normal (2 std) with variance
        1/fan_in, fan_in = (in/groups) * kh * kw; bias zeros."""
        fan_in = self.weight[0].numel()
        std = math.sqrt(1.0 / fan_in) / .87962566103423978
        with torch.no_grad():
            w = torch.empty(self.weight.shape, dtype=torch.float32,
                            device=self.weight.device)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            self.weight.copy_(w)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), w, b, self.stride, self.padding,
                        groups=self.groups)


def _stats(xf, dims):
    """flax ``_compute_stats`` (fast variance): fp32 mean and
    ``max(0, E[x^2] - E[x]^2)`` over ``dims``."""
    mean = xf.mean(dim=dims)
    var = torch.clamp(xf.square().mean(dim=dims) - mean * mean, min=0.0)
    return mean, var


class _GroupSum(torch.autograd.Function):
    """The sum of ``x`` over a process group, whose backward sums the
    incoming gradient over the group in turn (every rank's loss depends on
    every rank's contribution)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _global_stats(xf, group):
    """:func:`_stats` over the batch of every rank of ``group``: the
    per-rank sums of x and x^2 and the count, summed over the group in one
    all-reduce (the statistics of the reference's ``jit`` step, whose one
    program spans the global batch)."""
    count = xf.new_full((1,), xf.numel() / xf.shape[1])
    sums = _GroupSum.apply(torch.cat([xf.sum(dim=(0, 2, 3)),
                                      xf.square().sum(dim=(0, 2, 3)),
                                      count]), group)
    c = xf.shape[1]
    n = sums[2 * c]
    mean = sums[:c] / n
    var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
    return mean, var


def _normalize(xf, mean, var, scale, bias, eps, dtype):
    """flax ``_normalize``: ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` in fp32, stored in ``dtype``. ``mean``/``var`` broadcast over
    (B, C, H, W)."""
    mul = torch.rsqrt(var + eps) * scale.float()[:, None, None]
    return ((xf - mean) * mul + bias.float()[:, None, None]).to(dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` (module
    docstring). Train mode normalizes by the batch statistics and blends
    them into the ``mean``/``var`` buffers; eval mode reads the buffers."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype=torch.float32, zero_scale=False,
                 device=None, param_dtype=torch.float32):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        init = torch.zeros if zero_scale else torch.ones
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(init(features, dtype=param_dtype,
                                       device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                             device=device),
                                 requires_grad=False)
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        # set by a data-parallel trainer whose step spans the group's batch
        self.process_group = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x):
        xf = x.float()
        if self.training and self.process_group is not None:
            mean, var = _global_stats(xf, self.process_group)
        elif self.training:
            mean, var = _stats(xf, (0, 2, 3))
        if self.training:
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        return _normalize(xf, mean[:, None, None], var[:, None, None],
                          self.scale, self.bias, self.eps, self.dtype)


def set_batchnorm_group(model: nn.Module, group) -> int:
    """Point every :class:`BatchNorm` of ``model`` at ``group`` (None: per
    rank statistics); returns how many there are."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.process_group = group
    return len(norms)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=32, epsilon=1e-5)``: statistics per
    (sample, group) over H, W and the group's channels."""

    def __init__(self, features: int, num_groups: int = 32,
                 eps: float = 1e-5, dtype=torch.float32, zero_scale=False,
                 device=None, param_dtype=torch.float32):
        super().__init__()
        if features % num_groups:
            raise ValueError(f"GroupNorm: {num_groups} groups do not divide "
                             f"{features} channels")
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.zero_scale = zero_scale
        init = torch.zeros if zero_scale else torch.ones
        self.scale = nn.Parameter(init(features, dtype=param_dtype,
                                       device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                             device=device),
                                 requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()

    def forward(self, x):
        b, c, h, w = x.shape
        xf = x.float()
        mean, var = _stats(xf.reshape(b, self.num_groups, -1, h, w),
                           (2, 3, 4))
        per = c // self.num_groups
        mean = mean.repeat_interleave(per, dim=1)[:, :, None, None]
        var = var.repeat_interleave(per, dim=1)[:, :, None, None]
        return _normalize(xf, mean, var, self.scale, self.bias, self.eps,
                          self.dtype)


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3 -> 3x3, identity or 1x1 shortcut
    (expansion 1); ``tpu_dist/models/resnet.py:32``."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int, conv, norm,
                 norm_name: str):
        super().__init__()
        self.Conv_0 = conv(in_ch, filters, 3, stride, 1)
        setattr(self, f"{norm_name}_0", norm(filters))
        self.Conv_1 = conv(filters, filters, 3, 1, 1)
        setattr(self, f"{norm_name}_1", norm(filters, zero_scale=True))
        self.norms = (f"{norm_name}_0", f"{norm_name}_1")
        self.downsample = stride != 1 or in_ch != filters
        if self.downsample:
            self.downsample_conv = conv(in_ch, filters, 1, stride, 0)
            self.downsample_bn = norm(filters)

    def forward(self, x):
        n0, n1 = (getattr(self, n) for n in self.norms)
        y = F.relu(n0(self.Conv_0(x)))
        y = n1(self.Conv_1(y))
        res = (self.downsample_bn(self.downsample_conv(x))
               if self.downsample else x)
        return F.relu(y + res)


class Bottleneck(nn.Module):
    """torchvision Bottleneck (v1.5, stride on the 3x3): 1x1 -> 3x3 ->
    1x1, expansion 4; ``groups``/``base_width`` give the inner width
    ``filters * base_width/64 * groups`` and a grouped 3x3
    (``tpu_dist/models/resnet.py:56``)."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int, conv, norm,
                 norm_name: str, groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(filters * (base_width / 64.0)) * groups
        out = filters * self.expansion
        self.Conv_0 = conv(in_ch, width, 1, 1, 0)
        setattr(self, f"{norm_name}_0", norm(width))
        self.Conv_1 = conv(width, width, 3, stride, 1, groups=groups)
        setattr(self, f"{norm_name}_1", norm(width))
        self.Conv_2 = conv(width, out, 1, 1, 0)
        setattr(self, f"{norm_name}_2", norm(out, zero_scale=True))
        self.norms = tuple(f"{norm_name}_{k}" for k in range(3))
        self.downsample = stride != 1 or in_ch != out
        if self.downsample:
            self.downsample_conv = conv(in_ch, out, 1, stride, 0)
            self.downsample_bn = norm(out)

    def forward(self, x):
        n0, n1, n2 = (getattr(self, n) for n in self.norms)
        y = F.relu(n0(self.Conv_0(x)))
        y = F.relu(n1(self.Conv_1(y)))
        y = n2(self.Conv_2(y))
        res = (self.downsample_bn(self.downsample_conv(x))
               if self.downsample else x)
        return F.relu(y + res)


class ResNet(nn.Module):
    """torchvision-plan ResNet on (B, H, W, C) input; returns fp32 logits.

    ``stage_sizes``/``block_cls`` follow torchvision (resnet50 =
    Bottleneck [3,4,6,3]); ``stem`` is ``imagenet`` | ``cifar`` | ``s2d``
    (``""``: ``cifar_stem`` decides, as in the reference); ``norm`` is
    ``bn`` | ``gn``; ``norm_dtype`` None keeps fp32 norm outputs,
    ``torch.bfloat16`` stores them in bf16 (statistics stay fp32)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 10, dtype=torch.float32,
                 cifar_stem: bool = False, stem: str = "", norm: str = "bn",
                 norm_dtype=None, in_channels: int = 3, device=None,
                 seed: Optional[int] = 0, param_dtype=torch.float32,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.stem = stem or ("cifar" if cifar_stem else "imagenet")
        if self.stem not in ("imagenet", "cifar", "s2d"):
            raise ValueError(f"unknown stem {self.stem!r} (imagenet|cifar|s2d)")
        ndt = norm_dtype or torch.float32
        pd = dict(device=device, param_dtype=param_dtype)
        if norm == "gn":
            norm_fn, norm_name = partial(GroupNorm, dtype=ndt, **pd), "GroupNorm"
        elif norm == "bn":
            norm_fn, norm_name = partial(BatchNorm, dtype=ndt, **pd), "BatchNorm"
        else:
            raise ValueError(f"unknown norm {norm!r} (bn|gn)")

        def conv(i, o, k, s=1, p=0, groups=1):
            return Conv(i, o, k, s, p, groups, dtype=dtype, **pd)

        if self.stem == "cifar":
            self.conv1 = conv(in_channels, 64, 3, 1, 1)
        elif self.stem == "s2d":
            self.conv1 = conv(4 * in_channels, 64, 4, 1, 0)
        else:
            self.conv1 = conv(in_channels, 64, 7, 2, 3)
        self.bn1 = norm_fn(64)
        self.block_names = []
        ch = 64
        block_kw = ({"groups": groups, "base_width": base_width}
                    if block_cls is Bottleneck else {})
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                name = f"layer{i + 1}_block{j}"
                setattr(self, name, block_cls(ch, 64 * 2 ** i, stride, conv,
                                              norm_fn, norm_name, **block_kw))
                self.block_names.append(name)
                ch = 64 * 2 ** i * block_cls.expansion
        self.fc = make_dense(ch, num_classes, dtype=dtype, device=device,
                             param_dtype=param_dtype)
        self.requires_grad_(False)
        if seed is not None:
            self.init_weights(seed)

    def init_weights(self, seed: int) -> None:
        """Random weights from ``seed`` with flax's initializers."""
        gen = torch.Generator(device=self.fc.kernel.device).manual_seed(
            int(seed))
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

    def forward(self, x):
        x = x.to(self.dtype)
        if self.stem == "s2d":
            b, h, w, c = x.shape
            if h % 2 or w % 2:
                raise ValueError(f"s2d stem needs even H,W, got {h}x{w}")
            x = F.pad(x, (0, 0, 3, 3, 3, 3))
            hp, wp = h + 6, w + 6
            x = x.reshape(b, hp // 2, 2, wp // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(b, hp // 2, wp // 2, 4 * c)
        x = x.permute(0, 3, 1, 2)             # NCHW view, channels_last
        x = F.relu(self.bn1(self.conv1(x)))
        if self.stem != "cifar":
            x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))                 # global average pool
        return self.fc(x).float()


def _plan(stage_sizes, block_cls, **fixed):
    return partial(ResNet, stage_sizes=stage_sizes, block_cls=block_cls,
                   **fixed)


# torchvision layer plans (``tpu_dist/models/resnet.py:179-193``)
ResNet18 = _plan([2, 2, 2, 2], BasicBlock)
ResNet34 = _plan([3, 4, 6, 3], BasicBlock)
ResNet50 = _plan([3, 4, 6, 3], Bottleneck)
ResNet101 = _plan([3, 4, 23, 3], Bottleneck)
ResNet152 = _plan([3, 8, 36, 3], Bottleneck)
ResNeXt50_32x4d = _plan([3, 4, 6, 3], Bottleneck, groups=32, base_width=4)
ResNeXt101_32x8d = _plan([3, 4, 23, 3], Bottleneck, groups=32, base_width=8)
WideResNet50_2 = _plan([3, 4, 6, 3], Bottleneck, base_width=128)
WideResNet101_2 = _plan([3, 4, 23, 3], Bottleneck, base_width=128)
