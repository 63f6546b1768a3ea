"""The non-ResNet CNN plans for the port (``tpu_dist/models/cnn_zoo.py``):
VGG 11/13/16/19 (BatchNorm, a global-average-pool head), DenseNet
121/161/169/201, AlexNet, MobileNetV2, SqueezeNet 1_0/1_1, ShuffleNetV2
x0.5/x1.0/x1.5/x2.0 and EfficientNet-B0.

The idiom of ``models/resnet.py``: (B, H, W, C) input run as NCHW views in
``channels_last`` memory; the submodules carry the flax module names, so
``interop.load_flax_image_params`` maps a flax tree name for name; convs
and dense layers compute in ``dtype`` over masters in ``param_dtype``;
:class:`~tpu_dist_torch.models.resnet.BatchNorm` keeps flax's statistics
(fp32, biased variance, ``0.9 old + 0.1 batch``) and its fp32 output, with
``eps`` 1e-5, or 1e-3 where the reference sets it (EfficientNet and its
MBConv, Inception, MobileNetV3). Where two branches of different dtypes
meet (a concat), the result takes the wider one, as ``jnp.concatenate``
does.

Randomness: dropout and EfficientNet's stochastic depth draw from
``dropout_gen``, never from the global generator: the model's own
``torch.Generator`` (seeded from ``seed``), or the one the trainer's step
hands it for the step and microbatch (``engine.steps.dropout_from``).
JAX's draws differ, so parity with the reference holds in eval mode, for
the train-mode BatchNorm statistics ahead of the head's dropout, and for
full gradients on the archs without dropout.

Pools: :func:`_max_pool_ceil` pads only the end of each spatial dim with
-inf (flax's ``max_pool`` with explicit padding), not ``ceil_mode=True``:
torch drops a last window that starts in the padding, and squeezenet1_0 at
224 px needs it. ``avg_pool`` with padding counts the pad, as flax does.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpu_dist_torch.device import resolve_device
from tpu_dist_torch.models.resnet import BatchNorm, Conv
from tpu_dist_torch.ops.quant import make_dense


# ---- shared pieces --------------------------------------------------------

def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def hard_sigmoid(x):
    """flax ``nn.hard_sigmoid``: ``relu6(x + 3) / 6``."""
    return relu6(x + 3.0) / 6.0


def hard_swish(x):
    """flax ``nn.hard_swish``: ``x * hard_sigmoid(x)``."""
    return x * hard_sigmoid(x)


def cat(xs):
    """Channel concat with ``jnp.concatenate``'s promotion to the widest
    dtype."""
    dt = functools.reduce(torch.promote_types, (x.dtype for x in xs))
    return torch.cat([x.to(dt) for x in xs], dim=1)


def dropout(x, rate: float, training: bool, gen: torch.Generator):
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale by
    its inverse; the mask drawn from ``gen``."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty(x.shape, device=x.device).bernoulli_(keep,
                                                            generator=gen)
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


def _max_pool_ceil(x, k: int = 3, s: int = 2):
    """torchvision's ``MaxPool2d(ceil_mode=True)`` as the reference builds
    it (``cnn_zoo.py:380-389``): pad the end of H and W with -inf so that
    partial windows count, then a VALID pool."""
    pads = []
    for dim in (x.shape[3], x.shape[2]):      # F.pad takes W first
        rem = (dim - k) % s
        pads += [0, s - rem if rem else 0]
    if any(pads):
        x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, k, s)


def gap(x):
    """Global average pool of an NCHW map."""
    return x.mean(dim=(2, 3))


class ZooNet(nn.Module):
    """Base of the zoo's models: the device, the dtypes, the layer
    factories (``self.conv``, ``self.norm``, ``self.dense``) and the
    dropout generator, then flax's initializers from ``seed`` once the
    subclass has built its layers (:meth:`finish`)."""

    def __init__(self, dtype=torch.float32, device=None,
                 seed: Optional[int] = 0, param_dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self._seed = seed
        self.dropout_gen = torch.Generator(device=device).manual_seed(
            int(seed or 0) + 1)
        pd = dict(device=device, param_dtype=param_dtype)
        self.conv = partial(Conv, dtype=dtype, **pd)
        self.dense = partial(make_dense, dtype=dtype, **pd)
        self.norm = partial(BatchNorm, **pd)

    def finish(self) -> None:
        self.requires_grad_(False)
        if self._seed is not None:
            self.init_weights(self._seed)

    def init_weights(self, seed: int) -> None:
        """Random weights from ``seed`` with flax's initializers (convs and
        dense layers lecun-normal, biases zero, norms 1 and 0)."""
        gen = torch.Generator(device=self.dropout_gen.device).manual_seed(
            int(seed))
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

    def nchw(self, x):
        return x.to(self.dtype).permute(0, 3, 1, 2)

    def drop(self, x, rate: float):
        return dropout(x, rate, self.training, self.dropout_gen)


# ---- VGG ------------------------------------------------------------------

class VGG(ZooNet):
    """torchvision's vgg plan with BatchNorm: 3x3 conv stacks and 2x2
    pools ('M'), then a global average pool into fc0/fc1 (4096, relu,
    dropout 0.5) and the head."""

    def __init__(self, plan: Sequence, num_classes: int = 10,
                 in_channels: int = 3, **kw):
        super().__init__(**kw)
        self.plan = []
        ch = in_channels
        for entry in plan:
            if entry == "M":
                self.plan.append("M")
                continue
            i = sum(1 for e in self.plan if e != "M")
            setattr(self, f"conv{i}", self.conv(ch, entry, 3, 1, 1))
            setattr(self, f"bn{i}", self.norm(entry))
            self.plan.append(i)
            ch = entry
        self.fc0 = self.dense(ch, 4096)
        self.fc1 = self.dense(4096, 4096)
        self.head = self.dense(4096, num_classes)
        self.finish()

    def forward(self, x):
        x = self.nchw(x)
        for e in self.plan:
            if e == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"bn{e}")(
                    getattr(self, f"conv{e}")(x)))
        x = gap(x)
        for fc in (self.fc0, self.fc1):
            x = self.drop(F.relu(fc(x)), 0.5)
        return self.head(x).float()


# ---- DenseNet -------------------------------------------------------------

class _DenseLayer(nn.Module):
    """BN-ReLU-1x1 (4k) -> BN-ReLU-3x3 (k), concatenated onto the input."""

    def __init__(self, net: ZooNet, in_ch: int, growth: int):
        super().__init__()
        self.bn1 = net.norm(in_ch)
        self.conv1 = net.conv(in_ch, 4 * growth, 1)
        self.bn2 = net.norm(4 * growth)
        self.conv2 = net.conv(4 * growth, growth, 3, 1, 1)

    def forward(self, x):
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.conv2(F.relu(self.bn2(y)))
        return cat([x, y])


class DenseNet(ZooNet):
    """torchvision's DenseNet plan: a 7x7/2 stem and a 3x3/2 pool, dense
    blocks with 1x1 + 2x2-average-pool transitions that halve the
    channels, a last BN-ReLU, the pool and the head."""

    def __init__(self, block_sizes: Sequence[int], growth: int = 32,
                 init_features: int = 64, num_classes: int = 10,
                 in_channels: int = 3, **kw):
        super().__init__(**kw)
        self.conv0 = self.conv(in_channels, init_features, 7, 2, 3)
        self.bn0 = self.norm(init_features)
        self.layers = []
        ch = init_features
        for b, n_layers in enumerate(block_sizes):
            for j in range(n_layers):
                name = f"block{b}_layer{j}"
                setattr(self, name, _DenseLayer(self, ch, growth))
                self.layers.append(name)
                ch += growth
            if b != len(block_sizes) - 1:
                setattr(self, f"trans{b}_bn", self.norm(ch))
                setattr(self, f"trans{b}_conv", self.conv(ch, ch // 2, 1))
                self.layers.append(f"trans{b}")
                ch //= 2
        self.bn_final = self.norm(ch)
        self.head = self.dense(ch, num_classes)
        self.finish()

    def forward(self, x):
        x = F.relu(self.bn0(self.conv0(self.nchw(x))))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.layers:
            if name.startswith("trans"):
                x = F.relu(getattr(self, name + "_bn")(x))
                x = F.avg_pool2d(getattr(self, name + "_conv")(x), 2, 2)
            else:
                x = getattr(self, name)(x)
        x = gap(F.relu(self.bn_final(x)))
        return self.head(x).float()


# ---- MobileNetV2 and the inverted residual --------------------------------

class _InvertedResidual(nn.Module):
    """1x1 expand -> kxk depthwise -> 1x1 linear projection, with the
    residual when the stride is 1 and the channels match. MobileNetV2's
    flavor is relu6 with kernel 3; MnasNet's relu with kernel 3 or 5
    (``models.mobile``)."""

    def __init__(self, net: ZooNet, in_ch: int, out_ch: int, stride: int,
                 expand: int, kernel: int = 3, act: str = "relu6"):
        super().__init__()
        self.act = relu6 if act == "relu6" else F.relu
        ch = in_ch * expand
        if expand != 1:
            self.expand = net.conv(in_ch, ch, 1)
            self.bn_expand = net.norm(ch)
        self.has_expand = expand != 1
        self.depthwise = net.conv(ch, ch, kernel, stride, kernel // 2,
                                  groups=ch)
        self.bn_dw = net.norm(ch)
        self.project = net.conv(ch, out_ch, 1)
        self.bn_project = net.norm(out_ch)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        h = x
        if self.has_expand:
            h = self.act(self.bn_expand(self.expand(h)))
        h = self.act(self.bn_dw(self.depthwise(h)))
        h = self.bn_project(self.project(h))
        return x + h if self.residual else h


class MobileNetV2(ZooNet):
    """torchvision's mobilenet_v2 plan: a 32-wide 3x3/2 stem, seven
    inverted-residual stages (t, c, n, s), a 1280-wide 1x1 conv, the pool,
    dropout 0.2 and the head."""

    PLAN = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))

    def __init__(self, num_classes: int = 10, in_channels: int = 3, **kw):
        super().__init__(**kw)
        self.stem = self.conv(in_channels, 32, 3, 2, 1)
        self.bn_stem = self.norm(32)
        self.blocks = []
        ch = 32
        for si, (t, c, n, s) in enumerate(self.PLAN):
            for i in range(n):
                name = f"stage{si}_block{i}"
                setattr(self, name, _InvertedResidual(
                    self, ch, c, s if i == 0 else 1, t))
                self.blocks.append(name)
                ch = c
        self.head_conv = self.conv(ch, 1280, 1)
        self.bn_head = self.norm(1280)
        self.head = self.dense(1280, num_classes)
        self.finish()

    def forward(self, x):
        x = relu6(self.bn_stem(self.stem(self.nchw(x))))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = gap(relu6(self.bn_head(self.head_conv(x))))
        return self.head(self.drop(x, 0.2)).float()


# ---- EfficientNet ---------------------------------------------------------

class _SqueezeExcite(nn.Module):
    """Global pool -> 1x1 reduce (``act``) -> 1x1 expand (``gate``) ->
    scale; both 1x1 convs biased. EfficientNet: silu/sigmoid over the
    block's input channels // 4; MobileNetV3: relu/hard_sigmoid over
    round8(exp / 4)."""

    def __init__(self, net: ZooNet, ch: int, reduce_ch: int,
                 act: Callable = F.silu, gate: Callable = torch.sigmoid):
        super().__init__()
        self.act, self.gate = act, gate
        self.fc1 = net.conv(ch, reduce_ch, 1, use_bias=True)
        self.fc2 = net.conv(reduce_ch, ch, 1, use_bias=True)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.gate(self.fc2(self.act(self.fc1(s))))
        return x * s


class _MBConv(nn.Module):
    """[1x1 expand] -> kxk depthwise -> SE -> 1x1 linear projection, with
    the residual under stochastic depth (one draw per row, in training)
    when the shapes match. BatchNorm eps 1e-3."""

    def __init__(self, net: ZooNet, in_ch: int, out_ch: int, expand: int,
                 kernel: int, stride: int, sd_rate: float):
        super().__init__()
        norm = partial(net.norm, eps=1e-3)
        ch = in_ch * expand
        self.has_expand = expand != 1
        if self.has_expand:
            self.expand = net.conv(in_ch, ch, 1)
            self.bn_expand = norm(ch)
        self.dw = net.conv(ch, ch, kernel, stride, kernel // 2, groups=ch)
        self.bn_dw = norm(ch)
        self.se = _SqueezeExcite(net, ch, max(1, in_ch // 4))
        self.project = net.conv(ch, out_ch, 1)
        self.bn_project = norm(out_ch)
        self.residual = stride == 1 and in_ch == out_ch
        self.sd_rate = sd_rate

    def forward(self, x, gen: torch.Generator):
        h = x
        if self.has_expand:
            h = F.silu(self.bn_expand(self.expand(h)))
        h = self.se(F.silu(self.bn_dw(self.dw(h))))
        h = self.bn_project(self.project(h))
        if not self.residual:
            return h
        if self.training and self.sd_rate > 0:
            keep = 1.0 - self.sd_rate
            mask = torch.empty((h.shape[0], 1, 1, 1), device=h.device
                               ).bernoulli_(keep, generator=gen)
            h = h * mask.to(h.dtype) / keep
        return x + h


class EfficientNet(ZooNet):
    """torchvision's efficientnet_b0 plan: a 32-wide silu stem, seven MBConv
    stages (expand, channels, repeats, stride, kernel) with stochastic
    depth rising linearly to ``sd_max``, a 1280-wide 1x1 conv, the pool,
    dropout 0.2 and the head."""

    PLAN = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
            (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
            (6, 320, 1, 1, 3))

    def __init__(self, num_classes: int = 10, in_channels: int = 3,
                 sd_max: float = 0.2, **kw):
        super().__init__(**kw)
        norm = partial(self.norm, eps=1e-3)
        self.stem = self.conv(in_channels, 32, 3, 2, 1)
        self.bn_stem = norm(32)
        total = sum(n for _, _, n, _, _ in self.PLAN)
        self.blocks = []
        ch, bi = 32, 0
        for si, (t, c, n, s, k) in enumerate(self.PLAN):
            for i in range(n):
                name = f"stage{si}_block{i}"
                setattr(self, name, _MBConv(self, ch, c, t, k,
                                            s if i == 0 else 1,
                                            sd_max * bi / total))
                self.blocks.append(name)
                ch, bi = c, bi + 1
        self.head_conv = self.conv(ch, 1280, 1)
        self.bn_head = norm(1280)
        self.head = self.dense(1280, num_classes)
        self.finish()

    def forward(self, x):
        x = F.silu(self.bn_stem(self.stem(self.nchw(x))))
        for name in self.blocks:
            x = getattr(self, name)(x, self.dropout_gen)
        x = gap(F.silu(self.bn_head(self.head_conv(x))))
        return self.head(self.drop(x, 0.2)).float()


# ---- ShuffleNetV2 ---------------------------------------------------------

def _channel_shuffle(x, groups: int = 2):
    """Interleave the two branch halves: NHWC channel c = g * (C/groups) + j
    moves to j * groups + g (the reference's reshape and swap)."""
    b, c, h, w = x.shape
    return (x.reshape(b, groups, c // groups, h, w).transpose(1, 2)
            .reshape(b, c, h, w))


class _ShuffleUnit(nn.Module):
    """Stride 1: split the channels, the right half through 1x1 -> 3x3 dw
    -> 1x1, concat, shuffle. Stride 2: both branches downsample the whole
    input (left 3x3 dw -> 1x1; right as above)."""

    def __init__(self, net: ZooNet, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        branch = out_ch // 2
        self.stride = stride
        r_in = in_ch // 2 if stride == 1 else in_ch
        self.r_pw1 = net.conv(r_in, branch, 1)
        self.r_bn1 = net.norm(branch)
        self.r_dw = net.conv(branch, branch, 3, stride, 1, groups=branch)
        self.r_bn2 = net.norm(branch)
        self.r_pw2 = net.conv(branch, branch, 1)
        self.r_bn3 = net.norm(branch)
        if stride != 1:
            self.l_dw = net.conv(in_ch, in_ch, 3, 2, 1, groups=in_ch)
            self.l_bn1 = net.norm(in_ch)
            self.l_pw = net.conv(in_ch, branch, 1)
            self.l_bn2 = net.norm(branch)

    def _right(self, h):
        h = F.relu(self.r_bn1(self.r_pw1(h)))
        h = self.r_bn2(self.r_dw(h))
        return F.relu(self.r_bn3(self.r_pw2(h)))

    def forward(self, x):
        if self.stride == 1:
            left, rest = x.chunk(2, dim=1)
            out = cat([left, self._right(rest)])
        else:
            left = self.l_bn1(self.l_dw(x))
            left = F.relu(self.l_bn2(self.l_pw(left)))
            out = cat([left, self._right(x)])
        return _channel_shuffle(out)


class ShuffleNetV2(ZooNet):
    """torchvision's shufflenet_v2 plan: a 24-wide 3x3/2 stem and a 3x3/2
    pool, three stages of (downsampling + repeated) units, a 1x1 head conv,
    the pool and the head. The width multipliers are plans: x0_5
    (48/96/192), x1_0 (116/232/464), x1_5 (176/352/704), x2_0
    (244/488/976, a 2048 head)."""

    def __init__(self, num_classes: int = 10, in_channels: int = 3,
                 stage_out: Sequence[int] = (116, 232, 464),
                 stage_repeats: Sequence[int] = (4, 8, 4),
                 head_ch: int = 1024, **kw):
        super().__init__(**kw)
        self.conv1 = self.conv(in_channels, 24, 3, 2, 1)
        self.bn1 = self.norm(24)
        self.units = []
        ch = 24
        for si, (c, n) in enumerate(zip(stage_out, stage_repeats)):
            for i in range(n):
                name = f"stage{si}_unit{i}"
                setattr(self, name, _ShuffleUnit(self, ch, c,
                                                 2 if i == 0 else 1))
                self.units.append(name)
                ch = c
        self.conv5 = self.conv(ch, head_ch, 1)
        self.bn5 = self.norm(head_ch)
        self.head = self.dense(head_ch, num_classes)
        self.finish()

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(self.nchw(x))))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.units:
            x = getattr(self, name)(x)
        x = gap(F.relu(self.bn5(self.conv5(x))))
        return self.head(x).float()


# ---- SqueezeNet and AlexNet (biased convs, no BatchNorm) ------------------

class _Fire(nn.Module):
    """1x1 squeeze, then parallel 1x1 and 3x3 expands, concatenated."""

    def __init__(self, net: ZooNet, in_ch: int, squeeze: int, e1: int,
                 e3: int):
        super().__init__()
        self.squeeze = net.conv(in_ch, squeeze, 1, use_bias=True)
        self.expand1 = net.conv(squeeze, e1, 1, use_bias=True)
        self.expand3 = net.conv(squeeze, e3, 3, 1, 1, use_bias=True)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return cat([F.relu(self.expand1(s)), F.relu(self.expand3(s))])


# torchvision fire sequences with 'M' pools; fires are numbered from 2
_SQUEEZE_PLANS = {
    "1_0": [(16, 64, 64), (16, 64, 64), (32, 128, 128), "M",
            (32, 128, 128), (48, 192, 192), (48, 192, 192),
            (64, 256, 256), "M", (64, 256, 256)],
    "1_1": [(16, 64, 64), (16, 64, 64), "M", (32, 128, 128),
            (32, 128, 128), "M", (48, 192, 192), (48, 192, 192),
            (64, 256, 256), (64, 256, 256)],
}


class SqueezeNet(ZooNet):
    """torchvision's squeezenet plan: an unpadded stem (1_0: 96 wide 7x7;
    1_1: 64 wide 3x3, both stride 2), ceil-mode pools, fire modules,
    dropout 0.5, a 1x1 conv head with relu, the pool."""

    def __init__(self, num_classes: int = 10, in_channels: int = 3,
                 version: str = "1_1", **kw):
        super().__init__(**kw)
        stem_ch, stem_k = (96, 7) if version == "1_0" else (64, 3)
        self.stem = self.conv(in_channels, stem_ch, stem_k, 2, 0,
                              use_bias=True)
        self.plan = []
        ch, i = stem_ch, 2
        for entry in _SQUEEZE_PLANS[version]:
            if entry == "M":
                self.plan.append("M")
                continue
            setattr(self, f"fire{i}", _Fire(self, ch, *entry))
            self.plan.append(f"fire{i}")
            ch, i = entry[1] + entry[2], i + 1
        self.head_conv = self.conv(ch, num_classes, 1, use_bias=True)
        self.finish()

    def forward(self, x):
        x = _max_pool_ceil(F.relu(self.stem(self.nchw(x))))
        for e in self.plan:
            x = _max_pool_ceil(x) if e == "M" else getattr(self, e)(x)
        x = F.relu(self.head_conv(self.drop(x, 0.5)))
        return gap(x).float()


class AlexNet(ZooNet):
    """torchvision's alexnet features (biased convs) with VGG's pooled
    head: dropout, fc0/fc1 (4096, relu), the head. A pool is skipped where
    the map is smaller than its window (32 px inputs reach 1x1)."""

    def __init__(self, num_classes: int = 10, in_channels: int = 3, **kw):
        super().__init__(**kw)
        conv = partial(self.conv, use_bias=True)
        self.conv0 = conv(in_channels, 64, 11, 4, 2)
        self.conv1 = conv(64, 192, 5, 1, 2)
        self.conv2 = conv(192, 384, 3, 1, 1)
        self.conv3 = conv(384, 256, 3, 1, 1)
        self.conv4 = conv(256, 256, 3, 1, 1)
        self.fc0 = self.dense(256, 4096)
        self.fc1 = self.dense(4096, 4096)
        self.head = self.dense(4096, num_classes)
        self.finish()

    def forward(self, x):
        def pool(h):
            return _max_pool_ceil(h) if min(h.shape[2:]) >= 3 else h

        x = pool(F.relu(self.conv0(self.nchw(x))))
        x = pool(F.relu(self.conv1(x)))
        x = F.relu(self.conv2(x))
        x = F.relu(self.conv3(x))
        x = pool(F.relu(self.conv4(x)))
        x = gap(x)
        for fc in (self.fc0, self.fc1):
            x = F.relu(fc(self.drop(x, 0.5)))
        return self.head(x).float()


# torchvision plans (``cnn_zoo.py:493-518``)
VGG11 = partial(VGG, plan=[64, "M", 128, "M", 256, 256, "M",
                           512, 512, "M", 512, 512, "M"])
VGG13 = partial(VGG, plan=[64, 64, "M", 128, 128, "M", 256, 256, "M",
                           512, 512, "M", 512, 512, "M"])
VGG16 = partial(VGG, plan=[64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                           512, 512, 512, "M", 512, 512, 512, "M"])
VGG19 = partial(VGG, plan=[64, 64, "M", 128, 128, "M", 256, 256, 256, 256,
                           "M", 512, 512, 512, 512, "M",
                           512, 512, 512, 512, "M"])
DenseNet121 = partial(DenseNet, block_sizes=[6, 12, 24, 16])
DenseNet169 = partial(DenseNet, block_sizes=[6, 12, 32, 32])
DenseNet201 = partial(DenseNet, block_sizes=[6, 12, 48, 32])
DenseNet161 = partial(DenseNet, block_sizes=[6, 12, 36, 24], growth=48,
                      init_features=96)
SqueezeNet1_0 = partial(SqueezeNet, version="1_0")
SqueezeNet1_1 = partial(SqueezeNet, version="1_1")
ShuffleNetV2_x0_5 = partial(ShuffleNetV2, stage_out=(48, 96, 192))
ShuffleNetV2_x1_0 = partial(ShuffleNetV2, stage_out=(116, 232, 464))
ShuffleNetV2_x1_5 = partial(ShuffleNetV2, stage_out=(176, 352, 704))
ShuffleNetV2_x2_0 = partial(ShuffleNetV2, stage_out=(244, 488, 976),
                            head_ch=2048)
