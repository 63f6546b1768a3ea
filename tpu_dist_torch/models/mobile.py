"""MnasNet and MobileNetV3 for the port (``tpu_dist/models/mobile.py``).

In the zoo's idiom (``models/cnn_zoo.py``):

* MnasNet (0.5/0.75/1.0/1.3): plain-relu inverted residuals
  (``cnn_zoo._InvertedResidual``, kernels 3 and 5) whose widths scale by
  alpha through torchvision's round-to-a-multiple-of-8 rule
  (:func:`_scale_depths`, with its 0.9 round-up bias);
* MobileNetV3 large and small: per-row block tables (the expanded width
  given absolutely), squeeze-excite over round8(exp / 4) channels with
  hard_sigmoid gates, hard_swish in the deep half, BatchNorm eps 1e-3, and
  the 1280/1024-wide dense head after the pool.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch.nn.functional as F
from torch import nn

from tpu_dist_torch.models.cnn_zoo import (ZooNet, _InvertedResidual,
                                           _SqueezeExcite, gap,
                                           hard_sigmoid, hard_swish)


def _round8(val: float, round_up_bias: float = 0.9) -> int:
    """torchvision mnasnet's ``_round_to_multiple_of(val, 8)``."""
    new_val = max(8, int(val + 4) // 8 * 8)
    return new_val if new_val >= round_up_bias * val else new_val + 8


def _scale_depths(alpha: float) -> list:
    return [_round8(d * alpha) for d in (32, 16, 24, 40, 80, 96, 192, 320)]


class MnasNet(ZooNet):
    """A 3x3/2 stem, a separable conv, six inverted-residual stacks
    (kernel, expansion, repeats, first stride), a 1280-wide 1x1 conv, the
    pool, dropout 0.2 and the head."""

    PLAN = ((3, 3, 3, 2), (5, 3, 3, 2), (5, 6, 3, 2), (3, 6, 2, 1),
            (5, 6, 4, 2), (3, 6, 1, 1))

    def __init__(self, alpha: float = 1.0, num_classes: int = 10,
                 in_channels: int = 3, **kw):
        super().__init__(**kw)
        d = _scale_depths(alpha)
        self.conv0 = self.conv(in_channels, d[0], 3, 2, 1)
        self.bn0 = self.norm(d[0])
        self.sep_dw = self.conv(d[0], d[0], 3, 1, 1, groups=d[0])
        self.bn_dw = self.norm(d[0])
        self.sep_pw = self.conv(d[0], d[1], 1)
        self.bn_sep = self.norm(d[1])
        self.blocks = []
        ch = d[1]
        for si, (k, e, n, s) in enumerate(self.PLAN):
            for i in range(n):
                name = f"stack{si}_block{i}"
                setattr(self, name, _InvertedResidual(
                    self, ch, d[si + 2], s if i == 0 else 1, e, kernel=k,
                    act="relu"))
                self.blocks.append(name)
                ch = d[si + 2]
        self.conv_head = self.conv(ch, 1280, 1)
        self.bn_head = self.norm(1280)
        self.head = self.dense(1280, num_classes)
        self.finish()

    def forward(self, x):
        x = F.relu(self.bn0(self.conv0(self.nchw(x))))
        x = F.relu(self.bn_dw(self.sep_dw(x)))
        x = self.bn_sep(self.sep_pw(x))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = gap(F.relu(self.bn_head(self.conv_head(x))))
        return self.head(self.drop(x, 0.2)).float()


class _V3Block(nn.Module):
    """Expand to an absolute width (when it differs), kxk depthwise,
    optional SE, linear projection; relu or hard_swish; BatchNorm eps
    1e-3; the residual when the stride is 1 and the channels match."""

    def __init__(self, net: ZooNet, in_ch: int, out_ch: int, exp_ch: int,
                 kernel: int, stride: int, use_se: bool, act: str):
        super().__init__()
        norm = partial(net.norm, eps=1e-3)
        self.act = F.relu if act == "relu" else hard_swish
        self.has_expand = exp_ch != in_ch
        if self.has_expand:
            self.expand = net.conv(in_ch, exp_ch, 1)
            self.bn_expand = norm(exp_ch)
        self.depthwise = net.conv(exp_ch, exp_ch, kernel, stride,
                                  kernel // 2, groups=exp_ch)
        self.bn_dw = norm(exp_ch)
        if use_se:
            self.se = _SqueezeExcite(net, exp_ch, _round8(exp_ch / 4),
                                     act=F.relu, gate=hard_sigmoid)
        self.use_se = use_se
        self.project = net.conv(exp_ch, out_ch, 1)
        self.bn_project = norm(out_ch)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        h = x
        if self.has_expand:
            h = self.act(self.bn_expand(self.expand(h)))
        h = self.act(self.bn_dw(self.depthwise(h)))
        if self.use_se:
            h = self.se(h)
        h = self.bn_project(self.project(h))
        return x + h if self.residual else h


# (kernel, exp, out, SE, act, stride): torchvision's settings tables
_V3_LARGE = (
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hswish", 2),
    (3, 200, 80, False, "hswish", 1),
    (3, 184, 80, False, "hswish", 1),
    (3, 184, 80, False, "hswish", 1),
    (3, 480, 112, True, "hswish", 1),
    (3, 672, 112, True, "hswish", 1),
    (5, 672, 160, True, "hswish", 2),
    (5, 960, 160, True, "hswish", 1),
    (5, 960, 160, True, "hswish", 1),
)
_V3_SMALL = (
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hswish", 2),
    (5, 240, 40, True, "hswish", 1),
    (5, 240, 40, True, "hswish", 1),
    (5, 120, 48, True, "hswish", 1),
    (5, 144, 48, True, "hswish", 1),
    (5, 288, 96, True, "hswish", 2),
    (5, 576, 96, True, "hswish", 1),
    (5, 576, 96, True, "hswish", 1),
)


class MobileNetV3(ZooNet):
    """A 16-wide hard_swish stem, the variant's block table, a 6x-wide
    hard_swish 1x1 conv, the pool, a dense layer (1280 large / 1024 small)
    with hard_swish, dropout 0.2 and the head."""

    def __init__(self, plan: Sequence = _V3_LARGE, head_width: int = 1280,
                 num_classes: int = 10, in_channels: int = 3, **kw):
        super().__init__(**kw)
        norm = partial(self.norm, eps=1e-3)
        self.stem = self.conv(in_channels, 16, 3, 2, 1)
        self.bn_stem = norm(16)
        self.blocks = []
        ch = 16
        for i, (k, e, c, se, act, s) in enumerate(plan):
            setattr(self, f"block{i}", _V3Block(self, ch, c, e, k, s, se,
                                                act))
            self.blocks.append(f"block{i}")
            ch = c
        self.conv_last = self.conv(ch, 6 * ch, 1)
        self.bn_last = norm(6 * ch)
        self.fc_head = self.dense(6 * ch, head_width)
        self.head = self.dense(head_width, num_classes)
        self.finish()

    def forward(self, x):
        x = hard_swish(self.bn_stem(self.stem(self.nchw(x))))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = gap(hard_swish(self.bn_last(self.conv_last(x))))
        x = self.drop(hard_swish(self.fc_head(x)), 0.2)
        return self.head(x).float()


MnasNet0_5 = partial(MnasNet, alpha=0.5)
MnasNet0_75 = partial(MnasNet, alpha=0.75)
MnasNet1_0 = partial(MnasNet, alpha=1.0)
MnasNet1_3 = partial(MnasNet, alpha=1.3)
MobileNetV3Large = partial(MobileNetV3, plan=_V3_LARGE, head_width=1280)
MobileNetV3Small = partial(MobileNetV3, plan=_V3_SMALL, head_width=1024)
