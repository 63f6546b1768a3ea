"""GoogLeNet and Inception v3 for the port (``tpu_dist/models/inception.py``).

torchvision's plans with ``aux_logits=False`` (the deploy networks), in
the zoo's idiom (``models/cnn_zoo.py``). Every conv is a
:class:`_BasicConv`: conv (no bias) + BatchNorm (eps 1e-3) + relu, with
"same" (centered, per-axis ``k // 2``) or "valid" padding and square or
(kh, kw) kernels. GoogLeNet keeps torchvision's "5x5" branch with a 3x3
kernel; its pools are ceil-mode (``cnn_zoo._max_pool_ceil``). Inception
v3's pool branches average over 3x3 windows counting the padding, as flax
does; its VALID stem needs inputs of at least 75 px.
"""

from __future__ import annotations

from torch import nn
import torch.nn.functional as F

from tpu_dist_torch.models.cnn_zoo import ZooNet, _max_pool_ceil, cat, gap


class _BasicConv(nn.Module):
    def __init__(self, net: ZooNet, in_ch: int, ch: int, kernel=1,
                 stride: int = 1, pad: str = "same"):
        super().__init__()
        k = kernel if isinstance(kernel, tuple) else (kernel, kernel)
        padding = 0 if pad == "valid" else (k[0] // 2, k[1] // 2)
        self.conv = net.conv(in_ch, ch, k, stride, padding)
        self.bn = net.norm(ch, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _pool3(x):
    """3x3 stride-1 average pool, pad 1, the pad counted."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


class _Inception(nn.Module):
    """1x1 / 1x1 -> 3x3 / 1x1 -> '5x5' (a 3x3) / 3x3 max pool -> 1x1."""

    def __init__(self, net, in_ch, ch1, ch3r, ch3, ch5r, ch5, pool_proj):
        super().__init__()
        self.b1 = _BasicConv(net, in_ch, ch1)
        self.b2_1x1 = _BasicConv(net, in_ch, ch3r)
        self.b2_3x3 = _BasicConv(net, ch3r, ch3, 3)
        self.b3_1x1 = _BasicConv(net, in_ch, ch5r)
        self.b3_5x5 = _BasicConv(net, ch5r, ch5, 3)
        self.b4_1x1 = _BasicConv(net, in_ch, pool_proj)
        self.out_ch = ch1 + ch3 + ch5 + pool_proj

    def forward(self, x):
        return cat([self.b1(x), self.b2_3x3(self.b2_1x1(x)),
                    self.b3_5x5(self.b3_1x1(x)),
                    self.b4_1x1(F.max_pool2d(x, 3, 1, 1))])


# (ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5, pool_proj) per torchvision
_PLAN = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


class GoogLeNet(ZooNet):
    """7x7/2 stem, 1x1 + 3x3 convs, nine inception blocks with ceil-mode
    pools between the stages, the pool, dropout 0.2 and the head."""

    def __init__(self, num_classes: int = 10, in_channels: int = 3, **kw):
        super().__init__(**kw)
        self.conv1 = _BasicConv(self, in_channels, 64, 7, 2)
        self.conv2 = _BasicConv(self, 64, 64)
        self.conv3 = _BasicConv(self, 64, 192, 3)
        ch = 192
        for name in _PLAN:
            blk = _Inception(self, ch, *_PLAN[name])
            setattr(self, f"inception{name}", blk)
            ch = blk.out_ch
        self.head = self.dense(ch, num_classes)
        self.finish()

    def forward(self, x):
        x = _max_pool_ceil(self.conv1(self.nchw(x)))
        x = _max_pool_ceil(self.conv3(self.conv2(x)))
        for name in _PLAN:
            if name == "4a":
                x = _max_pool_ceil(x)
            elif name == "5a":
                x = _max_pool_ceil(x, k=2)
            x = getattr(self, f"inception{name}")(x)
        return self.head(self.drop(gap(x), 0.2)).float()


class _InceptionA(nn.Module):
    def __init__(self, net, in_ch, pool_ch):
        super().__init__()
        self.b1 = _BasicConv(net, in_ch, 64)
        self.b5_1 = _BasicConv(net, in_ch, 48)
        self.b5_2 = _BasicConv(net, 48, 64, 5)
        self.b3_1 = _BasicConv(net, in_ch, 64)
        self.b3_2 = _BasicConv(net, 64, 96, 3)
        self.b3_3 = _BasicConv(net, 96, 96, 3)
        self.bp = _BasicConv(net, in_ch, pool_ch)
        self.out_ch = 64 + 64 + 96 + pool_ch

    def forward(self, x):
        return cat([self.b1(x), self.b5_2(self.b5_1(x)),
                    self.b3_3(self.b3_2(self.b3_1(x))),
                    self.bp(_pool3(x))])


class _InceptionB(nn.Module):
    """Grid reduction: stride-2 3x3, a double 3x3, a 3x3/2 max pool."""

    def __init__(self, net, in_ch):
        super().__init__()
        self.b3 = _BasicConv(net, in_ch, 384, 3, 2, "valid")
        self.bd_1 = _BasicConv(net, in_ch, 64)
        self.bd_2 = _BasicConv(net, 64, 96, 3)
        self.bd_3 = _BasicConv(net, 96, 96, 3, 2, "valid")
        self.out_ch = 384 + 96 + in_ch

    def forward(self, x):
        return cat([self.b3(x), self.bd_3(self.bd_2(self.bd_1(x))),
                    F.max_pool2d(x, 3, 2)])


class _InceptionC(nn.Module):
    """Factorized 7x7 branches at width c7."""

    def __init__(self, net, in_ch, c7):
        super().__init__()
        self.b1 = _BasicConv(net, in_ch, 192)
        self.b7_1 = _BasicConv(net, in_ch, c7)
        self.b7_2 = _BasicConv(net, c7, c7, (1, 7))
        self.b7_3 = _BasicConv(net, c7, 192, (7, 1))
        self.bd_1 = _BasicConv(net, in_ch, c7)
        self.bd_2 = _BasicConv(net, c7, c7, (7, 1))
        self.bd_3 = _BasicConv(net, c7, c7, (1, 7))
        self.bd_4 = _BasicConv(net, c7, c7, (7, 1))
        self.bd_5 = _BasicConv(net, c7, 192, (1, 7))
        self.bp = _BasicConv(net, in_ch, 192)
        self.out_ch = 4 * 192

    def forward(self, x):
        h = self.bd_1(x)
        for conv in (self.bd_2, self.bd_3, self.bd_4, self.bd_5):
            h = conv(h)
        return cat([self.b1(x), self.b7_3(self.b7_2(self.b7_1(x))), h,
                    self.bp(_pool3(x))])


class _InceptionD(nn.Module):
    """Grid reduction: 1x1 -> 3x3/2, 1x1 -> 1x7 -> 7x1 -> 3x3/2, max pool."""

    def __init__(self, net, in_ch):
        super().__init__()
        self.b3_1 = _BasicConv(net, in_ch, 192)
        self.b3_2 = _BasicConv(net, 192, 320, 3, 2, "valid")
        self.b7_1 = _BasicConv(net, in_ch, 192)
        self.b7_2 = _BasicConv(net, 192, 192, (1, 7))
        self.b7_3 = _BasicConv(net, 192, 192, (7, 1))
        self.b7_4 = _BasicConv(net, 192, 192, 3, 2, "valid")
        self.out_ch = 320 + 192 + in_ch

    def forward(self, x):
        b7 = self.b7_4(self.b7_3(self.b7_2(self.b7_1(x))))
        return cat([self.b3_2(self.b3_1(x)), b7, F.max_pool2d(x, 3, 2)])


class _InceptionE(nn.Module):
    """Expanded filter bank: 1x3 / 3x1 splits, concatenated."""

    def __init__(self, net, in_ch):
        super().__init__()
        self.b1 = _BasicConv(net, in_ch, 320)
        self.b3_1 = _BasicConv(net, in_ch, 384)
        self.b3_2a = _BasicConv(net, 384, 384, (1, 3))
        self.b3_2b = _BasicConv(net, 384, 384, (3, 1))
        self.bd_1 = _BasicConv(net, in_ch, 448)
        self.bd_2 = _BasicConv(net, 448, 384, 3)
        self.bd_3a = _BasicConv(net, 384, 384, (1, 3))
        self.bd_3b = _BasicConv(net, 384, 384, (3, 1))
        self.bp = _BasicConv(net, in_ch, 192)
        self.out_ch = 320 + 768 + 768 + 192

    def forward(self, x):
        h = self.b3_1(x)
        b3 = cat([self.b3_2a(h), self.b3_2b(h)])
        h = self.bd_2(self.bd_1(x))
        bd = cat([self.bd_3a(h), self.bd_3b(h)])
        return cat([self.b1(x), b3, bd, self.bp(_pool3(x))])


class InceptionV3(ZooNet):
    """VALID-conv stem to 192 channels, 3 x A (pool 32/64/64), B, 4 x C
    (c7 128/160/160/192), D, 2 x E, the pool, dropout 0.5, the head."""

    def __init__(self, num_classes: int = 10, in_channels: int = 3, **kw):
        super().__init__(**kw)
        self.stem1a = _BasicConv(self, in_channels, 32, 3, 2, "valid")
        self.stem2a = _BasicConv(self, 32, 32, 3, pad="valid")
        self.stem2b = _BasicConv(self, 32, 64, 3)
        self.stem3b = _BasicConv(self, 64, 80)
        self.stem4a = _BasicConv(self, 80, 192, 3, pad="valid")
        self.mixed = []
        ch = 192

        def add(name, blk):
            nonlocal ch
            setattr(self, name, blk)
            self.mixed.append(name)
            ch = blk.out_ch

        for i, pool_ch in enumerate((32, 64, 64)):
            add(f"mixed5{'bcd'[i]}", _InceptionA(self, ch, pool_ch))
        add("mixed6a", _InceptionB(self, ch))
        for i, c7 in enumerate((128, 160, 160, 192)):
            add(f"mixed6{'bcde'[i]}", _InceptionC(self, ch, c7))
        add("mixed7a", _InceptionD(self, ch))
        for i in range(2):
            add(f"mixed7{'bc'[i]}", _InceptionE(self, ch))
        self.head = self.dense(ch, num_classes)
        self.finish()

    def forward(self, x):
        x = self.stem2b(self.stem2a(self.stem1a(self.nchw(x))))
        x = F.max_pool2d(x, 3, 2)
        x = F.max_pool2d(self.stem4a(self.stem3b(x)), 3, 2)
        for name in self.mixed:
            x = getattr(self, name)(x)
        return self.head(self.drop(gap(x), 0.5)).float()
