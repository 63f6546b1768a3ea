"""MNIST conv net for the port (``tpu_dist/models/lenet.py``).

conv(10, 5x5) -> max pool 2 -> relu -> conv(20, 5x5) -> dropout -> max pool
2 -> relu -> flatten -> fc(50) -> relu -> dropout -> fc(num_classes), on
(B, H, W, C) input, fp32 logits (the log_softmax lives in the loss). The
flatten follows flax's NHWC order, (H, W, C): 320 features for 28x28x1,
which is what the reference's ``fc1`` kernel expects. Dropout (0.5,
elementwise, train mode only) draws from ``dropout_gen``: the model's own
generator, seeded from ``seed`` as the zoo's is, or the one the trainer's
step hands it (``engine.steps.dropout_from``). JAX's draws differ, so
parity with the reference holds in eval mode.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpu_dist_torch.device import resolve_device
from tpu_dist_torch.models.cnn_zoo import dropout
from tpu_dist_torch.models.resnet import Conv
from tpu_dist_torch.ops.quant import make_dense


class LeNet(nn.Module):
    """MNIST classifier; input (B, 28, 28, 1) NHWC by default."""

    def __init__(self, num_classes: int = 10, dtype=torch.float32,
                 image_shape: Sequence[int] = (28, 28, 1), device=None,
                 seed: Optional[int] = 0, param_dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        h, w, c = image_shape
        conv = dict(use_bias=True, dtype=dtype, device=device,
                    param_dtype=param_dtype)
        self.conv1 = Conv(c, 10, 5, **conv)
        self.conv2 = Conv(10, 20, 5, **conv)
        out = lambda n: ((n - 4) // 2 - 4) // 2    # two VALID 5x5 + pools
        flat = 20 * out(h) * out(w)
        dense = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.fc1 = make_dense(flat, 50, **dense)
        self.fc2 = make_dense(50, num_classes, **dense)
        self.requires_grad_(False)
        self.dropout_gen = torch.Generator(device=device).manual_seed(
            int(seed or 0) + 1)
        if seed is not None:
            gen = torch.Generator(device=device).manual_seed(int(seed))
            for m in (self.conv1, self.conv2, self.fc1, self.fc2):
                m.reset_parameters(gen)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(F.max_pool2d(self.conv1(x), 2, 2))
        x = dropout(self.conv2(x), 0.5, self.training, self.dropout_gen)
        x = F.relu(F.max_pool2d(x, 2, 2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (H, W, C)
        x = dropout(F.relu(self.fc1(x)), 0.5, self.training,
                    self.dropout_gen)
        return self.fc2(x).float()
