"""Vision Transformer family for the port (``tpu_dist/models/vit.py``).

A strided conv ``patch_embed`` (p x p patches, biased), a zero-initialised
``cls`` token prepended, a learned ``pos_embed`` (normal, std 0.02) over
every token, ``num_layers`` pre-LN :class:`~tpu_dist_torch.models
.transformer.Block` s under non-causal ``full_attention``, an fp32
``ln_f`` and the head reading ``x[:, 0]``; fp32 logits.

``quant`` is the blocks' dense mode (``ops.quant``): under ``"int8"`` the
qkv, proj, mlp_in and mlp_out products of every block go through
``ops.pallas_quant.fused_quant_matmul``, which runs ``csrc/fused_quant.cu``
on CUDA tensors (4 calls a block) with its straight-through backward. The
patch embedding and the head stay in the compute dtype, as in the
reference.

``tp_impl="ring"`` maps onto the full-token ``ring_ar`` flavour of
``parallel.overlap.RingDense`` (``tpu_dist/models/vit.py:45-71``: the
[CLS] token makes the token count odd, so the sequence cannot split over
the ``model`` axis): after :meth:`ViT.set_tp` each block runs its
column products on this rank's slice and its row products as a chunked
ring all-reduce, over this rank's heads; the params stay whole and
replicated. The image ``Trainer`` sets it (``engine.loop``).

Plans: vit_tiny/small/base at 16 px patches (224 px inputs give 196
patches + cls = 197 tokens); ``vit_cifar`` at 4 px patches (32 px inputs
give 64 patches).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch
from torch import nn

from tpu_dist_torch.device import resolve_device
from tpu_dist_torch.models.resnet import Conv
from tpu_dist_torch.models.transformer import Block, LayerNorm, full_attention
from tpu_dist_torch.ops.quant import make_dense


class ViT(nn.Module):
    def __init__(self, num_classes: int = 10, patch_size: int = 16,
                 num_layers: int = 12, d_model: int = 192,
                 num_heads: int = 3, dtype=torch.float32,
                 image_shape: Sequence[int] = (224, 224, 3),
                 quant: str = "none", tp_impl: str = "gspmd", device=None,
                 seed: Optional[int] = 0, param_dtype=torch.float32):
        super().__init__()
        from tpu_dist_torch.parallel.overlap import validate_tp_impl

        validate_tp_impl(tp_impl)
        device = resolve_device(device)
        h, w, c = image_shape
        p = patch_size
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} not divisible by patch {p}")
        self.dtype, self.patch_size, self.d_model = dtype, p, d_model
        self.num_heads, self.tp_impl = num_heads, tp_impl
        pd = dict(device=device, param_dtype=param_dtype)
        self.patch_embed = Conv(c, d_model, p, p, 0, use_bias=True,
                                dtype=dtype, **pd)
        tokens = (h // p) * (w // p) + 1
        self.cls = nn.Parameter(torch.zeros(1, 1, d_model, device=device,
                                            dtype=param_dtype),
                                requires_grad=False)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, d_model,
                                                  device=device,
                                                  dtype=param_dtype),
                                      requires_grad=False)
        self.block_names = [f"block{i}" for i in range(num_layers)]
        for name in self.block_names:
            setattr(self, name, Block(
                d_model, num_heads, dtype,
                partial(full_attention, causal=False), quant, device,
                param_dtype, "ring_ar" if tp_impl == "ring" else tp_impl))
        self.ln_f = LayerNorm(d_model, device=device)
        self.head = make_dense(d_model, num_classes, dtype=dtype, **pd)
        self.requires_grad_(False)
        if seed is not None:
            self.init_weights(seed)

    def init_weights(self, seed: int) -> None:
        """flax's initializers from ``seed``: ``cls`` zeros, ``pos_embed``
        normal(0.02), convs and dense layers lecun-normal, biases zero,
        LayerNorm 1 and 0."""
        gen = torch.Generator(device=self.cls.device).manual_seed(int(seed))
        with torch.no_grad():
            self.cls.zero_()
            self.pos_embed.copy_(0.02 * torch.randn(
                self.pos_embed.shape, generator=gen,
                device=self.cls.device))
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

    def set_tp(self, axis) -> None:
        """Run the blocks ring-parallel over ``axis`` (a
        ``parallel.mesh.Axis``; ``tp_impl="ring"`` only)."""
        if self.tp_impl != "ring":
            raise ValueError("ViT tensor parallelism is the ring "
                             "(tp_impl='ring')")
        if self.num_heads % axis.size:
            raise ValueError(f"--tp-impl ring shards attention heads: "
                             f"num_heads {self.num_heads} must divide by "
                             f"the 'model' axis ({axis.size})")
        for name in self.block_names:
            getattr(self, name).tp = axis

    def forward(self, x):
        b = x.shape[0]
        x = self.patch_embed(x.to(self.dtype).permute(0, 3, 1, 2))
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.d_model)  # (B, T, D)
        cls = self.cls.to(self.dtype).expand(b, 1, self.d_model)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        for name in self.block_names:
            x, _ = getattr(self, name)(x)
        x = self.ln_f(x)
        return self.head(x[:, 0]).float()


# standard plans (depth, width, heads); patch size overridable per call
ViTTiny = partial(ViT, num_layers=12, d_model=192, num_heads=3)
ViTSmall = partial(ViT, num_layers=12, d_model=384, num_heads=6)
ViTBase = partial(ViT, num_layers=12, d_model=768, num_heads=12)
ViTCifar = partial(ViT, patch_size=4, num_layers=8, d_model=256,
                   num_heads=8)
