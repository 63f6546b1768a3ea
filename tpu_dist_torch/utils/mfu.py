"""Model FLOP accounting for the port (``tpu_dist/utils/mfu.py``): the
analytic counts behind the trainers' ``mfu`` and ``tflops`` columns, and
the card's peaks.

* :func:`lm_flops_per_token` and :func:`moe_lm_flops_per_token`: the
  reference's formulas over the whole model's (name, shape) pairs (the
  port reads shapes, not a param tree);
* :func:`image_forward_flops`: the image trainer's forward count, 2 x the
  MACs of the convs and dense layers of one image (the trainer takes 3 x
  it per trained image);
* :func:`peak_tflops_for`: the card's dense peak in TFLOP/s for a compute
  dtype, from ``device.PEAK_FLOPS`` (NVIDIA H100 SXM: 989 in bf16, 67 in
  fp32), None off CUDA and for a card the table does not hold.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_dist_torch.device import PEAK_FLOPS, peak_flops

__all__ = ["PEAK_FLOPS", "image_forward_flops", "lm_flops_per_token",
           "moe_lm_flops_per_token", "peak_tflops_for"]


def peak_tflops_for(device, dtype=torch.bfloat16) -> Optional[float]:
    """The dense peak of ``device`` for ``dtype`` in TFLOP/s, or None."""
    peak = peak_flops(torch.device(device), dtype)
    return peak / 1e12 if peak else None


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def lm_flops_per_token(named_shapes, num_layers: int, seq_len: int,
                       d_model: int) -> float:
    """Model FLOPs per trained token (the reference's ``utils/mfu.py``
    accounting): 6 * non-embedding params + 6 * layers * L * d, over the
    whole (unsharded) leaves' (name, shape) pairs."""
    n = sum(_numel(s) for name, s in named_shapes
            if not name.startswith(("tok_emb", "pos_emb")))
    return 6.0 * n + 6.0 * num_layers * seq_len * d_model


def moe_lm_flops_per_token(named_shapes, num_layers: int, seq_len: int,
                           d_model: int, num_experts: int, router_top_k: int,
                           total_tokens: int, group_size: int = 512,
                           capacity_factor: float = 1.25) -> float:
    """Model FLOPs per trained token of the MoE LM (``utils/mfu.py:54``):
    6 x the dense part (attention, norms, gate, head) + 6 x layers x L x d,
    6 x top_k x the expert params / E (the experts a token activates), and
    the dispatch and combine einsums, 2 x 6 x E x C x d a layer, C from the
    same ``moe_group_geometry`` the layer routes with."""
    from tpu_dist_torch.models.moe import moe_group_geometry

    n_params = n_embed = n_expert = 0
    for name, shape in named_shapes:
        size = _numel(shape)
        n_params += size
        if "tok_emb" in name or "pos_emb" in name:
            n_embed += size
        elif "w_in" in name or "w_out" in name:
            n_expert += size
    dense = 6.0 * (n_params - n_embed - n_expert) \
        + 6.0 * num_layers * seq_len * d_model
    experts = 6.0 * router_top_k * n_expert / num_experts
    _, cap = moe_group_geometry(total_tokens, seq_len, num_experts,
                                router_top_k, group_size, capacity_factor)
    routing = 2 * 6.0 * num_experts * cap * d_model * num_layers
    return dense + experts + routing


def image_forward_flops(model, image_shape) -> float:
    """Forward FLOPs per image of the convs and dense layers (2 x MACs),
    from one eval-mode forward of a single zero image."""
    from tpu_dist_torch.models.resnet import Conv
    from tpu_dist_torch.ops.quant import QuantDense

    total = [0.0]

    def conv_hook(mod, _inp, out):
        total[0] += 2.0 * out[0].numel() * mod.weight[0].numel()

    def dense_hook(mod, _inp, out):
        total[0] += 2.0 * out.numel() * mod.in_features   # every token

    hooks = [m.register_forward_hook(conv_hook if isinstance(m, Conv)
                                     else dense_hook)
             for m in model.modules() if isinstance(m, (Conv, QuantDense))]
    was_training, tuned = model.training, torch.backends.cudnn.benchmark
    model.eval()
    # no cuDNN autotuning for this one-off batch-1 forward
    torch.backends.cudnn.benchmark = False
    try:
        with torch.inference_mode():
            dev = next(model.parameters()).device
            model(torch.zeros((1, *image_shape), device=dev))
    finally:
        torch.backends.cudnn.benchmark = tuned
        model.train(was_training)
        for h in hooks:
            h.remove()
    return total[0]
