"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes each measured piece of work needs, computed from the cell's shapes.

One function per operation. Counts are the least the work needs: each
input byte read once, each output byte written once, no recomputation,
masked (causal) pairs not counted. A roofline share or a model FLOP
utilisation divides these by a measured time, so it can only understate.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

# dense peaks by card name fragment (NVIDIA H100 SXM data sheet): FLOP/s by
# compute type, and HBM bytes/s
PEAKS = {"H100": {"bf16": 989e12, "fp32": 67e12, "bytes": 3.35e12}}


def peak(device_name: str, what: str) -> float:
    for key, table in PEAKS.items():
        if key in device_name:
            return table[what]
    raise KeyError(f"no peak table for {device_name!r}")


def bound_s(flops: float, nbytes: float, device_name: str,
            dtype: str = "bf16") -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory rate."""
    return max(flops / peak(device_name, dtype),
               nbytes / peak(device_name, "bytes"))


# ---- the language model ---------------------------------------------------

def lm_model(config_model: dict) -> dict:
    """The decoder's sizes under the benchmark's names, from a
    configuration in GPT-2's keys (the MLP is 4 x n_embd, GPT-2's
    convention where ``n_inner`` is not given)."""
    d = config_model["n_embd"]
    return {"vocab_size": config_model["vocab_size"],
            "num_layers": config_model["n_layer"], "d_model": d,
            "num_heads": config_model["n_head"],
            "mlp_dim": config_model.get("n_inner") or 4 * d,
            "max_len": config_model["n_positions"],
            "ln_eps": config_model["layer_norm_epsilon"],
            "init_std": config_model["initializer_range"]}


def lm_shapes(model: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the GPT-style decoder by name and shape (the
    layout the benchmark makes its weights in): dense kernels (in, out)."""
    v, d, n = model["vocab_size"], model["d_model"], model["num_layers"]
    f = model["mlp_dim"]
    out = {"tok_emb.weight": (v, d), "pos_emb.weight": (model["max_len"], d)}
    for i in range(n):
        p = f"blocks.{i}."
        out.update({p + "ln1.scale": (d,), p + "ln1.bias": (d,),
                    p + "qkv.kernel": (d, 3 * d), p + "proj.kernel": (d, d),
                    p + "ln2.scale": (d,), p + "ln2.bias": (d,),
                    p + "mlp_in.kernel": (d, f), p + "mlp_in.bias": (f,),
                    p + "mlp_out.kernel": (f, d), p + "mlp_out.bias": (d,)})
    out.update({"ln_f.scale": (d,), "ln_f.bias": (d,),
                "lm_head.kernel": (d, v)})
    return out


def numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def lm_nonembedding_params(model: dict) -> int:
    return sum(numel(s) for k, s in lm_shapes(model).items()
               if not k.startswith(("tok_emb", "pos_emb")))


def lm_train_flops_per_token(model: dict, seq_len: int) -> float:
    """Model FLOPs a trained token (forward and backward, no
    recomputation): 6 x non-embedding params + 6 x layers x L x d, the
    accounting of the port's ``utils/mfu.py`` (copied)."""
    return (6.0 * lm_nonembedding_params(model)
            + 6.0 * model["num_layers"] * seq_len * model["d_model"])


def causal_pairs(seq: int) -> int:
    """(query, key) pairs a causal mask keeps over ``seq`` positions."""
    return seq * (seq + 1) // 2


def attention_bwd_work(batch: int, heads: int, seq: int, head_dim: int,
                       elem: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of causal attention's backward at one layer: the
    four products it needs (dV = P^T dO, dP = dO V^T, dQ = dS K,
    dK = dS^T Q) over the kept pairs, scores not recomputed; reads q, k,
    v, o, dO and the fp32 row statistics once, writes dq, dk, dv once."""
    pairs = batch * heads * causal_pairs(seq)
    flops = 4 * 2.0 * pairs * head_dim
    tensors = batch * seq * heads * head_dim * elem
    nbytes = 8 * tensors + batch * heads * seq * 4
    return flops, nbytes


# ---- the image model ------------------------------------------------------

def resnet_forward_flops(model: dict) -> float:
    """Forward FLOPs of one image through a torchvision-plan bottleneck
    ResNet (v1.5: stride on the 3x3) with the ImageNet stem: 2 x the
    multiply-adds of every convolution and of the dense head (norms, pools
    and activations not counted), from the configuration's shapes."""
    h = model["image_size"]
    macs = 0

    def conv(cin, cout, k, stride, pad, hin):
        hout = (hin + 2 * pad - k) // stride + 1
        return cin * k * k * cout * hout * hout, hout

    m, h = conv(model["in_channels"], 64, 7, 2, 3, h)
    macs += m
    h = (h + 2 - 3) // 2 + 1                      # 3x3/2 max pool, pad 1
    cin = 64
    for stage, count in enumerate(model["stage_sizes"]):
        width = 64 * 2 ** stage
        out = width * 4
        for j in range(count):
            stride = 2 if stage > 0 and j == 0 else 1
            m0, h0 = conv(cin, width, 1, 1, 0, h)
            m1, h1 = conv(width, width, 3, stride, 1, h0)
            m2, _ = conv(width, out, 1, 1, 0, h1)
            macs += m0 + m1 + m2
            if stride != 1 or cin != out:
                md, _ = conv(cin, out, 1, stride, 0, h)
                macs += md
            cin, h = out, h1
    macs += cin * model["num_classes"]
    return 2.0 * macs
