"""Int8 weight quantization for the port (``tpu_dist/ops/quant.py``).

Same conventions as the reference, so int8 values are bit-equal: one
symmetric scale per slice along the non-reduced dims,
``scale = max(amax, 1e-8) / 127``, ``q = clip(round(x / scale), -127,
127)`` with round-half-to-even (``torch.round``, like ``jnp.round``).

Modes of the ``quant`` knob:

* ``none``    -- exact matmul in the compute dtype;
* ``int8_wo`` -- weight-only: weights fake-quantize, or live as int8 with
  fp32 per-output-channel scales (:func:`wo_quantize_params` trees and
  :meth:`QuantDense.load_quantized`) and dequantize at each call;
* ``int8``    -- dynamic activation+weight int8 through
  ``ops.pallas_quant.fused_quant_matmul``: the Hopper kernel
  ``csrc/fused_quant.cu`` for CUDA tensors, its plain version for CPU
  tensors, with a straight-through backward. The dispatch switch
  (:func:`set_fused_quant`, seeded by ``TPU_DIST_FUSED_QUANT``; the plan's
  ``fused_quant``) routes it instead through :func:`quant_einsum`, the
  reference's unfused path, when set off (``:50-72, 167-175``).

Dense kernels keep flax's ``(in, out)`` layout (``y = x @ kernel``), so a
flax param tree loads without transposes and per-channel scales keep the
reference's ``(1, out)`` shape.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
from torch import nn

QUANT_MODES = ("none", "int8", "int8_wo")

_INT8_MAX = 127.0
_EPS = 1e-8  # floor for all-zero channels: keeps scale finite, q = 0

# ---- the fused-kernel dispatch switch (``:50-72``) --------------------------
# None = auto, True = on: ``quant_matmul(..., "int8")`` runs
# ``ops.pallas_quant.fused_quant_matmul`` (the kernel for CUDA tensors);
# False = off: the unfused quant_einsum. TPU_DIST_FUSED_QUANT=1/0 seeds it.
_FUSED_QUANT: Optional[bool] = (
    None if os.environ.get("TPU_DIST_FUSED_QUANT", "") == ""
    else os.environ["TPU_DIST_FUSED_QUANT"] not in ("0", "false", ""))


def set_fused_quant(enabled: Optional[bool]) -> None:
    """Force the fused int8 kernel on (True) or off (False); None restores
    auto, which is on. Set before the step runs (``plan.compile
    .activate_plan`` does)."""
    global _FUSED_QUANT
    _FUSED_QUANT = enabled


def fused_quant_active() -> bool:
    """Whether ``quant_matmul(mode="int8")`` routes through
    ``fused_quant_matmul`` now: auto and on do, off does not (the trainers
    stamp it into step records as the ``fused`` flag)."""
    return _FUSED_QUANT is not False


def validate_quant(mode: str) -> str:
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {mode!r} "
                         f"({'|'.join(QUANT_MODES)})")
    return mode


_DIVISORS: dict = {}


def _int8_max_on(device: torch.device) -> torch.Tensor:
    """127 as a 0-d float32 tensor on ``device``, made once per device. On
    CUDA, torch divides by a Python scalar (or a 0-d CPU tensor) as a
    multiply by its reciprocal, one rounding away from the reference's (and
    the kernels') IEEE division; a 0-d tensor on the same device is divided
    by truly, with no fill per call."""
    d = _DIVISORS.get(device)
    if d is None:
        # a normal tensor even when first asked for under inference_mode:
        # autograd saves the divisor where the dividend needs a gradient
        with torch.inference_mode(False):
            d = _DIVISORS[device] = torch.tensor(_INT8_MAX, device=device)
    return d


def quantize_int8(x: torch.Tensor, reduce_dims) -> tuple:
    """Symmetric int8 quantization of ``x`` with one scale per slice along
    the non-reduced dims (``reduce_dims``: amax over them, kept). Returns
    (q int8, scale fp32); ``q * scale`` dequantizes."""
    xf = x.float()
    return quantize_by_amax(xf, xf.abs().amax(dim=tuple(reduce_dims),
                                              keepdim=True))


def quantize_by_amax(x: torch.Tensor, amax: torch.Tensor) -> tuple:
    """:func:`quantize_int8` with the maxima given (``amax`` broadcast
    against ``x``): where a tensor-parallel group shares a contracted dim,
    the maxima are the whole dim's, taken over the group."""
    scale = torch.clamp(amax.float(), min=_EPS) / _int8_max_on(amax.device)
    q = torch.clamp(torch.round(x.float() / scale), -_INT8_MAX, _INT8_MAX)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def wo_fake_quant(w: torch.Tensor, reduce_dims=(0,)) -> torch.Tensor:
    """Forward sees the int8 round trip of ``w`` (per-channel scales over
    ``reduce_dims``); a gradient would pass straight through."""
    q, scale = quantize_int8(w, reduce_dims)
    wq = dequantize(q, scale, w.dtype)
    return w + (wq - w).detach()


def _dense_spec(ndim: int) -> str:
    """'abd,dZ->abZ'-style spec of an (..., D) x (D, F) dense matmul."""
    batch = "abcegh"[:ndim - 1]
    return f"{batch}d,dZ->{batch}Z"


def quant_matmul(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """The mode dispatch of a (..., D) x (D, F) matmul; both operands are
    already in the compute dtype."""
    if mode == "int8":
        if not fused_quant_active():
            # both operands quantized, exact integer sums, STE backward
            return quant_einsum(_dense_spec(x.dim()), x, w)
        # local import: ops.pallas_quant imports quantize_int8 from here
        from tpu_dist_torch.ops.pallas_quant import fused_quant_matmul
        return fused_quant_matmul(x, w)
    if mode == "int8_wo":
        return x @ wo_fake_quant(w)
    validate_quant(mode)
    return x @ w


class QuantDense(nn.Module):
    """Dense layer with flax's parameter names and layout: ``kernel``
    (in, out), optional ``bias`` (out,). ``mode`` is the quant knob.

    Parameters are stored in ``param_dtype`` (default: the compute dtype
    ``dtype``) and cast to ``dtype`` at every call, as flax does. Serving
    stores them in the compute dtype, which for inference gives the same
    values once; training keeps fp32 masters (``param_dtype=float32``), so
    optimizer updates smaller than a bf16 ulp are not rounded away. (A
    bf16-stored model wo-quantized here quantizes the bf16-rounded weights;
    the reference quantizes its fp32 masters. Load a tree quantized by
    :func:`wo_quantize_params` to match it exactly.)

    After :meth:`load_quantized` the kernel is an int8 buffer with an fp32
    ``kernel_scale`` (1, out) and is dequantized on each call -- the
    weight-only decode path of the reference's pre-quantized trees.
    """

    def __init__(self, in_features: int, features: int, mode: str = "none",
                 use_bias: bool = True, dtype=torch.float32, device=None,
                 param_dtype=None):
        super().__init__()
        validate_quant(mode)
        self.in_features, self.features = in_features, features
        self.mode = mode
        self.dtype = dtype
        param_dtype = dtype if param_dtype is None else param_dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features,
                                               dtype=param_dtype,
                                               device=device),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                              device=device),
                                  requires_grad=False)
                     if use_bias else None)
        self.register_buffer("kernel_scale", None)

    @property
    def prequantized(self) -> bool:
        return self.kernel_scale is not None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's ``lecun_normal``: truncated normal (2 std) with variance
        1/fan_in; bias zeros."""
        std = math.sqrt(1.0 / self.in_features) / .87962566103423978
        with torch.no_grad():
            w = torch.empty(self.kernel.shape, dtype=torch.float32,
                            device=self.kernel.device)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            self.kernel.copy_(w)
            if self.bias is not None:
                self.bias.zero_()

    def load_quantized(self, q: torch.Tensor, scale: torch.Tensor) -> None:
        """Hold the kernel as int8 ``q`` (in, out) with fp32 ``scale``
        (1, out) -- the reference's ``wo_quantize_params`` leaves."""
        if q.dtype != torch.int8 or tuple(q.shape) != (self.in_features,
                                                       self.features):
            raise ValueError(f"expected an int8 kernel of shape "
                             f"{(self.in_features, self.features)}, got "
                             f"{q.dtype} {tuple(q.shape)}")
        dev = self.kernel.device
        del self.kernel
        self.register_buffer("kernel", q.to(dev))
        self.register_buffer("kernel_scale",
                             scale.to(device=dev, dtype=torch.float32))

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """The product without the bias (the tensor-parallel layers add a
        sliced or a post-reduction bias themselves)."""
        x = x.to(self.dtype)
        if self.prequantized:
            if self.mode == "int8":
                # a wo-quantized layer has lost its fp weights: the dynamic
                # int8 product cannot be built from it (the reference's
                # refusal, not a silent weight-only fallback)
                raise ValueError(
                    "layer holds a pre-quantized int8 kernel "
                    "(kernel_scale, wo_quantize_params) but mode='int8' was "
                    "requested; pre-quantized kernels only support the "
                    "weight-only path -- use quant='int8_wo', or keep the "
                    "fp weights for dynamic int8")
            return x @ dequantize(self.kernel, self.kernel_scale, self.dtype)
        return quant_matmul(x, self.kernel.to(self.dtype), self.mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.matmul(x)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def make_dense(in_features: int, features: int, *, use_bias: bool = True,
               dtype=torch.float32, quant: str = "none", device=None,
               param_dtype=None) -> QuantDense:
    """The dense-layer factory of the transformer family (one module type
    for every quant mode, so the knob never forks the param layout)."""
    return QuantDense(in_features, features, mode=validate_quant(quant),
                      use_bias=use_bias, dtype=dtype, device=device,
                      param_dtype=param_dtype)


# ---- MoE expert matmuls (``:109-160, 266-277``) ----------------------------

def _contracted_dims(spec: str, operand: str) -> tuple:
    """Dims of ``operand`` (one side of an 'ab,bc->ac' einsum) that do not
    survive to the output: the dims its int8 scale reduces over."""
    out = spec.split("->")[1]
    return tuple(i for i, ch in enumerate(operand) if ch not in out)


class _QuantEinsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, lhs, rhs):
        ctx.spec = spec
        ctx.save_for_backward(lhs, rhs)
        l_sub, r_sub = spec.split("->")[0].split(",")
        ql, sl = quantize_int8(lhs, _contracted_dims(spec, l_sub))
        qr, sr = quantize_int8(rhs, _contracted_dims(spec, r_sub))
        # int32 sums, exact in float64 while |acc| < 2^53
        acc = torch.einsum(spec, ql.double(), qr.double())
        scale = torch.einsum(spec, sl, sr)   # contracted dims are size 1
        return (acc.float() * scale).to(lhs.dtype)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs = ctx.saved_tensors
        with torch.enable_grad():
            a, b = lhs.detach().requires_grad_(), rhs.detach().requires_grad_()
            out = torch.einsum(ctx.spec, a, b)
            ga, gb = torch.autograd.grad(out, (a, b), g)
        return None, ga, gb


def quant_einsum(spec: str, lhs: torch.Tensor, rhs: torch.Tensor
                 ) -> torch.Tensor:
    """``einsum(spec, lhs, rhs)`` with both operands int8-quantized (one
    scale per slice over each operand's contracted dims) and exact integer
    sums; the backward is the straight-through estimator, the vjp of the
    fp einsum. The plain version the MoE expert path is held to."""
    return _QuantEinsum.apply(spec, lhs, rhs)


EXPERT_SPECS = ("gecd,edf->gecf", "gecf,efd->gecd")


def moe_expert_matmul(spec: str, acts: torch.Tensor, w: torch.Tensor,
                      quant: str = "none", group=None) -> torch.Tensor:
    """One expert contraction (``EXPERT_SPECS``: acts (G, E, C, K) x w
    (E, K, N) -> (G, E, C, N)) under the quant mode: the fp einsum
    (``none``), the weight fake-quantized over its contracted dim
    (``int8_wo``), or ``int8``: each expert's (G*C, K) x (K, N) product
    through ``ops.pallas_quant.fused_quant_matmul`` (``csrc/fused_quant.cu``
    for CUDA tensors, one call per expert; its plain version on the CPU),
    whose per-row and per-column scales over K are exactly
    :func:`quant_einsum`'s, with the same STE backward. ``group``: K is
    this rank's shard of a dim the group shares (the experts' row-parallel
    ``w_out`` under tensor parallelism); the int8 scales are then the
    whole K's (``ops.pallas_quant.fused_quant_matmul(group=)``)."""
    if validate_quant(quant) == "none":
        return torch.einsum(spec, acts, w)
    if spec not in EXPERT_SPECS:
        raise ValueError(f"moe_expert_matmul takes {EXPERT_SPECS}, got "
                         f"{spec!r}")
    if quant == "int8_wo":
        return torch.einsum(spec, acts, wo_fake_quant(w, (1,)))
    from tpu_dist_torch.ops.pallas_quant import fused_quant_matmul

    g, e, c, k = acts.shape
    outs = [fused_quant_matmul(acts[:, i].reshape(g * c, k), w[i], group)
            .reshape(g, c, w.shape[-1]) for i in range(e)]
    return torch.stack(outs, 1)


# ---- weight-only decode: pre-quantized param trees ------------------------

def wo_quantize_params(params: dict) -> dict:
    """Pre-quantize a flax-layout param tree (nested dicts of tensors):
    every 2-D ``kernel`` becomes int8 with a sibling fp32
    ``kernel_scale`` (1, out); embeddings, norms and biases are untouched.
    The dense TransformerLM tree only -- the reference's MoE expert rule
    has no ported model yet."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = wo_quantize_params(v)
        elif k == "kernel" and getattr(v, "ndim", 0) == 2:
            q, s = quantize_int8(torch.as_tensor(v), (0,))
            out[k], out[k + "_scale"] = q, s
        else:
            out[k] = v
    return out


def params_are_wo_quantized(params) -> bool:
    """True if ``params`` (a flax-layout tree, or a module) carries
    pre-quantized ``*_scale`` leaves."""
    if isinstance(params, nn.Module):
        return any(isinstance(m, QuantDense) and m.prequantized
                   for m in params.modules())

    def walk(tree):
        return any(str(k).endswith("_scale")
                   or (isinstance(v, dict) and walk(v))
                   for k, v in tree.items())
    return walk(params)
