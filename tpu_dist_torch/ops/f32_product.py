"""Products of compute-dtype operands with an fp32 result: the port's
``jnp.dot``/``jnp.einsum(..., preferred_element_type=float32)``.

:func:`mm_f32` (2-d, no autograd: the chunked head's custom backward) and
:func:`matmul_f32` (batched, differentiable: the attention scores) run
``torch.mm``/``torch.bmm(..., out_dtype=float32)`` where this PyTorch
takes it for the operands' dtype and device. Elsewhere, and for mixed
operands (an fp32 cotangent against a bf16 operand, as the reference's
transposed product has), both operands are upcast: a product of two bf16
values is exact in fp32, so this is the same function with fp32
accumulation (TF32 must be off, PyTorch's default), only the summation
order may differ.

An upcast product runs inside :func:`_as_product`, which names the
operand dtypes it stands for: :func:`product_operands` reads them, so the
program audit (``analysis.proglint``, PL004) records the product the
program asked for, bf16 operands with an fp32 output, and not the fp32
matmul that computes it on this PyTorch.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional, Tuple

import torch

_operands = threading.local()


@contextlib.contextmanager
def _as_product(*dtypes: torch.dtype):
    prev = getattr(_operands, "dtypes", None)
    _operands.dtypes = dtypes
    try:
        yield
    finally:
        _operands.dtypes = prev


def product_operands() -> Optional[Tuple[torch.dtype, ...]]:
    """The operand dtypes of the fp32-output product an upcast is
    computing on this thread, or None outside one."""
    return getattr(_operands, "dtypes", None)


@functools.lru_cache(maxsize=None)
def _takes_out_dtype(op: str, device: str, dtype: torch.dtype) -> bool:
    """Whether this PyTorch runs ``torch.<op>(..., out_dtype=float32)``
    (``op`` mm or bmm) on ``dtype`` operands on ``device`` (asked once)."""
    a = torch.zeros((1, 1, 1)[:2 if op == "mm" else 3], dtype=dtype,
                    device=device)
    try:
        getattr(torch, op)(a, a, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return False
    return True


def _upcast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with _as_product(a.dtype, b.dtype):
        return torch.matmul(a.float(), b.float())


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two 2-d tensors of one compute dtype, fp32 result."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if _takes_out_dtype("mm", str(a.device), a.dtype):
        return torch.mm(a, b, out_dtype=torch.float32)
    return _upcast(a, b)


def mm_route(device, dtype) -> str:
    """Which product :func:`mm_f32` runs for ``dtype`` on ``device``:
    ``"out_dtype"``, ``"upcast"`` or ``"fp32"``."""
    if dtype == torch.float32:
        return "fp32"
    return ("out_dtype" if _takes_out_dtype(
        "mm", str(torch.device(device)), dtype) else "upcast")


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., m, k) @ (..., k, n), equal leading dims, fp32 result."""
    if a.dtype == b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.dtype == b.dtype and _takes_out_dtype("bmm", str(a.device),
                                                a.dtype):
        lead, (m, k), n = a.shape[:-2], a.shape[-2:], b.shape[-1]
        out = torch.bmm(a.reshape(-1, m, k), b.reshape(-1, k, n),
                        out_dtype=torch.float32)
        return out.reshape(*lead, m, n)
    return _upcast(a, b)


class _MatmulF32(torch.autograd.Function):
    """The fp32-output product with the reference's transposed products:
    each cotangent product takes the fp32 cotangent and the other
    operand, fp32 result, cast to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _product(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = _product(g, b.mT).to(a.dtype) if ctx.needs_input_grad[0] \
            else None
        gb = _product(a.mT, g).to(b.dtype) if ctx.needs_input_grad[1] \
            else None
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over (..., m, k) and (..., k, n) with equal leading
    dims, fp32 result, differentiable (module docstring)."""
    if a.dtype == b.dtype == torch.float32:
        return torch.matmul(a, b)
    return _MatmulF32.apply(a, b)
