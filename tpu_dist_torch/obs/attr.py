"""Cost attribution of one training step for the port
(``tpu_dist/obs/attr.py``): bucket the step's operators by category.

The reference walks the optimized HLO of its compiled step; an eager step
has no HLO. The port watches the step run instead: :class:`CostModelMode`
is a ``TorchDispatchMode`` over one step (forward, backward and update)
that sees every aten operator it dispatches. Module hooks mark the
forward of an attention module, and the autograd nodes that forward made
mark its backward (the node the engine runs, ``torch._C.
_current_autograd_node``, under ``autograd.grad`` too). It accumulates
per-category flop and byte estimates in the reference's categories:

* ``matmul``       — mm / addmm / bmm / baddbmm / convolution and their
  backward: flops from ``torch.utils.flop_counter``'s formulas;
* ``attention``    — any operator under a module whose class names
  attention (``attn``, ``attention``, ``flash``: the transformer's
  ``Attention``, the contraction of ``blocks.N.attn``), forward and
  backward, flops by the same formulas, ~1 per output element for the
  rest;
* ``collective:*`` — c10d operators (all-reduce, all-gather,
  reduce-scatter, all-to-all, broadcast, point to point), bytes = operand +
  result sizes, flops 0;
* ``elementwise``  — every other operator that computes (~1 flop per
  output element); views and allocations are free.

Bytes are each operator's operand and result sizes. Estimates, not
measurements, as in the reference: the hand-written CUDA kernels (the
flash attention triple, AdamW, SGD, the fused int8 matmul) launch through
ctypes, outside the dispatcher, so their inner flops and bytes are
invisible here, as Pallas custom calls are opaque to the reference's HLO
walk; elementwise flops are 1 per element. The point is the share
structure beside the measured step times.

The mode costs Python time per operator, so the trainers run it on the
run's first step only (warm: left out of every rate), when the ledger has
a path, never under CUDA graph capture and never while a profiler session
or the flight recorder's window runs.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# modules whose operators are attention, by class name (the transformer's
# Attention: the contraction of blocks.N.attn)
_ATTN_RE = re.compile(r"attn|attention|flash", re.I)
_MATMULS = ("mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution",
            "convolution_backward", "cudnn_convolution",
            "convolution_overrideable", "_slow_conv2d_forward", "_scaled_mm")
# c10d operator name -> the reference's collective names
_COLLECTIVES = (("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
                ("allgather", "all-gather"), ("all_gather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"),
                ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
                ("broadcast", "collective-broadcast"),
                ("send", "collective-permute"),
                ("recv", "collective-permute"))
# operators that move no data: allocations and bookkeeping (views are
# recognized by their schema)
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_local_scalar_dense", "record_stream", "set_", "resize_",
         "is_same_size", "_has_compatible_shallow_copy_type"}


def _nbytes(tree) -> float:
    leaves, _ = tree_flatten(tree)
    return float(sum(t.numel() * t.element_size() for t in leaves
                     if isinstance(t, torch.Tensor)))


def _numel(tree) -> float:
    leaves, _ = tree_flatten(tree)
    return float(sum(t.numel() for t in leaves
                     if isinstance(t, torch.Tensor)))


def _collective(ns: str, name: str) -> Optional[str]:
    if ns not in ("c10d", "_c10d_functional", "c10d_functional"):
        return None
    for key, coll in _COLLECTIVES:
        if key in name:
            return "collective:" + coll
    return "collective:" + name


def _add(acc: dict, cat: str, flops: float, nbytes: float) -> None:
    b = acc.setdefault(cat, {"flops": 0.0, "bytes": 0.0, "count": 0})
    b["flops"] += flops
    b["bytes"] += nbytes
    b["count"] += 1


def _grad_fns(tree) -> list:
    leaves, _ = tree_flatten(tree)
    return [t.grad_fn for t in leaves
            if isinstance(t, torch.Tensor) and t.grad_fn is not None]


class CostModelMode(TorchDispatchMode):
    """Accumulate ``{category: {'flops', 'bytes', 'count'}}`` over the
    operators dispatched inside ``with CostModelMode() as m:``;
    :meth:`buckets` reads them."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # the mode never runs under torch.compile: wrapping its dispatch in
        # dynamo's disable would import torch._dynamo (seconds a process)
        return False

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self._acc: Dict[str, dict] = {}
        self._attn_depth = 0       # attention forwards open now
        self._attn_inputs = []     # their inputs' autograd nodes
        self._attn_nodes = set()   # the nodes their forwards made
        self._hooks = []

    def __enter__(self):
        from torch.nn.modules.module import (
            register_module_forward_hook, register_module_forward_pre_hook)

        self._hooks = [register_module_forward_pre_hook(self._pre),
                       register_module_forward_hook(self._post)]
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for h in self._hooks:
                h.remove()
            self._hooks = []

    def _pre(self, mod, args):
        if _ATTN_RE.search(type(mod).__name__):
            self._attn_depth += 1
            self._attn_inputs.append(set(_grad_fns(args)))

    def _post(self, mod, args, out):
        """Close an attention forward: the autograd nodes between its
        outputs and its inputs are its backward's."""
        if not _ATTN_RE.search(type(mod).__name__):
            return
        self._attn_depth -= 1
        stop = self._attn_inputs.pop()
        todo = _grad_fns(out)
        while todo:
            node = todo.pop()
            if node in stop or node in self._attn_nodes or \
                    type(node).__name__ == "AccumulateGrad":
                continue
            self._attn_nodes.add(node)
            todo.extend(n for n, _ in node.next_functions if n is not None)

    def _in_attention(self) -> bool:
        return (self._attn_depth > 0
                or torch._C._current_autograd_node() in self._attn_nodes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        coll = _collective(func.namespace, name)
        if coll is not None:
            _add(self._acc, coll, 0.0, _nbytes((args, kwargs, out)))
            return out
        if func.is_view or name in _FREE:
            return out
        formula = self._flops.get(func.overloadpacket)
        # mm/bmm(..., out_dtype) pass the dtype third, where the library's
        # formula takes its output shape: count the product of the two
        fargs = args[:2] if func._overloadname == "dtype" else args
        flops = (float(formula(*fargs, **kwargs, out_val=out))
                 if formula is not None else _numel(out))
        if self._in_attention():
            cat = "attention"
        elif name in _MATMULS:
            cat = "matmul"
        elif formula is not None:     # the library's attention kernels
            cat = "attention"
        else:
            cat = "elementwise"
        _add(self._acc, cat, flops, _nbytes((args, kwargs, out)))
        return out

    def buckets(self) -> Dict[str, dict]:
        return {c: {"flops": round(b["flops"], 3),
                    "bytes": round(b["bytes"], 3), "count": b["count"]}
                for c, b in self._acc.items()}


def bucket_totals(buckets: Dict[str, dict]) -> dict:
    """{'flops', 'bytes', 'collective_bytes'} rollup of the buckets."""
    return {
        "flops": sum(b["flops"] for b in buckets.values()),
        "bytes": sum(b["bytes"] for b in buckets.values()),
        "collective_bytes": sum(b["bytes"] for c, b in buckets.items()
                                if c.startswith("collective:")),
    }


def effective_peaks(device, dtype) -> tuple:
    """(peak TFLOP/s, peak GB/s, is_nominal) of ``device``: the card's
    published dense peak for ``dtype`` and memory rate
    (``device.PEAK_FLOPS``, ``device.PEAK_BYTES``), or a nominal 1.0 each
    where the table has none (the CPU), as the reference's defaults."""
    from tpu_dist_torch.device import peak_bytes, peak_flops

    dev = torch.device(device)
    flops, nbytes = peak_flops(dev, dtype), peak_bytes(dev)
    return (flops / 1e12 if flops else 1.0, nbytes / 1e9 if nbytes else 1.0,
            not (flops and nbytes))


def emit_cost_model(ledger, program: str, buckets: Dict[str, dict], device,
                    dtype) -> Optional[dict]:
    """Emit the ``cost_model`` ledger event of one program's buckets
    (None when there are none). ``xla_flops`` stays in the record, None:
    there is no compiler cost model to cross-check against."""
    if not buckets:
        return None
    tot = bucket_totals(buckets)
    peak_tf, peak_gb, nominal = effective_peaks(device, dtype)
    return ledger.emit(
        "cost_model", program=program, buckets=buckets,
        total_flops=tot["flops"], total_bytes=tot["bytes"],
        collective_bytes=tot["collective_bytes"], xla_flops=None,
        peak_tflops=peak_tf, peak_gbps=peak_gb, peak_is_nominal=nominal)


class FirstDispatch:
    """The run's first dispatch of a program, for its ``compile`` and
    ``cost_model`` events: resets the allocator's peak on a CUDA device
    before it, and with ``cost=True`` runs the body under
    :class:`CostModelMode` (not under CUDA graph capture)."""

    def __init__(self, device, cost: bool):
        self.device = torch.device(device)
        self.cost = cost
        self.mode: Optional[CostModelMode] = None

    def __enter__(self):
        from tpu_dist_torch.utils.telemetry import reset_peak

        reset_peak(self.device)
        capturing = (self.device.type == "cuda"
                     and torch.cuda.is_current_stream_capturing())
        if self.cost and not capturing:
            self.mode = CostModelMode()
            self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        if self.mode is not None:
            self.mode.__exit__(*exc)
        return False

    def buckets(self) -> Dict[str, dict]:
        return self.mode.buckets() if self.mode is not None else {}
