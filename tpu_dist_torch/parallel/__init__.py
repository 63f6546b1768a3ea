"""tpu_dist_torch.parallel: the process group as a mesh, launch and
rendezvous, collectives and bucketed gradient sync, and the model-parallel
axes (fsdp, tp, ring tp, ring attention, ep, pp; serving's ``sp`` axis is
the sharded page pool of ``engine.serve``)
(``tpu_dist/parallel/__init__.py``).

Attribute access is lazy (PEP 562), as in the reference: ``from
tpu_dist_torch.parallel import launch`` and ``from tpu_dist_torch.parallel
import make_mesh`` both work, and a submodule is imported at first use.
"""

import importlib

# public name -> submodule that defines it (None = the submodule itself)
_LAZY = {
    "launch": None,
    "mesh": None,
    "collectives": None,
    "overlap": None,
    "fsdp": None,
    "tp": None,
    "ep": None,
    "ring_attention": None,
    # parallel.launch
    "LaunchInfo": "launch", "detect_launch": "launch",
    "initialize": "launch",
    # parallel.mesh
    "DATA_AXIS": "mesh", "FSDP_AXIS": "mesh", "MODEL_AXIS": "mesh",
    "SEQ_AXIS": "mesh", "EXPERT_AXIS": "mesh", "SP_AXIS": "mesh",
    "make_mesh": "mesh", "axis_mesh": "mesh", "world_info": "mesh",
    # parallel.collectives
    "adasum_reduce": "collectives", "allreduce_bench": "collectives",
    "barrier": "collectives", "compress_grads": "collectives",
    "pmean": "collectives", "psum": "collectives",
    "reduce_mean": "collectives", "ring_allreduce": "collectives",
    "ppermute": "collectives", "sum_bytes": "collectives",
    # parallel.overlap
    "bucketed_grad_sync": "overlap", "grad_buckets": "overlap",
    "RingDense": "overlap",
    # the model-parallel axes
    "fsdp_specs": "fsdp", "lm_param_specs": "tp", "ep_param_specs": "ep",
    "ring_attention_fn": "ring_attention",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    target = _LAZY[name]
    if target is None:
        return importlib.import_module(f"{__name__}.{name}")
    module = importlib.import_module(f"{__name__}.{target}")
    return getattr(module, name)


def __dir__():
    return __all__
