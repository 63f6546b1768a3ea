"""Build and load the port's hand-written CUDA kernels.

Route: each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Libraries go to
``build/tpu_dist_torch/`` beside the package (``TPU_DIST_TORCH_BUILD``
overrides), named by a hash of their source and flags, so an edited source
is rebuilt and a stale library is never loaded. Nothing is built at import
time: :func:`function` builds on first use, :func:`build` builds a set of
sources in parallel (one ``nvcc`` each, all started together).

Launch counts live in :data:`LAUNCHES`: each kernel's wrapper adds one
right after a launch returns success, and nowhere else.

Each kernel's plain PyTorch version is marked :func:`plain_version`: while
one runs, :func:`in_plain_version` is true, so the program audit
(``analysis.proglint``) can leave its operators out of the program's
compute, as a ctypes launch on the card is out of its sight.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional, Union

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG_DIR, "csrc")
SOURCES = {"flash_fwd": "flash_fwd.cu", "paged_decode": "paged_decode.cu",
           "flash_bwd_dq": "flash_bwd_dq.cu",
           "flash_bwd_dkv": "flash_bwd_dkv.cu", "adamw": "adamw.cu",
           "sgd": "sgd.cu", "fused_quant": "fused_quant.cu",
           "flash_fwd_int8kv": "flash_fwd_int8kv.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# a source's own headers, inlined by tools/cuda_emu.py and hashed into the
# library's name
LOCAL_INCLUDE = re.compile(r'^#include "([\w.]+)"$', re.M)

# what the C entries take: the dtype code of their float inputs/outputs
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The head dims of the five attention kernels, the rule of
# csrc/head_dim.cuh: every d from 1 up, as the reference's kernels take
# each head's whole d as one block. Up to 256 each source compiles
# instances at these head dims: the exact one runs d equal to it on
# tensors that start on a 16-byte boundary; the general one runs every
# other d up to it (8 on 16, 24 on 32, 33 and 48 on 64, 100 on 128, 136
# and 200 on 256) with the true d at run time, zeros past d in shared
# memory and nothing stored past d, so no tensor is copied or padded. Rows
# that are not whole 16-byte chunks on 16-byte boundaries (an odd d, a
# misaligned view) run on a third tensor-core instance that copies them by
# narrower cp.async or byte loads. Above 256 every d runs on the wide path
# (HEAD_DIM_WIDE): a block owns one chunk of the output's columns, the
# scores summed over d in slices streamed through shared memory, so
# neither registers nor shared memory grow with d; there is no ceiling.
# The C entries return -1 for d < 1.
HEAD_DIM_INSTANCES = (16, 32, 64, 128, 256)
HEAD_DIM_WIDE = "wide"
HEAD_DIM_RULE = "every head dim from 1 up"


def head_dim_instance(d: int) -> Union[int, str, None]:
    """The compiled head dim that runs head dim ``d`` (16 .. 256),
    :data:`HEAD_DIM_WIDE` above 256, or None where nothing does (d < 1):
    ``csrc/head_dim.cuh``'s ``tdt_head_dim_instance``."""
    if d < 1:
        return None
    if d > HEAD_DIM_INSTANCES[-1]:
        return HEAD_DIM_WIDE
    return min(i for i in HEAD_DIM_INSTANCES if i >= d)


def check_head_dim(kernel: str, d: int) -> Union[int, str]:
    """``head_dim_instance(d)``; raises ``ValueError`` naming ``d`` and the
    rule where nothing runs it."""
    inst = head_dim_instance(d)
    if inst is None:
        raise ValueError(f"{kernel}: head_dim {d} is refused: the kernels "
                         f"take {HEAD_DIM_RULE} (the rule of "
                         "csrc/head_dim.cuh; no kernel instance runs it)")
    return inst

# the entries a source exposes beyond its one-call kernel, each counted by
# its own wrapper: fused_quant's scales and product phases apart
EXTRA_LAUNCHES = ("fused_quant_amax", "fused_quant_scaled")
LAUNCHES: Dict[str, int] = {name: 0 for name in (*SOURCES,
                                                 *EXTRA_LAUNCHES)}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_plain = threading.local()


def plain_version(fn):
    """Mark ``fn`` as a kernel's plain version (module docstring)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        _plain.depth = getattr(_plain, "depth", 0) + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _plain.depth -= 1
    return run


def in_plain_version() -> bool:
    """Whether a kernel's plain version is running on this thread."""
    return getattr(_plain, "depth", 0) > 0


def build_dir() -> str:
    return os.environ.get("TPU_DIST_TORCH_BUILD") or os.path.join(
        os.path.dirname(PKG_DIR), "build", "tpu_dist_torch")


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source on first use")


def source_files(name: str) -> list:
    """``csrc/<name>.cu`` and the local headers it includes
    (``#include "x.cuh"``, resolved in ``csrc/``)."""
    path = os.path.join(CSRC, SOURCES[name])
    with open(path) as f:
        headers = LOCAL_INCLUDE.findall(f.read())
    return [path] + [os.path.join(CSRC, h) for h in headers]


def _lib_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):   # a header edit rebuilds its users
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(build_dir(), f"{name}.{digest.hexdigest()[:12]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source whose library is missing, all ``nvcc``
    processes started together. Returns {name: seconds} for the sources
    compiled (ptxas's register/shared-memory report lands in
    ``<build_dir>/<name>.log``); raises with the compiler's output when
    any build fails."""
    names = list(SOURCES if names is None else names)
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.isfile(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    took, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        with open(os.path.join(build_dir(), f"{name}.log"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} (nvcc exit {proc.returncode}):"
                          f"\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


def function(name: str, symbol: str, argtypes):
    """The C entry ``symbol`` of kernel ``name`` (library built first if
    needed), with its argument types set and an int (cudaError_t) result."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn
