"""The native host data path of the port (``tpu_dist/_native``): row
gather and libjpeg decode in C++, bound with ctypes.

Sources are the port's own copies, ``csrc/gather.cpp`` and
``csrc/decode.cpp`` (with ``csrc/jpeg_fixture.cpp``, which writes test
trees only). They build with ``g++ -O3 -fPIC -shared -std=c++17`` into one
library in ``kernels.build_dir()``, named by a hash of the sources, the
compiler and the flags, under the same lock and atomic rename as the CUDA
builds, so concurrent ranks and test workers never load a half-written
file. ``-ljpeg`` is linked where a link probe succeeds (``csrc/Makefile``'s
rule); otherwise the sources stub the decode out (``TPU_DIST_NO_JPEG``)
and :func:`decode_available` is False. ``CXX`` names the compiler
(default ``g++``).

Semantics are the reference's: :func:`gather_batch` memcpy's whole rows
and takes the numpy route for a non-contiguous array or an index out of
range; :func:`decode_jpeg` returns None on bytes that fail to decode. One
difference: a failed build raises, naming the command and the compiler's
output, where the reference keeps numpy quietly. :data:`ROUTES` counts
which route served each call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from tpu_dist_torch import kernels

SOURCES = ("gather.cpp", "decode.cpp", "jpeg_fixture.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_PROBE = ("#include <cstdio>\n#include <cstddef>\n#include <jpeglib.h>\n"
          "int main(){jpeg_decompress_struct c; jpeg_create_decompress(&c);"
          " return 0;}\n")

# calls served per route: gather_native / gather_numpy (gather_batch),
# decode_native / decode_failed (decode_jpeg)
ROUTES: Dict[str, int] = {"gather_native": 0, "gather_numpy": 0,
                          "decode_native": 0, "decode_failed": 0}
_routes_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_routes() -> None:
    with _routes_lock:
        for k in ROUTES:
            ROUTES[k] = 0


def _count(route: str) -> None:
    with _routes_lock:
        ROUTES[route] += 1


def cxx() -> str:
    return os.environ.get("CXX") or "g++"


def links_jpeg(compiler: str) -> bool:
    """``csrc/Makefile``'s probe: does a libjpeg program compile and link?"""
    try:
        res = subprocess.run([compiler, "-x", "c++", "-", "-ljpeg", "-o",
                              os.devnull], input=_PROBE, text=True,
                             capture_output=True, timeout=120)
    except FileNotFoundError:
        return False
    return res.returncode == 0


def build_command(out: str, compiler: str, jpeg: bool) -> list:
    srcs = [os.path.join(kernels.CSRC, s) for s in SOURCES]
    return [compiler, *CXX_FLAGS, *(() if jpeg else ("-DTPU_DIST_NO_JPEG",)),
            "-o", out, *srcs, *(("-ljpeg",) if jpeg else ())]


def library_path(compiler: str, jpeg: bool) -> str:
    digest = hashlib.sha1(" ".join(build_command("", compiler, jpeg))
                          .encode())
    for s in SOURCES:
        with open(os.path.join(kernels.CSRC, s), "rb") as f:
            digest.update(f.read())
    return os.path.join(kernels.build_dir(),
                        f"native.{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Build the library if it is missing; returns its path. Raises with
    the command and the compiler's output when the build fails."""
    compiler = cxx()
    jpeg = links_jpeg(compiler)
    out = library_path(compiler, jpeg)
    if os.path.isfile(out):
        return out
    os.makedirs(kernels.build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = build_command(tmp, compiler, jpeg)
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"native host library build failed: "
                           f"{' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"native host library build failed (exit "
                           f"{res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with kernels._lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.gather_rows_u8.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_int64] * 2
            lib.gather_rows_u8.restype = None
            lib.gather_i32.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_int64]
            lib.gather_i32.restype = None
            lib.decode_available.argtypes = []
            lib.decode_available.restype = ctypes.c_int
            lib.decode_jpeg_resize_crop.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.decode_jpeg_resize_crop.restype = ctypes.c_int
            lib.write_jpeg_fixture.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p]
            lib.write_jpeg_fixture.restype = ctypes.c_int
            _lib = lib
        return _lib


def gather_batch(images: np.ndarray, labels: np.ndarray, indices,
                 native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """``(images[indices], labels[indices])`` with int32 labels, by native
    row memcpy. The numpy route serves a non-contiguous ``images``, an
    index out of range (numpy raises or wraps as it does) and
    ``native=False`` (the comparison hook of ``tools/data_rate.py``)."""
    idx_arr = np.asarray(indices)
    in_bounds = (idx_arr.size == 0 or
                 (idx_arr.min() >= 0 and idx_arr.max() < images.shape[0]))
    if not (native and images.flags.c_contiguous and in_bounds):
        _count("gather_numpy")
        return images[indices], labels[indices].astype(np.int32)
    lib = _load()
    idx = np.ascontiguousarray(idx_arr, np.int64)
    n = idx.shape[0]
    row_bytes = images.dtype.itemsize * int(np.prod(images.shape[1:]))
    out_imgs = np.empty((n,) + images.shape[1:], images.dtype)
    lib.gather_rows_u8(images.ctypes.data, idx.ctypes.data,
                       out_imgs.ctypes.data, n, row_bytes)
    lab = np.ascontiguousarray(labels, np.int32)
    out_lab = np.empty((n,), np.int32)
    lib.gather_i32(lab.ctypes.data, idx.ctypes.data, out_lab.ctypes.data, n)
    _count("gather_native")
    return out_imgs, out_lab


def decode_available() -> bool:
    """True when the library was built against libjpeg."""
    return bool(_load().decode_available())


def decode_jpeg(data: bytes, size: int) -> Optional[np.ndarray]:
    """JPEG bytes -> (size, size, 3) RGB u8: libjpeg's DCT-scaled decode, a
    bilinear resize of the short side to ``size * 256 // 224`` and a
    center crop (``csrc/decode.cpp``). None when the bytes fail to decode.
    Raises when the library has no libjpeg (ask :func:`decode_available`
    first)."""
    lib = _load()
    if not lib.decode_available():
        raise RuntimeError("the native host library was built without "
                           "libjpeg (no jpeglib.h, or -ljpeg does not link)")
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.decode_jpeg_resize_crop(data, len(data), size,
                                     size * 256 // 224, out.ctypes.data)
    _count("decode_native" if rc == 0 else "decode_failed")
    return out if rc == 0 else None


def write_jpeg_fixture(rgb: np.ndarray, path: str, quality: int = 90
                       ) -> None:
    """Write an (H, W, 3) uint8 image as a JPEG with libjpeg's compressor.
    For test trees only (``tools/data_rate.py`` without PIL)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or not 1 <= quality <= 100:
        raise ValueError(f"write_jpeg_fixture takes (H, W, 3) uint8 and a "
                         f"quality in 1..100, got {rgb.shape}, {quality}")
    rc = _load().write_jpeg_fixture(rgb.ctypes.data, rgb.shape[0],
                                    rgb.shape[1], quality,
                                    os.fsencode(path))
    if rc != 0:
        raise RuntimeError(f"write_jpeg_fixture({path!r}) failed ({rc}): "
                           + ("no libjpeg in the native library" if rc < 0
                              else "cannot write the file"))
