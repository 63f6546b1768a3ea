"""A reader of flax's msgpack checkpoints in the standard library, for the
port's warm starts from the reference (``tpu_dist/engine/checkpoint.py``
writes them with ``flax.serialization.to_bytes``). The card machine has
neither ``msgpack`` nor ``flax``, so this reads the format itself:

* msgpack's maps, arrays, strings, binaries, ints, floats, bools and nil;
* flax's ext type 1, the ndarray: a msgpack ``(shape, dtype name,
  C-order bytes)``, returned as a CPU tensor (``bfloat16`` read as raw
  ``uint16`` and viewed as ``torch.bfloat16``);
* ext type 3, the numpy scalar: the same payload, returned as a 0-d
  tensor;
* flax's chunked arrays (``{"__msgpack_chunked_array__": True, "shape",
  "chunks"}``), which it writes for leaves above 2^30 bytes, put back
  together.

Anything else (ext type 2, flax's complex number, among them) raises,
naming the type code. Nothing here writes msgpack: the port's checkpoints
stay ``.pt``.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
# dtype names flax writes -> numpy dtypes (bfloat16 travels as uint16)
_NP_DTYPES = {name: np.dtype(name) for name in (
    "float16", "float32", "float64", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "bool")}


class MsgpackError(ValueError):
    """A byte string this reader does not take."""


def _array(payload: bytes) -> torch.Tensor:
    shape, name, buf = unpackb(payload)
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        a = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    if name not in _NP_DTYPES:
        raise MsgpackError(f"ndarray of dtype {name!r} is not supported")
    a = np.frombuffer(buf, dtype=_NP_DTYPES[name]).reshape(shape)
    return torch.from_numpy(a.copy())


class _Reader:
    def __init__(self, data):
        self.b = memoryview(data)
        self.i = 0

    def take(self, n: int) -> memoryview:
        if self.i + n > len(self.b):
            raise MsgpackError("truncated msgpack data")
        out = self.b[self.i:self.i + n]
        self.i += n
        return out

    def fmt(self, f: str):
        return struct.unpack(">" + f, self.take(struct.calcsize(">" + f)))[0]

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _array(payload)
        if code == EXT_NPSCALAR:
            return _array(payload).reshape(())
        raise MsgpackError(f"msgpack ext type {code} is not supported "
                           "(flax writes 1: ndarray, 3: numpy scalar)")

    def read(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        if t in (0xC4, 0xC5, 0xC6):                       # bin 8/16/32
            return bytes(self.take(self.fmt("BHI"[t - 0xC4])))
        if t in (0xC7, 0xC8, 0xC9):                       # ext 8/16/32
            n = self.fmt("BHI"[t - 0xC7])
            return self.ext(self.fmt("b"), n)
        if t == 0xCA:
            return self.fmt("f")
        if t == 0xCB:
            return self.fmt("d")
        if 0xCC <= t <= 0xCF:                             # uint 8..64
            return self.fmt("BHIQ"[t - 0xCC])
        if 0xD0 <= t <= 0xD3:                             # int 8..64
            return self.fmt("bhiq"[t - 0xD0])
        if 0xD4 <= t <= 0xD8:                             # fixext 1..16
            code = self.fmt("b")
            return self.ext(code, 1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):                       # str 8/16/32
            return str(self.take(self.fmt("BHI"[t - 0xD9])), "utf-8")
        if t in (0xDC, 0xDD):                             # array 16/32
            return [self.read() for _ in range(self.fmt("HI"[t - 0xDC]))]
        if t in (0xDE, 0xDF):                             # map 16/32
            return self.map(self.fmt("HI"[t - 0xDE]))
        raise MsgpackError(f"msgpack type byte {t:#04x} is not supported")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data) -> Any:
    """One msgpack object from ``data`` (bytes or a buffer), with flax's
    ext types; the whole buffer must be that one object."""
    r = _Reader(data)
    out = r.read()
    if r.i != len(r.b):
        raise MsgpackError(f"{len(r.b) - r.i} trailing bytes after the "
                           "msgpack object")
    return out


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(_CHUNKED):
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data) -> Any:
    """``flax.serialization.msgpack_restore``: the tree of dicts, lists and
    scalars with tensor leaves, chunked arrays put back together."""
    return _unchunk(unpackb(data))


def split_tree(tree: dict) -> Tuple[dict, dict]:
    """(params, batch_stats) of a restored ``TrainState`` tree."""
    return tree.get("params", {}) or {}, tree.get("batch_stats", {}) or {}
