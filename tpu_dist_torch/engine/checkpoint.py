"""Checkpoint save and resume for the port (``tpu_dist/engine/checkpoint.py``).

What follows the reference:

* one container file per checkpoint, ``MAGIC | u64-le meta_len | meta json
  | blob``, committed by one ``os.replace``; the meta carries the
  reference's keys (``epoch``, ``arch``, ``best_acc1``, ``step``, the
  trainer's run geometry, ``mid_epoch``) plus ``blob_len`` and a CRC32 of
  the blob, so a torn or bit-rotted file is detected at load;
* keep-last-K retention as step-stamped hard links
  (``{arch}-checkpoint.r<step>.pt``) and a newest-valid pointer
  (``{arch}-checkpoint.index.json``); a corrupt newest file falls back to
  the newest intact retained one, while a structure mismatch never falls
  back;
* ``{arch}-checkpoint.pt`` and a ``{arch}-model_best.pt`` copy on
  improvement; :func:`read_checkpoint_meta` reads the header alone;
* ``async_write=True``: the device-to-host copy happens in the caller, the
  serialization and the write in a thread (one writer per directory;
  :func:`wait_for_async_save` joins it and re-raises its error).

* the warm start (``:358-398``): :func:`load_warmstart` reads a
  checkpoint's params and BN stats by leaf name without a template, and
  :func:`graft_params` overlays the leaves whose name and shape match onto
  a fresh model (cast to this run's storage dtype); the run starts a fresh
  optimizer at step 0.

What differs: the blob is ``torch.save`` of the host state (the card has
no msgpack), so the port neither reads nor writes the reference's
``.msgpack`` files, and a warm start's donor is one of the port's own
``.pt`` checkpoints; the state is restored in place into the live
``TrainState``'s tensors. ``peer_restore_state`` (``TPU_DIST_PEER_RESUME``)
is not ported.
"""

from __future__ import annotations

import atexit
import glob
import io
import json
import os
import re
import shutil
import sys
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import torch

_MAGIC = b"TDTORCH1\n"
SUFFIX = ".pt"


class CheckpointCorruptError(ValueError):
    """The named checkpoint and every retained fallback failed their
    integrity checks (CRC32/length from the container header)."""


def host_state(state) -> dict:
    """A CPU copy of everything a resume needs: the step, the params, the
    BN running stats and every optimizer-state tensor, field by field."""
    cpu = lambda t: t.detach().to("cpu", copy=True)
    opt = {}
    for name, v in zip(state.opt_state._fields, state.opt_state):
        opt[name] = cpu(v) if torch.is_tensor(v) else [cpu(t) for t in v]
    ls = state.loss_scale
    return {"step": int(state.step),
            "params": [cpu(p) for p in state.params],
            "batch_stats": [cpu(b) for b in state.batch_stats],
            "param_names": list(state.param_names),
            "stat_names": list(state.stat_names),
            "loss_scale": None if ls is None else [cpu(t) for t in ls],
            "opt_state": opt}


def _split_container(raw: bytes) -> Tuple[Dict, memoryview]:
    if not raw.startswith(_MAGIC):
        raise CheckpointCorruptError("not a tpu_dist_torch checkpoint "
                                     "(bad magic)")
    off = len(_MAGIC)
    meta_len = int.from_bytes(raw[off:off + 8], "little")
    meta = json.loads(raw[off + 8:off + 8 + meta_len])
    return meta, memoryview(raw)[off + 8 + meta_len:]


def _integrity_error(meta: Dict, blob) -> Optional[str]:
    want_len = meta.get("blob_len")
    if want_len is not None and len(blob) != int(want_len):
        return (f"blob is {len(blob)} bytes, header says {want_len} "
                "(truncated write?)")
    want_crc = meta.get("crc32")
    if want_crc is not None:
        got = zlib.crc32(blob) & 0xFFFFFFFF
        if got != int(want_crc):
            return f"CRC32 mismatch (header {want_crc:#010x}, file {got:#010x})"
    return None


def _retained_path(path: str, step: int) -> str:
    root, ext = os.path.splitext(path)
    return f"{root}.r{int(step)}{ext}"


def retained_checkpoints(path: str) -> List[str]:
    """The keep-last-K retained siblings of a checkpoint path, newest
    (highest step) first."""
    root, ext = os.path.splitext(path)
    found = []
    for p in glob.glob(f"{glob.escape(root)}.r*{ext}"):
        m = re.fullmatch(re.escape(root) + r"\.r(\d+)" + re.escape(ext), p)
        if m:
            found.append((int(m.group(1)), p))
    return [p for _, p in sorted(found, reverse=True)]


def _retain(path: str, meta: Dict, keep: int, is_best: bool) -> None:
    """Keep-last-K hard links (copies where the FS has none) and the
    newest-valid pointer, written after the newest file committed."""
    retained = []
    if keep > 0:
        snap = _retained_path(path, meta.get("step", 0))
        try:
            if os.path.exists(snap):
                os.remove(snap)
            try:
                os.link(path, snap)
            except OSError:
                shutil.copyfile(path, snap)
        except OSError as e:
            print(f"warning: checkpoint retention copy failed: {e}",
                  file=sys.stderr)
        retained = retained_checkpoints(path)
        for stale in retained[keep:]:
            try:
                os.remove(stale)
            except OSError:
                pass
        retained = retained[:keep]
    root, _ = os.path.splitext(path)
    index = {"newest": os.path.basename(path), "step": meta.get("step"),
             "epoch": meta.get("epoch"), "crc32": meta.get("crc32"),
             "retained": [os.path.basename(p) for p in retained],
             "best": (f"{meta.get('arch')}-model_best{SUFFIX}"
                      if is_best else None)}
    tmp = root + ".index.json.tmp"
    with open(tmp, "w") as f:
        json.dump(index, f)
    os.replace(tmp, root + ".index.json")


def _write(ckpt_dir: str, path: str, state: dict, meta: Dict, arch: str,
           is_best: bool, keep: int) -> None:
    buf = io.BytesIO()
    torch.save(state, buf)
    blob = buf.getvalue()
    meta = dict(meta, blob_len=len(blob), crc32=zlib.crc32(blob) & 0xFFFFFFFF)
    meta_bytes = json.dumps(meta).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(len(meta_bytes).to_bytes(8, "little"))
        f.write(meta_bytes)
        f.write(blob)
    os.replace(tmp, path)
    with open(path + ".json.tmp", "w") as f:   # human-readable sidecar
        json.dump(meta, f)
    os.replace(path + ".json.tmp", path + ".json")
    _retain(path, meta, keep, is_best)
    if is_best:
        best = os.path.join(ckpt_dir, f"{arch}-model_best{SUFFIX}")
        for src, dst in ((path, best), (path + ".json", best + ".json")):
            shutil.copyfile(src, dst + ".tmp")
            os.replace(dst + ".tmp", dst)


class _AsyncWriter:
    __slots__ = ("thread", "error")

    def __init__(self):
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None


_writers: Dict[str, _AsyncWriter] = {}
_writers_lock = threading.Lock()


def _writer_for(ckpt_dir: str) -> _AsyncWriter:
    key = os.path.abspath(ckpt_dir or ".")
    with _writers_lock:
        return _writers.setdefault(key, _AsyncWriter())


def wait_for_async_save(ckpt_dir: Optional[str] = None) -> None:
    """Block until pending async writes finish (``None``: every
    directory); re-raises any error a writer hit."""
    with _writers_lock:
        if ckpt_dir is None:
            pending = list(_writers.values())
        else:
            w = _writers.get(os.path.abspath(ckpt_dir))
            pending = [w] if w is not None else []
    first_err = None
    for w in pending:
        if w.thread is not None:
            w.thread.join()
            w.thread = None
        if w.error is not None:
            first_err = first_err or w.error
            w.error = None
    if first_err is not None:
        raise RuntimeError("async checkpoint write failed") from first_err


# a process must never exit with a write in flight (daemon threads die
# mid-write at interpreter shutdown)
atexit.register(wait_for_async_save)


def save_checkpoint(ckpt_dir: str, state, epoch: int, best_acc1: float,
                    arch: str, is_best: bool,
                    extra_meta: Optional[Dict] = None,
                    async_write: bool = False, keep: int = 0) -> str:
    """Save ``state`` (a ``TrainState``); returns the checkpoint path. The
    device-to-host copy runs here; with ``async_write`` the write runs in a
    thread (not readable until :func:`wait_for_async_save`)."""
    host = host_state(state)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{arch}-checkpoint{SUFFIX}")
    meta = {"epoch": epoch, "arch": arch, "best_acc1": float(best_acc1),
            "step": host["step"], **(extra_meta or {})}
    writer = _writer_for(ckpt_dir)
    wait_for_async_save(ckpt_dir)   # one writer per directory
    if async_write:
        def run():
            try:
                _write(ckpt_dir, path, host, meta, arch, is_best, keep)
            except BaseException as e:  # re-raised by wait_for_async_save
                writer.error = e
        writer.thread = threading.Thread(target=run, daemon=True)
        writer.thread.start()
    else:
        _write(ckpt_dir, path, host, meta, arch, is_best, keep)
    return path


def peer_restore_state(state, broadcast=None):
    raise NotImplementedError(
        "peer_restore_state (TPU_DIST_PEER_RESUME=1) is not ported yet: the "
        "port runs one process on one device")


def read_checkpoint_meta(path: str) -> Dict:
    """The container's meta header alone, without reading the blob."""
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC) + 8)
        if not head.startswith(_MAGIC):
            return {}
        meta_len = int.from_bytes(head[len(_MAGIC):], "little")
        return json.loads(f.read(meta_len))


def _restore_into(state, host: dict) -> None:
    """Copy ``host`` into the live ``state``'s tensors; raise ValueError on
    any structure or shape mismatch, before anything is copied."""
    fields = state.opt_state._fields
    if set(host["opt_state"]) != set(fields):
        raise ValueError(f"optimizer state fields {sorted(host['opt_state'])}"
                         f" in the checkpoint, {sorted(fields)} in the run "
                         "(a different --optimizer?)")
    groups = [("params", state.params, host["params"]),
              ("batch_stats", state.batch_stats, host["batch_stats"])]
    ls = host.get("loss_scale")
    if (ls is None) != (state.loss_scale is None):
        raise ValueError(f"loss scale {'in' if ls is not None else 'not in'}"
                         " the checkpoint, "
                         f"{'on' if state.loss_scale is not None else 'off'}"
                         " in the run")
    if ls is not None:
        groups.append(("loss_scale", list(state.loss_scale), ls))
    for name, v in zip(fields, state.opt_state):
        src = host["opt_state"][name]
        groups.append((f"opt_state.{name}", [v] if torch.is_tensor(v) else v,
                       [src] if torch.is_tensor(v) else src))
    for what, dst, src in groups:
        if len(dst) != len(src):
            raise ValueError(f"{what}: {len(src)} tensors in the checkpoint, "
                             f"{len(dst)} in the run")
        for i, (d, s) in enumerate(zip(dst, src)):
            if tuple(d.shape) != tuple(s.shape):
                raise ValueError(f"{what}[{i}]: shape {tuple(s.shape)} in the "
                                 f"checkpoint, {tuple(d.shape)} in the run")
    with torch.no_grad():
        for _, dst, src in groups:
            for d, s in zip(dst, src):
                d.copy_(s.to(device=d.device, dtype=d.dtype))
    state.step = int(host["step"])


def load_warmstart(path: str) -> Tuple[Dict, Dict, Dict]:
    """(params, batch_stats, meta) of a checkpoint, without a template:
    ``{leaf name: CPU tensor}`` for each. It carries no optimizer state: a
    warm start begins a fresh trajectory, unlike ``--resume``."""
    with open(path, "rb") as f:
        raw = f.read()
    meta, blob = _split_container(raw)
    bad = _integrity_error(meta, blob)
    if bad:
        raise CheckpointCorruptError(f"checkpoint {path!r} is corrupt: {bad}")
    host = torch.load(io.BytesIO(bytes(blob)), map_location="cpu",
                      weights_only=True)
    if "param_names" not in host:
        raise ValueError(f"checkpoint {path!r} carries no leaf names; a warm "
                         "start needs a checkpoint of this version")
    return (dict(zip(host["param_names"], host["params"])),
            dict(zip(host["stat_names"], host["batch_stats"])), meta)


@torch.no_grad()
def graft_params(named: List[Tuple[str, torch.Tensor]],
                 loaded: Dict[str, torch.Tensor]) -> Tuple[int, List[str]]:
    """Copy each ``loaded`` leaf into the live tensor of the same name in
    ``named`` (``model.named_parameters()`` or ``named_buffers()``) where
    the shapes match, cast to the live tensor's dtype; the others keep
    their fresh values. Returns (leaves copied, names skipped)."""
    n, skipped = 0, []
    for name, t in named:
        src = loaded.get(name)
        if src is not None and tuple(src.shape) == tuple(t.shape):
            t.copy_(src.to(device=t.device, dtype=t.dtype))
            n += 1
        else:
            skipped.append(name)
    return n, skipped


def _load_one(path: str, state) -> Dict:
    with open(path, "rb") as f:
        raw = f.read()
    meta, blob = _split_container(raw)
    bad = _integrity_error(meta, blob)
    if bad:
        raise CheckpointCorruptError(f"checkpoint {path!r} is corrupt: {bad}")
    host = torch.load(io.BytesIO(bytes(blob)), map_location="cpu",
                      weights_only=True)
    try:
        _restore_into(state, host)
    except (ValueError, KeyError) as e:
        raise ValueError(f"checkpoint {path!r} does not match the current "
                         f"run's state: {e}") from e
    return meta


def load_checkpoint(path: str, state, fallback: bool = True
                    ) -> Tuple[object, Dict]:
    """Restore a checkpoint of :func:`save_checkpoint` into ``state`` in
    place; returns ``(state, meta)``. A file that fails its integrity check
    falls back (with ``fallback``) to the retained siblings newest first;
    a structure mismatch raises at once."""
    candidates = [path] + (retained_checkpoints(path) if fallback else [])
    last_err: Optional[Exception] = None
    for i, p in enumerate(candidates):
        try:
            meta = _load_one(p, state)
        except (CheckpointCorruptError, FileNotFoundError) as e:
            print(f"warning: {e}"
                  + ("; falling back to the previous retained checkpoint"
                     if i + 1 < len(candidates) else ""), file=sys.stderr)
            last_err = e
            continue
        if i > 0:
            print(f"warning: resumed from RETAINED checkpoint {p!r} "
                  f"(step {meta.get('step')}): the newest was corrupt",
                  file=sys.stderr)
        return state, meta
    raise CheckpointCorruptError(
        f"checkpoint {path!r} is corrupt and no intact retained fallback "
        f"exists ({len(candidates) - 1} sibling(s) tried)") from last_err
