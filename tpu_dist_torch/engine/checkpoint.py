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
no msgpack), and the state is restored in place into the live
``TrainState``'s tensors. A warm start's donor is a port ``.pt`` or a
reference ``.msgpack`` (``TPUDIST1`` container, with its CRC32 and length
checked, or bare msgpack from before the container with its ``.json``
sidecar), told apart by the file's first bytes, not its name; the
reference's tree is read by ``engine.flax_msgpack`` and its leaf names
mapped to the port's by ``interop.flax_named_leaves``. The port writes
``.pt`` only. Under data parallelism rank 0 writes and every rank resumes
from the same file; a sharded state (fsdp, tp, ep) is gathered leaf by
leaf on every rank first (``gather``), so the file holds whole leaves,
and a resume slices them again (``reslice``): the file does not depend on
the layout (``gather_to_host``, ``:44-70``).

The restart layer's two pieces (``:166``, ``:312-338``): the
``ckpt_enospc`` fault site raises ``OSError(ENOSPC)`` inside the container
write before any byte lands, so the pointer stays on the previous
committed container; :func:`peer_restore_state` adopts rank 0's live state
on every rank of a dp-pure group (``TPU_DIST_PEER_RESUME``) through
``collectives.sum_bytes``, one all-reduce over raw bytes in which rank 0
owns every byte (exact for every dtype, and the one collective gloo takes
on CUDA tensors as well as on CPU ones).
"""

from __future__ import annotations

import atexit
import errno
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

from tpu_dist_torch.obs import faults as _faults
from tpu_dist_torch.parallel.collectives import barrier

_MAGIC = b"TDTORCH1\n"
# the reference's container: the same header layout, a msgpack blob
_REF_MAGIC = b"TPUDIST1\n"
SUFFIX = ".pt"


class CheckpointCorruptError(ValueError):
    """The named checkpoint and every retained fallback failed their
    integrity checks (CRC32/length from the container header)."""


def _per_leaf(v, n_params: int) -> bool:
    """Whether an optimizer-state field is a list aligned with the params
    (momenta), as opposed to a scalar or an empty list."""
    return not torch.is_tensor(v) and len(v) == n_params > 0


def host_state(state, gather=None) -> dict:
    """A CPU copy of everything a resume needs: the step, the params, the
    BN running stats and every optimizer-state tensor, field by field.
    ``gather(i, t)`` turns leaf i's shard (or a per-leaf optimizer
    tensor's) into the whole tensor (a collective: every rank calls)."""
    cpu = lambda t: t.detach().to("cpu", copy=True)   # noqa: E731
    whole = (lambda i, t: cpu(gather(i, t.detach()))) if gather \
        else (lambda i, t: cpu(t))
    opt = {}
    for name, v in zip(state.opt_state._fields, state.opt_state):
        opt[name] = (cpu(v) if torch.is_tensor(v) else
                     [whole(i, t) for i, t in enumerate(v)]
                     if _per_leaf(v, len(state.params))
                     else [cpu(t) for t in v])
    ls = state.loss_scale
    return {"step": int(state.step),
            "params": [whole(i, p) for i, p in enumerate(state.params)],
            "batch_stats": [cpu(b) for b in state.batch_stats],
            "param_names": list(state.param_names),
            "stat_names": list(state.stat_names),
            "loss_scale": None if ls is None else [cpu(t) for t in ls],
            "opt_state": opt}


def _split_container(raw: bytes, magic: bytes = _MAGIC
                     ) -> Tuple[Dict, memoryview]:
    """(meta, blob) of a container with ``magic`` (the port's or the
    reference's header: ``magic | u64-le meta_len | meta json | blob``)."""
    if not raw.startswith(magic):
        raise CheckpointCorruptError("not a tpu_dist_torch checkpoint "
                                     "(bad magic)")
    off = len(magic)
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
    fault = _faults.fire("ckpt_enospc")
    if fault is not None:
        # before any byte lands: the checkpoint on disk stays the previous
        # valid one, which is exactly what the fallback path must find
        raise OSError(errno.ENOSPC,
                      f"No space left on device (injected: {fault.spec})")
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
                    async_write: bool = False, keep: int = 0,
                    mesh=None, gather=None) -> str:
    """Save ``state`` (a ``TrainState``); returns the checkpoint path. The
    device-to-host copy runs here; with ``async_write`` the write runs in a
    thread (not readable until :func:`wait_for_async_save`). Over a
    ``mesh`` (``parallel.mesh.Mesh``) rank 0 writes, then every rank meets
    at a barrier; a sharded state passes ``gather`` (:func:`host_state`),
    which every rank runs before the write."""
    path = os.path.join(ckpt_dir, f"{arch}-checkpoint{SUFFIX}")
    host = host_state(state, gather) if gather is not None else None
    if mesh is None or mesh.is_main:
        _save(ckpt_dir, path, host or host_state(state), epoch, best_acc1,
              arch, is_best, extra_meta, async_write, keep)
    if mesh is not None:
        barrier(mesh.device, mesh.group())
    return path


def _save(ckpt_dir, path, host, epoch, best_acc1, arch, is_best,
          extra_meta, async_write, keep) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
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


def _state_tensors(state) -> List[torch.Tensor]:
    """Every tensor of ``state`` a peer restore carries, in one fixed
    order: params, BN stats, each optimizer-state field, the loss scale."""
    out = list(state.params) + list(state.batch_stats)
    for v in state.opt_state:
        out.extend([v] if torch.is_tensor(v) else v)
    if state.loss_scale is not None:
        out.extend(state.loss_scale)
    return out


@torch.no_grad()
def peer_restore_state(state, group=None, broadcast=None):
    """Checkpoint-less dp-pure recovery (``:312-338``): adopt rank 0's
    live state on every rank of ``group``, in place. Returns ``(state,
    True)`` after the exchange, or ``(state, False)`` untouched on one
    process.

    On a mesh re-expansion a returning host has no (or a stale) local
    checkpoint, but every survivor holds the live replicated state, and
    the consensus renumbering (survivors first) makes rank 0 a survivor.
    Every rank must call this. Replicated (dp-pure) states only: sharded
    layouts take the disk path. The exchange is one
    ``collectives.sum_bytes`` over every tensor and the step counter, in
    which rank 0 sends its bytes and the others zeros (a byte plus zeros
    is that byte), on the tensors' own device. ``broadcast(tensors)``
    replaces it in tests."""
    from tpu_dist_torch.parallel.collectives import (group_rank, group_size,
                                                     sum_bytes)

    if broadcast is None and group_size(group) <= 1:
        return state, False
    live = _state_tensors(state)
    dev = live[0].device if live else torch.device("cpu")
    step = torch.tensor([int(state.step)], dtype=torch.int64, device=dev)
    sent = [step] + [t.detach() for t in live]
    if broadcast is not None:
        got = broadcast(sent)
    else:
        if group_rank(group) != 0:
            sent = [torch.zeros_like(t) for t in sent]
        got = sum_bytes(sent, group)
    for dst, src in zip(live, got[1:]):
        dst.copy_(src)
    state.step = int(got[0].item())
    return state, True


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


def _reference_warmstart(path: str, raw: bytes, model):
    """(params, batch_stats, meta) of a reference ``.msgpack``, leaf names
    mapped onto ``model``'s (``interop.flax_named_leaves``)."""
    from tpu_dist_torch.engine.flax_msgpack import msgpack_restore, split_tree
    from tpu_dist_torch.interop import flax_named_leaves

    if raw.startswith(_REF_MAGIC):
        meta, blob = _split_container(raw, _REF_MAGIC)
    else:                        # bare msgpack from before the container
        meta, blob = {}, memoryview(raw)
        if os.path.exists(path + ".json"):
            with open(path + ".json") as f:
                meta = json.load(f)
    bad = _integrity_error(meta, blob)
    if bad:
        raise CheckpointCorruptError(f"checkpoint {path!r} is corrupt: {bad}")
    if model is None:
        raise ValueError(f"{path!r} is a reference (msgpack) checkpoint: its "
                         "leaves are named onto a model, so pass the model")
    params, stats = split_tree(msgpack_restore(blob))
    named_p, named_s = flax_named_leaves(model, params, stats)
    return named_p, named_s, meta


def load_warmstart(path: str, model=None) -> Tuple[Dict, Dict, Dict]:
    """(params, batch_stats, meta) of a checkpoint, without a template:
    ``{leaf name: CPU tensor}`` for each. It carries no optimizer state: a
    warm start begins a fresh trajectory, unlike ``--resume``. A port
    ``.pt`` names its own leaves; a reference ``.msgpack`` (routed by the
    file's first bytes) is named onto ``model``."""
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(_MAGIC):
        return _reference_warmstart(path, raw, model)
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


def _reslice(host: dict, reslice) -> dict:
    """``host`` with each whole leaf (params, per-leaf optimizer tensors)
    cut to this rank's shard by ``reslice(i, t)``."""
    host = dict(host, params=[reslice(i, t)
                              for i, t in enumerate(host["params"])])
    host["opt_state"] = {
        name: ([reslice(i, t) for i, t in enumerate(v)]
               if _per_leaf(v, len(host["params"])) else v)
        for name, v in host["opt_state"].items()}
    return host


def _load_one(path: str, state, reslice=None) -> Dict:
    with open(path, "rb") as f:
        raw = f.read()
    meta, blob = _split_container(raw)
    bad = _integrity_error(meta, blob)
    if bad:
        raise CheckpointCorruptError(f"checkpoint {path!r} is corrupt: {bad}")
    host = torch.load(io.BytesIO(bytes(blob)), map_location="cpu",
                      weights_only=True)
    try:
        if reslice is not None:
            host = _reslice(host, reslice)
        _restore_into(state, host)
    except (ValueError, KeyError) as e:
        raise ValueError(f"checkpoint {path!r} does not match the current "
                         f"run's state: {e}") from e
    return meta


def load_checkpoint(path: str, state, fallback: bool = True, reslice=None
                    ) -> Tuple[object, Dict]:
    """Restore a checkpoint of :func:`save_checkpoint` into ``state`` in
    place; returns ``(state, meta)``. A file that fails its integrity check
    falls back (with ``fallback``) to the retained siblings newest first;
    a structure mismatch raises at once. ``reslice(i, t)`` cuts whole
    leaves to a sharded state's shards (:func:`_reslice`)."""
    candidates = [path] + (retained_checkpoints(path) if fallback else [])
    last_err: Optional[Exception] = None
    for i, p in enumerate(candidates):
        try:
            meta = _load_one(p, state, reslice)
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
