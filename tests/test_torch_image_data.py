"""The port's image data layer against the reference, on CPU:

* the synthetic CIFAR-10, MNIST and ImageNet sets are bit-equal to the
  reference's;
* the CIFAR-10 pickle and MNIST idx loaders read tiny files written here in
  the torchvision on-disk formats, as the reference's do;
* ``normalize`` matches the reference's in fp32 and bf16;
* the loader's batches and ``valid`` masks are bit-equal to the reference
  ``DataLoader``'s for the same sampler, and ``prefetch_to_device`` on the
  CPU hands the same arrays through;
* ``random_shift`` and ``random_flip`` keep the shape and are deterministic
  for a given generator (JAX's PRNG cannot be matched)."""

import gzip
import os
import pickle
import struct

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.data import datasets as jds  # noqa: E402
from tpu_dist.data import pipeline as jpipe  # noqa: E402
from tpu_dist.data.loader import DataLoader as JaxDataLoader  # noqa: E402
from tpu_dist.data.sampler import DistributedSampler as JaxSampler  # noqa: E402
from tpu_dist_torch.data import datasets as tds  # noqa: E402
from tpu_dist_torch.data import pipeline as tpipe  # noqa: E402
from tpu_dist_torch.data.loader import (DataLoader,  # noqa: E402
                                        prefetch_to_device)
from tpu_dist_torch.data.sampler import DistributedSampler  # noqa: E402

torch.set_num_threads(1)


def _same(ref, port):
    assert (ref.name, ref.num_classes) == (port.name, port.num_classes)
    for a in ("images", "labels", "mean", "std"):
        r, p = getattr(ref, a), getattr(port, a)
        assert r.dtype == p.dtype
        np.testing.assert_array_equal(r, p)


@pytest.mark.parametrize("name", ["cifar10", "synthetic-cifar10", "mnist",
                                  "imagenet"])
def test_synthetic_sets_bit_equal(tmp_path, name):
    """With no files under the root each name is its synthetic set
    (``imagenet``: 224 x 224 x 3, 1000 classes, no ``train``/``val``
    folders)."""
    kw = dict(synth_train=96, synth_val=40, seed=7)
    root = str(tmp_path / "absent")
    for ref, port in zip(jds.load_dataset(name, root, **kw),
                         tds.load_dataset(name, root, **kw)):
        _same(ref, port)


def _write_cifar(root, n_per_batch=12):
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rng.integers(0, 255, (n_per_batch, 3072))
                 .astype(np.uint8),
                 b"labels": rng.integers(0, 10, n_per_batch).tolist()}
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(batch, f)


def _write_idx(path, arr, gz):
    header = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(header + arr.tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_real_format_loaders_match_reference(tmp_path, gz):
    root = str(tmp_path)
    _write_cifar(root)
    rng = np.random.default_rng(1)
    sfx = ".gz" if gz else ""
    for stem, shape in (("train-images-idx3-ubyte", (30, 28, 28)),
                        ("train-labels-idx1-ubyte", (30,)),
                        ("t10k-images-idx3-ubyte", (10, 28, 28)),
                        ("t10k-labels-idx1-ubyte", (10,))):
        hi = 255 if "images" in stem else 10
        _write_idx(os.path.join(root, stem + sfx),
                   rng.integers(0, hi, shape).astype(np.uint8), gz)
    for name, shapes in (("cifar10", ((60, 32, 32, 3), (12, 32, 32, 3))),
                         ("mnist", ((30, 28, 28, 1), (10, 28, 28, 1)))):
        port = tds.load_dataset(name, root)
        for ref, p, shape in zip(jds.load_dataset(name, root), port, shapes):
            _same(ref, p)
            assert p.images.shape == shape and p.images.dtype == np.uint8
            assert p.labels.dtype == np.int32


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_normalize_matches_reference(dtype):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (4, 8, 8, 3)).astype(np.uint8)
    mean, std = tds.CIFAR10_MEAN, tds.CIFAR10_STD
    ref = jpipe.normalize(jnp.asarray(imgs), jnp.asarray(mean),
                          jnp.asarray(std), jdt)
    port = tpipe.make_transform(mean, std, dtype=tdt)(torch.from_numpy(imgs))
    assert port.dtype == tdt and port.shape == imgs.shape
    np.testing.assert_array_equal(port.float().numpy(),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("train,workers", [(True, 1), (False, 3)])
def test_loader_batches_bit_equal(train, workers):
    ds_ref, _ = jds.load_dataset("synthetic-cifar10", "", 70, 10, seed=3)
    ds, _ = tds.load_dataset("synthetic-cifar10", "", 70, 10, seed=3)
    for epoch in (0, 1):
        got = []
        for cls, loader_cls, d in ((JaxSampler, JaxDataLoader, ds_ref),
                                   (DistributedSampler, DataLoader, ds)):
            s = cls(len(d), 1, 0, shuffle=train, seed=5, batch_size=16)
            s.set_epoch(epoch)
            got.append(list(loader_cls(d, s, 16, workers=workers,
                                       emit_valid=not train)))
        assert len(got[0]) == len(got[1]) == 5      # 70 padded to 80
        for ref, port in zip(*got):
            assert len(ref) == len(port) == (2 if train else 3)
            for r, p in zip(ref, port):
                assert r.dtype == p.dtype
                np.testing.assert_array_equal(r, p)
        staged = list(prefetch_to_device(iter(got[1]), "cpu"))
        for host, dev in zip(got[1], staged):
            for h, t in zip(host, dev):
                np.testing.assert_array_equal(h, t.numpy())
    if not train:
        assert got[1][-1][2].sum() == 70 - 4 * 16   # padding rows masked


def test_random_shift_and_flip_keep_shape_and_are_deterministic():
    x = torch.arange(2 * 6 * 5 * 3, dtype=torch.float32).reshape(2, 6, 5, 3)
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(11)
        outs.append(tpipe.random_flip(tpipe.random_shift(x, gen, 2), gen))
    assert outs[0].shape == x.shape
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    flipped = tpipe.random_flip(x, torch.Generator().manual_seed(0))
    for b in range(2):   # each sample is itself or its mirror
        assert (torch.equal(flipped[b], x[b])
                or torch.equal(flipped[b], x[b].flip(1)))
    assert tpipe.random_shift(x, torch.Generator(), 0) is x
    aug = tpipe.make_transform(np.zeros(3), np.ones(3), augment=True)
    u8 = torch.zeros((2, 6, 5, 3), dtype=torch.uint8)
    assert aug(u8, torch.Generator().manual_seed(1)).shape == u8.shape
