"""Image datasets for the port: a numpy copy of ``tpu_dist/data/datasets.py``.

* :class:`ArrayDataset` holds uint8 images (N, H, W, C) and int32 labels
  on the host; :meth:`ArrayDataset.get_batch` gathers rows through the
  port's native library (``native.gather_batch``: whole-row memcpy with
  the GIL released, numpy for a non-contiguous array or an index out of
  range), as the reference does through ``tpu_dist/_native``;
* :func:`_synthetic` is the reference's deterministic, learnable synthetic
  set (``:75-96``): images and labels are bit-equal to the reference's for
  the same seeds, because both draw from numpy's ``default_rng`` in the same
  order;
* the CIFAR-10 pickle (``cifar-10-batches-py``) and MNIST idx loaders read
  the torchvision on-disk formats when the files are under ``--data``;
  otherwise :func:`load_dataset` falls back to the synthetic set, as the
  reference does (``:143-172``);
* ``imagenet`` reads ``<root>/{train,val}/<class>/<image>`` through
  ``data.imagefolder`` when both folders exist, and is otherwise the
  synthetic 224x224x3, 1000-class set (``:164-171``).
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from tpu_dist_torch import native

# CIFAR10 channel stats, as hard-coded by the reference cookbook
CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)
MNIST_MEAN = np.array([0.1307], np.float32)
MNIST_STD = np.array([0.3081], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclass
class ArrayDataset:
    """Host-side dataset: uint8 images (N,H,W,C) + int32 labels (N,)."""

    images: np.ndarray
    labels: np.ndarray
    mean: np.ndarray
    std: np.ndarray
    num_classes: int
    name: str = "dataset"

    def __len__(self) -> int:
        return self.images.shape[0]

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return self.images.shape[1:]

    def get_batch(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The uint8 batch and its int32 labels for the given sample
        indices (``native.gather_batch``)."""
        return native.gather_batch(self.images, self.labels, indices)


def _synthetic(num: int, shape: Tuple[int, int, int], num_classes: int,
               proto_seed: int, sample_seed: int, name: str) -> ArrayDataset:
    """Deterministic learnable synthetic data: per-class low-frequency
    pattern + per-sample noise (the reference's ``_synthetic``, draw for
    draw). Class prototypes depend only on ``proto_seed`` so the train and
    val splits share one distribution; samples differ via
    ``sample_seed``."""
    proto_rng = np.random.default_rng(proto_seed)
    rng = np.random.default_rng(sample_seed)
    h, w, c = shape
    protos = proto_rng.normal(0.0, 1.0, size=(num_classes, 4, 4, c)).astype(np.float32)
    protos = np.repeat(np.repeat(protos, (h + 3) // 4, axis=1), (w + 3) // 4, axis=2)
    protos = protos[:, :h, :w, :]
    labels = rng.integers(0, num_classes, size=num).astype(np.int32)
    noise = rng.normal(0.0, 0.6, size=(num, h, w, c)).astype(np.float32)
    imgs = protos[labels] + noise
    imgs = np.clip((imgs + 3.0) / 6.0, 0.0, 1.0)
    images = (imgs * 255).astype(np.uint8)
    mean = np.full((c,), 0.5, np.float32)
    std = np.full((c,), 0.25, np.float32)
    return ArrayDataset(images, labels, mean, std, num_classes, name)


def _load_cifar10_pickles(root: str) -> Optional[Tuple[ArrayDataset, ArrayDataset]]:
    d = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(d):
        return None

    def load(names):
        xs, ys = [], []
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            xs.append(np.asarray(batch[b"data"], np.uint8))
            ys.append(np.asarray(batch[b"labels"], np.int32))
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return np.ascontiguousarray(x), np.concatenate(ys)

    xtr, ytr = load([f"data_batch_{i}" for i in range(1, 6)])
    xte, yte = load(["test_batch"])
    mk = lambda x, y, nm: ArrayDataset(x, y, CIFAR10_MEAN, CIFAR10_STD, 10, nm)
    return mk(xtr, ytr, "cifar10-train"), mk(xte, yte, "cifar10-val")


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _, _, ndim = struct.unpack(">HBB", f.read(4))
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def _load_mnist_idx(root: str) -> Optional[Tuple[ArrayDataset, ArrayDataset]]:
    for d in (root, os.path.join(root, "MNIST", "raw")):
        tri = os.path.join(d, "train-images-idx3-ubyte")
        if os.path.exists(tri) or os.path.exists(tri + ".gz"):
            def get(stem):
                p = os.path.join(d, stem)
                return _read_idx(p if os.path.exists(p) else p + ".gz")
            xtr = get("train-images-idx3-ubyte")[..., None]
            ytr = get("train-labels-idx1-ubyte").astype(np.int32)
            xte = get("t10k-images-idx3-ubyte")[..., None]
            yte = get("t10k-labels-idx1-ubyte").astype(np.int32)
            mk = lambda x, y, nm: ArrayDataset(x, y, MNIST_MEAN, MNIST_STD, 10, nm)
            return mk(xtr, ytr, "mnist-train"), mk(xte, yte, "mnist-val")
    return None


def load_dataset(name: str, root: str, synth_train: int = 50000,
                 synth_val: int = 10000, seed: int = 1234,
                 ) -> Tuple[ArrayDataset, ArrayDataset]:
    """Returns (train, val). Falls back to synthetic when files are absent."""
    name = name.lower()
    if name in ("cifar10", "synthetic", "synthetic-cifar10"):
        if name == "cifar10":
            real = _load_cifar10_pickles(root)
            if real is not None:
                return real
        tr = _synthetic(synth_train, (32, 32, 3), 10, seed, seed + 1, "synth-cifar10-train")
        va = _synthetic(synth_val, (32, 32, 3), 10, seed, seed + 2, "synth-cifar10-val")
        return tr, va
    if name in ("mnist", "synthetic-mnist"):
        if name == "mnist":
            real = _load_mnist_idx(root)
            if real is not None:
                return real
        tr = _synthetic(synth_train, (28, 28, 1), 10, seed, seed + 1, "synth-mnist-train")
        va = _synthetic(synth_val, (28, 28, 1), 10, seed, seed + 2, "synth-mnist-val")
        return tr, va
    if name == "imagenet":
        from tpu_dist_torch.data.imagefolder import load_imagefolder
        real = load_imagefolder(root)
        if real is not None:
            return real
        tr = _synthetic(synth_train, (224, 224, 3), 1000, seed, seed + 1, "synth-imagenet-train")
        va = _synthetic(synth_val, (224, 224, 3), 1000, seed, seed + 2, "synth-imagenet-val")
        return tr, va
    raise ValueError(f"unknown dataset {name!r}")
