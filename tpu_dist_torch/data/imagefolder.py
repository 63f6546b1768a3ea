"""ImageFolder-style ImageNet loading for the port
(``tpu_dist/data/imagefolder.py``).

:class:`ImageFolderDataset` scans ``<split>/<class>/<image>`` in sorted
order (the same samples and ``class_to_idx`` as the reference) and decodes
each batch on the host through a thread pool, to ``size x size x 3`` uint8:
the short side resized to ``size * 256 // 224``, then a center crop (the
reference cookbook's ``Resize(256)``/``CenterCrop(224)``); flips and crops
run on the device like the other datasets (``data.pipeline``).

JPEGs go through the native libjpeg decoder (``native.decode_jpeg``, the
GIL released for the whole call). Other extensions, and JPEGs where the
library has no libjpeg or the decode returned None, take PIL's route, the
reference's ``:73-84``. Where that route is needed and PIL is missing, the
batch raises, naming both libraries: no image is ever left blank.
:attr:`ImageFolderDataset.routes` counts the images each route served.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np

from tpu_dist_torch import native
from tpu_dist_torch.data.datasets import IMAGENET_MEAN, IMAGENET_STD

_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}


def _pil_decode(path: str, size: int) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        why = ("not a JPEG" if not path.lower().endswith((".jpg", ".jpeg"))
               else "libjpeg is missing from the native library or could "
                    "not decode it")
        raise RuntimeError(
            f"cannot decode {path}: {why}, and PIL (Pillow) is not "
            "importable. Install libjpeg (jpeglib.h and -ljpeg, for JPEGs) "
            "or PIL (any format)") from e
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        scale = (size * 256 // 224) / min(w, h)
        im = im.resize((max(1, round(w * scale)), max(1, round(h * scale))))
        arr = np.asarray(im, np.uint8)
    top = (arr.shape[0] - size) // 2
    left = (arr.shape[1] - size) // 2
    return arr[top:top + size, left:left + size]


class ImageFolderDataset:
    """Lazy ImageFolder with the ``ArrayDataset`` batch protocol
    (``get_batch``)."""

    def __init__(self, split_dir: str, size: int = 224, workers: int = 8,
                 name: str = "imagefolder"):
        classes = sorted(d for d in os.listdir(split_dir)
                         if os.path.isdir(os.path.join(split_dir, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(split_dir, c)
            for fn in sorted(os.listdir(cdir)):
                if os.path.splitext(fn)[1].lower() in _EXTS:
                    self.samples.append((os.path.join(cdir, fn),
                                         self.class_to_idx[c]))
        if not self.samples:
            raise FileNotFoundError(f"no images under {split_dir}")
        self.labels = np.array([s[1] for s in self.samples], np.int32)
        self.size = size
        self.num_classes = len(classes)
        self.mean, self.std = IMAGENET_MEAN, IMAGENET_STD
        self.name = name
        self.routes: Dict[str, int] = {"native": 0, "pil": 0}
        self._pool = ThreadPoolExecutor(max_workers=workers)

    def __len__(self):
        return len(self.samples)

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return (self.size, self.size, 3)

    def _decode(self, idx: int) -> Tuple[np.ndarray, str]:
        path, _ = self.samples[idx]
        # ask before reading: a host without the decoder reads once, for PIL
        if path.lower().endswith((".jpg", ".jpeg")) \
                and native.decode_available():
            with open(path, "rb") as f:
                out = native.decode_jpeg(f.read(), self.size)
            if out is not None:
                return out, "native"
        return _pil_decode(path, self.size), "pil"

    def get_batch(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        done = list(self._pool.map(self._decode, [int(i) for i in indices]))
        for _, route in done:
            self.routes[route] += 1
        return np.stack([img for img, _ in done]), self.labels[indices]

    def close(self) -> None:
        self._pool.shutdown(wait=True)


def load_imagefolder(root: str) -> Optional[
        Tuple[ImageFolderDataset, ImageFolderDataset]]:
    """(train, val) from ``root/train`` and ``root/val`` at 224 px, or None
    unless both exist."""
    tr_dir, va_dir = os.path.join(root, "train"), os.path.join(root, "val")
    if not (os.path.isdir(tr_dir) and os.path.isdir(va_dir)):
        return None
    return (ImageFolderDataset(tr_dir, name="imagenet-train"),
            ImageFolderDataset(va_dir, name="imagenet-val"))
