"""The port's native host data path (``tpu_dist_torch/native.py`` over
``tpu_dist_torch/csrc/{gather,decode,jpeg_fixture}.cpp``) and its
ImageFolder dataset against the reference's, on the CPU:

* the row gather is bit-equal to numpy and to ``tpu_dist._native``, takes
  the numpy route for a non-contiguous array, an index out of range and
  ``native=False``, and counts each route;
* ``decode_jpeg`` is bit-equal to the reference's on the same bytes (both
  libraries built from the same source against this host's libjpeg),
  frames like PIL, and returns None on bytes that do not decode;
* a failed build raises, naming the compiler command;
* ``ImageFolderDataset`` scans the same samples and classes as the
  reference's and its ``get_batch`` is bit-equal over a tree of JPEGs and
  PNGs (the JPEGs through the native decode, the PNGs through PIL), and
  ``load_dataset("imagenet", root)`` reads the tree;
* with PIL missing, a PNG raises an error that names libjpeg and PIL;
* the libjpeg fixture writer's JPEGs decode back to the image.
"""

import io
import os

import numpy as np
import pytest
import torch

from tpu_dist_torch import native

torch.set_num_threads(1)


def _rgb(h, w, seed=0):
    """A smooth image with some noise: JPEG-friendly, not constant."""
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    arr = np.stack([xx * 255 // max(w, 1), yy * 255 // max(h, 1),
                    (xx + yy) * 255 // (h + w)], -1)
    return np.clip(arr + rng.integers(0, 24, arr.shape), 0, 255).astype(
        np.uint8)


def _jpeg(arr, quality=90):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def test_gather_is_bit_equal_and_counts_routes():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (100, 8, 8, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, (100,)).astype(np.int32)
    idx = rng.integers(0, 100, (32,))
    native.reset_routes()
    gi, gl = native.gather_batch(images, labels, idx)
    np.testing.assert_array_equal(gi, images[idx])
    np.testing.assert_array_equal(gl, labels[idx])
    assert gl.dtype == np.int32 and gi.flags.c_contiguous
    ni, nl = native.gather_batch(images, labels, idx, native=False)
    np.testing.assert_array_equal(ni, gi)
    np.testing.assert_array_equal(nl, gl)
    strided = images[:, ::2]                              # non-contiguous
    si, _ = native.gather_batch(strided, labels, idx)
    np.testing.assert_array_equal(si, strided[idx])
    with pytest.raises(IndexError):
        native.gather_batch(images, labels, np.array([0, 100]))
    assert native.ROUTES["gather_native"] == 1
    assert native.ROUTES["gather_numpy"] == 3
    pytest.importorskip("flax")
    from tpu_dist import _native
    ri, rl = _native.gather_batch(images, labels, idx)
    np.testing.assert_array_equal(ri, gi)
    np.testing.assert_array_equal(rl, gl)


def test_decode_is_bit_equal_to_the_reference_and_frames_like_pil():
    pytest.importorskip("PIL")
    from PIL import Image
    if not native.decode_available():
        pytest.skip("this host has no libjpeg to link")
    data = _jpeg(_rgb(375, 500))
    big = _jpeg(_rgb(1200, 1600, seed=1))         # the DCT-scaled branch
    out, out_big = native.decode_jpeg(data, 224), native.decode_jpeg(big, 224)
    assert out.shape == out_big.shape == (224, 224, 3)
    im = Image.open(io.BytesIO(data)).convert("RGB")
    w, h = im.size
    scale = 256 / min(w, h)
    ref = np.asarray(im.resize((round(w * scale), round(h * scale))))
    top, left = (ref.shape[0] - 224) // 2, (ref.shape[1] - 224) // 2
    diff = np.abs(out.astype(int)
                  - ref[top:top + 224, left:left + 224].astype(int))
    assert diff.mean() < 2.0
    assert native.decode_jpeg(b"\xff\xd8 not a jpeg" * 8, 224) is None
    pytest.importorskip("flax")
    from tpu_dist import _native
    if not _native.decode_available():
        pytest.skip("the reference's library has no libjpeg")
    np.testing.assert_array_equal(out, _native.decode_jpeg(data, 224))
    np.testing.assert_array_equal(out_big, _native.decode_jpeg(big, 224))


def test_a_failed_build_raises_with_the_command(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setenv("TPU_DIST_TORCH_BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="no-such-compiler.*gather.cpp"):
        native.build()


def test_fixture_writer_round_trips():
    if not native.decode_available():
        pytest.skip("this host has no libjpeg to link")
    import tempfile
    arr = _rgb(300, 400)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x.jpg")
        native.write_jpeg_fixture(arr, path, quality=95)
        with open(path, "rb") as f:
            out = native.decode_jpeg(f.read(), 224)
    assert out is not None and out.shape == (224, 224, 3)
    with pytest.raises(ValueError, match="quality"):
        native.write_jpeg_fixture(arr, "x.jpg", quality=0)


def _tree(root, n_per=3):
    """root/{train,val}/<class>/ with JPEGs and a PNG per class."""
    from PIL import Image
    k = 0
    for split in ("train", "val"):
        for c in ("cat", "ant", "bee"):
            d = os.path.join(root, split, c)
            os.makedirs(d)
            for i in range(n_per):
                arr = _rgb(240 + 17 * i, 300 + 9 * k, seed=k)
                k += 1
                if i == n_per - 1:
                    Image.fromarray(arr).save(os.path.join(d, f"{i}.png"))
                else:
                    with open(os.path.join(d, f"{i}.JPG"), "wb") as f:
                        f.write(_jpeg(arr))
            with open(os.path.join(d, "notes.txt"), "w") as f:
                f.write("not an image")


def test_imagefolder_get_batch_is_bit_equal_to_the_reference(tmp_path):
    pytest.importorskip("PIL")
    pytest.importorskip("flax")
    from tpu_dist.data import datasets as jds
    from tpu_dist.data.imagefolder import ImageFolderDataset as JaxFolder
    from tpu_dist_torch.data import datasets as tds
    from tpu_dist_torch.data.imagefolder import ImageFolderDataset

    root = str(tmp_path)
    _tree(root)
    ref = JaxFolder(os.path.join(root, "train"), size=64, workers=2)
    port = ImageFolderDataset(os.path.join(root, "train"), size=64,
                              workers=2)
    assert port.samples == ref.samples
    assert port.class_to_idx == ref.class_to_idx == {"ant": 0, "bee": 1,
                                                     "cat": 2}
    idx = np.array([8, 0, 2, 5, 1, 7, 3, 6, 4])
    gi, gl = port.get_batch(idx)
    ri, rl = ref.get_batch(idx)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gl, rl)
    assert gi.shape == (9, 64, 64, 3) and gl.dtype == np.int32
    assert port.routes == ({"native": 6, "pil": 3}
                           if native.decode_available()
                           else {"native": 0, "pil": 9})
    port.close()
    tr, va = tds.load_dataset("imagenet", root)
    jtr, jva = jds.load_dataset("imagenet", root)
    assert (tr.name, va.name, tr.num_classes, tr.image_shape) == (
        jtr.name, jva.name, jtr.num_classes, jtr.image_shape)
    assert len(va) == len(jva) == 9
    np.testing.assert_array_equal(va.get_batch(np.arange(9))[0],
                                  jva.get_batch(np.arange(9))[0])


def test_pil_route_without_pil_names_both_libraries(tmp_path, monkeypatch):
    import builtins

    from tpu_dist_torch.data.imagefolder import ImageFolderDataset

    pytest.importorskip("PIL")
    _tree(str(tmp_path), n_per=1)                # one PNG per class
    ds = ImageFolderDataset(os.path.join(str(tmp_path), "train"), size=32,
                            workers=1)
    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match="libjpeg.*PIL"):
        ds.get_batch(np.array([0]))
    ds.close()
