"""Warm starts from the reference's msgpack checkpoints
(``tpu_dist_torch.engine.flax_msgpack``, ``engine.checkpoint
.load_warmstart``), on CPU: the donors are written by the JAX package
itself (``tpu_dist.engine.checkpoint.save_checkpoint``,
``flax.serialization``).

Held:

* the stdlib reader against ``flax.serialization.msgpack_restore`` on
  random trees of every dtype (bfloat16 included, read as raw uint16 and
  viewed), numpy scalars, Python scalars, strings, bytes, nil, lists and
  nested maps of every msgpack width, and a chunked array (flax's chunk
  size cut so a small leaf chunks); anything else raises naming its type
  code;
* the container: its CRC32 and length checked (a flipped byte or a
  truncated blob raises), and bare msgpack from before the container with
  its ``.json`` sidecar;
* ``LMTrainer(pretrained=...)`` from a reference ``tiny_lm`` checkpoint and
  ``Trainer(pretrained=...)`` from a reference ResNet-18 one (params and
  BatchNorm statistics): the port's forward equals the JAX model's within
  1e-5 (1 + |x|); a pipeline-stacked donor is refused with the reason;
* the committed fixture ``tests/fixtures/torch_tiny_lm.msgpack`` (the donor
  the card's phase 12d warm-starts) equals a fresh JAX build of it, leaf
  by leaf.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import flax.serialization as fser  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_dist.engine import checkpoint as jckpt  # noqa: E402
from tpu_dist.engine.state import TrainState as JaxTrainState  # noqa: E402
from tpu_dist.ops import make_optimizer as jax_optimizer  # noqa: E402
from tpu_dist_torch.engine import checkpoint as ckpt  # noqa: E402
from tpu_dist_torch.engine.flax_msgpack import (MsgpackError,  # noqa: E402
                                                msgpack_restore, unpackb)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "torch_tiny_lm.msgpack")
# the fixture's geometry (stamped in its meta, as the LMTrainer stamps a
# run's): tiny_lm at V 64, 2 layers, d 16, 2 heads, L 16
FIXTURE_LM = dict(vocab_size=64, num_layers=2, d_model=16, num_heads=2,
                  seq_len=16)
TOL = 1e-5


def _same(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) or hasattr(want,
                                                                "dtype"):
        w = np.asarray(want)
        assert torch.is_tensor(got), path
        assert tuple(got.shape) == w.shape, path
        if w.dtype == jnp.bfloat16:
            assert got.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(
                got.view(torch.uint16).numpy(), w.view(np.uint16), path)
        else:
            assert str(got.dtype).split(".")[-1] == str(w.dtype), path
            np.testing.assert_array_equal(got.numpy(), w, path)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def _random_tree(seed):
    rng = np.random.default_rng(seed)
    tree = {"arrays": {}}
    for dt in ("float16", "float32", "float64", "int8", "int16", "int32",
               "int64", "uint8", "uint16", "uint32", "uint64", "bool"):
        shape = tuple(rng.integers(1, 5, rng.integers(0, 4)))
        a = rng.normal(size=shape) * 100
        tree["arrays"][dt] = (a > 0) if dt == "bool" else a.astype(dt)
    tree["arrays"]["bfloat16"] = jnp.asarray(
        rng.normal(size=(3, 5)), jnp.bfloat16)
    tree["scalars"] = {"np_f32": np.float32(1.5), "np_i64": np.int64(-7),
                       "ints": [0, 127, 128, 255, 256, 65535, 65536,
                                2 ** 32, -1, -32, -33, -128, -129,
                                -32768, -32769, -2 ** 31 - 1, 2 ** 63 - 1],
                       "float": 0.1, "flag": True, "off": False,
                       "none": None, "blob": b"\x00\x01\xff" * 3}
    tree["text"] = {"short": "abc", "str8": "x" * 40, "str16": "y" * 300,
                    "unicode": "héllo ✓"}
    tree["wide"] = {f"k{i}": i for i in range(20)}           # map16
    tree["long_list"] = list(range(20))                      # array16
    tree["nested"] = {"a": {"b": {"c": [1, {"d": np.ones((2,), np.int32)}]}}}
    return tree


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reader_matches_flax_on_random_trees(seed):
    raw = fser.msgpack_serialize(_random_tree(seed))
    _same(msgpack_restore(raw), fser.msgpack_restore(raw))


def test_chunked_arrays_are_put_back_together(monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(100, dtype=np.float32).reshape(10, 10),
            "small": np.arange(3, dtype=np.int32)}
    raw = fser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in raw
    _same(msgpack_restore(raw), fser.msgpack_restore(raw))


def test_unsupported_types_raise_naming_them():
    with pytest.raises(MsgpackError, match="ext type 2"):
        unpackb(fser.msgpack_serialize({"z": 1 + 2j}))
    with pytest.raises(MsgpackError, match="ext type 7"):
        unpackb(b"\xd4\x07\x00")
    with pytest.raises(MsgpackError, match="0xc1"):
        unpackb(b"\xc1")
    with pytest.raises(MsgpackError, match="truncated"):
        unpackb(fser.msgpack_serialize({"a": np.ones(4)})[:-3])


def _lm_donor(path_dir, geometry=FIXTURE_LM, seed=0, extra=None):
    """A reference LM checkpoint of ``tiny_lm`` (params from ``seed``,
    fresh sgd state) through the reference's own ``save_checkpoint``."""
    from tpu_dist.models.transformer import tiny_lm

    g = dict(geometry)
    model = tiny_lm(vocab_size=g["vocab_size"], num_layers=g["num_layers"],
                    d_model=g["d_model"], num_heads=g["num_heads"],
                    max_len=g["seq_len"])
    params = model.init({"params": jax.random.PRNGKey(seed)},
                        np.zeros((1, g["seq_len"]), np.int32),
                        train=False)["params"]
    state = JaxTrainState.create(params, {}, jax_optimizer(0.1))
    meta = {**g, "num_experts": 0, "pp_stages": 0, **(extra or {})}
    path = jckpt.save_checkpoint(str(path_dir), state, 1, 0.0, "lm", False,
                                 extra_meta=meta)
    return path, model, params


def build_fixture(path: str) -> None:
    """Write the committed fixture anew at ``path`` (the reference's
    container bytes for ``tiny_lm`` at FIXTURE_LM from PRNGKey(0))."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        src, _, _ = _lm_donor(tmp)
        with open(src, "rb") as f, open(path, "wb") as g:
            g.write(f.read())


def test_container_crc_and_length_are_checked(tmp_path):
    path, model, _ = _lm_donor(tmp_path)
    from tpu_dist_torch.models.transformer import tiny_lm

    port = tiny_lm(vocab_size=64, num_layers=2, d_model=16, num_heads=2,
                   max_len=16, device="cpu")
    params, _, meta = ckpt.load_warmstart(path, port)
    assert meta["arch"] == "lm" and len(params) == len(
        list(port.parameters()))
    raw = bytearray(open(path, "rb").read())
    flipped = tmp_path / "flipped.msgpack"
    raw[-10] ^= 0xFF
    flipped.write_bytes(bytes(raw))
    with pytest.raises(ckpt.CheckpointCorruptError, match="CRC32"):
        ckpt.load_warmstart(str(flipped), port)
    cut = tmp_path / "cut.msgpack"
    cut.write_bytes(open(path, "rb").read()[:-5])
    with pytest.raises(ckpt.CheckpointCorruptError, match="truncated"):
        ckpt.load_warmstart(str(cut), port)
    # bare msgpack from before the container, meta from its sidecar; the
    # route follows the bytes, not the file's name
    bare = tmp_path / "bare.bin"
    blob = open(path, "rb").read()
    off = len(b"TPUDIST1\n")
    n = int.from_bytes(blob[off:off + 8], "little")
    bare.write_bytes(blob[off + 8 + n:])
    (tmp_path / "bare.bin.json").write_text(json.dumps({"arch": "lm"}))
    got, _, meta = ckpt.load_warmstart(str(bare), port)
    assert meta == {"arch": "lm"} and set(got) == set(params)


def _lm_cfg(tmp_path, pretrained, **kw):
    from tpu_dist_torch.configs import LMConfig

    return LMConfig(batch_size=2, seq_len=16, d_model=16, num_layers=2,
                    num_heads=2, vocab_size=64, synth_tokens=2000,
                    pretrained=pretrained, max_steps=1, **kw)


def test_lm_trainer_warm_starts_from_reference_checkpoint(tmp_path):
    from tpu_dist_torch.engine.lm_loop import LMTrainer

    path, model, params = _lm_donor(tmp_path, seed=5)
    tr = LMTrainer(_lm_cfg(tmp_path, path), device="cpu")
    tokens = np.random.default_rng(0).integers(0, 64, (2, 16))
    want = np.asarray(model.apply({"params": params}, jnp.asarray(tokens),
                                  train=False))
    with torch.no_grad():
        got = tr.model(torch.from_numpy(tokens)).numpy()
    bad = np.abs(got - want) > TOL * (1 + np.abs(want))
    assert not bad.any(), np.abs(got - want).max()
    assert tr.state.step == 0          # a fresh trajectory


def test_pipeline_stacked_donor_is_refused(tmp_path):
    from tpu_dist_torch.engine.lm_loop import LMTrainer

    path, _, _ = _lm_donor(tmp_path, extra={"pp_stages": 2})
    with pytest.raises(ValueError, match="pipeline-parallel"):
        LMTrainer(_lm_cfg(tmp_path, path), device="cpu")


def test_image_trainer_warm_starts_resnet18_from_reference(tmp_path):
    from tpu_dist.models import resnet as jres
    from tpu_dist_torch.configs import TrainConfig
    from tpu_dist_torch.engine.loop import Trainer

    ref = jres.ResNet18(num_classes=10)
    x = np.random.default_rng(1).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    variables = jax.jit(lambda k: ref.init(k, jnp.asarray(x), train=False))(
        jax.random.PRNGKey(2))
    stats = jax.tree_util.tree_map(lambda a: a + 0.05,
                                   variables["batch_stats"])
    state = JaxTrainState.create(variables["params"], stats,
                                 jax_optimizer(0.1))
    path = jckpt.save_checkpoint(str(tmp_path), state, 1, 10.0, "resnet18",
                                 False)
    tr = Trainer(TrainConfig(arch="resnet18", dataset="cifar10",
                             batch_size=8, epochs=1, synth_train_size=16,
                             synth_val_size=8, precision="fp32",
                             pretrained=path, log_csv="",
                             checkpoint_dir=str(tmp_path / "ck"),
                             data=str(tmp_path / "no-data")), device="cpu")
    want = np.asarray(jax.jit(lambda v: ref.apply(v, jnp.asarray(x),
                                                  train=False))(
        {"params": variables["params"], "batch_stats": stats}))
    tr.model.eval()
    with torch.no_grad():
        got = tr.model(torch.from_numpy(x)).numpy()
    bad = np.abs(got - want) > TOL * (1 + np.abs(want))
    assert not bad.any(), np.abs(got - want).max()


def test_committed_fixture_equals_a_fresh_build(tmp_path):
    fresh = tmp_path / "fresh.msgpack"
    build_fixture(str(fresh))
    meta_a, blob_a = ckpt._split_container(open(FIXTURE, "rb").read(),
                                           ckpt._REF_MAGIC)
    meta_b, blob_b = ckpt._split_container(fresh.read_bytes(),
                                           ckpt._REF_MAGIC)
    assert {k: meta_a[k] for k in FIXTURE_LM} == FIXTURE_LM
    a, b = fser.msgpack_restore(bytes(blob_a)), fser.msgpack_restore(
        bytes(blob_b))
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (p, u), (_, v) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v),
                                      jax.tree_util.keystr(p))
    # and the port reads it: every param leaf of tiny_lm by name
    from tpu_dist_torch.models.transformer import tiny_lm

    port = tiny_lm(vocab_size=64, num_layers=2, d_model=16, num_heads=2,
                   max_len=16, device="cpu")
    params, _, _ = ckpt.load_warmstart(FIXTURE, port)
    n, skipped = ckpt.graft_params(port.named_parameters(), params)
    assert skipped == [] and n == len(list(port.parameters()))


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_msgpack.py: rebuild the fixture
    jax.config.update("jax_platforms", "cpu")
    build_fixture(FIXTURE)
    print(f"wrote {FIXTURE}")
