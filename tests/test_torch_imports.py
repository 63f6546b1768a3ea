"""The port stands alone: no module of ``tpu_dist_torch`` (nor
``chip_smoke.py`` or ``kernel_turns.py``) imports JAX or the JAX package,
and its entry points run on CUDA unless the caller asks for the CPU --
without CUDA the default device raises instead of falling back."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tpu_dist_torch")


def _port_files():
    out = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                           "kernel_turns.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return out


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "tpu_dist")


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import tpu_dist_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "tpu_dist_torch.__path__, 'tpu_dist_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'tpu_dist'))\n"
        "print(json.dumps({'mods': mods, 'bad': bad}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert {"tpu_dist_torch.engine.serve", "tpu_dist_torch.interop",
            "tpu_dist_torch.tools.decode_bench",
            "tpu_dist_torch.ops.paged_attention",
            "tpu_dist_torch.engine.lm_loop", "tpu_dist_torch.ops.pallas_adamw",
            "tpu_dist_torch.scripts.lm_longcontext",
            "tpu_dist_torch.tools.profile_lm",
            "tpu_dist_torch.engine.loop", "tpu_dist_torch.engine.checkpoint",
            "tpu_dist_torch.models.resnet", "tpu_dist_torch.models.lenet",
            "tpu_dist_torch.models.registry", "tpu_dist_torch.data.datasets",
            "tpu_dist_torch.data.loader", "tpu_dist_torch.data.pipeline",
            "tpu_dist_torch.ops.pallas_sgd", "tpu_dist_torch.ops.fused_xent",
            "tpu_dist_torch.scripts.image_train",
            "tpu_dist_torch.tools.profile_image",
            "tpu_dist_torch.ops.pallas_quant",
            "tpu_dist_torch.tools.request_report",
            "tpu_dist_torch.tools.profile_serve",
            "tpu_dist_torch.parallel", "tpu_dist_torch.parallel.mesh",
            "tpu_dist_torch.parallel.launch",
            "tpu_dist_torch.parallel.collectives",
            "tpu_dist_torch.parallel.overlap",
            "tpu_dist_torch.tools.comm_bench",
            "tpu_dist_torch.scripts.cookbook",
            "tpu_dist_torch.scripts.dataparallel",
            "tpu_dist_torch.scripts.distributed",
            "tpu_dist_torch.scripts.multiprocessing_spawn",
            "tpu_dist_torch.scripts.bf16_distributed",
            "tpu_dist_torch.scripts.allreduce_distributed",
            "tpu_dist_torch.scripts.mnist", "tpu_dist_torch.native",
            "tpu_dist_torch.data.imagefolder",
            "tpu_dist_torch.models.cnn_zoo",
            "tpu_dist_torch.models.inception",
            "tpu_dist_torch.models.mobile", "tpu_dist_torch.models.vit",
            "tpu_dist_torch.scripts.distributed_slurm",
            "tpu_dist_torch.tools.data_rate",
            "tpu_dist_torch.engine.flax_msgpack",
            "tpu_dist_torch.models.moe", "tpu_dist_torch.parallel.fsdp",
            "tpu_dist_torch.parallel.tp", "tpu_dist_torch.parallel.ep",
            "tpu_dist_torch.parallel.ring_attention",
            "tpu_dist_torch.plan", "tpu_dist_torch.plan.ir",
            "tpu_dist_torch.plan.tune", "tpu_dist_torch.plan.compile",
            "tpu_dist_torch.tools.tune", "tpu_dist_torch.obs.autoscale",
            "tpu_dist_torch.obs.goodput", "tpu_dist_torch.sim",
            "tpu_dist_torch.sim.scenario", "tpu_dist_torch.sim.fleet",
            "tpu_dist_torch.sim.runner", "tpu_dist_torch.sim.worker",
            "tpu_dist_torch.tools.fleet_report",
            "tpu_dist_torch.analysis", "tpu_dist_torch.analysis.proglint",
            "tpu_dist_torch.tools.convergence",
            "tpu_dist_torch.tools.lm_convergence",
            "tpu_dist_torch.ops.f32_product",
            "tpu_dist_torch.tools.optim_step_time"} <= set(out["mods"])


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_neither_jax_nor_tpu_dist(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names if _forbidden(n)], names


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    from tpu_dist_torch.engine.generate import generate
    from tpu_dist_torch.engine.kv_cache import PagedKVPool
    from tpu_dist_torch.engine.serve import ServeConfig, ServeEngine
    from tpu_dist_torch.models.transformer import tiny_lm

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tiny_lm(vocab_size=64, max_len=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedKVPool(1, 4, 4, 2, 8)
    lm = tiny_lm(vocab_size=64, max_len=32, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(lm, ServeConfig(max_slots=1, num_pages=8))
    # the CPU path is the caller's explicit choice, and it works
    eng = ServeEngine(lm, ServeConfig(max_slots=1, num_pages=8),
                      device="cpu")
    assert eng.pool.layers()[0].k.device.type == "cpu"
    out = generate(lm, np.array([[1, 2]], np.int32), 3, use_cache=True)
    assert out.shape == (1, 5)
    from tpu_dist_torch.models.registry import create_model

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model("resnet18")
    assert create_model("lenet", device="cpu").fc2.kernel.device.type \
        == "cpu"
    for arch in ("mobilenet_v3_small", "vit_cifar"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_model(arch)
