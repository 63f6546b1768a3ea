"""tpu_dist_torch: the PyTorch/CUDA port of ``tpu_dist`` for NVIDIA Hopper.

Module names mirror ``tpu_dist`` (``tpu_dist/engine/serve.py`` <->
``tpu_dist_torch/engine/serve.py``). The package imports ``torch`` and
never ``jax``, and nothing of ``tpu_dist``: what it needs of the
reference's jax-free modules it keeps as its own copies (``obs/``,
``configs.py``, ``data/``, ``utils/meters.py``, ``parallel/consensus.py``,
``parallel/supervisor.py``). Ported so far: LM serving (``engine/serve.py``,
int8, speculative, sp-sharded), LM training (``engine/lm_loop.py``, every
mesh mode) and image training (``engine/loop.py``) over
``torch.distributed``, the cookbook scripts, and the restart layer: fault
injection (``obs/faults.py``), the watchdog and goodput lineage
(``obs/{watchdog,goodput}.py``, ``obs.RunObs``), the elastic supervisor
(``parallel/supervisor.py``, ``python -m tpu_dist_torch.supervise``) and
consensus membership (``parallel/consensus.py``).

Every TPU (Pallas) kernel on a ported path has a hand-written CUDA C++
kernel under ``csrc/`` (built by :mod:`tpu_dist_torch.kernels`) and a plain
PyTorch version beside its wrapper. A wrapper runs the plain version only
for tensors on the CPU; for CUDA tensors it launches its kernel or raises.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"`` (the tests do); without CUDA the default raises.

Importing the package imports no ``torch``: ``resolve_device`` loads on
first use, so a process started as ``python -m tpu_dist_torch.<module>``
(the fleet worker) can take its signals before torch's seconds of import.
"""


def __getattr__(name):
    if name == "resolve_device":
        from tpu_dist_torch.device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
