"""tpu_dist_torch: the PyTorch/CUDA port of ``tpu_dist`` for NVIDIA Hopper.

Module names mirror ``tpu_dist`` (``tpu_dist/engine/serve.py`` <->
``tpu_dist_torch/engine/serve.py``). The package imports ``torch`` and
never ``jax``, and nothing of ``tpu_dist``: what it needs of the
reference's jax-free modules it keeps as its own copies (``obs/``,
``configs.py``, ``data/``, ``utils/meters.py``). Ported so far: LM serving
(``engine/serve.py``) and LM training (``engine/lm_loop.py``).

Every TPU (Pallas) kernel on a ported path has a hand-written CUDA C++
kernel under ``csrc/`` (built by :mod:`tpu_dist_torch.kernels`) and a plain
PyTorch version beside its wrapper. A wrapper runs the plain version only
for tensors on the CPU; for CUDA tensors it launches its kernel or raises.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"`` (the tests do); without CUDA the default raises.
"""

from tpu_dist_torch.device import resolve_device  # noqa: F401
