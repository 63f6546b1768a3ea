"""GoogLeNet and InceptionV3 of ``tpu_dist_torch/models/inception.py``
against the flax reference on the CPU, fp32 and bf16 (inputs, what is held
and at what tolerance: ``tests/torch_zoo_parity.py``)."""

import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from torch_zoo_parity import check_family  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("family", ["googlenet", "inception_v3"])
def test_family_matches_flax(family, precision):
    check_family(family, precision)
