"""The port's launch and rendezvous layer (``tpu_dist_torch.parallel.launch``)
against the reference's discovery cases (``tests/test_launch.py``): the
environment, explicit arguments, Slurm and its node lists, a single Slurm
process, the mesh epoch's port offset; the retry and backoff around a
failing rendezvous with a fake ``sleep``; the TPU-metadata method's
refusal; the data mesh over the process group; and the trainers' checks
of the data-parallel knobs (the reference ``Trainer``'s and
``LMTrainer``'s)."""

import os
from unittest import mock

import pytest
import torch

from tpu_dist_torch.parallel import launch
from tpu_dist_torch.parallel.launch import (LaunchInfo, _slurm_first_host,
                                            detect_launch, epoch_coordinator,
                                            rendezvous_with_retry)
from tpu_dist_torch.parallel.mesh import make_mesh, world_info


def test_local_default():
    with mock.patch.dict(os.environ, {}, clear=True):
        info = detect_launch()
        assert info.method == "local"
        assert info.num_processes == 1 and info.process_id == 0


def test_env_rendezvous():
    env = {"TPU_DIST_COORDINATOR": "10.0.0.1:8476",
           "TPU_DIST_NUM_PROCESSES": "4", "TPU_DIST_PROCESS_ID": "2"}
    with mock.patch.dict(os.environ, env, clear=True):
        info = detect_launch()
        assert info.method == "env"
        assert info.coordinator == "10.0.0.1:8476"
        assert info.num_processes == 4 and info.process_id == 2


def test_explicit_args_override_env():
    env = {"TPU_DIST_COORDINATOR": "10.0.0.1:8476",
           "TPU_DIST_NUM_PROCESSES": "4", "TPU_DIST_PROCESS_ID": "2"}
    with mock.patch.dict(os.environ, env, clear=True):
        info = detect_launch("h:1", 2, 1)
        assert (info.coordinator, info.num_processes, info.process_id) == \
            ("h:1", 2, 1)


def test_slurm_rendezvous():
    env = {"SLURM_PROCID": "3", "SLURM_NPROCS": "4",
           "SLURM_JOB_NODELIST": "tpu-node[01-04]"}
    with mock.patch.dict(os.environ, env, clear=True):
        info = detect_launch()
        assert info.method == "slurm"
        assert info.process_id == 3 and info.num_processes == 4
        assert info.coordinator == "tpu-node01:8476"
    # a relaunch's TPU_DIST_* overrides win over the static Slurm env
    env.update(TPU_DIST_NUM_PROCESSES="3", TPU_DIST_PROCESS_ID="1")
    with mock.patch.dict(os.environ, env, clear=True):
        info = detect_launch()
        assert (info.num_processes, info.process_id) == (3, 1)


def test_slurm_nodelist_expansion():
    assert _slurm_first_host("host1") == "host1"
    assert _slurm_first_host("node[3-7]") == "node3"
    assert _slurm_first_host("gpu[11,13]") == "gpu11"
    assert _slurm_first_host("a01,a02") == "a01"


def test_single_slurm_proc_is_local():
    env = {"SLURM_PROCID": "0", "SLURM_NPROCS": "1"}
    with mock.patch.dict(os.environ, env, clear=True):
        assert detect_launch().method == "local"


def test_mesh_epoch_offsets_the_coordinator_port():
    assert epoch_coordinator("h:8476", 0) == "h:8476"
    assert epoch_coordinator("h:8476", 3) == "h:8479"
    assert epoch_coordinator("h", 3) == "h"
    assert epoch_coordinator("h:x", 3) == "h:x"
    env = {"TPU_DIST_COORDINATOR": "h:100", "TPU_DIST_MESH_EPOCH": "2"}
    with mock.patch.dict(os.environ, env, clear=True):
        assert detect_launch().coordinator == "h:102"
    env = {"SLURM_PROCID": "1", "SLURM_NPROCS": "2",
           "SLURM_JOB_NODELIST": "n[1-2]", "TPU_DIST_MESH_EPOCH": "1"}
    with mock.patch.dict(os.environ, env, clear=True):
        assert detect_launch().coordinator == "n1:8477"


INFO = LaunchInfo("h:1", 2, 1, "env")


def test_rendezvous_retries_with_doubling_backoff():
    calls, slept = [], []

    def init():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("coordinator not up")

    assert rendezvous_with_retry(init, INFO, retries=5, timeout_s=300,
                                 backoff_s=2, sleep=slept.append) == 3
    assert slept == [2, 4]


def test_rendezvous_gives_up_with_one_clear_error():
    slept = []

    def init():
        raise ConnectionError("refused")

    with pytest.raises(RuntimeError, match=r"'h:1' \(env method, process "
                       r"1/2\) after 3 attempt"):
        rendezvous_with_retry(init, INFO, retries=3, timeout_s=300,
                              backoff_s=20, sleep=slept.append)
    assert slept == [20, 30]        # doubling, capped at 30 s
    # the total deadline stops the retries early
    slept.clear()
    with pytest.raises(RuntimeError, match="after 1 attempt"):
        rendezvous_with_retry(init, INFO, retries=5, timeout_s=1,
                              backoff_s=2, sleep=slept.append)
    assert slept == []


def test_rendezvous_reads_env_knobs_and_passes_interrupts():
    env = {"TPU_DIST_RENDEZVOUS_RETRIES": "2",
           "TPU_DIST_RENDEZVOUS_BACKOFF_S": "0.5"}
    slept = []

    def init():
        raise OSError("down")

    with mock.patch.dict(os.environ, env, clear=True):
        with pytest.raises(RuntimeError, match="RETRIES=2"):
            rendezvous_with_retry(init, INFO, sleep=slept.append)
    assert slept == [0.5]

    def interrupted():
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        rendezvous_with_retry(interrupted, INFO, sleep=slept.append)


def test_initialize_local_and_refusals():
    with mock.patch.dict(os.environ, {}, clear=True):
        info = launch.initialize(device="cpu")
    assert info.method == "local" and world_info() == (0, 1, 1, 1)
    with mock.patch.dict(os.environ, {"TPU_WORKER_HOSTNAMES": "a,b"},
                         clear=True):
        with pytest.raises(NotImplementedError, match="tpu-metadata"):
            launch.initialize(device="cpu")
    with mock.patch.dict(os.environ, {"TPU_DIST_COORDINATOR": "h:1"},
                         clear=True):
        with pytest.raises(ValueError, match="backend 'mpi'"):
            launch.initialize(device="cpu", backend="mpi")
    if not torch.cuda.is_available():
        with mock.patch.dict(os.environ, {"TPU_DIST_COORDINATOR": "h:1"},
                             clear=True):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                launch.initialize()


def test_data_mesh_over_one_process():
    mesh = make_mesh(device="cpu")
    assert (mesh.shape, mesh.rank, mesh.size, mesh.group()) == \
        ({"data": 1}, 0, 1, None)
    assert make_mesh((-1,), device="cpu").size == 1
    with pytest.raises(ValueError, match="one process per device"):
        make_mesh((2,), device="cpu")
    with pytest.raises(ValueError, match="rank"):
        make_mesh((1, 1), ("data",), device="cpu")
    # every axis is ported, pipeline stages and serving's sp included;
    # an axis the reference does not have raises, naming it
    assert make_mesh((1, 1), ("data", "model"), device="cpu").shape == \
        {"data": 1, "model": 1}
    assert make_mesh((1, 1), ("data", "stage"), device="cpu").shape == \
        {"data": 1, "stage": 1}
    assert make_mesh((1,), ("sp",), device="cpu").shape == {"sp": 1}
    with pytest.raises(ValueError, match="unknown mesh axis 'spp'"):
        make_mesh((1,), ("spp",), device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(variant="pmap"), "unknown variant"),
    (dict(grad_compression="fp8"), "unknown grad compression"),
    (dict(grad_bucket_mb=25.0), "grad-bucket-mb"),
    (dict(variant="shard_map", grad_accum_steps=2),
     r"grad_accum_steps > 1 requires variant='jit'"),
    (dict(adasum=True), "adasum requires variant='shard_map'"),
    (dict(variant="shard_map", adasum=True, grad_compression="bf16"),
     "adasum replaces"),
    (dict(variant="shard_map", steps_per_dispatch=2),
     r"steps_per_dispatch > 1 requires variant='jit'"),
    (dict(variant="shard_map", data_placement="device"),
     r"data_placement='device' requires variant='jit'"),
    (dict(batch_size=15, grad_accum_steps=2, mesh_shape=(1,)),
     "not divisible"),
], ids=str)
def test_image_trainer_refuses_invalid_dp_settings(kw, match):
    """The reference ``Trainer``'s validity checks on the dp knobs, before
    any data or model is built."""
    from tpu_dist_torch.configs import TrainConfig
    from tpu_dist_torch.engine.loop import Trainer

    with pytest.raises(ValueError, match=match):
        Trainer(TrainConfig(**{"arch": "lenet", "dataset": "mnist",
                               "batch_size": 16, **kw}), device="cpu")


def test_lm_trainer_refuses_buckets_with_accumulation():
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer

    with pytest.raises(ValueError, match="grad_bucket_mb does not compose"):
        LMTrainer(LMConfig(batch_size=8, grad_accum_steps=2,
                           grad_bucket_mb=25.0), device="cpu")
