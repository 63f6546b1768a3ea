"""The port's long-context entry points on CPU: the decode bench's CLI
on the checked-in ``tools/traces/longcontext_mix.json`` at the
reference's tiny geometry with ``--sp-capacity 4`` (its pins,
``tests/test_goodput.py:700-727``, and the virtual-clock numbers of
``chip_smoke.P14_LC_PINS``, which ``tests/test_torch_longcontext.py``
holds against the reference), and script 8's ``--serve`` over the ``seq``
axis of a ``data=1,seq=2`` run."""

import json
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke
from tpu_dist_torch.tools import decode_bench

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_decode_bench_long_context_cli_with_sp_capacity(capfd, monkeypatch):
    # the bench's ranks inherit this: one thread each, as this process has
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = [os.path.join(ROOT, a) if a == chip_smoke.P14_TRACE else a
            for a in chip_smoke.P14_LC_ARGV if a != "--long-monolithic"]
    decode_bench.main(["--device", "cpu", "--precision", "fp32",
                       "--vocab-size", "256", "--d-model", "32",
                       "--num-layers", "1", "--num-heads", "2", *argv,
                       "--sp-capacity", "4"])
    lines = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1                # rank 0 alone prints it
    head = json.loads(lines[0])
    assert head["metric"] == "torch_lm_longcontext_serving"
    srv = head["serving"]
    assert srv["mode"] == "long_context"
    assert srv["requests"] == 15 and srv["completed"] == 15
    assert srv["long_requests"] == 1
    assert srv["tpot_interference_pct"] <= 25.0, srv
    assert srv["ttft_long_p99"] > 0 and srv["tpot_baseline_p99"] > 0
    assert srv["chunk_ticks"] >= 16384 // 128
    for k, want in chip_smoke.P14_LC_PINS.items():
        if k != "monolithic":
            assert srv[k] == want, k
    sp = srv["sp_capacity"]
    assert sp["exceeds_single_device"], sp
    assert sp["context_tokens"] > sp["device_token_budget"]
    assert sp["completed"] == 1 and sp["sp_prefills"] == 1
    assert sp["devices"] == 4


@pytest.mark.parametrize("mesh,want", [("data=1,seq=2", "1 sp prefills")])
def test_script8_serves_over_the_seq_axis(tmp_path, mesh, want):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_DIST", "SLURM_"))}
    env.update(TPU_DIST_NPROCS_SPAWN="2", OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT)
    run = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.scripts.lm_longcontext",
         "--device", "cpu", "--seq-len", "48", "--d-model", "32",
         "--num-layers", "1", "--num-heads", "2", "--vocab-size", "64",
         "--synth-tokens", "3000", "--batch-size", "4", "--max-steps", "2",
         "--optimizer", "fused_adamw", "--mesh", mesh, "--serve", "2",
         "--checkpoint-dir", str(tmp_path / "ck")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    line = [ln for ln in run.stdout.splitlines() if ln.startswith("served")]
    assert len(line) == 1, run.stdout        # the main rank prints it
    assert line[0].startswith("served 3/3 requests (1 long 24-token prompt")
    assert "on 2 device(s)" in line[0] and want in line[0]
