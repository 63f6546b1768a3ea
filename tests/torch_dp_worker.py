"""One rank of a ``torch.distributed`` group for the port's multi-process
tests (``tests/test_torch_{collectives,dp,dp_lm,cuda}.py``): gloo on the
CPU unless the spec names another ``device`` and ``backend``.

    python tests/torch_dp_worker.py SPEC.json

with ``TPU_DIST_COORDINATOR``, ``TPU_DIST_NUM_PROCESSES`` and
``TPU_DIST_PROCESS_ID`` set (:func:`run_group` sets them). The rank joins
the group through ``tpu_dist_torch.parallel.launch.initialize``, runs
every job of the spec in order and writes ``rank<r>.json`` (and the
``.npz`` files its jobs name) into the spec's ``out`` directory. It
imports neither JAX nor the JAX package.
"""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_group(world: int, spec: dict, out: str, timeout: int = 300):
    """Run ``spec`` on ``world`` gloo ranks; returns each rank's result."""
    os.makedirs(out, exist_ok=True)
    spec = dict(spec, out=out)
    path = os.path.join(out, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    # this process binds the store on a free port and holds it until the
    # ranks are done, so nothing else can take the port first
    from tpu_dist_torch.parallel.launch import host_store

    store, coordinator = host_store("127.0.0.1:0", world)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_DIST", "SLURM_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = []
    for r in range(world):
        log = open(os.path.join(out, f"rank{r}.log"), "w")
        procs.append((log, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path],
            env=dict(env, TPU_DIST_COORDINATOR=coordinator,
                     TPU_DIST_NUM_PROCESSES=str(world),
                     TPU_DIST_PROCESS_ID=str(r), TPU_DIST_STORE_HELD="1"),
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for r, (log, p) in enumerate(procs):
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = "timeout"
        log.close()
        if rc != 0:
            with open(os.path.join(out, f"rank{r}.log")) as f:
                failed.append(f"rank {r} rc={rc}\n{f.read()[-3000:]}")
    del store                 # every rank has exited
    if failed:
        raise AssertionError("\n".join(failed))
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def _ledger_losses(path):
    with open(path) as f:
        return [r["loss"] for r in map(json.loads, f) if r["event"] == "step"]


def _trainer_job(job, out, rank, torch, device):
    """Fit an image ``Trainer`` (or an ``LMTrainer``) from the job's config
    and initial params; rank 0 reports the ledger's step losses, every rank
    its final params (as .npz) and its validation metric."""
    from tpu_dist_torch.engine import checkpoint as ckpt

    name = job["name"]
    kw = dict(job["cfg"])
    kw["ledger_path"] = os.path.join(out, f"{name}.jsonl")
    if job["kind"] == "image":
        kw.setdefault("checkpoint_dir", f"ck-{name}")
    for key in ("checkpoint_dir", "resume"):
        if kw.get(key):
            kw[key] = os.path.join(out, kw[key])
    init = None
    if job.get("init"):
        with np.load(job["init"], allow_pickle=True) as z:
            init = z["tree"].item()
    if job["kind"] == "image":
        from tpu_dist_torch.configs import TrainConfig
        from tpu_dist_torch.engine.loop import Trainer

        tr = Trainer(TrainConfig(**kw), device=device,
                     init_params=init and init["params"],
                     init_batch_stats=init and init["batch_stats"])
    else:
        from tpu_dist_torch.configs import LMConfig
        from tpu_dist_torch.engine.lm_loop import LMTrainer

        tr = LMTrainer(LMConfig(**kw), device=device, init_params=init)
    cut = job.get("interrupt_at")
    if cut is not None:       # every rank stops at the same global step
        step = tr._step

        def interrupted(*a):
            if tr.state.step == cut:
                raise KeyboardInterrupt
            return step(*a)

        tr._step = interrupted
    from tpu_dist_torch import kernels

    kernels.reset_launches()
    res = {}
    try:
        res["best"] = tr.fit()
    except KeyboardInterrupt:
        arch = "lm" if job["kind"] == "lm" else tr.cfg.arch
        res["ckpt_meta"] = ckpt.read_checkpoint_meta(
            os.path.join(kw["checkpoint_dir"], f"{arch}-checkpoint.pt"))
    res["step"] = tr.state.step
    res["launches"] = dict(kernels.LAUNCHES)
    res["world"], res["rank"] = tr.world, tr.rank
    res["local_batch"] = tr.local_batch
    if rank == 0:
        res["losses"] = _ledger_losses(kw["ledger_path"])
    np.savez(os.path.join(out, f"{name}.rank{rank}.npz"),
             *[p.detach().float().cpu().numpy() for p in tr.state.params])
    return res


def _collectives_job(job, out, rank, torch, device):
    """The collectives on per-rank inputs drawn from ``job["seed"]``: rank
    r's leaves are ``rng.normal(size=(world,) + shape)[r]``."""
    from tpu_dist_torch.parallel import collectives as C
    from tpu_dist_torch.parallel import overlap as O

    world = C.group_size()
    rng = np.random.default_rng(job["seed"])
    full = [rng.normal(size=(world,) + tuple(s)).astype(np.float32)
            for s in job["shapes"]]
    mine = [torch.from_numpy(a[rank].copy()).to(device) for a in full]
    res = {}
    res["reduce_mean"] = [t.tolist() for t in C.reduce_mean(mine)]
    down, up = C.compress_grads(mine, "bf16")
    res["compress_dtypes"] = [str(t.dtype) for t in down]
    res["compress_roundtrip"] = [t.tolist() for t in up(down)]
    for gran in ("leaf", "tree"):
        res[f"adasum_{gran}"] = [t.tolist() for t in
                                 C.adasum_reduce(mine, granularity=gran)]
    res["ring"] = [C.ring_allreduce(t).tolist() for t in mine]
    res["psum"] = [C.psum(t).tolist() for t in mine]
    for impl in O.IMPLS:
        res[f"bucketed_{impl}"] = [t.tolist() for t in O.bucketed_grad_sync(
            mine, bucket_mb=job["bucket_mb"], mean=True, impl=impl)]
    res["monolithic"] = [C.pmean(t).tolist() for t in mine]
    # one leaf identical on every rank (Adasum averages it), one
    # orthogonal across ranks (Adasum adds it)
    probe = {"par": torch.arange(1, 5, dtype=torch.float32, device=device),
             "orth": torch.zeros(world, device=device).index_fill_(
                 0, torch.tensor(rank, device=device), 3.0)}
    for gran in ("leaf", "tree"):
        res[f"adasum_probe_{gran}"] = {
            k: v.tolist() for k, v in
            C.adasum_reduce(probe, granularity=gran).items()}
    if world == 4:          # a group of 3 is refused before any transfer
        import torch.distributed as dist

        three = dist.new_group([0, 1, 2])
        if rank < 3:
            try:
                # distlint: disable=DL001 -- ranks 0-2 are the whole 3-rank subgroup it runs over
                C.adasum_reduce(mine, three)
            except ValueError as e:
                res["three_error"] = str(e)
    bench = C.allreduce_bench(sizes_mb=(0.001,), iters=2, device=device)
    res["bench"] = next(iter(bench.values()))
    C.barrier(device)
    return res


JOBS = {"image": _trainer_job, "lm": _trainer_job,
        "collectives": _collectives_job}


def main(spec_path):
    import torch

    torch.set_num_threads(1)
    # fp32 on the card means fp32, as on its CPU twin (cuDNN's default
    # would run the convolutions in TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpu_dist_torch.parallel import launch

    with open(spec_path) as f:
        spec = json.load(f)
    device = spec.get("device", "cpu")
    info = launch.initialize(device=device, backend=spec.get("backend"))
    rank = info.process_id
    results = {}
    for job in spec["jobs"]:
        results[job["name"]] = JOBS[job["kind"]](job, spec["out"], rank,
                                                 torch, device)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(sys.argv[1])
