"""One rank of a ``torch.distributed`` group for the port's multi-process
tests (``tests/test_torch_{collectives,dp,dp_lm,cuda,fsdp,tp,moe,
ring_attention,int8_tp,pp,pp_modes,generate_mesh,vit,sp_serve,elastic,
obs_trace,proglint,dropout}.py``):
gloo on the
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
    res["mode"] = getattr(tr, "mode", None)     # the LMTrainer's
    res["launches"] = dict(kernels.LAUNCHES)
    res["world"], res["rank"] = tr.world, tr.rank
    res["local_batch"] = tr.local_batch
    if rank == 0:
        res["losses"] = _ledger_losses(kw["ledger_path"])
    np.savez(os.path.join(out, f"{name}.rank{rank}.npz"),
             *[p.detach().float().cpu().numpy() for p in tr.state.params])
    pipe = getattr(tr, "pipe", None)
    if pipe is not None:      # a pipeline run: its work, its whole params
        res["pp"] = {"work": dict(pipe.work), "stash_peak": pipe.stash_peak,
                     "stage": pipe.s}
        whole = tr.whole_model()          # every rank: a gather
        if rank == 0:
            np.savez(os.path.join(out, f"{name}.whole.npz"),
                     **{n: p.detach().float().cpu().numpy()
                        for n, p in whole.named_parameters()})
    return res


def dropout_recorder(masks: list):
    """A stand-in for ``models.cnn_zoo.dropout`` (LeNet's too) that appends
    each train-mode draw to ``masks`` as (the generator's seed, the mask's
    packed bits): the mask replayed from the generator's state before the
    draw, and checked against what the real function applied."""
    import torch

    from tpu_dist_torch.models import cnn_zoo

    real = getattr(cnn_zoo.dropout, "real", cnn_zoo.dropout)

    def recording(x, rate, training, gen):
        if not training or rate == 0.0:
            return real(x, rate, training, gen)
        state = gen.get_state()
        out = real(x, rate, training, gen)
        replay = torch.Generator(device=gen.device)
        replay.set_state(state)
        keep = 1.0 - rate
        mask = torch.empty(x.shape, device=x.device).bernoulli_(
            keep, generator=replay).bool()
        xd = x.detach()
        assert torch.equal(out.detach(), torch.where(
            mask, xd / keep, torch.zeros_like(xd))), "replayed mask differs"
        masks.append((gen.initial_seed(),
                      np.packbits(mask.cpu().numpy()).tobytes()))
        return out
    recording.real = real
    return recording


def _dropout_job(job, out, rank, torch, device):
    """``_trainer_job`` with every dropout draw recorded: the result's
    ``masks`` holds one (seed, sha256 of the mask) a draw, in order."""
    import hashlib

    from tpu_dist_torch.models import cnn_zoo, lenet

    masks = []
    cnn_zoo.dropout = lenet.dropout = dropout_recorder(masks)
    res = _trainer_job(dict(job, kind="image"), out, rank, torch, device)
    res["masks"] = [[seed, hashlib.sha256(bits).hexdigest()]
                    for seed, bits in masks]
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


def _lm_batch(job, vocab, torch, device, data_rank=0, data_size=1):
    """This data shard's (inputs, targets) of the job's numpy-seeded
    (B, L+1) rows."""
    b, l = job["batch"], job["seq_len"]
    rows = np.random.default_rng(job["seed"]).integers(
        0, vocab, (b, l + 1)).astype(np.int64)
    mine = rows[data_rank * b // data_size:(data_rank + 1) * b // data_size]
    t = torch.from_numpy(mine).to(device)
    return t[:, :-1], t[:, 1:]


def _lm_grads_job(job, out, rank, torch, device):
    """One forward and backward of an ``LMTrainer``'s mode on the job's
    batch: the loss (mean CE), the router aux and every leaf's synced
    gradient, whole (gathered where the mode shards it), written by rank 0
    as ``<name>.grads.npz`` under the port's leaf names."""
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.engine.lm_steps import lm_objective

    init = None
    if job.get("init"):
        with np.load(job["init"], allow_pickle=True) as z:
            init = z["tree"].item()
    tr = LMTrainer(LMConfig(**job["cfg"]), device=device, init_params=init)
    inputs, targets = _lm_batch(job, tr.vocab_size, torch, tr.device,
                                tr.data_rank, tr.data_size)
    mask = torch.ones(targets.shape, dtype=torch.float32, device=tr.device)
    par = tr.par
    with par.params_ctx(tr.model, tr.state):
        loss_sum, metrics, aux = lm_objective(
            tr.model, inputs, targets, mask, tr.cfg.loss_chunk, par)
        mean = loss_sum / metrics["count"] + par.aux_weight * aux["aux"]
        grads = torch.autograd.grad(mean, tr.state.params)
    grads = par.sync_grads(list(grads))
    sums = par.sync_metrics(metrics) if not par.mode.startswith("dp") \
        else par.dp.metrics(metrics)
    whole = [tr._gather_leaf(i, g) if tr._sharded() else g
             for i, g in enumerate(grads)]
    if rank == 0:
        np.savez(os.path.join(out, f"{job['name']}.grads.npz"),
                 **{n: g.detach().float().cpu().numpy()
                    for (n, _), g in zip(tr._shapes, whole)})
    return {"loss": float(sums["loss_sum"] / sums["count"]),
            "correct1": float(sums["correct1"]),
            "aux": float(aux["aux"]), "mode": tr.mode,
            "local_shapes": [list(p.shape) for p in tr.state.params]}


def _ring_attention_job(job, out, rank, torch, device):
    """Ring attention over the whole group as the ``seq`` axis, on this
    rank's chunk of numpy-seeded (B, L, H, D) q, k, v: the output chunk
    and the gradients of sum(out^2) w.r.t. the chunk's q, k, v."""
    from tpu_dist_torch.parallel.collectives import group_size, p2p_route
    from tpu_dist_torch.parallel.mesh import make_mesh
    from tpu_dist_torch.parallel.ring_attention import ring_attention

    world = group_size()
    mesh = make_mesh((world,), ("seq",), device=device)
    axis = mesh.axis("seq")
    rng = np.random.default_rng(job["seed"])
    full = [rng.normal(size=job["shape"]).astype(np.float32)
            for _ in range(3)]
    lc = job["shape"][1] // world
    q, k, v = (torch.from_numpy(a[:, rank * lc:(rank + 1) * lc].copy())
               .to(device).requires_grad_() for a in full)
    res = {"route": p2p_route(axis.group, q.device)}
    for causal in (True, False):
        o = ring_attention(q, k, v, axis, causal=causal)
        gq, gk, gv = torch.autograd.grad((o * o).sum(), (q, k, v))
        res[f"causal={causal}"] = {
            name: t.detach().cpu().numpy().tolist()
            for name, t in (("out", o), ("dq", gq), ("dk", gk), ("dv", gv))}
    return res


def _ring_matmul_job(job, out, rank, torch, device):
    """The ring collective matmuls over the whole group as the ``model``
    axis on numpy-seeded operands: the all-gather matmul of this rank's
    sequence chunk by its column shard, the reduce-scatter matmul of the
    whole sequence's feature shard by its row shard."""
    from tpu_dist_torch.parallel.collectives import group_size
    from tpu_dist_torch.parallel.mesh import make_mesh
    from tpu_dist_torch.parallel.overlap import (ring_allgather_matmul,
                                                 ring_matmul_reduce_scatter)

    n = group_size()
    ax = make_mesh((n,), ("model",), device=device).axis("model")
    rng = np.random.default_rng(job["seed"])
    b, l, d, f = job["dims"]
    x = rng.normal(size=(b, l, d)).astype(np.float32)
    w1 = rng.normal(size=(d, f)).astype(np.float32)
    h = rng.normal(size=(b, l, f)).astype(np.float32)
    w2 = rng.normal(size=(f, d)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    lc, fc = l // n, f // n
    ag = ring_allgather_matmul(t(x[:, rank * lc:(rank + 1) * lc]),
                               t(w1[:, rank * fc:(rank + 1) * fc]), ax)
    rs = ring_matmul_reduce_scatter(t(h[:, :, rank * fc:(rank + 1) * fc]),
                                    t(w2[rank * fc:(rank + 1) * fc]), ax)
    return {"ag": ag.cpu().numpy().tolist(), "rs": rs.cpu().numpy().tolist()}


def _generate_mesh_job(job, out, rank, torch, device):
    """Sharded greedy decode (``engine.generate(mesh=)``) of the job's
    numpy-seeded prompt by an LM loaded from its flax tree, over a mesh of
    the whole group: the buffer from each of the job's ``cases``
    (``[use_cache, quant]``)."""
    from tpu_dist_torch.engine.generate import generate
    from tpu_dist_torch.interop import load_flax_params
    from tpu_dist_torch.parallel.mesh import make_mesh

    with np.load(job["init"], allow_pickle=True) as z:
        tree = z["tree"].item()
    kw = dict(job["model"])
    if kw.get("num_experts"):
        from tpu_dist_torch.models.moe import MoETransformerLM as cls
    else:
        from tpu_dist_torch.models.transformer import TransformerLM as cls
    model = load_flax_params(cls(device=device, seed=None, **kw), tree)
    mesh = make_mesh(job["shape"], job["axes"], device=device)
    prompt = np.random.default_rng(job["seed"]).integers(
        0, kw["vocab_size"], (job["batch"], job["prompt_len"])).astype(
        np.int32)
    res = {}
    for use_cache, quant in job["cases"]:
        buf = generate(model, prompt, job["steps"], use_cache=use_cache,
                       quant=quant, mesh=mesh)
        res[f"{use_cache}-{quant}"] = buf.cpu().numpy().tolist()
    return res


def _vit_ring_job(job, out, rank, torch, device):
    """A ViT under ``tp_impl="ring"`` over the whole group as the
    ``model`` axis, from the job's flax tree, on numpy-seeded images: the
    logits and (rank 0, ``<name>.grads.npz``) the gradient of the summed
    cross entropy under the flax leaf paths."""
    from tpu_dist_torch.engine.steps import cross_entropy_sum
    from tpu_dist_torch.interop import (export_flax_image_params,
                                        load_flax_image_params)
    from tpu_dist_torch.models import vit
    from tpu_dist_torch.parallel.collectives import group_size
    from tpu_dist_torch.parallel.mesh import make_mesh

    mesh = make_mesh((group_size(),), ("model",), device=device)
    with np.load(job["init"], allow_pickle=True) as z:
        tree = z["tree"].item()
    model = vit.ViT(image_shape=tuple(job["image_shape"]), tp_impl="ring",
                    quant=job["quant"], device=device, seed=None,
                    **job["model"])
    load_flax_image_params(model, tree)
    model.set_tp(mesh.axis("model"))
    model.requires_grad_(True)
    rng = np.random.default_rng(job["seed"])
    x = rng.standard_normal([job["batch"]] + list(job["image_shape"]))
    y = rng.integers(0, job["model"]["num_classes"], job["batch"])
    logits = model(torch.from_numpy(x.astype(np.float32)).to(device))
    grads = torch.autograd.grad(
        cross_entropy_sum(logits, torch.from_numpy(y).long().to(device)),
        list(model.parameters()))
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads):
            p.copy_(g)
    if rank == 0:
        flat = {}

        def walk(tree, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/")
                else:
                    flat[prefix + k] = np.asarray(v, np.float32)
        walk(export_flax_image_params(model)[0])
        np.savez(os.path.join(out, f"{job['name']}.grads.npz"), **flat)
    return {"logits": logits.detach().cpu().numpy().tolist()}


def _sp_ops_job(job, out, rank, torch, device):
    """``sp_paged_write`` then ``sp_gather_pages`` over the whole group as
    the ``sp`` axis, on this rank's block of a numpy-seeded global arena
    (``job["dtype"]``: int8 or float32): the gathered view and the written
    block."""
    from tpu_dist_torch.ops.paged_attention import (sp_gather_pages,
                                                    sp_paged_write)
    from tpu_dist_torch.parallel.mesh import make_mesh

    mesh = make_mesh((job["world"],), ("sp",), device=device)
    arena, bt, pos, vals, valid = sp_ops_inputs(job)
    rows = arena.shape[0] // job["world"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    block = t(arena[rank * rows:(rank + 1) * rows])
    sp_paged_write(block, t(bt), t(pos), t(vals), t(valid), mesh)
    g = sp_gather_pages(block, t(bt), mesh)
    return {"gathered": g.cpu().numpy().tolist(),
            "block": block.cpu().numpy().tolist()}


def sp_ops_inputs(job):
    """The sp gather/write case of ``job`` (world, dtype, seed): a global
    arena of ``world`` blocks of 3 pages + a trash row, two sequences'
    flat block tables over pages of every rank, their write positions,
    values and mask (the second row's last write masked)."""
    rng = np.random.default_rng(job["seed"])
    world, ps, h, d = job["world"], 4, 2, 8
    rows = 4                                  # 3 pages + the local trash
    shape = (world * rows, ps, h, d)
    if job["dtype"] == "int8":
        draw = lambda s: rng.integers(-127, 128, s).astype(np.int8)  # noqa
    else:
        draw = lambda s: rng.standard_normal(s).astype(np.float32)  # noqa
    arena = draw(shape)
    pages = [p for p in range(world * rows) if p % rows != rows - 1]
    perm = rng.permutation(pages)
    bt = perm[:6].reshape(2, 3).astype(np.int32)
    pos = np.stack([np.arange(5), np.arange(3, 8)]).astype(np.int64)
    vals = draw((2, 5, h, d))
    valid = np.ones((2, 5), bool)
    valid[1, -1] = False
    return arena, bt, pos, vals, valid


def _sp_serve_job(job, out, rank, torch, device):
    """The sp-sharded ``ServeEngine`` over the whole group as the ``sp``
    axis, with an LM loaded from the job's flax tree: for each of the
    job's cases (a ServeConfig, requests ``[prompt, steps]``, ``waves``)
    the tokens of every wave, the engine's stats, the forks it made and,
    with ``kv_rows``, the gathered K/V of the first request's prompt rows
    after the first step (its prefill); the rank's arena blocks go to
    ``<name>.<case>.rank<r>.npz``."""
    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)
    from tpu_dist_torch.interop import load_flax_params
    from tpu_dist_torch.models.transformer import TransformerLM
    from tpu_dist_torch.ops.paged_attention import sp_gather_many
    from tpu_dist_torch.parallel.mesh import make_mesh

    with np.load(job["init"], allow_pickle=True) as z:
        tree = z["tree"].item()
    model = load_flax_params(
        TransformerLM(device=device, seed=None, **job["model"]), tree)
    mesh = make_mesh((job["world"],), ("sp",), device=device)
    res = {}
    for case in job["cases"]:
        eng = ServeEngine(model, ServeConfig(**case["cfg"]), mesh=mesh)
        forks = []
        fork = eng.pool.fork_page

        def record(src, dst, rid=None, fork=fork, forks=forks):
            forks.append([src, dst])
            return fork(src, dst, rid=rid)

        eng.pool.fork_page = record
        reqs = [(np.asarray(p, np.int32), n) for p, n in case["requests"]]
        waves, kv = [], None
        for w in range(case.get("waves", 1)):
            batch = [DecodeRequest(i, p, n) for i, (p, n) in enumerate(reqs)]
            comps = []
            if case.get("kv_rows") and w == 0:
                for r in batch:
                    eng.submit(r)
                comps += eng.step()
                slot = eng.slots[0]
                bt = torch.as_tensor(eng.pool.flat_block_table(
                    slot.block_table[None])).to(device)
                # distlint: disable=DL002 -- a test rank reports its prompt rows once
                kv = [[g[0, :slot.prompt_len].float().cpu().numpy().tolist()
                       for g in sp_gather_many([layer.k, layer.v], bt, mesh)]
                      for layer in eng.pool.layers()]
                batch = []
            comps += eng.run(batch)
            # distlint: disable=DL002 -- host numpy tokens, no device sync
            waves.append({str(c.rid): c.tokens.tolist() for c in comps})
        np.savez(os.path.join(out, f"{job['name']}.{case['name']}.rank{rank}"
                              ".npz"),
                 **{f"{i}.{j}": a.float().cpu().numpy() if a.dtype !=
                    torch.int8 else a.cpu().numpy()
                    for i, layer in enumerate(eng.pool.layers())
                    for j, a in zip(("k", "v", "ks", "vs"), layer.arenas())})
        st = eng.stats()
        res[case["name"]] = {
            "waves": waves, "forks": forks, "kv": kv,
            "stats": {k: st[k] for k in (
                "sp_prefills", "prefills", "chunk_ticks", "pages_free",
                "pages_total", "sharded_devices", "pages_per_device",
                "cow_copies", "prefix_hits")},
            "page_device": {str(p): eng.pool.page_device(p)
                            for f in forks for p in f}}
    return res


def _restart_job(job, out, rank, torch, device):
    """The restart layer of an ``LMTrainer`` over the group: this rank's
    seed (``job["seeds"]``), an optional resume (``job["resume"]``, a
    rank -> path map), ``TPU_DIST_PEER_RESUME`` (``job["peer"]``), this
    rank's fault spec (``job["faults"]``, rank -> spec), and a fit whose
    exit code is recorded (75: the preemption snapshot). Reports the step
    after construction, this rank's ledger step losses, its ``run_end``
    and ``scale`` events and a digest of its params."""
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.obs import faults
    from tpu_dist_torch.obs.ledger import per_process_path

    name = job["name"]
    kw = dict(job["cfg"])
    kw["ledger_path"] = os.path.join(out, f"{name}.jsonl")
    kw["seed"] = job.get("seeds", [kw.get("seed", 0)] * (rank + 1))[rank]
    kw["faults"] = job.get("faults", {}).get(str(rank), "")
    if kw.get("checkpoint_dir"):
        kw["checkpoint_dir"] = os.path.join(out, kw["checkpoint_dir"])
    kw["resume"] = job.get("resume", {}).get(str(rank), "")
    faults._reset_for_tests()
    if job.get("peer"):
        os.environ["TPU_DIST_PEER_RESUME"] = "1"
    try:
        tr = LMTrainer(LMConfig(**kw), device=device)
    finally:
        os.environ.pop("TPU_DIST_PEER_RESUME", None)
    res = {"step0": tr.state.step,
           "digest0": [float(p.detach().double().sum()) for p in
                       tr.state.params]}
    try:
        tr.fit()
        res["code"] = 0
    except SystemExit as e:
        res["code"] = e.code
    res["step"] = tr.state.step
    with open(per_process_path(kw["ledger_path"], rank)) as f:
        recs = [json.loads(line) for line in f]
    res["losses"] = {r["step"]: r["loss"] for r in recs
                     if r["event"] == "step"}
    res["run_end"] = [r for r in recs if r["event"] == "run_end"][-1]
    res["scale"] = [r for r in recs if r["event"] == "scale"]
    res["digest"] = [float(p.detach().double().sum())
                     for p in tr.state.params]
    return res


def _skew_job(job, out, rank, torch, device):
    """The port's ``SkewMonitor`` over the group: for each case of the job
    (``every``, the record strides and this rank's (step_s, data_s) a
    record), the stats of every exchange, and the ``skew`` events its
    ledger emitted."""
    from tpu_dist_torch.obs.ledger import Ledger
    from tpu_dist_torch.obs.skew import SkewMonitor

    res = {}
    for name, case in job["cases"].items():
        led = Ledger(None, process_index=rank)
        events = []
        led.add_sink(events.append)
        mon = SkewMonitor(case["every"], ledger=led, device=device)
        stats = []
        for i, n in enumerate(case["strides"]):
            step_s, data_s = case["times"][rank][i]
            got = mon.record(i, step_s, data_s, n_steps=n)
            if got is not None:
                stats.append(got)
        res[name] = {"stats": stats, "events": events}
    return res


def _proglint_job(job, out, rank, torch, device):
    """The program audit over the group: each case's audited program run
    once under ``audit=record`` (``_halt`` cases: ``halt``), this rank's
    findings (or the AuditError), and the audited dp step of a tiny
    ``LMTrainer`` on the two ranks (its ``audit`` events)."""
    import torch.distributed as dist

    from tpu_dist_torch.analysis.proglint import AuditError
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.obs.ledger import Ledger, per_process_path, read_ledger
    from tpu_dist_torch.parallel.mesh import make_mesh, register_axis_group
    from tpu_dist_torch.plan import compile as pc

    make_mesh(device=device)            # the world group serves "data"
    led = Ledger(None, process_index=rank)
    events = []
    led.add_sink(events.append)
    x = torch.ones(8, device=device)

    def audited(name, fn, mode="record"):
        pc.set_audit(mode, led)
        try:
            fs = pc.audit_program(name, fn, x, device=device)
            return {"checks": [f.check for f in fs],
                    "messages": [f.message for f in fs]}
        except AuditError as e:
            return {"halt": str(e)}
        finally:
            pc.set_audit("none")

    res = {}
    for axis in ("batch", "data", "sp", "spd", None):
        group = dist.new_group([0, 1])      # every rank makes every group
        if axis is not None:
            register_axis_group(group, axis)
        res[f"pl001_{axis}"] = audited(
            f"pl001_{axis}", lambda v, g=group: dist.all_reduce(v, group=g))
    SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX
    first, then = (SUM, MAX) if rank == 0 else (MAX, SUM)

    def swap(v):        # same shapes, the reduce order swapped by rank
        dist.all_reduce(v, op=first)
        dist.all_reduce(v, op=then)

    def symmetric(v):
        dist.all_reduce(v, op=SUM)
        dist.all_reduce(v, op=MAX)

    def loop(v):        # the same trip count on every rank
        for _ in range(3):
            dist.all_reduce(v)

    for name, fn in (("swap", swap), ("symmetric", symmetric),
                     ("loop", loop)):
        res[f"pl002_{name}"] = audited(f"pl002_{name}", fn)
    res["pl002_swap_halt"] = audited("pl002_swap", swap, "halt")
    res["events"] = [e for e in events if e["event"] == "audit"]
    path = os.path.join(out, "lm.jsonl")
    LMTrainer(LMConfig(**job["lm"], ledger_path=path, audit="record",
                       mesh_shape=(2,)), device=device).fit()
    res["lm_audits"] = [r for r in read_ledger(per_process_path(path, rank))
                        if r["event"] == "audit"]
    return res


JOBS = {"image": _trainer_job, "dropout": _dropout_job,
        "proglint": _proglint_job, "skew": _skew_job, "lm": _trainer_job,
        "restart": _restart_job,
        "sp_ops": _sp_ops_job, "sp_serve": _sp_serve_job,
        "vit_ring": _vit_ring_job,
        "generate_mesh": _generate_mesh_job,
        "collectives": _collectives_job, "lm_grads": _lm_grads_job,
        "ring_attention": _ring_attention_job,
        "ring_matmul": _ring_matmul_job}


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
    # a barrier before leaving: a rank that destroys its gloo group while
    # a peer is still finishing can abort that peer at teardown
    launch.shutdown()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(sys.argv[1])
