"""Train the causal LM through the port's ``LMTrainer`` (the port of
``scripts/8.lm_longcontext.py``, with the same flags)::

    python -m tpu_dist_torch.scripts.lm_longcontext --attn flash \\
        --optimizer fused_adamw --precision bf16 --steps 20

Every ``LMConfig`` field is a ``--flag`` (``--checkpoint-dir``/``--resume``,
``--pretrained``, ``--steps-per-dispatch``/``--data-placement``,
``--grad-accum-steps``, ``--loss-chunk`` and ``--attn blockwise`` among
them); ``--mesh`` picks the parallelism as script 8's does (``data=N``,
``data=N`` with ``--fsdp``, ``data=N,model=M`` with ``--tp-impl gspmd``
or ``ring``, ``data=N,seq=M``, ``data=N,expert=M`` with
``--num-experts``, ``data=N,expert=M,model=K``, and ``data=N,stage=S``
with ``--pp-microbatches`` and ``--pp-schedule gpipe|1f1b``, or
``data=N,stage=S,model=K`` for pp x tp), one process per device of the mesh, launched as the
cookbook scripts launch theirs: ``TPU_DIST_NPROCS_SPAWN=N`` starts N
copies of the script (as ``multiprocessing_spawn`` does), or set the
``TPU_DIST_*`` / Slurm variables per process. ``--backend gloo`` puts CUDA
tensors on gloo (two ranks sharing one card). ``--steps`` (alias
of ``--max-steps``), ``--generate N``
(greedy-decode N tokens afterwards with ``engine.generate`` and report how
many follow the synthetic affine rule) and ``--serve N`` (stand up the
port's ``ServeEngine`` on the trained model and serve one long prompt plus
N short requests: with ``seq=M`` in ``--mesh`` every rank of the ``seq``
group joins a page pool sharded over those M ranks as the ``sp`` axis and
the long prompt prefills sequence-parallel; without it, chunked prefill
on one rank) are the script's own. ``--device``
picks the device (default ``cuda``; ``cpu`` runs the plain versions).
Without ``--data``, the corpus is the deterministic synthetic affine
stream.

``--max-restarts N`` (N > 0) runs the trainer under the in-process
supervisor (``parallel.supervisor.run_supervised``): a ``HealthError``
halt or a crash rebuilds the trainer from the newest valid checkpoint of
``--checkpoint-dir`` with the next attempt's ledger, the prebuilt trainer
serving attempt 0 only. Process-killing faults (a hang, ``os._exit``, a
preemption) need the subprocess supervisor::

    python -m tpu_dist_torch.supervise --ledger run.jsonl --ckpt-dir ck \\
        -- python -m tpu_dist_torch.scripts.lm_longcontext ...
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np


def parse_mesh(s):
    shape, axes = [], []
    for part in s.split(","):
        name, n = part.split("=")
        axes.append(name.strip())
        shape.append(int(n))
    return tuple(shape), tuple(axes)


def affine(seed: int, n: int, vocab: int) -> np.ndarray:
    toks = [seed % vocab]
    for _ in range(n - 1):
        toks.append((toks[-1] * 5 + 7) % vocab)
    return np.asarray(toks, np.int32)


def follows(toks, start: int, vocab: int):
    """(tokens after ``start`` that follow the affine rule, tokens)."""
    toks = [int(t) for t in toks]
    hits = sum(toks[i + 1] == (toks[i] * 5 + 7) % vocab
               for i in range(start - 1, len(toks) - 1))
    return hits, len(toks) - start


SERVE_PAGE = 8


def serve_mesh(trainer):
    """The ``sp`` mesh ``--serve`` shards its pool over: the trained
    mesh's ``seq`` axis (every rank of the group joins), or None (one
    rank, chunked) without one or when ``seq_len`` is too short for it."""
    from tpu_dist_torch.parallel.mesh import SEQ_AXIS, SP_AXIS, axis_mesh

    if not trainer.use_sp:
        return None
    n = trainer.mesh.shape[SEQ_AXIS]
    if trainer.cfg.seq_len < 2 * n * SERVE_PAGE:
        trainer.log(f"--serve: seq_len {trainer.cfg.seq_len} too short for "
                    f"a {n}-device sp pool; serving chunked on one device")
        return None
    return axis_mesh(trainer.mesh, SEQ_AXIS, SP_AXIS)


def serve(trainer, model, n_short: int, mesh=None) -> str:
    """One long prompt and ``n_short`` short ones through ``ServeEngine``
    (script 8's ``--serve``): sequence-parallel over ``mesh`` (every rank
    of it calls this) at or past half the serving length, else chunked."""
    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)

    sp_n = mesh.shape["sp"] if mesh is not None else 1
    step = sp_n * SERVE_PAGE
    serve_len = (trainer.cfg.seq_len // step) * step
    thresh = serve_len // 2
    scfg = ServeConfig(max_slots=4, page_size=SERVE_PAGE,
                       num_pages=4 * (serve_len // SERVE_PAGE),
                       max_len=serve_len, prefill_chunk=2 * SERVE_PAGE,
                       sp_prefill_threshold=thresh if mesh is not None
                       else 0)
    eng = ServeEngine(model, scfg, mesh=mesh,
                      device=None if mesh is not None else trainer.device)
    v = trainer.vocab_size
    long_len = thresh
    reqs = [DecodeRequest(0, affine(3, long_len, v), 8)]
    reqs += [DecodeRequest(i + 1, affine(3 + i, 6, v), 8)
             for i in range(n_short)]
    comps = eng.run(reqs)
    hits = total = 0
    for c in comps:
        h, t = follows(c.tokens, c.prompt_len, v)
        hits, total = hits + h, total + t
    st = eng.stats()
    return (f"served {len(comps)}/{len(reqs)} requests (1 long "
            f"{long_len}-token prompt + {n_short} short) on {sp_n} "
            f"device(s): {st['sp_prefills']} sp prefills, "
            f"{st['chunk_ticks']} chunk ticks, occupancy "
            f"{st['occupancy'] * 100:.0f}%, {hits}/{total} generated tokens "
            "follow the affine rule")


def main(argv=None):
    from tpu_dist_torch.configs import LMConfig, add_args

    ap = argparse.ArgumentParser(description=__doc__)
    add_args(ap, LMConfig())
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    help="e.g. data=2 | data=1,model=2 | data=1,seq=2 | "
                         "data=1,expert=2 (overrides --mesh-shape/"
                         "--mesh-axes)")
    ap.add_argument("--steps", type=int, default=0,
                    help="alias for --max-steps (cookbook compat)")
    ap.add_argument("--generate", type=int, default=0,
                    help="after training, greedy-decode N tokens and report "
                         "how often they follow the affine rule")
    ap.add_argument("--serve", type=int, default=0,
                    help="after training, serve one long prompt plus N "
                         "short requests with ServeEngine (sp-sharded over "
                         "the seq axis of --mesh, else chunked prefill)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend (default: nccl on cuda, "
                         "gloo on cpu)")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    nprocs = int(os.environ.get("TPU_DIST_NPROCS_SPAWN", "0") or 0)
    if nprocs > 1 and "TPU_DIST_PROCESS_ID" not in os.environ:
        from tpu_dist_torch.parallel.launch import spawn

        spawn("tpu_dist_torch.scripts.lm_longcontext", nprocs, argv,
              "127.0.0.1:0")
        return

    from tpu_dist_torch.parallel import launch

    cfg = LMConfig(**{f.name: getattr(args, f.name)
                      for f in dataclasses.fields(LMConfig)})
    if args.mesh:
        cfg = dataclasses.replace(cfg, mesh_shape=args.mesh[0],
                                  mesh_axes=args.mesh[1])
    if args.steps:
        cfg = dataclasses.replace(cfg, max_steps=args.steps)

    info = launch.initialize(device=args.device, backend=args.backend)
    try:
        run(args, cfg, info)
    finally:
        launch.shutdown()


def run(args, cfg, info):
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.parallel import launch

    trainer = LMTrainer(cfg, device=args.device)
    launch.say(f"[proc {info.process_id}/{info.num_processes}] "
               f"mesh={trainer.mesh.shape} mode={trainer.mode} "
               f"device={trainer.device} corpus={trainer.train_ds.name} "
               f"rows={len(trainer.train_ds)} "
               f"tokens/step={cfg.batch_size * cfg.seq_len}")
    if cfg.max_restarts > 0:
        # in-process restarts (:91-113): the prebuilt trainer serves
        # attempt 0 only; a restart drops the dead attempt's trainer before
        # building the next (its params and optimizer state must be free),
        # and --generate/--serve below use the last attempt's
        from tpu_dist_torch.parallel.supervisor import run_supervised

        current = {"trainer": trainer, "used": False}

        def build(run_cfg):
            if current["used"]:
                current["trainer"] = None
                current["trainer"] = LMTrainer(run_cfg, device=args.device)
            current["used"] = True
            return current["trainer"]

        trainer = None
        best_ppl = run_supervised(build, cfg)
        trainer = current["trainer"]
    else:
        best_ppl = trainer.fit()
    if not cfg.evaluate:
        trainer.log(f"throughput {trainer.last_tok_s:,.0f} tokens/sec "
                    f"({trainer.mode}) best_ppl {best_ppl:.2f}")
    if not (args.generate or args.serve):
        return
    model = trainer.whole_model()     # every rank: a gather when sharded
    mesh = serve_mesh(trainer) if args.serve else None
    if not trainer.is_main and mesh is None:
        return
    if args.generate and trainer.is_main:
        from tpu_dist_torch.engine.generate import generate

        n = min(args.generate, cfg.seq_len - 2)
        seed = 3
        prompt = np.asarray([[seed, (seed * 5 + 7) % trainer.vocab_size]],
                            np.int32)
        out = generate(model, prompt, steps=n, use_cache=True)
        row = out[0].cpu().numpy()
        hits, _ = follows(row, 2, trainer.vocab_size)
        print(f"generated {n} tokens, {hits}/{n} follow the affine rule: "
              f"{row.tolist()}", flush=True)
    if args.serve:
        line = serve(trainer, model, args.serve, mesh)
        if trainer.is_main:
            print(line, flush=True)


if __name__ == "__main__":
    main()
