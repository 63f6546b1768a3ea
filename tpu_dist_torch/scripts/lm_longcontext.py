"""Train the causal LM through the port's ``LMTrainer`` (the port of
``scripts/8.lm_longcontext.py``, with the same flags)::

    python -m tpu_dist_torch.scripts.lm_longcontext --attn flash \\
        --optimizer fused_adamw --precision bf16 --steps 20

Every ``LMConfig`` field is a ``--flag`` (``--checkpoint-dir``/``--resume``,
``--pretrained``, ``--steps-per-dispatch``/``--data-placement``,
``--grad-accum-steps``, ``--loss-chunk`` and ``--attn blockwise`` among
them); ``--mesh`` (only ``data=1`` runs in the port yet), ``--steps`` (alias of ``--max-steps``), ``--generate N``
(greedy-decode N tokens afterwards with ``engine.generate`` and report how
many follow the synthetic affine rule) and ``--serve N`` (stand up the
port's ``ServeEngine`` on the trained model, chunked prefill, and serve one
long prompt plus N short requests) are the script's own. ``--device``
picks the device (default ``cuda``; ``cpu`` runs the plain versions).
Without ``--data``, the corpus is the deterministic synthetic affine
stream.
"""

from __future__ import annotations

import argparse
import dataclasses

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


def serve(trainer, n_short: int) -> str:
    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)

    page_size = 8
    serve_len = (trainer.cfg.seq_len // page_size) * page_size
    scfg = ServeConfig(max_slots=4, page_size=page_size,
                       num_pages=4 * (serve_len // page_size),
                       max_len=serve_len, prefill_chunk=2 * page_size)
    eng = ServeEngine(trainer.model, scfg, device=trainer.device)
    v = trainer.vocab_size
    long_len = serve_len // 2
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
            f"{long_len}-token prompt + {n_short} short) on "
            f"{trainer.device}: {st['chunk_ticks']} chunk ticks, occupancy "
            f"{st['occupancy'] * 100:.0f}%, {hits}/{total} generated tokens "
            "follow the affine rule")


def main(argv=None):
    from tpu_dist_torch.configs import LMConfig, add_args

    ap = argparse.ArgumentParser(description=__doc__)
    add_args(ap, LMConfig())
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    help="e.g. data=1 (overrides --mesh-shape/--mesh-axes; "
                         "other meshes are not ported yet)")
    ap.add_argument("--steps", type=int, default=0,
                    help="alias for --max-steps (cookbook compat)")
    ap.add_argument("--generate", type=int, default=0,
                    help="after training, greedy-decode N tokens and report "
                         "how often they follow the affine rule")
    ap.add_argument("--serve", type=int, default=0,
                    help="after training, serve one long prompt (chunked "
                         "prefill) plus N short requests with ServeEngine")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    from tpu_dist_torch.engine.lm_loop import LMTrainer

    cfg = LMConfig(**{f.name: getattr(args, f.name)
                      for f in dataclasses.fields(LMConfig)})
    if args.mesh:
        cfg = dataclasses.replace(cfg, mesh_shape=args.mesh[0],
                                  mesh_axes=args.mesh[1])
    if args.steps:
        cfg = dataclasses.replace(cfg, max_steps=args.steps)

    trainer = LMTrainer(cfg, device=args.device)
    print(f"[proc 0/1] mesh={{'data': 1}} mode={trainer.mode} "
          f"device={trainer.device} corpus={trainer.train_ds.name} "
          f"rows={len(trainer.train_ds)} "
          f"tokens/step={cfg.batch_size * cfg.seq_len}", flush=True)
    best_ppl = trainer.fit()
    if not cfg.evaluate:
        print(f"throughput {trainer.last_tok_s:,.0f} tokens/sec "
              f"({trainer.mode}) best_ppl {best_ppl:.2f}", flush=True)

    if args.generate:
        from tpu_dist_torch.engine.generate import generate

        n = min(args.generate, cfg.seq_len - 2)
        seed = 3
        prompt = np.asarray([[seed, (seed * 5 + 7) % trainer.vocab_size]],
                            np.int32)
        out = generate(trainer.model, prompt, steps=n, use_cache=True)
        row = out[0].cpu().numpy()
        hits, _ = follows(row, 2, trainer.vocab_size)
        print(f"generated {n} tokens, {hits}/{n} follow the affine rule: "
              f"{row.tolist()}", flush=True)
    if args.serve:
        print(serve(trainer, args.serve), flush=True)


if __name__ == "__main__":
    main()
