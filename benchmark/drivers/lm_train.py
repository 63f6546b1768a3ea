"""LM training cells: the port's ``LMTrainer`` on token batches the
benchmark draws from the seed, one ``_dispatch`` a step (the trainer's own
call, with its ``dispatch_s``).

Set-up builds the trainer, copies the benchmark's weights into it and
drives it through the steps the check compares (each step's loss, the
first gradient as AdamW's first moment holds it, each leaf's change after
the last checked step); the same object then runs the window. After the
window: the card's memory peak, an optional traced segment, the trainer
freed, and the plain reference over the checked steps' batches from the
same weights.
"""

from __future__ import annotations

import time

import torch

from benchmark import common, generate, weights, work
from benchmark import trace as btrace
from benchmark.core import Window

TRACED_STEPS = 4


def _trainer(cell, seed: int, device):
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer

    rec, mix = cell.config["train"], cell.traffic
    model = work.lm_model(cell.config["model"])
    if model["mlp_dim"] != 4 * model["d_model"]:
        raise ValueError("the port's blocks take an MLP of 4 x d_model")
    if model["ln_eps"] != 1e-6:
        raise ValueError("the port's LayerNorm takes eps 1e-6")
    cfg = LMConfig(
        vocab_size=model["vocab_size"], num_layers=model["num_layers"],
        d_model=model["d_model"], num_heads=model["num_heads"],
        seq_len=mix["seq_len"], batch_size=mix["batch"],
        precision=cell.config["precision"], attn=rec["attn"],
        optimizer=rec["optimizer"], lr=rec["lr"], adam_b1=rec["b1"],
        adam_b2=rec["b2"], adam_eps=rec["eps"],
        weight_decay=rec["weight_decay"], grad_clip=rec["grad_clip"],
        synth_tokens=4 * (mix["seq_len"] + 1), seed=seed % (1 << 31),
        checkpoint_dir="", print_freq=1 << 30)
    if model["max_len"] != mix["seq_len"]:
        raise ValueError("the trainer's positions table is seq_len long")
    return LMTrainer(cfg, device=device)


def _norms(names, tensors, scale=1.0):
    return {n: float(t.float().norm()) * scale
            for n, t in zip(names, tensors)}


def run(cell, seed: int, seconds: float, trace: bool, device, clock0: float,
        options=None) -> Window:
    opts = options or {}
    rec, mix = cell.config["train"], cell.traffic
    model = work.lm_model(cell.config["model"])
    b, length, vocab = mix["batch"], mix["seq_len"], model["vocab_size"]
    n_check = mix["check_steps"]
    shapes = work.lm_shapes(model)

    tr = _trainer(cell, seed, device)
    w = weights.lm_weights(shapes, model, seed, device)
    weights.load_into(tr.model.named_parameters(), w)
    del w
    names = list(tr.state.param_names)

    def rows(step):
        r = generate.token_rows(seed, step, b, length + 1, vocab, device)
        return r[:, :-1], r[:, 1:]

    def one(step):
        inputs, targets = rows(step)
        m, dispatch_s, _ = tr._dispatch(
            step, "train_step", lambda: tr._step(inputs, targets), clock0,
            1, (inputs, targets))
        return m, dispatch_s

    # the checked steps: the trainer's own call, rows that all differ
    prog = {"losses": []}
    for step in range(n_check):
        m, _ = one(step)
        prog["losses"].append(float(m["loss_sum"] / m["count"]))
        if step == 0:
            prog["grad_norms"] = _norms(names, tr.state.opt_state.mu,
                                        1.0 / (1.0 - rec["b1"]))
    start = weights.lm_weights(shapes, model, seed, device)
    prog["change_norms"] = {n: float((p.detach() - start[n]).norm())
                            for n, p in zip(names, tr.state.params)}
    del start
    common.sync(device)
    setup_s = time.perf_counter() - clock0

    # the window
    step, losses, dispatch = n_check, [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        m, dispatch_s = one(step)
        losses.append(m["loss_sum"] / m["count"])
        dispatch.append(dispatch_s)
        step += 1
    common.sync(device)
    window_s = time.perf_counter() - t0
    steps = step - n_check
    peak = common.memory_peak(device)
    nonfinite = int((~torch.isfinite(torch.stack(losses))).sum())
    tokens_per_s = steps * b * length / window_s

    tr_out = None
    if trace:
        tr_out = btrace.traced(
            lambda: [one(s) for s in range(step, step + TRACED_STEPS)],
            lambda: _ranged_steps(tr, one, step + TRACED_STEPS),
            lambda: common.sync(device), lambda: common.warm(device))
    del tr, one, m, losses
    common.free(device)

    # the reference, over the checked steps' batches from the same weights
    w = weights.lm_weights(shapes, model, seed, device)
    batches = [rows(s) for s in range(n_check)]
    ref_mod = cell.reference
    with common.exact_fp32():
        ref = ref_mod.train_steps(w, batches, model, rec)
        control = None
        if opts.get("control"):
            control = {
                "fp8": common.readings(ref_mod.train_steps(
                    w, batches, model, rec, mode="fp8"), ref),
                "half_batch": common.readings(ref_mod.train_steps(
                    w, [(i[: b // 2], t[: b // 2]) for i, t in batches],
                    model, rec), ref),
            }
    checks = common.train_checks(prog, ref, cell.limits)
    counters = {
        "dispatch_s": dispatch, "steps": steps, "window_s": window_s,
        "traced_steps": TRACED_STEPS,
        "flops_per_token": work.lm_train_flops_per_token(model, length),
        "attention": {"batch": b, "heads": model["num_heads"],
                      "seq": length,
                      "head_dim": model["d_model"] // model["num_heads"],
                      "layers": model["num_layers"]},
        "program": prog, "reference": ref, "control": control,
        "device_name": (torch.cuda.get_device_name(device)
                        if torch.device(device).type == "cuda" else "cpu"),
    }
    return Window(
        metrics={"train_tokens_per_s": tokens_per_s, "setup_s": setup_s},
        attempted=steps, failed=nonfinite, checks=checks,
        counters=counters, trace=tr_out, memory_peak_bytes=peak)


def _ranged_steps(tr, one, first_step):
    """``TRACED_STEPS`` more steps, each block's attention inside a
    ``bench.attn_fwd`` range and its backward's autograd nodes inside
    ``bench.attn_bwd`` ranges."""
    attns = [blk.attn for blk in tr.model.blocks]
    inputs = {}

    def pre(mod, args):
        inputs[id(mod)] = (args[:3], btrace.Range("bench.attn_fwd")
                           .__enter__())

    def post(mod, args, out):
        qkv, rng = inputs.pop(id(mod))
        rng.__exit__()
        if torch.is_grad_enabled():
            btrace.backward_ranges(out, qkv, "bench.attn_bwd")

    hooks = [h for a in attns for h in (a.register_forward_pre_hook(pre),
                                        a.register_forward_hook(post))]
    try:
        for s in range(first_step, first_step + TRACED_STEPS):
            one(s)
    finally:
        for h in hooks:
            h.remove()
