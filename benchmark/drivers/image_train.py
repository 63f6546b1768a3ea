"""Image training cells: the port's image ``Trainer`` on an ImageNet-shaped
uint8 set the benchmark draws on the card from the seed, through the
trainer's resident-set window (``compiled.train_step`` over index rows,
one ``_dispatch`` a window of K steps).

Set-up builds the trainer (its own data set is one batch: the benchmark
hands it every batch), copies the benchmark's weights into it and drives
it through the checked steps, each a window of one step (the first
gradient is SGD's first momentum less the weight decay; each leaf's change
after the last checked step); the same object then runs the window.
After the window: the card's memory peak, an optional traced window, the
trainer freed, and the plain reference over the checked steps' batches
with the same augmentation draws.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from benchmark import common, generate, weights, work
from benchmark import trace as btrace
from benchmark.core import Window

ORDER_STEPS = 4096          # index rows drawn ahead (more than a window runs)


def _trainer(cell, seed: int, device):
    from tpu_dist_torch.configs import TrainConfig
    from tpu_dist_torch.engine.loop import Trainer

    model, rec, mix = cell.config["model"], cell.config["train"], cell.traffic
    steps_per_epoch = cell.config["dataset_size"] // mix["batch"]
    cfg = dataclasses.replace(
        TrainConfig(), arch=model["arch"], dataset=model["dataset"],
        data="", stem=model["stem"], norm_dtype=model["norm_dtype"],
        precision=cell.config["precision"], optimizer=rec["optimizer"],
        lr=rec["lr"], momentum=rec["momentum"],
        weight_decay=rec["weight_decay"], batch_size=mix["batch"],
        # the trainer's own set is one batch; its step decay falls where
        # the stated epochs of the configuration's set would put it
        synth_train_size=mix["batch"], synth_val_size=1,
        lr_step_epochs=rec["lr_step_epochs"] * steps_per_epoch,
        steps_per_dispatch=mix["window_steps"], data_placement="device",
        seed=seed % (1 << 31), checkpoint_dir="", log_csv="",
        print_freq=1 << 30)
    return Trainer(cfg, device=device)


def run(cell, seed: int, seconds: float, trace: bool, device, clock0: float,
        options=None) -> Window:
    opts = options or {}
    model, rec, mix = cell.config["model"], cell.config["train"], cell.traffic
    batch, k, n_check = mix["batch"], mix["window_steps"], mix["check_steps"]

    tr = _trainer(cell, seed, device)
    w = weights.resnet_weights(model, seed, device)
    weights.load_into(tr.model.named_parameters(), w)
    names = list(tr.state.param_names)
    images, labels = generate.image_set(
        seed, cell.config["dataset_size"], model["image_size"],
        model["in_channels"], model["num_classes"], device)
    order = torch.as_tensor(generate.image_order(
        seed, cell.config["dataset_size"], batch, ORDER_STEPS),
        device=device)
    tr.model.train()

    def window(step, n):
        idx = order[step:step + n]

        def fn():
            tr.state, m = tr.compiled.advance(
                tr.compiled.train_step, tr.state, images, labels, idx, step)
            return m
        m, dispatch_s, _ = tr._dispatch(step, "window_step", fn, clock0, n,
                                        (idx,))
        return m, dispatch_s

    prog = {"losses": []}
    for step in range(n_check):
        m, _ = window(step, 1)
        prog["losses"].append(float(m["loss_sum"] / m["count"]))
        if step == 0:
            wd = rec["weight_decay"]
            prog["grad_norms"] = {
                n: float((mom - wd * w[n]).norm())
                for n, mom in zip(names, tr.state.opt_state.trace)}
    prog["change_norms"] = {n: float((p.detach() - w[n]).norm())
                            for n, p in zip(names, tr.state.params)}
    del w
    common.sync(device)
    setup_s = time.perf_counter() - clock0

    # the window: dispatches of k steps until the time is up
    step, dispatch, sums = n_check, [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline and step + k <= ORDER_STEPS:
        m, dispatch_s = window(step, k)
        sums.append(m["loss_sum"] / m["count"])
        dispatch.append(dispatch_s)
        step += k
    common.sync(device)
    window_s = time.perf_counter() - t0
    steps = step - n_check
    peak = common.memory_peak(device)
    nonfinite = int((~torch.isfinite(torch.stack(sums))).sum())

    tr_out = None
    if trace:
        tr_out = btrace.traced(
            lambda: window(step, k), lambda: window(step + k, k),
            lambda: common.sync(device), lambda: common.warm(device))
    checked = [order[s] for s in range(n_check)]
    del tr, window, m, sums
    common.free(device)

    w = weights.resnet_weights(model, seed, device)
    # the draws of the trainer's augmentation generator at step s (its
    # seed's documented function of the run's seed and the step, one rank)
    aug_seed = lambda s: (seed % (1 << 31)) * 1_000_003 + s
    batches = [(images.index_select(0, idx), labels.index_select(0, idx),
                aug_seed(s)) for s, idx in enumerate(checked)]
    del images, labels
    ref_mod = cell.reference
    with common.exact_fp32():
        ref = ref_mod.train_steps(w, batches, model, rec)
        control = None
        if opts.get("control"):
            control = {
                "fp8": common.readings(ref_mod.train_steps(
                    w, batches, model, rec, mode="fp8"), ref),
                "half_batch": common.readings(ref_mod.train_steps(
                    w, [(i[: batch // 2], lb[: batch // 2], s)
                        for i, lb, s in batches], model, rec), ref),
            }
    checks = common.train_checks(prog, ref, cell.limits)
    counters = {
        "dispatch_s": dispatch, "steps": steps, "window_s": window_s,
        "traced_steps": k,
        "flops_per_image": 3.0 * work.resnet_forward_flops(model),
        "program": prog, "reference": ref, "control": control,
        "device_name": (torch.cuda.get_device_name(device)
                        if torch.device(device).type == "cuda" else "cpu"),
    }
    return Window(
        metrics={"train_images_per_s": steps * batch / window_s,
                 "setup_s": setup_s},
        attempted=steps, failed=nonfinite, checks=checks, counters=counters,
        trace=tr_out, memory_peak_bytes=peak)
