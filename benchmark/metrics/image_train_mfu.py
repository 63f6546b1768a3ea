"""Image train step (``engine/steps.py``, ``models/resnet.py``): 3 x the
forward FLOPs of the convolutions and the dense head an image
(``work.resnet_forward_flops``, from the configuration's shapes) times the
window's images a second, over the card's bf16 peak (summed over the
chips), in %."""

from benchmark import work


def read(run):
    rate = run.metrics.get("train_images_per_s")
    flops = run.counters.get("flops_per_image")
    name = run.counters.get("device_name", "")
    chips = run.cell.chips
    if not rate or not flops or "H100" not in name:
        return None
    return 100.0 * rate * flops / (work.peak(name, "bf16") * chips)
