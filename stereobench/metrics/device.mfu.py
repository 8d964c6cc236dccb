"""The whole step's share of the card's bf16 peak, %: the model FLOPs of
every frame delivered in the traced slice (counted from the configuration's
widths on the reference, whatever implements them) over the slice's
seconds and the peak."""

from stereobench.roofline import BF16_OPS_PER_S


def read(run):
    if run.slice is None or not run.slice.device:
        return None
    a, b = run.slice.host_bounds()
    frames = sum(1 for d in run.deliveries if a <= d.t < b)
    if not frames:
        return None
    return 100.0 * frames * run.model_flops_per_frame / (b - a) / BF16_OPS_PER_S
