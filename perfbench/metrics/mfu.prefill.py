"""mfu.prefill: model FLOPs of every request of the window (``harness.
flops.prefill_flops``) over the window's wall time, as a share of the bf16
peak, in %."""
from harness import flops
from harness.peaks import PEAK_BF16_FLOPS


def read(ctx, outcome):
    w = outcome.window
    total = w["batch"] * sum(flops.prefill_flops(ctx.conf, s) for s in w["lengths"])
    return 100.0 * total / (w["wall_s"] * PEAK_BF16_FLOPS)
